"""The paper's 11 memory-bound benchmarks (Table 3), ported to AMI.

Each workload provides:

* ``build()`` -> a :class:`WorkloadInstance` with real numpy-backed far
  memory, coroutine tasks following the paper's porting paradigm (§5.2:
  loop-level parallelism for GUPS/HJ/HPCG/IS/STREAM, request-level
  parallelism for BS/HT/LL/SL/Redis, frontier parallelism for BFS), and a
  ``verify()`` that checks the far-memory contents / collected results
  against a serial numpy oracle.
* an :class:`IterationProfile` describing one logical work unit for the
  baseline out-of-order window model (64-byte line granularity, dependence
  structure, compute instruction count), declared on the builder's
  ``@workload`` registration.

Every builder registers itself into :data:`repro_torch.amu.REGISTRY` via the
``@workload`` decorator (capabilities: vector/pipelined/locked/distinct/
frontier); port bodies yield commands through the typed facade
:data:`repro_torch.amu.ctx` rather than constructing command objects by hand.

Sizes are scaled down from the paper (as the paper itself scales down for
simulation time) but keep the structural character: random vs sequential,
chase depth, granularity.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterable, List, Optional

import numpy as np

from repro_torch.amu.commands import ctx
from repro_torch.amu.registry import workload as _workload
from repro_torch.configs.base import EngineConfig
from repro_torch.core.engine import AMART_ENTRY_BYTES

LINE = 64  # baseline cache-line granularity

# Every workload has a vector (AloadVec/AstoreVec) port behind a
# `vector=True` builder knob; the scalar ports stay the default (and the
# differential oracle — tests pin vector execution to the scalar port's
# results). Loop-level-parallel benchmarks batch independent requests per
# generator hop (§5.2); the request-level-parallel chase workloads (HJ, HT,
# LL, SL, Redis) use software-pipelined ports instead: K concurrent chases
# per coroutine advance in lockstep, one AloadVec per round over the live
# set (the BS probe-batch pattern generalized — arXiv 2112.13306's software
# pipelining); BFS batches the per-chunk parent fetch/claim. Which port a
# workload carries is declared on its @workload registration (the `vector`/
# `pipelined` capabilities in repro_torch.amu.REGISTRY).

# Zero-copy port idiom: SpmRead yields a read-only view aliasing live SPM.
# Ports do view arithmetic directly (`data.view(dt)`), hand computed arrays
# to SpmWrite without `.tobytes()`, and only copy (or double-buffer slots)
# where a value must survive a later DMA/SpmWrite into the same range — see
# the SL port (double-buffered node slots) and the pipelined SL port
# (per-chase node snapshots).


def _fit_spm(data_bytes: int, queue_length: int,
             floor: int = 64 * 1024) -> int:
    """Smallest power-of-two SPM that fits `data_bytes` of slots plus the
    AMART/queue metadata area (vector ports with big per-coroutine windows
    outgrow the default 64 KiB — the paper's SPM is an L2-slice, MiB-scale)."""
    need = data_bytes + queue_length * AMART_ENTRY_BYTES + 1
    spm = floor
    while spm < need:
        spm *= 2
    return spm


def _unique_keys(rng, n: int, lo: int = 1, hi: int = 1 << 40) -> "np.ndarray":
    """n distinct uint64 keys in [lo, hi) without materializing the range."""
    out = np.unique(rng.integers(lo, hi, size=2 * n + 16, dtype=np.uint64))
    while out.size < n:  # astronomically unlikely for our sizes
        more = rng.integers(lo, hi, size=2 * n, dtype=np.uint64)
        out = np.unique(np.concatenate([out, more]))
    return rng.permutation(out)[:n]


@dataclass(frozen=True)
class IterationProfile:
    """One logical work unit as the baseline OoO core sees it.

    `mlp_cap` and `local_cycles` are the two calibration knobs fitted against
    the paper's Table 4 / Fig 2 curves: `mlp_cap` is the *effective* sustained
    far-memory concurrency the Gem5 baseline achieves for this access pattern
    (second-order limits: TLB walks holding MSHRs, LSQ walks, line-fill
    serialization — well below the nominal 48 MSHRs for fine random RMW), and
    `local_cycles` is serialized per-iteration core/local-memory work (hash,
    page walk, loop control) that does not scale with far latency."""
    insts: float              # non-memory instructions
    chase: float = 0          # serially dependent far loads (pointer chase)
    indep_loads: float = 0    # independent far loads (64B lines)
    stores: float = 0         # far stores (issue after loads/compute)
    local_frac: float = 0.0   # fraction of far loads that hit local cache
    sequential: bool = False  # stride pattern (hardware prefetcher works)
    mlp_cap: float = 0.0      # 0 -> window-derived; else sustained-MLP cap
    local_cycles: float = 0.0 # serialized non-far cycles per iteration


@dataclass
class WorkloadInstance:
    name: str
    mem: np.ndarray                       # far-memory backing (uint8)
    tasks: List                           # generator tasks
    units: int                            # logical work units (for rates)
    engine_config: EngineConfig
    verify: Callable[[np.ndarray], bool]
    disambiguation: bool = False
    vector: bool = False                  # which port was built (stats label)
    # request-level ports (serving) fill one completion latency per logical
    # request during the run; the session turns it into RunStats req_* fields
    request_latency_cycles: Optional[np.ndarray] = None


def _cfg(granularity: int, queue_length: int = 256,
         spm_bytes: int = 64 * 1024, batch_ids: int = 31) -> EngineConfig:
    return EngineConfig(queue_length=queue_length, granularity=granularity,
                        spm_bytes=spm_bytes, batch_ids=batch_ids)


def _vec_cfg(granularity: int, coroutines: int, pipeline_k: int,
             data_bytes: int = 0) -> EngineConfig:
    """Engine config for a pipelined/vector port: ID pool sized to 2x the
    peak in-flight demand (vectors that park at exact occupancy burn their
    speedup on retry churn), SPM auto-fit when the slot windows outgrow the
    default 64 KiB."""
    qlen = min(2048, max(256, 2 * coroutines * pipeline_k))
    spm = _fit_spm(data_bytes, qlen) if data_bytes else 64 * 1024
    return _cfg(granularity, queue_length=qlen, spm_bytes=spm)


# =========================================================================
# GUPS — HPCC RandomAccess: read-modify-write random 8B words (LLP)
# =========================================================================
@_workload("GUPS", profile=IterationProfile(insts=8, indep_loads=1, stores=1,
                                            mlp_cap=6, local_cycles=165),
           vector=True, distinct=True,
           description="HPCC RandomAccess, 8B RMW updates")
def build_gups(seed: int = 0, table_words: int = 8192, updates: int = 4096,
               coroutines: int = 256, vector: bool = False,
               vec_chunk: int = 32, distinct: bool = False) -> WorkloadInstance:
    rng = np.random.default_rng(seed)
    table = rng.integers(0, 1 << 63, size=table_words, dtype=np.uint64)
    mem = table.view(np.uint8).copy()
    if distinct:
        # conflict-free update set (each slot touched at most once): makes
        # the final bytes schedule-independent for differential tests
        if updates > table_words:
            raise ValueError(f"distinct=True needs updates <= table_words "
                             f"({updates} > {table_words})")
        idx = rng.permutation(table_words)[:updates]
    else:
        idx = rng.integers(0, table_words, size=updates)
    vals = rng.integers(0, 1 << 63, size=updates, dtype=np.uint64)

    def task(c: int, lo: int, hi: int):
        spm = c * 8
        for k in range(lo, hi):
            addr = int(idx[k]) * 8
            yield ctx.aload(spm, addr, 8)
            data = yield ctx.spm_read(spm, 8)
            new = data.view(np.uint64) ^ vals[k]
            yield ctx.spm_write(spm, new)
            yield ctx.astore(spm, addr, 8)
            yield ctx.cost(insts=6)

    def vtask(c: int, lo: int, hi: int):
        base = c * vec_chunk * 8           # vec_chunk 8B slots per coroutine
        for k0 in range(lo, hi, vec_chunk):
            cnt = min(vec_chunk, hi - k0)
            addrs = idx[k0:k0 + cnt] * 8
            slots = base + np.arange(cnt) * 8
            yield ctx.aload_vec(slots, addrs, 8, wait=True)
            data = yield ctx.spm_read(base, cnt * 8)
            new = data.view(np.uint64) ^ vals[k0:k0 + cnt]
            yield ctx.spm_write(base, new)
            yield ctx.astore_vec(slots, addrs, 8, wait=True)
            yield ctx.cost(insts=6 * cnt)

    if vector:
        coroutines = min(coroutines, 32)
    bounds = np.linspace(0, updates, coroutines + 1).astype(int)
    mk = vtask if vector else task
    tasks = [mk(c, bounds[c], bounds[c + 1]) for c in range(coroutines)]

    expect = table.copy()
    for k in range(updates):
        expect[idx[k]] ^= vals[k]
    conflict_free = np.bincount(idx, minlength=table_words) <= 1

    def verify(mem_out: np.ndarray) -> bool:
        got = mem_out[:table_words * 8].view(np.uint64)
        # HPCC allows racy updates to diverge; conflict-free slots must match
        return bool(np.array_equal(got[conflict_free], expect[conflict_free]))

    # vector mode wants every coroutine's whole chunk in flight: size the ID
    # queue to the aggregate vector demand (parking stays correct but slow)
    cfg = _cfg(8, queue_length=min(2048, max(256, coroutines * vec_chunk))) \
        if vector else _cfg(8)
    return WorkloadInstance("GUPS", mem, tasks, updates, cfg, verify,
                            vector=vector)


# =========================================================================
# STREAM — triad a = b + s*c with large-granularity (512B) aload/astore (LLP)
# =========================================================================
@_workload("STREAM", profile=IterationProfile(insts=160, indep_loads=16,
                                              stores=8, sequential=True,
                                              mlp_cap=64, local_cycles=226),
           vector=True, llvm_defaults={"block_doubles": 1},
           description="triad over 512B blocks (64 doubles/unit)")
def build_stream(seed: int = 0, n: int = 65536, block_doubles: int = 64,
                 coroutines: int = 32, vector: bool = False,
                 vec_chunk: int = 4) -> WorkloadInstance:
    rng = np.random.default_rng(seed)
    b = rng.standard_normal(n)
    c = rng.standard_normal(n)
    a = np.zeros(n)
    s = 3.0
    mem = np.concatenate([a, b, c]).view(np.uint8).copy()
    a_off, b_off, c_off = 0, n * 8, 2 * n * 8
    gran = block_doubles * 8
    blocks = n // block_doubles

    def task(coro: int, lo: int, hi: int):
        sb = coro * 2 * gran          # two input slots per coroutine
        for blk in range(lo, hi):
            off = blk * gran
            rb = yield ctx.aload(sb, b_off + off, gran, wait=False)
            rc = yield ctx.aload(sb + gran, c_off + off, gran, wait=False)
            yield ctx.await_rid(rb)
            yield ctx.await_rid(rc)
            db = yield ctx.spm_read(sb, gran)
            dc = yield ctx.spm_read(sb + gran, gran)
            out = db.view(np.float64) + s * dc.view(np.float64)
            yield ctx.cost(insts=2 * block_doubles)
            yield ctx.spm_write(sb, out)
            yield ctx.astore(sb, a_off + off, gran)

    def vtask(coro: int, lo: int, hi: int):
        # vec_chunk b-slots then vec_chunk c-slots, contiguous per coroutine
        sb = coro * 2 * vec_chunk * gran
        sc = sb + vec_chunk * gran
        for b0 in range(lo, hi, vec_chunk):
            cnt = min(vec_chunk, hi - b0)
            offs = np.arange(b0, b0 + cnt) * gran
            bslots = sb + np.arange(cnt) * gran
            cslots = sc + np.arange(cnt) * gran
            yield ctx.aload_vec(np.concatenate([bslots, cslots]),
                                np.concatenate([b_off + offs, c_off + offs]),
                                gran, wait=True)
            db = yield ctx.spm_read(sb, cnt * gran)
            dc = yield ctx.spm_read(sc, cnt * gran)
            out = db.view(np.float64) + s * dc.view(np.float64)
            yield ctx.cost(insts=2 * block_doubles * cnt)
            yield ctx.spm_write(sb, out)
            yield ctx.astore_vec(bslots, a_off + offs, gran, wait=True)

    if vector:
        coroutines = min(coroutines, 8)
    bounds = np.linspace(0, blocks, coroutines + 1).astype(int)
    mk = vtask if vector else task
    tasks = [mk(i, bounds[i], bounds[i + 1]) for i in range(coroutines)]
    expect = b + s * c

    def verify(mem_out: np.ndarray) -> bool:
        got = mem_out[a_off:a_off + n * 8].view(np.float64)
        return bool(np.allclose(got, expect))

    cfg = _cfg(gran)
    if vector:           # big per-coroutine windows outgrow the default SPM
        # ID pool sized to 2x the peak vector demand (2 loads + 1 store per
        # block in flight) so refills never park at exact occupancy
        qlen = min(2048, max(256, 6 * coroutines * vec_chunk))
        cfg = _cfg(gran, queue_length=qlen,
                   spm_bytes=_fit_spm(coroutines * 2 * vec_chunk * gran,
                                      qlen))
    return WorkloadInstance("STREAM", mem, tasks, blocks, cfg, verify,
                            vector=vector)


# =========================================================================
# BS — binary search over sorted 16B elements (RLP, dependent chase)
# =========================================================================
@_workload("BS", profile=IterationProfile(insts=120, chase=14,
                                          local_frac=0.5, local_cycles=60),
           vector=True,
           description="binary search, 16B elements, 14-deep chase")
def build_bs(seed: int = 0, n_elems: int = 16384, searches: int = 512,
             coroutines: int = 256, vector: bool = False) -> WorkloadInstance:
    rng = np.random.default_rng(seed)
    keys = np.sort(_unique_keys(rng, n_elems))
    payload = rng.integers(0, 1 << 63, size=n_elems, dtype=np.uint64)
    elems = np.empty(n_elems * 2, np.uint64)
    elems[0::2], elems[1::2] = keys, payload
    mem = elems.view(np.uint8).copy()
    queries = keys[rng.integers(0, n_elems, size=searches)]
    found_payload = np.zeros(searches, np.uint64)

    def task(c: int, qs: List[int]):
        spm = c * 16
        for qi in qs:
            target = queries[qi]
            lo, hi = 0, n_elems - 1
            while lo <= hi:
                mid = (lo + hi) // 2
                yield ctx.aload(spm, mid * 16, 16)
                data = yield ctx.spm_read(spm, 16)
                k, v = data.view(np.uint64)
                yield ctx.cost(insts=8)
                if k == target:
                    found_payload[qi] = v
                    break
                lo, hi = (mid + 1, hi) if k < target else (lo, mid - 1)

    def vtask(c: int, qs: "np.ndarray"):
        # probe batch: all of this task's searches advance in lock-step —
        # one AloadVec fetches the current mid element of every live search
        nq = len(qs)
        base = c * nq * 16                 # one 16B element slot per search
        lo = np.zeros(nq, np.int64)
        hi = np.full(nq, n_elems - 1, np.int64)
        live = np.ones(nq, bool)
        while live.any():
            act = np.nonzero(live)[0]
            mid = (lo[act] + hi[act]) // 2
            yield ctx.aload_vec(base + act * 16, mid * 16, 16, wait=True)
            yield ctx.cost(insts=8 * len(act))
            for pos, ai in enumerate(act):
                data = yield ctx.spm_read(int(base + ai * 16), 16)
                k, v = data.view(np.uint64)
                target = queries[qs[ai]]
                if k == target:
                    found_payload[qs[ai]] = v
                    live[ai] = False
                elif k < target:
                    lo[ai] = mid[pos] + 1
                else:
                    hi[ai] = mid[pos] - 1
                if live[ai] and lo[ai] > hi[ai]:
                    live[ai] = False

    if vector:
        coroutines = min(coroutines, 32)   # fewer tasks, each a probe batch
    qsplit = np.array_split(np.arange(searches), coroutines)
    if vector:
        tasks = [vtask(c, qs) for c, qs in enumerate(qsplit) if len(qs)]
    else:
        tasks = [task(c, list(qs)) for c, qs in enumerate(qsplit) if len(qs)]
    expect = payload[np.searchsorted(keys, queries)]

    def verify(mem_out: np.ndarray) -> bool:
        return bool(np.array_equal(found_payload, expect))

    cfg = _cfg(16, queue_length=min(1024, max(256, searches))) if vector \
        else _cfg(16)
    return WorkloadInstance("BS", mem, tasks, searches, cfg, verify,
                            vector=vector)


# =========================================================================
# Chained hash structures — shared helper (HJ probe, HT, Redis)
# node layout: [key u64 | value u64 | next i64 (byte offset, -1 end) | pad]
# =========================================================================
_NODE = 32


def _build_chains(rng, n_keys: int, n_buckets: int):
    keys = _unique_keys(rng, n_keys)
    vals = rng.integers(1, 1 << 62, size=n_keys, dtype=np.uint64)
    bucket_of = keys % n_buckets
    heads = np.full(n_buckets, -1, np.int64)
    nodes = np.zeros(n_keys * 4, np.uint64)  # key, val, next, pad per node
    for i in range(n_keys):
        b = bucket_of[i]
        nodes[4 * i + 0] = keys[i]
        nodes[4 * i + 1] = vals[i]
        nodes[4 * i + 2] = np.uint64(heads[b] if heads[b] >= 0
                                     else 0xFFFFFFFFFFFFFFFF)
        heads[b] = i * _NODE
    return keys.astype(np.uint64), vals, heads, nodes


_NIL64 = np.uint64(0xFFFFFFFFFFFFFFFF)


def _chase_chain(spm: int, head_off: int, target: int):
    """Generator fragment: follow a chain until key==target.
    Yields AMI commands; returns (node_off, value) via StopIteration value."""
    off = head_off
    while off != -1:
        yield ctx.aload(spm, off, _NODE)
        data = yield ctx.spm_read(spm, _NODE)
        k, v, nxt, _ = data.view(np.uint64)
        yield ctx.cost(insts=8)
        if k == target:
            return off, int(v)
        off = -1 if nxt == _NIL64 else int(nxt)
    return -1, 0


def _chase_chain_vec(base: int, heads, targets):
    """Software-pipelined counterpart of :func:`_chase_chain`: K chases
    advance in lockstep, one ``AloadVec`` per round over the still-live set
    (the BS probe-batch pattern generalized to chained structures). Chase i
    lands in SPM slot ``base + i*_NODE``; one zero-copy SpmRead view over the
    whole slot window serves every chase's node each round. Per-chase far
    traffic is identical to the scalar chase. Returns ``(offs, vals)`` int64/
    uint64 arrays via StopIteration (off -1 where the key was absent)."""
    targets = np.asarray(targets, np.uint64)
    nb = targets.size
    cur = np.asarray(heads, np.int64).copy()
    offs = np.full(nb, -1, np.int64)
    vals = np.zeros(nb, np.uint64)
    live = cur >= 0
    while live.any():
        act = np.nonzero(live)[0]
        yield ctx.aload_vec(base + act * _NODE, cur[act], _NODE, wait=True)
        data = yield ctx.spm_read(base, nb * _NODE)
        nodes = data.view(np.uint64).reshape(nb, 4)
        yield ctx.cost(insts=8 * act.size)
        k, v, nxt = nodes[act, 0], nodes[act, 1], nodes[act, 2]
        hit = k == targets[act]
        offs[act[hit]] = cur[act[hit]]
        vals[act[hit]] = v[hit]
        ended = ~hit & (nxt == _NIL64)
        cont = ~hit & ~ended
        cur[act[cont]] = nxt[cont].astype(np.int64)
        live[act[hit | ended]] = False
    return offs, vals


def _lock_set(addrs) -> "np.ndarray":
    """Ascending distinct 64B-block lock representatives for a pipeline
    batch. The disambiguation set conflicts at aligned-block granularity, so
    deduping per block both avoids self-conflict (two addresses of one batch
    sharing a block would make the coroutine wait on itself) and gives a
    total acquisition order across coroutines (deadlock-free)."""
    a = np.asarray(addrs).astype(np.int64)
    return np.unique(a >> 6) << 6


def _distinct_key_batches(op_order, op_keys, k: int):
    """Split ops into pipeline batches of <= k with pairwise-distinct keys.
    Ops whose key already appears in the current batch are deferred to a
    later batch (relative per-key order preserved), so concurrent chases in
    one batch never race on the same key — each batch acquires its key set
    once, in ascending order (total-order locking: deadlock-free even with
    K locks held across coroutines)."""
    remaining = list(op_order)
    while remaining:
        batch, used, deferred = [], set(), []
        for oi in remaining:
            key = int(op_keys[oi])
            if len(batch) < k and key not in used:
                batch.append(oi)
                used.add(key)
            else:
                deferred.append(oi)
        yield np.asarray(batch, np.int64)
        remaining = deferred


# =========================================================================
# HJ — hash join probe (LLP) with software disambiguation (Table 5)
# =========================================================================
@_workload("HJ", profile=IterationProfile(insts=24, chase=1.5, mlp_cap=11,
                                          local_cycles=57),
           vector=True, pipelined=True, locked=True,
           description="hash join probe, 32B nodes, load factor 1")
def build_hj(seed: int = 0, build_keys: int = 4096, buckets: int = 4096,
             probes: int = 2048, coroutines: int = 256, vector: bool = False,
             pipeline_k: int = 16) -> WorkloadInstance:
    rng = np.random.default_rng(seed)
    keys, vals, heads, nodes = _build_chains(rng, build_keys, buckets)
    mem = nodes.view(np.uint8).copy()
    probe_keys = keys[rng.integers(0, build_keys, size=probes)]
    probe_payload = rng.integers(1, 1 << 62, size=probes, dtype=np.uint64)
    joined = np.zeros(probes, np.uint64)

    def task(c: int, ps: Iterable[int]):
        spm = c * _NODE
        for pi in ps:
            target = int(probe_keys[pi])
            head = int(heads[target % buckets])   # bucket array is local
            yield ctx.cost(insts=6)                   # hash + bucket index
            yield ctx.acquire(head if head >= 0 else 0)
            if head >= 0:
                _, v = yield from _chase_chain(spm, head, target)
                joined[pi] = np.uint64(v) ^ probe_payload[pi]
                # materialize the output tuple (partition buffer write)
                yield ctx.cost(insts=20, cycles=35)
            yield ctx.release(head if head >= 0 else 0)

    def vtask(c: int, ps: "np.ndarray"):
        base = c * pipeline_k * _NODE          # one node slot per chase
        for batch in _distinct_key_batches(ps, probe_keys, pipeline_k):
            targets = probe_keys[batch]
            locks = _lock_set(np.maximum(heads[targets % buckets], 0))
            yield ctx.cost(insts=6 * batch.size)
            yield ctx.acquire_vec(locks)       # one hop, ascending order
            _, v = yield from _chase_chain_vec(
                base, heads[targets % buckets], targets)
            joined[batch] = v ^ probe_payload[batch]
            yield ctx.cost(insts=20 * batch.size, cycles=35 * batch.size)
            yield ctx.release_vec(locks)

    if vector:
        coroutines = min(coroutines, 32)
    psplit = np.array_split(np.arange(probes), coroutines)
    if vector:
        tasks = [vtask(c, ps) for c, ps in enumerate(psplit) if len(ps)]
    else:
        tasks = [task(c, list(ps)) for c, ps in enumerate(psplit) if len(ps)]
    kv = dict(zip(keys.tolist(), vals.tolist()))
    expect = np.array([kv[int(k)] for k in probe_keys],
                      np.uint64) ^ probe_payload

    def verify(mem_out: np.ndarray) -> bool:
        return bool(np.array_equal(joined, expect))

    cfg = _vec_cfg(_NODE, coroutines, pipeline_k) if vector else _cfg(_NODE)
    inst = WorkloadInstance("HJ", mem, tasks, probes, cfg, verify,
                            vector=vector)
    inst.disambiguation = True
    return inst


# =========================================================================
# HT — ASCYLIB-style chained hash table, 50/50 lookup/update (RLP, disamb)
# =========================================================================
@_workload("HT", profile=IterationProfile(insts=26, chase=2, stores=1,
                                          local_frac=0.1, mlp_cap=14,
                                          local_cycles=57),
           vector=True, pipelined=True, locked=True,
           description="chained hash table 50/50 lookup/update")
def build_ht(seed: int = 0, n_keys: int = 4096, buckets: int = 2048,
             ops: int = 2048, coroutines: int = 256,
             hot_frac: float = 0.04, vector: bool = False,
             pipeline_k: int = 16) -> WorkloadInstance:
    rng = np.random.default_rng(seed)
    keys, vals, heads, nodes = _build_chains(rng, n_keys, buckets)
    mem = nodes.view(np.uint8).copy()
    # skewed (YCSB-zipf-like) key popularity: `hot_frac` of ops hit one hot
    # key, so conflicting ops serialize through the disambiguation waiter
    # queue — this drives Table 5's latency-dependent overhead fraction.
    op_keys = keys[rng.integers(0, n_keys, size=ops)]
    hot = rng.random(ops) < hot_frac
    op_keys[hot] = keys[0]
    op_upd = rng.random(ops) < 0.5
    op_delta = rng.integers(1, 1 << 30, size=ops, dtype=np.uint64)
    lookups = np.zeros(ops, np.uint64)

    def task(c: int, os_: Iterable[int]):
        spm = c * _NODE
        for oi in os_:
            target = int(op_keys[oi])
            head = int(heads[target % buckets])
            yield ctx.cost(insts=6)
            yield ctx.acquire(target)             # key-granular conflict set
            off, v = yield from _chase_chain(spm, head, target)
            if op_upd[oi]:
                newv = np.uint64(v) + op_delta[oi]
                yield ctx.spm_write(spm + 8, newv.tobytes())
                yield ctx.astore(spm + 8, off + 8, 8)  # value field RMW
            else:
                lookups[oi] = v
            yield ctx.release(target)

    def vtask(c: int, os_: "np.ndarray"):
        base = c * pipeline_k * _NODE
        # distinct-key batches: same-key RMWs never chase concurrently, so
        # per-key serialization (and the final sum of deltas) is preserved
        for batch in _distinct_key_batches(os_, op_keys, pipeline_k):
            targets = op_keys[batch]
            locks = _lock_set(targets)
            yield ctx.cost(insts=6 * batch.size)
            yield ctx.acquire_vec(locks)           # one hop, ascending order
            offs, v = yield from _chase_chain_vec(
                base, heads[targets % buckets], targets)
            upd = op_upd[batch]
            ui = np.nonzero(upd)[0]
            for i in ui:                           # value-field RMW per slot
                newv = v[i] + op_delta[batch[i]]
                yield ctx.spm_write(int(base + i * _NODE + 8),
                                    np.uint64(newv).tobytes())
            if ui.size:
                yield ctx.astore_vec(base + ui * _NODE + 8,
                                     offs[ui] + 8, 8, wait=True)
            lookups[batch[~upd]] = v[~upd]
            yield ctx.release_vec(locks)

    if vector:
        coroutines = min(coroutines, 32)
    osplit = np.array_split(np.arange(ops), coroutines)
    if vector:
        tasks = [vtask(c, o) for c, o in enumerate(osplit) if len(o)]
    else:
        tasks = [task(c, list(o)) for c, o in enumerate(osplit) if len(o)]

    expect_vals = dict(zip(keys.tolist(), vals.tolist()))
    expect_lookup = np.zeros(ops, np.uint64)
    for oi in range(ops):
        k = int(op_keys[oi])
        if op_upd[oi]:
            expect_vals[k] = np.uint64(expect_vals[k] + op_delta[oi])
        else:
            expect_lookup[oi] = expect_vals[k]
    key_to_node = {int(k): i for i, k in enumerate(keys)}

    def verify(mem_out: np.ndarray) -> bool:
        got = mem_out.view(np.uint64)
        for k, v in expect_vals.items():
            if got[4 * key_to_node[k] + 1] != v:
                return False
        # lookups see *some* serialized prefix value; only check final state +
        # lookups of never-updated keys
        updated_keys = set(op_keys[op_upd].tolist())
        for oi in range(ops):
            if not op_upd[oi] and int(op_keys[oi]) not in updated_keys:
                if lookups[oi] != expect_lookup[oi]:
                    return False
        return True

    cfg = _vec_cfg(_NODE, coroutines, pipeline_k) if vector else _cfg(_NODE)
    inst = WorkloadInstance("HT", mem, tasks, ops, cfg, verify,
                            vector=vector)
    inst.disambiguation = True
    return inst


# =========================================================================
# LL — hand-over-hand linked list lookup (RLP, deep dependent chase)
# =========================================================================
@_workload("LL", profile=IterationProfile(insts=2200, chase=200,
                                          local_cycles=40),
           vector=True, pipelined=True,
           description="hand-over-hand list lookup (~200-node chase)")
def build_ll(seed: int = 0, list_len: int = 400, lookups: int = 96,
             coroutines: int = 96, vector: bool = False,
             pipeline_k: int = 16) -> WorkloadInstance:
    rng = np.random.default_rng(seed)
    keys = np.sort(_unique_keys(rng, list_len))
    vals = rng.integers(1, 1 << 62, size=list_len, dtype=np.uint64)
    order = rng.permutation(list_len)          # nodes scattered in memory
    pos_of = np.empty(list_len, np.int64)
    pos_of[order] = np.arange(list_len)
    nodes = np.zeros(list_len * 4, np.uint64)
    for i in range(list_len):                  # list order = sorted keys
        p = pos_of[i]
        nodes[4 * p + 0] = keys[i]
        nodes[4 * p + 1] = vals[i]
        nxt = pos_of[i + 1] * _NODE if i + 1 < list_len else 0xFFFFFFFFFFFFFFFF
        nodes[4 * p + 2] = np.uint64(nxt)
    mem = nodes.view(np.uint8).copy()
    head = int(pos_of[0] * _NODE)
    q_idx = rng.integers(0, list_len, size=lookups)
    found = np.zeros(lookups, np.uint64)

    def task(c: int, qs: Iterable[int]):
        spm = c * _NODE
        for qi in qs:
            target = int(keys[q_idx[qi]])
            off = head
            while off != -1:
                yield ctx.aload(spm, off, _NODE)
                data = yield ctx.spm_read(spm, _NODE)
                k, v, nxt, _ = data.view(np.uint64)
                yield ctx.cost(insts=10)
                if k == target:
                    found[qi] = v
                    break
                if k > target:
                    break
                off = -1 if nxt == _NIL64 else int(nxt)

    def vtask(c: int, qs: "np.ndarray"):
        # K hand-over-hand chases, software-pipelined: a finished chase's
        # slot is refilled with the next lookup immediately (LL holds no
        # locks, so refill cannot deadlock), keeping the AloadVec width at K
        # until the queue drains instead of degenerating with the batch.
        # The sorted-key early exit (k > target) retires a chase exactly
        # where the scalar port stops, so far traffic stays pinned.
        base = c * pipeline_k * _NODE
        tq = keys[q_idx[qs]]                   # per-lookup targets
        nq = len(qs)
        prime = min(pipeline_k, nq)
        slot_q = np.full(pipeline_k, -1, np.int64)   # lookup index per slot
        slot_q[:prime] = np.arange(prime)
        cur = np.full(pipeline_k, head, np.int64)
        nexti = prime
        act = np.arange(prime)                 # active slots, kept up to date
        while act.size:
            yield ctx.aload_vec(base + act * _NODE, cur[act], _NODE, wait=True)
            data = yield ctx.spm_read(base, pipeline_k * _NODE)
            nodes = data.view(np.uint64).reshape(pipeline_k, 4)
            yield ctx.cost(insts=10 * act.size)
            sub = nodes[act]                   # one gather for k/v/nxt cols
            k, v, nxt = sub[:, 0], sub[:, 1], sub[:, 2]
            t = tq[slot_q[act]]
            hit = k == t
            found[qs[slot_q[act[hit]]]] = v[hit]
            stop = hit | (k > t) | (nxt == _NIL64)
            cur[act[~stop]] = nxt[~stop].astype(np.int64)
            refills = []
            for s in act[stop]:                # refill retired slots
                if nexti < nq:
                    slot_q[s] = nexti
                    cur[s] = head
                    nexti += 1
                    refills.append(s)
            act = act[~stop]
            if refills:
                act = np.concatenate([act, np.asarray(refills, np.int64)])

    if vector:
        # keep the scalar port's total chase concurrency (`coroutines`), but
        # fold it into coroutines-of-K so every slot refills many times —
        # the pipeline only pays off when each task streams lookups through
        # its K slots, not when it holds exactly one batch
        coroutines = max(1, min(coroutines, lookups) // pipeline_k)
    qsplit = np.array_split(np.arange(lookups), coroutines)
    if vector:
        tasks = [vtask(c, q) for c, q in enumerate(qsplit) if len(q)]
    else:
        tasks = [task(c, list(q)) for c, q in enumerate(qsplit) if len(q)]
    expect = vals[q_idx]

    def verify(mem_out: np.ndarray) -> bool:
        return bool(np.array_equal(found, expect))

    cfg = _vec_cfg(_NODE, coroutines, pipeline_k) if vector else _cfg(_NODE)
    return WorkloadInstance("LL", mem, tasks, lookups, cfg, verify,
                            vector=vector)


# =========================================================================
# SL — skip-list lookup (RLP): 32B payload + 15 pointers per node (160B)
# =========================================================================
_SL_LEVELS = 15
_SL_NODE = 160  # 32B payload (key,val,meta) + 15 * 8B forward pointers


@_workload("SL", profile=IterationProfile(insts=200, chase=22,
                                          local_frac=0.3, local_cycles=60),
           vector=True, pipelined=True,
           description="skip-list lookup, 160B nodes")
def build_sl(seed: int = 0, n_keys: int = 2048, lookups: int = 512,
             coroutines: int = 128, vector: bool = False,
             pipeline_k: int = 16) -> WorkloadInstance:
    rng = np.random.default_rng(seed)
    keys = np.sort(_unique_keys(rng, n_keys, lo=2))
    vals = rng.integers(1, 1 << 62, size=n_keys, dtype=np.uint64)
    levels = np.minimum(1 + rng.geometric(0.5, size=n_keys), _SL_LEVELS)
    NIL = np.uint64(0xFFFFFFFFFFFFFFFF)
    # node i (0 = sentinel head, key 0 < all keys, full height) at byte
    # offset i*_SL_NODE; u64 layout: [key, val, level, pad, fwd[0..14], pad]
    total = n_keys + 1
    u = np.zeros(total * (_SL_NODE // 8), np.uint64)
    node_level = np.concatenate([[_SL_LEVELS],
                                 levels.astype(np.int64)])
    node_keys = np.concatenate([np.zeros(1, np.uint64), keys])
    node_vals = np.concatenate([np.zeros(1, np.uint64), vals])
    for i in range(total):
        base = i * 20
        u[base + 0], u[base + 1] = node_keys[i], node_vals[i]
        u[base + 2] = np.uint64(node_level[i])
        for lv in range(_SL_LEVELS):
            u[base + 4 + lv] = NIL
    last_at_level = [0] * _SL_LEVELS   # sentinel heads every level
    for i in range(1, total):          # nodes already in key order
        for lv in range(int(node_level[i])):
            u[last_at_level[lv] * 20 + 4 + lv] = np.uint64(i * _SL_NODE)
            last_at_level[lv] = i
    mem = u.view(np.uint8).copy()
    q_idx = rng.integers(0, n_keys, size=lookups)
    found = np.zeros(lookups, np.uint64)

    def read_node(spm, off):
        yield ctx.aload(spm, off, _SL_NODE)
        data = yield ctx.spm_read(spm, _SL_NODE)
        return data.view(np.uint64)

    def task(c: int, qs: Iterable[int]):
        # two slots per coroutine: SpmRead views alias live SPM, and the
        # rejected-probe path keeps using `node` after the NEXT fetch — so
        # each fetch lands in the slot NOT holding the current node
        # (double-buffering instead of a per-node copy)
        base = c * 2 * _SL_NODE
        for qi in qs:
            target = keys[q_idx[qi]]
            cur = 0
            node = yield from read_node(base, 0)    # sentinel into slot 0
            yield ctx.cost(insts=6)
            for lv in range(_SL_LEVELS - 1, -1, -1):
                while True:
                    nxt = node[4 + lv]
                    if nxt == NIL:
                        break
                    nxt_node = yield from read_node(
                        base + (1 - cur) * _SL_NODE, int(nxt))
                    yield ctx.cost(insts=8)
                    if nxt_node[0] <= target:
                        node = nxt_node
                        cur = 1 - cur
                    else:
                        break
                if node[0] == target:
                    break
            if node[0] == target:
                found[qi] = node[1]

    _ROW = _SL_NODE // 8

    def vtask(c: int, qs: "np.ndarray"):
        # K skip-list descents, software-pipelined (slot refill — SL holds
        # no locks). Level moves that need no far fetch (NIL forward
        # pointers) resolve locally; each round AloadVec's the next node of
        # every live chase. The current node is snapshotted per chase
        # (`node[si] = rows[si]`): the slot window is overwritten every
        # round, and a rejected probe must keep the prior node — the
        # documented copy-on-overwrite case of the zero-copy contract. The
        # fetch sequence (and far traffic) per lookup is identical to the
        # scalar port's.
        base = c * pipeline_k * _SL_NODE
        tq = keys[q_idx[qs]]
        nq = len(qs)
        prime = min(pipeline_k, nq)
        slot_q = np.full(pipeline_k, -1, np.int64)
        slot_q[:prime] = np.arange(prime)
        nexti = prime
        node = np.zeros((pipeline_k, _ROW), np.uint64)  # per-chase snapshot
        lv = np.zeros(pipeline_k, np.int64)             # level cursor
        fetch = np.zeros(pipeline_k, np.int64)          # next offset (=sentinel)
        sentinel = np.ones(pipeline_k, bool)
        live = slot_q >= 0

        def finish(si):
            """Chase in slot `si` ended: record a hit, refill or retire."""
            nonlocal nexti
            if node[si, 0] == tq[slot_q[si]]:
                found[qs[slot_q[si]]] = node[si, 1]
            if nexti < nq:
                slot_q[si] = nexti
                fetch[si] = 0
                sentinel[si] = True
                nexti += 1
            else:
                live[si] = False

        while live.any():
            act = np.nonzero(live)[0]
            yield ctx.aload_vec(base + act * _SL_NODE, fetch[act],
                                _SL_NODE, wait=True)
            data = yield ctx.spm_read(base, pipeline_k * _SL_NODE)
            rows = data.view(np.uint64).reshape(pipeline_k, _ROW)
            n_sent = int(sentinel[act].sum())
            yield ctx.cost(insts=6 * n_sent + 8 * (act.size - n_sent))
            for si in act:
                got = rows[si]
                target = tq[slot_q[si]]
                if sentinel[si]:
                    node[si] = got                   # snapshot (see above)
                    sentinel[si] = False
                    lv[si] = _SL_LEVELS - 1
                elif got[0] <= target:
                    node[si] = got                   # accept, stay at level
                elif node[si, 0] == target:
                    finish(si)                       # reject -> hit
                    continue
                else:
                    lv[si] -= 1                      # reject -> descend
                # local descent to the next fetchable forward pointer
                while lv[si] >= 0:
                    nxt = node[si, 4 + lv[si]]
                    if nxt != NIL:
                        fetch[si] = int(nxt)
                        break
                    if node[si, 0] == target:
                        break
                    lv[si] -= 1
                else:
                    finish(si)                       # levels exhausted
                    continue
                if node[si, 4 + lv[si]] == NIL:      # stopped on hit check
                    finish(si)

    if vector:
        # fold the scalar port's concurrency into coroutines-of-K (see the
        # LL port): each task streams lookups through refilled slots
        coroutines = max(1, min(coroutines, lookups) // pipeline_k)
    qsplit = np.array_split(np.arange(lookups), coroutines)
    if vector:
        tasks = [vtask(c, q) for c, q in enumerate(qsplit) if len(q)]
    else:
        tasks = [task(c, list(q)) for c, q in enumerate(qsplit) if len(q)]
    expect = vals[q_idx]

    def verify(mem_out: np.ndarray) -> bool:
        return bool(np.array_equal(found, expect))

    if vector:
        cfg = _vec_cfg(_SL_NODE, coroutines, pipeline_k,
                       data_bytes=coroutines * pipeline_k * _SL_NODE)
    else:
        cfg = _cfg(_SL_NODE,
                   spm_bytes=_fit_spm(coroutines * 2 * _SL_NODE, 256))
    return WorkloadInstance("SL", mem, tasks, lookups, cfg, verify,
                            vector=vector)


# =========================================================================
# BFS — Graph500-style level-synchronous BFS (frontier parallelism)
# =========================================================================
@_workload("BFS", profile=IterationProfile(insts=12, chase=1, indep_loads=1,
                                           stores=0.4, local_frac=0.2,
                                           mlp_cap=10, local_cycles=30),
           vector=True, frontier=True,
           description="level-synchronous BFS per-edge unit")
def build_bfs(seed: int = 0, n_vertices: int = 2048, n_edges: int = 32768,
              coroutines: int = 224, vector: bool = False) -> WorkloadInstance:
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_vertices, size=n_edges)
    dst = rng.integers(0, n_vertices, size=n_edges)
    # undirected CSR
    u = np.concatenate([src, dst])
    v = np.concatenate([dst, src])
    order = np.argsort(u, kind="stable")
    u, v = u[order], v[order]
    degs = np.bincount(u, minlength=n_vertices)
    offs = np.zeros(n_vertices + 1, np.int64)
    np.cumsum(degs, out=offs[1:])
    adj = v.astype(np.int32)
    # far memory: [adjacency int32 array | parent int64 array]
    adj_bytes = adj.size * 4
    parent = np.full(n_vertices, -1, np.int64)
    root = int(u[0])
    parent[root] = root
    mem = np.concatenate([adj.view(np.uint8),
                          parent.view(np.uint8)]).copy()
    par_off = adj_bytes
    CHUNK = 60  # neighbors per aload (240B; last 8B of the slot = parent slot)

    next_frontier: set = set()

    def expand(c: int, vertices: List[int]):
        spm = c * 256
        pslot = spm + 248
        for uu in vertices:
            lo, hi = int(offs[uu]), int(offs[uu + 1])
            yield ctx.cost(insts=8)
            for base in range(lo, hi, CHUNK):
                cnt = min(CHUNK, hi - base)
                yield ctx.aload(spm, base * 4, cnt * 4)
                data = yield ctx.spm_read(spm, cnt * 4)
                neigh = data.view(np.int32)
                yield ctx.cost(insts=4 * cnt)
                for vv in neigh:
                    vv = int(vv)
                    yield ctx.aload(pslot, par_off + vv * 8, 8)
                    pdata = yield ctx.spm_read(pslot, 8)
                    if pdata.view(np.int64)[0] == -1:
                        yield ctx.spm_write(pslot, np.int64(uu).tobytes())
                        yield ctx.astore(pslot, par_off + vv * 8, 8)
                        next_frontier.add(vv)
                    yield ctx.cost(insts=6)

    # vector port SPM layout per coroutine: 240B neighbor chunk | 8B parent
    # staging slot (holds uu for the AstoreVec scatter) | CHUNK parent slots
    VSLOT = 768

    def vexpand(c: int, vertices: List[int]):
        nbase = c * VSLOT
        stage = nbase + 240
        pbase = nbase + 248
        for uu in vertices:
            lo, hi = int(offs[uu]), int(offs[uu + 1])
            yield ctx.cost(insts=8)
            for base in range(lo, hi, CHUNK):
                cnt = min(CHUNK, hi - base)
                yield ctx.aload(nbase, base * 4, cnt * 4)
                data = yield ctx.spm_read(nbase, cnt * 4)
                neigh = data.view(np.int32).astype(np.int64)
                yield ctx.cost(insts=4 * cnt)
                # one vector fetch of every neighbor's parent word
                yield ctx.aload_vec(pbase + np.arange(cnt) * 8,
                                    par_off + neigh * 8, 8, wait=True)
                pdata = yield ctx.spm_read(pbase, cnt * 8)
                parents = pdata.view(np.int64)
                yield ctx.cost(insts=6 * cnt)
                claim = np.unique(neigh[parents == -1])
                if claim.size:
                    # scatter `uu` from one staging slot to every claimed
                    # parent word (repeated SPM source, vector of targets)
                    yield ctx.spm_write(stage, np.int64(uu).tobytes())
                    yield ctx.astore_vec(np.full(claim.size, stage),
                                         par_off + claim * 8, 8, wait=True)
                    next_frontier.update(int(vv) for vv in claim)

    if vector:
        coroutines = min(coroutines, 64)

    # level-synchronous driver is run by the caller via `rounds`
    def make_round_tasks(frontier: List[int]) -> List:
        next_frontier.clear()
        fsplit = np.array_split(np.array(frontier, dtype=np.int64),
                                min(coroutines, max(1, len(frontier))))
        mk = vexpand if vector else expand
        return [mk(c, list(f)) for c, f in enumerate(fsplit) if len(f)]

    # reference BFS distances
    dist = np.full(n_vertices, -1, np.int64)
    dist[root] = 0
    frontier = [root]
    d = 0
    while frontier:
        nxt = []
        for uu in frontier:
            for k in range(int(offs[uu]), int(offs[uu + 1])):
                vv = int(adj[k])
                if dist[vv] == -1:
                    dist[vv] = d + 1
                    nxt.append(vv)
        frontier = nxt
        d += 1

    cfg = _cfg(256, queue_length=1024) if vector else _cfg(256)
    inst = WorkloadInstance("BFS", mem, [], 2 * n_edges, cfg, lambda m: True,
                            vector=vector)
    inst.make_round_tasks = make_round_tasks            # type: ignore
    inst.next_frontier = next_frontier                  # type: ignore
    inst.root = root                                    # type: ignore

    def verify(mem_out: np.ndarray) -> bool:
        got_parent = mem_out[par_off:par_off + n_vertices * 8].view(np.int64)
        # every reachable vertex has a parent that is exactly one level closer
        for vv in range(n_vertices):
            if dist[vv] > 0:
                p = got_parent[vv]
                if p < 0 or dist[int(p)] != dist[vv] - 1:
                    return False
            if dist[vv] == -1 and got_parent[vv] != -1:
                return False
        return True

    inst.verify = verify
    return inst


# =========================================================================
# IS — NAS integer sort (bucket counting): sequential key blocks (LLP)
# =========================================================================
@_workload("IS", profile=IterationProfile(insts=400, indep_loads=8,
                                          sequential=True, mlp_cap=48,
                                          local_cycles=320),
           vector=True,
           description="bucket counting over sequential 512B key blocks")
def build_is(seed: int = 0, n_keys: int = 65536, block: int = 128,
             coroutines: int = 32, n_buckets: int = 1024,
             vector: bool = False, vec_chunk: int = 8) -> WorkloadInstance:
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, n_buckets, size=n_keys).astype(np.int32)
    mem = keys.view(np.uint8).copy()
    hist = np.zeros(n_buckets, np.int64)      # histogram kept local (cached)
    gran = block * 4
    blocks = n_keys // block

    def task(c: int, lo: int, hi: int):
        spm = c * gran
        for blk in range(lo, hi):
            yield ctx.aload(spm, blk * gran, gran)
            data = yield ctx.spm_read(spm, gran)
            np.add.at(hist, data.view(np.int32), 1)
            yield ctx.cost(insts=3 * block)

    def vtask(c: int, lo: int, hi: int):
        base = c * vec_chunk * gran
        for b0 in range(lo, hi, vec_chunk):
            cnt = min(vec_chunk, hi - b0)
            yield ctx.aload_vec(base + np.arange(cnt) * gran,
                                np.arange(b0, b0 + cnt) * gran, gran,
                                wait=True)
            data = yield ctx.spm_read(base, cnt * gran)
            np.add.at(hist, data.view(np.int32), 1)
            yield ctx.cost(insts=3 * block * cnt)

    if vector:
        coroutines = min(coroutines, 8)
    bounds = np.linspace(0, blocks, coroutines + 1).astype(int)
    mk = vtask if vector else task
    tasks = [mk(c, bounds[c], bounds[c + 1]) for c in range(coroutines)]
    expect = np.bincount(keys, minlength=n_buckets)

    def verify(mem_out: np.ndarray) -> bool:
        return bool(np.array_equal(hist, expect))

    cfg = _vec_cfg(gran, coroutines, vec_chunk,
                   data_bytes=coroutines * vec_chunk * gran) if vector \
        else _cfg(gran)
    return WorkloadInstance("IS", mem, tasks, blocks, cfg, verify,
                            vector=vector)


# =========================================================================
# HPCG — sparse matrix-vector product y = A x (LLP; mixed granularity)
# =========================================================================
@_workload("HPCG", profile=IterationProfile(insts=140, indep_loads=33,
                                            local_frac=0.15, mlp_cap=40,
                                            local_cycles=120),
           vector=True,
           description="SpMV row: 352B row data + 27 x-gathers")
def build_hpcg(seed: int = 0, rows: int = 2048, nnz_per_row: int = 27,
               coroutines: int = 64, vector: bool = False,
               vec_rows: int = 4) -> WorkloadInstance:
    rng = np.random.default_rng(seed)
    cols = rng.integers(0, rows, size=(rows, nnz_per_row)).astype(np.int32)
    vals = rng.standard_normal((rows, nnz_per_row))
    x = rng.standard_normal(rows)
    # far layout: [row data: per row 27*(i32 col + f64 val) packed | x | y]
    row_pad = 352  # 27*12=324 -> pad to 352 for alignment
    packed = np.zeros(rows * row_pad, np.uint8)
    for r in range(rows):
        base = r * row_pad
        packed[base:base + nnz_per_row * 4] = cols[r].view(np.uint8)
        packed[base + nnz_per_row * 4:base + nnz_per_row * 4 + nnz_per_row * 8] \
            = vals[r].view(np.uint8)
    x_off = rows * row_pad
    y_off = x_off + rows * 8
    mem = np.concatenate([packed, x.view(np.uint8),
                          np.zeros(rows * 8, np.uint8)]).copy()

    def task(c: int, lo: int, hi: int):
        spm = c * 512
        xs = spm + 352
        for r in range(lo, hi):
            yield ctx.aload(spm, r * row_pad, row_pad)
            data = yield ctx.spm_read(spm, row_pad)
            rc = data[:nnz_per_row * 4].view(np.int32)
            rv = data[nnz_per_row * 4:
                      nnz_per_row * 4 + nnz_per_row * 8].view(np.float64)
            acc = 0.0
            # gather x entries: independent 8B aloads, 16 slots in flight
            rids = []
            for j in range(min(16, len(rc))):
                rid = yield ctx.aload(xs + j * 8, x_off + int(rc[j]) * 8,
                                      8, wait=False)
                rids.append(rid)
            for j in range(len(rc)):
                yield ctx.await_rid(rids[j])
                xd = yield ctx.spm_read(xs + (j % 16) * 8, 8)
                acc += rv[j] * xd.view(np.float64)[0]
                yield ctx.cost(insts=4)
                if j + 16 < len(rc):   # refill the freed slot
                    rid = yield ctx.aload(xs + (j % 16) * 8,
                                          x_off + int(rc[j + 16]) * 8, 8,
                                          wait=False)
                    rids.append(rid)
            yield ctx.spm_write(spm, np.float64(acc).tobytes())
            yield ctx.astore(spm, y_off + r * 8, 8)

    def vtask(c: int, lo: int, hi: int):
        # per-coroutine SPM layout: vec_rows row slots | vec_rows*27 x-slots
        # | vec_rows y-slots.  Row gather -> one AloadVec per batch of rows.
        stride = vec_rows * (row_pad + nnz_per_row * 8 + 8)
        rbase = c * stride
        xbase = rbase + vec_rows * row_pad
        ybase = xbase + vec_rows * nnz_per_row * 8
        for r0 in range(lo, hi, vec_rows):
            cnt = min(vec_rows, hi - r0)
            yield ctx.aload_vec(rbase + np.arange(cnt) * row_pad,
                                (r0 + np.arange(cnt)) * row_pad, row_pad,
                                wait=True)
            rcs, rvs = [], []
            for i in range(cnt):
                data = yield ctx.spm_read(rbase + i * row_pad, row_pad)
                rcs.append(data[:nnz_per_row * 4].view(np.int32))
                rvs.append(data[nnz_per_row * 4:
                                nnz_per_row * 4 + nnz_per_row * 8]
                           .view(np.float64))
            cols_flat = np.concatenate(rcs).astype(np.int64)
            yield ctx.aload_vec(xbase + np.arange(cnt * nnz_per_row) * 8,
                                x_off + cols_flat * 8, 8, wait=True)
            xdata = yield ctx.spm_read(xbase, cnt * nnz_per_row * 8)
            xv = xdata.view(np.float64)
            accs = np.empty(cnt)
            for i in range(cnt):
                acc = 0.0
                for j in range(nnz_per_row):   # scalar-port accumulation order
                    acc += rvs[i][j] * xv[i * nnz_per_row + j]
                accs[i] = acc
                yield ctx.cost(insts=4 * nnz_per_row)
            yield ctx.spm_write(ybase, accs)
            yield ctx.astore_vec(ybase + np.arange(cnt) * 8,
                                 y_off + (r0 + np.arange(cnt)) * 8, 8,
                                 wait=True)

    if vector:
        coroutines = min(coroutines, 8)
    bounds = np.linspace(0, rows, coroutines + 1).astype(int)
    mk = vtask if vector else task
    tasks = [mk(c, bounds[c], bounds[c + 1]) for c in range(coroutines)]
    expect = np.einsum("rj,rj->r", vals, x[cols])

    def verify(mem_out: np.ndarray) -> bool:
        got = mem_out[y_off:y_off + rows * 8].view(np.float64)
        return bool(np.allclose(got, expect))

    cfg = _cfg(512, queue_length=1024) if vector else _cfg(512)
    return WorkloadInstance("HPCG", mem, tasks, rows, cfg, verify,
                            vector=vector)


# =========================================================================
# Redis — YCSB-B-style KV service: local buckets, far collision lists (RLP)
# =========================================================================
@_workload("Redis", profile=IterationProfile(insts=40, chase=1.5,
                                             stores=0.05, mlp_cap=11,
                                             local_cycles=70),
           vector=True, pipelined=True, locked=True, distinct=True,
           description="YCSB-B KV: local buckets, far collision lists")
def build_redis(seed: int = 0, n_keys: int = 4096, buckets: int = 4096,
                ops: int = 2048, coroutines: int = 256,
                update_frac: float = 0.05, vector: bool = False,
                pipeline_k: int = 16,
                distinct: bool = False) -> WorkloadInstance:
    rng = np.random.default_rng(seed)
    keys, vals, heads, nodes = _build_chains(rng, n_keys, buckets)
    mem = nodes.view(np.uint8).copy()
    op_keys = keys[rng.integers(0, n_keys, size=ops)]
    op_upd = rng.random(ops) < update_frac
    if distinct:
        # at most one update per key (later conflicting updates demoted to
        # lookups): final far-memory bytes become schedule-independent, so
        # differential tests can pin vector runs to the scalar port exactly
        seen: set = set()
        for oi in np.nonzero(op_upd)[0]:
            k = int(op_keys[oi])
            if k in seen:
                op_upd[oi] = False
            else:
                seen.add(k)
    op_newval = rng.integers(1, 1 << 62, size=ops, dtype=np.uint64)
    got_vals = np.zeros(ops, np.uint64)

    def task(c: int, os_: Iterable[int]):
        spm = c * _NODE
        for oi in os_:
            target = int(op_keys[oi])
            head = int(heads[target % buckets])    # bucket array local
            yield ctx.cost(insts=10)                   # parse request + hash
            yield ctx.acquire(target)
            off, v = yield from _chase_chain(spm, head, target)
            if op_upd[oi]:
                yield ctx.spm_write(spm + 8, op_newval[oi].tobytes())
                yield ctx.astore(spm + 8, off + 8, 8)
            else:
                got_vals[oi] = v
            yield ctx.release(target)
            yield ctx.cost(insts=8)                    # format reply

    def vtask(c: int, os_: "np.ndarray"):
        base = c * pipeline_k * _NODE
        for batch in _distinct_key_batches(os_, op_keys, pipeline_k):
            targets = op_keys[batch]
            locks = _lock_set(targets)
            yield ctx.cost(insts=10 * batch.size)
            yield ctx.acquire_vec(locks)           # one hop, ascending order
            offs, v = yield from _chase_chain_vec(
                base, heads[targets % buckets], targets)
            upd = op_upd[batch]
            ui = np.nonzero(upd)[0]
            for i in ui:
                yield ctx.spm_write(int(base + i * _NODE + 8),
                                    op_newval[batch[i]].tobytes())
            if ui.size:
                yield ctx.astore_vec(base + ui * _NODE + 8,
                                     offs[ui] + 8, 8, wait=True)
            got_vals[batch[~upd]] = v[~upd]
            yield ctx.release_vec(locks)
            yield ctx.cost(insts=8 * batch.size)

    if vector:
        coroutines = min(coroutines, 32)
    osplit = np.array_split(np.arange(ops), coroutines)
    if vector:
        tasks = [vtask(c, o) for c, o in enumerate(osplit) if len(o)]
    else:
        tasks = [task(c, list(o)) for c, o in enumerate(osplit) if len(o)]

    final = dict(zip(keys.tolist(), vals.tolist()))
    for oi in range(ops):
        if op_upd[oi]:
            final[int(op_keys[oi])] = op_newval[oi]
    key_to_node = {int(k): i for i, k in enumerate(keys)}

    def verify(mem_out: np.ndarray) -> bool:
        got = mem_out.view(np.uint64)
        # final value of every updated key must be one of the writes or orig
        for oi in range(ops):
            k = int(op_keys[oi])
            node_val = got[4 * key_to_node[k] + 1]
            cand = {int(vals[key_to_node[k]])} | {
                int(op_newval[j]) for j in range(ops)
                if op_upd[j] and int(op_keys[j]) == k}
            if int(node_val) not in cand:
                return False
        return True

    cfg = _vec_cfg(_NODE, coroutines, pipeline_k) if vector else _cfg(_NODE)
    inst = WorkloadInstance("Redis", mem, tasks, ops, cfg, verify,
                            vector=vector)
    inst.disambiguation = True
    return inst


# =========================================================================
# Registration lives on the builders (@_workload above each): one entry per
# workload in repro_torch.amu.REGISTRY, carrying the builder, the baseline
# IterationProfile, and declared capabilities (vector/pipelined/locked/
# distinct/frontier, LLVM rebuild kwargs).
#
# Profiles: `mlp_cap`/`local_cycles` pairs for the additive (Little's-law)
# baseline mode are FITTED against the paper's Table 4 curves (GUPS, HJ,
# STREAM) and transferred to structurally similar workloads; window-mode
# profiles (chase-dominated) derive concurrency from ROB/LSQ occupancy.
# =========================================================================
