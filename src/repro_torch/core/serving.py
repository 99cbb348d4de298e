"""Paged-KV serving as a first-class AMU workload (`paged_kv_serve`).

Multi-tenant LLM serving reduced to its far-memory skeleton: every request
gathers its KV pages — a hot shared-prefix pool that stays in local DRAM,
a per-tenant warm working set on CXL, and a cold pool across the switch —
folds them (the attention stand-in), and appends one new KV page. Requests
arrive on a seeded *open-loop* clock (Poisson, or a bursty diurnal trace)
via :class:`~repro_torch.core.coroutines.WaitUntil`; each records its completion
latency with :class:`~repro_torch.core.coroutines.Now`, so a run reports
per-request p50/p99/p999 alongside throughput
(:class:`~repro_torch.amu.session.RunStats` ``req_*`` fields).

Three data planes, one page/tier layout:

* ``data_plane="ami"`` (default) — the paper's mechanism: ``coroutines``
  workers, asynchronous page gathers (scalar ``aload`` per page, or one
  ``aload_vec`` per request with ``vector=True``), MLP across requests.
* ``data_plane="sync"`` — the page-fault baseline ("A Tale of Two Paths"):
  ONE worker, a trap cost plus one *blocking* fetch per page, MLP ~= 1.
  The AMI-vs-sync latency ratio is the headline of the ``serve`` sweep.

:func:`serve_regions` builds the matching
:class:`~repro_torch.core.farmem.FarMemoryRegion` list (same address split as the
builder), so ``AmuConfig(far=serve_regions())`` routes hot/warm/cold pages
through the PR 5 tiers. The workload also runs against the flat model (any
address resolves) for the smoke gate.

All randomness is drawn at BUILD time from the seed (page pools, per-request
tier composition, arrival times), so the instance — and therefore the
per-request latency trace — is pinned batch/scalar identical under the
existing differential discipline (engines are trace-identical under a fixed
scheduler; tests/test_serving.py).
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from repro_torch.amu.commands import ctx
from repro_torch.amu.config import FREQ_GHZ, far_region
from repro_torch.amu.registry import workload as _workload
from repro_torch.core.farmem import (BimodalTail, FarMemoryRegion, FaultModel,
                                     LatencyDistribution)
from repro_torch.core.workloads import (IterationProfile, WorkloadInstance, _cfg,
                                        _fit_spm)

#: cycles per microsecond at the simulated core clock
_CYC_PER_US = FREQ_GHZ * 1e3

# Default layout (shared by the builder and serve_regions): page counts per
# pool and the per-request gather mix. Scaled down like every workload, but
# keeping the structural character: a small very-hot shared prefix, a
# mid-size per-tenant warm set, a large cold tail.
PAGE_BYTES = 256
HOT_PAGES = 64
WARM_PAGES = 256
COLD_PAGES = 512
REQUESTS = 96
TIER_MIX = (0.5, 0.35, 0.15)        # P(page is hot / warm / cold)

_ARRIVAL_SEED_SALT = 101            # arrivals draw from their own stream


# ========================================================================
# Open-loop arrival processes (seeded, deterministic)
# ========================================================================
def poisson_arrivals(seed: int, n: int, rate_per_us: float) -> np.ndarray:
    """`n` open-loop Poisson arrival times in CYCLES (exponential gaps at
    `rate_per_us` requests/µs), strictly increasing, deterministic in
    `seed` (one Generator array fill — no order dependence to pin)."""
    if rate_per_us <= 0:
        raise ValueError(f"rate_per_us must be > 0, got {rate_per_us}")
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate_per_us, size=n) * _CYC_PER_US
    return np.cumsum(gaps)


def bursty_arrivals(seed: int, n: int, rate_per_us: float,
                    burst_mult: float = 4.0, period_us: float = 8.0,
                    duty: float = 0.2) -> np.ndarray:
    """A bursty diurnal trace in CYCLES: a square-wave rate with a fraction
    `duty` of every `period_us` window at ``burst_mult x`` the base rate and
    the rest at the trough rate that preserves the mean. Implemented by
    time-rescaling unit-rate exponentials through the integrated rate (the
    inversion is exact for a piecewise-constant rate), so the draw is one
    Generator array fill and the trace is deterministic in `seed`."""
    if rate_per_us <= 0:
        raise ValueError(f"rate_per_us must be > 0, got {rate_per_us}")
    if not 0.0 < duty < 1.0:
        raise ValueError(f"duty must be in (0, 1), got {duty}")
    if burst_mult * duty >= 1.0:
        raise ValueError("burst carries the whole mean: need "
                         f"burst_mult*duty < 1, got {burst_mult * duty}")
    rng = np.random.default_rng(seed)
    unit = rng.exponential(1.0, size=n)          # unit-rate arrival masses
    peak = burst_mult * rate_per_us
    trough = (1.0 - duty * burst_mult) / (1.0 - duty) * rate_per_us
    # closed-form inversion of the integrated rate: every period carries
    # exactly `rate_per_us * period_us` mass (mean-preserving), so a
    # cumulative target splits into whole periods + a remainder that lands
    # either in the burst or the trough segment of its period
    targets = np.cumsum(unit)
    mass_period = rate_per_us * period_us
    mass_burst = peak * duty * period_us
    k = np.floor(targets / mass_period)
    rem = targets - k * mass_period
    t_us = np.where(
        rem <= mass_burst,
        k * period_us + rem / peak,
        k * period_us + duty * period_us + (rem - mass_burst) / trough)
    return t_us * _CYC_PER_US


def arrival_times(kind: str, seed: int, n: int, rate_per_us: float,
                  **kw) -> np.ndarray:
    """Dispatch on `kind` ("poisson" | "bursty")."""
    if kind == "poisson":
        return poisson_arrivals(seed, n, rate_per_us)
    if kind == "bursty":
        return bursty_arrivals(seed, n, rate_per_us, **kw)
    raise KeyError(f"unknown arrival process {kind!r}; "
                   "known: 'poisson', 'bursty'")


# ========================================================================
# Page/tier layout
# ========================================================================
def serve_regions(requests: int = REQUESTS, hot_pages: int = HOT_PAGES,
                  warm_pages: int = WARM_PAGES, cold_pages: int = COLD_PAGES,
                  page_bytes: int = PAGE_BYTES, local_us: float = 0.08,
                  cxl_us: float = 1.0, xswitch_us: float = 5.0,
                  tail: Optional[LatencyDistribution] = None,
                  link: Optional[str] = "switch",
                  faults: Optional[FaultModel] = None,
                  failover: Optional[str] = None) -> List[FarMemoryRegion]:
    """The tier list matching the builder's address split: hot pool + the
    per-request output pages in local DRAM, the warm pool on CXL, the cold
    pool across the switch (bimodal congestion tail by default), the two
    far tiers contending on one shared channel. Pass the same size knobs
    here and to the builder; ``AmuConfig(far=serve_regions(...))``.
    ``faults`` attaches a :class:`~repro_torch.core.farmem.FaultModel` to the
    cross-switch tier (the fabric that actually flaps in production) and
    ``failover`` names its post-retry fallback tier (e.g. ``"cxl"``)."""
    if tail is None:
        tail = BimodalTail(0.05, 8.0)
    local_b = (hot_pages + requests) * page_bytes
    warm_b = warm_pages * page_bytes
    cold_b = cold_pages * page_bytes
    return [
        far_region("local", 0, local_b, local_us),
        far_region("cxl", local_b, warm_b, cxl_us, link=link),
        far_region("xswitch", local_b + warm_b, cold_b, xswitch_us,
                   distribution=tail, link=link, faults=faults,
                   failover=failover),
    ]


# ========================================================================
# The workload
# ========================================================================
@_workload("paged_kv_serve",
           profile=IterationProfile(insts=64, indep_loads=8, stores=1,
                                    mlp_cap=8, local_cycles=220),
           vector=True, request_level=True,
           description="multi-tenant paged-KV serving: open-loop arrivals, "
                       "tiered page gathers, per-request tail latency")
def build_paged_kv_serve(seed: int = 0, requests: int = REQUESTS,
                         pages_per_request: int = 8, tenants: int = 4,
                         hot_pages: int = HOT_PAGES,
                         warm_pages: int = WARM_PAGES,
                         cold_pages: int = COLD_PAGES,
                         page_bytes: int = PAGE_BYTES,
                         coroutines: int = 32,
                         arrival: str = "poisson",
                         rate_per_us: float = 2.0,
                         burst_mult: float = 4.0, period_us: float = 8.0,
                         duty: float = 0.2,
                         data_plane: str = "ami",
                         fault_insts: int = 180,
                         fault_cycles: float = 900.0,
                         compute_insts_per_page: int = 64,
                         sync_retries: int = 8,
                         vector: bool = False) -> WorkloadInstance:
    if data_plane not in ("ami", "sync"):
        raise KeyError(f"unknown data_plane {data_plane!r}; "
                       "known: 'ami', 'sync'")
    if page_bytes % 8:
        raise ValueError(f"page_bytes must be a multiple of 8: {page_bytes}")
    rng = np.random.default_rng(seed)
    page_words = page_bytes // 8

    # ------------------------------------------------- address space layout
    # [hot pool][per-request output pages] = local tier, then warm (CXL),
    # then cold (cross-switch) — the serve_regions split.
    hot_off = 0
    out_off = hot_pages * page_bytes
    warm_off = out_off + requests * page_bytes
    cold_off = warm_off + warm_pages * page_bytes
    total = cold_off + cold_pages * page_bytes
    pool = rng.integers(0, 1 << 63, size=total // 8, dtype=np.uint64)
    pool[out_off // 8:warm_off // 8] = 0        # output pages start blank
    mem = pool.view(np.uint8).copy()

    # ------------------------------------- per-request gathers and arrivals
    tier = rng.choice(3, size=(requests, pages_per_request), p=TIER_MIX)
    pick = rng.random(size=(requests, pages_per_request))
    page_addr = np.empty((requests, pages_per_request), np.int64)
    warm_per_tenant = warm_pages // tenants
    for r in range(requests):
        ten = r % tenants                        # tenant-private warm slice
        for j in range(pages_per_request):
            if tier[r, j] == 0:                  # hot: global shared prefix
                pg = int(pick[r, j] * hot_pages)
                page_addr[r, j] = hot_off + pg * page_bytes
            elif tier[r, j] == 1:                # warm: this tenant's set
                pg = ten * warm_per_tenant + int(pick[r, j] * warm_per_tenant)
                page_addr[r, j] = warm_off + pg * page_bytes
            else:                                # cold: anywhere
                pg = int(pick[r, j] * cold_pages)
                page_addr[r, j] = cold_off + pg * page_bytes
    out_addr = out_off + np.arange(requests, dtype=np.int64) * page_bytes
    arrive = arrival_times(arrival, seed + _ARRIVAL_SEED_SALT, requests,
                           rate_per_us, **(dict(burst_mult=burst_mult,
                                                period_us=period_us,
                                                duty=duty)
                                           if arrival == "bursty" else {}))

    lat = np.full(requests, -1.0)                # completion - arrival, cycles
    pool_words = pool.copy()                     # snapshot for the oracle

    # ---------------------------------------------------------- data planes
    def fold(pages_u64: np.ndarray) -> np.ndarray:
        """The attention stand-in: XOR-fold the gathered pages into the
        appended KV page (schedule-independent, cheap to oracle)."""
        return np.bitwise_xor.reduce(pages_u64.reshape(-1, page_words),
                                     axis=0)

    def sync_fallback(spm: int, addr: int, status):
        """Degradation mode: the AMI plane reported a final failure (after
        the scheduler's retries/failover), so fall back to the synchronous
        page-fault plane — pay the trap cost and re-fetch, up to
        `sync_retries` blocking attempts. Returns the final status (0 once
        a fetch lands); a still-failing page is dropped from the fold so
        the request completes degraded instead of wedging the worker."""
        tries = 0
        while status and tries < sync_retries:
            yield ctx.cost(insts=fault_insts, cycles=fault_cycles)
            status = yield ctx.aload(spm, addr, page_bytes)
            tries += 1
        return status

    def ami_task(c: int):
        spm = c * page_bytes
        for r in range(c, requests, coroutines):
            yield ctx.wait_until(arrive[r])
            acc = np.zeros(page_words, np.uint64)
            for addr in page_addr[r]:
                st = yield ctx.aload(spm, int(addr), page_bytes)
                if st:                           # None/0 on the happy path
                    st = yield from sync_fallback(spm, int(addr), st)
                    if st:
                        continue                 # page lost: degraded fold
                data = yield ctx.spm_read(spm, page_bytes)
                acc = acc ^ data.view(np.uint64)
                yield ctx.cost(insts=compute_insts_per_page)
            yield ctx.spm_write(spm, acc)
            yield ctx.astore(spm, int(out_addr[r]), page_bytes)
            t_end = yield ctx.now()
            lat[r] = t_end - arrive[r]

    def ami_vtask(c: int):
        base = c * pages_per_request * page_bytes
        slots = base + np.arange(pages_per_request) * page_bytes
        for r in range(c, requests, coroutines):
            yield ctx.wait_until(arrive[r])
            st = yield ctx.aload_vec(slots, page_addr[r], page_bytes,
                                     wait=True)
            data = yield ctx.spm_read(base, pages_per_request * page_bytes)
            if st is None or not np.any(st):     # zero-fault / all lanes OK
                acc = fold(data.view(np.uint64))
            else:                                # per-lane degradation
                ok = np.ones(pages_per_request, bool)
                for j in np.flatnonzero(st):
                    s2 = yield from sync_fallback(
                        int(slots[j]), int(page_addr[r, j]), int(st[j]))
                    ok[j] = not s2
                data = yield ctx.spm_read(base,
                                          pages_per_request * page_bytes)
                pages = data.view(np.uint64).reshape(-1, page_words)
                acc = (np.bitwise_xor.reduce(pages[ok], axis=0) if ok.any()
                       else np.zeros(page_words, np.uint64))
            yield ctx.cost(insts=compute_insts_per_page * pages_per_request)
            yield ctx.spm_write(base, acc)
            yield ctx.astore(base, int(out_addr[r]), page_bytes)
            t_end = yield ctx.now()
            lat[r] = t_end - arrive[r]

    def sync_task():
        """Page-fault baseline: one worker, a trap + blocking fetch per
        page — no memory-level parallelism anywhere."""
        spm = 0
        for r in range(requests):                # arrivals are sorted
            yield ctx.wait_until(arrive[r])
            acc = np.zeros(page_words, np.uint64)
            for addr in page_addr[r]:
                yield ctx.cost(insts=fault_insts, cycles=fault_cycles)
                st = yield ctx.aload(spm, int(addr), page_bytes)
                if st:
                    st = yield from sync_fallback(spm, int(addr), st)
                    if st:
                        continue
                data = yield ctx.spm_read(spm, page_bytes)
                acc = acc ^ data.view(np.uint64)
                yield ctx.cost(insts=compute_insts_per_page)
            yield ctx.spm_write(spm, acc)
            yield ctx.astore(spm, int(out_addr[r]), page_bytes)
            t_end = yield ctx.now()
            lat[r] = t_end - arrive[r]

    if data_plane == "sync":
        use_vector = False
        tasks = [sync_task()]
        window_bytes, qlen = page_bytes, 256
    elif vector:
        use_vector = True
        coroutines = min(coroutines, requests)
        tasks = [ami_vtask(c) for c in range(coroutines)]
        window_bytes = coroutines * pages_per_request * page_bytes
        qlen = min(2048, max(256, 2 * coroutines * pages_per_request))
    else:
        use_vector = False
        coroutines = min(coroutines, requests)
        tasks = [ami_task(c) for c in range(coroutines)]
        window_bytes = coroutines * page_bytes
        qlen = min(2048, max(256, 2 * coroutines))

    # ------------------------------------------------------------- oracle
    expect = np.empty((requests, page_words), np.uint64)
    for r in range(requests):
        idx = page_addr[r] // 8
        gathered = np.stack([pool_words[i:i + page_words] for i in idx])
        expect[r] = np.bitwise_xor.reduce(gathered, axis=0)

    def verify(mem_out: np.ndarray) -> bool:
        got = mem_out[out_off:out_off + requests * page_bytes] \
            .view(np.uint64).reshape(requests, page_words)
        if not np.array_equal(got, expect):
            return False
        # every request completed after (never before) its arrival
        return bool(np.all(lat >= 0.0))

    cfg = _cfg(page_bytes, queue_length=qlen,
               spm_bytes=_fit_spm(window_bytes, qlen))
    return WorkloadInstance("paged_kv_serve", mem, tasks, requests, cfg,
                            verify, vector=use_vector,
                            request_latency_cycles=lat)
