"""The port's copy of the AMU engines, far-memory model and address set
against the reference's: `repro_torch.core` vs `repro.core`.

Both copies run the same numpy operations in the same order, so the
tolerance is zero: one seeded aload / astore / getfin sequence (with
`aload_batch` / `astore_batch` / `getfin_all`) gives equal request IDs, done
times, statuses, traces, stats and SPM / far-memory bytes, and one seeded
issue sequence gives equal completion times, statuses, MLP and link and
region accounting. Nothing here is a tolerance check."""
import numpy as np
import pytest

import repro.configs.base as jbase
import repro.core.disambiguation as jdisamb
import repro.core.engine as jengine
import repro.core.farmem as jfarmem
import repro.core.hostjit as jhostjit
import repro_torch.configs.base as tbase
import repro_torch.core.disambiguation as tdisamb
import repro_torch.core.engine as tengine
import repro_torch.core.farmem as tfarmem
import repro_torch.core.hostjit as thostjit

PKGS = {"reference": (jbase, jengine, jfarmem, jdisamb),
        "port": (tbase, tengine, tfarmem, tdisamb)}
FARS = ["instant", "flat", "backpressure", "bimodal+faults", "regions"]


def _far_config(fm, kind):
    """A far-memory config of `fm` (one package's farmem module)."""
    if kind == "flat":
        return fm.FarMemoryConfig.from_latency_us(1.0)
    if kind == "backpressure":
        return fm.FarMemoryConfig.from_latency_us(
            0.5, max_inflight=6, distribution=fm.LognormalLatency(0.4))
    if kind == "bimodal+faults":
        return fm.FarMemoryConfig.from_latency_us(
            1.0, distribution=fm.BimodalTail(0.1, 8.0),
            faults=fm.FaultModel(error_prob=0.05, drop_prob=0.05,
                                 flaps=(fm.LinkFlap(2000.0, 3000.0),)))
    assert kind == "regions"
    return fm.FarMemoryConfig(regions=(
        fm.FarMemoryRegion.from_latency_us("local", 0, 2048, 0.1),
        fm.FarMemoryRegion.from_latency_us(
            "cxl", 2048, 2048, 1.0, link="switch",
            distribution=fm.UniformJitter(0.2)),
        fm.FarMemoryRegion.from_latency_us(
            "xswitch", 4096, 4096, 5.0, link="switch", max_inflight=4,
            distribution=fm.BimodalTail(0.05, 8.0),
            faults=fm.FaultModel(error_prob=0.1, drop_prob=0.05),
            failover="cxl")))


def _far(fm, kind, timeout_cycles=0.0):
    if kind == "instant":
        return fm.InstantMemory()
    return fm.FarMemoryModel(_far_config(fm, kind),
                             timeout_cycles=timeout_cycles)


def _drive_engine(pkg, kind, far_kind, seed, qlen=24, rounds=80):
    """Apply one seeded AMI sequence to an engine of `pkg`; returns what
    every call returned, and the engine."""
    base, engine, fm, _ = PKGS[pkg]
    cfg = base.EngineConfig(queue_length=qlen, granularity=8,
                            spm_bytes=64 * 1024, batch_ids=5)
    e = engine.make_engine(kind, cfg, _far(fm, far_kind), record_trace=True)
    rng = np.random.default_rng(seed)
    e.mem[:8192] = rng.integers(0, 256, 8192).astype(np.uint8)
    out, t = [], 0.0
    for _ in range(rounds):
        op = rng.choice(["aload", "astore", "getfin", "advance", "write",
                         "read", "aload_batch", "astore_batch",
                         "getfin_all"],
                        p=[.15, .1, .15, .2, .05, .05, .1, .05, .15])
        # aloads land in [0, 512) of the SPM, the core's own reads and
        # writes use [512, 1024), and astores send from either
        spm = int(rng.integers(0, 64)) * 8
        addr = int(rng.integers(0, 1000)) * 8
        if op in ("aload", "astore"):
            spm += 512 * int(op == "astore" and rng.random() < 0.5)
            rid = getattr(e, op)(spm, addr, 8)
            out.append((op, rid, e.done_time(rid) if rid else None))
        elif op == "getfin":
            out.append((op, e.getfin(), e.fin_status))
        elif op == "advance":
            t += float(rng.uniform(0.0, 4000.0))
            e.advance(t)
        elif op == "write":
            e.spm_write(512 + spm, rng.integers(0, 256, 8).astype(np.uint8))
        elif op == "read":
            out.append((op, e.spm_read(512 + spm, 8).tolist()))
        elif op in ("aload_batch", "astore_batch"):
            n = int(rng.integers(1, qlen + 4))     # may overshoot the pool
            spms = rng.integers(0, 64, n) * 8
            addrs = rng.integers(0, 1000, n) * 8
            rids = np.asarray(getattr(e, op)(spms, addrs,
                                             np.full(n, 8, np.int64)))
            out.append((op, rids.tolist(),
                        np.asarray(e.done_times(rids[rids > 0])).tolist()))
        else:
            fins = e.getfin_all()
            st = e.fin_statuses
            out.append((op, list(fins),
                        None if st is None else np.asarray(st).tolist()))
        out.append(("free", e.free_ids, e.outstanding, e.finished_pending))
        e.check_invariants()
    e.drain()
    out.append(("drained", list(e.getfin_all())))
    return out, e


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("far_kind", FARS)
@pytest.mark.parametrize("kind", ["scalar", "batched"])
def test_engine_sequence_equals_reference(kind, far_kind, seed):
    ref_out, ref = _drive_engine("reference", kind, far_kind, seed)
    port_out, port = _drive_engine("port", kind, far_kind, seed)
    assert port_out == ref_out
    assert port.trace == ref.trace
    assert port.stats == ref.stats
    assert (port.host_entries, port.host_rows) == \
        (ref.host_entries, ref.host_rows)
    assert np.array_equal(port.spm, ref.spm)
    assert np.array_equal(port.mem, ref.mem)
    assert port.now == ref.now


def test_engine_kinds_and_constants_equal_reference():
    assert sorted(tengine.ENGINE_KINDS) == sorted(jengine.ENGINE_KINDS)
    assert (tengine.LOAD, tengine.STORE, tengine.AMART_ENTRY_BYTES) == \
        (jengine.LOAD, jengine.STORE, jengine.AMART_ENTRY_BYTES)
    for pkg in PKGS.values():
        base, engine, _, _ = pkg
        with pytest.raises(engine.SpmOverflow, match="needs"):
            engine.make_engine("scalar", base.EngineConfig(
                queue_length=4096, spm_bytes=1024))
    assert (tfarmem.STATUS_OK, tfarmem.STATUS_ERROR,
            tfarmem.STATUS_TIMED_OUT) == (jfarmem.STATUS_OK,
                                          jfarmem.STATUS_ERROR,
                                          jfarmem.STATUS_TIMED_OUT)


def _drive_far(fm, far_kind, seed, timeout_cycles):
    """One seeded mix of `issue`, `issue_batch` and `issue_epoch`."""
    far = _far(fm, far_kind, timeout_cycles)
    rng = np.random.default_rng(seed)
    out, now = [], 0.0
    for _ in range(30):
        now += float(rng.uniform(0.0, 1500.0))
        op = int(rng.integers(0, 3))
        if op == 0:
            addr = int(rng.integers(0, 1000)) * 8
            out.append(("issue", far.issue(now, 8, addr), far.last_status))
        elif op == 1:
            n = int(rng.integers(1, 20))
            addrs = rng.integers(0, 1000, n) * 8
            done = far.issue_batch(now, np.full(n, 8.0), addrs)
            st = far.last_statuses
            out.append(("batch", done.tolist(),
                        None if st is None else st.tolist()))
        else:
            segs = int(rng.integers(1, 4))
            counts = rng.integers(1, 8, segs)
            bounds = np.concatenate([[0], np.cumsum(counts)])
            nows = now + np.cumsum(rng.uniform(0.0, 200.0, segs))
            addrs = rng.integers(0, 125, int(bounds[-1])) * 64
            done = far.issue_epoch(nows, bounds,
                                   np.full(int(bounds[-1]), 64.0), addrs)
            st = far.last_statuses
            out.append(("epoch", done.tolist(),
                        None if st is None else st.tolist()))
            now = float(nows[-1])
        out.append(("inflight", far.inflight_at(now)))
    total = now + 50000.0
    out.append(("totals", far.requests, far.bytes_moved, far.avg_mlp(total),
                far.link_occupancy(total), far.region_stats(total),
                far.faults_injected, far.errors, far.timeouts))
    return out


@pytest.mark.parametrize("timeout_cycles", [0.0, 6000.0])
@pytest.mark.parametrize("far_kind", FARS[1:])
def test_far_memory_model_equals_reference(far_kind, timeout_cycles):
    assert _drive_far(tfarmem, far_kind, 7, timeout_cycles) == \
        _drive_far(jfarmem, far_kind, 7, timeout_cycles)


@pytest.mark.parametrize("n", [1, 5, 300])
def test_latency_distributions_draw_the_same_bitstream(n):
    for name, args in (("UniformJitter", (0.3,)), ("LognormalLatency", (0.5,)),
                       ("BimodalTail", (0.1, 6.0))):
        a = getattr(jfarmem, name)(*args)
        b = getattr(tfarmem, name)(*args)
        ra, rb = np.random.default_rng(n), np.random.default_rng(n)
        assert np.array_equal(np.asarray(a.draw(ra, n)),
                              np.asarray(b.draw(rb, n)))
        assert a.draw(ra) == b.draw(rb)


def test_far_memory_config_refusals_equal_reference():
    for fm in (jfarmem, tfarmem):
        with pytest.raises(ValueError, match="two spellings"):
            fm.FarMemoryConfig(jitter_frac=0.1,
                               distribution=fm.BimodalTail())
        with pytest.raises(ValueError, match="faults per region"):
            fm.FarMemoryConfig(
                regions=(fm.FarMemoryRegion("a", 0, 64, 10.0),),
                faults=fm.FaultModel(error_prob=0.1))


def test_hostjit_fallback_is_the_same_in_both_packages():
    """Neither package's environment has numba here, so both take the numpy
    path; the probe and the getters agree."""
    assert thostjit.numba_available() == jhostjit.numba_available()
    for flag in (False, True):
        assert (thostjit.get_chain(flag) is None) == \
            (jhostjit.get_chain(flag) is None)
        assert (thostjit.get_seq_sum(flag) is None) == \
            (jhostjit.get_seq_sum(flag) is None)


def _drive_cuckoo(disamb, seed, slots):
    s = disamb.CuckooAddressSet(slots_per_table=slots, num_tables=2)
    rng = np.random.default_rng(seed)
    held, out = [], []
    for i in range(400):
        if held and rng.random() < 0.45:
            addr = held.pop(int(rng.integers(0, len(held))))
            waiter = s.end_access(addr)
            out.append(("end", addr, waiter))
            if waiter is not None:
                held.append(addr)             # ownership passed on
        else:
            addr = int(rng.integers(0, 256)) * 64
            ok = s.start_access(addr, waiter=i)
            out.append(("start", addr, ok))
            if ok:
                held.append(addr)
        out.append(s.active_count())
    out.append((s.probes, s.inserts, s.conflicts, s.overflow_inserts))
    return out


@pytest.mark.parametrize("slots", [4, 64])
@pytest.mark.parametrize("seed", [0, 3])
def test_cuckoo_address_set_equals_reference(seed, slots):
    assert _drive_cuckoo(tdisamb, seed, slots) == \
        _drive_cuckoo(jdisamb, seed, slots)
