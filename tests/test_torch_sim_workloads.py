"""The port's copy of the AMU session, registry, workloads, rack and window
model against the reference's: `repro_torch.amu` / `repro_torch.core` vs
`repro.amu` / `repro.core`.

Both copies run the same numpy operations in the same order, so the
tolerance is zero. Every registered workload runs under both engines, every
scheduler and, where it has one, its vector port, at small builder sizes (the
five of `tests/test_session_api.py`'s `_SMALL` and like sizes for the rest);
its `RunStats` mapping, the engine's trace and stats, and the far-memory and
SPM bytes are equal. `us_per_entry` is wall-clock and stays out, as the
reference's own mapping leaves it out."""
import dataclasses

import pytest

import repro.amu as jamu
import repro.core.coroutines as jcoroutines
import repro.core.simulator as jsim
import repro.core.workloads as jworkloads
import repro_torch.amu as tamu
import repro_torch.core.coroutines as tcoroutines
import repro_torch.core.simulator as tsim
import repro_torch.core.workloads as tworkloads

SMALL = {
    "GUPS": dict(table_words=2048, updates=512, coroutines=64),
    "STREAM": dict(n=8192, coroutines=8),
    "BS": dict(n_elems=2048, searches=96, coroutines=48),
    "HJ": dict(build_keys=512, buckets=512, probes=192, coroutines=48),
    "SL": dict(n_keys=256, lookups=96, coroutines=24),
    "HT": dict(n_keys=512, buckets=256, ops=192, coroutines=48),
    "LL": dict(list_len=64, lookups=24, coroutines=24),
    "BFS": dict(n_vertices=256, n_edges=2048, coroutines=64),
    "IS": dict(n_keys=8192, coroutines=8, n_buckets=256),
    "HPCG": dict(rows=256, coroutines=32),
    "Redis": dict(n_keys=512, buckets=512, ops=192, coroutines=48),
    "paged_kv_serve": dict(requests=16),
}
# the rack shape of examples/quickstart.py
RACK_KW = dict(table_words=8192, updates=2048, coroutines=128)


def _cases():
    for name in jamu.REGISTRY.names():
        vectors = (False, True) if jamu.REGISTRY[name].vector else (False,)
        for engine in ("scalar", "batched"):
            for scheduler in jcoroutines.SCHEDULER_KINDS:
                for vector in vectors:
                    yield pytest.param(
                        name, engine, scheduler, vector,
                        id=f"{name}-{engine}-{scheduler}"
                           f"{'-vector' if vector else ''}")


def _run(amu, name, sanitize=False, **cfg):
    """One session run of `amu` (one package's `amu`): (stats mapping,
    engine trace, engine stats, far-memory bytes, SPM bytes)."""
    with amu.AmuSession(amu.AmuConfig(sanitize=sanitize, **cfg)) as s:
        st = s.run(name, record_trace=True, **SMALL[name])
        assert st.verified is True
        return (st.to_dict(), s.engine.trace, s.engine.stats,
                s.engine.mem.copy(), s.engine.spm.copy())


def _assert_runs_equal(port, ref):
    assert port[0] == ref[0]
    assert "us_per_entry" not in port[0]
    assert port[1] == ref[1]
    assert port[2] == ref[2]
    assert port[3].tobytes() == ref[3].tobytes()
    assert port[4].tobytes() == ref[4].tobytes()


def test_registry_names_capabilities_and_profiles_equal_reference():
    assert tamu.REGISTRY.names() == jamu.REGISTRY.names()
    assert set(SMALL) == set(jamu.REGISTRY.names())
    for name, jd in jamu.REGISTRY.items():
        td = tamu.REGISTRY[name]
        for f in dataclasses.fields(jd):
            mine, theirs = getattr(td, f.name), getattr(jd, f.name)
            if f.name == "build":
                assert mine.__name__ == theirs.__name__
                assert mine.__module__ == theirs.__module__.replace(
                    "repro.", "repro_torch.", 1)
            elif f.name == "profile":
                assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
            else:
                assert mine == theirs, (name, f.name)
    assert tamu.REGISTRY.vector_names() == jamu.REGISTRY.vector_names()
    assert sorted(tcoroutines.SCHEDULER_KINDS) == \
        sorted(jcoroutines.SCHEDULER_KINDS)
    assert (tamu.FREQ_GHZ, tamu.LINE) == (jamu.FREQ_GHZ, jamu.LINE)
    assert sorted(tamu.__all__) == sorted(jamu.__all__)


@pytest.mark.parametrize("name,engine,scheduler,vector", list(_cases()))
def test_workload_run_equals_reference(name, engine, scheduler, vector):
    cfg = dict(engine=engine, scheduler=scheduler, vector=vector)
    _assert_runs_equal(_run(tamu, name, **cfg), _run(jamu, name, **cfg))


@pytest.mark.parametrize("name", ["GUPS", "HJ", "BFS", "paged_kv_serve"])
@pytest.mark.parametrize("engine", ["scalar", "batched"])
def test_sanitizer_on_gives_the_same_run_in_both_packages(engine, name):
    """`AmuConfig(sanitize=True)` only observes: the run equals the one with
    it off, in both packages, and the two packages agree."""
    runs = {(amu.__name__, on): _run(amu, name, sanitize=on, engine=engine)
            for amu in (jamu, tamu) for on in (False, True)}
    ref = runs[("repro.amu", False)]
    for run in runs.values():
        _assert_runs_equal(run, ref)


@pytest.mark.parametrize("latency_us", [0.2, 1.0, 5.0])
@pytest.mark.parametrize("config", jsim.CONFIG_NAMES)
@pytest.mark.parametrize("workload", ["GUPS", "BS"])
def test_simulator_run_equals_reference(workload, config, latency_us):
    """`simulator.run` at the paper's sizes: the window model for the
    baseline and CXL-ideal cores, the scalar session for the AMU ones."""
    assert tsim.CONFIG_NAMES == jsim.CONFIG_NAMES
    mine = tsim.run(workload, config, latency_us)
    assert mine == jsim.run(workload, config, latency_us)
    assert mine.get("verified", True) is True


def test_simulator_models_equal_reference():
    assert dataclasses.asdict(tsim.BASELINE_CORE) == \
        dataclasses.asdict(jsim.BASELINE_CORE)
    assert dataclasses.asdict(tsim.CXL_IDEAL_CORE) == \
        dataclasses.asdict(jsim.CXL_IDEAL_CORE)
    for name in ("LL", "HPCG"):
        prof = jamu.REGISTRY[name].profile
        tprof = tamu.REGISTRY[name].profile
        for group in (4, 32):
            assert tsim.simulate_group_prefetch(tprof, 256, 1.0, group) == \
                jsim.simulate_group_prefetch(prof, 256, 1.0, group)
    stats = jsim.run("GUPS", "baseline", 1.0)
    assert tsim.PowerModel().power(stats, 1e4) == \
        jsim.PowerModel().power(stats, 1e4)


def _rack(amu, cores):
    with amu.RackSession(amu.AmuConfig(cores=cores, sanitize=False)) as r:
        rack = r.run("GUPS", **RACK_KW)
    assert rack.verified is True
    return rack


@pytest.mark.parametrize("cores", [1, 4])
def test_rack_equals_reference(cores):
    mine, theirs = _rack(tamu, cores), _rack(jamu, cores)
    assert [c.to_dict() for c in mine.cores] == \
        [c.to_dict() for c in theirs.cores]
    for f in dataclasses.fields(theirs):
        if f.name != "cores":
            assert getattr(mine, f.name) == getattr(theirs, f.name), f.name
    assert mine.n_cores == cores


def test_builders_draw_the_same_data():
    """Each builder at its paper size: the same far-memory image, units and
    engine sizing from the same seed."""
    for name in jamu.REGISTRY.names():
        mine = tamu.REGISTRY.build(name, 3)
        theirs = jamu.REGISTRY.build(name, 3)
        assert mine.mem.tobytes() == theirs.mem.tobytes(), name
        assert mine.units == theirs.units
        assert dataclasses.asdict(mine.engine_config) == \
            dataclasses.asdict(theirs.engine_config)
        assert len(mine.tasks) == len(theirs.tasks)
    assert tworkloads.AMART_ENTRY_BYTES == jworkloads.AMART_ENTRY_BYTES
    assert dataclasses.asdict(tworkloads.IterationProfile(insts=5)) == \
        dataclasses.asdict(jworkloads.IterationProfile(insts=5))
