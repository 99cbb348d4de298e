"""The port's copy of the AMI protocol tools against the reference's:
`repro_torch.analysis` (the runtime sanitizer and `amilint`) vs
`repro.analysis`, and the two packages' registries kept apart.

Both copies run the same code on the same inputs, so the tolerance is zero:
a broken port raises the same error with the same message in both packages,
and `lint_source` gives the same findings on the same seeded bad sources."""
import dataclasses
import os
import textwrap

import numpy as np
import pytest

import repro.amu as jamu
import repro.analysis as janalysis
import repro.configs.base as jbase
import repro.core.engine as jengine
import repro.core.workloads as jworkloads
import repro_torch.amu as tamu
import repro_torch.analysis as tanalysis
import repro_torch.configs.base as tbase
import repro_torch.core.engine as tengine
import repro_torch.core.workloads as tworkloads

PKGS = {"reference": (jamu, janalysis, jworkloads),
        "port": (tamu, tanalysis, tworkloads)}
COMBOS = [("scalar", "scalar"), ("batched", "batched"), ("batched", "fused")]


def _leaked(ctx):
    yield ctx.aload(0, 64, 8, wait=False)
    yield ctx.cost(1)


def _racing(ctx):
    rid = yield ctx.aload(0, 64, 8, wait=False)
    _ = yield ctx.spm_read(0, 8)
    yield ctx.await_rid(rid)


def _reversed_locks(ctx):
    def locker(a, b):
        yield ctx.acquire(a)
        yield ctx.acquire(b)
        yield ctx.release(b)
        yield ctx.release(a)
    return [locker(64, 128), locker(128, 64)]


BROKEN = {"leaked": lambda ctx: [_leaked(ctx)],
          "racing": lambda ctx: [_racing(ctx)],
          "lock-order": _reversed_locks}


def _protocol_error(pkg, broken, engine, sched):
    amu, analysis, workloads = PKGS[pkg]
    tasks = BROKEN[broken](amu.ctx)
    inst = workloads.WorkloadInstance(
        "FIXTURE", np.zeros(4096, np.uint8), tasks, 1, workloads._cfg(8),
        lambda m: True, disambiguation=broken == "lock-order")
    cfg = amu.AmuConfig(engine=engine, scheduler=sched, sanitize=True)
    with pytest.raises(AssertionError) as info:
        amu.AmuSession(cfg).run(inst)
    err = info.value
    # the scalar oracle's own overlap assert fires before the sanitizer's
    # on a race, with the same shared message
    if not (broken == "racing" and engine == "scalar"):
        assert isinstance(err, analysis.AmiProtocolError)
    return type(err).__name__, str(err)


@pytest.mark.parametrize("engine,sched", COMBOS)
@pytest.mark.parametrize("broken", sorted(BROKEN))
def test_sanitizer_raises_the_same_error_in_both_packages(broken, engine,
                                                          sched):
    mine = _protocol_error("port", broken, engine, sched)
    theirs = _protocol_error("reference", broken, engine, sched)
    assert mine == theirs
    assert "FIXTURE" in mine[1]


# statement templates of port bodies, clean and broken: `{s}` is an SPM
# address, `{m}` / `{n}` far addresses, `{i}` a counter
SNIPPETS = [
    "yield ctx.aload({s}, {m}, 8, wait=False)",                   # leak
    "r{i} = yield ctx.aload({s}, {m}, 8, wait=False)",            # maybe
    "r{i} = yield ctx.aload({s}, {m}, 8, wait=False)\n"
    "_ = yield ctx.spm_read({s}, 8)\nyield ctx.await_rid(r{i})",   # race
    "r{i} = yield ctx.aload({s}, {m}, 8, wait=False)\n"
    "yield ctx.await_rid(r{i})\n_ = yield ctx.spm_read({s}, 8)",   # clean
    "yield ctx.acquire({m})",
    "yield ctx.release({m})",
    "yield ctx.acquire({n})\nyield ctx.acquire({m})",
    "yield ctx.acquire_vec([{n}, {m}])\nyield ctx.release_vec([{n}, {m}])",
    "yield ctx.cost({i})",
    "yield {i}",                                                  # no command
    "yield ctx.no_such_op({s})",
    "eng.aload({s}, {m})",                                        # bypass
    "if x:\n    r{i} = yield ctx.astore({s}, {m}, 8, wait=False)\n"
    "    yield ctx.await_rid(r{i})",
    "rs = yield ctx.aload_vec([{s}], [{m}], 8, wait=False)\n"
    "yield ctx.await_rids(rs)",
    "yield ctx.aload({s}, {m}, 8)  # amilint: ignore[AMI001]",
]


def _bad_source(seed):
    rng = np.random.default_rng(seed)
    funcs = []
    for f in range(3):
        body = []
        for i in range(int(rng.integers(2, 7))):
            snip = SNIPPETS[int(rng.integers(0, len(SNIPPETS)))]
            m = int(rng.integers(1, 8)) * 64
            body.append(snip.format(s=int(rng.integers(0, 8)) * 8, m=m,
                                    n=m + 64 * int(rng.integers(-1, 2)),
                                    i=i))
        funcs.append(f"def port{f}(ctx, eng, x):\n"
                     + textwrap.indent("\n".join(body), "    ") + "\n")
    return "\n\n".join(funcs)


@pytest.mark.parametrize("seed", range(12))
def test_lint_source_finds_the_same_in_both_packages(seed):
    src = _bad_source(seed)
    mine = [f.to_dict() for f in tanalysis.lint_source(src, "<fixture>")]
    theirs = [f.to_dict() for f in janalysis.lint_source(src, "<fixture>")]
    assert mine == theirs
    assert tanalysis.amilint.render(tanalysis.lint_source(src)) == \
        janalysis.amilint.render(janalysis.lint_source(src))


def test_lint_sources_find_something():
    """The seeded sources are not all clean: every rule the templates can
    break is found somewhere."""
    rules = {f.rule for seed in range(12)
             for f in tanalysis.lint_source(_bad_source(seed))}
    assert len(rules) >= 5, rules


def test_lint_registry_gives_the_same_findings_on_each_packages_ports():
    def key(findings):
        return [(f.rule, f.line, f.message) for f in findings]
    mine, theirs = tanalysis.lint_registry(), janalysis.lint_registry()
    assert key(mine) == key(theirs)
    mine_files = tamu.REGISTRY.source_files()
    theirs_files = jamu.REGISTRY.source_files()
    assert [os.path.basename(p) for p in mine_files] == \
        [os.path.basename(p) for p in theirs_files]
    assert all(os.sep + "repro_torch" + os.sep in p for p in mine_files)
    assert not any(os.sep + "repro_torch" + os.sep in p
                   for p in theirs_files)
    assert tanalysis.amilint.FACADE_METHODS == \
        janalysis.amilint.FACADE_METHODS
    assert tanalysis.amilint.COMMAND_CLASSES == \
        janalysis.amilint.COMMAND_CLASSES


@pytest.mark.parametrize("home,other", [("port", "reference"),
                                        ("reference", "port")])
def test_a_workload_registered_in_one_registry_is_absent_from_the_other(
        home, other):
    amu, workloads = PKGS[home][0], PKGS[home][2]
    name = f"TEST_ONLY_{home}"

    @amu.workload(name, profile=workloads.IterationProfile(insts=4),
                  description="one aload")
    def build(seed=0):
        def task():
            yield amu.ctx.aload(0, 0, 8)
        return workloads.WorkloadInstance(
            name, np.zeros(64, np.uint8), [task()], 1, workloads._cfg(8),
            lambda m: True)
    try:
        assert name in amu.REGISTRY
        assert name not in PKGS[other][0].REGISTRY
        with amu.AmuSession(amu.AmuConfig()) as s:
            assert s.run(name).verified is True
    finally:
        del amu.REGISTRY._defs[name]
    assert name not in amu.REGISTRY
    assert tamu.REGISTRY.names() == jamu.REGISTRY.names()


def test_the_simulator_uses_the_ports_own_engine_config():
    """One `EngineConfig` in the port: the simulator imports the copy in
    `repro_torch.configs`, whose defaults equal the reference's."""
    assert tengine.EngineConfig is tbase.EngineConfig
    assert tworkloads.EngineConfig is tbase.EngineConfig
    assert jengine.EngineConfig is jbase.EngineConfig
    assert dataclasses.asdict(tbase.EngineConfig()) == \
        dataclasses.asdict(jbase.EngineConfig())
