"""The port's whole quickstart against the reference's simulator:
`repro_torch.launch.quickstart` vs the session, rack and window model of
`repro.amu` / `repro.core`, as `examples/quickstart.py` drives them.

The simulator figures come from the same numpy operations in both packages,
so they are held equal with zero tolerance; the kernel part runs its plain
version on the CPU and is checked exactly, as on the card."""
import inspect

import pytest

import repro.amu as jamu
import repro.core.simulator as jsim
from repro_torch.launch import quickstart

# examples/quickstart.py's rack shape
GUPS_KW = dict(table_words=8192, updates=2048, coroutines=128)


def _reference_sweep():
    rows = []
    for lat in (0.2, 1.0, 5.0):
        base = jsim.run("GUPS", "baseline", lat)
        with jamu.AmuSession(jamu.AmuConfig(latency_us=lat)) as s:
            amu = s.run("GUPS")
        assert amu.verified
        rows.append((lat, base["us"], amu.us, base["us"] / amu.us, amu.mlp))
    return rows


def _reference_rack():
    with jamu.RackSession(jamu.AmuConfig(cores=4)) as r:
        rack = r.run("GUPS", **GUPS_KW)
    with jamu.AmuSession(jamu.AmuConfig()) as s:
        solo = s.run("GUPS", **GUPS_KW)
    assert rack.verified
    return (rack.aggregate_gups / (solo.units / solo.us / 1e3),
            rack.fairness, rack.link_occupancy["far"]["occupancy"])


def test_quickstart_prints_the_references_figures_and_exits_0(capsys):
    assert quickstart.GUPS_KW == GUPS_KW
    assert quickstart.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    for lat, base_us, amu_us, speedup, mlp in _reference_sweep():
        assert (f"{lat:7.1f}u {base_us:9.1f}u {amu_us:9.1f}u "
                f"{speedup:7.2f}x {mlp:8.1f}\n") in out
    agg, fair, occ = _reference_rack()
    assert (f"aggregate {agg:.2f}x one core | Jain fairness {fair:.3f} | "
            f"shared-link occupancy {occ:.1%}\n") in out
    assert "modelled" in out
    assert "int32 table, 512 updates, cpu): OK" in out
    assert "MISMATCH" not in out and "wrong" not in out


def test_quickstart_parts_equal_the_reference_exactly():
    rows = quickstart.latency_sweep()
    assert [(r["latency_us"], r["baseline_us"], r["amu_us"], r["speedup"],
             r["mlp"]) for r in rows] == _reference_sweep()
    assert all(r["verified"] for r in rows)
    rack = quickstart.rack()
    assert (rack["aggregate_x"], rack["fairness"], rack["occupancy"]) == \
        _reference_rack()
    assert rack["verified"]


@pytest.mark.parametrize("part", ["latency_sweep", "rack", "gups"])
def test_quickstart_fails_on_an_unverified_run(monkeypatch, capsys, part):
    real = getattr(quickstart, part)

    def broken(*args, **kw):
        res = real(*args, **kw)
        if part == "latency_sweep":
            res[1]["verified"] = False
        elif part == "rack":
            res["verified"] = False
        else:
            res["ok"] = False
        return res
    monkeypatch.setattr(quickstart, part, broken)
    assert quickstart.main(["--device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert ("MISMATCH" if part == "gups" else "wrong!") in out


def test_quickstart_kernel_part_defaults_to_the_card():
    """The simulator parts are host-side by design; the kernel part asks
    for the card unless told otherwise."""
    assert inspect.signature(quickstart.gups).parameters["device"].default \
        == "cuda"
