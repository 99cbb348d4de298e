"""Quickstart: the paper's AMI programming model, GUPS three ways.

The counterpart of `examples/quickstart.py`, in its order and at its sizes:
  1. GUPS under growing far-memory latency (0.2, 1, 5 us): the synchronous
     baseline (the simulator's out-of-order window model) against the AMU
     through the session API (`AmuConfig` + `AmuSession.run` on the timed
     engine, the far-memory table real data and verified);
  2. a 4-core rack sharing one far-memory device (`RackSession`) against
     one core;
  3. the same mechanism as a kernel: one GUPS xor read-modify-write pass
     over a table through `ops.scatter_update`, which on the card launches
     the `async_scatter` CUDA kernel.

Parts 1 and 2 run the port's own copy of the simulator (`repro_torch.amu`,
`repro_torch.core`), a host-side model in numpy, as the reference's do: what
they print are the model's figures (modelled microseconds at the model's 3
GHz, modelled MLP), the same on every machine, not times taken on the card.

Part 3 draws a `[4096, 128]` int32 table, 512 updates and 8 slots in flight
from numpy seed 0 in the reference's order (table, indices, updates), so the
same seed gives the same numbers as the reference; `ref.scatter_update_ref`
checks the result exactly. Every size is an argument: the reference asks for
the paper-sized run by dropping its small sizes, and `--source device` draws
a table too large for the host to fill quickly on the card instead
(`torch.Generator`, other numbers). Part 3 runs on the card unless
`--device cpu` is given.

    PYTHONPATH=src python -m repro_torch.launch.quickstart [--device cuda]
"""
from __future__ import annotations

import argparse
import sys
from typing import Any, Dict, List

import numpy as np
import torch

from repro_torch.amu import AmuConfig, AmuSession, RackSession
from repro_torch.core import simulator as sim
from repro_torch.kernels import ops, ref
from repro_torch.models.lm import resolve_device

VALUE_BITS = 30         # values in [0, 2^30), as the reference draws them
LATENCIES_US = (0.2, 1.0, 5.0)
# the reference's shrunken rack shape (its CI smoke); the latency sweep runs
# GUPS at the paper's size
GUPS_KW = dict(table_words=8192, updates=2048, coroutines=128)


def latency_sweep() -> List[Dict[str, Any]]:
    """Part 1: the paper-sized GUPS port at each of `LATENCIES_US`, the
    baseline core against the AMU. Per latency: `latency_us`,
    `baseline_us` and `amu_us` (modelled), `speedup`, `mlp` (the AMU run's
    modelled memory-level parallelism) and `verified` (the far-memory table
    holds what the numpy oracle says)."""
    rows = []
    for lat in LATENCIES_US:
        base = sim.run("GUPS", "baseline", lat)
        with AmuSession(AmuConfig(latency_us=lat)) as s:
            amu = s.run("GUPS")
        rows.append({"latency_us": lat, "baseline_us": base["us"],
                     "amu_us": amu.us, "speedup": base["us"] / amu.us,
                     "mlp": amu.mlp, "verified": amu.verified is True})
    return rows


def rack() -> Dict[str, Any]:
    """Part 2: 4 AMU cores over one shared far-memory device against one
    core, GUPS at `GUPS_KW`. Returns `aggregate_x` (the rack's GUP/s over
    one core's), `fairness` (Jain's index over the cores), `occupancy` (the
    shared link's busy share of the makespan) and `verified`; all
    modelled."""
    with RackSession(AmuConfig(cores=4)) as r:
        stats = r.run("GUPS", **GUPS_KW)
    with AmuSession(AmuConfig()) as s:
        solo = s.run("GUPS", **GUPS_KW)
    return {"aggregate_x": stats.aggregate_gups / (solo.units / solo.us / 1e3),
            "fairness": stats.fairness,
            "occupancy": stats.link_occupancy["far"]["occupancy"],
            "verified": stats.verified is True and solo.verified is True}


def draw(table_rows: int, row_width: int, updates: int, seed: int,
         device: torch.device, source: str):
    """(table [rows, width] int32, indices [updates] int32, updates
    [updates, width] int32). "numpy": the reference's draws from
    `np.random.default_rng(seed)`; "device": `torch.Generator` on `device`."""
    if source == "numpy":
        rng = np.random.default_rng(seed)
        table = rng.integers(0, 1 << VALUE_BITS, (table_rows, row_width))
        idx = rng.integers(0, table_rows, updates)
        upd = rng.integers(0, 1 << VALUE_BITS, (updates, row_width))
        return tuple(torch.from_numpy(a.astype(np.int32)).to(device)
                     for a in (table, idx, upd))
    if source != "device":
        raise ValueError(f"source {source!r} is not numpy or device")
    gen = torch.Generator(device=device).manual_seed(seed)

    def randint(high, shape):
        return torch.randint(0, high, shape, generator=gen, device=device,
                             dtype=torch.int32)
    return (randint(1 << VALUE_BITS, (table_rows, row_width)),
            randint(table_rows, (updates,)),
            randint(1 << VALUE_BITS, (updates, row_width)))


def gups(*, table_rows: int = 4096, row_width: int = 128, updates: int = 512,
         num_slots: int = 8, seed: int = 0, device="cuda",
         source: str = "numpy") -> Dict[str, Any]:
    """One GUPS xor pass through `ops.scatter_update`, checked against the
    plain version. Returns `table`, `indices`, `updates`, `out`, `expect` and
    `ok` (out equals expect exactly)."""
    device = resolve_device(device)
    table, idx, upd = draw(table_rows, row_width, updates, seed, device,
                           source)
    out = ops.scatter_update(table, idx, upd, op="xor", num_slots=num_slots)
    expect = ref.scatter_update_ref(table, idx, upd, op="xor")
    return {"table": table, "indices": idx, "updates": upd, "out": out,
            "expect": expect, "ok": bool(torch.equal(out, expect))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--table-rows", type=int, default=4096)
    ap.add_argument("--row-width", type=int, default=128,
                    help="int32 words a row (HPCC RandomAccess: 2)")
    ap.add_argument("--updates", type=int, default=512)
    ap.add_argument("--num-slots", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--source", choices=("numpy", "device"), default="numpy")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu, where the plain version runs")
    args = ap.parse_args(argv)
    ok = True

    print("=== GUPS under growing far-memory latency (modelled: the "
          "simulator's us at 3 GHz) ===")
    print(f"{'latency':>8s} {'baseline':>10s} {'AMU':>10s} {'speedup':>8s} "
          f"{'AMU MLP':>8s}")
    for row in latency_sweep():
        ok &= row["verified"]
        print(f"{row['latency_us']:7.1f}u {row['baseline_us']:9.1f}u "
              f"{row['amu_us']:9.1f}u {row['speedup']:7.2f}x "
              f"{row['mlp']:8.1f}"
              + ("" if row["verified"] else "  far-memory contents wrong!"))

    print("\n=== 4 cores, one shared far-memory device (RackSession, "
          "modelled) ===")
    r = rack()
    ok &= r["verified"]
    print(f"aggregate {r['aggregate_x']:.2f}x one core | Jain fairness "
          f"{r['fairness']:.3f} | shared-link occupancy {r['occupancy']:.1%}"
          + ("" if r["verified"] else " | far-memory contents wrong!"))

    print("\n=== the same mechanism as a kernel ===")
    res = gups(table_rows=args.table_rows, row_width=args.row_width,
               updates=args.updates, num_slots=args.num_slots, seed=args.seed,
               device=args.device, source=args.source)
    ok &= res["ok"]
    print(f"async_scatter (GUPS xor-update, {args.num_slots} slots in "
          f"flight, {args.table_rows}x{args.row_width} int32 table, "
          f"{args.updates} updates, {res['out'].device}):",
          "OK" if res["ok"] else "MISMATCH")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
