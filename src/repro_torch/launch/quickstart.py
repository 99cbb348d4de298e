"""Quickstart, the kernel half: the paper's flagship random-access benchmark,
GUPS, as one xor read-modify-write pass over a table through the
`async_scatter` kernel.

The counterpart of "the same mechanism as a TPU kernel" in
`examples/quickstart.py`: a `[4096, 128]` int32 table, 512 updates, 8 slots in
flight, drawn from numpy seed 0 in the reference's order (table, indices,
updates), so the same seed gives the same numbers as the reference.
`ops.scatter_update` applies them and `ref.scatter_update_ref` checks the
result exactly. Every size is an argument: the reference asks for the
paper-sized run by dropping its small sizes, and `--source device` draws a
table too large for the host to fill quickly on the card instead
(`torch.Generator`, other numbers). The quickstart's other half, the
simulated AMU under growing far-memory latency, comes with the port's copy of
the simulator (ROADMAP A10).

Runs on the card unless `--device cpu` is given.

    PYTHONPATH=src python -m repro_torch.launch.quickstart [--device cuda]
"""
from __future__ import annotations

import argparse
import sys
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.kernels import ops, ref
from repro_torch.models.lm import resolve_device

VALUE_BITS = 30         # values in [0, 2^30), as the reference draws them


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
    res = gups(table_rows=args.table_rows, row_width=args.row_width,
               updates=args.updates, num_slots=args.num_slots, seed=args.seed,
               device=args.device, source=args.source)
    print(f"async_scatter (GUPS xor-update, {args.num_slots} slots in "
          f"flight, {args.table_rows}x{args.row_width} int32 table, "
          f"{args.updates} updates, {res['out'].device}):",
          "OK" if res["ok"] else "MISMATCH")
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
