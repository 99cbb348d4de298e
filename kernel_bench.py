#!/usr/bin/env python3
"""Times flash_attention and async_gather of one tree at their main-path shapes.

    python3 kernel_bench.py [--src DIR] [--label NAME]

`--src` is the `src/` directory whose `repro_torch` is timed (this tree's by
default), so that two trees can be compared on one card in one run of the
machine: unpack the other tree (`git archive`) into a directory `.gitignore`
lists and run parent, change, change, parent. Each tree builds its own
kernels under its own `build/`.

Shapes: flash at qwen2.5-3b's prefill (B=4, Hq=16, Hkv=2, S=1000, D=128,
bf16, causal); gather at qwen2.5-3b's embedding table ([151936, 2048] bf16,
4000 ids) and at 2^20 rows of an 8 GiB [2^24, 128] f32 table. For each:
kernel ms (CUDA events, mean of back-to-back calls, best of 5 windows, as in
chip_smoke.py), host us a call (perf_counter over 50 calls without a
synchronise), the library call's ms (`scaled_dot_product_attention`,
`index_select`: yardsticks the port never calls), and the bound. Prints one
JSON line, then the card's name and power limit. Needs one NVIDIA card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--label", default="this tree")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_bench: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    import chip_smoke as cs              # timing, shapes and bounds
    sys.path.insert(0, os.path.abspath(args.src))
    import torch.nn.functional as F
    from repro_torch.kernels import async_gather as ag
    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    b, hq, hkv, s, d = cs.BATCH, 16, 2, cs.PROMPT_LEN, 128
    q, k, v = cs.flash_case(gen, b, hq, hkv, s, d, torch.bfloat16)
    rows.append(dict(
        kernel="flash_attention", case=f"B{b} Hq{hq} Hkv{hkv} S{s} D{d} bf16",
        ms=cs.time_ms([lambda: fa.flash_attention(q, k, v)], 20),
        host_us=cs.host_us(lambda: fa.flash_attention(q, k, v)),
        library_ms=cs.time_ms([lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True)], 10),
        bound_ms=cs.flash_bound(b, hq, hkv, s, d, 0, torch.bfloat16)[0]))
    del q, k, v
    for shape, dtype, m, what in [((151936, 2048), torch.bfloat16, 4000,
                                   "embedding"),
                                  ((1 << 24, 128), torch.float32, 1 << 20,
                                   "8 GiB")]:
        table = cs.amu_table(gen, shape, dtype)
        idx = cs.amu_index(gen, shape[0], m)
        if not torch.equal(ag.async_gather(table, idx),
                           torch.index_select(table, 0, idx)):
            raise AssertionError(f"gather {what}: wrong rows")
        row_bytes = shape[1] * table.element_size()
        touched = torch.unique(idx).numel()
        rows.append(dict(
            kernel="async_gather", case=f"{what} {list(shape)} {m} rows",
            ms=cs.time_ms([lambda: ag.async_gather(table, idx)], 20),
            host_us=cs.host_us(lambda: ag.async_gather(table, idx)),
            library_ms=cs.time_ms([lambda: torch.index_select(table, 0, idx)],
                                  20),
            library_host_us=cs.host_us(
                lambda: torch.index_select(table, 0, idx)),
            bound_ms=cs.amu_bound(touched * row_bytes + m * row_bytes
                                  + m * 4)[0]))
        del table, idx
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    for r in rows:
        print(f"{args.label}: {r['kernel']} {r['case']}: kernel "
              f"{r['ms']:.4f} ms, host {r['host_us']:.1f} us a call, library "
              f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms",
              flush=True)
    print(json.dumps({"label": args.label, "src": args.src, "rows": rows}))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
