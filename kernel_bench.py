#!/usr/bin/env python3
"""Times the kernels of one tree at their main-path shapes.

    python3 kernel_bench.py [--src DIR] [--label NAME] [--only NAME ...]

`--src` is the `src/` directory whose `repro_torch` is timed (this tree's by
default), so that two trees can be compared on one card in one run of the
machine: unpack the other tree (`git archive`) into a directory `.gitignore`
lists and run parent, change, change, parent. Each tree builds its own
kernels under its own `build/`.

Shapes: flash at qwen2.5-3b's prefill (B=4, Hq=16, Hkv=2, S=1000, D=128,
bf16, causal); paged at its decode (B=4, Hq=16, Hkv=2, T=1032, D=128, bf16,
lengths [1032, 1001, 517, 64], 16 caches in turn so that each call finds
its cache cold, as `chip_smoke.check_paged` does) and at one sequence of
32768 rows (4 caches in turn); gather at qwen2.5-3b's
embedding table ([151936, 2048] bf16, 4000 ids) and at 2^20 rows of an 8 GiB
[2^24, 128] f32 table; triad at STREAM's f32 N = 2^28. `--only` picks some
of flash, paged, gather, triad. For each: kernel ms (CUDA events, mean of
back-to-back calls, best of 5 windows, as in chip_smoke.py), host us a call
(perf_counter over 50 calls without a synchronise), the library call's ms
(`scaled_dot_product_attention`, `index_select`, `torch.add`: yardsticks the
port never calls), and the bound. Prints one JSON line, then the card's name
and power limit. Needs one NVIDIA card.
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
    ap.add_argument("--only", nargs="*",
                    default=["flash", "paged", "gather", "triad"])
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
    from repro_torch.kernels import paged_attention as pa, ref
    from repro_torch.kernels import stream_triad as st

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    b, hq, hkv, s, d = cs.BATCH, 16, 2, cs.PROMPT_LEN, 128
    if "flash" in args.only:
        rows.append(bench_flash(cs, fa, F, gen, b, hq, hkv, s, d))
    if "paged" in args.only:
        rows.append(bench_paged(cs, pa, ref, F, gen, b, hq, hkv, d))
        rows.append(bench_paged(cs, pa, ref, F, gen, b, hq, hkv, d,
                                long=True))
    if "gather" in args.only:
        rows.extend(bench_gather(cs, ag, gen))
    if "triad" in args.only:
        rows.append(bench_triad(cs, st, gen))
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


def bench_flash(cs, fa, F, gen, b, hq, hkv, s, d):
    q, k, v = cs.flash_case(gen, b, hq, hkv, s, d, torch.bfloat16)
    return dict(
        kernel="flash_attention", case=f"B{b} Hq{hq} Hkv{hkv} S{s} D{d} bf16",
        ms=cs.time_ms([lambda: fa.flash_attention(q, k, v)], 20),
        host_us=cs.host_us(lambda: fa.flash_attention(q, k, v)),
        library_ms=cs.time_ms([lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True)], 10),
        bound_ms=cs.flash_bound(b, hq, hkv, s, d, 0, torch.bfloat16)[0])


def bench_paged(cs, pa, ref, F, gen, b, hq, hkv, d, long=False):
    """The serve shape, or (`long`) one sequence of 32768 rows."""
    t = 32768 if long else cs.PROMPT_LEN + cs.MAX_NEW
    lens = torch.tensor([t] if long else [t, cs.PROMPT_LEN + 1, 517, 64],
                        dtype=torch.int32, device="cuda")
    b = lens.numel()
    sets = [cs.paged_case(gen, b, hq, hkv, t, d, torch.bfloat16)
            for _ in range(4 if long else 16)]
    cs.check_close(f"paged T{t}", pa.paged_attention(*sets[0], lens),
                   ref.paged_attention_ref(*sets[0], lens),
                   **cs.PAGED_BF16_TOL)
    mask = (torch.arange(t, device="cuda")[None, :]
            < lens[:, None])[:, None, None, :]

    def library(x):
        return F.scaled_dot_product_attention(
            x[0][:, :, None], x[1].transpose(1, 2), x[2].transpose(1, 2),
            attn_mask=mask, enable_gqa=True)
    return dict(
        kernel="paged_attention",
        case=f"B{b} Hq{hq} Hkv{hkv} T{t} D{d} bf16 lengths {lens.tolist()}",
        ms=cs.time_ms([lambda x=x: pa.paged_attention(*x, lens)
                       for x in sets], 64),
        host_us=cs.host_us(lambda: pa.paged_attention(*sets[0], lens)),
        library_ms=cs.time_ms([lambda x=x: library(x) for x in sets], 64),
        library_host_us=cs.host_us(lambda: library(sets[0])),
        bound_ms=cs.paged_bound(lens, hq, hkv, d, torch.bfloat16)[0])


def bench_triad(cs, st, gen):
    n = 1 << 28
    b, c = (cs.randn(gen, (n,), torch.float32) for _ in range(2))
    cs.check_close_big("triad f32 N=2^28", st.stream_triad(b, c, 3.0),
                       torch.add(b, c, alpha=3.0),
                       **cs.TRIAD_TOL[torch.float32])
    row = dict(
        kernel="stream_triad", case=f"f32 N={n}",
        ms=cs.time_ms([lambda: st.stream_triad(b, c, 3.0)], 20),
        host_us=cs.host_us(lambda: st.stream_triad(b, c, 3.0)),
        library_ms=cs.time_ms([lambda: torch.add(b, c, alpha=3.0)], 20),
        library_host_us=cs.host_us(lambda: torch.add(b, c, alpha=3.0)),
        bound_ms=cs.amu_bound(3 * n * 4, 2 * n)[0])
    del b, c
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return row


def bench_gather(cs, ag, gen):
    rows = []
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
    return rows


if __name__ == "__main__":
    sys.exit(main())
