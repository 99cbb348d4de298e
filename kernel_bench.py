#!/usr/bin/env python3
"""Times the kernels of one tree at their main-path shapes.

    python3 kernel_bench.py [--src DIR] [--label NAME] [--only NAME ...]

`--src` is the `src/` directory whose `repro_torch` is timed (this tree's by
default), so that two trees can be compared on one card in one run of the
machine: unpack the other tree (`git archive`) into a directory `.gitignore`
lists and run parent, change, change, parent. Each tree builds its own
kernels under its own `build/`.

Shapes: flash at qwen2.5-3b's prefill (B=4, Hq=16, Hkv=2, S=1000, D=128,
bf16, causal) and at recurrentgemma-9b's (B=4, Hq=16, Hkv=1, S=4096, D=256,
window 2048; its library call takes the window as a boolean mask); paged
at qwen2.5-3b's decode (B=4, Hq=16, Hkv=2, T=1032, D=128, bf16,
lengths [1032, 1001, 517, 64], 16 caches in turn so that each call finds
its cache cold, as `chip_smoke.check_paged` does) and at one sequence of
32768 rows (4 caches in turn). Then head sizes that are not a body's own:
flash at D=8 in qwen2.5-3b's layout (the smoke configs' head size) and at
hubert-xlarge's D=80 (B=4, Hq=Hkv=16, S=1000, not causal); paged at D=8
and 80 in the same layouts (T=1032) and at recurrentgemma-9b's D=256 (B=4,
Hq=16, Hkv=1, T=4128, lengths [4128, 4097, 2065, 64]); and both at D=100
in the D=80 layouts, whose bf16 rows (200 bytes) are no whole number of
16-byte pieces: flash's wgmma body with its element loader (the fma body in
a tree from before it) and paged's element-copy body; flash also at D=100
in f16, e4m3 and e5m2 (SDPA on bf16 copies for float8), at granite's D=64
(B=4, Hq=16, Hkv=8, S=1000, causal) and in f32 at qwen2.5-3b's prefill
(SDPA in f32). Then the
wide bodies and float16: flash at D=512 in bf16 and f16 and at D=128 in
f16, in qwen2.5-3b's layout (B=4, Hq=16, Hkv=2, S=1000, causal); paged at
D=512 in bf16 and f16 and at D=128 in f16, in its serve layout (T=1032);
at D > 256 flash's case names the kernels of SDPA's backend (the profiler).
A case whose head size or type the tree's kernel does not take is
skipped. Gather at qwen2.5-3b's
embedding table ([151936, 2048] bf16, 4000 ids), at 2^20 rows of an 8 GiB
[2^24, 128] f32 table and at 2^20 rows of a [2^24, 3] bf16 table (6-byte
rows: the element path); triad at STREAM's f32 N = 2^28 and in f16;
`scatter_bf16` adds 2^20 bf16 updates into [2^24, 64] (128-byte rows,
red.add.noftz.bf16x2); scatter at GUPS (xor,
HPCC's 8-byte rows, [2^30, 2] int32, 2^26 updates), also with the same
updates sorted beforehand by table region (`idx >> s`, untimed: what
bucketing by region could buy), its bucket pass alone (bound by its bytes:
the indices read twice, the rows once, both written once), and at 512-byte
rows ([2^24, 128], 2^20 updates) in int32 xor and f32 add. `types` (a
tree that takes them) times the inputs added last: flash in e4m3 and e5m2
at qwen2.5-3b's prefill and paged with e4m3 / e5m2 caches (and a bf16 q
over e4m3 caches) at its decode, their library call SDPA on bf16 copies;
triad at N = 2^28 in int8, uint8, int16, int32, e4m3 and e5m2 (library:
`torch.add(b, c, alpha=s)` for the integers, none for float8); scatter add
of 2^20 updates (a quarter into 4096 hot rows) into [2^24, 64] int8, int16,
uint16, e4m3, e5m2 and into rows of 3 and 6 bytes, xor into int8 and
uint16 rows of 64 elements and of 3, bf16 add into [2^24, 3] (library:
`index_add_` where torch has it, none for xor and float8); the gather of
[2^24, 64] e4m3 rows (library: `index_select` of the rows' bytes). Triad
also runs in bf16. Four sets run only when named: `paged_fp8` (paged
over float8 caches at qwen2.5-3b's decode under e4m3 / e5m2 / bf16 / f16
q, and its element body at D 8 and 100, each with the kernels one call
runs on the device, from the profiler), `paged_mixed` (the same over
bf16 caches under a float32 and a float16 q), `scatter_narrow` (2^20 updates
into rows of 3 and 6 bytes: bf16 and f16 add, xor, int8 / int16 / e4m3
add, and the bucket pass alone), `scatter_sweep` (M from 2^20 to
2^26 into [2^24, 3], [2^26, 3] and [2^28, 3] bf16 tables and at GUPS,
bucketed and not where the tree can be given the path, else as it plans),
`paged_heads` (bf16 paged at T=1032 and the serve lengths, Hq=16 over
`chip_smoke.PAGED_HEADS`: 16 KV heads at D 64, 80 and 128, 2 at D 80; then
8 and 4 KV heads at D 64, 80 and 128) and
`flash_fp8` (flash in e4m3 and e5m2 at granite's D 64, qwen2.5-3b's
prefill and recurrentgemma-9b's windowed D 256, each held within one unit
in the last place plus the P term of the plain version, beside SDPA on
bf16 copies and then the bf16 body at the same shape) and `g16_add16`
(paged at 16 query heads a KV head in recurrentgemma-9b's layout, B=4,
Hkv=1, T=4128, lengths [4128, 4097, 2065, 64]: bf16 at D 64, 128 and 256,
e4m3 caches under a bf16 q at D 256, beside SDPA; then int16, uint16 and
int8 add of 2^20 updates, a quarter into 4096 hot rows, into [2^24, 64]
and [2^24, 3] beside `index_add_`), `mma_triad` (flash at D 8, 16 and 32,
the mma.sync body, in qwen2.5-3b's prefill layout in bf16 and f16 beside
SDPA; then the triad at N = 2^28 in every type it takes, each held bit for
bit once, beside `torch.add(b, c, alpha=s)` where torch takes the type on
the card), `elem_wide` (paged over rows of no whole 16-byte pieces: e4m3
and e5m2 caches at D 8 and e4m3 at D 100 at qwen2.5-3b's decode, e4m3,
bf16 and f16 at D 100 over 16 KV heads; flash at D 512 in bf16 and f16
and at D 1024 and 2048 in bf16 at its prefill layout), `cas_wide` (int8,
uint8, e4m3 and e5m2 add of 2^20 updates into [2^24, 64] and [2^24, 3], a
quarter into 4096 hot rows and uniform, beside `index_add_` where torch
has it, int8 xor into [2^24, 64] both ways; paged at qwen2.5-3b's decode
layout at D 512, 1024 and 2048 in bf16 and f16 beside SDPA) and `served`
(the bodies of the served paths alone: flash at qwen2.5-3b's prefill and
recurrentgemma-9b's D 256, paged at qwen2.5-3b's decode, GUPS as drawn,
the f32 triad), `fma_wide` (the two FMA bodies, each beside its plain
version's time: flash's fma body in f32 at qwen2.5-3b's prefill and at
recurrentgemma-9b's windowed D 256, in int8 at B2 Hq8 Hkv2 D64 at S 200
and 1100 and in bf16 at D 12, and its clusters above 256 in f32 at D 512,
1024 and 2048 and in bf16 at D 500; paged's
wide body at qwen2.5-3b's decode layout in bf16 at D 1024 and 2048, in
f32 at D 512 and 1024 and over e4m3 caches under a bf16 q at D 512).
`--only` picks some of flash, paged, gather, triad, scatter,
scatter_bf16, types, paged_fp8, paged_mixed, scatter_narrow,
scatter_sweep, paged_heads, flash_fp8, g16_add16, mma_triad, elem_wide,
cas_wide, served, fma_wide. For
each:
kernel ms (CUDA
events, mean of back-to-back calls, best of 5 windows, as in chip_smoke.py),
host us a call (perf_counter over 50 calls without a synchronise), the
library call's ms
(`scaled_dot_product_attention`, `index_select`, `torch.add`, `index_add_`:
yardsticks the port never calls), and the bound (scatter: also the sector
bound, and `index_add_` on the GUPS table as a yardstick of the card's
random-atomic rate: it adds, where GUPS xors). A scatter case whose result
differs from the plain version is printed with `check FAIL` beside its time
(so a throwaway copy that is wrong on purpose, such as one without its
reductions, can still be timed) and makes the bench exit 1; so does a
paged case of `bench_paged` that differs from the plain version. Prints one JSON
line, then the card's name and power limit. Needs one NVIDIA card.
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
                    default=["flash", "paged", "gather", "triad",
                             "scatter", "scatter_bf16", "types"])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_bench: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    import chip_smoke as cs              # timing, shapes and bounds
    sys.path.insert(0, os.path.abspath(args.src))
    import torch.nn.functional as F
    from repro_torch.kernels import async_gather as ag
    from repro_torch.kernels import async_scatter as asc
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa, ref
    from repro_torch.kernels import stream_triad as st

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    b, hq, hkv, s, d = cs.BATCH, 16, 2, cs.PROMPT_LEN, 128
    if "flash" in args.only:
        rows.append(bench_flash(cs, fa, F, gen, b, hq, hkv, s, d))
        rows.append(bench_flash(cs, fa, F, gen, b, 16, 1, 4096, 256,
                                window=2048))
        # granite's layout at D = 64, and float32 at the serve shape
        rows.append(bench_flash(cs, fa, F, gen, b, 16, 8, s, 64))
        rows.append(bench_flash(cs, fa, F, gen, b, hq, hkv, s, d,
                                dtype=torch.float32))
        if takes(fa, 8):
            rows.append(bench_flash(cs, fa, F, gen, b, hq, hkv, s, 8))
            rows.append(bench_flash(cs, fa, F, gen, b, 16, 16, s, 80,
                                    causal=False))
            rows.append(bench_flash(cs, fa, F, gen, b, 16, 16, s, 100,
                                    causal=False))
        # D = 100 (rows of no whole 16-byte pieces) in float16 and float8
        for dtype in (torch.float16, *cs.FP8):
            if dtype in getattr(fa, "KERNEL_TYPES", ()):
                rows.append(bench_flash(cs, fa, F, gen, b, 16, 16, s, 100,
                                        causal=False, dtype=dtype))
        if takes(fa, 512):
            for d, dtype in ((512, torch.bfloat16), (512, torch.float16),
                             (128, torch.float16)):
                rows.append(bench_flash(cs, fa, F, gen, b, hq, hkv, s, d,
                                        dtype=dtype))
    if "paged" in args.only:
        rows.append(bench_paged(cs, pa, ref, F, gen, b, hq, hkv, d))
        rows.append(bench_paged(cs, pa, ref, F, gen, b, hq, hkv, d,
                                long=True))
        if takes(pa, 8):
            rows.append(bench_paged(cs, pa, ref, F, gen, b, hq, hkv, 8))
            rows.append(bench_paged(cs, pa, ref, F, gen, b, 16, 16, 80))
            rows.append(bench_paged(cs, pa, ref, F, gen, b, 16, 16, 100))
            rows.append(bench_paged(cs, pa, ref, F, gen, b, 16, 1, 256,
                                    prompt=4096))
        if takes(pa, 512):
            for d, dtype in ((512, torch.bfloat16), (512, torch.float16),
                             (128, torch.float16)):
                rows.append(bench_paged(cs, pa, ref, F, gen, b, hq, hkv, d,
                                        dtype=dtype))
    if "gather" in args.only:
        rows.extend(bench_gather(cs, ag, gen))
    if "triad" in args.only:
        rows.append(bench_triad(cs, st, gen))
        for dtype in (torch.bfloat16, torch.float16):
            if dtype in st.TYPES:
                rows.append(bench_triad(cs, st, gen, dtype))
    if "scatter" in args.only:
        rows.extend(bench_scatter(cs, asc, ref, gen))
    if "scatter_bf16" in args.only and torch.bfloat16 in asc.TYPES["add"]:
        rows.append(bench_scatter_bf16(cs, asc, ref, gen))
    if "types" in args.only and torch.int8 in st.TYPES:
        rows.extend(bench_types(cs, fa, pa, ag, asc, st, ref, F, gen))
    if "paged_fp8" in args.only:
        rows.extend(bench_paged_fp8(cs, pa, ref, F, gen))
    if "paged_heads" in args.only:
        rows.extend(bench_paged(cs, pa, ref, F, gen, b, 16, hkv_, d_)
                    for hkv_, d_ in cs.PAGED_HEADS + PAGED_GROUPS)
    if "flash_fp8" in args.only:
        rows.extend(bench_flash_fp8(cs, fa, ref, F, gen))
    if "g16_add16" in args.only:
        rows.extend(bench_g16_add16(cs, pa, asc, ref, F, gen))
    if "mma_triad" in args.only:
        rows.extend(bench_flash(cs, fa, F, gen, b, hq, hkv, s, d_,
                                dtype=dtype)
                    for dtype in (torch.bfloat16, torch.float16)
                    for d_ in MMA_DIMS)
        rows.extend(bench_triad_typed(cs, st, ref, gen, dtype)
                    for dtype in st.TYPES)
    if "elem_wide" in args.only:
        rows.extend(bench_elem_wide(cs, fa, pa, ref, F, gen))
    if "cas_wide" in args.only:
        rows.extend(bench_cas_wide(cs, pa, asc, ref, F, gen))
    if "fma_wide" in args.only:
        rows.extend(bench_fma_wide(cs, fa, pa, ref, F, gen))
    if "served" in args.only:
        rows.append(bench_flash(cs, fa, F, gen, b, hq, hkv, s, d))
        rows.append(bench_flash(cs, fa, F, gen, b, 16, 1, 4096, 256,
                                window=2048))
        rows.append(bench_paged(cs, pa, ref, F, gen, b, hq, hkv, d))
        rows.extend(bench_scatter(cs, asc, ref, gen, gups_only=True))
        rows.append(bench_triad(cs, st, gen))
    if "paged_mixed" in args.only:
        rows.extend(bench_paged_typed(cs, pa, ref, F, gen, q_dtype,
                                      torch.bfloat16)
                    for q_dtype in (torch.float32, torch.float16))
    if "scatter_narrow" in args.only:
        rows.extend(bench_scatter_narrow(cs, asc, ref, gen))
    if "scatter_sweep" in args.only:
        rows.extend(bench_scatter_sweep(cs, asc, ref, gen))
    for r in rows:
        lib = r["library_ms"]
        extra = "".join(f", {k} {r[k]:.5f} ms" for k in
                        ("sector_bound_ms", "yardstick_ms") if k in r)
        host = f", host {r['host_us']:.1f} us a call" if "host_us" in r \
            else ""
        plain = f", plain {r['plain_ms']:.4f} ms" if "plain_ms" in r else ""
        print(f"{args.label}: {r['kernel']} {r['case']}: kernel "
              f"{r['ms']:.4f} ms{host}{plain}, library "
              f"{'none' if lib is None else f'{lib:.4f} ms'}, bound "
              f"{r['bound_ms']:.5f} ms{extra}"
              f"{'' if r.get('check', 'ok') == 'ok' else ', check FAIL'}",
              flush=True)
    print(json.dumps({"label": args.label, "src": args.src, "rows": rows}))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip())
    return 1 if any(r.get("check") == "FAIL" for r in rows) else 0


# `paged_heads` after chip_smoke.PAGED_HEADS: (Hkv, D) at 2 and 4 query
# heads a KV head, at head sizes that are a body's own (64, 128) and not (80)
PAGED_GROUPS = ((8, 64), (8, 80), (8, 128), (4, 64), (4, 80), (4, 128))
# `flash_fp8`: (Hq, Hkv, S, D, window) in the model's layout, causal:
# granite's D 64, qwen2.5-3b's prefill at D 128, recurrentgemma-9b's D 256
FLASH_FP8 = ((16, 8, 1000, 64, 0), (16, 2, 1000, 128, 0),
             (16, 1, 4096, 256, 2048))


def bench_flash_fp8(cs, fa, ref, F, gen):
    """`flash_fp8`: flash in e4m3 and e5m2 at each shape of FLASH_FP8, each
    held against the plain version (one unit in the last place plus the
    f16 P term of the wgmma body) and timed beside SDPA on bf16 copies;
    then the bf16 body at the same shape."""
    rows = []
    b = cs.BATCH
    for hq, hkv, s, d, window in FLASH_FP8:
        for dtype in cs.FP8:
            q, k, v = cs.flash_case(gen, b, hq, hkv, s, d, dtype)
            cs.check_ulp(f"flash {cs.tname(dtype)} D{d}",
                         fa.flash_attention(q, k, v, window=window),
                         ref.attention_ref(q, k, v, window=window), quiet=True,
                         extra=cs.fp8_p_term(q, k, v, fa.body_for(dtype, d),
                                             window=window))
            del q, k, v
            rows.append(bench_flash(cs, fa, F, gen, b, hq, hkv, s, d,
                                    window=window, dtype=dtype))
        rows.append(bench_flash(cs, fa, F, gen, b, hq, hkv, s, d,
                                window=window))
        cs.free_cuda()
    return rows


def bench_g16_add16(cs, pa, asc, ref, F, gen):
    """`g16_add16`: paged at 16 query heads a KV head (recurrentgemma-9b's
    B4 Hq16 Hkv1, T = 4128) in bf16 at D 64, 128 and 256 and over e4m3
    caches under a bf16 q at D 256; then int16, uint16 and int8 add into
    [2^24, 64] and [2^24, 3]."""
    rows = [bench_paged(cs, pa, ref, F, gen, cs.BATCH, 16, 1, d, prompt=4096)
            for d in (64, 128, 256)]
    rows.append(bench_paged_typed(cs, pa, ref, F, gen, torch.bfloat16,
                                  torch.float8_e4m3fn, d=256, hkv=1,
                                  t=4128))
    for w in (64, 3):
        for dtype in (torch.int16, torch.uint16, torch.int8):
            rows.append(bench_scatter_typed(cs, asc, ref, gen, dtype, "add",
                                            w))
    return rows


def bench_elem_wide(cs, fa, pa, ref, F, gen):
    """`elem_wide`: paged over rows of no whole 16-byte pieces at
    qwen2.5-3b's decode layout (B4 Hq16 Hkv2 T1032, the serve lengths): e4m3
    and e5m2 caches under a q of their kind at D 8 and e4m3 at D 100, and
    at hubert-xlarge's heads (Hkv16) e4m3 at D 100 and bf16 and f16 at D
    100; then flash's wgmma body above 256 columns at qwen2.5-3b's prefill
    layout (B4 Hq16 Hkv2 S1000, causal), bf16 and f16 at D 512, bf16 at D
    1024 and 2048."""
    rows = [bench_paged_typed(cs, pa, ref, F, gen, dtype, dtype, d=d,
                              hkv=hkv)
            for dtype, d, hkv in ((torch.float8_e4m3fn, 8, 2),
                                  (torch.float8_e5m2, 8, 2),
                                  (torch.float8_e4m3fn, 100, 2),
                                  (torch.float8_e4m3fn, 100, 16))]
    rows.extend(bench_paged(cs, pa, ref, F, gen, cs.BATCH, 16, 16, 100,
                            dtype=dtype)
                for dtype in (torch.bfloat16, torch.float16))
    rows.extend(bench_flash(cs, fa, F, gen, cs.BATCH, 16, 2, cs.PROMPT_LEN,
                            d, dtype=dtype)
                for d, dtype in ((512, torch.bfloat16), (512, torch.float16),
                                 (1024, torch.bfloat16),
                                 (2048, torch.bfloat16)))
    return rows


def bench_cas_wide(cs, pa, asc, ref, F, gen):
    """`cas_wide`: int8, uint8, e4m3 and e5m2 add of 2^20 updates into
    [2^24, 64] and into 3-byte rows ([2^24, 3]), a quarter into 4096 hot
    rows and uniform, beside `index_add_` where torch has it, and int8 xor
    into [2^24, 64] (a reduction on the int32 view, no compare-and-swap)
    both ways; then paged at qwen2.5-3b's decode layout (B4 Hq16 Hkv2
    T1032, the serve lengths) at D 512, 1024 and 2048 in bf16 and f16
    beside SDPA."""
    rows = [bench_scatter_typed(cs, asc, ref, gen, dtype, "add", w, hot=hot)
            for w in (64, 3)
            for dtype in (torch.int8, torch.uint8, *cs.FP8)
            for hot in (True, False)]
    rows.extend(bench_scatter_typed(cs, asc, ref, gen, torch.int8, "xor", 64,
                                    hot=hot) for hot in (True, False))
    rows.extend(bench_paged(cs, pa, ref, F, gen, cs.BATCH, 16, 2, d,
                            dtype=dtype)
                for d in (512, 1024, 2048)
                for dtype in (torch.bfloat16, torch.float16))
    return rows


# `fma_wide`: flash's fma body, (B, Hq, Hkv, S, D, window, type), causal:
# float32 at qwen2.5-3b's prefill and at recurrentgemma-9b's windowed D 256,
# int8 (float32 copies) at D 64 at S 200 (64-row tiles: 128-row ones give
# 32 blocks) and 1100 (144 blocks of 128 rows) and bf16 at D 12 (rows of no
# whole 16-byte pieces at Dp 16); and its body above 256 columns (clusters
# of a CTA a 256-column piece) in float32 at D 512, 1024 and 2048 and in
# bf16 at D 500 (rows of no whole 16-byte pieces)
FMA_FLASH = ((4, 16, 2, 1000, 128, 0, torch.float32),
             (4, 16, 1, 4096, 256, 2048, torch.float32),
             (2, 8, 2, 200, 64, 0, torch.int8),
             (2, 8, 2, 1100, 64, 0, torch.int8),
             (4, 16, 2, 1000, 12, 0, torch.bfloat16),
             (4, 16, 2, 1000, 512, 0, torch.float32),
             (4, 16, 2, 1000, 1024, 0, torch.float32),
             (4, 16, 2, 1000, 2048, 0, torch.float32),
             (4, 16, 2, 1000, 500, 0, torch.bfloat16))
# ... and paged's wide FMA body at qwen2.5-3b's decode layout: (D, q's
# type, the caches')
FMA_PAGED = ((1024, torch.bfloat16, torch.bfloat16),
             (2048, torch.bfloat16, torch.bfloat16),
             (512, torch.float32, torch.float32),
             (1024, torch.float32, torch.float32),
             (512, torch.bfloat16, torch.float8_e4m3fn))


def bench_fma_wide(cs, fa, pa, ref, F, gen):
    """`fma_wide`: flash at FMA_FLASH and paged at FMA_PAGED (B4 Hq16 Hkv2
    T1032, the serve lengths), each beside its plain version's time, SDPA
    (on the same type, on float32 copies of integers, on bf16 copies
    beside float8 caches) and its bound."""
    rows = []
    for b, hq, hkv, s, d, window, dtype in FMA_FLASH:
        rows.append(bench_flash(cs, fa, F, gen, b, hq, hkv, s, d,
                                window=window, dtype=dtype, ref=ref))
        cs.free_cuda()
    for d, q_dtype, dtype in FMA_PAGED:
        if q_dtype == dtype:
            rows.append(bench_paged(cs, pa, ref, F, gen, cs.BATCH, 16, 2, d,
                                    dtype=dtype, plain=True))
        else:
            rows.append(bench_paged_typed(cs, pa, ref, F, gen, q_dtype, dtype,
                                          d=d, plain=True))
        cs.free_cuda()
    return rows


def takes(mod, d) -> bool:
    """Whether the tree's kernel module takes head size `d`: a tree from
    before every head size from 1 to 256 (`padded_head_dim`) took only its
    `HEAD_DIMS`, one from before the wide bodies (`CHUNK_DIM`) none above
    256."""
    if d > 256:
        return hasattr(mod, "CHUNK_DIM")
    return hasattr(mod, "padded_head_dim") or d in mod.HEAD_DIMS


def short(dtype) -> str:
    return {torch.bfloat16: "bf16", torch.float16: "f16",
            torch.float32: "f32", torch.float8_e4m3fn: "e4m3",
            torch.float8_e5m2: "e5m2"}.get(dtype, str(dtype)[6:])


def bench_flash(cs, fa, F, gen, b, hq, hkv, s, d, window=0, causal=True,
                dtype=torch.bfloat16, ref=None):
    """One flash case timed beside SDPA on the same inputs (on bf16 copies
    for float8, on float32 copies for integers, which SDPA does not take)
    and its bound; with `ref`, also the plain version's time, after one
    check of the kernel against it."""
    q, k, v = cs.flash_case(gen, b, hq, hkv, s, d, dtype)
    body = fa.body_for(dtype, d) if hasattr(fa, "body_for") else "?"
    lib = (dict(attn_mask=cs.window_mask(s, window)) if window
           else dict(is_causal=causal))
    lq, lk, lv = ((x.to(torch.bfloat16) for x in (q, k, v))
                  if dtype in cs.FP8 else (x.float() for x in (q, k, v))
                  if not dtype.is_floating_point else (q, k, v))
    extra = {}
    if ref is not None:
        want = ref.attention_ref(q, k, v, causal, window)
        got = fa.flash_attention(q, k, v, causal=causal, window=window)
        if dtype.is_floating_point:
            cs.check_flash_out(f"flash D{d} {short(dtype)}", got, q, k, v,
                               causal, window, quiet=True)
        else:                # within one unit of the plain version
            cs.check_close(f"flash D{d} {short(dtype)}", got, want, atol=1,
                           rtol=0, quiet=True)
        del want, got
        extra["plain_ms"] = cs.time_ms(
            [lambda: ref.attention_ref(q, k, v, causal, window)], 5, 3)
    backend = ""
    if d > 256:                   # which of SDPA's backends takes D > 256
        backend = ", library " + cs.sdpa_backend(
            lambda: F.scaled_dot_product_attention(q, k, v, enable_gqa=True,
                                                   **lib))
    return dict(
        kernel="flash_attention",
        case=f"B{b} Hq{hq} Hkv{hkv} S{s} D{d} {short(dtype)}"
             + (f" window{window}" if window else "")
             + ("" if causal else " not causal") + f" ({body} body{backend}"
             + ("; library on bf16 copies" if dtype in cs.FP8 else "") + ")",
        ms=cs.time_ms([lambda: fa.flash_attention(q, k, v, causal=causal,
                                                  window=window)], 20),
        host_us=cs.host_us(lambda: fa.flash_attention(q, k, v, causal=causal,
                                                      window=window)),
        library_ms=cs.time_ms([lambda: F.scaled_dot_product_attention(
            lq, lk, lv, enable_gqa=True, **lib)], 10),
        bound_ms=cs.flash_bound(b, hq, hkv, s, d, window, dtype, causal)[0],
        **extra)


def bench_paged(cs, pa, ref, F, gen, b, hq, hkv, d, long=False,
                prompt=None, dtype=torch.bfloat16, plain=False):
    """The serve shape (T = prompt + 32, lengths [T, prompt + 1,
    (T + 2) // 2, 64]; the prompt chip_smoke serves by default), or
    (`long`) one sequence of 32768 rows; with `plain`, also the plain
    version's time."""
    prompt = prompt or cs.PROMPT_LEN
    t = 32768 if long else prompt + cs.MAX_NEW
    lens = torch.tensor([t] if long else [t, prompt + 1, (t + 2) // 2, 64],
                        dtype=torch.int32, device="cuda")
    b = lens.numel()
    sets = [cs.paged_case(gen, b, hq, hkv, t, d, dtype)
            for _ in range(4 if long else 16)]
    try:
        cs.check_close(f"paged T{t}", pa.paged_attention(*sets[0], lens),
                       ref.paged_attention_ref(*sets[0], lens),
                       **(cs.paged_tol(dtype) if dtype == torch.float32
                          else cs.PAGED_BF16_TOL))
        check = "ok"
    except AssertionError:
        check = "FAIL"
    mask = (torch.arange(t, device="cuda")[None, :]
            < lens[:, None])[:, None, None, :]

    def library(x):
        return F.scaled_dot_product_attention(
            x[0][:, :, None], x[1].transpose(1, 2), x[2].transpose(1, 2),
            attn_mask=mask, enable_gqa=True)
    return dict(
        kernel="paged_attention",
        case=f"B{b} Hq{hq} Hkv{hkv} T{t} D{d} {short(dtype)} lengths "
             f"{lens.tolist()}"
             + (f" ({pa.body_for(dtype, d)} body)"
                if hasattr(pa, "body_for") else ""),
        ms=cs.time_ms([lambda x=x: pa.paged_attention(*x, lens)
                       for x in sets], 64),
        host_us=cs.host_us(lambda: pa.paged_attention(*sets[0], lens)),
        library_ms=cs.time_ms([lambda x=x: library(x) for x in sets], 64),
        library_host_us=cs.host_us(lambda: library(sets[0])),
        bound_ms=cs.paged_bound(lens, hq, hkv, d, dtype)[0], check=check,
        **({"plain_ms": cs.time_ms(
            [lambda x=x: ref.paged_attention_ref(*x, lens) for x in sets],
            16)} if plain else {}))


def bench_triad(cs, st, gen, dtype=torch.float32):
    n = 1 << 28
    b, c = (cs.randn(gen, (n,), dtype) for _ in range(2))
    cs.check_close_big(f"triad {short(dtype)} N=2^28",
                       st.stream_triad(b, c, 3.0),
                       torch.add(b, c, alpha=3.0), **cs.TRIAD_TOL[dtype])
    row = dict(
        kernel="stream_triad", case=f"{short(dtype)} N={n}",
        ms=cs.time_ms([lambda: st.stream_triad(b, c, 3.0)], 20),
        host_us=cs.host_us(lambda: st.stream_triad(b, c, 3.0)),
        library_ms=cs.time_ms([lambda: torch.add(b, c, alpha=3.0)], 20),
        library_host_us=cs.host_us(lambda: torch.add(b, c, alpha=3.0)),
        bound_ms=cs.amu_bound(3 * n * b.element_size(), 2 * n)[0])
    del b, c
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return row


# `mma_triad`: the head sizes of flash's mma.sync body at qwen2.5-3b's
# prefill layout (D 8 is the smoke configs' head size, on Dp 16)
MMA_DIMS = (8, 16, 32)


def bench_triad_typed(cs, st, ref, gen, dtype, scale=1.0):
    """The triad at N = 2^28 in `dtype` (floats N(0, scale^2), integers
    over the whole type), held bit for bit against the plain version once,
    beside `torch.add(b, c, alpha=s)` with s in the type where torch takes
    the type on the card (none for float8, and where it refuses the type:
    uint16 and uint32 in some versions)."""
    n = 1 << 28
    x, y = (cs.rand_typed(gen, (n,), dtype, scale) for _ in range(2))
    cs.check_same(f"triad {cs.tname(dtype)}", st.stream_triad(x, y, 3.3),
                  ref.triad_ref(x, y, 3.3), quiet=True)
    alpha = ref.round_scalar(3.3, dtype)
    library_ms = None
    if dtype not in cs.FP8:
        try:
            torch.add(x, y, alpha=alpha)
            library_ms = cs.time_ms([lambda: torch.add(x, y, alpha=alpha)],
                                    20)
        except (RuntimeError, TypeError):
            pass
    row = dict(
        kernel="stream_triad", case=f"{cs.tname(dtype)} N={n}",
        ms=cs.time_ms([lambda: st.stream_triad(x, y, 3.3)], 20),
        host_us=cs.host_us(lambda: st.stream_triad(x, y, 3.3)),
        library_ms=library_ms,
        bound_ms=cs.amu_bound(3 * n * x.element_size(), 2 * n)[0])
    del x, y
    cs.free_cuda()
    return row


def bench_gather(cs, ag, gen):
    rows = []
    cases = [((151936, 2048), torch.bfloat16, 4000, "embedding"),
             ((1 << 24, 128), torch.float32, 1 << 20, "8 GiB")]
    try:                                  # a tree that takes 6-byte rows
        ag.gather_path(6, 16)
        cases.append(((1 << 24, 3), torch.bfloat16, 1 << 20, "6-byte rows"))
    except ValueError:
        pass
    for shape, dtype, m, what in cases:
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


def bench_scatter(cs, asc, ref, gen, gups_only=False):
    """GUPS as drawn and sorted by region beforehand; then 512-byte rows in
    int32 xor and f32 add (`gups_only`: GUPS as drawn alone). Each case's
    result is held against the plain version once; the timed calls keep
    updating one table in place."""
    rows = []

    def case(name, table, idx, upd, op, want, library=None, yardstick=None,
             iters=10):
        out = asc.async_scatter(table.clone(), idx, upd, op)
        if op == "xor" or out.dtype == torch.int32:
            ok = torch.equal(out, want)
        else:
            ok = all(torch.allclose(o, w, **cs.SCATTER_TOL) for o, w in
                     zip(out.split(1 << 22), want.split(1 << 22)))
        nbytes, sectors = cs.scatter_bytes(idx, table.shape[1] * 4)
        m = idx.numel()
        row = dict(
            kernel="async_scatter", case=name,
            ms=cs.time_ms([lambda: asc.async_scatter(out, idx, upd, op)],
                          iters),
            host_us=cs.host_us(lambda: asc.async_scatter(out, idx, upd, op)),
            library_ms=None if library is None else cs.time_ms(
                [lambda: library(out)], iters),
            bound_ms=cs.amu_bound(nbytes, m * table.shape[1])[0],
            sector_bound_ms=cs.amu_bound(sectors)[0],
            check="ok" if ok else "FAIL")
        if yardstick is not None:
            row["yardstick_ms"] = cs.time_ms([lambda: yardstick(out)], iters)
        row["giga_updates_s"] = m / row["ms"] / 1e6
        rows.append(row)
        del out
        cs.free_cuda()

    n, w, m = 1 << 30, 2, 1 << 26
    table = cs.amu_table(gen, (n, w), torch.int32)
    idx = cs.amu_index(gen, n, m)
    upd = cs.amu_table(gen, (m, w), torch.int32)
    want = ref.scatter_update_ref(table, idx, upd, "xor")
    cs.free_cuda()
    case(f"GUPS xor [{n},{w}] int32, {m} updates", table, idx, upd, "xor",
         want, yardstick=lambda out: out.index_add_(0, idx, upd))
    if gups_only:
        del table, idx, upd, want
        cs.free_cuda()
        return rows
    if hasattr(asc, "scatter_bucket"):      # the bucket pass alone, where
                                            # the tree has one
        rows.append(dict(
            kernel="async_scatter", case="GUPS bucket pass alone",
            ms=cs.time_ms([lambda: asc.scatter_bucket(idx, upd, n)], 10),
            host_us=cs.host_us(lambda: asc.scatter_bucket(idx, upd, n)),
            library_ms=None,
            bound_ms=cs.amu_bound(m * (3 * 4 + 2 * w * 4))[0]))
    for shift in (0, 9, 14, 17, 19, 20, 22, 25):
        order = torch.argsort(idx >> shift, stable=True)
        case(f"GUPS, updates sorted by idx >> {shift} (regions of "
             f"{(w * 4) << shift} B)", table, idx[order], upd[order], "xor",
             want)
        del order
    del table, idx, upd, want
    cs.free_cuda()

    n, w, m = 1 << 24, 128, 1 << 20
    for op, dtype in (("xor", torch.int32), ("add", torch.float32)):
        table = cs.amu_table(gen, (n, w), dtype)
        idx = cs.amu_index(gen, n, m)
        upd = cs.amu_table(gen, (m, w), dtype)
        want = ref.scatter_update_ref(table, idx, upd, op)
        case(f"{op} [{n},{w}] {str(dtype)[6:]}, {m} updates", table, idx,
             upd, op, want, iters=20, library=None if op == "xor" else
             (lambda out: out.index_add_(0, idx, upd)))
        del table, idx, upd, want
        cs.free_cuda()
    return rows


def bench_types(cs, fa, pa, ag, asc, st, ref, F, gen):
    """The inputs added last (the module docstring's `types`), each checked
    once against its plain version as chip_smoke.py checks it."""
    rows = []
    b, hq, hkv, s, d = cs.BATCH, 16, 2, cs.PROMPT_LEN, 128
    for dtype in cs.FP8:
        q = cs.rand_typed(gen, (b, s, hq, d), dtype, cs.Q_SCALE).transpose(1, 2)
        k = cs.rand_typed(gen, (b, s, hkv, d), dtype).transpose(1, 2)
        v = cs.rand_typed(gen, (b, s, hkv, d), dtype).transpose(1, 2)
        cs.check_ulp("flash", fa.flash_attention(q, k, v),
                     ref.attention_ref(q, k, v), quiet=True,
                     extra=cs.fp8_p_term(q, k, v, fa.body_for(dtype, d)))
        bq, bk, bv = (x.to(torch.bfloat16) for x in (q, k, v))
        rows.append(dict(
            kernel="flash_attention",
            case=f"B{b} Hq{hq} Hkv{hkv} S{s} D{d} {cs.tname(dtype)} "
                 f"({fa.body_for(dtype, d)} body; library on bf16 copies)",
            ms=cs.time_ms([lambda: fa.flash_attention(q, k, v)], 10),
            library_ms=cs.time_ms([lambda: F.scaled_dot_product_attention(
                bq, bk, bv, is_causal=True, enable_gqa=True)], 10),
            bound_ms=cs.flash_bound(b, hq, hkv, s, d, 0, dtype)[0]))
        del q, k, v, bq, bk, bv
    for q_dtype, dtype in ((torch.float8_e4m3fn, torch.float8_e4m3fn),
                           (torch.float8_e5m2, torch.float8_e5m2),
                           (torch.bfloat16, torch.float8_e4m3fn)):
        rows.append(bench_paged_typed(cs, pa, ref, F, gen, q_dtype, dtype))
    for dtype in (torch.int8, torch.uint8, torch.int16, torch.int32,
                  *cs.FP8):
        rows.append(bench_triad_typed(cs, st, ref, gen, dtype,
                                      cs.OVERFLOW_SCALE.get(dtype, 1.0)))
    for dtype, op, w in ((torch.int8, "add", 64), (torch.int16, "add", 64),
                         (torch.uint16, "add", 64),
                         (torch.float8_e4m3fn, "add", 64),
                         (torch.float8_e5m2, "add", 64),
                         (torch.int8, "add", 3), (torch.int16, "add", 3),
                         (torch.int8, "xor", 64), (torch.uint16, "xor", 64),
                         (torch.int8, "xor", 3), (torch.uint16, "xor", 3),
                         (torch.bfloat16, "add", 3)):
        rows.append(bench_scatter_typed(cs, asc, ref, gen, dtype, op, w))
    rows_n, m = 1 << 24, 1 << 20
    table = cs.rand_typed(gen, (rows_n, 64), torch.float8_e4m3fn)
    idx = cs.amu_index(gen, rows_n, m)
    cs.check_same("gather", ag.async_gather(table, idx),
                  ref.gather_ref(table, idx), quiet=True)
    touched = torch.unique(idx).numel()
    rows.append(dict(
        kernel="async_gather", case=f"[{rows_n},64] e4m3, {m} rows",
        ms=cs.time_ms([lambda: ag.async_gather(table, idx)], 20),
        host_us=cs.host_us(lambda: ag.async_gather(table, idx)),
        library_ms=cs.time_ms([lambda: torch.index_select(
            cs.bits(table), 0, idx)], 20),
        bound_ms=cs.amu_bound(touched * 64 + m * 64 + m * 4)[0]))
    del table, idx
    cs.free_cuda()
    return rows


def paged_lengths(t):
    """The serve shape's lengths at T = t: [T, prompt + 1, (T + 2) // 2,
    64], with the mask SDPA takes for them."""
    lens = torch.tensor([t, t - 31, (t + 2) // 2, 64], dtype=torch.int32,
                        device="cuda")
    mask = (torch.arange(t, device="cuda")[None, :]
            < lens[:, None])[:, None, None, :]
    return lens, mask


def bench_paged_typed(cs, pa, ref, F, gen, q_dtype, dtype, d=128, hq=16,
                      hkv=2, t=None, plain=False):
    """Paged at qwen2.5-3b's decode (T = 1032, or `t`, lengths
    `paged_lengths`) with q of `q_dtype` over caches of `dtype`, checked
    once (one unit in the last place of a float8 output, PAGED_BF16_TOL /
    PAGED_F16_TOL of a 16-bit one), timed over 16 caches in turn beside
    SDPA on bf16 copies and the bound."""
    b, t = cs.BATCH, t or cs.PROMPT_LEN + cs.MAX_NEW
    lens, mask = paged_lengths(t)
    sets = [(cs.rand_typed(gen, (b, hq, d), q_dtype, cs.Q_SCALE),
             cs.rand_typed(gen, (b, t, hkv, d), dtype),
             cs.rand_typed(gen, (b, t, hkv, d), dtype)) for _ in range(16)]
    got = pa.paged_attention(*sets[0], lens)
    want = ref.paged_attention_ref(*sets[0], lens)
    if q_dtype in cs.FP8:
        cs.check_ulp("paged", got, want, quiet=True)
    else:
        cs.check_close("paged", got, want, quiet=True,
                       **(cs.PAGED_F16_TOL if q_dtype == torch.float16
                          else cs.PAGED_BF16_TOL))
    wide = [tuple(x.to(torch.bfloat16) for x in w) for w in sets]
    products = (f", {pa.products_on(q_dtype, dtype, d)}"
                if hasattr(pa, "products_on") else "")
    row = dict(
        kernel="paged_attention",
        case=f"B{b} Hq{hq} Hkv{hkv} T{t} D{d} q {cs.tname(q_dtype)} "
             f"caches {cs.tname(dtype)} ({pa.body_for(dtype, d)} body"
             f"{products}; library on bf16 copies)",
        ms=cs.time_ms([lambda x=x: pa.paged_attention(*x, lens)
                       for x in sets], 64),
        host_us=cs.host_us(lambda: pa.paged_attention(*sets[0], lens)),
        library_ms=cs.time_ms([lambda w=w: F.scaled_dot_product_attention(
            w[0][:, :, None], w[1].transpose(1, 2), w[2].transpose(1, 2),
            attn_mask=mask, enable_gqa=True) for w in wide], 64),
        bound_ms=cs.paged_bound(lens, hq, hkv, d, dtype, q_dtype)[0])
    if plain:
        row["plain_ms"] = cs.time_ms(
            [lambda x=x: ref.paged_attention_ref(*x, lens) for x in sets], 16)
    row["device_kernels"] = sum(cs.kernel_counts(
        lambda: pa.paged_attention(*sets[0], lens)).values())
    return row


def bench_paged_fp8(cs, pa, ref, F, gen):
    """`paged_fp8`: float8 caches at qwen2.5-3b's decode under a q of each
    kind the tensor-core body takes (e4m3 / e5m2 over their own kind, bf16
    over e4m3, f16 over e5m2), and the element body (rows of no whole
    16-byte pieces) at D 8 and 100 in e4m3. Each row also counts the
    kernels the profiler sees in one call (`device_kernels`)."""
    rows = [bench_paged_typed(cs, pa, ref, F, gen, q_dtype, dtype)
            for q_dtype, dtype in (
                (torch.float8_e4m3fn, torch.float8_e4m3fn),
                (torch.float8_e5m2, torch.float8_e5m2),
                (torch.bfloat16, torch.float8_e4m3fn),
                (torch.float16, torch.float8_e5m2))]
    for d in (8, 100):
        rows.append(bench_paged_typed(cs, pa, ref, F, gen,
                                      torch.float8_e4m3fn,
                                      torch.float8_e4m3fn, d=d))
    return rows


def bench_scatter_typed(cs, asc, ref, gen, dtype, op, w, rows_n=1 << 24,
                        m=1 << 20, hot=True, check=True):
    """`op` of m updates into [rows_n, w] of `dtype` (`hot`: a quarter of
    them into 4096 hot rows), checked once against the plain version
    (`check`), timed beside `index_add_` where torch has it."""
    table = cs.rand_typed(gen, (rows_n, w), dtype)
    idx = cs.amu_index(gen, rows_n, m)
    if hot:
        idx[::4] %= 4096
    upd = cs.rand_typed(gen, (m, w), dtype)
    out = asc.async_scatter(table.clone(), idx, upd, op)
    ok = True
    if check and dtype.is_floating_point:
        ok = cs.check_scatter16(op, out, table, idx, upd, raise_=False)
    elif check:
        cs.check_same(op, out, ref.scatter_update_ref(table, idx, upd, op),
                      quiet=True)
    library_ms = None
    if op == "add" and dtype not in cs.FP8:
        try:
            library_ms = cs.time_ms([lambda: out.index_add_(0, idx, upd)],
                                    20)
        except (RuntimeError, NotImplementedError):
            pass
    nbytes, sectors = cs.scatter_bytes(idx, w * table.element_size())
    plan = asc.launch_plan(out, m, op)
    row = dict(
        kernel="async_scatter",
        case=f"{op} [{rows_n},{w}] {cs.tname(dtype)}, {m} updates"
             f"{'' if hot else ' (uniform)'}"
             f"{' (bucketed)' if plan.bucket else ''}",
        ms=cs.time_ms([lambda: asc.async_scatter(out, idx, upd, op)], 20),
        host_us=cs.host_us(lambda: asc.async_scatter(out, idx, upd, op)),
        library_ms=library_ms, bound_ms=cs.amu_bound(nbytes, m * w)[0],
        sector_bound_ms=cs.amu_bound(sectors)[0],
        check="ok" if ok else "FAIL")
    del table, idx, upd, out
    cs.free_cuda()
    return row


def bench_scatter_narrow(cs, asc, ref, gen):
    """`scatter_narrow`: 2^20 updates (a quarter into 4096 hot rows) into
    rows of 3 and 6 bytes of a [2^24, 3] table: bf16 and f16 add (the
    16-bit add at rows of no whole 4-byte words), xor (uint16, int8), int8,
    int16 and e4m3 add; then the bucket pass alone on the bf16 case's
    updates (bound: the indices read twice and written once, the rows read
    and written once), so that the apply is the total less the pass."""
    rows = [bench_scatter_typed(cs, asc, ref, gen, dtype, op, 3)
            for dtype, op in ((torch.bfloat16, "add"),
                              (torch.float16, "add"),
                              (torch.uint16, "xor"), (torch.int8, "xor"),
                              (torch.int8, "add"), (torch.int16, "add"),
                              (torch.float8_e4m3fn, "add"))]
    n, m = 1 << 24, 1 << 20
    idx = cs.amu_index(gen, n, m)
    idx[::4] %= 4096
    upd = cs.rand_typed(gen, (m, 3), torch.bfloat16)
    rows.append(dict(
        kernel="async_scatter",
        case=f"bucket pass alone, [{n},3] bf16 rows, {m} updates",
        ms=cs.time_ms([lambda: asc.scatter_bucket(idx, upd, n)], 20),
        host_us=cs.host_us(lambda: asc.scatter_bucket(idx, upd, n)),
        library_ms=None, bound_ms=cs.amu_bound(m * (3 * 4 + 2 * 6))[0]))
    del idx, upd
    cs.free_cuda()
    return rows


def bench_scatter_sweep(cs, asc, ref, gen):
    """`scatter_sweep`: M of 2^20, 2^22, 2^24, 2^25 and 2^26 updates into
    narrow rows of four table sizes about the bucket rule's: bf16 add into
    [2^24, 3] (96 MiB), [2^26, 3] (384 MiB) and [2^28, 3] (1.5 GiB), a
    quarter into 4096 hot rows, checked once a path; GUPS (xor into
    [2^30, 2] int32, 8 GiB, uniform, unchecked: `scatter` checks it at
    2^26). Each call down both paths, bucketed and not, where the tree's
    `launch_plan` takes `bucket` (`async_scatter.launch` on that plan), else
    as the tree plans it."""
    both = hasattr(asc, "launch") and hasattr(asc, "bucketed")
    rows = []

    def sweep(table, op, make, check):
        n, w = table.shape
        for m in (1 << 20, 1 << 22, 1 << 24, 1 << 25, 1 << 26):
            idx, upd = make(m)
            nbytes, sectors = cs.scatter_bytes(idx, w * table.element_size())
            for force in ((True, False) if both else (None,)):
                plan = (asc.launch_plan(table, m, op) if force is None
                        else asc.launch_plan(table, m, op, bucket=force))

                def call(out, plan=plan, force=force):
                    return (asc.async_scatter(out, idx, upd, op)
                            if force is None
                            else asc.launch(out, idx, upd, op, plan))
                ok = True
                if check:
                    got = call(table.clone())
                    ok = cs.check_scatter16(op, got, table, idx, upd,
                                            raise_=False)
                    del got
                rule = (" (the rule's)" if both and plan.bucket
                        == asc.bucketed(w * table.element_size(), n, m)
                        else "")
                rows.append(dict(
                    kernel="async_scatter",
                    case=f"{op} [{n},{w}] {cs.tname(table.dtype)}, {m} "
                         f"updates, {'bucketed' if plan.bucket else 'not'}"
                         f"{rule}",
                    ms=cs.time_ms([lambda: call(table)], 10),
                    library_ms=None,
                    bound_ms=cs.amu_bound(nbytes, m * w)[0],
                    sector_bound_ms=cs.amu_bound(sectors)[0],
                    check="ok" if ok else "FAIL"))
            del idx, upd
            cs.free_cuda()

    def hot16(n):
        def make(m):
            idx = cs.amu_index(gen, n, m)
            idx[::4] %= 4096
            return idx, cs.rand_typed(gen, (m, 3), torch.bfloat16)
        return make

    for n in (1 << 24, 1 << 26, 1 << 28):
        table = cs.rand_typed(gen, (n, 3), torch.bfloat16)
        sweep(table, "add", hot16(n), True)
        del table
        cs.free_cuda()
    table = cs.amu_table(gen, (1 << 30, 2), torch.int32)
    sweep(table, "xor", lambda m: (cs.amu_index(gen, 1 << 30, m),
                                   cs.amu_table(gen, (m, 2), torch.int32)),
          False)
    del table
    cs.free_cuda()
    return rows


def bench_scatter_bf16(cs, asc, ref, gen):
    """bf16 add of 2^20 updates into [2^24, 64] (128-byte rows), held to
    `ref.scatter_add16_limit` of the plain version once."""
    n, w, m = 1 << 24, 64, 1 << 20
    table = cs.amu_table(gen, (n, w), torch.bfloat16)
    idx = cs.amu_index(gen, n, m)
    upd = cs.amu_table(gen, (m, w), torch.bfloat16)
    out = asc.async_scatter(table.clone(), idx, upd, "add")
    ok = cs.check_scatter16("bf16 add", out, table, idx, upd, raise_=False)
    nbytes, sectors = cs.scatter_bytes(idx, w * 2)
    row = dict(
        kernel="async_scatter",
        case=f"add [{n},{w}] bf16, {m} updates",
        ms=cs.time_ms([lambda: asc.async_scatter(out, idx, upd, "add")], 20),
        host_us=cs.host_us(lambda: asc.async_scatter(out, idx, upd, "add")),
        library_ms=cs.time_ms([lambda: out.index_add_(0, idx, upd)], 20),
        bound_ms=cs.amu_bound(nbytes, m * w)[0],
        sector_bound_ms=cs.amu_bound(sectors)[0],
        check="ok" if ok else "FAIL")
    del table, idx, upd, out
    cs.free_cuda()
    return row


if __name__ == "__main__":
    sys.exit(main())
