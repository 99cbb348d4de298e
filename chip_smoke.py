#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts and is right on the GPU.

    python3 chip_smoke.py                  # everything, needs one NVIDIA card
    python3 chip_smoke.py --kernels-only   # phases 1-3: build and check kernels

Phases, each of which fails the run (non-zero exit) on any error:

1. device: a CUDA card must be there; its name and power limit are printed.
2. build: every CUDA source of `src/repro_torch/kernels/csrc/` is compiled,
   and the machine code must hold the Hopper paths: wgmma and TMA loads in
   flash_attention, bulk copies in async_gather (cuobjdump).
3. kernels: each kernel's wrapper against its plain PyTorch version on the
   card, at the reference test shapes and at the full-width serve shapes
   (bf16, G=8, D=128). Inputs are drawn so that the logits have a standard
   deviation of about 2: the softmax is peaked, both products matter and the
   outputs are of order 0.1 to 1. fp32 is held to atol 2e-5 / rtol 1e-4;
   bf16 to one bf16 step of the value (rtol 1e-2, atol 1e-4), to which
   flash, whose P is rounded to bf16, adds the worst that rounding can do,
   2^-8 of sum_i p_i |v_i| (taken as 5e-3 of it). Flash's bf16 cases reach
   both of its tensor-core bodies and the wgmma body's edges (S ragged
   against 128 and below it, windows, GQA groups 1, 7, 8). Each is timed
   with CUDA events beside its plain version and one
   `scaled_dot_product_attention` call (a yardstick only: the port never
   calls it), and its bound is computed from the run's inputs. Then seeded
   random shapes through both kernels, and the KV offload class alone: pages
   through a small window on the side streams.
   Then the AMU kernels (async_gather, async_scatter, stream_triad) at the
   reference tests' shapes, its 10 seeded scatter fuzz cases, 8- and 12-byte
   rows and ragged lengths, the gather's two paths (bulk copies at 512-byte
   and 4 KB rows, also on a table 16 bytes in; cp.async on one 4 bytes in)
   at M = 1, 7, 131, 4000: gather and int32 scatter bit-exact, f32
   scatter-add within atol=rtol=1e-4, triad 1e-6 (f32) / 2e-2 (bf16); and
   what their wrappers refuse must raise.
4. slice: `repro_torch.launch.serve` serves qwen2.5-3b at full width with
   `--use-kernels --offload-kv`; offloaded tokens must equal the baseline's,
   the launch counters must show the kernels carried the run, and prefill
   logits with kernels must agree with the plain path.
5. AMU kernels at H100 scale: GUPS through `repro_torch.launch.quickstart`
   (xor, an 8 GiB table of HPCC's 8-byte rows, 2^26 updates), then
   `ops.scatter_update` (xor and f32 add, 8 GiB of 512-byte rows, 2^20
   updates), `ops.gather` (the same rows; qwen2.5-3b's embedding table) and
   `ops.triad` (2^28 floats), each against its plain version, timed beside
   its bound and the library call, and a sweep of the gather's ring depth K
   with the rows in flight per SM. One launch per `ops` call, counted.
6. one JSON line listing the kernels, then the device line, then the verdict.

Imports `torch` and `repro_torch` only. There is no fallback to the CPU or to
a plain version anywhere: whatever fails, fails the run.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# Published peaks of one H100 SXM (NVIDIA data sheet, dense rates): the
# bounds below are stated against these, whatever power limit the card has.
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

FP32_TOL = dict(atol=2e-5, rtol=1e-4)
# bf16: the plain versions compute in fp32 and round once at the end, so a
# right kernel differs by one bf16 step of the value (2^-7 of it at most) where
# the two fp32 results straddle a rounding boundary, plus its own rounding
# inside. Paged stays fp32. Flash rounds each p_i to bf16 (2^-8 of it at most)
# for the second product, so its result moves by at most 2^-8 sum_i p_i |v_i|,
# which is the plain version applied to |v| (`spread`), whatever cancels in
# sum_i p_i v_i itself: `ptol` times that is added to the limit.
FLASH_BF16_TOL = dict(atol=1e-4, rtol=1e-2, ptol=5e-3)
PAGED_BF16_TOL = dict(atol=1e-4, rtol=1e-2)
LIBRARY_TOL = dict(atol=1e-2, rtol=2e-2)  # the yardstick computes the same
# the AMU kernels, at tests/test_kernels.py's limits: f32 scatter-add sums a
# row's updates in the order the L2 applies them; triad's plain version
# repeats the kernel's arithmetic, so it agrees to the bit in practice
SCATTER_TOL = dict(atol=1e-4, rtol=1e-4)
TRIAD_TOL = {torch.float32: dict(atol=1e-6, rtol=1e-6),
             torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}
LOGITS_TOL = dict(atol=0.25, rtol=0.05)   # bf16 logits, kernels vs plain path

ARCH = "qwen2.5-3b"
BATCH, PROMPT_LEN, MAX_NEW = 4, 1000, 32

FLASH_SRC = "src/repro_torch/kernels/csrc/flash_attention.cu"
PAGED_SRC = "src/repro_torch/kernels/csrc/paged_attention.cu"


def log(msg: str) -> None:
    print(msg, flush=True)


def check_close(name, got, want, atol, rtol, ptol=0.0, spread=None,
                quiet=False) -> float:
    """Max abs error; raises unless
    |got - want| <= atol + rtol * |want| + ptol * spread, elementwise.
    `quiet` prints the line only where the check fails."""
    got, want = got.float(), want.float()
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite values in the result")
    err = (got - want).abs()
    worst = float(err.max())
    limit = atol + rtol * want.abs()
    if ptol:
        limit = limit + ptol * spread
    ok = bool((err <= limit).all())
    if not (ok and quiet):
        log(f"  {name}: max abs err {worst:.3e}, "
            f"{float((err / limit).max()):.2f} of the limit "
            f"(atol {atol:g}, rtol {rtol:g}"
            f"{f', ptol {ptol:g}' if ptol else ''}; median |value| "
            f"{float(want.abs().median()):.2e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: disagrees with its plain version, "
                             f"max abs err {worst:.3e}")
    return worst


def time_ms(calls, iters: int, repeats: int = 5) -> float:
    """ms of one call by CUDA events: the mean over `iters` back-to-back
    calls, best of `repeats` such windows after one warm-up round (a window
    in which the shared host stalls and lets the queue drain reads long).
    Each window starts behind a sleep kernel that outlasts twice the host's
    time to enqueue it, so that the window times the card even where a
    call's host time (`host_us`) comes near its kernel's. `calls` is a list
    of closures over different buffers, taken in turn so that a call finds
    its inputs as cold in L2 as the real caller would."""
    for fn in calls:
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(iters):
        calls[i % len(calls)]()
    enqueue_s = min(time.perf_counter() - t0, 0.05)
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(2 * enqueue_s * 2e9))    # cycles, at <= 2 GHz
        start.record()
        for i in range(iters):
            calls[i % len(calls)]()
        stop.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(stop) / iters)
    return best


def host_us(call, n: int = 50) -> float:
    """Host microseconds a wrapper call takes to enqueue its launch:
    perf_counter over `n` calls without a synchronise, then one. Where this
    comes near the CUDA-event ms of back-to-back calls, those measure the
    host, not the kernel."""
    call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        call()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


# ------------------------------------------------------------------ phase 2
# Hopper instructions that must be in a library's machine code: wgmma
# (HGMMA) on tiles loaded by TMA (UTMALDG) for flash, bulk copies (UBLKCP)
# for the gather's rows.
SASS_WANT = {"flash_attention": ("HGMMA", "UTMALDG"),
             "async_gather": ("UBLKCP",)}


def check_sass(out_dir) -> dict:
    """Counts the SASS lines of each instruction of `SASS_WANT` in the built
    libraries (cuobjdump, beside nvcc) and fails where one is missing."""
    from pathlib import Path
    from repro_torch.kernels import _build
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    counts = {}
    for lib, ops in SASS_WANT.items():
        sass = subprocess.run(
            [str(cuobjdump), "--dump-sass", str(out_dir / f"lib{lib}.so")],
            check=True, capture_output=True, text=True).stdout.splitlines()
        counts[lib] = {op: sum(op in line for line in sass) for op in ops}
        if not all(counts[lib].values()):
            raise AssertionError(f"lib{lib}.so lacks Hopper instructions: "
                                 f"{counts[lib]}")
    log(f"SASS lines of the Hopper paths: {counts}")
    return counts


Q_SCALE = 2.0     # q ~ N(0, 2^2), k ~ N(0, 1): logits q.k/sqrt(D) have std 2


def randn(gen, shape, dtype, scale=1.0):
    x = torch.randn(shape, generator=gen, device="cuda", dtype=torch.float32)
    return (x * scale).to(dtype)


# ------------------------------------------------------------------ phase 3
def flash_case(gen, b, hq, hkv, s, d, dtype):
    """q, k, v as the model hands them over: [B, S, H, D] viewed [B, H, S, D]."""
    q = randn(gen, (b, s, hq, d), dtype, Q_SCALE).transpose(1, 2)
    k = randn(gen, (b, s, hkv, d), dtype).transpose(1, 2)
    v = randn(gen, (b, s, hkv, d), dtype).transpose(1, 2)
    return q, k, v


def flash_spread(q, k, v, causal=True, window=0):
    """sum_i p_i |v_i| in fp32: what `FLASH_BF16_TOL["ptol"]` scales."""
    from repro_torch.kernels import ref
    return ref.attention_ref(q.float(), k.float(), v.float().abs(), causal,
                             window)


def flash_bound(b, hq, hkv, s, d, window, dtype):
    item = torch.empty((), dtype=dtype).element_size()
    nbytes = (2 * b * hq * s * d + 2 * b * hkv * s * d) * item
    rows = torch.arange(1, s + 1, dtype=torch.float64)
    keys = float((rows.clamp(max=window) if window else rows).sum())
    flops = 4.0 * b * hq * keys * d       # QK^T and PV, 2 flops per FMA
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def check_flash(gen):
    from repro_torch.kernels import flash_attention as fa, ref
    import torch.nn.functional as F

    log("flash_attention vs ref.attention_ref")
    worst = 0.0
    for (b, hq, hkv, s, d) in [(2, 4, 2, 256, 64), (1, 8, 1, 128, 128),
                               (2, 2, 2, 512, 32)]:
        for window in (0, 64):
            q, k, v = flash_case(gen, b, hq, hkv, s, d, torch.float32)
            out = fa.flash_attention(q, k, v, causal=True, window=window)
            torch.cuda.synchronize()
            worst = max(worst, check_close(
                f"fp32 B{b} Hq{hq} Hkv{hkv} S{s} D{d} window{window}", out,
                ref.attention_ref(q, k, v, True, window), **FP32_TOL))
    q, k, v = flash_case(gen, 2, 4, 2, 200, 16, torch.float32)
    check_close("fp32 ragged S200 D16 window48",
                fa.flash_attention(q, k, v, window=48),
                ref.attention_ref(q, k, v, True, 48), **FP32_TOL)
    q, k, v = flash_case(gen, 1, 2, 2, 130, 32, torch.float32)
    check_close("fp32 ragged S130 D32 not causal",
                fa.flash_attention(q, k, v, causal=False),
                ref.attention_ref(q, k, v, False, 0), **FP32_TOL)
    # the body rule of the source is the wrapper's
    from repro_torch.kernels import _build
    lib = _build.load("flash_attention")
    names = {0: "fma", 1: "wgmma", 2: "mma"}
    for dtype in (torch.float32, torch.bfloat16):
        for d in fa.HEAD_DIMS:
            got = names[lib.flash_attention_body(_build.DTYPE_CODES[dtype], d)]
            if got != fa.body_for(dtype, d):
                raise AssertionError(f"flash body for {dtype} D{d}: source "
                                     f"runs {got}, wrapper says "
                                     f"{fa.body_for(dtype, d)}")
    log("  body rule: fp32 -> fma; bf16 D64/D128 -> wgmma, D16/D32 -> mma "
        "(source and wrapper agree)")
    # bf16 runs on the tensor cores: D 16/32 on mma.sync, 64/128 on wgmma;
    # then the wgmma body at its edges: S ragged against its 128-row tiles
    # and below one tile, windows, not causal, GQA groups 1, 7 and 8
    for (b, hq, hkv, s, d, causal, window) in [
            (1, 4, 2, 128, 64, True, 0), (2, 4, 2, 200, 16, True, 48),
            (2, 2, 2, 512, 32, True, 64), (1, 8, 1, 333, 128, True, 0),
            (2, 4, 2, 256, 64, True, 64), (1, 4, 2, 130, 64, False, 0),
            # head layouts of qwen2-7b, phi4-mini-3.8b, qwen2.5-32b
            (1, 28, 4, 200, 128, True, 0), (1, 24, 8, 200, 128, True, 0),
            (1, 40, 8, 200, 128, True, 0),
            (2, 4, 4, 129, 128, True, 0), (1, 7, 1, 255, 64, True, 0),
            (1, 8, 1, 1000, 128, True, 0), (2, 4, 2, 100, 128, True, 0),
            (1, 4, 2, 37, 64, False, 0), (1, 7, 1, 300, 128, True, 48),
            (1, 4, 4, 255, 64, True, 64), (1, 8, 1, 129, 64, False, 48),
            (1, 4, 2, 1000, 128, False, 0), (2, 16, 2, 255, 128, True, 64)]:
        q, k, v = flash_case(gen, b, hq, hkv, s, d, torch.bfloat16)
        out = fa.flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        check_close(f"bf16 B{b} Hq{hq} Hkv{hkv} S{s} D{d} causal{causal} "
                    f"window{window}", out,
                    ref.attention_ref(q, k, v, causal, window),
                    spread=flash_spread(q, k, v, causal, window),
                    **FLASH_BF16_TOL)

    # the serve shape: full-width qwen2.5-3b prefill, S ragged against 128
    from repro_torch import configs
    cfg = configs.get_config(ARCH)
    b, hq, hkv, s, d = (BATCH, cfg.num_heads, cfg.num_kv_heads, PROMPT_LEN,
                        cfg.resolved_head_dim)
    q, k, v = flash_case(gen, b, hq, hkv, s, d, torch.bfloat16)
    out = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    err = check_close(f"bf16 serve shape B{b} Hq{hq} Hkv{hkv} S{s} D{d}", out,
                      ref.attention_ref(q, k, v),
                      spread=flash_spread(q, k, v), **FLASH_BF16_TOL)
    check_close("  (library call agrees)", F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), out, **LIBRARY_TOL)
    ms = time_ms([lambda: fa.flash_attention(q, k, v)], 20)
    plain_ms = time_ms([lambda: ref.attention_ref(q, k, v)], 5)
    library_ms = time_ms([lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True)], 10)
    bound_ms, bound_by = flash_bound(b, hq, hkv, s, d, 0, torch.bfloat16)
    host = host_us(lambda: fa.flash_attention(q, k, v))
    log(f"  serve shape ({fa.body_for(q.dtype, d)} body): kernel {ms:.4f} ms "
        f"(host {host:.1f} us a call), plain {plain_ms:.4f} ms, library "
        f"{library_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by})")
    return {"name": "flash_attention", "route": "cuda", "source": FLASH_SRC,
            "replaces": "src/repro/kernels/flash_attention.py:96",
            "launches": 0, "max_abs_err": max(err, worst), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def paged_bound(lengths, hq, hkv, d, dtype):
    item = torch.empty((), dtype=dtype).element_size()
    rows, b = int(lengths.sum()), lengths.numel()
    nbytes = 2 * rows * hkv * d * item + 2 * b * hq * d * item + 4 * b
    flops = 4.0 * rows * hq * d
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def check_paged(gen):
    from repro_torch.kernels import paged_attention as pa, ref
    import torch.nn.functional as F

    log("paged_attention vs ref.paged_attention_ref")
    worst = 0.0
    for (b, hq, hkv, t, d, page) in [(3, 8, 2, 1024, 64, 256),
                                     (1, 4, 4, 512, 128, 512),
                                     (2, 16, 2, 2048, 64, 512),
                                     (2, 16, 2, 1032, 128, 512),  # G=8
                                     (2, 4, 2, 700, 16, 512)]:
        q = randn(gen, (b, hq, d), torch.float32, Q_SCALE)
        kc = randn(gen, (b, t, hkv, d), torch.float32)
        vc = randn(gen, (b, t, hkv, d), torch.float32)
        lens = torch.randint(1, t + 1, (b,), generator=gen, device="cuda",
                             dtype=torch.int32)
        out = pa.paged_attention(q, kc, vc, lens, page=page)
        torch.cuda.synchronize()
        worst = max(worst, check_close(
            f"fp32 B{b} Hq{hq} Hkv{hkv} T{t} D{d} page{page}", out,
            ref.paged_attention_ref(q, kc, vc, lens), **FP32_TOL))

    for (b, hq, hkv, t, d) in [(2, 28, 4, 300, 128), (2, 24, 8, 300, 128),
                               (2, 40, 8, 300, 128), (2, 4, 2, 140, 16)]:
        q = randn(gen, (b, hq, d), torch.bfloat16, Q_SCALE)
        kc = randn(gen, (b, t, hkv, d), torch.bfloat16)
        vc = randn(gen, (b, t, hkv, d), torch.bfloat16)
        lens = torch.tensor([t, t // 3], dtype=torch.int32, device="cuda")
        check_close(f"bf16 B{b} Hq{hq} Hkv{hkv} T{t} D{d}",
                    pa.paged_attention(q, kc, vc, lens),
                    ref.paged_attention_ref(q, kc, vc, lens),
                    **PAGED_BF16_TOL)

    # the serve shape: full-width qwen2.5-3b decode, T ragged, mixed lengths
    from repro_torch import configs
    cfg = configs.get_config(ARCH)
    b, hq, hkv, t, d = (BATCH, cfg.num_heads, cfg.num_kv_heads,
                        PROMPT_LEN + MAX_NEW, cfg.resolved_head_dim)
    lens = torch.tensor([t, PROMPT_LEN + 1, 517, 64], dtype=torch.int32,
                        device="cuda")
    # enough distinct caches to exceed the L2: a decode step finds its layer's
    # cache cold, the layer's weights went through the L2 since the last step
    sets = []
    for _ in range(16):
        sets.append((randn(gen, (b, 1, hq, d), torch.bfloat16, Q_SCALE)[:, 0],
                     randn(gen, (b, t, hkv, d), torch.bfloat16),
                     randn(gen, (b, t, hkv, d), torch.bfloat16)))
    q, kc, vc = sets[0]
    out = pa.paged_attention(q, kc, vc, lens)
    torch.cuda.synchronize()
    err = check_close(f"bf16 serve shape B{b} Hq{hq} Hkv{hkv} T{t} D{d} "
                      f"lengths {lens.tolist()}", out,
                      ref.paged_attention_ref(q, kc, vc, lens),
                      **PAGED_BF16_TOL)
    ms = time_ms([lambda s=s: pa.paged_attention(*s, lens) for s in sets], 64)
    plain_ms = time_ms([lambda s=s: ref.paged_attention_ref(*s, lens)
                        for s in sets], 32)
    mask = (torch.arange(t, device="cuda")[None, :]
            < lens[:, None])[:, None, None, :]

    def library(s):
        return F.scaled_dot_product_attention(
            s[0][:, :, None], s[1].transpose(1, 2), s[2].transpose(1, 2),
            attn_mask=mask, enable_gqa=True)
    check_close("  (library call agrees)", library(sets[0])[:, :, 0], out,
                **LIBRARY_TOL)
    library_ms = time_ms([lambda s=s: library(s) for s in sets], 64)
    bound_ms, bound_by = paged_bound(lens, hq, hkv, d, torch.bfloat16)
    log(f"  serve shape: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"library {library_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by})")
    return {"name": "paged_attention", "route": "cuda", "source": PAGED_SRC,
            "replaces": "src/repro/kernels/paged_attention.py:79",
            "launches": 0, "max_abs_err": max(err, worst), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def fuzz_kernels(gen, cases=40):
    """Seeded random shapes through both kernels: any S and T, odd GQA
    groups, windows shorter and longer than a tile, causal or not, ragged
    lengths, every head size and both types."""
    import random
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa, ref

    log(f"seeded random shapes, {cases} per kernel")
    rnd = random.Random(0)
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for i in range(cases):
        dtype = rnd.choice([torch.float32, torch.bfloat16])
        fp32 = dtype == torch.float32
        b, hkv, g = rnd.randint(1, 3), rnd.choice([1, 2, 4]), \
            rnd.choice([1, 2, 3, 5, 8, 16])
        d = rnd.choice([16, 32, 64, 128])
        s = rnd.choice([1, 7, 63, 64, 65, rnd.randint(2, 400)])
        causal = rnd.random() < 0.7
        window = rnd.choice([0, 0, rnd.randint(1, max(1, s)), 3 * s + 1])
        q, k, v = flash_case(gen, b, hkv * g, hkv, s, d, dtype)
        got = fa.flash_attention(q, k, v, causal=causal, window=window)
        want = ref.attention_ref(q, k, v, causal, window)
        name = (f"flash #{i} {dtype} B{b} Hq{hkv * g} Hkv{hkv} S{s} D{d} "
                f"causal{causal} window{window}")
        if fp32:
            tol = FP32_TOL
        else:
            tol = dict(FLASH_BF16_TOL,
                       spread=flash_spread(q, k, v, causal, window))
        worst[dtype] = max(worst[dtype],
                           check_close(name, got, want, quiet=True, **tol))

        t = rnd.choice([1, 63, 64, 65, 512, rnd.randint(2, 1500)])
        page = rnd.choice([64, 256, 512])
        tol = FP32_TOL if fp32 else PAGED_BF16_TOL
        qd = randn(gen, (b, hkv * g, d), dtype, Q_SCALE)
        kc = randn(gen, (b, t, hkv, d), dtype)
        vc = randn(gen, (b, t, hkv, d), dtype)
        lens = torch.tensor([rnd.randint(1, t) for _ in range(b)],
                            dtype=torch.int32, device="cuda")
        got = pa.paged_attention(qd, kc, vc, lens, page=page)
        want = ref.paged_attention_ref(qd, kc, vc, lens)
        name = (f"paged #{i} {dtype} B{b} Hq{hkv * g} Hkv{hkv} T{t} D{d} "
                f"page{page} lengths {lens.tolist()}")
        worst[dtype] = max(worst[dtype],
                           check_close(name, got, want, quiet=True, **tol))
    torch.cuda.synchronize()
    log(f"  all agree; max abs err fp32 {worst[torch.float32]:.3e}, "
        f"bf16 {worst[torch.bfloat16]:.3e}")


def check_offload(gen):
    """OffloadedKVCache on the card beyond what `launch.serve` moves: eight
    pages walked twice through a window of two and updated in place, so pages
    are uploaded, written back, uploaded again from the written-back copy and
    written back again, all on the side streams. The same walk on the CPU
    (plain copies) must leave the same host copies and the same stats."""
    from repro_torch.runtime.offload import OffloadedKVCache

    log("OffloadedKVCache on the card: 8 pages, window 2, two passes")
    n, passes = 8, 2
    pages = [randn(gen, (4, 256, 2, 128), torch.bfloat16) for _ in range(n)]

    def walk(device):
        kv = OffloadedKVCache(num_layers=n, window=2, device=device)
        for i, page in enumerate(pages):
            kv.host_put(i, page.to(device))
        kv.prefetch(0)
        for _ in range(passes):
            for i in range(n):
                page = kv.fetch(i)
                page += 1.0                 # in place, on the current stream
                kv.update(i, page)
        kv.close()
        return kv

    on_card, on_cpu = walk("cuda"), walk("cpu")
    for i, page in enumerate(pages):
        if not on_card._host[i].is_pinned():
            raise AssertionError("host pages are not in pinned memory")
        want = page.float()
        for _ in range(passes):
            want = (want + 1.0).to(torch.bfloat16).float()
        for kv in (on_card, on_cpu):
            if not torch.equal(kv._host[i].float(), want.cpu()):
                raise AssertionError(f"host copy of page {i} is wrong after "
                                     f"the writebacks ({kv.device})")
    log(f"  host copies right after {passes} passes; stats {on_card.stats}")
    if on_card.stats != on_cpu.stats or on_card.stats["writebacks"] < n:
        raise AssertionError(f"offload stats on the card {on_card.stats} != "
                             f"on the CPU {on_cpu.stats}")


def check_equal(name, got, want, quiet=False) -> float:
    """Bit-exact agreement (the gather kernel copies, xor is exact)."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name}: {tuple(got.shape)} {got.dtype} != "
                             f"{tuple(want.shape)} {want.dtype}")
    if not torch.equal(got, want):
        bad = int((got != want).sum())
        raise AssertionError(f"{name}: {bad} of {got.numel()} elements differ "
                             "from the plain version (want bit-exact)")
    if not quiet:
        log(f"  {name}: bit-exact ok")
    return 0.0


def amu_table(gen, shape, dtype):
    """Random table on the card: int32 in [0, 2^30), floats N(0, 1)."""
    if dtype == torch.int32:
        return torch.randint(0, 1 << 30, shape, generator=gen, device="cuda",
                             dtype=torch.int32)
    return torch.randn(shape, generator=gen, device="cuda", dtype=dtype)


def amu_index(gen, n, m):
    return torch.randint(0, n, (m,), generator=gen, device="cuda",
                         dtype=torch.int32)


def check_amu_kernels(gen):
    """async_gather, async_scatter and stream_triad against their plain
    versions on the card at the reference tests' shapes, the 10 seeded fuzz
    cases, rows of 8 and 12 bytes and ragged lengths; then the refusals.
    Returns the worst error of each kernel."""
    import numpy as np
    from repro_torch.kernels import async_gather as ag
    from repro_torch.kernels import async_scatter as asc
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import stream_triad as st

    log("async_gather vs ref.gather_ref: bit-exact")
    for (n, d, m, bm, k) in [(64, 128, 256, 128, 8), (512, 256, 128, 64, 4),
                             (33, 128, 64, 32, 2), (1024, 512, 512, 256, 16),
                             (1000, 2, 1000, 256, 8), (77, 3, 333, 64, 3)]:
        for dtype in (torch.float32, torch.bfloat16, torch.int32):
            if d * torch.empty((), dtype=dtype).element_size() % 4:
                continue                    # bf16 with D = 3: refused below
            table = amu_table(gen, (n, d), dtype)
            idx = amu_index(gen, n, m)
            check_equal(f"{str(dtype)[6:]} N{n} D{d} M{m} block_m{bm} K{k}",
                        ag.async_gather(table, idx, block_m=bm, num_slots=k),
                        ref.gather_ref(table, idx))

    log("async_gather paths: bulk copies for rows of a multiple of 16 bytes "
        "on a 16-byte aligned table, cp.async chunks otherwise; bit-exact")
    for (n, d, dtype, offset, bulk) in [
            (1000, 128, torch.float32, 0, True),      # 512-byte rows
            (3000, 2048, torch.bfloat16, 0, True),    # 4 KB rows
            (1000, 128, torch.float32, 16, True),     # table 16 bytes in
            (1000, 128, torch.float32, 4, False),     # table 4 bytes in
            (1000, 2, torch.float32, 0, False)]:      # 8-byte rows
        flat = amu_table(gen, (n * d + 16,), dtype)
        first = offset // flat.element_size()
        table = flat[first:first + n * d].view(n, d)
        for m in (1, 7, 131, 4000):
            idx = amu_index(gen, n, m)
            plan = ag.launch_plan(table, m)
            what = (f"{str(dtype)[6:]} rows of {d * flat.element_size()} B, "
                    f"table +{offset} B, M{m}: {plan.blocks} blocks of "
                    f"{plan.rows} rows, {plan.warps} warps, "
                    f"{'bulk' if plan.bulk else f'cp.async {plan.chunk} B'}")
            if plan.bulk != bulk:
                raise AssertionError(f"{what}: want the "
                                     f"{'bulk' if bulk else 'cp.async'} path")
            want = ref.gather_ref(table, idx)
            check_equal(what, ag.async_gather(table, idx), want,
                        quiet=m != 4000)
            for bm, k in ((1, 1), (16, 3), (64, 32)):   # block_m: a bound
                check_equal(f"{what}, block_m {bm} K{k}", ag.async_gather(
                    table, idx, block_m=bm, num_slots=k), want, quiet=True)
        del flat, table

    log("async_scatter vs ref.scatter_update_ref: f32 add atol=rtol=1e-4, "
        "int32 add and xor bit-exact")
    worst = 0.0
    for (n, d, m, bm, k) in [(64, 128, 256, 128, 8), (8, 128, 64, 32, 4),
                             (1024, 256, 128, 128, 8), (16, 8, 128, 64, 8),
                             (1000, 2, 1000, 256, 8), (77, 3, 333, 64, 3)]:
        table = amu_table(gen, (n, d), torch.float32)
        idx = amu_index(gen, n, m)
        upd = randn(gen, (m, d), torch.float32)
        want = ref.scatter_update_ref(table, idx, upd, "add")
        got = asc.async_scatter(table, idx, upd, "add", block_m=bm,
                                num_slots=k)
        worst = max(worst, check_close(
            f"f32 add N{n} D{d} M{m} block_m{bm} K{k}", got, want,
            **SCATTER_TOL))
        for op in ("add", "xor"):
            table = amu_table(gen, (n, d), torch.int32)
            upd = amu_table(gen, (m, d), torch.int32)
            want = ref.scatter_update_ref(table, idx, upd, op)
            check_equal(f"i32 {op} N{n} D{d} M{m} block_m{bm} K{k}",
                        asc.async_scatter(table, idx, upd, op, block_m=bm,
                                          num_slots=k), want)
    # tests/test_kernels.py::test_async_scatter_xor_gups
    table = amu_table(gen, (32, 8), torch.int32)
    idx = amu_index(gen, 32, 256)
    upd = amu_table(gen, (256, 8), torch.int32)
    check_equal("xor GUPS N32 D8 M256 (8 updates a row)",
                asc.async_scatter(table.clone(), idx, upd, "xor",
                                  block_m=128, num_slots=8),
                ref.scatter_update_ref(table, idx, upd, "xor"))
    # the 10 seeded cases of tests/test_kernels.py::test_async_scatter_fuzz
    rng = np.random.default_rng(7)
    for i in range(10):
        n = int(rng.integers(4, 128))
        bm = int(rng.choice([16, 64]))
        m = bm * int(rng.integers(1, 4))
        k = int(rng.choice([2, 4, 8]))
        table = torch.from_numpy(
            rng.standard_normal((n, 32)).astype(np.float32)).cuda()
        idx = torch.from_numpy(rng.integers(0, n, m).astype(np.int32)).cuda()
        upd = torch.from_numpy(
            rng.standard_normal((m, 32)).astype(np.float32)).cuda()
        want = ref.scatter_update_ref(table, idx, upd, "add")
        worst = max(worst, check_close(
            f"fuzz #{i} f32 add N{n} M{m} block_m{bm} K{k}",
            asc.async_scatter(table, idx, upd, "add", block_m=bm,
                              num_slots=k), want, quiet=True, **SCATTER_TOL))
    log(f"  10 seeded fuzz cases agree; worst f32 add error {worst:.3e}")

    log("stream_triad vs ref.triad_ref: f32 atol=rtol=1e-6, bf16 2e-2")
    triad_worst = 0.0
    for (n, block) in [(4096, 512), (8192, 1024), (512, 512), (1003, 512)]:
        for dtype in (torch.float32, torch.bfloat16):
            b, c = randn(gen, (n,), dtype), randn(gen, (n,), dtype)
            tol = TRIAD_TOL[dtype]
            triad_worst = max(triad_worst, check_close(
                f"{str(dtype)[6:]} N{n} block{block}",
                st.stream_triad(b, c, 3.0, block=block),
                ref.triad_ref(b, c, 3.0), **tol))
    b, c = randn(gen, (1000,), torch.float32), randn(gen, (1000,),
                                                      torch.float32)
    triad_worst = max(triad_worst, check_close(
        "ops.triad f32 N1000 (not a multiple of block 512)",
        ops.triad(b, c, 2.5, block=512), ref.triad_ref(b, c, 2.5),
        **TRIAD_TOL[torch.float32]))

    # what the kernels do not take must raise, not fall back
    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device="cuda")
    refusals = [
        ("async_gather, bf16 rows of 6 bytes", ValueError,
         lambda: ag.async_gather(zeros(4, 3, dtype=torch.bfloat16),
                                 amu_index(gen, 4, 3))),
        ("async_scatter, xor on float32", TypeError,
         lambda: asc.async_scatter(zeros(4, 4), amu_index(gen, 4, 3),
                                   zeros(3, 4), "xor")),
        ("stream_triad, int32", TypeError,
         lambda: st.stream_triad(zeros(8, dtype=torch.int32),
                                 zeros(8, dtype=torch.int32), 1.0)),
    ]
    for name, exc, call in refusals:
        try:
            call()
        except exc:
            pass
        else:
            raise AssertionError(f"{name}: the wrapper did not raise")
    torch.cuda.synchronize()
    log("  refused as they should be: " + "; ".join(r[0] for r in refusals))
    return {"async_gather": 0.0, "async_scatter": worst,
            "stream_triad": triad_worst}


# ------------------------------------------------------------------ phase 4
def run_slice(kernels):
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.launch.serve import serve
    from repro_torch.models import lm

    cfg = configs.get_config(ARCH)
    log(f"slice: serve {ARCH} at full width: {cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads, head_dim "
        f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}; "
        f"batch {BATCH}, prompt {PROMPT_LEN}, max_new {MAX_NEW}")
    torch.cuda.reset_peak_memory_stats()
    fa.launches = pa.launches = 0
    res = serve(ARCH, batch=BATCH, prompt_len=PROMPT_LEN, max_new=MAX_NEW,
                use_kernels=True, offload_kv=True, device="cuda", seed=0)
    n_flash, n_paged = fa.launches, pa.launches
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()

    L, steps = cfg.num_layers, MAX_NEW - 1
    log(f"  launches on the main path: flash_attention {n_flash} (want {L}: "
        f"one prefill), paged_attention {n_paged} (want {2 * L * steps}: "
        f"{L} x {steps} steps x 2 decode runs)")
    if n_flash != L or n_paged != 2 * L * steps:
        raise AssertionError("the main path did not go through the kernels "
                             "as often as it has layers and steps")
    kernels[0]["launches"], kernels[1]["launches"] = n_flash, n_paged

    tokens, tokens_off = res["tokens"], res["tokens_offload"]
    if tuple(tokens.shape) != (BATCH, MAX_NEW):
        raise AssertionError(f"tokens have shape {tuple(tokens.shape)}")
    if int(tokens.min()) < 0 or int(tokens.max()) >= cfg.vocab_size:
        raise AssertionError("generated tokens outside the vocabulary")
    if not res["tokens_identical"] or not torch.equal(tokens, tokens_off):
        raise AssertionError("offloaded decode diverged from the baseline")
    log(f"  offloaded tokens identical to baseline: True | row 0: "
        f"{tokens[0, :12].tolist()}")

    # the same weights and prompts through the plain attention path
    cache = lm.init_cache(cfg, BATCH, PROMPT_LEN + MAX_NEW, device="cuda")
    logits_plain, _ = lm.prefill(cfg, res["params"],
                                 {"tokens": res["prompts"]}, cache,
                                 use_kernels=False)
    torch.cuda.synchronize()
    if fa.launches != n_flash:
        raise AssertionError("use_kernels=False launched the flash kernel")
    got = res["prefill_logits"]
    if tuple(got.shape) != (BATCH, 1, cfg.vocab_size):
        raise AssertionError(f"logits have shape {tuple(got.shape)}")
    check_close("prefill last-token logits, kernels vs plain path (bf16)",
                got, logits_plain, **LOGITS_TOL)
    agree = float((got.argmax(-1) == logits_plain.argmax(-1)).float().mean())
    log(f"  greedy first token agrees on {agree:.0%} of the batch")

    log(f"  prefill {res['prefill_ms']:.2f} ms for {BATCH}x{PROMPT_LEN} "
        f"tokens | decode {res['decode_tok_s']:.2f} tok/s "
        f"({res['decode_ms']:.2f} ms for {steps} steps) | decode with "
        f"offload {res['offload_tok_s']:.2f} tok/s "
        f"({res['offload_ms']:.2f} ms)")
    log(f"  offload: {res['offload_pages']} pages, window "
        f"{res['offload_window']}, stats {res['offload_stats']}")
    log(f"  peak device memory {peak / 2**30:.3f} GiB "
        f"(torch.cuda.max_memory_allocated)")

    # the smoke sizes on the card, kernels and offload on: head size 16 runs;
    # head size 8 is below what the kernels take and must raise, not fall back
    for arch in ("qwen2.5-3b", "qwen2-7b", "phi4-mini-3.8b", "qwen2.5-32b"):
        kwargs = dict(smoke=True, batch=2, prompt_len=130, max_new=4,
                      use_kernels=True, offload_kv=True, device="cuda")
        if configs.get_smoke_config(arch).resolved_head_dim in fa.HEAD_DIMS:
            small = serve(arch, **kwargs)
            if not small["tokens_identical"] or not torch.isfinite(
                    small["prefill_logits"].float()).all():
                raise AssertionError(f"{arch} at smoke size failed")
        else:
            try:
                serve(arch, **kwargs)
            except ValueError as exc:
                if "head dim" not in str(exc):
                    raise
            else:
                raise AssertionError(f"{arch} at smoke size: a head size the "
                                     "kernels do not take did not raise")
    log("  dense archs at smoke size on the card: head size 16 served, "
        "head size 8 refused by the wrappers")


# ------------------------------------------------------------------ phase 5
def amu_bound(nbytes, ops=0.0):
    """Bytes over the memory rate against 32-bit operations over the fp32
    rate (the guide's table has no int32 rate; add and xor are far below
    either way)."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_FLOPS[torch.float32]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def check_close_big(name, got, want, atol, rtol) -> float:
    """check_close over slices of 2^26 elements, so that an 8 GiB table
    needs no 8 GiB temporaries."""
    g, w = got.reshape(-1), want.reshape(-1)
    worst, ratio, step = 0.0, 0.0, 1 << 26
    for i in range(0, g.numel(), step):
        gi, wi = g[i:i + step].float(), w[i:i + step].float()
        if not torch.isfinite(gi).all():
            raise AssertionError(f"{name}: non-finite values in the result")
        err = (gi - wi).abs()
        worst = max(worst, float(err.max()))
        ratio = max(ratio, float((err / (atol + rtol * wi.abs())).max()))
    ok = ratio <= 1.0
    log(f"  {name}: max abs err {worst:.3e}, {ratio:.2f} of the limit (atol "
        f"{atol:g}, rtol {rtol:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: disagrees with its plain version, "
                             f"max abs err {worst:.3e}")
    return worst


def free_cuda():
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def run_amu(kernels, worst):
    """The AMU kernels' own path at H100 scale: the quickstart's GUPS at
    HPCC's 8-byte rows, then `ops.scatter_update`, `ops.gather` and
    `ops.triad` on tables in HBM far past the 50 MB L2. Each case is held
    against its plain version on the card, timed with CUDA events beside its
    bound and, where one PyTorch call computes the same, that call; then the
    gather's ring depth is swept. The launch counters are set to 0 just
    before each `ops` call and read just after."""
    from repro_torch import configs
    from repro_torch.kernels import async_gather as ag
    from repro_torch.kernels import async_scatter as asc
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import stream_triad as st
    from repro_torch.launch import quickstart

    mods = {"async_gather": ag, "async_scatter": asc, "stream_triad": st}
    counts = dict.fromkeys(mods, 0)

    def drive(fn):
        for mod in mods.values():
            mod.launches = 0
        out = fn()
        torch.cuda.synchronize()
        for name, mod in mods.items():
            counts[name] += mod.launches
        return out

    gen = torch.Generator(device="cuda").manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    free_cuda()
    cases = []

    def report(case, kernel, **nums):
        cases.append(dict(case=case, kernel=kernel, **nums))
        gbs = nums["bytes"] / nums["ms"] / 1e6
        lib = nums.get("library_ms")
        log(f"  {case}: kernel {nums['ms']:.4f} ms ({gbs:.1f} GB/s), plain "
            f"{nums['plain_ms']:.4f} ms, library "
            f"{'none' if lib is None else f'{lib:.4f} ms'}, bound "
            f"{nums['bound_ms']:.5f} ms ({nums['bound_by']}, "
            f"{nums['bytes'] / 1e9:.4f} GB)")

    # GUPS, HPCC RandomAccess rows, through the quickstart
    rows, width, m, k = 1 << 30, 2, 1 << 26, 8
    log("AMU kernels at H100 scale (data from torch.Generator seed 0)")
    log(f"GUPS through launch.quickstart: xor, table [{rows}, {width}] int32 "
        f"({rows * width * 4 / 2**30:.0f} GiB), {m} updates, {k} slots")
    res = drive(lambda: quickstart.gups(
        table_rows=rows, row_width=width, updates=m, num_slots=k, seed=0,
        device="cuda", source="device"))
    if not res["ok"]:
        raise AssertionError("GUPS: the quickstart reports MISMATCH")
    check_equal("quickstart GUPS xor vs ref.scatter_update_ref", res["out"],
                res["expect"])
    idx, upd, out = res["indices"], res["updates"], res["out"]
    del res
    free_cuda()
    touched = torch.unique(idx).numel()
    nbytes = 2 * touched * width * 4 + m * width * 4 + m * 4
    bound_ms, bound_by = amu_bound(nbytes, m * width)
    ms = time_ms([lambda: asc.async_scatter(out, idx, upd, "xor",
                                            num_slots=k)], 10)
    plain_ms = time_ms([lambda: ref.scatter_update_ref(out, idx, upd, "xor")],
                       1, repeats=2)
    report(f"GUPS xor [{rows},{width}] int32, {m} updates", "async_scatter",
           ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=bound_ms,
           bound_by=bound_by, bytes=nbytes, touched_rows=touched,
           giga_updates_s=m / ms / 1e6)
    log(f"    {m / ms / 1e6:.3f} GUP/s; the bound counts 8 bytes a row, the "
        "card moves 32-byte sectors: about 4x of it is out of reach")
    gups = cases[-1]
    del idx, upd, out
    free_cuda()

    # GUPS and scatter-add at the quickstart's 512-byte rows
    rows, width, m = 1 << 24, 128, 1 << 20
    for op, dtype in (("xor", torch.int32), ("add", torch.float32)):
        table = amu_table(gen, (rows, width), dtype)
        idx = amu_index(gen, rows, m)
        upd = amu_table(gen, (m, width), dtype)
        name = (f"scatter {op} [{rows},{width}] {str(dtype)[6:]}, "
                f"{m} updates")
        out = drive(lambda: ops.scatter_update(table, idx, upd, op))
        want = ref.scatter_update_ref(table, idx, upd, op)
        if op == "xor":
            check_equal(name, out, want)
        else:
            worst["async_scatter"] = max(worst["async_scatter"],
                                         check_close_big(name, out, want,
                                                         **SCATTER_TOL))
        touched = torch.unique(idx).numel()
        nbytes = 2 * touched * width * 4 + m * width * 4 + m * 4
        bound_ms, bound_by = amu_bound(nbytes, m * width)
        ms = time_ms([lambda: asc.async_scatter(out, idx, upd, op)], 20)
        plain_ms = time_ms([lambda: ref.scatter_update_ref(table, idx, upd,
                                                           op)], 2, repeats=3)
        library_ms = None
        if op == "add":
            library_ms = time_ms([lambda: want.index_add_(0, idx, upd)], 20)
        report(name, "async_scatter", ms=ms, plain_ms=plain_ms,
               library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
               bytes=nbytes, touched_rows=touched)
        del table, idx, upd, out, want
        free_cuda()

    # gather: 512-byte rows of an 8 GiB table, then the embedding lookup
    cfg = configs.get_config(ARCH)
    gathers = [((1 << 24, 128), torch.float32, 1 << 20, "random rows"),
               ((cfg.vocab_size, cfg.d_model), torch.bfloat16,
                BATCH * PROMPT_LEN, f"{ARCH} embedding, {BATCH}x{PROMPT_LEN} "
                "token ids")]
    sweep = []
    for i, (shape, dtype, m, what) in enumerate(gathers):
        table = amu_table(gen, shape, dtype)
        idx = amu_index(gen, shape[0], m)
        name = f"gather [{shape[0]},{shape[1]}] {str(dtype)[6:]}, {m} {what}"
        out = drive(lambda: ops.gather(table, idx))
        check_equal(name, out, ref.gather_ref(table, idx))
        check_equal("  (library call agrees)", torch.index_select(table, 0,
                                                                   idx), out)
        row_bytes = shape[1] * table.element_size()
        touched = torch.unique(idx).numel()
        nbytes = touched * row_bytes + m * row_bytes + m * 4
        bound_ms, bound_by = amu_bound(nbytes)
        ms = time_ms([lambda: ag.async_gather(table, idx)], 20)
        plain_ms = time_ms([lambda: ref.gather_ref(table, idx)], 20)
        library_ms = time_ms([lambda: torch.index_select(table, 0, idx)], 20)
        plan = ag.launch_plan(table, m)
        report(name, "async_gather", ms=ms, plain_ms=plain_ms,
               library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
               bytes=nbytes, touched_rows=touched,
               rows_in_flight_per_sm=plan.rows_in_flight_per_sm,
               host_us=host_us(lambda: ag.async_gather(table, idx)),
               library_host_us=host_us(
                   lambda: torch.index_select(table, 0, idx)))
        log(f"    {plan.blocks} blocks of {plan.rows} rows, {plan.warps} "
            f"warps, {'bulk' if plan.bulk else 'cp.async'} path; host "
            f"{cases[-1]['host_us']:.1f} us a call (index_select "
            f"{cases[-1]['library_host_us']:.1f} us)")
        if i == 0:
            gather_main = cases[-1]
        # the paper's "queue length follows demand": ring depth K, on the
        # 8 GiB table and on the embedding table
        log(f"  ring-depth sweep on {name} ({plan.blocks} blocks of "
            f"{plan.rows} indices at K=8):")
        for slots in (1, 2, 4, 8, 16, 32):
            check_equal(f"K={slots}", ag.async_gather(
                table, idx, num_slots=slots), out, quiet=True)
            t = time_ms([lambda: ag.async_gather(table, idx,
                                                 num_slots=slots)], 20)
            mlp = ag.launch_plan(table, m, num_slots=slots
                                 ).rows_in_flight_per_sm
            sweep.append(dict(case=name, num_slots=slots, ms=t,
                              gb_s=nbytes / t / 1e6,
                              rows_in_flight_per_sm=mlp))
            log(f"    K={slots:2d}: {t:.4f} ms, {nbytes / t / 1e6:.1f} "
                f"GB/s, {mlp} rows ({mlp * row_bytes / 1024:.0f} KB) in "
                "flight per SM")
        del table, idx, out
        free_cuda()

    # STREAM triad, one size, 4x past the caches
    n = 1 << 28
    b, c = randn(gen, (n,), torch.float32), randn(gen, (n,), torch.float32)
    name = f"triad f32 N={n} ({n * 4 / 2**30:.0f} GiB an array)"
    a = drive(lambda: ops.triad(b, c, 3.0))
    worst["stream_triad"] = max(worst["stream_triad"], check_close_big(
        name, a, ref.triad_ref(b, c, 3.0), **TRIAD_TOL[torch.float32]))
    check_close_big("  (library call agrees)", torch.add(b, c, alpha=3.0), a,
                    **TRIAD_TOL[torch.float32])
    nbytes = 3 * n * 4
    bound_ms, bound_by = amu_bound(nbytes, 2 * n)
    ms = time_ms([lambda: st.stream_triad(b, c, 3.0)], 20)
    plain_ms = time_ms([lambda: ref.triad_ref(b, c, 3.0)], 10)
    library_ms = time_ms([lambda: torch.add(b, c, alpha=3.0)], 20)
    report(name, "stream_triad", ms=ms, plain_ms=plain_ms,
           library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
           bytes=nbytes)
    triad_main = cases[-1]
    del a, b, c
    free_cuda()

    want = {"async_gather": 2, "async_scatter": 3, "stream_triad": 1}
    log(f"  launches on the AMU path: {counts} (want {want}: one per ops "
        "call)")
    if counts != want:
        raise AssertionError("the AMU path did not launch each kernel once "
                             "per ops call")
    log(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f}"
        " GiB (torch.cuda.max_memory_allocated)")
    log(json.dumps({"amu_cases": cases, "ring_depth_sweep": sweep}))

    sources = {"async_gather": "src/repro/kernels/async_gather.py:83",
               "async_scatter": "src/repro/kernels/async_scatter.py:123",
               "stream_triad": "src/repro/kernels/stream_triad.py:36"}
    for name, case in (("async_gather", gather_main),
                       ("async_scatter", gups),
                       ("stream_triad", triad_main)):
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": sources[name], "launches": counts[name],
            "max_abs_err": worst[name], "ms": case["ms"],
            "plain_ms": case["plain_ms"], "bound_ms": case["bound_ms"],
            "bound_by": case["bound_by"], "library_ms": case["library_ms"]})


# --------------------------------------------------------------------- main
def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after the kernels are built and checked")
    ap.add_argument("--ptxas", action="store_true",
                    help="build with -Xptxas -v and print the compiler's "
                         "report of registers, shared memory and spills")
    args = ap.parse_args()
    t_start = time.time()

    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{count} device(s)")
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 references stay fp32

    # 2. build
    from repro_torch.kernels import _build
    out_dir = _build.build_all(verbose=args.ptxas)
    log(f"built {len(list(out_dir.glob('lib*.so')))} kernel libraries in "
        f"{_build.build_seconds or 0.0:.1f} s -> {out_dir}")
    if args.ptxas:
        log("\n".join(_build.build_log))
    check_sass(out_dir)

    # 3. kernels against their plain versions
    gen = torch.Generator(device="cuda").manual_seed(0)
    kernels = [check_flash(gen), check_paged(gen)]
    fuzz_kernels(gen)
    check_offload(gen)
    amu_worst = check_amu_kernels(gen)

    # 4. the slice; 5. the AMU kernels' own path
    if not args.kernels_only:
        run_slice(kernels)
        run_amu(kernels, amu_worst)

    # 6. report
    log(f"chip_smoke: all phases passed in {time.time() - t_start:.1f} s")
    if not args.kernels_only:
        log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                            "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
