#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts and is right on the GPU.

    python3 chip_smoke.py                  # everything, needs one NVIDIA card
    python3 chip_smoke.py --kernels-only   # phases 1-3: build and check kernels
    python3 chip_smoke.py --mutants        # phase 3 must catch broken kernels

Phases, each of which fails the run (non-zero exit) on any error:

1. device: a CUDA card must be there; its name and power limit are printed.
2. build: every CUDA source of `src/repro_torch/kernels/csrc/` is compiled,
   and the machine code must hold the Hopper paths: wgmma and TMA loads in
   flash_attention, TMA loads and mma.sync in paged_attention, bulk copies
   in async_gather, stream_triad and async_scatter, and L2 reductions (RED)
   in async_scatter (cuobjdump).
3. kernels: each kernel's wrapper against its plain PyTorch version on the
   card, at the reference test shapes and at the full-width serve shapes of
   every served arch (bf16, B=4: qwen2.5-3b G=8 D=128, granite G=2 D=64,
   qwen2-vl G=6 D=128; flash at S=1000, paged at T=1032). Inputs are drawn so that the logits have a standard
   deviation of about 2: the softmax is peaked, both products matter and the
   outputs are of order 0.1 to 1. fp32 is held to atol 2e-5 / rtol 1e-4;
   bf16 to one bf16 step of the value (rtol 1e-2, atol 1e-4), to which
   flash, whose P is rounded to bf16, adds the worst that rounding can do,
   2^-8 of sum_i p_i |v_i| (taken as 5e-3 of it). Paged's cases reach its
   edges: lengths 0, 1, page - 1, page, page + 1 and T in one batch, B=1 at
   T=32768 (also with one KV head, whose last block merges ~132 partials),
   GQA groups 1, 3, 5, 7, 8, every head size in both types, and
   two calls in a row on one workspace (its tickets must be reset). Flash's
   bf16 cases reach
   both of its tensor-core bodies and the wgmma body's edges (S ragged
   against 128 and below it, windows, GQA groups 1, 7, 8); at head size 256
   (both types) windows of 1, 63, 64, 65, 127 keys and past S, S of 37, 1000
   and 4113, groups 1, 4 and 16, not causal; and recurrentgemma-9b's served
   shape (B4 Hq16 Hkv1 S4096 D256, window 2048, the library call with the
   window as a boolean mask, its kernels printed). Each serve shape is timed
   with CUDA events beside its plain version and one
   `scaled_dot_product_attention` call (a yardstick only: the port never
   calls it), and its bound is computed from the run's inputs. Then seeded
   random shapes through both kernels, and the KV offload class alone: pages
   through a small window on the side streams.
   Then the AMU kernels (async_gather, async_scatter, stream_triad) at the
   reference tests' shapes, its 10 seeded scatter fuzz cases, 8- and 12-byte
   rows and ragged lengths, the gather's two paths (bulk copies at 512-byte
   and 4 KB rows, also on a table 16 bytes in; cp.async on one 4 bytes in)
   at M = 1, 7, 131, 4000, triad at N = 1, 3, 7, 4097, 2^20 + 5: gather and
   int32 scatter bit-exact, f32 scatter-add within atol=rtol=1e-4, triad
   1e-6 (f32) / 2e-2 (bf16); and what their wrappers refuse must raise
   (among them a triad operand 4 bytes off a 16-byte boundary).
   async_scatter's own rule and edges: rows of 8, 12, 16 bytes through the
   bucket pass and rows of 512 and 4096 bytes straight to the apply (the
   path asserted by `launch_plan` and by the source), M = 1, 7, 131, 4000,
   block_m a bound, K 1-32, one row hit by every update, every update in the
   last row, N not a whole number of regions; the bucket pass bit-exact
   against `ref.scatter_bucket_ref`; two calls in a row on one workspace.
4. slice: `repro_torch.launch.serve` serves qwen2.5-3b at full width with
   `--use-kernels --offload-kv`; offloaded tokens must equal the baseline's,
   the launch counters must show the kernels carried the run, and prefill
   logits with kernels must agree with the plain path. Then the paths of
   the archs added later, each at full width on a freed card with its wall
   time and peak memory: granite-moe-1b-a400m (MoE) served the same way
   (flash once a layer, paged once a layer a step; also the dense-dispatch
   logits beside the capacity ones, printed), qwen2-vl-2b through
   `lm.prefill` with a vision prefix and 31 `lm.decode_step`s (the same
   counts), hubert-xlarge's encoder forward (not causal: no flash launch),
   rwkv6-7b served with offload (no kernel; its 128 MiB state is written
   back every step); then the five at smoke size. Last recurrentgemma-9b
   (RG-LRU and sliding-window attention, window 2048) served with kernels
   and offload at a prompt of 4096: 12 flash launches (one a local layer),
   none of paged (its decode goes through the ring cache), 11 offload
   pages, kernel logits within LOGITS_TOL of the plain path.
   Then the training path (`run_training`): (a) two `make_train_step`
   steps of qwen2.5-3b at full width and 2 layers (B1 S512) on the card and
   on the CPU from the same seeded weights and batches, fp32 compute (loss,
   grad norm and lr to 1e-5 of their value, moments to 1e-3, params to
   2 sum(lr), since the first Adam step is lr sign(g)), then bf16 compute
   (BF16_TOL; moments no farther from the fp32 ones than 3x the CPU's bf16
   moments are); (b) qwen2.5-3b and (d) granite-moe-1b-a400m trained 4
   steps at full width through `launch.train` (B2 S4096, 2 microbatches,
   remat full): finite losses and grad norms, step 0's loss within 1.0 of
   ln V, step ms, tokens/s, peak memory and the model-FLOPs share printed;
   no checkpoint at that size (~37 GB); (c) qwen2.5-3b's forward-only loss
   with `use_kernels=True` under no_grad: exactly 36 flash launches, within
   1e-2 of the plain path, and under autograd NotImplementedError; (e) the
   supervisor at smoke size on the card: a failure at step 3 of 6 with a
   checkpoint every 2 restarts once and ends within 2 sum(lr) of an
   uninterrupted run; the prefetching loader's copies equal the batches.
5. AMU kernels at H100 scale: GUPS through `repro_torch.launch.quickstart`
   (xor, an 8 GiB table of HPCC's 8-byte rows, 2^26 updates), then
   `ops.scatter_update` (xor and f32 add, 8 GiB of 512-byte rows, 2^20
   updates), `ops.gather` (the same rows; qwen2.5-3b's embedding table) and
   `ops.triad` (2^28 floats), each against its plain version, timed beside
   its bound (scatter: also its sector bound) and the library call, and
   sweeps of the scatter's ring depth K at GUPS (where it must not matter)
   and at 512-byte xor, of its `block_m` at GUPS (what is in flight an SM
   there), with GUP/s and updates in flight per SM, and of the gather's K
   (rows in flight per SM). One launch per `ops` call, counted, but four for
   the bucketed GUPS scatter.
6. simulator: the port's whole quickstart (`repro_torch.launch.quickstart`
   `main`, on the card): GUPS at 0.2, 1 and 5 us of far-memory latency,
   baseline core against the AMU session; the 4-core rack against one
   core; the GUPS xor pass through `ops.scatter_update` (one
   `async_scatter` launch, counted). Then `simulator.run` on each of the
   paper's eleven workloads, "baseline" against "amu" (batched engine) at
   1 us, and GUPS also at 5 us. Every run must be verified (the far-memory
   image equals the numpy oracle's). The speedups and MLP printed are the
   model's figures, the same on any machine; the phase's host seconds are
   the only measurement.
7. one JSON line listing the kernels, then the device line, then the verdict.

Imports `torch` and `repro_torch` only. There is no fallback to the CPU or to
a plain version anywhere: whatever fails, fails the run.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import shutil
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
# fp32 logits of a whole model, kernels vs plain path: the CPU parity tests'
# fp32 bound for a 3-layer model (atol 2e-4, rtol 1e-4), scaled by ~13 for
# the 38 layers whose sums are formed in another order
FP32_LOGITS_TOL = dict(atol=2e-3, rtol=1e-3)

ARCH = "qwen2.5-3b"
BATCH, PROMPT_LEN, MAX_NEW = 4, 1000, 32
# the served archs this slice adds, whose head layouts phase 3 also checks:
# granite D=64 GQA group 2, qwen2-vl D=128 group 6
SLICE_ARCHS = ("granite-moe-1b-a400m", "qwen2-vl-2b")
SERVE_SHAPES: list = []       # phase 3's serve-shape cases, printed as JSON
TRAIN_RESULTS: list = []      # the training phase's full-width runs

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
# (HGMMA) on tiles loaded by TMA (UTMALDG) for flash, TMA loads of K/V
# pages and mma.sync (HMMA) for paged attention, bulk copies (UBLKCP) for the
# gather's rows, triad's steps and the scatter's update spans, and the
# scatter's L2 reductions (RED, which also counts REDG).
SASS_WANT = {"flash_attention": ("HGMMA", "UTMALDG"),
             "async_gather": ("UBLKCP",),
             "async_scatter": ("UBLKCP", "RED"),
             "paged_attention": ("UTMALDG", "HMMA"),
             "stream_triad": ("UBLKCP",)}


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
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa, ref

    log("flash_attention vs ref.attention_ref")
    worst = 0.0
    for (b, hq, hkv, s, d) in [(2, 4, 2, 256, 64), (1, 8, 1, 128, 128),
                               (2, 2, 2, 512, 32), (1, 4, 1, 256, 256)]:
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
    log("  body rule: fp32 -> fma; bf16 D64/D128/D256 -> wgmma, D16/D32 -> "
        "mma (source and wrapper agree)")
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
            (1, 4, 2, 1000, 128, False, 0), (2, 16, 2, 255, 128, True, 64),
            # qwen2.5-3b's training shape (B2 S4096), which the training
            # phase's forward-only loss gives the kernel
            (2, 16, 2, 4096, 128, True, 0)]:
        q, k, v = flash_case(gen, b, hq, hkv, s, d, torch.bfloat16)
        out = fa.flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        check_close(f"bf16 B{b} Hq{hq} Hkv{hkv} S{s} D{d} causal{causal} "
                    f"window{window}", out,
                    ref.attention_ref(q, k, v, causal, window),
                    spread=flash_spread(q, k, v, causal, window),
                    **FLASH_BF16_TOL)

    worst = max(worst, check_flash_256(gen))

    # the serve shapes: full-width prefill of each served arch, S ragged
    # against 128 (qwen2.5-3b's is the one the kernels line reports), and
    # recurrentgemma-9b's windowed one at D = 256
    shapes = [flash_serve_shape(gen, arch) for arch in (ARCH,) + SLICE_ARCHS]
    rg = "recurrentgemma-9b"
    window = configs.get_config(rg).window_size
    shapes.append(flash_serve_shape(gen, rg, 2 * window, window))
    main = shapes[0]
    SERVE_SHAPES.extend(dict(kernel="flash_attention", **c) for c in shapes)
    return {"name": "flash_attention", "route": "cuda", "source": FLASH_SRC,
            "replaces": "src/repro/kernels/flash_attention.py:96",
            "launches": 0,
            "max_abs_err": max([worst] + [c["max_abs_err"] for c in shapes]),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"]}


def window_mask(s, window):
    """[S, S] boolean mask of causal attention within `window` keys, as the
    library call takes it."""
    pos = torch.arange(s, device="cuda")
    return (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)


def flash_serve_shape(gen, arch, s=PROMPT_LEN, window=0) -> dict:
    """Flash at one arch's full-width prefill (B=4, causal, bf16; S and the
    window as given): held against the plain version and the library call,
    timed beside both and its bound. With a window, the library call takes
    it as a boolean mask, and the kernels the profiler sees in that call are
    printed: they say which backend served it."""
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa, ref
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    cfg = configs.get_config(arch)
    b, hq, hkv, d = (BATCH, cfg.num_heads, cfg.num_kv_heads,
                     cfg.resolved_head_dim)
    shape = (f"{arch} B{b} Hq{hq} Hkv{hkv} S{s} D{d}"
             + (f" window{window}" if window else ""))
    q, k, v = flash_case(gen, b, hq, hkv, s, d, torch.bfloat16)
    out = fa.flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    err = check_close(f"bf16 {shape}", out,
                      ref.attention_ref(q, k, v, True, window),
                      spread=flash_spread(q, k, v, True, window),
                      **FLASH_BF16_TOL)
    lib = (dict(attn_mask=window_mask(s, window)) if window
           else dict(is_causal=True))

    def library():
        return F.scaled_dot_product_attention(q, k, v, enable_gqa=True, **lib)

    check_close("  (library call agrees)", library(), out, **LIBRARY_TOL)
    ms = time_ms([lambda: fa.flash_attention(q, k, v, window=window)], 20)
    plain_ms = time_ms([lambda: ref.attention_ref(q, k, v, True, window)], 5)
    library_ms = time_ms([library], 10)
    bound_ms, bound_by = flash_bound(b, hq, hkv, s, d, window, torch.bfloat16)
    host = host_us(lambda: fa.flash_attention(q, k, v, window=window))
    log(f"  serve shape ({fa.body_for(q.dtype, d)} body): kernel {ms:.4f} ms "
        f"(host {host:.1f} us a call), plain {plain_ms:.4f} ms, library "
        f"{library_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by})")
    case = dict(shape=shape, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                host_us=host)
    if window:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            library()
            torch.cuda.synchronize()
        case["library_kernels"] = sorted(
            {e.key for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA})
        log("  the library call ran: "
            + ", ".join(n[:70] for n in case["library_kernels"]))
    return case


def check_flash_256(gen) -> float:
    """The D = 256 bodies (wgmma with 64 x 64 tiles and one consumer
    warpgroup in bf16, FMAs in fp32) at their edges: windows of 1, 63, 64,
    65 and 127 keys (below, at and past the 64-key tile, one short of two
    tiles) and past S, S ragged against 64 (1000, 4113) and below one tile,
    GQA groups 1 and 16 (recurrentgemma's MQA: 16 query heads on one KV
    head), not causal with and without a window. Returns the worst fp32
    error."""
    from repro_torch.kernels import flash_attention as fa, ref

    log("flash_attention at head size 256 vs ref.attention_ref")
    worst = 0.0
    cases = [  # (b, hq, hkv, s, causal, window)
        (1, 16, 1, 1000, True, 1), (1, 16, 1, 1000, True, 63),
        (1, 16, 1, 1000, True, 64), (1, 16, 1, 1000, True, 65),
        (1, 16, 1, 1000, True, 127), (2, 16, 1, 1000, True, 4096),
        (1, 4, 4, 1000, True, 0), (1, 16, 1, 4113, True, 2048),
        (2, 2, 1, 37, True, 0), (1, 16, 1, 333, False, 0),
        (1, 4, 4, 300, False, 63), (1, 16, 1, 129, False, 65)]
    for dtype in (torch.bfloat16, torch.float32):
        for (b, hq, hkv, s, causal, window) in cases:
            q, k, v = flash_case(gen, b, hq, hkv, s, 256, dtype)
            out = fa.flash_attention(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            want = ref.attention_ref(q, k, v, causal, window)
            name = (f"{str(dtype)[6:]} B{b} Hq{hq} Hkv{hkv} S{s} D256 "
                    f"causal{causal} window{window}")
            if dtype == torch.float32:
                worst = max(worst, check_close(name, out, want, **FP32_TOL))
            else:
                check_close(name, out, want,
                            spread=flash_spread(q, k, v, causal, window),
                            **FLASH_BF16_TOL)
            del q, k, v, out, want
    return worst


def paged_bound(lengths, hq, hkv, d, dtype):
    item = torch.empty((), dtype=dtype).element_size()
    rows, b = int(lengths.sum()), lengths.numel()
    nbytes = 2 * rows * hkv * d * item + 2 * b * hq * d * item + 4 * b
    flops = 4.0 * rows * hq * d
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def paged_case(gen, b, hq, hkv, t, d, dtype):
    return (randn(gen, (b, hq, d), dtype, Q_SCALE),
            randn(gen, (b, t, hkv, d), dtype), randn(gen, (b, t, hkv, d), dtype))


def check_paged_edges(gen) -> float:
    """The redesigned kernel's edges, each against the plain version at the
    same limits: lengths at the aload's and the page's boundaries (0, 1,
    page - 1, page, page + 1, T) in one batch, one long sequence that the
    ring streams (also with one KV head, whose last block merges a partial
    of every block), every GQA group of the model zoo and 1, every head size
    in both types, and two calls in a row on one workspace, whose tickets
    the first call's last blocks must have reset. Returns the worst fp32
    error."""
    from repro_torch.kernels import paged_attention as pa, ref

    log("paged_attention edges (lengths, long T, GQA groups, head sizes, "
        "workspace reuse)")
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        tol = FP32_TOL if dtype == torch.float32 else PAGED_BF16_TOL
        for page in (16, 32, 64):
            t = 4 * page + 3
            lens = torch.tensor([0, 1, page - 1, page, page + 1, t],
                                dtype=torch.int32, device="cuda")
            q, kc, vc = paged_case(gen, 6, 16, 2, t, 128, dtype)
            err = check_close(
                f"{str(dtype)[6:]} page{page} T{t} lengths {lens.tolist()}",
                pa.paged_attention(q, kc, vc, lens, page=page),
                ref.paged_attention_ref(q, kc, vc, lens), **tol)
            if dtype == torch.float32:
                worst = max(worst, err)
        for g in (1, 3, 5, 7, 8):
            for d in (16, 32, 64, 128):
                q, kc, vc = paged_case(gen, 2, 2 * g, 2, 333, d, dtype)
                lens = torch.tensor([333, 77], dtype=torch.int32,
                                    device="cuda")
                err = check_close(
                    f"{str(dtype)[6:]} G{g} D{d}",
                    pa.paged_attention(q, kc, vc, lens),
                    ref.paged_attention_ref(q, kc, vc, lens), quiet=True,
                    **tol)
                if dtype == torch.float32:
                    worst = max(worst, err)
    log("  GQA groups 1, 3, 5, 7, 8 x head sizes 16-128 x both types agree")
    # one long sequence: the ring streams, and with one KV head (hg = 1)
    # every block holds a piece of one segment, so its last block merges
    # ~132 partials (the merge's batches past 64 of a warp)
    lens = torch.tensor([32768], dtype=torch.int32, device="cuda")
    for hq, hkv, dtype in ((16, 2, torch.bfloat16), (8, 1, torch.float32),
                           (8, 1, torch.bfloat16)):
        q, kc, vc = paged_case(gen, 1, hq, hkv, 32768, 128, dtype)
        plan, (slots, _) = pa.launch_plan(q, kc), pa.ring(q, kc)
        err = check_close(
            f"{str(dtype)[6:]} B1 Hq{hq} Hkv{hkv} T32768 ({plan.blocks} "
            f"blocks, {slots} slots of {plan.rows} rows)",
            pa.paged_attention(q, kc, vc, lens),
            ref.paged_attention_ref(q, kc, vc, lens),
            **(FP32_TOL if dtype == torch.float32 else PAGED_BF16_TOL))
        if dtype == torch.float32:
            worst = max(worst, err)
        del q, kc, vc
    # two calls in a row on one workspace, outputs kept apart: a ticket left
    # standing by the first would keep the second from writing its output
    cases = [paged_case(gen, 4, 16, 2, 1032, 128, torch.float32)
             for _ in range(2)]
    lens = torch.tensor([1032, 1001, 517, 64], dtype=torch.int32,
                        device="cuda")
    outs = [pa.paged_attention(*c, lens) for c in cases]
    for i, (c, out) in enumerate(zip(cases, outs)):
        worst = max(worst, check_close(
            f"fp32 call {i + 1} of 2 on one workspace", out,
            ref.paged_attention_ref(*c, lens), **FP32_TOL))
    return worst


def check_paged(gen):
    from repro_torch.kernels import paged_attention as pa, ref

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
    worst = max(worst, check_paged_edges(gen))

    # the serve shapes: full-width decode of each served arch, T ragged,
    # mixed lengths (qwen2.5-3b's is the one the kernels line reports)
    shapes = [paged_serve_shape(gen, arch) for arch in (ARCH,) + SLICE_ARCHS]
    main = shapes[0]
    SERVE_SHAPES.extend(dict(kernel="paged_attention", **c) for c in shapes)
    return {"name": "paged_attention", "route": "cuda", "source": PAGED_SRC,
            "replaces": "src/repro/kernels/paged_attention.py:79",
            "launches": 0,
            "max_abs_err": max([worst] + [c["max_abs_err"] for c in shapes]),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"]}


def paged_serve_shape(gen, arch) -> dict:
    """Paged at one arch's full-width decode (B=4, T=1032, lengths [1032,
    1001, 517, 64], bf16) over 16 rotating caches, so that a call finds its
    cache cold as a decode step does: held against the plain version and
    the library call, timed beside both and its bound."""
    from repro_torch import configs
    from repro_torch.kernels import paged_attention as pa, ref
    import torch.nn.functional as F

    cfg = configs.get_config(arch)
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
    err = check_close(f"bf16 {arch} serve shape B{b} Hq{hq} Hkv{hkv} T{t} "
                      f"D{d} lengths {lens.tolist()}", out,
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
    host = host_us(lambda: pa.paged_attention(q, kc, vc, lens))
    plan, (slots, _) = pa.launch_plan(q, kc), pa.ring(q, kc)
    log(f"  serve shape ({plan.blocks} blocks, {slots} slots of "
        f"{plan.rows} rows): kernel {ms:.4f} ms (host {host:.1f} us a call), "
        f"plain {plain_ms:.4f} ms, library {library_ms:.4f} ms, bound "
        f"{bound_ms:.5f} ms ({bound_by})")
    return dict(shape=f"{arch} B{b} Hq{hq} Hkv{hkv} T{t} D{d}",
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                host_us=host)


def fuzz_kernels(gen, cases=40):
    """Seeded random shapes through both kernels: any S and T, odd GQA
    groups, windows shorter and longer than a tile, causal or not, ragged
    lengths, every head size (flash up to 256, paged up to 128) and both
    types."""
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
        d = rnd.choice([16, 32, 64, 128, 256])
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
        d = min(d, 128)                 # paged's head sizes end at 128
        qd = randn(gen, (b, hkv * g, d), dtype, Q_SCALE)
        kc = randn(gen, (b, t, hkv, d), dtype)
        vc = randn(gen, (b, t, hkv, d), dtype)
        lens = torch.tensor([rnd.randint(0, t) for _ in range(b)],
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
    from repro_torch.kernels import paged_attention as pa
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
    worst = max(worst, check_scatter_paths(gen))

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
    for n in (1, 3, 7, 4097, (1 << 20) + 5):     # bulk steps and the tail
        for dtype in (torch.float32, torch.bfloat16):
            b, c = randn(gen, (n,), dtype), randn(gen, (n,), dtype)
            triad_worst = max(triad_worst, check_close(
                f"{str(dtype)[6:]} N{n}", st.stream_triad(b, c, 3.0),
                ref.triad_ref(b, c, 3.0), quiet=True, **TRIAD_TOL[dtype]))
    log("  N = 1, 3, 7, 4097, 2^20 + 5 agree in both types")
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
        ("stream_triad, b 4 bytes off a 16-byte boundary", ValueError,
         lambda: st.stream_triad(zeros(1025)[1:], zeros(1024), 1.0)),
        ("paged_attention, a cache row 4 bytes off 16 bytes", ValueError,
         lambda: pa.paged_attention(zeros(1, 2, 16), zeros(1, 8, 2, 17)[..., 1:],
                                    zeros(1, 8, 2, 16),
                                    torch.ones(1, dtype=torch.int32,
                                               device="cuda"))),
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


def check_scatter_paths(gen) -> float:
    """async_scatter's plan rule and edges: rows of 8, 12 and 16 bytes take
    the bucket pass, rows of 512 and 4096 bytes go straight to the apply
    (asserted by `launch_plan` and by the source's own rule), each at M = 1,
    7, 131 and 4000 in every op and type, block_m a bound and K from 1 to
    32; a table whose rows are not a whole number of bucket regions, one row
    hit by every update, every update in the last row; the bucket pass
    against its plain version bit for bit (one tile, many tiles, tiles of
    several sub-chunks); the apply's shared memory as Python plans it and as
    the source sizes it; two calls in a row, each on the workspace the other
    left. Returns the worst f32 error."""
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import async_scatter as asc

    lib = _build.load("async_scatter")
    asc._bind()
    log("async_scatter paths: bucketed below 32-byte rows, straight to the "
        "apply above; i32 bit-exact, f32 add within 1e-4")
    worst = 0.0

    def run(table, idx, upd, op, want_bucket, quiet=True, **kw):
        nonlocal worst
        r = table.shape[1] * 4
        plan = asc.launch_plan(table, idx.numel(), op, **kw)
        what = (f"{str(table.dtype)[6:]} {op} rows of {r} B, N{table.shape[0]}"
                f" M{idx.numel()}{f' {kw}' if kw else ''}: "
                f"{'bucket pass + ' if plan.bucket else ''}apply of "
                f"{plan.blocks} blocks, {plan.slots} slots of {plan.span} "
                f"updates, {plan.chunk}-byte reductions")
        if plan.bucket != want_bucket or bool(
                lib.async_scatter_bucketed(r)) != want_bucket:
            raise AssertionError(f"{what}: want "
                                 f"{'the bucket pass' if want_bucket else 'no bucket pass'}")
        if lib.async_scatter_apply_smem(plan.span, plan.slots, r) \
                != plan.smem:
            raise AssertionError(f"{what}: Python plans {plan.smem} bytes "
                                 "of shared memory, the source sizes "
                                 f"{lib.async_scatter_apply_smem(plan.span, plan.slots, r)}")
        want = ref.scatter_update_ref(table, idx, upd, op)
        got = asc.async_scatter(table.clone(), idx, upd, op, **kw)
        if table.dtype == torch.float32:
            worst = max(worst, check_close(what, got, want, quiet=quiet,
                                           **SCATTER_TOL))
        else:
            check_equal(what, got, want, quiet=quiet)

    cases = [(8, torch.int32, "xor"), (8, torch.float32, "add"),
             (12, torch.int32, "add"), (12, torch.int32, "xor"),
             (16, torch.float32, "add"), (16, torch.int32, "xor"),
             (512, torch.int32, "xor"), (512, torch.float32, "add"),
             (512, torch.int32, "add"), (4096, torch.float32, "add"),
             (4096, torch.int32, "xor")]
    for r, dtype, op in cases:
        n = 5003 if r < 512 else 1000      # 5003 rows: 626 regions of 8
        table = amu_table(gen, (n, r // 4), dtype)
        for m in (1, 7, 131, 4000):
            idx = amu_index(gen, n, m)
            upd = amu_table(gen, (m, r // 4), dtype)
            run(table, idx, upd, op, r < 32, quiet=m != 4000)
            for bm, k in ((1, 1), (16, 3), (64, 32)):
                if asc.apply_smem(4, k, r) > asc.MAX_SMEM:
                    continue               # refused: checked in the tests
                run(table, idx, upd, op, r < 32, block_m=bm, num_slots=k)
        m = 4000
        upd = amu_table(gen, (m, r // 4), dtype)
        if dtype == torch.float32:
            # 4000 terms a row: order alone moves a sum of N(0, 1) terms by
            # ~1e-4 of its size; updates of N(0, 1/64^2) keep it in atol
            upd = upd / 64
        for row, what in ((17, "one row hit by every update"),
                          (n - 1, "every update in the last row")):
            idx = torch.full((m,), row, dtype=torch.int32, device="cuda")
            run(table, idx, upd, op, r < 32, quiet=False)
            log(f"    ({what})")
    log("  rows of 8-4096 B x M 1-4000 x block_m and K agree")

    log("scatter bucket pass vs ref.scatter_bucket_ref: bit-exact")
    for n, m, r in ((5003, 4000, 8), (5003, 300_001, 12), (1 << 20,
                    (1 << 23) + 5, 8), (1 << 30, 1 << 16, 8), (77, 333, 16)):
        idx = amu_index(gen, n, m)
        upd = amu_table(gen, (m, r // 4), torch.int32)
        shift, buckets, sub, tile, tiles = asc.bucket_layout(
            n, m, r, torch.cuda.get_device_properties(0).multi_processor_count)
        got = asc.scatter_bucket(idx, upd, n)
        want = ref.scatter_bucket_ref(idx, upd, shift, buckets)
        what = (f"N{n} M{m} rows of {r} B: {buckets} regions of 2^{shift} "
                f"rows, {tiles} tiles of {tile // sub} sub-chunks of {sub}")
        for name, g, w in zip(("indices", "updates", "offsets"), got, want):
            check_equal(f"{what}, {name}", g, w, quiet=name != "offsets")

    log("async_scatter: two calls in a row, each on the workspace the "
        "other left")
    for r, dtype, op in ((8, torch.int32, "xor"), (512, torch.float32,
                                                   "add")):
        n, m = (1 << 20, 1 << 20)
        pairs = [(amu_table(gen, (n, r // 4), dtype), amu_index(gen, n, m),
                  amu_table(gen, (m, r // 4), dtype)) for _ in range(2)]
        outs = [asc.async_scatter(t.clone(), i, u, op) for t, i, u in pairs]
        for k, ((t, i, u), out) in enumerate(zip(pairs, outs)):
            want = ref.scatter_update_ref(t, i, u, op)
            name = f"{str(dtype)[6:]} {op} rows of {r} B, call {k + 1} of 2"
            if dtype == torch.float32:
                worst = max(worst, check_close(name, out, want,
                                               **SCATTER_TOL))
            else:
                check_equal(name, out, want)
        del pairs, outs
    return worst


# ------------------------------------------------------------------ phase 4
def check_served(arch, res, vocab, prompt_len=PROMPT_LEN):
    """What `launch.serve` with offload must give: B x MAX_NEW tokens in the
    vocabulary, the same with and without offload. Prints them and the
    run's times."""
    tokens = res["tokens"]
    check_tokens(arch, tokens, vocab, (BATCH, MAX_NEW))
    if not res["tokens_identical"] or not torch.equal(
            tokens, res["tokens_offload"]):
        raise AssertionError(f"{arch}: offloaded decode diverged from the "
                             "baseline")
    log(f"  offloaded tokens identical to baseline: True | row 0: "
        f"{tokens[0, :12].tolist()}")
    log(f"  prefill {res['prefill_ms']:.2f} ms for {BATCH}x{prompt_len} "
        f"tokens | decode {res['decode_tok_s']:.2f} tok/s "
        f"({res['decode_ms']:.2f} ms for {MAX_NEW - 1} steps) | decode with "
        f"offload {res['offload_tok_s']:.2f} tok/s "
        f"({res['offload_ms']:.2f} ms)")


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

    check_served(ARCH, res, cfg.vocab_size)

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


def drive_path(name, fn):
    """One path of phase 4 on a freed card: the attention kernels' launch
    counters are set to 0 just before `fn` and read just after; prints the
    path's wall time and peak device memory. Returns (fn's result, flash
    launches, paged launches)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa

    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fa.launches = pa.launches = 0
    out = fn()
    torch.cuda.synchronize()
    n_flash, n_paged = fa.launches, pa.launches
    log(f"  {name}: wall {time.perf_counter() - t0:.2f} s, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB "
        f"(torch.cuda.max_memory_allocated); launches flash {n_flash}, "
        f"paged {n_paged}")
    return out, n_flash, n_paged


def want_launches(arch, n_flash, n_paged, flash, paged):
    if (n_flash, n_paged) != (flash, paged):
        raise AssertionError(
            f"{arch}: launches flash {n_flash}, paged {n_paged}; the path "
            f"should have launched flash {flash} and paged {paged} times")


def check_tokens(arch, tokens, vocab, shape):
    if tuple(tokens.shape) != shape:
        raise AssertionError(f"{arch}: tokens have shape "
                             f"{tuple(tokens.shape)}, want {shape}")
    if int(tokens.min()) < 0 or int(tokens.max()) >= vocab:
        raise AssertionError(f"{arch}: generated tokens outside the "
                             "vocabulary")


def check_logits(arch, logits, vocab):
    if tuple(logits.shape) != (BATCH, 1, vocab):
        raise AssertionError(f"{arch}: logits have shape "
                             f"{tuple(logits.shape)}")
    if not torch.isfinite(logits.float()).all():
        raise AssertionError(f"{arch}: non-finite logits")


def run_new_paths(kernels):
    """The archs this slice adds, at full width on the card: granite (MoE)
    and rwkv6 through `launch.serve`, qwen2-vl (vision prefix, M-RoPE)
    through `lm.prefill` and `lm.decode_step` (serve is token-only, as the
    reference's is), hubert's encoder forward; then all five at smoke size.
    Each path's launches are added to the kernels line's."""
    from repro_torch import configs
    from repro_torch.launch.serve import serve
    from repro_torch.models import lm

    total = [0, 0]

    def count(n_flash, n_paged):
        total[0] += n_flash
        total[1] += n_paged

    steps = MAX_NEW - 1

    # granite-moe-1b-a400m: 32 experts top-8, head size 64, GQA group 2
    arch = "granite-moe-1b-a400m"
    cfg = configs.get_config(arch)
    log(f"path: serve {arch} at full width: {cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads, head_dim "
        f"{cfg.resolved_head_dim}, {cfg.moe.num_experts} experts top-"
        f"{cfg.moe.top_k} of d_ff {cfg.moe.d_ff_expert}, vocab "
        f"{cfg.vocab_size}; batch {BATCH}, prompt {PROMPT_LEN}, max_new "
        f"{MAX_NEW}, moe_mode capacity")
    res, n_flash, n_paged = drive_path(arch, lambda: serve(
        arch, batch=BATCH, prompt_len=PROMPT_LEN, max_new=MAX_NEW,
        use_kernels=True, offload_kv=True, device="cuda", seed=0))
    L = cfg.num_layers
    want_launches(arch, n_flash, n_paged, L, 2 * L * steps)
    count(n_flash, n_paged)
    check_served(arch, res, cfg.vocab_size)
    check_logits(arch, res["prefill_logits"], cfg.vocab_size)
    cache = lm.init_cache(cfg, BATCH, PROMPT_LEN + MAX_NEW, device="cuda")
    plain, _ = lm.prefill(cfg, res["params"], {"tokens": res["prompts"]},
                          cache, use_kernels=False)
    check_close(f"{arch} prefill last-token logits, kernels vs plain path "
                "(bf16)", res["prefill_logits"], plain, **LOGITS_TOL)
    # the dense dispatch drops no pair, the capacity one may: a print only
    cache = lm.init_cache(cfg, BATCH, PROMPT_LEN + MAX_NEW, device="cuda")
    dense, _ = lm.prefill(cfg, res["params"], {"tokens": res["prompts"]},
                          cache, use_kernels=True, moe_mode="dense")
    diff = (dense.float() - res["prefill_logits"].float()).abs()
    agree = float((dense.argmax(-1) == res["prefill_logits"].argmax(-1))
                  .float().mean())
    log(f"  moe_mode dense vs capacity prefill logits: max abs difference "
        f"{float(diff.max()):.4f}, mean {float(diff.mean()):.4f}; greedy "
        f"first token agrees on {agree:.0%} of the batch (not a check: the "
        "modes drop different pairs)")
    log(f"  offload: {res['offload_pages']} pages, window "
        f"{res['offload_window']}, stats {res['offload_stats']}")
    del res, cache, plain, dense

    # qwen2-vl-2b: a 256-patch vision prefix and M-RoPE, D=128, group 6
    arch = "qwen2-vl-2b"
    cfg = configs.get_config(arch)
    fe = cfg.frontend
    log(f"path: {arch} at full width through lm.prefill + {steps} greedy "
        f"lm.decode_step: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.num_heads}/{cfg.num_kv_heads} heads, head_dim "
        f"{cfg.resolved_head_dim}, M-RoPE sections {cfg.mrope_sections}; "
        f"batch {BATCH}, prompt {PROMPT_LEN} of which {fe.prefix_len} vision "
        f"positions from vision_embeds [{BATCH}, {fe.prefix_len}, "
        f"{fe.feature_dim}]")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = lm.cast_params_for_compute(lm.init_model(cfg, gen,
                                                      device="cuda"))
    inputs = {"tokens": torch.randint(0, cfg.vocab_size, (BATCH, PROMPT_LEN),
                                      generator=gen, device="cuda"),
              "vision_embeds": torch.randn(
                  (BATCH, fe.prefix_len, fe.feature_dim), generator=gen,
                  device="cuda")}

    def vl_path():
        cache = lm.init_cache(cfg, BATCH, PROMPT_LEN + MAX_NEW, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = lm.prefill(cfg, params, inputs, cache,
                                   use_kernels=True)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        tok = torch.argmax(logits[:, -1], -1)[:, None]
        out = [tok]
        for _ in range(steps):
            lg, cache = lm.decode_step(cfg, params, tok, cache,
                                       use_kernels=True)
            tok = torch.argmax(lg[:, -1], -1)[:, None]
            out.append(tok)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        return logits, torch.cat(out, 1), (t1 - t0) * 1e3, t2 - t1

    (logits, tokens, prefill_ms, t_dec), n_flash, n_paged = drive_path(
        arch, vl_path)
    L = cfg.num_layers
    want_launches(arch, n_flash, n_paged, L, L * steps)
    count(n_flash, n_paged)
    check_logits(arch, logits, cfg.vocab_size)
    check_tokens(arch, tokens, cfg.vocab_size, (BATCH, MAX_NEW))
    cache = lm.init_cache(cfg, BATCH, PROMPT_LEN + MAX_NEW, device="cuda")
    plain, _ = lm.prefill(cfg, params, inputs, cache, use_kernels=False)
    check_close(f"{arch} prefill last-token logits, kernels vs plain path "
                "(bf16)", logits, plain, **LOGITS_TOL)
    log(f"  prefill {prefill_ms:.2f} ms for {BATCH}x{PROMPT_LEN} tokens | "
        f"decode {BATCH * steps / t_dec:.2f} tok/s ({t_dec * 1e3:.2f} ms for "
        f"{steps} steps) | row 0: {tokens[0, :12].tolist()}")
    del params, inputs, logits, tokens, cache, plain

    # hubert-xlarge: audio frames through a bidirectional encoder, head size
    # 80; not causal, so the reference's rule keeps flash off its path
    arch = "hubert-xlarge"
    cfg = configs.get_config(arch)
    log(f"path: {arch} encoder forward at full width through lm.prefill("
        f"cache=None, use_kernels=True): {cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.num_heads} heads, head_dim "
        f"{cfg.resolved_head_dim}; features [{BATCH}, {PROMPT_LEN}, "
        f"{cfg.frontend.feature_dim}]")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = lm.cast_params_for_compute(lm.init_model(cfg, gen,
                                                      device="cuda"))
    feats = {"features": torch.randn((BATCH, PROMPT_LEN,
                                      cfg.frontend.feature_dim),
                                     generator=gen, device="cuda")}

    def encode():
        times = []
        for _ in range(2):              # a first call, then a warm one
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = lm.prefill(cfg, params, feats, None,
                                       use_kernels=True)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return logits, cache, times

    (logits, cache, times), n_flash, n_paged = drive_path(arch, encode)
    want_launches(arch, n_flash, n_paged, 0, 0)
    check_logits(arch, logits, cfg.vocab_size)
    if cache is not None:
        raise AssertionError(f"{arch}: an encoder forward returned a cache")
    log(f"  encoder forward {BATCH}x{PROMPT_LEN} frames: first call "
        f"{times[0]:.2f} ms, second {times[1]:.2f} ms; logits finite")
    del params, feats, logits

    # rwkv6-7b: attention-free, its state rewritten whole on every step
    arch = "rwkv6-7b"
    cfg = configs.get_config(arch)
    log(f"path: serve {arch} at full width: {cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.num_heads} heads of {cfg.resolved_head_dim}, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}; batch {BATCH}, prompt "
        f"{PROMPT_LEN}, max_new {MAX_NEW}, use_kernels (no kernel on this "
        "path), offload")
    res, n_flash, n_paged = drive_path(arch, lambda: serve(
        arch, batch=BATCH, prompt_len=PROMPT_LEN, max_new=MAX_NEW,
        use_kernels=True, offload_kv=True, device="cuda", seed=0))
    want_launches(arch, n_flash, n_paged, 0, 0)
    check_served(arch, res, cfg.vocab_size)
    check_logits(arch, res["prefill_logits"], cfg.vocab_size)
    s_leaf = res["cache"]["scan"][0]["s"]
    log(f"  offload: {res['offload_pages']} pages (the state leaf s "
        f"{list(s_leaf.shape)} fp32, "
        f"{s_leaf.numel() * s_leaf.element_size() / 2**20:.0f} MiB, written "
        f"back every step), window {res['offload_window']}, stats "
        f"{res['offload_stats']}")
    del res, s_leaf

    # the new archs at smoke size on the card, kernels and offload on
    free_cuda()
    for arch in ("granite-moe-1b-a400m", "kimi-k2-1t-a32b", "rwkv6-7b",
                 "recurrentgemma-9b"):
        small = serve(arch, smoke=True, batch=2, prompt_len=130, max_new=4,
                      use_kernels=True, offload_kv=True, device="cuda")
        if not small["tokens_identical"] or not torch.isfinite(
                small["prefill_logits"].float()).all():
            raise AssertionError(f"{arch} at smoke size failed")
    for arch in ("qwen2-vl-2b", "hubert-xlarge"):
        cfg = configs.get_smoke_config(arch)
        gen = torch.Generator(device="cuda").manual_seed(0)
        params = lm.init_model(cfg, gen, device="cuda")
        fe = cfg.frontend
        if fe.kind == "audio":
            inputs = {"features": torch.randn((2, 130, fe.feature_dim),
                                              generator=gen, device="cuda")}
            cache = None
        else:
            inputs = {"tokens": torch.randint(0, cfg.vocab_size, (2, 130),
                                              generator=gen, device="cuda"),
                      "vision_embeds": torch.randn(
                          (2, fe.prefix_len, fe.feature_dim), generator=gen,
                          device="cuda")}
            cache = lm.init_cache(cfg, 2, 134, device="cuda")
        logits, cache = lm.prefill(cfg, params, inputs, cache,
                                   use_kernels=True)
        for _ in range(3 if cache is not None else 0):
            tok = torch.argmax(logits[:, -1], -1)[:, None]
            logits, cache = lm.decode_step(cfg, params, tok, cache,
                                           use_kernels=True)
        if not torch.isfinite(logits.float()).all():
            raise AssertionError(f"{arch} at smoke size failed")
    log("  granite, kimi, qwen2-vl, hubert, rwkv6, recurrentgemma at smoke "
        "size on the card: finite logits, offloaded tokens identical where "
        "served")
    kernels[0]["launches"] += total[0]
    kernels[1]["launches"] += total[1]
    log(f"  launches of this slice's paths: flash_attention {total[0]}, "
        f"paged_attention {total[1]}")


def run_recurrentgemma(kernels):
    """recurrentgemma-9b (RG-LRU, RG-LRU, sliding-window attention; 38 = 12 x
    3 + 2 layers) served at full width with kernels and offload. The prompt
    is twice the window, so the window binds in flash, the prefill's ring
    fill wraps and every decode step overwrites the oldest slot. Its 12
    local layers each launch flash once in the prefill; decode goes through
    the ring cache, never through paged (the reference takes paged only
    without a window). The cache flattens to 11 offload pages."""
    from repro_torch import configs, convert
    from repro_torch.launch.serve import serve
    from repro_torch.models import lm

    arch = "recurrentgemma-9b"
    cfg = configs.get_config(arch)
    prompt_len = 2 * cfg.window_size
    n_local = cfg.num_layers // len(cfg.block_pattern)
    log(f"path: serve {arch} at full width: {cfg.num_layers} layers of "
        f"{cfg.block_pattern} (+ {cfg.num_layers % len(cfg.block_pattern)} "
        f"tail), d_model {cfg.d_model}, rnn_width {cfg.rnn_width}, "
        f"{cfg.num_heads}/{cfg.num_kv_heads} heads, head_dim "
        f"{cfg.resolved_head_dim}, window {cfg.window_size}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size}; batch {BATCH}, prompt "
        f"{prompt_len}, max_new {MAX_NEW}, use_kernels, offload")
    res, n_flash, n_paged = drive_path(arch, lambda: serve(
        arch, batch=BATCH, prompt_len=prompt_len, max_new=MAX_NEW,
        use_kernels=True, offload_kv=True, device="cuda", seed=0))
    want_launches(arch, n_flash, n_paged, n_local, 0)
    kernels[0]["launches"] += n_flash
    check_served(arch, res, cfg.vocab_size, prompt_len)
    check_logits(arch, res["prefill_logits"], cfg.vocab_size)
    leaves = convert.flatten(res["cache"])[0]
    if len(leaves) != 11 or res["offload_pages"] != 11:
        raise AssertionError(f"{arch}: {res['offload_pages']} offload pages, "
                             "want 11 (len, then 2 x RG-LRU {conv, h} and "
                             "the window's {k, v} of the period, then 2 x "
                             "RG-LRU {conv, h} of the tail)")
    sizes = [t.numel() * t.element_size() for t in leaves]
    log(f"  offload: {res['offload_pages']} pages of "
        f"{[list(t.shape) for t in leaves]} ({sum(sizes) / 2**20:.1f} MiB in "
        f"all, the largest {max(sizes) / 2**20:.1f} MiB), window "
        f"{res['offload_window']}, stats {res['offload_stats']}")
    # the same weights and prompts through the plain attention path; its
    # local layers hold [B, 16, S, S] fp32 logits (4 GiB), which fit now
    # that `serve` has let go of the fp32 weights
    cache = lm.init_cache(cfg, BATCH, prompt_len + MAX_NEW, device="cuda")
    plain, _ = lm.prefill(cfg, res["params"], {"tokens": res["prompts"]},
                          cache, use_kernels=False)
    check_close(f"{arch} prefill last-token logits, kernels vs plain path "
                "(bf16)", res["prefill_logits"], plain, **LOGITS_TOL)
    agree = float((plain.argmax(-1) == res["prefill_logits"].argmax(-1))
                  .float().mean())
    log(f"  greedy first token agrees on {agree:.0%} of the batch")
    del cache, leaves
    # the same weights widened to fp32, through both paths (the kernel path
    # on flash's fp32 body at D = 256): they must agree to fp32 rounding,
    # and each bf16 path's distance from the fp32 result says where the
    # bf16 difference above comes from
    w32 = convert.tree_map(lambda t: t.float(), res["params"])
    f32 = {}
    for use_kernels in (True, False):
        cache = lm.init_cache(cfg, BATCH, prompt_len + MAX_NEW, device="cuda")
        f32[use_kernels], _ = lm.prefill(
            cfg, w32, {"tokens": res["prompts"]}, cache,
            use_kernels=use_kernels, dtype=torch.float32)
        del cache
    check_close(f"{arch} prefill last-token logits in fp32, kernels vs plain "
                "path", f32[True], f32[False], **FP32_LOGITS_TOL)
    for name, got in (("kernels", res["prefill_logits"]), ("plain", plain)):
        diff = (got.float() - f32[False]).abs()
        log(f"  bf16 {name} path against the fp32 plain path: max abs "
            f"{float(diff.max()):.4f}, mean {float(diff.mean()):.5f}")
    del res, plain, w32, f32


# ---------------------------------------------------------------- training
# (a) the card against the CPU in fp32: sums in another order over two
# full-width layers and a 151936-way softmax. Loss and grad norm to 1e-5 of
# their value; a moment to 1e-3 of itself plus 1e-4 of its leaf's largest
# (an element whose gradient cancels to near zero moves by its neighbours'
# rounding); params to TRAIN_STEP_SIZE * 2 * sum(lr): the first Adam step
# is lr * sign(g), which two right sums may take opposite ways where |g| is
# at its rounding, and so may the second, whose |m^ / sqrt(v^)| is at most
# sqrt(sum_i a_i^2 / c_i) = 1.0004 over the moments' weights (a_i for m, c_i
# for v; Cauchy-Schwarz): a weight that flips at both steps parts by up to
# 2 (lr_0 + 1.0004 lr_1) (the bf16 case takes 0.985 of 2 sum(lr) on an
# H100: flips at both steps happen)
TRAIN_FP32_TOL = dict(atol=0.0, rtol=1e-5)
TRAIN_STEP_SIZE = 1.001
# ... and since every other weight takes nearly the same steps on both
# sides, at most TRAIN_FLIP_SHARE of the weights may part by more than
# TRAIN_STEP_PART * sum(lr): half the lr, no bias correction (0.45 of the
# first step) or another eps moves every weight that has a gradient by more
TRAIN_STEP_PART = 0.25
TRAIN_FLIP_SHARE = 0.05
# bf16 compute rounds at other places on the two devices: loss and grad
# norm at the CPU tests' BF16_TOL; a moment leaf of the card's bf16 run no
# farther (L2) from the CPU's fp32 run than TRAIN_BF16_FACTOR times the
# CPU's own bf16 run is (as tests/test_torch_train.py holds bf16 gradients
# against the reference's); params as above
TRAIN_BF16_TOL = dict(atol=3e-2, rtol=3e-2)
TRAIN_BF16_FACTOR = 3.0
# the full-width runs: qwen2.5-3b (the serve slice's model) and granite,
# through `launch.train` at the reference's TRAIN_4K sequence length
TRAIN_ARCHS = ("qwen2.5-3b", "granite-moe-1b-a400m")
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO = 4, 2, 4096, 2
# forward-only loss through the flash kernel against the plain path, both
# bf16: a mean over 8192 positions of a 36-layer model. The loss hardly
# sees attention (the final norm fixes the logits' scale), so each layer's
# flash output is also held against ref.attention_ref on that layer's own
# q, k, v at FLASH_BF16_TOL
TRAIN_KERNEL_LOSS_ATOL = 1e-2


def model_flops_per_token(cfg, seq: int) -> int:
    """Training FLOPs a token needs, recomputation not counted: 6 for each
    parameter that multiplies it (MoE: the active ones; an embedding only as
    a tied head), plus causal attention's two products over seq / 2 keys on
    average, forward and backward: 6 * L_attn * Hq * Dh * seq."""
    from repro_torch import configs

    n = cfg.active_param_count()
    if not cfg.tie_embeddings and (cfg.frontend is None
                                   or cfg.frontend.kind == "vision"):
        n -= cfg.vocab_size * cfg.d_model       # a lookup, not a product
    n_attn = sum(k in (configs.BLOCK_FULL, configs.BLOCK_LOCAL)
                 for k in cfg.layer_kinds)
    return 6 * n + 6 * n_attn * cfg.num_heads * cfg.resolved_head_dim * seq


def check_steps(name, got, want, lr_sum, size=1.0) -> str:
    """Params after the same Adam steps from the same start, with
    gradients computed on each side: no weight parts by more than
    2 * sum(lr) * size, and at most TRAIN_FLIP_SHARE of them by more than
    TRAIN_STEP_PART * sum(lr). Returns what it saw, for the log."""
    worst, beyond, total = 0.0, 0, 0
    for a, b in zip(got, want):
        d = (a.float() - b.float()).abs()
        worst = max(worst, float(d.max()))
        beyond += int((d > TRAIN_STEP_PART * lr_sum).sum())
        total += d.numel()
    share = beyond / total
    seen = (f"params max abs {worst:.3e} (limit 2 * sum(lr) * {size} = "
            f"{2 * lr_sum * size:.4e}), {share:.4%} of {total:,} weights "
            f"beyond {TRAIN_STEP_PART} * sum(lr) (limit "
            f"{TRAIN_FLIP_SHARE:.0%})")
    if worst > 2 * lr_sum * size or share > TRAIN_FLIP_SHARE:
        raise AssertionError(f"{name}: {seen}")
    return seen


def _train_two_steps(cfg, params, batch, dtype, device):
    """Two `make_train_step` steps (remat "selective", the default) on
    `device` from copies of `params`; returns (metrics per step as floats,
    params, state) on the CPU."""
    from repro_torch import configs, convert
    from repro_torch.optim import adamw
    from repro_torch.runtime import steps

    p = convert.tree_map(lambda t: t.to(device, copy=True), params)
    state = adamw.init_state(p)
    step_fn = steps.make_train_step(cfg, configs.ParallelConfig(),
                                    adamw.AdamWConfig(), dtype=dtype)
    rows = []
    for b in batch:
        p, state, m = step_fn(p, state, {k: v.to(device)
                                         for k, v in b.items()})
        rows.append({k: float(v) for k, v in m.items()})
    cpu = lambda t: t.cpu()                                   # noqa: E731
    return rows, convert.tree_map(cpu, p), convert.tree_map(cpu, state)


def check_train_card_vs_cpu():
    """(a) qwen2.5-3b at full width and 2 layers, B1 S512: two train steps
    on the card and on the CPU from the same seeded weights and batches, in
    fp32 compute (TF32 off) and in bf16 compute."""
    import dataclasses

    from repro_torch import configs, convert
    from repro_torch.data.pipeline import batch_to, synthetic_batch
    from repro_torch.models import lm

    cfg = dataclasses.replace(configs.get_config("qwen2.5-3b"), num_layers=2)
    shape = configs.ShapeConfig("card_vs_cpu", 512, 1, configs.KIND_TRAIN)
    params = lm.init_model(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    batch = [batch_to(synthetic_batch(cfg, shape, s), "cpu") for s in (0, 1)]
    log(f"training (a): {cfg.name} at full width, {cfg.num_layers} layers, "
        f"B1 S512, two make_train_step steps on the card and on the CPU "
        f"({torch.get_num_threads()} threads), same weights and batches")
    exact = None                     # the CPU's fp32 moments
    for dtype in (torch.float32, torch.bfloat16):
        free_cuda()
        t0 = time.perf_counter()
        rows, p, st = _train_two_steps(cfg, params, batch, dtype, "cuda")
        t_card = time.perf_counter() - t0
        t0 = time.perf_counter()
        crows, cp, cst = _train_two_steps(cfg, params, batch, dtype, "cpu")
        t_cpu = time.perf_counter() - t0
        name = str(dtype).replace("torch.", "")
        log(f"  {name}: card {t_card:.1f} s, CPU {t_cpu:.1f} s; loss "
            f"{[r['loss'] for r in rows]} vs {[r['loss'] for r in crows]}, "
            f"grad norm {[r['grad_norm'] for r in rows]} vs "
            f"{[r['grad_norm'] for r in crows]}")
        tol = TRAIN_FP32_TOL if dtype == torch.float32 else TRAIN_BF16_TOL
        for i, (r, c) in enumerate(zip(rows, crows)):
            for key in ("loss", "grad_norm", "lr"):
                check_close(f"{name} step {i} {key}, card vs CPU",
                            torch.tensor(r[key]), torch.tensor(c[key]),
                            **tol)
        lr_sum = sum(r["lr"] for r in crows)
        worst = 0.0
        for part in ("m", "v"):
            leaves = zip(convert.flatten(st[part])[0],
                         convert.flatten(cst[part])[0],
                         convert.flatten(exact[part])[0] if exact
                         else [None] * len(convert.flatten(st[part])[0]))
            for a, b, e in leaves:
                if dtype == torch.float32:
                    top = float(b.abs().max())
                    check_close(f"fp32 {part}", a, b, atol=1e-4 * top,
                                rtol=1e-3, quiet=True)
                    continue
                ratio = float((a - e).norm()
                              / (b - e).norm().clamp_min(1e-30))
                worst = max(worst, ratio)
                if ratio > TRAIN_BF16_FACTOR:
                    raise AssertionError(
                        f"bf16 {part}: the card's run is {ratio:.2f} times "
                        "as far from the fp32 moments as the CPU's, limit "
                        f"{TRAIN_BF16_FACTOR}")
        seen = check_steps(f"{name} params, card vs CPU",
                           convert.flatten(p)[0], convert.flatten(cp)[0],
                           lr_sum, TRAIN_STEP_SIZE)
        log(f"  {name}: moments "
            + ("within 1e-3 of themselves + 1e-4 of the leaf's largest"
               if dtype == torch.float32 else
               f"at most {worst:.3f} times as far from the fp32 ones as the "
               f"CPU's bf16 (limit {TRAIN_BF16_FACTOR})")
            + f"; {seen}")
        if exact is None:
            exact = cst
        del p, st, cp


def run_train_full(arch):
    """(b) / (d) `launch.train` at full width on a freed card. Returns the
    train result (its state holds the params and optimizer state)."""
    from repro_torch import configs
    from repro_torch.launch.train import train

    cfg = configs.get_config(arch)
    log(f"training: {arch} at full width through launch.train: "
        f"{cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.num_heads}/{cfg.num_kv_heads} heads, vocab {cfg.vocab_size}, "
        f"{cfg.param_count() / 1e9:.3f} B parameters "
        f"({cfg.active_param_count() / 1e9:.3f} B active); steps "
        f"{TRAIN_STEPS}, batch {TRAIN_BATCH}, seq {TRAIN_SEQ}, microbatches "
        f"{TRAIN_MICRO}, remat full, bf16 compute, fp32 masters and AdamW "
        "state. No checkpoint is written: params, m and v would take "
        f"{cfg.param_count() * 12 / 1e9:.1f} GB of disk and host memory")
    res, n_flash, _ = drive_path(f"{arch} training", lambda: train(
        arch, steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
        microbatches=TRAIN_MICRO, checkpoint_every=1000,
        checkpoint_dir=os.path.join(ROOT, "build", "train_ckpt"),
        device="cuda", on_step=lambda r: log(
            f"  step {r['step']}: loss {r['loss']:.4f}, grad norm "
            f"{r['grad_norm']:.4f}, lr {r['lr']:.3e}, {r['ms']:.1f} ms")))
    peak = torch.cuda.max_memory_allocated() / 2**30
    if n_flash:
        raise AssertionError("training launched the flash kernel")
    hist = res["history"]
    if len(hist) != TRAIN_STEPS or not all(
            math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
            for r in hist):
        raise AssertionError(f"{arch}: a loss or grad norm is not finite, "
                             "or a step is missing")
    ln_v = math.log(cfg.vocab_size)
    if abs(hist[0]["loss"] - ln_v) > 1.0:
        raise AssertionError(f"{arch}: step 0 loss {hist[0]['loss']:.4f} is "
                             f"not within 1.0 of ln V = {ln_v:.4f}")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    steady = [r["ms"] for r in hist[1:]]
    step_ms = sum(steady) / len(steady)
    flops = model_flops_per_token(cfg, TRAIN_SEQ) * tokens
    share = flops / (step_ms / 1e3) / PEAK_FLOPS[torch.bfloat16]
    log(f"  {arch}: wall {res['wall_s']:.2f} s for {TRAIN_STEPS} steps, "
        f"{res['tok_s']:,.0f} tok/s over the run; steps 1-{TRAIN_STEPS - 1} "
        f"{step_ms:.1f} ms each = {tokens / step_ms * 1e3:,.0f} tok/s; peak "
        f"{peak:.3f} GiB (torch.cuda.max_memory_allocated); step 0 loss "
        f"{hist[0]['loss']:.4f} (ln V = {ln_v:.4f})")
    log(f"  {arch}: model FLOPs {flops / 1e12:.1f} T a step ((6 N + 6 L H "
        f"Dh S) a token, N = {model_flops_per_token(cfg, 0) / 6e9:.3f} B "
        f"multiplying parameters), {share:.1%} of the H100 SXM's 989 "
        f"TFLOP/s bf16 dense on {torch.cuda.get_device_name(0)}")
    TRAIN_RESULTS.append({
        "arch": arch, "step_ms": [r["ms"] for r in hist],
        "loss": [r["loss"] for r in hist],
        "grad_norm": [r["grad_norm"] for r in hist],
        "tok_s": tokens / step_ms * 1e3, "peak_gib": peak,
        "model_flops_share": share, "wall_s": res["wall_s"]})
    return res


def check_train_kernels_forward(params, kernels):
    """(c) qwen2.5-3b's trained params and step 0's batch, forward only:
    `train_loss(use_kernels=True)` under no_grad launches flash once a
    layer, each launch's output agrees with ref.attention_ref on that
    layer's q, k, v, and the loss with the plain path's; with autograd it
    raises."""
    from repro_torch import configs, convert
    from repro_torch.data.pipeline import batch_to, synthetic_batch
    from repro_torch.kernels import flash_attention as fa, ops, ref
    from repro_torch.models import lm

    arch = "qwen2.5-3b"
    cfg = configs.get_config(arch)
    shape = configs.ShapeConfig("t", TRAIN_SEQ, TRAIN_BATCH,
                                configs.KIND_TRAIN)
    batch = batch_to(synthetic_batch(cfg, shape, 0), "cuda")

    def forward():
        with torch.no_grad():
            return lm.train_loss(cfg, params, batch, use_kernels=True)[0]

    # keep each launch's inputs and output (ops hands its [B, S, H, D]
    # tensors to the wrapper as [B, H, S, D] views)
    calls, wrapper = [], ops._flash

    def kept(q, k, v, causal=True, window=0, **kw):
        out = wrapper(q, k, v, causal=causal, window=window, **kw)
        calls.append((q, k, v, causal, window, out))
        return out

    ops._flash = kept
    try:
        got, n_flash, n_paged = drive_path(
            f"{arch} forward-only loss with kernels", forward)
    finally:
        ops._flash = wrapper
    want_launches(arch, n_flash, n_paged, cfg.num_layers, 0)
    kernels[0]["launches"] += n_flash
    want_shape = (TRAIN_BATCH, cfg.num_heads, TRAIN_SEQ,
                  cfg.resolved_head_dim)
    worst, share = 0.0, 0.0          # share: of the limit, at most
    tol = FLASH_BF16_TOL
    for i, (q, k, v, causal, window, out) in enumerate(calls):
        if tuple(q.shape) != want_shape or q.dtype != torch.bfloat16:
            raise AssertionError(f"layer {i}: flash got q "
                                 f"{tuple(q.shape)} {q.dtype}")
        want = ref.attention_ref(q, k, v, causal, window)
        spread = flash_spread(q, k, v, causal, window)
        worst = max(worst, check_close(
            f"layer {i} flash output on its own q, k, v", out, want,
            spread=spread, quiet=True, **tol))
        share = max(share, float(((out.float() - want.float()).abs() / (
            tol["atol"] + tol["rtol"] * want.float().abs()
            + tol["ptol"] * spread)).max()))
    log(f"  flash's output in each of the {len(calls)} layers (bf16 "
        f"B{want_shape[0]} Hq{want_shape[1]} Hkv{cfg.num_kv_heads} "
        f"S{want_shape[2]} D{want_shape[3]}, causal, the layer's own q, k, "
        f"v) vs ref.attention_ref: max abs err {worst:.3e}, at most "
        f"{share:.2f} of FLASH_BF16_TOL's limit with its spread term "
        f"({fa.body_for(torch.bfloat16, want_shape[3])} body)")
    del calls, q, k, v, out, want, spread
    with torch.no_grad():
        plain = lm.train_loss(cfg, params, batch, use_kernels=False)[0]
    diff = abs(float(got) - float(plain))
    log(f"  loss with kernels {float(got):.6f}, plain path "
        f"{float(plain):.6f}: |diff| {diff:.2e} (limit "
        f"{TRAIN_KERNEL_LOSS_ATOL:g}); flash launches {n_flash}")
    if not diff <= TRAIN_KERNEL_LOSS_ATOL:
        raise AssertionError("forward-only loss: kernels and plain path "
                             "disagree")
    alias = convert.tree_map(lambda t: t.detach().requires_grad_(True),
                             params)
    try:
        loss, _ = lm.train_loss(cfg, alias, batch, use_kernels=True)
        torch.autograd.grad(loss, convert.flatten(alias)[0])
    except NotImplementedError as exc:
        log(f"  under autograd: NotImplementedError ({str(exc)[:60]}...)")
    else:
        raise AssertionError("the flash path under autograd did not raise")
    del alias


def check_train_supervisor():
    """(e) the supervisor on the card at smoke size: a failure at step 3 of
    6 with a checkpoint every 2 restores step 2 and ends within tolerance
    of an uninterrupted run (the embedding's backward adds by atomics on
    the card, so not bit for bit); the prefetching loader's copies to the
    card equal the batches."""
    from repro_torch import configs, convert
    from repro_torch.checkpoint.store import CheckpointStore
    from repro_torch.data.pipeline import (PrefetchingLoader, batch_to,
                                           synthetic_batch)
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    from repro_torch.runtime import steps
    from repro_torch.runtime.ft import TrainSupervisor

    cfg = configs.get_smoke_config("qwen2.5-3b")
    shape = configs.ShapeConfig("t", 64, 2, configs.KIND_TRAIN)
    opt_cfg = adamw.AdamWConfig(total_steps=6)
    step_fn = steps.make_train_step(cfg, configs.ParallelConfig(remat="full"),
                                    opt_cfg)
    runs = {}
    for name, fail_at in (("clean", None), ("failed", 3)):
        directory = os.path.join(ROOT, "build", "train_ckpt", name)
        if os.path.exists(directory):
            shutil.rmtree(directory)
        gen = torch.Generator(device="cuda").manual_seed(0)
        params = lm.init_model(cfg, gen, device="cuda")
        sup = TrainSupervisor(CheckpointStore(directory), checkpoint_every=2)
        state = sup.run({"params": params, "opt_state": adamw.init_state(
            params), "step": 0}, step_fn, lambda s: batch_to(
                synthetic_batch(cfg, shape, s), "cuda"), 6, fail_at=fail_at)
        runs[name] = (state, sup.restarts)
    (clean, r0), (failed, r1) = runs["clean"], runs["failed"]
    if (r0, r1) != (0, 1) or failed["step"] != 6:
        raise AssertionError(f"supervisor: restarts {r0}, {r1}; step "
                             f"{failed['step']}")
    lr_sum = sum(float(adamw.schedule(opt_cfg, torch.tensor(
        s, dtype=torch.int32))) for s in range(6))
    got = convert.flatten(failed["params"])[0]
    want = convert.flatten(clean["params"])[0]
    seen = check_steps("supervisor: the resumed run against the "
                       "uninterrupted one", got, want, lr_sum)
    same = all(torch.equal(a, b) for a, b in zip(got, want))
    log(f"  supervisor on the card ({cfg.name}, B2 S64): restarts 1, "
        f"resumed from step 2; final params vs uninterrupted run: {seen}, "
        f"bit-equal: {same}; final loss "
        f"{float(failed['metrics']['loss']):.6f} vs "
        f"{float(clean['metrics']['loss']):.6f}")
    loader = PrefetchingLoader(cfg, shape, device="cuda", start_step=2)
    try:
        for want_step, (step, b) in zip(range(2, 5), loader):
            want = synthetic_batch(cfg, shape, step)
            if step != want_step or any(
                    v.device.type != "cuda" or not torch.equal(
                        v.cpu(), torch.from_numpy(want[k]))
                    for k, v in b.items()):
                raise AssertionError("PrefetchingLoader on the card: a batch "
                                     "differs from synthetic_batch")
    finally:
        loader.close()
    log("  PrefetchingLoader on the card: steps 2-4 equal synthetic_batch")


def run_training(kernels):
    """The training path: (a) card vs CPU at reduced depth, (b) qwen2.5-3b
    and (d) granite at full width through launch.train, (c) the
    forward-only flash loss, (e) the supervisor's restart on the card."""
    check_train_card_vs_cpu()
    res = run_train_full(TRAIN_ARCHS[0])
    params = res["state"]["params"]
    del res
    free_cuda()
    check_train_kernels_forward(params, kernels)
    del params
    run_train_full(TRAIN_ARCHS[1])
    free_cuda()
    check_train_supervisor()
    log(json.dumps({"training": TRAIN_RESULTS}))


# ------------------------------------------------------------------ phase 5
def amu_bound(nbytes, ops=0.0):
    """Bytes over the memory rate against 32-bit operations over the fp32
    rate (the guide's table has no int32 rate; add and xor are far below
    either way)."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_FLOPS[torch.float32]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def scatter_bytes(idx, row_bytes):
    """(bytes, sector bytes) an in-place scatter of these indices must move.
    bytes: each touched row read and written once, each index and update row
    read once. sector bytes: the same, but the table moves in the 32-byte
    sectors of the L2 (read and written back), so a row narrower than a
    sector costs the whole sector, and rows that share one share it (the
    table starts on a sector boundary)."""
    rows = torch.unique(idx).long()
    stream = idx.numel() * (4 + row_bytes)
    first = rows * row_bytes
    offs = sorted(set(range(0, row_bytes, 32)) | {row_bytes - 1})
    if row_bytes % 32 == 0:
        sectors = rows.numel() * (row_bytes // 32)
    else:
        sectors = torch.unique(torch.cat([(first + o) // 32
                                          for o in offs])).numel()
    return 2 * rows.numel() * row_bytes + stream, 64 * sectors + stream


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
    cases, sweep = [], []

    def sweep_scatter(name, table, idx, upd, op, out, knob, values):
        """The paper's "queue length follows demand": the scatter's
        `num_slots` K (the ring depth of a persistent block at 512-byte
        rows; one slot a block on the bucketed stream, where it must not
        matter) or its `block_m` (the updates a block of the bucketed stream
        takes, which set what is in flight an SM), each value held against
        the plain version, timed on `out`."""
        log(f"  {knob} sweep of {name}:")
        expect = ref.scatter_update_ref(table, idx, upd, op)
        for value in values:
            kw = {knob: value}
            check_equal(f"{knob}={value}", asc.async_scatter(
                table.clone(), idx, upd, op, **kw), expect, quiet=True)
            t = time_ms([lambda: asc.async_scatter(out, idx, upd, op, **kw)],
                        10)
            plan = asc.launch_plan(out, idx.numel(), op, **kw)
            mlp = plan.updates_in_flight_per_sm
            sweep.append(dict(case=name, **kw, ms=t,
                              giga_updates_s=idx.numel() / t / 1e6,
                              updates_in_flight_per_sm=mlp))
            log(f"    {knob}={value:3d}: {t:.4f} ms, "
                f"{idx.numel() / t / 1e6:.2f} GUP/s, {plan.slots} slots of "
                f"{plan.span} updates, {plan.blocks} blocks, {mlp} updates "
                "in flight per SM")
        del expect

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
    res_table = res["table"]
    del res
    free_cuda()
    touched = torch.unique(idx).numel()
    nbytes, sector_bytes = scatter_bytes(idx, width * 4)
    bound_ms, bound_by = amu_bound(nbytes, m * width)
    ms = time_ms([lambda: asc.async_scatter(out, idx, upd, "xor",
                                            num_slots=k)], 10)
    plain_ms = time_ms([lambda: ref.scatter_update_ref(out, idx, upd, "xor")],
                       1, repeats=2)
    plan = asc.launch_plan(out, m, "xor", num_slots=k)
    report(f"GUPS xor [{rows},{width}] int32, {m} updates", "async_scatter",
           ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=bound_ms,
           bound_by=bound_by, bytes=nbytes, touched_rows=touched,
           sector_bound_ms=amu_bound(sector_bytes)[0],
           giga_updates_s=m / ms / 1e6,
           host_us=host_us(lambda: asc.async_scatter(out, idx, upd, "xor",
                                                     num_slots=k)))
    log(f"    {m / ms / 1e6:.3f} GUP/s, host {cases[-1]['host_us']:.1f} us a "
        f"call; {plan.launches} launches ({plan.buckets} regions of 2^"
        f"{plan.shift} rows, then {plan.blocks} apply blocks, spans of "
        f"{plan.span}); sector bound {cases[-1]['sector_bound_ms']:.5f} ms")
    gups = cases[-1]
    sweep_scatter("GUPS", res_table, idx, upd, "xor", out, "num_slots",
                  (1, 2, 4, 8, 16, 32))
    sweep_scatter("GUPS", res_table, idx, upd, "xor", out, "block_m",
                  (8, 16, 32, 64))
    del idx, upd, out, res_table
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
        nbytes, sector_bytes = scatter_bytes(idx, width * 4)
        bound_ms, bound_by = amu_bound(nbytes, m * width)
        ms = time_ms([lambda: asc.async_scatter(out, idx, upd, op)], 20)
        plain_ms = time_ms([lambda: ref.scatter_update_ref(table, idx, upd,
                                                           op)], 2, repeats=3)
        library_ms = None
        if op == "add":
            library_ms = time_ms([lambda: want.index_add_(0, idx, upd)], 20)
        report(name, "async_scatter", ms=ms, plain_ms=plain_ms,
               library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
               bytes=nbytes, touched_rows=touched,
               sector_bound_ms=amu_bound(sector_bytes)[0],
               host_us=host_us(lambda: asc.async_scatter(out, idx, upd, op)))
        log(f"    sector bound {cases[-1]['sector_bound_ms']:.5f} ms; host "
            f"{cases[-1]['host_us']:.1f} us a call")
        if op == "xor":
            sweep_scatter(name, table, idx, upd, op, out, "num_slots",
                          (1, 2, 4, 8, 16, 32))
        del table, idx, upd, out, want
        free_cuda()

    # gather: 512-byte rows of an 8 GiB table, then the embedding lookup
    cfg = configs.get_config(ARCH)
    gathers = [((1 << 24, 128), torch.float32, 1 << 20, "random rows"),
               ((cfg.vocab_size, cfg.d_model), torch.bfloat16,
                BATCH * PROMPT_LEN, f"{ARCH} embedding, {BATCH}x{PROMPT_LEN} "
                "token ids")]
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
           bytes=nbytes, host_us=host_us(lambda: st.stream_triad(b, c, 3.0)),
           library_host_us=host_us(lambda: torch.add(b, c, alpha=3.0)))
    log(f"    host {cases[-1]['host_us']:.1f} us a call (torch.add "
        f"{cases[-1]['library_host_us']:.1f} us)")
    triad_main = cases[-1]
    del a, b, c
    free_cuda()

    # one launch per ops call, but async_scatter's GUPS (8-byte rows) runs
    # the bucket pass's three kernels before its apply: 4 + 1 + 1
    want = {"async_gather": 2, "async_scatter": 6, "stream_triad": 1}
    log(f"  launches on the AMU path: {counts} (want {want}: one per ops "
        "call, four for the bucketed GUPS scatter)")
    if counts != want:
        raise AssertionError("the AMU path did not launch each kernel as "
                             "often as its ops calls need")
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


# ------------------------------------------------------------------ phase 6
def run_simulator():
    """The port's own copy of the AMU simulator, driven as a user would: the
    whole quickstart, then `simulator.run` at the paper's conditions. The
    simulator is a host-side numpy model (as the reference's is): its
    figures are modelled, and only the host seconds are measured here."""
    from repro_torch.amu import REGISTRY
    from repro_torch.core import simulator as sim
    from repro_torch.kernels import async_scatter as asc
    from repro_torch.launch import quickstart

    log("simulator: the port's quickstart, whole (figures modelled: the "
        "simulator's us at 3 GHz and MLP)")
    t0 = time.perf_counter()
    asc.launches = 0
    rc = quickstart.main([])
    torch.cuda.synchronize()
    quick_s = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"quickstart exited {rc}: an unverified run or "
                             "a kernel mismatch")
    if asc.launches != 1:
        raise AssertionError(f"the quickstart's kernel part launched "
                             f"async_scatter {asc.launches} times, want 1")
    log(f"  quickstart: exit 0, 1 async_scatter launch, {quick_s:.3f} s of "
        "host time")

    # the paper's headline conditions: its eleven workloads (the serving
    # workload, request-level, stays out of throughput sweeps by its
    # registry entry) at 1 us, GUPS also at 5 us
    cases = [(n, 1.0) for n in REGISTRY.names()
             if not REGISTRY[n].request_level] + [("GUPS", 5.0)]
    t0 = time.perf_counter()
    runs = []
    for name, lat in cases:
        base = sim.run(name, "baseline", lat)
        amu = sim.run(name, "amu", lat, engine="batched")
        if amu["verified"] is not True:
            raise AssertionError(f"simulator: {name} at {lat} us is not "
                                 "verified")
        runs.append(dict(workload=name, latency_us=lat,
                         baseline_us=base["us"], amu_us=amu["us"],
                         speedup=base["us"] / amu["us"], mlp=amu["mlp"],
                         requests=amu["requests"], verified=True))
        log(f"  {name:6s} at {lat:.1f} us: baseline {base['us']:10.1f} us, "
            f"AMU {amu['us']:9.1f} us, speedup {runs[-1]['speedup']:6.2f}x, "
            f"MLP {amu['mlp']:6.1f} (modelled)")
    sweep_s = time.perf_counter() - t0
    at_1us = [r["speedup"] for r in runs if r["latency_us"] == 1.0]
    mean = sum(at_1us) / len(at_1us)
    geo = math.exp(sum(math.log(x) for x in at_1us) / len(at_1us))
    log(f"  {len(at_1us)} workloads at 1 us: mean speedup {mean:.2f}x, "
        f"geometric mean {geo:.2f}x (modelled); {len(runs)} runs verified "
        f"in {sweep_s:.3f} s of host time")
    log(json.dumps({"simulator": {
        "quickstart_host_s": quick_s, "sweep_host_s": sweep_s,
        "mean_speedup_1us": mean, "geomean_speedup_1us": geo,
        "runs": runs}}))


# ------------------------------------------------------------------ mutants
# Broken copies of the redesigned kernels that phase 3 must catch, each one
# edit of a source of src/repro_torch/kernels/csrc/: (file, text, its
# replacement). The text must be in the file exactly once, so that a mutant
# always breaks the kernel as it stands.
PAGED_GETFIN = ("    mbar_wait(&full[j % a.slots], (uint32_t)((j / a.slots) & 1));"
                "  // getfin\n")
TRIAD_GETFIN = ("    mbar_wait(&full[t % stages], (uint32_t)((t / stages) & 1));"
                "  // getfin\n")
TRIAD_STORE = ("      bulk_store(a + c0 * VEC, dst, (uint32_t)nc * 16);"
               "   // astore\n      bulk_commit();\n")
SCATTER_GETFIN = ("    mbar_wait(&full[s], (uint32_t)((t / K) & 1));"
                  "  // getfin\n")
SCATTER_REFILL = ("      if (t >= K)                      // every consumer "
                  "warp has left slot s\n        mbar_wait(&empty[s], "
                  "(uint32_t)((t / K - 1) & 1));\n")
MUTANTS = {
    # flash's wgmma body misses the window's straddling tile by one key: a
    # tile whose first key is the last row's first one outside the window
    # is not masked (caught at D = 256 by window 127, and not causal by 63)
    "flash_window_edge": [("flash_attention.cu",
                           "(window > 0 && k0 <= rlo + 63 - window)",
                           "(window > 0 && k0 < rlo + 63 - window)")],
    # the scatter's consumers reduce from a slot without waiting for it
    "scatter_getfin": [("async_scatter.cu", SCATTER_GETFIN, "")],
    # the producer refills a slot before the consumers have left it
    "scatter_refill": [("async_scatter.cu", SCATTER_REFILL, "")],
    # the first bucket's size one short: every later bucket starts one
    # early, so one update is written over and one place never written
    "scatter_bucket": [("async_scatter.cu",
                        "  if (threadIdx.x == 0) totals[blockIdx.x] = carry;",
                        "  if (threadIdx.x == 0) totals[blockIdx.x] = "
                        "carry - (blockIdx.x == 0);")],
    # the consumers read a slot without waiting for its loads
    "paged_getfin": [("paged_attention.cu", PAGED_GETFIN, "")],
    # the last block of a segment leaves its ticket standing
    "paged_ticket": [("paged_attention.cu",
                      "      if (last) atomicExch(&a.tickets[cur], 0);",
                      "")],
    # the merge leaves out the last partial of its second set
    "paged_merge": [("paged_attention.cu",
                     "    const int np_all = set == 0 ? half : count - half;",
                     "    const int np_all = set == 0 ? half : "
                     "count - half - 1;")],
    # the threads compute from a slot without waiting for its loads
    "triad_getfin": [("stream_triad.cu", TRIAD_GETFIN, "")],
    # a slot's bulk store is issued before the threads have computed it
    "triad_store": [("stream_triad.cu", TRIAD_STORE, ""),
                    ("stream_triad.cu", TRIAD_GETFIN,
                     TRIAD_GETFIN + "    if (elected) {\n" + TRIAD_STORE
                     + "    }\n")],
}


def run_mutants(timeout_s: int = 300) -> bool:
    """Builds each mutant in a copy of src/ and this script under
    build/mutants/ and runs `--kernels-only` there, killed after
    `timeout_s`. Prints each copy's exit code and first failing check; true
    if every copy failed or hung."""
    import shutil

    caught = True
    for name, edits in MUTANTS.items():
        dst = os.path.join(ROOT, "build", "mutants", name)
        shutil.rmtree(dst, ignore_errors=True)
        shutil.copytree(os.path.join(ROOT, "src"), os.path.join(dst, "src"),
                        ignore=shutil.ignore_patterns("__pycache__"))
        shutil.copy(os.path.abspath(__file__), dst)
        for source, old, new in edits:
            path = os.path.join(dst, "src", "repro_torch", "kernels", "csrc",
                                source)
            with open(path) as f:
                text = f.read()
            if text.count(old) != 1:
                raise AssertionError(f"mutant {name}: its text is not in "
                                     f"{source} exactly once")
            with open(path, "w") as f:
                f.write(text.replace(old, new))
        proc = subprocess.run(
            ["timeout", "-s", "KILL", str(timeout_s), sys.executable,
             os.path.join(dst, "chip_smoke.py"), "--kernels-only"],
            capture_output=True, text=True)
        why = [line.strip() for line in proc.stdout.splitlines()
               if line.endswith("FAIL")] \
            or proc.stderr.strip().splitlines()[-1:] or ["no output"]
        log(f"mutant {name}: exit {proc.returncode} "
            f"({'caught' if proc.returncode else 'NOT CAUGHT'}): {why[0]}")
        caught = caught and proc.returncode != 0
    return caught


# --------------------------------------------------------------------- main
def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after the kernels are built and checked")
    ap.add_argument("--ptxas", action="store_true",
                    help="build with -Xptxas -v and print the compiler's "
                         "report of registers, shared memory and spills")
    ap.add_argument("--mutants", action="store_true",
                    help="only build the broken kernels of MUTANTS and "
                         "check that phase 3 fails on each")
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
    if args.mutants:
        caught = run_mutants()
        log(card)
        return 0 if caught else 1

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

    # 4. the slice and the later paths, then training; 5. the AMU kernels'
    # own path; 6. the simulator and the whole quickstart
    log(json.dumps({"serve_shapes": SERVE_SHAPES}))
    if not args.kernels_only:
        run_slice(kernels)
        run_new_paths(kernels)
        run_recurrentgemma(kernels)
        run_training(kernels)
        run_amu(kernels, amu_worst)
        run_simulator()

    # 7. report
    log(f"chip_smoke: all phases passed in {time.time() - t_start:.1f} s")
    if not args.kernels_only:
        log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                            "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
