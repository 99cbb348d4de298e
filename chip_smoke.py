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
   in async_scatter (cuobjdump); wgmma and TMA loads in the kernel symbol of
   the 16-bit flash body above 256 columns, TMA loads in paged's above 256,
   mma.sync, TMA loads and ldmatrix in paged's tensor-core body over the
   whole head (16-bit, 256 < D <= 512), compare-and-swaps in the scatter's
   8-bit integer and fp8 adds.
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
   window as a boolean mask, its kernels printed). Every head size from 1
   to 256 (a launch runs the body for Dp, the next of 16-256 up, columns
   past D zero-loaded, never stored, scaled by 1/sqrt(D)): the body rules
   of both sources against their wrappers at every D 0-257 in both types,
   flash at D 1, 7, 8, 24, 40, 80, 96, 100, 192 and paged at D 1, 7, 8,
   24, 40, 80, 100, 256 against the plain versions, and the guard columns
   (each kernel's raw launch into rows 8 columns past Dp, filled with a
   sentinel that must survive); hubert-xlarge's D = 80 attention (not
   causal) on flash and recurrentgemma-9b's D = 256 head layout on paged
   are timed as serve shapes. Every input the TPU kernels take: the body
   rules at D 0-1100 and 2048 in float32, bfloat16 and float16 and (flash)
   the six mixed pairs; both kernels at D 257, 264, 300, 384, 512, 576,
   1000, 1024, 2048 in the three types (the wide bodies: a chunk of 256
   output columns a block), float16 at D 8, 64, 80, 128, 256, bf16 q with
   f32 k, v and f16 q with bf16 k, v, and the guard columns at D 300, 512,
   1000 in the three types; float16 is held at FLASH_F16_TOL and
   PAGED_F16_TOL, tighter than bf16's. Paged's tensor-core body over the
   whole head (`check_wide_mma`: bf16 / f16 at 256 < D <= 512, one chunk) at
   D 264-512 in four layouts, its guard columns, and its time at D 512;
   the scatter's batched compare-and-swaps (`check_cas_batches`: int8,
   uint8, e4m3, e5m2 add at rows of 64, 6, 3 and 1 elements, uniform, a
   quarter hot and all in one row, narrow rows down both paths). Each serve shape is timed
   with CUDA events beside its plain version and one
   `scaled_dot_product_attention` call (a yardstick only: the port never
   calls it), and its bound is computed from the run's inputs. Then seeded
   random shapes through both kernels, and the KV offload class alone: pages
   through a small window on the side streams.
   Then the AMU kernels (async_gather, async_scatter, stream_triad) at the
   reference tests' shapes, its 10 seeded scatter fuzz cases, 8- and 12-byte
   rows and ragged lengths, the gather's three paths (bulk copies at
   512-byte and 4 KB rows, also on a table 16 bytes in; cp.async on one 4
   bytes in; copies by element at rows of 6, 3, 1 and 4094 bytes and on a
   bf16 table 2 bytes in) at M = 1, 7, 131, 4000, triad at N = 1, 3, 7,
   4097, 2^20 + 5 in f32, bf16 and f16: gather and integer scatter
   bit-exact (uint32 add and xor too), f32 scatter-add within
   atol=rtol=1e-4, bf16 and f16 add within `ref.scatter_add16_limit`, triad
   1e-6 (f32) / 2e-2 (bf16) / 2e-3 (f16); and what their wrappers refuse
   must raise (among them a triad operand 4 bytes off a 16-byte boundary).
   async_scatter's own rule and edges: rows of 8, 12, 16, 512 and 4096
   bytes (the path, bucketed or not, asserted by `launch_plan` and by the
   source, also at the rule's edges; 2^25 updates into 1.5 GiB tables of
   3- and 6-byte rows), M = 1, 7, 131, 4000, block_m a bound, K 1-32, one
   row hit by every update, every update in the last row, N not a whole
   number of regions, each case of rows below 32 bytes down both paths
   (the rule's, and `async_scatter.launch` on the other plan); the bucket
   pass bit-exact against `ref.scatter_bucket_ref`; two calls in a row on
   one workspace.
   Then the inputs taken last (`check_every_type`): float8 conversions at
   the edge of the range (e4m3fn 500 -> NaN, 464 -> 448; e5m2 61440 -> inf)
   and an integer triad's scalar saturated on the card (int8 300 -> 127);
   the triad in bf16, f16, e4m3fn, e5m2 and the six integer types at N 1003
   and 2^20 + 5, also with inputs past the range, bit-exact (bf16 and f16
   now too: the triad rounds where the reference does); scatter add and xor
   of 8/16-bit integers at rows of 1, 3 and 64 elements, float8 add at 3
   and 64, bf16 / f16 add at 1, 3 and 5 elements (the word path), 50000
   updates into 3000 rows and every update into one row, integers
   bit-exact, float8 and 16-bit floats within `ref.scatter_add16_limit`;
   the gather of e4m3 rows; flash in e4m3 / e5m2 at D 8, 100, 128 and in
   int8 (its float32 copies), paged with e4m3 / e5m2 caches at D 8, 100,
   128, within one unit in the output type's last place, and a bf16 q over
   e4m3 caches within PAGED_BF16_TOL; flash in int8 timed beside SDPA on
   float32 copies. Then (`check_paged_fp8`) paged over float8 caches on
   the tensor cores: the rule of where its products run, the source's
   against the wrapper's; q in e4m3, e5m2, bf16 and f16 over caches of
   both kinds at D 48, 64, 80, 128, 144 and 256, lengths 0 to T; fp32 and
   int8 q; outputs past e4m3's range. Last (`fp8_serve_shapes`) flash in
   both float8 types at qwen2.5-3b's prefill and paged with float8 caches
   (and a bf16 q over e4m3, an f16 q over e5m2) at its decode, timed beside
   the plain version, the bound and SDPA on bf16 copies, each paged call
   one kernel on the device (torch.profiler, in a process of its own).
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
   pages, kernel logits within LOGITS_TOL of the plain path. The four
   dense archs at smoke size with kernels and offload: phi4-mini-3.8b and
   qwen2.5-32b at head size 8 through flash and paged, launches counted,
   offloaded tokens identical, the prefill's and the first decode step's
   logits within LOGITS_TOL of the plain path on the same weights. Then
   (`run_float16_paths`) qwen2.5-3b at full width cast to float16, batch 4,
   prompt 1000, 8 decode steps with kernels (the profiler must see flash's
   and paged's float16 instantiations; prefill and first-step logits within
   LOGITS_TOL of the plain path, whose float16 logits must be finite), and
   qwen2.5-3b's smoke config at head size 512 (prefill and 3 decode steps
   through the wide bodies, logits against the plain path).
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
   updates; bf16 add, [2^24, 64], 2^20 updates; then the types taken last
   at 2^20 updates, a quarter into 4096 hot rows: add into [2^24, 64]
   int8, int16, uint16, e4m3fn, e5m2 and into 3- and 6-byte rows, xor
   into int8 and uint16 rows of 64 elements and of 3, bf16 add into
   [2^24, 3]), `ops.gather` (the same
   rows; qwen2.5-3b's embedding table; [2^24, 3] bf16 and int8 tables,
   rows of 6 and 3 bytes; [2^24, 64] e4m3) and `ops.triad` (2^28 floats,
   f32 and f16; then int8, uint8, int16, int32, e4m3fn, e5m2, each drawn
   past its range: integers wrap, float8 gives NaN / inf), the
   GUPS xor again on a uint32 view of its table (bit for bit the int32
   result), each against its plain version, timed beside
   its bound (scatter: also its sector bound) and the library call, and
   sweeps of the scatter's ring depth K at GUPS (where it must not matter)
   and at 512-byte xor, of its `block_m` at GUPS (what is in flight an SM
   there), with GUP/s and updates in flight per SM, and of the gather's K
   (rows in flight per SM). One launch per `ops` call, counted, but four for
   each bucketed scatter (rows of fewer than 32 bytes, tables of 8 GiB or
   more, 2^26 updates or more: GUPS).
6. simulator: the port's whole quickstart (`repro_torch.launch.quickstart`
   `main`, on the card): GUPS at 0.2, 1 and 5 us of far-memory latency,
   baseline core against the AMU session; the 4-core rack against one
   core; the GUPS xor pass through `ops.scatter_update` (one
   `async_scatter` launch, counted). Then `simulator.run` on each of the
   paper's eleven workloads, "baseline" against "amu" (batched engine) at
   1 us, and GUPS also at 5 us. Every run must be verified (the far-memory
   image equals the numpy oracle's). The speedups and MLP printed are the
   model's figures, the same on any machine; the phase's host seconds are
   the only measurement. Then the port's counterparts of `examples/`:
   `launch.serve_paged --lm --use-kernels --arch phi4-mini-3.8b
   --prompt-len 130` (head size 8 through flash and paged, two waves,
   launches counted) and `launch.train_far_memory` for 30 steps with a
   failure injected at step 15 (one restart from the step-10 checkpoint,
   the steps run checked).
7. parallel: (a) the sharded train step (`runtime.steps.jit_train_step`,
   DTensors on the sharding rules' placements) on a one-rank `nccl` group
   and a (1, 1) ("data", "model") DeviceMesh: qwen2.5-3b at full width as
   the training phase runs it, 3 steps, then on a freed card 3 steps of
   `make_train_step` from the same seed; losses and grad norms must agree
   to a relative 1e-6 (the largest difference is printed), with step ms
   both ways and the peak memory; no kernel launches (the sharded steps
   run `use_kernels=False`, as the reference's). (b) The dry run
   (`launch.dryrun`) on fake ranks and fake tensors: every arch at
   train_4k on the 16x16 mesh, qwen2.5-32b and kimi-k2-1t-a32b on 2x16x16,
   in parallel processes (rwkv6 with its chunk-parallel mixer at chunks of
   256: the default per-token scan is a 4096-step eager loop); a row each
   (per-device argument and peak GiB,
   FLOPs, HBM bytes, collective bytes by kind, the three roofline terms on
   the H100's published rates, the bottleneck); each cell must complete,
   its argument bytes equal those of the specs, its useful-FLOPs ratio in
   (0, 1.05].
8. one JSON line listing the kernels, then the device line, then the verdict.

Imports `torch` and `repro_torch` only. There is no fallback to the CPU or to
a plain version anywhere: whatever fails, fails the run.
"""
from __future__ import annotations

import argparse
import ctypes
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
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float16: 989e12,
              torch.float32: 67e12, torch.float8_e4m3fn: 1979e12,
              torch.float8_e5m2: 1979e12, torch.int8: 1979e12}

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
# float16 the same way at its own unit roundoff, 2^-11 where bf16's is 2^-8:
# one f16 step of the value (2^-10 of it at most) and 2^-11 of sum p_i |v_i|
# for P rounded to f16, each with a 2x margin; tighter than bf16's
FLASH_F16_TOL = dict(atol=1e-4, rtol=2e-3, ptol=1e-3)
PAGED_F16_TOL = dict(atol=1e-4, rtol=2e-3)
LIBRARY_TOL = dict(atol=1e-2, rtol=2e-2)  # the yardstick computes the same
# the AMU kernels, at tests/test_kernels.py's limits: f32 scatter-add sums a
# row's updates in the order the L2 applies them; triad's plain version
# repeats the kernel's arithmetic, so it agrees to the bit in practice
SCATTER_TOL = dict(atol=1e-4, rtol=1e-4)
TRIAD_TOL = {torch.float32: dict(atol=1e-6, rtol=1e-6),
             torch.bfloat16: dict(atol=2e-2, rtol=2e-2),
             torch.float16: dict(atol=2e-3, rtol=2e-3)}
# the types added last: float8 and the 8/16-bit integers (the triad's,
# scatter's and attention's new inputs)
FP8 = (torch.float8_e4m3fn, torch.float8_e5m2)
SMALL_INTS = (torch.int8, torch.uint8, torch.int16, torch.uint16)
# float8 triad inputs drawn this wide pass the type's range in s * c or in
# the sum (the overflow cases); 16-bit floats likewise
OVERFLOW_SCALE = {torch.float8_e4m3fn: 200.0, torch.float8_e5m2: 30000.0,
                  torch.float16: 3e4, torch.bfloat16: 1e38}
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


# ... and in each kernel whose symbol holds all the given parts (an
# instruction "A*B" is a line holding both): the 16-bit flash body above 256
# columns (the pair body) on wgmma, TMA and setmaxnreg; flash's wgmma body
# with the element loader (its template argument ELEM, the last but one,
# true) and at D = 256, on wgmma
# and with the producer warpgroup's register hand-over (setmaxnreg,
# USETMAXREG in SASS); its fp8 bodies by TMA (F8 true, ELEM false, and E5
# false or true) on the fp8 wgmma of their kind (QGMMA in SASS); flash's
# fma body in float32 (`flash_fma_kernel<float, D, EXACT>`) on cp.async
# (LDGSTS) into its ring, mbarriers (SYNCS) and ex2.approx, without expf's
# slow path; its clusters above 256 columns (`flash_fma_kernel<E, 256,
# false, 64, WIDE=true>`) on the cluster barrier (UCGABAR) and arrivals on
# the peers' mbarriers (SYNCS...RED); paged's wide body by TMA (`paged_wide_kernel<E, EQ, true>`) on
# TMA and mbarriers, its segments of several KV heads (HEADS true, HX 1) on
# TMA, its bodies of two query heads a warp (HX 2) on mma.sync, TMA and
# ldmatrix (LDSM: q's fragments), its tensor-core body over the whole head
# above 256 columns (<E, E, 512, EXACT=false, TMA=true, HEADS=false>) on
# mma.sync, TMA and ldmatrix (q staged in shared memory); the scatter's
# 16-bit integer add
# (`scatter_apply_kernel<1, OP_ADD, uint16_t>`) on the returning add
# (ATOMG.ADD) and the carry repair (RED), its 8-bit integer and fp8 adds
# (uint8_t, __nv_fp8_e4m3 / e5m2), a word or (W 16) a 16-byte unit at a
# time, on compare-and-swaps (ATOMG.CAS); flash's mma.sync body at Dp 16
# for D < 16 (D = 8, the smoke configs' head size: EXACT false) on mma.sync
# (HMMA) with p by ex2.approx (MUFU.EX2), and none of expf's slow path
# (its range reduction's FFMA.SAT, one an expf: 34 in the body that took
# expf; an instruction marked "!" must be absent)
SASS_WANT_IN = {"flash_attention": [
                    (("flash_mma_kernel", "Li16ELb0E"),
                     ("HMMA", "MUFU.EX2", "!FFMA.SAT")),
                    (("flash_fma_kernelIfLi",),
                     ("LDGSTS", "SYNCS", "MUFU.EX2", "!FFMA.SAT")),
                    (("flash_fma_kernel", "Lb1EEEv"),
                     ("UCGABAR_ARV", "UCGABAR_WAIT", "SYNCS*RED")),
                    (("flash_wgmma_pair_kernel",),
                     ("HGMMA", "UTMALDG", "USETMAXREG")),
                    (("flash_wgmma_kernel", "Lb1ELb0EEEv"),
                     ("HGMMA", "USETMAXREG")),
                    (("flash_wgmma_kernel", "Li256E"),
                     ("HGMMA", "USETMAXREG")),
                    (("flash_wgmma_kernel", "Lb1ELb0ELb0EEEv"),
                     ("GMMA*E4M3", "HGMMA", "UTMALDG", "USETMAXREG")),
                    (("flash_wgmma_kernel", "Lb1ELb0ELb1EEEv"),
                     ("GMMA*E5M2", "HGMMA", "UTMALDG", "USETMAXREG"))],
                "paged_attention": [(("paged_wide_kernel", "Lb1EEEv"),
                                     ("UTMALDG", "SYNCS")),
                                    (("Lb1ELb1ELi1EEEv",), ("UTMALDG",)),
                                    (("Lb0ELi2EEEv",),
                                     ("HMMA", "UTMALDG", "LDSM")),
                                    (("Li512ELb0ELb1ELb0E",),
                                     ("HMMA", "UTMALDG", "LDSM")),
                                    (("q_asI6__half",), ("HMMA", "UTMALDG")),
                                    (("q_asI13__nv_bfloat16",),
                                     ("HMMA", "UTMALDG"))],
                "async_scatter": [(("scatter_apply_kernelILi1ELi0EtE",),
                                   ("ATOMG*ADD", "RED")),
                                  (("scatter_apply_kernelILi1ELi0EhE",),
                                   ("ATOMG*CAS",)),
                                  (("scatter_apply_kernelILi1ELi0E13__nv_fp8_e",),
                                   ("ATOMG*CAS",)),
                                  (("scatter_apply_kernelILi16ELi0EhE",),
                                   ("ATOMG*CAS",)),
                                  (("scatter_apply_kernelILi16ELi0E13__nv_fp8_e",),
                                   ("ATOMG*CAS",))]}


def sass_functions(sass) -> dict:
    """Each kernel's SASS lines (cuobjdump --dump-sass), by symbol."""
    funcs, func = {}, None
    for line in sass:
        if "Function :" in line:
            func = line.split("Function :")[1].strip()
            funcs[func] = []
        elif func is not None and "/*" in line and ";" in line:
            funcs[func].append(line)
    return funcs


def sass_reached(lines, start) -> list:
    """The instructions of one kernel's SASS reachable from the first one
    that holds `start`: every path through branches (a predicated branch or
    exit also falls through), none past an unpredicated EXIT, RET or
    indirect branch."""
    import re
    code = {}
    order = []
    for line in lines:
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s*(.*?);", line)
        if m:
            addr = int(m.group(1), 16)
            code[addr] = m.group(2).strip()
            order.append(addr)
    after = {a: b for a, b in zip(order, order[1:])}
    todo = [a for a in order if start in code[a]][:1]
    seen = set()
    while todo:
        a = todo.pop()
        if a in seen or a not in code:
            continue
        seen.add(a)
        ins = code[a]
        op = ins.split()[1] if ins.startswith("@") else ins.split()[0]
        guarded = ins.startswith("@") and not ins.startswith("@PT")
        target = re.findall(r"0x([0-9a-f]+)", ins)
        if op.startswith(("BRA", "CALL")) and target:
            todo.append(int(target[-1], 16))
            if not guarded and op.startswith("BRA"):
                continue
        elif op.startswith(("EXIT", "RET", "BRX", "JMX")) and not guarded:
            continue
        if a in after:
            todo.append(after[a])
    return [code[a] for a in order if a in seen]


# ... and in the code of the consumer warpgroups of each such kernel (the
# instructions reachable from their setmaxnreg.inc, USETMAXREG.TRY_ALLOC):
# the instructions they must hold and those they must not. flash's fp8
# bodies by TMA take Q K^T on the fp8 wgmma and leave V's conversion to f16
# (F2FP...UNPACK_B for e4m3) to the producer warpgroup, whose code holds
# it in the e4m3 bodies
SASS_CONSUMERS = {"flash_attention": [
    (("flash_wgmma_kernel", "Lb1ELb0ELb0EEEv"), ("GMMA*E4M3",), ("UNPACK",),
     ("UNPACK",)),
    (("flash_wgmma_kernel", "Lb1ELb0ELb1EEEv"), ("GMMA*E5M2",), ("UNPACK",),
     ())]}


def sass_has(line, op) -> bool:
    return all(part in line for part in op.split("*"))


def check_sass(out_dir) -> dict:
    """Counts the SASS lines of each instruction of `SASS_WANT` in the built
    libraries (cuobjdump, beside nvcc), and of `SASS_WANT_IN` in each kernel
    whose symbol holds the given parts, and fails where one is missing (in
    a library, or in any one of those kernels); then holds the consumer
    warpgroups' code of `SASS_CONSUMERS` to what it must and must not
    hold."""
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
        for parts, want in SASS_WANT_IN.get(lib, []):
            funcs, func = {}, None        # kernel symbol -> counts
            for line in sass:
                if "Function :" in line:
                    func = line.split("Function :")[1].strip()
                    if not all(part in func for part in parts):
                        func = None
                    else:
                        funcs[func] = {op: 0 for op in want}
                elif func is not None:
                    for op in want:
                        funcs[func][op] += sass_has(line, op.lstrip("!"))
            key = f"{lib} {'*'.join(parts)}"
            counts[key] = {op: sum(f[op] for f in funcs.values())
                           for op in want}
            counts[key]["kernels"] = len(funcs)
            lacking = [name for name, f in funcs.items()
                       if not all(f[op] == 0 if op.startswith("!") else f[op]
                                  for op in want)]
            if not funcs or lacking:
                raise AssertionError(f"lib{lib}.so: the kernels named "
                                     f"*{'*'.join(parts)}* ({len(funcs)}) "
                                     f"fail {want} ('!': absent): "
                                     f"{lacking[:3]}")
        for parts, must, never, producer in SASS_CONSUMERS.get(lib, []):
            kernels = {name: code
                       for name, code in sass_functions(sass).items()
                       if all(part in name for part in parts)}
            key = f"{lib} {'*'.join(parts)} consumers"
            counts[key] = {"kernels": len(kernels)}
            for name, code in kernels.items():
                mine = sass_reached(code, "USETMAXREG.TRY_ALLOC")
                theirs = sass_reached(code, "USETMAXREG.DEALLOC")
                bad = [op for op in must if not any(sass_has(x, op)
                                                    for x in mine)]
                bad += [f"not {op}" for op in never
                        if any(sass_has(x, op) for x in mine)]
                bad += [f"producer {op}" for op in producer
                        if not any(sass_has(x, op) for x in theirs)]
                if not mine or bad:
                    raise AssertionError(
                        f"lib{lib}.so: the consumer warpgroups of {name} "
                        f"({len(mine)} instructions) fail {bad}")
                for op in must + never:
                    counts[key][op] = counts[key].get(op, 0) + sum(
                        sass_has(x, op) for x in mine)
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


def flash_bound(b, hq, hkv, s, d, window, dtype, causal=True):
    item = torch.empty((), dtype=dtype).element_size()
    nbytes = (2 * b * hq * s * d + 2 * b * hkv * s * d) * item
    if causal:
        rows = torch.arange(1, s + 1, dtype=torch.float64)
        keys = float((rows.clamp(max=window) if window else rows).sum())
    else:          # every key, or those after the row's window edge
        pos = torch.arange(s)
        keys = float(s * s) if not window else float(
            (pos[None, :] > pos[:, None] - window).sum())
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
    check_body_rules()
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
    worst = max(worst, check_flash_padded(gen))
    check_flash_padded(gen, F16_DIMS, (torch.float16,))
    check_flash_padded(gen, ELEM_DIMS, (torch.bfloat16, torch.float16))
    worst = max(worst, check_flash_padded(gen, WIDE_DIMS, TYPES))

    # the serve shapes: full-width prefill of each served arch, S ragged
    # against 128 (qwen2.5-3b's is the one the kernels line reports),
    # recurrentgemma-9b's windowed one at D = 256, and hubert-xlarge's
    # encoder attention at D = 80 (not causal: its own path never reaches
    # flash, the reference's rule, but its shape is the one at D = 80)
    shapes = [flash_serve_shape(gen, arch) for arch in (ARCH,) + SLICE_ARCHS]
    rg = "recurrentgemma-9b"
    window = configs.get_config(rg).window_size
    shapes.append(flash_serve_shape(gen, rg, 2 * window, window))
    shapes.append(flash_serve_shape(gen, "hubert-xlarge", causal=False))
    main = shapes[0]
    SERVE_SHAPES.extend(dict(kernel="flash_attention", **c) for c in shapes)
    return {"name": "flash_attention", "route": "cuda", "source": FLASH_SRC,
            "replaces": "src/repro/kernels/flash_attention.py:96",
            "launches": 0,
            "max_abs_err": max([worst] + [c["max_abs_err"] for c in shapes]),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"]}


BODY_RULE_DIMS = list(range(0, 1101)) + [2048]
# head sizes above 256 at which paged's products and chunks are held: every
# one up to 2048 (one chunk), and chunks of 2048 above (the last one whole,
# or of one to seven pieces)
WIDE_RULE_DIMS = list(range(257, 2049)) + [2049, 2304, 2560, 4096, 4097,
                                           4352, 6144, 8192]
# (Hq, Hkv) at which paged's split and products rules are held: G of 1 to 32,
# KV heads that 8 / G does not divide, and groups of 16 query heads that are
# not whole or more than one
PAGED_RULE_LAYOUTS = ((16, 16), (16, 8), (16, 4), (16, 2), (16, 1), (6, 6),
                      (12, 6), (3, 3), (20, 4), (24, 8), (12, 1), (32, 2),
                      (24, 1))


# head sizes at which paged's run rule is held (rows of every width up to
# Dp 256, and one above)
RUN_RULE_DIMS = list(range(1, 258)) + [300]


def run_layouts(hkv, d):
    """[B, T, Hkv] strides of k and v in elements: contiguous, strided
    heads (4 elements past each), a T stride of 1 element more than the
    tokens, and k contiguous beside v with strided heads."""
    dense = (7 * hkv * d, hkv * d, d)
    padded = (7 * hkv * (d + 4), hkv * (d + 4), d + 4)
    loose = (7 * (hkv * d + 1), hkv * d + 1, d)
    return (dense * 2, padded * 2, loose * 2, dense + padded)


# head sizes and (B, Hq, S) at which the fma body's query rows a block are
# held: every Dp, and grids of 128-row tiles on either side of 100, 132 and
# 144 blocks and at them
FMA_ROWS_DIMS = (8, 16, 32, 33, 64, 100, 128, 200, 256, 512)
FMA_ROWS_GRID = tuple((b, hq, s) for b in (1, 2, 4)
                      for hq in (1, 8, 16, 33, 50, 66, 72, 131, 132, 133)
                      for s in (1, 64, 128, 129, 200, 256, 257, 1000, 1057))


def check_flash_blocks(flash, fa, code, dtype, d):
    """Flash's blocks a query tile and CTAs a cluster at (dtype, d): the
    source's (`flash_attention_wide_blocks`, `flash_attention_cluster`)
    against the wrapper's (`wide_blocks`, `fma_cluster`), and the blocks
    the clusters times the passes of Q K^T (`qk_passes`)."""
    got = (flash.flash_attention_wide_blocks(code, d),
           flash.flash_attention_cluster(code, d))
    want = (fa.wide_blocks(dtype, d), fa.fma_cluster(dtype, d))
    if got != want:
        raise AssertionError(
            f"flash blocks a query tile and CTAs a cluster for {dtype} D{d}: "
            f"the source says {got}, the wrapper {want} ... FAIL")
    if fa.body_for(dtype, d) == "fma" and \
            want[0] != want[1] * fa.qk_passes(dtype, d):
        raise AssertionError(f"flash fma {dtype} D{d}: {want[0]} blocks, "
                             f"clusters of {want[1]} ... FAIL")


def check_body_rules():
    """The body rule of each attention source is its wrapper's, at every
    head size from 0 to 1100 and at 2048, in the three types and (flash)
    with q, k, v of two types, which the wrapper runs on the float32 body:
    0 refused by both."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa

    flash, paged = _build.load("flash_attention"), _build.load("paged_attention")
    names = {-1: None, 0: "fma", 1: "wgmma", 2: "mma", 3: "wgmma_elem"}
    types = (torch.float32, torch.bfloat16, torch.float16)
    pairs = [(a, b) for a in types for b in types] + [(t, t) for t in FP8]
    for q_dtype, kv_dtype in pairs:
        # the type the source's launch is given: float32 for mixed types
        code = _build.DTYPE_CODES[q_dtype if q_dtype == kv_dtype
                                  else torch.float32]
        for d in BODY_RULE_DIMS:
            try:
                want = fa.body_for(q_dtype, d, kv_dtype)
            except ValueError:
                want = None
            got = names[flash.flash_attention_body(code, d)]
            want_paged = got_paged = None
            if q_dtype == kv_dtype:
                try:
                    want_paged = pa.body_for(q_dtype, d)
                except ValueError:
                    want_paged = None
                got_paged = {-1: None, 0: "tma", 1: "element"}[
                    paged.paged_attention_body(code, d)]
            if (got, got_paged) != (want, want_paged):
                raise AssertionError(
                    f"body for {q_dtype} / {kv_dtype} D{d}: the sources run "
                    f"flash {got}, paged {got_paged}; the wrappers say "
                    f"{want}, {want_paged} ... FAIL")
            if want is not None and q_dtype == kv_dtype:
                check_flash_blocks(flash, fa, code, q_dtype, d)
    # flash above 1100 columns: the blocks a query tile and the clusters
    fa._bind()
    for dtype in (*types, *FP8):
        for d in WIDE_RULE_DIMS:
            check_flash_blocks(flash, fa, _build.DTYPE_CODES[dtype], dtype, d)
    # the fma body's query rows a block, by the heads and rows of a launch
    # and the card's SMs (this card's, and two others)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = {}
    for q_dtype, kv_dtype in pairs:
        code = _build.DTYPE_CODES[q_dtype if q_dtype == kv_dtype
                                  else torch.float32]
        for d in FMA_ROWS_DIMS:
            for b, hq, s in FMA_ROWS_GRID:
                for n_sm in (sms, 100, 144):
                    got = flash.flash_attention_fma_rows(code, d, b, hq, s,
                                                         n_sm)
                    want = fa.fma_rows(q_dtype, d, b, hq, s, n_sm, kv_dtype)
                    if got != want:
                        raise AssertionError(
                            f"flash fma rows for {q_dtype} / {kv_dtype} D{d} "
                            f"B{b} Hq{hq} S{s} on {n_sm} SMs: the source says "
                            f"{got}, the wrapper {want} ... FAIL")
                    if n_sm == sms and want:
                        rows[want] = rows.get(want, 0) + 1
    # paged's KV heads a segment and where its products run, by GQA layout
    pa._bind()
    products = {0: "fma", 1: "mma"}
    for dtype in (*types, *FP8):
        code = _build.DTYPE_CODES[dtype]
        for hq, hkv in PAGED_RULE_LAYOUTS:
            for d in BODY_RULE_DIMS[1:]:
                got = (paged.paged_attention_heads(code, code, d, hq, hkv),
                       products[paged.paged_attention_products(
                           code, code, d, hq, hkv)],
                       paged.paged_attention_group(code, code, d, hq, hkv))
                want = (pa.kv_heads(dtype, dtype, d, hq, hkv),
                        pa.products_on(dtype, dtype, d, hq, hkv),
                        pa.query_heads(dtype, dtype, d, hq, hkv))
                if got != want:
                    raise AssertionError(
                        f"paged heads, products and group for {dtype} Hq{hq} "
                        f"Hkv{hkv} D{d}: the source says {got}, the wrapper "
                        f"{want} ... FAIL")
    # paged above 256 columns, at every D from 257 to 2048 and at
    # WIDE_RULE_DIMS above: where the products run and the chunks of 2048
    # output columns (1 up to 2048: a block over the whole head, on the
    # tensor cores up to 512 for 16-bit rows of whole pieces under their own
    # q, else in the wide body on FMAs) by the source and by the wrapper's
    # plan, whose rows the source's ring takes, under a q of the caches'
    # type and of another
    wide = chunked = 0
    for dtype in (*types, *FP8):
        code = _build.DTYPE_CODES[dtype]
        for q_dtype in (dtype, torch.float32, torch.float16):
            qk = pa.kernel_types(q_dtype, dtype)[0]
            qcode = _build.DTYPE_CODES[qk]
            for d in WIDE_RULE_DIMS:
                got = (products[paged.paged_attention_products(
                           code, qcode, d, 16, 2)],
                       paged.paged_attention_chunks(code, qcode, d, 16, 2))
                where = pa.products_on(q_dtype, dtype, d, 16, 2)
                plan = pa.paged_plan(4, 16, 2, 1032, 512, 132, d,
                                     dtype.itemsize, products=where)
                if got != (where, plan.chunks):
                    raise AssertionError(
                        f"paged above 256 columns for {dtype} q {q_dtype} "
                        f"D{d}: the source says {got}, the wrapper "
                        f"{(where, plan.chunks)} ... FAIL")
                pa._ring(4, d, plan.rows, dtype, qk)   # raises where none
                if plan.chunks != -(-d // 2048):
                    raise AssertionError(
                        f"paged above 256 columns for {dtype} q {q_dtype} "
                        f"D{d}: {plan.chunks} chunks of 2048 columns ... FAIL")
                wide += plan.chunks == 1
                chunked += plan.chunks > 1
    # paged's KV heads a TMA box of rows of no whole 16-byte pieces, by the
    # caches' strides and alignment
    paged.paged_attention_run.argtypes = [
        ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int]
    runs = 0
    for dtype in (*types, *FP8):
        code = _build.DTYPE_CODES[dtype]
        for q_dtype in (dtype, torch.float32):
            qcode = _build.DTYPE_CODES[pa.kernel_types(q_dtype, dtype)[0]]
            for hq, hkv in PAGED_RULE_LAYOUTS:
                for d in RUN_RULE_DIMS:
                    for layout in run_layouts(hkv, d):
                        for aligned in (True, False):
                            got = paged.paged_attention_run(
                                code, qcode, d, hq, hkv,
                                (ctypes.c_longlong * 6)(*layout), aligned)
                            want = pa.run_heads(q_dtype, dtype, d, hq, hkv,
                                                layout, aligned)
                            runs += got > 0
                            if got != want:
                                raise AssertionError(
                                    f"paged run of heads for {dtype} q "
                                    f"{q_dtype} Hq{hq} Hkv{hkv} D{d} strides "
                                    f"{layout} aligned {aligned}: the source "
                                    f"says {got}, the wrapper {want} ... FAIL")
    log("  body rules, D 0-1100 and 2048 x 3 types, the 6 mixed pairs and "
        "fp8, sources and wrappers agree: flash fp32 and mixed -> fma; "
        "16-bit D % 8 == 0: Dp >= 64 -> wgmma (wide above 256), Dp 16-32 -> "
        "mma; 16-bit D % 8 != 0 and fp8 D % 16 != 0 at Dp 64-256 -> "
        "wgmma_elem, else fma; fp8 D % 16 == 0 and Dp 64-256 -> wgmma; "
        "paged rows of whole 16-byte pieces -> tma, others -> element; 0 "
        "refused; paged's KV heads a segment, products and query heads a "
        f"segment at {len(PAGED_RULE_LAYOUTS)} GQA layouts (16-bit on the "
        "TMA ring at Dp 64-256, G = 1, or G of 2 and 4 at D < Dp, and rows "
        "of no whole 16-byte pieces in every type at G dividing 8: 8 / G "
        "heads a segment, on fma; G > 8 on mma: 16 query heads a segment); "
        "flash's blocks a query tile and CTAs a cluster (one up to 512 in "
        "the wgmma body; a cluster of one CTA a 256-column piece in the fma "
        f"body, 8 a chunk of 2048 above) also at {WIDE_RULE_DIMS[-8:]}; the "
        f"fma body's rows a block at D {FMA_ROWS_DIMS} x "
        f"{len(FMA_ROWS_GRID)} (B, Hq, S) x {sms}, 100, 144 SMs "
        f"(on this card: {rows}); "
        "paged above 256 columns at every D 257-2048 and at "
        f"{WIDE_RULE_DIMS[-8:]} under three q types: products and chunks "
        f"agree, each plan's ring fits ({wide} launches of one chunk, a "
        "block over the whole head, on mma for 16-bit rows of whole pieces "
        "up to 512 under their own q, else in the wide body on FMAs; "
        f"{chunked} of ceil(D / 2048) chunks above 2048); "
        f"paged's runs of heads by TMA at D {RUN_RULE_DIMS[0]}-"
        f"{RUN_RULE_DIMS[-1]}, 4 stride layouts, aligned or not ({runs} "
        "runs)")


def window_mask(s, window):
    """[S, S] boolean mask of causal attention within `window` keys, as the
    library call takes it."""
    pos = torch.arange(s, device="cuda")
    return (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)


def flash_serve_shape(gen, arch, s=PROMPT_LEN, window=0,
                      causal=True) -> dict:
    """Flash at one arch's full-width prefill (B=4, bf16; S, the window and
    causality as given): held against the plain version and the library
    call, timed beside both and its bound. With a window, the library call
    takes it as a boolean mask, and the kernels the profiler sees in that
    call are printed: they say which backend served it."""
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa, ref
    import torch.nn.functional as F

    cfg = configs.get_config(arch)
    b, hq, hkv, d = (BATCH, cfg.num_heads, cfg.num_kv_heads,
                     cfg.resolved_head_dim)
    shape = (f"{arch} B{b} Hq{hq} Hkv{hkv} S{s} D{d}"
             + (f" window{window}" if window else "")
             + ("" if causal else " not causal"))
    q, k, v = flash_case(gen, b, hq, hkv, s, d, torch.bfloat16)
    out = fa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    err = check_close(f"bf16 {shape}", out,
                      ref.attention_ref(q, k, v, causal, window),
                      spread=flash_spread(q, k, v, causal, window),
                      **FLASH_BF16_TOL)
    lib = (dict(attn_mask=window_mask(s, window)) if window
           else dict(is_causal=causal))

    def library():
        return F.scaled_dot_product_attention(q, k, v, enable_gqa=True, **lib)

    check_close("  (library call agrees)", library(), out, **LIBRARY_TOL)
    ms = time_ms([lambda: fa.flash_attention(q, k, v, causal=causal,
                                             window=window)], 20)
    plain_ms = time_ms([lambda: ref.attention_ref(q, k, v, causal, window)],
                       5)
    library_ms = time_ms([library], 10)
    bound_ms, bound_by = flash_bound(b, hq, hkv, s, d, window, torch.bfloat16,
                                     causal)
    host = host_us(lambda: fa.flash_attention(q, k, v, causal=causal,
                                              window=window))
    log(f"  serve shape ({fa.body_for(q.dtype, d)} body): kernel {ms:.4f} ms "
        f"(host {host:.1f} us a call), plain {plain_ms:.4f} ms, library "
        f"{library_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by})")
    case = dict(shape=shape, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                host_us=host)
    if window:
        case["library_kernels"] = kernel_names(library)
        log("  the library call ran: "
            + ", ".join(n[:70] for n in case["library_kernels"]))
    return case


def check_flash_256(gen) -> float:
    """The D = 256 bodies (wgmma with 128 x 64 tiles and two consumer
    warpgroups, in bf16 and f16, and with the element loader at D 196 and
    255; FMAs in fp32) at their edges: windows of 1, 63, 64, 65 and 127 keys
    (below, at and past the 64-key tile, one short of two tiles) and past
    S, S ragged against 64 and 128 (1000, 4113) and below one tile, GQA
    groups 1 and 16 (recurrentgemma's MQA: 16 query heads on one KV head),
    not causal with and without a window. Returns the worst fp32 error."""
    from repro_torch.kernels import flash_attention as fa

    log("flash_attention at head size 256 vs ref.attention_ref")
    worst = 0.0
    cases = [  # (b, hq, hkv, s, causal, window)
        (1, 16, 1, 1000, True, 1), (1, 16, 1, 1000, True, 63),
        (1, 16, 1, 1000, True, 64), (1, 16, 1, 1000, True, 65),
        (1, 16, 1, 1000, True, 127), (2, 16, 1, 1000, True, 4096),
        (1, 4, 4, 1000, True, 0), (1, 16, 1, 4113, True, 2048),
        (2, 2, 1, 37, True, 0), (1, 16, 1, 333, False, 0),
        (1, 4, 4, 300, False, 63), (1, 16, 1, 129, False, 65)]
    for dtype, d in ((torch.bfloat16, 256), (torch.float32, 256),
                     (torch.float16, 256), (torch.bfloat16, 196),
                     (torch.float16, 255)):
        for (b, hq, hkv, s, causal, window) in cases:
            q, k, v = flash_case(gen, b, hq, hkv, s, d, dtype)
            out = fa.flash_attention(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            err = check_flash_out(
                f"{tname(dtype)} B{b} Hq{hq} Hkv{hkv} S{s} D{d} "
                f"causal{causal} window{window} ({fa.body_for(dtype, d)} "
                "body)", out, q, k, v, causal, window)
            if dtype == torch.float32:
                worst = max(worst, err)
            del q, k, v, out
    return worst


# head sizes between the bodies' own: below 16, not a whole number of
# 16-byte pieces in bf16 (1, 7: flash's fma body; 100: its wgmma body with
# the element loader; paged's element body), through mma.sync (8, 24),
# through wgmma or paged's TMA ring with TMA's zero fill (40 below one
# 64-column box; 80, 96, 192)
PADDED_FLASH_DIMS = (1, 7, 8, 24, 40, 80, 96, 100, 192)
PADDED_PAGED_DIMS = (1, 7, 8, 24, 40, 80, 100, 256)
# float16 at the bodies' own head sizes and at 8 and 80 (padded)
F16_DIMS = (8, 64, 80, 128, 256)
# 16-bit rows of no whole 16-byte pieces on the wgmma body with the element
# loader, at each Dp (64, 128, 256): odd (2-byte loads through registers),
# 98 (4-byte cp.async), 100 and 196 (8-byte cp.async); and 200, whole pieces
# padded to 256 (TMA)
ELEM_DIMS = (33, 98, 100, 196, 200, 255)
# the wide bodies: a chunk and a tail of 1 (fma) or 8 columns (wgmma, TMA),
# 300 (16-bit: fma / element), whole chunks (512, 1024, 2048), 384, 576,
# 1000 (part of a chunk, part of a 64-column piece)
WIDE_DIMS = (257, 264, 300, 384, 512, 576, 1000, 1024, 2048)
GUARD_WIDE_DIMS = (300, 512, 1000)
TYPES = (torch.float32, torch.bfloat16, torch.float16)
GUARD = 8                 # guard columns past the padded head
SENTINEL = -512.0         # exact in bf16 and f16; no attention output reaches it


def tname(dtype) -> str:
    return str(dtype)[6:]


def flash_tol(dtype) -> dict:
    return {torch.float32: FP32_TOL, torch.bfloat16: FLASH_BF16_TOL,
            torch.float16: FLASH_F16_TOL}[dtype]


def paged_tol(dtype) -> dict:
    return {torch.float32: FP32_TOL, torch.bfloat16: PAGED_BF16_TOL,
            torch.float16: PAGED_F16_TOL}[dtype]


def check_flash_out(name, out, q, k, v, causal=True, window=0,
                    quiet=False) -> float:
    """flash's output against the plain version at the limit of q's type
    (the output's): the fp32 one, or the 16-bit one with its P term."""
    from repro_torch.kernels import ref
    want = ref.attention_ref(q, k, v, causal, window)
    if q.dtype == torch.float32:
        return check_close(name, out, want, quiet=quiet, **FP32_TOL)
    return check_close(name, out, want, quiet=quiet,
                       spread=flash_spread(q, k, v, causal, window),
                       **flash_tol(q.dtype))


def check_flash_padded(gen, dims=PADDED_FLASH_DIMS,
                       dtypes=(torch.float32, torch.bfloat16)) -> float:
    """Flash at head sizes that are not a body's own, each run by the body
    for Dp with its tail zero-filled and masked, and above 256 by the wide
    bodies: causal, windowed and not causal, S ragged against the tiles, GQA
    groups 1 and 8, in `dtypes`. Returns the worst fp32 error."""
    from repro_torch.kernels import flash_attention as fa

    log(f"flash_attention at head sizes {dims} in "
        f"{', '.join(map(tname, dtypes))} vs ref.attention_ref")
    worst = 0.0
    cases = [  # (b, hq, hkv, s, causal, window)
        (2, 8, 1, 200, True, 0), (1, 4, 4, 129, True, 48),
        (2, 8, 8, 100, False, 0), (1, 8, 1, 333, False, 63)]
    for dtype in dtypes:
        for d in dims:
            for (b, hq, hkv, s, causal, window) in cases:
                q, k, v = flash_case(gen, b, hq, hkv, s, d, dtype)
                out = fa.flash_attention(q, k, v, causal=causal,
                                         window=window)
                err = check_flash_out(
                    f"{tname(dtype)} B{b} Hq{hq} Hkv{hkv} S{s} D{d} "
                    f"causal{causal} window{window} "
                    f"({fa.body_for(dtype, d)} body)", out, q, k, v, causal,
                    window, quiet=True)
                if dtype == torch.float32:
                    worst = max(worst, err)
    torch.cuda.synchronize()
    log(f"  {len(dims)} head sizes x {len(cases)} cases x {len(dtypes)} "
        f"types agree; worst fp32 error {worst:.3e}")
    return worst


def check_paged_padded(gen, dims=PADDED_PAGED_DIMS,
                       dtypes=(torch.float32, torch.bfloat16)) -> float:
    """Paged at head sizes that are not a TMA body's own (and at 256), and
    above 256 (the wide body): lengths 0, 1, a middle one and T in one
    batch, GQA groups 1 and 8, one long sequence, in `dtypes`. Returns the
    worst fp32 error."""
    from repro_torch.kernels import paged_attention as pa, ref

    log(f"paged_attention at head sizes {dims} in "
        f"{', '.join(map(tname, dtypes))} vs ref.paged_attention_ref")
    worst = 0.0
    cases = [  # (b, hq, hkv, t, lengths)
        (4, 16, 2, 333, [0, 1, 200, 333]), (2, 8, 8, 65, [65, 0]),
        (1, 8, 1, 3000, [3000])]
    for dtype in dtypes:
        for d in dims:
            for (b, hq, hkv, t, lens) in cases:
                q, kc, vc = paged_case(gen, b, hq, hkv, t, d, dtype)
                lens = torch.tensor(lens, dtype=torch.int32, device="cuda")
                err = check_close(
                    f"{tname(dtype)} B{b} Hq{hq} Hkv{hkv} T{t} D{d} "
                    f"lengths {lens.tolist()} ({pa.body_for(dtype, d)} body)",
                    pa.paged_attention(q, kc, vc, lens),
                    ref.paged_attention_ref(q, kc, vc, lens), quiet=True,
                    **paged_tol(dtype))
                if dtype == torch.float32:
                    worst = max(worst, err)
    torch.cuda.synchronize()
    log(f"  {len(dims)} head sizes x {len(cases)} cases x {len(dtypes)} "
        f"types agree; worst fp32 error {worst:.3e}")
    return worst


def check_mixed_types(gen):
    """q of one type, k and v of another: bf16 q with f32 k, v and f16 q
    with bf16 k, v (and a wide head), through both wrappers, held at the
    limit of q's type against the plain versions (which cast each operand
    to float32, as the reference's kernels do)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa, ref

    log("mixed types: bf16 q with f32 k, v; f16 q with bf16 k, v")
    for q_dtype, kv_dtype in ((torch.bfloat16, torch.float32),
                              (torch.float16, torch.bfloat16)):
        for d in (80, 128, 512):
            q = randn(gen, (2, 200, 8, d), q_dtype, Q_SCALE).transpose(1, 2)
            k = randn(gen, (2, 200, 2, d), kv_dtype).transpose(1, 2)
            v = randn(gen, (2, 200, 2, d), kv_dtype).transpose(1, 2)
            out = fa.flash_attention(q, k, v, causal=True, window=0)
            if out.dtype != q_dtype:
                raise AssertionError(f"flash mixed: output {out.dtype}")
            check_flash_out(f"flash q {tname(q_dtype)} k, v {tname(kv_dtype)}"
                            f" D{d} ({fa.body_for(q_dtype, d, kv_dtype)} "
                            "body)", out, q, k, v)
            pq = randn(gen, (4, 16, d), q_dtype, Q_SCALE)
            kc = randn(gen, (4, 333, 2, d), kv_dtype)
            vc = randn(gen, (4, 333, 2, d), kv_dtype)
            lens = torch.tensor([0, 1, 200, 333], dtype=torch.int32,
                                device="cuda")
            pout = pa.paged_attention(pq, kc, vc, lens)
            if pout.dtype != q_dtype:
                raise AssertionError(f"paged mixed: output {pout.dtype}")
            check_close(f"paged q {tname(q_dtype)} caches {tname(kv_dtype)} "
                        f"D{d} ({pa.body_for(kv_dtype, d)} body)", pout,
                        ref.paged_attention_ref(pq, kc, vc, lens),
                        **paged_tol(q_dtype))
    torch.cuda.synchronize()


def check_guard_columns(gen, dims=None, dtypes=(torch.float32,
                                                torch.bfloat16)):
    """Each attention kernel's raw launch (`launch`, through `_build.load`)
    into an output whose rows are GUARD columns wider than the padded head,
    filled with SENTINEL: the columns past D must keep it (a store of Dp
    columns, or of a whole chunk, would write there), and the first D must
    agree with the plain version."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa, ref

    dims = dims or sorted(set(PADDED_FLASH_DIMS + PADDED_PAGED_DIMS
                              + ELEM_DIMS + (128,)))
    log(f"guard columns at D {tuple(dims)} in "
        f"{', '.join(map(tname, dtypes))}: raw launches into rows {GUARD} "
        f"columns past Dp, filled with {SENTINEL}")
    for dtype in dtypes:
        for d in dims:
            width = fa.padded_head_dim("flash_attention", d) + GUARD
            q, k, v = flash_case(gen, 2, 8, 2, 150, d, dtype)
            buf = torch.full((2, 8, 150, width), SENTINEL, dtype=dtype,
                             device="cuda")
            fa.launch(q, k, v, buf[..., :d], causal=True, window=0)
            q1, kc, vc = paged_case(gen, 3, 16, 2, 77, d, dtype)
            lens = torch.tensor([77, 0, 40], dtype=torch.int32, device="cuda")
            pbuf = torch.full((3, 16, width), SENTINEL, dtype=dtype,
                              device="cuda")
            pa.launch(q1, kc, vc, lens, pbuf[..., :d])
            torch.cuda.synchronize()
            for name, got in (("flash", buf), ("paged", pbuf)):
                if not bool((got[..., d:] == SENTINEL).all()):
                    bad = int((got[..., d:] != SENTINEL).sum())
                    raise AssertionError(
                        f"guard columns {name} {tname(dtype)} D{d}: {bad} "
                        f"written past the head ... FAIL")
            check_flash_out(f"guard flash {tname(dtype)} D{d}", buf[..., :d],
                            q, k, v, quiet=True)
            check_close(f"guard paged {tname(dtype)} D{d}", pbuf[..., :d],
                        ref.paged_attention_ref(q1, kc, vc, lens), quiet=True,
                        **paged_tol(dtype))
    log("  no store past D in either kernel")


def paged_bound(lengths, hq, hkv, d, dtype, q_dtype=None):
    """`dtype` the caches'; q and out of `q_dtype` (the caches' by
    default)."""
    item = torch.empty((), dtype=dtype).element_size()
    q_item = torch.empty((), dtype=q_dtype or dtype).element_size()
    rows, b = int(lengths.sum()), lengths.numel()
    nbytes = 2 * rows * hkv * d * item + 2 * b * hq * d * q_item + 4 * b
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
            for d in (16, 32, 64, 128, 256):
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
    log("  GQA groups 1, 3, 5, 7, 8 x head sizes 16-256 x both types agree")
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
    from repro_torch import configs
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
    worst = max(worst, check_paged_padded(gen))
    check_paged_padded(gen, F16_DIMS, (torch.float16,))
    worst = max(worst, check_paged_padded(gen, WIDE_DIMS, TYPES))
    check_mixed_types(gen)
    check_guard_columns(gen)
    check_guard_columns(gen, GUARD_WIDE_DIMS, TYPES)
    check_guard_columns(gen, (8, 80, 100, 255), (torch.float16,))

    # the serve shapes: full-width decode of each served arch, T ragged,
    # mixed lengths (qwen2.5-3b's is the one the kernels line reports), and
    # recurrentgemma-9b's head layout at D = 256 (its own decode goes
    # through the ring cache, not paged) over a cache of 2 x its window
    shapes = [paged_serve_shape(gen, arch) for arch in (ARCH,) + SLICE_ARCHS]
    rg = "recurrentgemma-9b"
    shapes.append(paged_serve_shape(
        gen, rg, prompt=2 * configs.get_config(rg).window_size))
    main = shapes[0]
    SERVE_SHAPES.extend(dict(kernel="paged_attention", **c) for c in shapes)
    return {"name": "paged_attention", "route": "cuda", "source": PAGED_SRC,
            "replaces": "src/repro/kernels/paged_attention.py:79",
            "launches": 0,
            "max_abs_err": max([worst] + [c["max_abs_err"] for c in shapes]),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"]}


# The two FMA bodies redesigned last, at every head size of the rule checks
# that runs them: flash's fma body (float32 at D 1-256; 16-bit rows of no
# whole 16-byte pieces and float8 where Dp is 16 or 32) in (B, Hq, Hkv, S,
# causal, window) cases taken in turn, and paged's wide body (D 257-1100 and
# 2048: float32 at each, bf16 at every third, e4m3 caches under a bf16 q at
# every fifth; the tensor-core body's head sizes skipped) at (B, Hq, Hkv, T,
# lengths) cases in turn, the second spread over 13 blocks (a two-level
# merge); above 2048 columns, where chunks of 2048 are a grid dimension
# (each its column offset, partials and tickets; the last of fewer
# pieces), at FMA_PAGED_CHUNKED in the three types at both cases; then at
# FMA_PAGED_LONG, whose 12000 rows give each of 132 blocks three chunks of
# rows of one segment (66 blocks a chunk of columns at 2304: six), so that
# a warp's accumulators of several pieces are rescaled between them (D
# 1024, 1100, 2048 and 2304 in fp32 and bf16)
FMA_FLASH_CASES = ((1, 4, 2, 130, True, 0), (2, 2, 1, 77, True, 33),
                   (1, 2, 2, 70, False, 0))
FMA_PAGED_CASES = ((2, 8, 1, 70, (70, 33)), (1, 8, 1, 400, (400,)))
FMA_PAGED_CHUNKED = (2304, 4352)       # 2 and 3 chunks, the last 1 piece
FMA_PAGED_LONG = (1, 8, 1, 12000, (12000,))
FMA_PAGED_TYPES = ((torch.float32, torch.float32, 1),
                   (torch.bfloat16, torch.bfloat16, 3),
                   (torch.bfloat16, torch.float8_e4m3fn, 5))


# flash's fma body above 256 columns (clusters of one CTA a 256-column
# piece, chunks of 2048 columns a grid dimension above): float32 at every
# third D from 257 to 1100 and at FMA_WIDE_DIMS (one cluster of 8; two and
# three chunks, the last of one piece), then (q's type, k's and v's, D):
# 16-bit rows of no whole 16-byte pieces, int8 and a mixed pair (float32
# copies); the (B, Hq, Hkv, S, causal, window) cases in turn
FMA_WIDE_DIMS = (2048, 2304, 4352)
FMA_WIDE_TYPED = ((torch.bfloat16, torch.bfloat16, 300),
                  (torch.bfloat16, torch.bfloat16, 500),
                  (torch.float16, torch.float16, 500),
                  (torch.int8, torch.int8, 512),
                  (torch.bfloat16, torch.float16, 512))
# the fma body's 64-row tiles at Dp 64 and 128 (`fma_rows`: fewer 128-row
# tiles than SMs), (B, Hq, Hkv, S, D, causal, window, type)
FMA_SMALL_GRID = ((2, 8, 2, 200, 64, True, 0, torch.int8),
                  (2, 8, 2, 200, 64, True, 0, torch.float32),
                  (2, 8, 2, 200, 128, True, 0, torch.float32),
                  (1, 4, 2, 130, 64, True, 33, torch.float32),
                  (1, 2, 1, 77, 128, False, 0, torch.float32),
                  (2, 8, 2, 200, 100, True, 48, torch.float32),
                  (1, 2, 2, 450, 37, True, 0, torch.float32))


def check_fma_flash(gen) -> float:
    """Flash's fma body against its plain version at every head size 1-256
    it takes (float32 at each; 16-bit rows of no whole 16-byte pieces and
    float8 at Dp 16 and 32), above 256 columns at every third D 257-1100,
    at FMA_WIDE_DIMS and FMA_WIDE_TYPED, and at FMA_SMALL_GRID (64-row
    tiles), in FMA_FLASH_CASES taken in turn: fp32 at FP32_TOL, 16-bit at
    its limit with the P term, float8 and integer outputs within one unit
    in the last place. Then the clusters the card holds at once and the
    body's time at the serve shape and at D512 beside the library; returns
    the worst fp32 error."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa, ref
    import torch.nn.functional as F

    def one(q_dtype, kv_dtype, d, case, label=""):
        b, hq, hkv, s, causal, window = case
        q = rand_typed(gen, (b, s, hq, d), q_dtype, Q_SCALE).transpose(1, 2)
        k = rand_typed(gen, (b, s, hkv, d), kv_dtype).transpose(1, 2)
        v = rand_typed(gen, (b, s, hkv, d), kv_dtype).transpose(1, 2)
        out = fa.flash_attention(q, k, v, causal=causal, window=window)
        name = (f"flash fma {tname(q_dtype)}"
                + ("" if kv_dtype == q_dtype else f" k, v {tname(kv_dtype)}")
                + f" B{b} Hq{hq} Hkv{hkv} S{s} D{d} causal{causal} "
                f"window{window}{label}")
        if q_dtype in FP8 or not q_dtype.is_floating_point:
            check_ulp(name, out, ref.attention_ref(q, k, v, causal, window),
                      quiet=True)
            return 0.0
        err = check_flash_out(name, out, q, k, v, causal, window, quiet=True)
        return err if q_dtype == torch.float32 else 0.0

    worst, n = 0.0, 0
    for d in range(1, 257):
        for dtype in (torch.float32, torch.bfloat16, torch.float16, *FP8):
            if fa.body_for(dtype, d) != "fma":
                continue
            b, hq, hkv, s, causal, window = FMA_FLASH_CASES[
                n % len(FMA_FLASH_CASES)]
            q, k, v = flash_case(gen, b, hq, hkv, s, d, dtype)
            out = fa.flash_attention(q, k, v, causal=causal, window=window)
            name = (f"flash fma {tname(dtype)} B{b} Hq{hq} Hkv{hkv} S{s} D{d}"
                    f" causal{causal} window{window}")
            if dtype in FP8:
                check_ulp(name, out, ref.attention_ref(q, k, v, causal,
                                                       window), quiet=True)
            else:
                err = check_flash_out(name, out, q, k, v, causal, window,
                                      quiet=True)
                if dtype == torch.float32:
                    worst = max(worst, err)
            n += 1
    torch.cuda.synchronize()
    log(f"  flash's fma body at D 1-256: {n} launches agree (float32 at "
        "every D, 16-bit and float8 where it takes them); worst fp32 error "
        f"{worst:.3e}")
    wide = [(torch.float32, torch.float32, d)
            for d in (*range(257, 1101, 3), *FMA_WIDE_DIMS)]
    for i, (q_dtype, kv_dtype, d) in enumerate(wide + list(FMA_WIDE_TYPED)):
        assert fa.body_for(q_dtype, d, kv_dtype) == "fma", (q_dtype, d)
        blocks = fa.wide_blocks(q_dtype, d, kv_dtype)
        worst = max(worst, one(q_dtype, kv_dtype, d,
                               FMA_FLASH_CASES[i % len(FMA_FLASH_CASES)],
                               f" ({blocks} CTAs a query tile)"))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for b, hq, hkv, s, d, causal, window, dtype in FMA_SMALL_GRID:
        rows = fa.fma_rows(dtype, d, b, hq, s, sms)
        worst = max(worst, one(dtype, dtype, d,
                               (b, hq, hkv, s, causal, window),
                               f" ({rows} rows a block)"))
    torch.cuda.synchronize()
    flash = _build.load("flash_attention")
    fa._bind()
    clusters = {c: flash.flash_attention_fma_clusters(c) for c in (2, 4, 8)}
    log(f"  flash's fma body above 256 columns (clusters of a CTA a "
        f"256-column piece): {len(wide) + len(FMA_WIDE_TYPED)} launches "
        f"agree (float32 at every third D 257-1100 and {FMA_WIDE_DIMS}; "
        f"{[(tname(a), tname(b), d) for a, b, d in FMA_WIDE_TYPED]}), and "
        f"{len(FMA_SMALL_GRID)} at 64-row tiles; worst fp32 error "
        f"{worst:.3e}; clusters the card holds at once (of n CTAs: SMs "
        "busy): " + ", ".join(f"n={c}: {k} ({c * k} of {sms})"
                              for c, k in clusters.items()))
    q, k, v = flash_case(gen, BATCH, 16, 2, PROMPT_LEN, 128, torch.float32)
    ms = time_ms([lambda: fa.flash_attention(q, k, v)], 10)
    lib = time_ms([lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True)], 10)
    bound = flash_bound(BATCH, 16, 2, PROMPT_LEN, 128, 0, torch.float32)[0]
    log(f"  flash fma fp32 B{BATCH} Hq16 Hkv2 S{PROMPT_LEN} D128 causal: "
        f"{ms:.4f} ms, SDPA fp32 {lib:.4f} ms, bound {bound:.5f} ms")
    del q, k, v
    q, k, v = flash_case(gen, BATCH, 16, 2, PROMPT_LEN, 512, torch.float32)
    ms = time_ms([lambda: fa.flash_attention(q, k, v)], 10)
    plain = time_ms([lambda: ref.attention_ref(q, k, v)], 3)
    lib = time_ms([lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True)], 5)
    bound = flash_bound(BATCH, 16, 2, PROMPT_LEN, 512, 0, torch.float32)[0]
    log(f"  flash fma fp32 B{BATCH} Hq16 Hkv2 S{PROMPT_LEN} D512 causal "
        f"(clusters of 2): {ms:.4f} ms, plain {plain:.4f} ms, SDPA fp32 "
        f"{lib:.4f} ms, bound {bound:.5f} ms")
    del q, k, v
    return worst


def check_fma_bodies(gen):
    """Flash's fma body (`check_fma_flash`) and paged's wide body against
    their plain versions at every head size of the rule checks that runs
    them (FMA_PAGED_CASES and FMA_PAGED_TYPES), fp32 at FP32_TOL, 16-bit at
    its limit, float8 caches within one unit in the last place; then the
    wide body's time at its largest shape."""
    from repro_torch.kernels import paged_attention as pa, ref

    worst = check_fma_flash(gen)
    m = 0
    for d in list(range(257, 1101)) + [2048]:
        for q_dtype, kv_dtype, step in FMA_PAGED_TYPES:
            if (d - 257) % step and d != 2048 or \
                    pa.products_on(q_dtype, kv_dtype, d) != "fma":
                continue
            b, hq, hkv, t, lens = FMA_PAGED_CASES[m % len(FMA_PAGED_CASES)]
            q = rand_typed(gen, (b, hq, d), q_dtype, Q_SCALE)
            kc = rand_typed(gen, (b, t, hkv, d), kv_dtype)
            vc = rand_typed(gen, (b, t, hkv, d), kv_dtype)
            lens = torch.tensor(lens, dtype=torch.int32, device="cuda")
            err = paged_out_check(
                f"paged wide q {tname(q_dtype)} caches {tname(kv_dtype)} "
                f"B{b} Hq{hq} Hkv{hkv} T{t} D{d} lengths {lens.tolist()}",
                pa.paged_attention(q, kc, vc, lens),
                ref.paged_attention_ref(q, kc, vc, lens))
            if q_dtype == torch.float32:
                worst = max(worst, err)
            m += 1
    for d in FMA_PAGED_CHUNKED:
        for q_dtype, kv_dtype, _ in FMA_PAGED_TYPES:
            for b, hq, hkv, t, lens in FMA_PAGED_CASES:
                q = rand_typed(gen, (b, hq, d), q_dtype, Q_SCALE)
                kc = rand_typed(gen, (b, t, hkv, d), kv_dtype)
                vc = rand_typed(gen, (b, t, hkv, d), kv_dtype)
                lens = torch.tensor(lens, dtype=torch.int32, device="cuda")
                plan = pa.launch_plan(q, kc)
                err = paged_out_check(
                    f"paged wide q {tname(q_dtype)} caches {tname(kv_dtype)} "
                    f"B{b} Hq{hq} Hkv{hkv} T{t} D{d} lengths {lens.tolist()}"
                    f" ({plan.chunks} chunks of {plan.blocks} blocks)",
                    pa.paged_attention(q, kc, vc, lens),
                    ref.paged_attention_ref(q, kc, vc, lens))
                if q_dtype == torch.float32:
                    worst = max(worst, err)
                m += 1
    b, hq, hkv, t, lens = FMA_PAGED_LONG
    lens = torch.tensor(lens, dtype=torch.int32, device="cuda")
    for d in (1024, 1100, 2048, 2304):
        for dtype in (torch.float32, torch.bfloat16):
            q, kc, vc = paged_case(gen, b, hq, hkv, t, d, dtype)
            err = paged_out_check(
                f"paged wide {tname(dtype)} B{b} Hq{hq} Hkv{hkv} T{t} D{d} "
                f"lengths {lens.tolist()} (several chunks a block)",
                pa.paged_attention(q, kc, vc, lens),
                ref.paged_attention_ref(q, kc, vc, lens))
            if dtype == torch.float32:
                worst = max(worst, err)
            m += 1
            del q, kc, vc
    torch.cuda.synchronize()
    log(f"  paged's wide body at D 257-1100, 2048 and {FMA_PAGED_CHUNKED} "
        f"(chunks of 2048 columns): {m} launches agree (float32, bf16, e4m3 "
        f"caches under bf16; and T{t} in one segment, several chunks of rows "
        f"a block); worst fp32 error {worst:.3e}")
    t = PROMPT_LEN + MAX_NEW
    lens = torch.tensor([t, t - 31, (t + 2) // 2, 64], dtype=torch.int32,
                        device="cuda")
    x = paged_case(gen, BATCH, 16, 2, t, 2048, torch.bfloat16)
    ms = time_ms([lambda: pa.paged_attention(*x, lens)], 20)
    log(f"  paged wide bf16 B{BATCH} Hq16 Hkv2 T{t} D2048 lengths "
        f"{lens.tolist()}: {ms:.4f} ms, bound "
        f"{paged_bound(lens, 16, 2, 2048, torch.bfloat16)[0]:.5f} ms")
    return worst


# paged's tensor-core body over the whole head above 256 columns (16-bit
# rows of whole 16-byte pieces up to 512): head sizes, and (B, Hq, Hkv, T,
# lengths) cases: qwen2.5-3b's decode layout and serve lengths, one query
# head a KV head, 16 (two segments of 8 a KV head), lengths 0, 1, 32, 33, T
WIDE_MMA_DIMS = (264, 272, 320, 384, 448, 504, 512)
WIDE_MMA_CASES = ((4, 16, 2, 1032, (1032, 1001, 517, 64)),
                  (3, 4, 4, 129, (0, 1, 129)), (1, 32, 2, 700, (700,)),
                  (2, 8, 1, 33, (33, 32)))


def check_wide_mma(gen):
    """Paged's tensor-core body over the whole head (256 < D <= 512, bf16
    and f16 under their own q: `products_on` "mma", one chunk) against the
    plain version within PAGED_BF16_TOL / PAGED_F16_TOL at WIDE_MMA_DIMS x
    WIDE_MMA_CASES, the guard columns at D 264 and 504, then its time at
    qwen2.5-3b's decode layout at D 512 beside the plain version and SDPA
    (8 caches in turn)."""
    import torch.nn.functional as F
    from repro_torch.kernels import paged_attention as pa, ref

    log(f"paged's tensor-core body over the whole head at D {WIDE_MMA_DIMS} "
        f"x {len(WIDE_MMA_CASES)} cases in bf16 and f16")
    for dtype in (torch.bfloat16, torch.float16):
        for d in WIDE_MMA_DIMS:
            for (b, hq, hkv, t, lens) in WIDE_MMA_CASES:
                q, kc, vc = paged_case(gen, b, hq, hkv, t, d, dtype)
                plan = pa.launch_plan(q, kc)
                where = pa.products_on(dtype, dtype, d, hq, hkv)
                if where != "mma" or plan.chunks != 1:
                    raise AssertionError(
                        f"paged {tname(dtype)} D{d} Hq{hq} Hkv{hkv}: "
                        f"{where}, {plan.chunks} chunks, not the tensor-core "
                        "body over the whole head ... FAIL")
                lens = torch.tensor(lens, dtype=torch.int32, device="cuda")
                check_close(f"{tname(dtype)} B{b} Hq{hq} Hkv{hkv} T{t} D{d} "
                            f"lengths {lens.tolist()} (mma, whole head)",
                            pa.paged_attention(q, kc, vc, lens),
                            ref.paged_attention_ref(q, kc, vc, lens),
                            quiet=True, **paged_tol(dtype))
    log("  agree")
    check_guard_columns(gen, (264, 504), (torch.bfloat16, torch.float16))
    t = PROMPT_LEN + MAX_NEW
    lens = torch.tensor([t, t - 31, (t + 2) // 2, 64], dtype=torch.int32,
                        device="cuda")
    mask = (torch.arange(t, device="cuda")[None, :]
            < lens[:, None])[:, None, None, :]
    for dtype in (torch.bfloat16, torch.float16):
        sets = [paged_case(gen, BATCH, 16, 2, t, 512, dtype)
                for _ in range(8)]
        ms = time_ms([lambda x=x: pa.paged_attention(*x, lens)
                      for x in sets], 64)
        lib = time_ms([lambda x=x: F.scaled_dot_product_attention(
            x[0][:, :, None], x[1].transpose(1, 2), x[2].transpose(1, 2),
            attn_mask=mask, enable_gqa=True) for x in sets], 64)
        plain = time_ms([lambda: ref.paged_attention_ref(*sets[0], lens)],
                        2, repeats=3)
        bound = paged_bound(lens, 16, 2, 512, dtype)[0]
        log(f"  B{BATCH} Hq16 Hkv2 T{t} D512 {tname(dtype)}: kernel {ms:.4f} "
            f"ms, plain {plain:.4f} ms, SDPA {lib:.4f} ms, bound {bound:.5f} "
            "ms")
        del sets
    free_cuda()


# the scatter's 8-bit integer and fp8 add (`cas_rows`): row widths in
# elements (64, 6, 3 and 1 bytes) and where the updates go
CAS_WIDTHS = (64, 6, 3, 1)
CAS_SPREADS = ("uniform", "a quarter hot", "one row")


def check_cas_batches(gen):
    """The scatter's 8-bit integer and fp8 add (batched compare-and-swaps)
    against the plain version: int8 / uint8 bit for bit, e4m3 / e5m2
    within `ref.scatter_add16_limit` (`check_scatter16`), into [2^20, w]
    at CAS_WIDTHS: 2^18 updates uniform and with a quarter into 4096 hot
    rows, and 4096 into one row; rows narrower than a sector also down
    the other path than the rule's (`launch_plan(..., bucket=...)`); rows
    of 16-byte units swap a unit at once (the plan's chunk 16), but on a
    table that starts on no 16 bytes a word (chunk 1)."""
    from repro_torch.kernels import async_scatter as asc, ref

    n, m = 1 << 20, 1 << 18
    log(f"scatter add by batched compare-and-swaps: int8, uint8, e4m3, e5m2 "
        f"into [{n}, w], w {CAS_WIDTHS} (64 also on a table 4 bytes past 16: "
        f"a word a CAS), {CAS_SPREADS}")
    runs = 0
    for dtype in (torch.int8, torch.uint8, *FP8):
        for w, off in [(w, 0) for w in CAS_WIDTHS] + [(64, 4)]:
            for spread in CAS_SPREADS:      # (off: the table's bytes past 16)
                table = rand_typed(gen, (n * w + off,), dtype)[off:].view(n, w)
                idx = amu_index(gen, n, m if spread != "one row" else 4096)
                if spread == "a quarter hot":
                    idx[::4] %= 4096
                elif spread == "one row":
                    idx.fill_(1234)
                upd = rand_typed(gen, (idx.numel(), w), dtype)
                plans = [asc.launch_plan(table, idx.numel(), "add")]
                if plans[0].chunk != (asc.CAS_UNIT if w % asc.CAS_UNIT == 0
                                      and table.data_ptr() % asc.CAS_UNIT
                                      == 0 else 1):
                    raise AssertionError(f"scatter add {tname(dtype)} "
                                         f"[{n},{w}]: chunk "
                                         f"{plans[0].chunk} ... FAIL")
                if w < asc.SECTOR:
                    plans.append(asc.launch_plan(table, idx.numel(), "add",
                                                 bucket=not plans[0].bucket))
                want = (None if dtype in FP8
                        else ref.scatter_update_ref(table, idx, upd, "add"))
                for plan in plans:
                    got = asc.launch(table.clone(), idx, upd, "add", plan)
                    name = (f"scatter add {tname(dtype)} [{n},{w}]"
                            f"{f', {off} bytes in' if off else ''}, "
                            f"{idx.numel()} updates {spread}"
                            f"{', bucketed' if plan.bucket else ''}")
                    if want is None:
                        check_scatter16(name, got, table, idx, upd)
                    else:
                        check_same(name, got, want, quiet=True)
                    runs += 1
                del table, idx, upd, want
    free_cuda()
    log(f"  {runs} runs: int8 / uint8 bit-exact, fp8 within its limit")


def paged_serve_shape(gen, arch, prompt=PROMPT_LEN) -> dict:
    """Paged at one arch's full-width decode (B=4, T = prompt + 32,
    lengths [T, prompt + 1, (T + 2) // 2, 64], bf16; at the default prompt
    [1032, 1001, 517, 64]) over 16 rotating caches, so that a call finds its
    cache cold as a decode step does: held against the plain version and
    the library call, timed beside both and its bound."""
    from repro_torch import configs
    from repro_torch.kernels import paged_attention as pa, ref
    import torch.nn.functional as F

    cfg = configs.get_config(arch)
    b, hq, hkv, t, d = (BATCH, cfg.num_heads, cfg.num_kv_heads,
                        prompt + MAX_NEW, cfg.resolved_head_dim)
    lens = torch.tensor([t, prompt + 1, (t + 2) // 2, 64], dtype=torch.int32,
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
    lengths, the bodies' head sizes and any other from 1 to 256, and both
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
        d = rnd.choice([16, 32, 64, 128, 256, rnd.randint(1, 256)])
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


def amu_table(gen, shape, dtype):
    """Random table on the card: int32 in [0, 2^30), int8 in [-128, 128),
    floats N(0, 1)."""
    if dtype == torch.int32:
        return torch.randint(0, 1 << 30, shape, generator=gen, device="cuda",
                             dtype=torch.int32)
    if dtype == torch.int8:
        return torch.randint(-128, 128, shape, generator=gen, device="cuda",
                             dtype=torch.int8)
    return torch.randn(shape, generator=gen, device="cuda", dtype=dtype)


def check_scatter16(name, got, table, idx, upd, raise_=True) -> bool:
    """A bf16 / f16 / float8 scatter-add against the plain version: within
    `ref.scatter_add16_limit` (two orders of rounded adds) on the rows the
    updates hit, bit for bit on the others. Works on the touched rows only,
    so that a large table needs no float32 copy of itself."""
    from repro_torch.kernels import ref
    rows, inv = torch.unique(idx, return_inverse=True)
    touched = ref.gather_ref(table, rows)
    want = ref.scatter_update_ref(touched, inv.to(torch.int32), upd)
    limit = ref.scatter_add16_limit(touched, inv.to(torch.int32), upd)
    err = (ref.gather_ref(got, rows).float() - want.float()).abs()
    ratio = float((err / limit.clamp(min=1e-30)).max())
    ok = bool((err <= limit).all())
    mask = torch.ones(table.shape[0], dtype=torch.bool, device=table.device)
    mask[rows.long()] = False
    ok = ok and bool(torch.equal(bits(got)[mask], bits(table)[mask]))
    log(f"  {name}: max abs err {float(err.max()):.3e}, {ratio:.2f} of the "
        f"limit (2 c u (1 + u)^c (|t| + sum |u_j|)), untouched rows equal "
        f"{'ok' if ok else 'FAIL'}")
    if not ok and raise_:
        raise AssertionError(f"{name}: disagrees with its plain version")
    return ok


# What the untouched neighbours of a 16-bit row hold in
# `check_scatter16_neighbours`: -0.0 and +0.0, NaNs of several payloads
# (quiet and signalling, either sign), the infinities and subnormals, as bits
NEIGHBOUR_BITS = {
    torch.bfloat16: (0x8000, 0x0000, 0x7FC0, 0x7FC1, 0x7FFF, 0xFFFF, 0x7F81,
                     0xFFA5, 0x7F80, 0xFF80, 0x0001, 0x8001),
    torch.float16: (0x8000, 0x0000, 0x7E00, 0x7E01, 0x7FFF, 0xFFFF, 0x7C01,
                    0xFCA5, 0x7C00, 0xFC00, 0x0001, 0x8001)}


def check_scatter16_neighbours(gen, raise_=True) -> bool:
    """bf16 / f16 add into rows of 1, 3 and 5 elements (2, 6 and 10 bytes)
    where only the rows of one parity are hit: each aligned word the path
    reduces that holds one element of a hit row holds one of a row never
    hit (its low half for odd rows, its high half for even ones), filled
    with NEIGHBOUR_BITS; 50000 updates into 4096 rows, and 2^25 into 2^28
    rows of 3 elements, there down the rule's path and on a bucketed plan
    (`async_scatter.launch`). Those rows must keep their bits and the
    hit rows stay within
    `ref.scatter_add16_limit` (`check_scatter16`). True if every case
    passed."""
    from repro_torch.kernels import async_scatter as asc
    ok = True
    sizes = [(4096, 50000, w) for w in (1, 3, 5)] + [(1 << 28, 1 << 25, 3)]
    for dtype, pattern in NEIGHBOUR_BITS.items():
        pat = torch.tensor([b - (1 << 16) if b >= 1 << 15 else b
                            for b in pattern], dtype=torch.int16,
                           device="cuda")
        for (n, m, w), parity in ((x, p) for x in sizes for p in (0, 1)):
            table = rand_typed(gen, (n, w), dtype)
            other = torch.arange(1 - parity, n, 2, device="cuda")
            fill = pat[torch.arange(other.numel() * w, device="cuda")
                       % pat.numel()].view(-1, w)
            bits(table)[other] = fill
            idx = (parity + 2 * torch.randint(
                0, n // 2, (m,), generator=gen, device="cuda")).to(torch.int32)
            upd = rand_typed(gen, (m, w), dtype)
            runs = [(asc.bucketed(2 * w, n, m),
                     asc.async_scatter(table.clone(), idx, upd))]
            if m >= 1 << 25 and not runs[0][0]:
                plan = asc.launch_plan(table, m, bucket=True)
                runs.append((True, asc.launch(table.clone(), idx, upd, "add",
                                              plan)))
            for on, got in runs:
                ok = check_scatter16(
                    f"scatter add {tname(dtype)} [{n},{w}], {m} updates "
                    f"({'' if on else 'not '}bucketed) into the "
                    f"{'odd' if parity else 'even'} rows, the others holding "
                    "-0.0, NaN payloads, inf, subnormals", got, table, idx,
                    upd, raise_=raise_) and ok
            del table, other, fill, idx, upd, runs
            free_cuda()
    return ok


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
        for dtype in (torch.float32, torch.bfloat16, torch.int32,
                      torch.int8):          # bf16 and int8 at D = 3: element
            table = amu_table(gen, (n, d), dtype)
            idx = amu_index(gen, n, m)
            check_same(f"{str(dtype)[6:]} N{n} D{d} M{m} block_m{bm} K{k}",
                        ag.async_gather(table, idx, block_m=bm, num_slots=k),
                        ref.gather_ref(table, idx))

    log("async_gather paths: bulk copies for rows of a multiple of 16 bytes "
        "on a 16-byte aligned table, cp.async chunks for other rows of whole "
        "4-byte words, a copy by element for the rest; bit-exact")
    for (n, d, dtype, offset, path) in [
            (1000, 128, torch.float32, 0, "bulk"),      # 512-byte rows
            (3000, 2048, torch.bfloat16, 0, "bulk"),    # 4 KB rows
            (1000, 128, torch.float32, 16, "bulk"),     # table 16 bytes in
            (1000, 128, torch.float32, 4, "cp.async"),  # table 4 bytes in
            (1000, 2, torch.float32, 0, "cp.async"),    # 8-byte rows
            (1000, 3, torch.bfloat16, 0, "element"),    # 6-byte rows
            (1000, 3, torch.int8, 0, "element"),        # 3-byte rows
            (1000, 1, torch.int8, 0, "element"),        # 1-byte rows
            (1000, 2047, torch.bfloat16, 0, "element"),  # 4094-byte rows
            (1000, 128, torch.bfloat16, 2, "element")]:  # table 2 bytes in
        flat = amu_table(gen, (n * d + 16,), dtype)
        first = offset // flat.element_size()
        table = flat[first:first + n * d].view(n, d)
        for m in (1, 7, 131, 4000):
            idx = amu_index(gen, n, m)
            plan = ag.launch_plan(table, m)
            got_path = ("bulk" if plan.bulk else "cp.async"
                        if plan.chunk >= 4 else "element")
            what = (f"{str(dtype)[6:]} rows of {d * flat.element_size()} B, "
                    f"table +{offset} B, M{m}: {plan.blocks} blocks of "
                    f"{plan.rows} rows, {plan.warps} warps, {got_path} "
                    f"{plan.chunk} B")
            if got_path != path:
                raise AssertionError(f"{what}: want the {path} path")
            want = ref.gather_ref(table, idx)
            check_same(what, ag.async_gather(table, idx), want,
                        quiet=m != 4000)
            for bm, k in ((1, 1), (16, 3), (64, 32)):   # block_m: a bound
                check_same(f"{what}, block_m {bm} K{k}", ag.async_gather(
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
            check_same(f"i32 {op} N{n} D{d} M{m} block_m{bm} K{k}",
                        asc.async_scatter(table, idx, upd, op, block_m=bm,
                                          num_slots=k), want)
    # tests/test_kernels.py::test_async_scatter_xor_gups
    table = amu_table(gen, (32, 8), torch.int32)
    idx = amu_index(gen, 32, 256)
    upd = amu_table(gen, (256, 8), torch.int32)
    check_same("xor GUPS N32 D8 M256 (8 updates a row)",
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

    log("async_scatter in 16-bit floats (add, within ref.scatter_add16_limit) "
        "and uint32 (add and xor on an int32 view, bit-exact)")
    for (n, d, m) in [(64, 128, 256), (8, 128, 64), (16, 8, 128),
                      (1000, 2, 1000), (77, 4, 333), (1 << 16, 64, 1 << 14)]:
        idx = amu_index(gen, n, m)
        for dtype in (torch.bfloat16, torch.float16):
            table = amu_table(gen, (n, d), dtype)
            upd = amu_table(gen, (m, d), dtype)
            check_scatter16(f"{tname(dtype)} add N{n} D{d} M{m}",
                            asc.async_scatter(table.clone(), idx, upd, "add"),
                            table, idx, upd)
        for op in ("add", "xor"):
            table = amu_table(gen, (n, d), torch.int32).view(torch.uint32)
            upd = amu_table(gen, (m, d), torch.int32).view(torch.uint32)
            got = asc.async_scatter(table.clone(), idx, upd, op)
            if got.dtype != torch.uint32:
                raise AssertionError(f"uint32 {op}: got {got.dtype}")
            check_same(f"uint32 {op} N{n} D{d} M{m}", got.view(torch.int32),
                        ref.scatter_update_ref(table.view(torch.int32), idx,
                                               upd.view(torch.int32), op),
                        quiet=True)
    log("  16-bit add within its limit, uint32 add and xor bit-exact")

    log("stream_triad vs ref.triad_ref: f32 atol=rtol=1e-6, bf16 and f16 "
        "bit-exact")
    triad_worst = 0.0
    for (n, block) in [(4096, 512), (8192, 1024), (512, 512), (1003, 512)]:
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            b, c = randn(gen, (n,), dtype), randn(gen, (n,), dtype)
            got = st.stream_triad(b, c, 3.0, block=block)
            name = f"{str(dtype)[6:]} N{n} block{block}"
            if dtype == torch.float32:
                triad_worst = max(triad_worst, check_close(
                    name, got, ref.triad_ref(b, c, 3.0), **TRIAD_TOL[dtype]))
            else:
                check_same(name, got, ref.triad_ref(b, c, 3.0))
    for n in (1, 3, 7, 4097, (1 << 20) + 5):     # bulk steps and the tail
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            b, c = randn(gen, (n,), dtype), randn(gen, (n,), dtype)
            got, want = st.stream_triad(b, c, 3.0), ref.triad_ref(b, c, 3.0)
            if dtype == torch.float32:
                triad_worst = max(triad_worst, check_close(
                    f"f32 N{n}", got, want, quiet=True, **TRIAD_TOL[dtype]))
            else:
                check_same(f"{str(dtype)[6:]} N{n}", got, want, quiet=True)
    log("  N = 1, 3, 7, 4097, 2^20 + 5 agree in the three types")
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
        ("async_scatter, xor on float8_e4m3fn", TypeError,
         lambda: asc.async_scatter(zeros(4, 3, dtype=torch.float8_e4m3fn),
                                   amu_index(gen, 4, 3),
                                   zeros(3, 3, dtype=torch.float8_e4m3fn),
                                   "xor")),
        ("async_scatter, int8 table 1 byte off 4 bytes", ValueError,
         lambda: asc.async_scatter(zeros(5, 4, dtype=torch.int8)
                                   .view(-1)[1:17].view(4, 4),
                                   amu_index(gen, 4, 3),
                                   zeros(3, 4, dtype=torch.int8))),
        ("async_scatter, xor on float32", TypeError,
         lambda: asc.async_scatter(zeros(4, 4), amu_index(gen, 4, 3),
                                   zeros(3, 4), "xor")),
        ("stream_triad, int64", TypeError,
         lambda: st.stream_triad(zeros(8, dtype=torch.int64),
                                 zeros(8, dtype=torch.int64), 1.0)),
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


def bits(t):
    """t's bits as an integer tensor of its width: what torch compares on
    the card for every type (it lacks uint16's comparisons)."""
    return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32}[
        t.element_size()])


def check_same(name, got, want, quiet=False) -> float:
    """Bit-exact agreement of any type; floats (float8 too) compared as
    values with NaN where the other is NaN."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name}: {tuple(got.shape)} {got.dtype} != "
                             f"{tuple(want.shape)} {want.dtype}")
    if got.is_floating_point():
        g, w = got.float(), want.float()
        gn, wn = torch.isnan(g), torch.isnan(w)
        bad = (gn != wn) | (~wn & (g != w))
    else:
        bad = bits(got) != bits(want)
    nbad = int(bad.sum())
    if nbad:
        log(f"  {name}: {nbad} of {got.numel()} elements differ FAIL")
        raise AssertionError(f"{name}: {nbad} of {got.numel()} elements "
                             "differ from the plain version (want bit-exact)")
    if not quiet:
        log(f"  {name}: bit-exact ok")
    return 0.0


def check_ulp(name, got, want, quiet=False, extra=None) -> float:
    """Within one unit in the last place of the output's type at the larger
    magnitude (1 for integers), NaN where the other is NaN: the kernel and
    the plain version compute in fp32 in other orders and round once.
    `extra` (elementwise, absolute) adds what a body rounds besides: flash's
    tensor-core body for fp8 rounds P to f16, as its f16 body does, which
    moves a sum p v by up to 2^-11 sum p |v| (FLASH_F16_TOL's ptol times
    `flash_spread`), beyond fp8's finest steps near 0 in e5m2."""
    g, w = got.float(), want.float()
    if got.is_floating_point():
        fi = torch.finfo(got.dtype)
        mag = torch.maximum(g.abs(), w.abs()).clamp(min=fi.tiny)
        step = torch.exp2(torch.floor(torch.log2(mag))) * fi.eps
    else:
        step = torch.ones_like(g)
    if extra is not None:
        step = step + extra
    gn, wn = torch.isnan(g), torch.isnan(w)
    err = torch.where(wn | gn, torch.zeros_like(g), (g - w).abs())
    step = torch.where(wn | gn, torch.ones_like(step), step)
    ok = bool((gn == wn).all()) and bool((err <= step).all())
    worst = float(err.max())
    if not (ok and quiet):
        log(f"  {name}: max abs err {worst:.3e}, {float((err / step).max()):.2f}"
            f" of one unit in the last place {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: more than one unit in the last place "
                             "from its plain version")
    return worst


def fp8_p_term(q, k, v, body, causal=True, window=0):
    """`check_ulp`'s extra term for flash in fp8: the f16 P of its wgmma
    bodies, the TMA body (Q K^T on the fp8 wgmma, P V in f16 on V converted
    by its producer warpgroup) and the element loader's (f16 throughout);
    none for the fma body, fp32 throughout."""
    if body not in ("wgmma", "wgmma_elem"):
        return None
    return FLASH_F16_TOL["ptol"] * flash_spread(q, k, v, causal, window)


def rand_typed(gen, shape, dtype, scale=1.0):
    """Seeded values of any type on the card: floats N(0, scale^2) in the
    type (float8 by `ref.to_fp8`: past its range NaN or inf), integers
    uniform over the whole type."""
    from repro_torch.kernels import ref
    if dtype.is_floating_point:
        x = torch.randn(shape, generator=gen, device="cuda") * scale
        return ref.from_float(x, dtype)
    signed = {torch.uint16: torch.int16, torch.uint32: torch.int32}.get(
        dtype, dtype)
    info = torch.iinfo(signed)
    x = torch.randint(info.min, info.max + 1, shape, generator=gen,
                      device="cuda", dtype=torch.int64)
    return x.to(signed).view(dtype)


def check_every_type(gen):
    """The inputs the port took last, each against its plain version:
    float8 conversions at their edges (e4m3fn 500 -> NaN, e5m2 61440 ->
    inf) and an integer triad's scalar saturated on the card; the triad in
    bf16, f16, both float8 and the six integer types (N = 1003 and 2^20 +
    5, also with inputs past the type's range), bit-exact; scatter add and
    xor of 8/16-bit integers at rows of 1, 3 and 64 elements, float8 add at
    3 and 64, bf16 / f16 add at 1, 3 and 5 (the word path: CAS loops, xor
    words with zero bytes, pair reductions with -0.0 beside a lone 16-bit
    element, `check_scatter16_neighbours`), 50000 updates into
    3000 rows and every update into one row; the gather of float8 rows;
    flash in float8 at D 8, 33, 64, 72, 80, 98, 100, 128, 200, 256 (fma,
    the f16-converted wgmma body and the element loader's, with loads of 1,
    2, 4 and 8 bytes; their f16 P adds `fp8_p_term`) and int8 once (its
    float32 copies),
    paged with float8 caches at D 8, 100, 128, within one unit in the
    output type's last place, and bf16 q over e4m3 caches at bf16's limit
    (PAGED_BF16_TOL: a bf16 output near 0 is finer than the fp32 sums'
    order)."""
    from repro_torch.kernels import async_gather as ag
    from repro_torch.kernels import async_scatter as asc
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref
    from repro_torch.kernels import stream_triad as st

    log("every input type: float8, 8- and 16-bit integers, any row width")
    nan, inf = float("nan"), float("inf")
    edges = {torch.float8_e4m3fn: ([52.0, 16.0, -52.0], [448.0, 448.0,
                                                         -448.0],
                                   [nan, 448.0, nan]),
             torch.float8_e5m2: ([4096.0, 2048.0, -4096.0],
                                 [57344.0, 57344.0, -57344.0],
                                 [inf, 57344.0, -inf])}
    for dtype, (b, c, want) in edges.items():
        b = torch.tensor(b * 341, device="cuda").to(dtype)     # 1023 long
        c = torch.tensor(c * 341, device="cuda").to(dtype)
        a = st.stream_triad(b, c, 1.0)
        check_same(f"triad {tname(dtype)} at its range's edge", a,
                   ref.triad_ref(b, c, 1.0), quiet=True)
        got = a.float()[:3].tolist()
        if not all(g == w or (g != g and w != w) for g, w in zip(got, want)):
            raise AssertionError(f"triad {tname(dtype)}: b + c = {got}, "
                                 f"want {want} (no saturation) ... FAIL")
    for dtype, s, want in ((torch.int8, 300.0, 127), (torch.uint8, -1.5, 0),
                           (torch.int32, 1e10, 2 ** 31 - 1)):
        b = torch.zeros(1003, dtype=dtype, device="cuda")
        c = torch.ones(1003, dtype=dtype, device="cuda")
        got = int(st.stream_triad(b, c, s)[0])
        if got != want:
            raise AssertionError(f"triad {tname(dtype)} s={s}: {got}, want "
                                 f"{want} (toward zero, saturated) ... FAIL")
    log("  float8 sums past the range: e4m3fn 500 -> NaN, 464 -> 448; e5m2 "
        "61440 -> inf, 59392 -> 57344; integer scalars 300 -> 127 (int8), "
        "-1.5 -> 0 (uint8), 1e10 -> 2^31 - 1 (int32) ok")

    types = (torch.bfloat16, torch.float16, *FP8, *SMALL_INTS, torch.int32,
             torch.uint32)
    for dtype in types:
        for n in (1003, (1 << 20) + 5):
            for wide in (False, True):
                scale = OVERFLOW_SCALE.get(dtype, 1.0) if wide else 4.0
                b = rand_typed(gen, (n,), dtype, scale)
                c = rand_typed(gen, (n,), dtype, scale)
                check_same(f"triad {tname(dtype)} N{n} scale {scale:g}",
                           st.stream_triad(b, c, 3.3),
                           ref.triad_ref(b, c, 3.3), quiet=True)
    log(f"  triad bit-exact in {', '.join(map(tname, types))} at N 1003 and "
        "2^20 + 5, with and without overflow")

    n, m = 3000, 50000
    cases = [(t, op, d) for t in SMALL_INTS for op in ("add", "xor")
             for d in (1, 3, 64)]
    cases += [(t, "add", d) for t in FP8 for d in (3, 64)]
    cases += [(t, "add", d) for t in (torch.bfloat16, torch.float16)
              for d in (1, 3, 5)]
    for dtype, op, d in cases:
        for hot in (False, True):
            if hot and not (d == 3 and op == "add"):
                continue
            table = rand_typed(gen, (n, d), dtype)
            idx = amu_index(gen, n, m if not hot else 4096)
            if hot:                                  # every update, one row
                idx = torch.full_like(idx, 1234)
            upd = rand_typed(gen, (idx.numel(), d), dtype)
            got = asc.async_scatter(table.clone(), idx, upd, op)
            name = (f"scatter {op} {tname(dtype)} [{n},{d}], {idx.numel()} "
                    f"updates{' into one row' if hot else ''}")
            if dtype.is_floating_point:
                check_scatter16(name, got, table, idx, upd)
            else:
                check_same(name, got, ref.scatter_update_ref(table, idx, upd,
                                                             op), quiet=True)
    log(f"  scatter: {len(cases)} (type, op, width) cases and 4 hot rows: "
        "integers bit-exact, float8 / 16-bit within their limit")
    check_scatter16_neighbours(gen)

    for d in (3, 64):
        table = rand_typed(gen, (5000, d), torch.float8_e4m3fn)
        idx = amu_index(gen, 5000, 3001)
        check_same(f"gather float8_e4m3fn [5000,{d}]",
                   ag.async_gather(table, idx), ref.gather_ref(table, idx))

    for dtype in FP8:
        for d in (8, 33, 64, 72, 80, 98, 100, 128, 200, 256):
            q = rand_typed(gen, (2, 200, 8, d), dtype, Q_SCALE).transpose(1, 2)
            k = rand_typed(gen, (2, 200, 2, d), dtype).transpose(1, 2)
            v = rand_typed(gen, (2, 200, 2, d), dtype).transpose(1, 2)
            body = fa.body_for(dtype, d)
            check_ulp(f"flash {tname(dtype)} D{d} ({body} body)",
                      fa.flash_attention(q, k, v), ref.attention_ref(q, k, v),
                      extra=fp8_p_term(q, k, v, body))
            pq = rand_typed(gen, (4, 16, d), dtype, Q_SCALE)
            kc = rand_typed(gen, (4, 333, 2, d), dtype)
            vc = rand_typed(gen, (4, 333, 2, d), dtype)
            lens = torch.tensor([0, 1, 200, 333], dtype=torch.int32,
                                device="cuda")
            check_ulp(f"paged {tname(dtype)} caches D{d} "
                      f"({pa.body_for(dtype, d)} body)",
                      pa.paged_attention(pq, kc, vc, lens),
                      ref.paged_attention_ref(pq, kc, vc, lens))
            if dtype == torch.float8_e4m3fn:     # a bf16 output: its limit
                bq = pq.to(torch.bfloat16)
                check_close(f"paged bf16 q, {tname(dtype)} caches D{d}",
                            pa.paged_attention(bq, kc, vc, lens),
                            ref.paged_attention_ref(bq, kc, vc, lens),
                            **PAGED_BF16_TOL)
    qi = torch.randint(-3, 4, (2, 8, 200, 64), generator=gen, device="cuda",
                       dtype=torch.int8)
    ki = torch.randint(-3, 4, (2, 2, 200, 64), generator=gen, device="cuda",
                       dtype=torch.int8)
    vi = ki.flip(2)
    err = check_ulp("flash int8 D64 (float32 copies)",
                    fa.flash_attention(qi, ki, vi),
                    ref.attention_ref(qi, ki, vi))
    # timed beside SDPA on float32 copies and the bound of its int8 inputs
    import torch.nn.functional as F
    qf, kf, vf = (x.float() for x in (qi, ki, vi))
    ms = time_ms([lambda: fa.flash_attention(qi, ki, vi)], 20)
    plain_ms = time_ms([lambda: ref.attention_ref(qi, ki, vi)], 10)
    library_ms = time_ms([lambda: F.scaled_dot_product_attention(
        qf, kf, vf, is_causal=True, enable_gqa=True)], 20)
    bound_ms, bound_by = flash_bound(2, 8, 2, 200, 64, 0, torch.int8)
    log(f"  flash int8 B2 Hq8 Hkv2 S200 D64: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, library on float32 copies {library_ms:.4f} ms, "
        f"bound {bound_ms:.5f} ms ({bound_by})")
    SERVE_SHAPES.append(dict(
        kernel="flash_attention", shape="B2 Hq8 Hkv2 S200 D64 int8",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
        library="sdpa on float32 copies", bound_ms=bound_ms,
        bound_by=bound_by))
    torch.cuda.synchronize()


PAGED_MMA_DIMS = (48, 64, 80, 128, 144, 256)   # Dp 64, 64, 128, 128, 256, 256
PAGED_Q_TYPES = (*FP8, torch.bfloat16, torch.float16)


def paged_out_check(name, got, want, extra_tol=None):
    """Paged's output against its plain version in the output's type: one
    unit in the last place of float8, PAGED_BF16_TOL / PAGED_F16_TOL of
    16 bits, FP32_TOL of float32."""
    if got.dtype in FP8:
        return check_ulp(name, got, want, quiet=True)
    tol = {torch.bfloat16: PAGED_BF16_TOL, torch.float16: PAGED_F16_TOL,
           torch.float32: FP32_TOL}[got.dtype]
    return check_close(name, got, want, quiet=True, **tol)


def check_paged_fp8(gen):
    """Paged over float8 caches, whose q is read and output written in q's
    own type: the rule of where the products run (`products_on` against the
    source's `paged_attention_products`, every q / cache pair of the float
    types and int8 at D 1-600); the tensor-core bodies at D 48, 64, 80,
    128, 144 and 256 (Dp 64, 128, 256; TMA rows) for q in e4m3, e5m2, bf16
    and f16 over caches of both kinds, lengths 0, 1, 31, 32, 33, 200 and T,
    GQA groups 8, 3 and 16, each within one unit in the last place of a
    float8 output and PAGED_BF16_TOL / PAGED_F16_TOL of a 16-bit one; an
    fp32 and an int8 q over e4m3 caches (FMAs; int8 through float32);
    outputs past e4m3's range (an e4m3 q over e5m2 caches of values near
    1000: NaN, as `to_fp8` gives them, not 448)."""
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import paged_attention as pa

    lib = _build.load("paged_attention")
    pa._bind()
    names = {0: "fma", 1: "mma"}
    types = (torch.float32, torch.bfloat16, torch.float16, *FP8)
    for c in types:
        for qt in (*types, torch.int8):
            kq, kc = pa.kernel_types(qt, c)
            for d in range(1, 601):
                got = names[lib.paged_attention_products(
                    _build.DTYPE_CODES[kc], _build.DTYPE_CODES[kq], d,
                    pa.GC, 1)]
                want = pa.products_on(qt, c, d)
                if got != want:
                    raise AssertionError(
                        f"paged products for q {qt} over {c} D{d}: the "
                        f"source runs {got}, the wrapper says {want} ... FAIL")
    log("paged over float8 caches: products rule, D 1-600 x q / cache "
        "pairs, source and wrapper agree (mma: TMA rows at Dp 64-256, "
        "16-bit caches under their own q, fp8 caches under a 16-bit or fp8 "
        "q; else fma)")
    n = 0
    for d in PAGED_MMA_DIMS:
        for kv in FP8:
            for qt in PAGED_Q_TYPES:
                for hq, hkv in ((16, 2), (6, 2), (16, 1)):
                    if (hq, hkv) != (16, 2) and d not in (80, 128):
                        continue
                    q = rand_typed(gen, (7, hq, d), qt, Q_SCALE)
                    kc = rand_typed(gen, (7, 333, hkv, d), kv)
                    vc = rand_typed(gen, (7, 333, hkv, d), kv)
                    lens = torch.tensor([0, 1, 31, 32, 33, 200, 333],
                                        dtype=torch.int32, device="cuda")
                    if pa.products_on(qt, kv, d) != "mma":
                        raise AssertionError(f"paged q {qt} over {kv} D{d}: "
                                             "not on the tensor cores")
                    paged_out_check(
                        f"paged q {tname(qt)} caches {tname(kv)} D{d} "
                        f"Hq{hq} Hkv{hkv}",
                        pa.paged_attention(q, kc, vc, lens),
                        ref.paged_attention_ref(q, kc, vc, lens))
                    n += 1
    log(f"  {n} tensor-core cases (D {PAGED_MMA_DIMS}, q e4m3 / e5m2 / bf16 "
        "/ f16 over e4m3 / e5m2 caches, lengths 0 to T, GQA 8, 3, 16) agree")
    for qt in (torch.float32, torch.int8):
        q = (rand_typed(gen, (4, 16, 128), qt, Q_SCALE) if qt.is_floating_point
             else torch.randint(-3, 4, (4, 16, 128), generator=gen,
                                device="cuda", dtype=qt))
        kc = rand_typed(gen, (4, 333, 2, 128), torch.float8_e4m3fn)
        vc = rand_typed(gen, (4, 333, 2, 128), torch.float8_e4m3fn)
        lens = torch.tensor([0, 1, 200, 333], dtype=torch.int32,
                            device="cuda")
        got = pa.paged_attention(q, kc, vc, lens)
        want = ref.paged_attention_ref(q, kc, vc, lens)
        if qt.is_floating_point:
            paged_out_check(f"paged q {tname(qt)} caches e4m3 D128 (fma)",
                            got, want)
        else:
            check_ulp("paged q int8 caches e4m3 D128 (float32 q)", got, want,
                      quiet=True)
    q = rand_typed(gen, (4, 16, 128), torch.float8_e4m3fn, Q_SCALE)
    kc = rand_typed(gen, (4, 333, 2, 128), torch.float8_e5m2)
    vc = rand_typed(gen, (4, 333, 2, 128), torch.float8_e5m2, 600.0)
    lens = torch.tensor([0, 1, 200, 333], dtype=torch.int32, device="cuda")
    got = pa.paged_attention(q, kc, vc, lens)
    want = ref.paged_attention_ref(q, kc, vc, lens)
    check_ulp("paged q e4m3 over e5m2 caches of |v| up to ~2000 (outputs "
              "past e4m3's range)", got, want)
    nans = int(torch.isnan(want.float()).sum())
    if nans == 0:
        raise AssertionError("paged overflow case: no output past e4m3's "
                             "range ... FAIL")
    log(f"  fp32 and int8 q over e4m3 caches agree; {nans} outputs past "
        "e4m3's range are NaN as the plain version gives them")


# flash's fp8 TMA body: head sizes held in both kinds (those not a multiple
# of 32 end on k-steps of zeros; from 128 on, Q K^T in more than one chain)
FLASH_FP8_DIMS = (64, 80, 96, 128, 144, 208, 256)
# paged at B4 Hq16 T1032 (lengths [1032, 1001, 517, 64]): (Hkv, D) of
# kernel_bench.py's `paged_heads` set, then 2 and 4 query heads a KV head
PAGED_HEADS = ((16, 64), (16, 80), (16, 128), (2, 80))
PAGED_HEADS_CHECKED = PAGED_HEADS + ((8, 80), (4, 80), (8, 72), (4, 112),
                                     (16, 96), (16, 256), (8, 128), (4, 64))


def check_redesigns(gen):
    """The two bodies redesigned last, against their plain versions:
    flash's fp8 body by TMA (Q K^T on the fp8 wgmma of each kind) at every
    D of FLASH_FP8_DIMS, causal, not causal and with a window of 100, four
    seeds a case from 128 on (more chains to add in fp32), within one unit in
    the last place plus `fp8_p_term`; paged in bf16 and f16 at
    PAGED_HEADS_CHECKED (below 8 query heads a KV head, segments of several
    KV heads on FMAs: `kv_heads`) and at ragged lengths with zeros, within
    PAGED_BF16_TOL; at the PAGED_HEADS shapes in bf16 timed beside the plain
    version, the library call (SDPA) and the bound (one input set, warm in
    L2: `kernel_bench.py --only paged_heads` times them cold)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa, ref
    import torch.nn.functional as F

    log("flash's fp8 body by TMA and paged at one to four query heads a "
        "KV head")
    for dtype in FP8:
        worst = {}
        for d in FLASH_FP8_DIMS:
            assert fa.body_for(dtype, d) == "wgmma"
            for causal, window in ((True, 0), (False, 0), (True, 100)):
                for _ in range(4 if d >= 128 else 1):
                    q, k, v = flash_case(gen, 2, 8, 2, 300, d, dtype)
                    err = check_ulp(
                        f"flash {tname(dtype)} D{d} causal {causal} window "
                        f"{window}", fa.flash_attention(q, k, v, causal,
                                                        window),
                        ref.attention_ref(q, k, v, causal, window),
                        quiet=True, extra=fp8_p_term(q, k, v, "wgmma",
                                                     causal, window))
                    worst[d] = max(worst.get(d, 0.0), err)
        log(f"  flash {tname(dtype)} (wgmma body, fp8 Q K^T) within one unit "
            f"in the last place + P term; max abs err by D: "
            + ", ".join(f"{d} {e:.3e}" for d, e in worst.items()))
    b, hq, t = BATCH, 16, PROMPT_LEN + MAX_NEW
    lens = torch.tensor([t, PROMPT_LEN + 1, (t + 2) // 2, 64],
                        dtype=torch.int32, device="cuda")
    ragged = torch.tensor([0, 1, 31, 32, 33, 200, 333], dtype=torch.int32,
                          device="cuda")
    mask = (torch.arange(t, device="cuda")[None, :]
            < lens[:, None])[:, None, None, :]
    for dtype in (torch.bfloat16, torch.float16):
        for hkv, d in PAGED_HEADS_CHECKED:
            x = paged_case(gen, b, hq, hkv, t, d, dtype)
            plan, (slots, _) = pa.launch_plan(x[0], x[1]), pa.ring(x[0], x[1])
            check_close(
                f"paged {tname(dtype)} Hq{hq} Hkv{hkv} T{t} D{d} ("
                f"{plan.heads} KV heads a segment, "
                f"{pa.products_on(dtype, dtype, d, hq, hkv)}, {plan.blocks} "
                f"blocks, {slots} slots of {plan.rows} rows)",
                pa.paged_attention(*x, lens),
                ref.paged_attention_ref(*x, lens), **PAGED_BF16_TOL)
            if dtype == torch.bfloat16 and (hkv, d) in PAGED_HEADS:
                ms = time_ms([lambda: pa.paged_attention(*x, lens)], 64)
                plain_ms = time_ms([lambda: ref.paged_attention_ref(*x, lens)],
                                   8)
                library_ms = time_ms([lambda: F.scaled_dot_product_attention(
                    x[0][:, :, None], x[1].transpose(1, 2),
                    x[2].transpose(1, 2), attn_mask=mask, enable_gqa=True)],
                    64)
                bound_ms, bound_by = paged_bound(lens, hq, hkv, d, dtype)
                log(f"    kernel {ms:.4f} ms (its inputs warm in L2), plain "
                    f"{plain_ms:.4f} ms, library {library_ms:.4f} ms, bound "
                    f"{bound_ms:.5f} ms ({bound_by})")
            x = paged_case(gen, 7, hq, hkv, 333, d, dtype)
            check_close(f"  the same at lengths {ragged.tolist()}",
                        pa.paged_attention(*x, ragged),
                        ref.paged_attention_ref(*x, ragged), **PAGED_BF16_TOL)


# paged above 8 query heads a KV head: (Hq, Hkv) of G = 16, of G = 12 (a
# group that is not whole) and of G = 32 (two groups a KV head); head sizes
# padded to 256, where a segment of one KV head serves 16 query heads
# (`query_heads`, a warp two: that body's own and two below it, rows of whole
# 16-byte pieces in bf16 and fp8), and 64 and 128, where it serves 8; (q,
# caches) types of the tensor-core bodies
PAIR_LAYOUTS = ((16, 1), (12, 1), (32, 2))
PAIR_DIMS = (64, 128, 144, 208, 256)
PAIR_TYPES = ((torch.bfloat16, torch.bfloat16), (torch.float16, torch.float16),
              (torch.bfloat16, torch.float8_e4m3fn),
              (torch.float16, torch.float8_e5m2),
              (torch.float8_e4m3fn, torch.float8_e4m3fn),
              (torch.float8_e5m2, torch.float8_e5m2))
# the 16-bit integer add (a returning add and a carry repair a word): row
# widths in elements, so that words lie wholly in a row (64), hold its
# first or last element beside a neighbour's (3) or one element (1)
ADD16_WIDTHS = (64, 3, 1)


def check_pair_heads_and_add16(gen):
    """The two bodies redesigned last, against their plain versions: paged
    at PAIR_LAYOUTS x PAIR_DIMS x PAIR_TYPES (at Dp 256 a segment of one KV
    head serving 16 query heads, two a warp), lengths [0, 1, 31, 32, 33,
    200, 333], within PAGED_BF16_TOL / PAGED_F16_TOL of a 16-bit output and one
    unit in the last place of a float8 one, and at recurrentgemma-9b's
    decode layout (B4 Hq16 Hkv1 T4128 D256, lengths [4128, 4097, 2065, 64])
    in bf16; then int16 and uint16 add of 2^20 updates, a quarter into 4096
    hot rows, into [2^24, w] for w in ADD16_WIDTHS, every table value and
    update negative as int16 (a half at 0x8000 or more: the low half
    carries on every add, the high half wraps), held bit for bit."""
    from repro_torch.kernels import async_scatter as asc
    from repro_torch.kernels import paged_attention as pa, ref

    log("paged at 12 to 32 query heads a KV head (two a warp) and the "
        "16-bit integer add on a returning add")
    lens = torch.tensor([0, 1, 31, 32, 33, 200, 333], dtype=torch.int32,
                        device="cuda")
    n = 0
    for hq, hkv in PAIR_LAYOUTS:
        for d in PAIR_DIMS:
            for qt, kv in PAIR_TYPES:
                if (hq, hkv) == (32, 2) and d != 256:
                    continue
                q = rand_typed(gen, (7, hq, d), qt, Q_SCALE)
                kc = rand_typed(gen, (7, 333, hkv, d), kv)
                vc = rand_typed(gen, (7, 333, hkv, d), kv)
                plan = pa.launch_plan(q, kc)
                group = 2 * pa.GC if d > 128 else pa.GC
                if plan.group != group or pa.products_on(
                        qt, kv, d, hq, hkv) != "mma":
                    raise AssertionError(
                        f"paged q {qt} caches {kv} Hq{hq} Hkv{hkv} D{d}: "
                        f"plan {plan}, not {group} query heads a segment on "
                        "the tensor cores ... FAIL")
                paged_out_check(
                    f"paged q {tname(qt)} caches {tname(kv)} Hq{hq} Hkv{hkv} "
                    f"D{d}", pa.paged_attention(q, kc, vc, lens),
                    ref.paged_attention_ref(q, kc, vc, lens))
                n += 1
    b, t = BATCH, 4128
    rg_lens = torch.tensor([t, t - 31, (t + 2) // 2, 64], dtype=torch.int32,
                           device="cuda")
    x = paged_case(gen, b, 16, 1, t, 256, torch.bfloat16)
    plan, (slots, smem) = pa.launch_plan(x[0], x[1]), pa.ring(x[0], x[1])
    check_close(f"paged bf16 B{b} Hq16 Hkv1 T{t} D256 ({plan.segments} "
                f"segments, {plan.blocks} blocks, {slots} slots of "
                f"{plan.rows} rows, {smem} bytes of shared memory)",
                pa.paged_attention(*x, rg_lens),
                ref.paged_attention_ref(*x, rg_lens), **PAGED_BF16_TOL)
    log(f"  {n} cases above 8 query heads a KV head agree (G 16, 12, 32; D "
        f"{PAIR_DIMS}, 16 heads a segment above 128; bf16 / f16 caches, e4m3 "
        "/ e5m2 under 16-bit and fp8 q)")
    del x
    def negative(shape, dtype):
        return torch.randint(-32768, 0, shape, generator=gen, device="cuda",
                             dtype=torch.int16).view(dtype)

    rows, m = 1 << 24, 1 << 20
    for width in ADD16_WIDTHS:
        for dtype in (torch.int16, torch.uint16):
            table = negative((rows, width), dtype)
            upd = negative((m, width), dtype)
            idx = amu_index(gen, rows, m)
            idx[::4] %= 4096
            plan = asc.launch_plan(table, m, "add")
            out = asc.async_scatter(table.clone(), idx, upd, "add")
            check_same(f"scatter add [{rows},{width}] {tname(dtype)}, every "
                       f"add carrying, {m} updates (chunk {plan.chunk}, "
                       f"{plan.lanes} lanes a row)", out,
                       ref.scatter_update_ref(table, idx, upd, "add"))
            del table, upd, idx, out
    free_cuda()


# flash's mma.sync body (16-bit rows of whole 16-byte pieces at Dp 16 and
# 32): head sizes, and (b, hq, hkv, s, causal, window) cases: qwen2.5-3b's
# prefill layout, windows whose edge falls inside a warp's 16 rows, S
# ragged against the 64-key tiles and below one, GQA groups 1, 4 and 8
MMA_DIMS = (8, 16, 24, 32)
MMA_CASES = ((4, 16, 2, 1000, True, 0), (2, 8, 1, 200, True, 48),
             (1, 4, 4, 129, True, 0), (2, 8, 8, 100, False, 0),
             (1, 8, 1, 333, False, 63), (1, 4, 2, 1000, True, 200),
             (1, 2, 2, 1, True, 0), (1, 2, 1, 17, True, 5),
             (1, 4, 1, 300, True, 100))
# the triad's steps of several bulk copies: (n, block, stages), the last
# step short of its copies and of its chunks; one stage with several steps
# a block; rings where 4 / item blocks a step do not fit (2 at 8 bits, 1 at
# 16: `stream_triad.step_blocks`), which 32-bit types must refuse
TRIAD_STEP_CASES = ((12345, 128, 2), (12345, 512, 4), ((1 << 18) + 13, 1024, 2),
                    ((1 << 18) + 13, 512, 8), (515, 512, 4),
                    ((1 << 23) + 13, 512, 1), ((1 << 20) + 13, 1024, 1),
                    ((1 << 20) + 13, 8192, 4), ((1 << 20) + 13, 4096, 8))


def check_mma_and_triad(gen):
    """The two bodies redesigned last, against their plain versions: flash's
    mma.sync body (a mask only on straddling tiles, p by one FFMA and one
    ex2, a 3-slot ring with one barrier a tile, P V at n = 8 for D = 8) at
    MMA_DIMS x MMA_CASES in bf16 and f16 within FLASH_BF16_TOL /
    FLASH_F16_TOL, then timed at qwen2.5-3b's prefill layout beside SDPA
    and the plain version;
    the triad's steps sized in bytes (4 / item bulk copies a step where
    they fit, 8- and 16-bit integers a word at a time) in every type at
    TRIAD_STEP_CASES,
    integers over the whole type, bit for bit."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa, ref
    from repro_torch.kernels import stream_triad as st

    log("flash's mma.sync body at D 8-32 in bf16 and f16, and the triad's "
        "byte-sized steps in every type")
    for dtype in (torch.bfloat16, torch.float16):
        for d in MMA_DIMS:
            if fa.body_for(dtype, d) != "mma":
                raise AssertionError(f"flash D{d} {tname(dtype)} runs the "
                                     f"{fa.body_for(dtype, d)} body")
            for (b, hq, hkv, s, causal, window) in MMA_CASES:
                q, k, v = flash_case(gen, b, hq, hkv, s, d, dtype)
                check_flash_out(
                    f"{tname(dtype)} B{b} Hq{hq} Hkv{hkv} S{s} D{d} "
                    f"causal{causal} window{window} (mma body)",
                    fa.flash_attention(q, k, v, causal=causal,
                                       window=window), q, k, v, causal,
                    window, quiet=True)
    torch.cuda.synchronize()
    log(f"  {len(MMA_DIMS)} head sizes x {len(MMA_CASES)} cases x 2 types "
        "agree")
    b, hq, hkv, s = BATCH, 16, 2, PROMPT_LEN
    for dtype in (torch.bfloat16, torch.float16):
        for d in (8, 16, 32):
            q, k, v = flash_case(gen, b, hq, hkv, s, d, dtype)
            ms = time_ms([lambda: fa.flash_attention(q, k, v)], 20)
            lib = time_ms([lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True)], 20)
            plain = time_ms([lambda: ref.attention_ref(q, k, v)], 5)
            log(f"  flash B{b} Hq{hq} Hkv{hkv} S{s} D{d} {tname(dtype)} "
                f"causal: {ms:.4f} ms (SDPA {lib:.4f} ms, plain "
                f"{plain:.4f} ms, bound "
                f"{flash_bound(b, hq, hkv, s, d, 0, dtype)[0]:.5f} ms)")
            del q, k, v
    for dtype in st.TYPES:
        for (n, block, stages) in TRIAD_STEP_CASES:
            x, y = (rand_typed(gen, (n,), dtype, 4.0) for _ in range(2))
            if not st.step_blocks(dtype.itemsize, block, stages):
                try:
                    st.stream_triad(x, y, 3.3, block=block, stages=stages)
                except ValueError:
                    continue
                raise AssertionError(f"triad {tname(dtype)} took {stages} "
                                     f"stages of block {block}: its ring "
                                     "does not fit")
            check_same(f"triad {tname(dtype)} N{n} block{block} "
                       f"stages{stages}",
                       st.stream_triad(x, y, 3.3, block=block, stages=stages),
                       ref.triad_ref(x, y, 3.3), quiet=True)
    log(f"  triad bit-exact in {len(st.TYPES)} types at (N, block, stages) "
        f"{TRIAD_STEP_CASES}")
    free_cuda()


# paged's rows of no whole 16-byte pieces: (q type, cache type, D, Hq, Hkv,
# head pad, route) at T 1032, the serve lengths, then lengths 0, 1, 33 and
# T: fp8 D8 at the decode layout (a box of the token's two heads), fp8
# D100 at Hkv2 (a token of 200 bytes: the copy, 4-byte loads) and Hkv16 (a
# box of 8 heads), 16-bit D100 at Hkv16 (hubert-xlarge's heads) and Hkv2,
# strided heads (the copy, 8 heads a segment), D98 (columns no whole
# vector of a lane), D7 at G 3 (the copy, 2-byte loads) and fp32 D7 at G 1
ELEM_ROWS = (
    (torch.float8_e4m3fn, torch.float8_e4m3fn, 8, 16, 2, 0, "run"),
    (torch.float8_e5m2, torch.float8_e5m2, 8, 16, 2, 0, "run"),
    (torch.bfloat16, torch.float8_e4m3fn, 8, 16, 2, 0, "run"),
    (torch.float8_e4m3fn, torch.float8_e4m3fn, 100, 16, 2, 0, "element"),
    (torch.float16, torch.float8_e5m2, 100, 16, 2, 0, "element"),
    (torch.float8_e5m2, torch.float8_e5m2, 100, 16, 16, 0, "run"),
    (torch.bfloat16, torch.bfloat16, 100, 16, 16, 0, "run"),
    (torch.float16, torch.float16, 100, 16, 16, 0, "run"),
    (torch.bfloat16, torch.bfloat16, 100, 16, 2, 0, "run"),
    (torch.float32, torch.float16, 100, 16, 16, 0, "run"),
    (torch.bfloat16, torch.bfloat16, 100, 16, 16, 4, "element"),
    (torch.float8_e4m3fn, torch.float8_e4m3fn, 8, 16, 2, 8, "element"),
    (torch.bfloat16, torch.bfloat16, 98, 16, 16, 0, "run"),
    (torch.float16, torch.float16, 98, 16, 2, 6, "element"),
    (torch.bfloat16, torch.bfloat16, 7, 12, 4, 0, "element"),
    (torch.float32, torch.float32, 7, 16, 16, 0, "run"),
    (torch.float8_e4m3fn, torch.float8_e4m3fn, 8, 16, 1, 0, "element"))
# flash's pair body (256 < D <= 512) and the chunked one above, held at
# these (b, hq, hkv, s, causal, window) beside check_flash_padded's cases:
# S of one key, a tail of one row, a window edge inside a tile
PAIR_CASES = ((1, 2, 1, 1, True, 0), (2, 8, 1, 65, True, 0),
              (1, 8, 8, 300, True, 100), (1, 4, 2, 257, False, 0))


def check_elem_rows_and_pair(gen):
    """The two bodies redesigned last (run right after `check_paged`, so
    that their mutants fail early), against their plain versions: paged
    over rows of no whole 16-byte pieces at ELEM_ROWS (each on the route
    it names, `paged_attention.route`: TMA boxes of a run of heads, or the
    producer warp's copy in loads as wide as the rows allow), within one
    unit in the last place of an fp8 output and PAGED_BF16_TOL /
    PAGED_F16_TOL / FP32_TOL of the others, at the serve lengths and at 0,
    1, 33 and T; timed at the serve lengths beside SDPA (on bf16 copies for
    fp8), the plain version and the bound. Then flash's wgmma body at
    WIDE_DIMS x PAIR_CASES in bf16 and f16 (the pair body up to 512: two
    consumer warpgroups that add their parts of Q K^T), and timed at
    qwen2.5-3b's prefill layout at D 512, 1024 and 2048."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa, ref

    log("paged over rows of no whole 16-byte pieces (runs of heads by TMA, "
        "or the copy) and flash's pair body above 256 columns")
    b, t = BATCH, PROMPT_LEN + MAX_NEW
    lens = torch.tensor([t, PROMPT_LEN + 1, (t + 2) // 2, 64],
                        dtype=torch.int32, device="cuda")
    edge = torch.tensor([0, 1, 33, t], dtype=torch.int32, device="cuda")
    mask = (torch.arange(t, device="cuda")[None, :]
            < lens[:, None])[:, None, None, :]
    for q_dtype, dtype, d, hq, hkv, pad, want in ELEM_ROWS:
        q = rand_typed(gen, (b, hq, d), q_dtype, Q_SCALE)
        k, v = (rand_typed(gen, (b, t, hkv, d + pad), dtype)[..., :d]
                for _ in range(2))
        got = pa.route(q, k, v)
        plan = pa.launch_plan(q, k, v_cache=v)
        strided = f", heads {pad} elements apart past D" if pad else ""
        name = (f"paged q {tname(q_dtype)} caches {tname(dtype)} B{b} "
                f"Hq{hq} Hkv{hkv} T{t} D{d}{strided} "
                f"({got}: {plan.heads} KV heads a segment, "
                f"{plan.box_heads} a slot row, {plan.rows} rows)")
        if got != want:
            raise AssertionError(f"{name}: want the {want} route FAIL")
        for lengths in (lens, edge):
            paged_out_check(f"{name} lengths {lengths.tolist()}",
                            pa.paged_attention(q, k, v, lengths),
                            ref.paged_attention_ref(q, k, v, lengths))
        if pad:
            continue
        ms = time_ms([lambda: pa.paged_attention(q, k, v, lens)], 64)
        plain = time_ms([lambda: ref.paged_attention_ref(q, k, v, lens)], 4)
        lq, lk, lv = (x.to(torch.bfloat16) if x.dtype in FP8 else x
                      for x in (q, k, v))
        lib = time_ms([lambda: F.scaled_dot_product_attention(
            lq[:, :, None], lk.transpose(1, 2), lv.transpose(1, 2),
            attn_mask=mask, enable_gqa=True)], 64) \
            if lq.dtype == lk.dtype else None
        bound, by = paged_bound(lens, hq, hkv, d, dtype, q_dtype)
        log(f"  {name}: {ms:.4f} ms, plain {plain:.4f} ms, library "
            f"{'none' if lib is None else f'{lib:.4f} ms'}, bound "
            f"{bound:.5f} ms ({by})")
        del q, k, v
    torch.cuda.synchronize()
    log(f"  {len(ELEM_ROWS)} paged cases agree at the serve lengths and at "
        f"{edge.tolist()}")
    for dtype in (torch.bfloat16, torch.float16):
        for d in WIDE_DIMS:
            for (bb, hq, hkv, s, causal, window) in PAIR_CASES:
                q, k, v = flash_case(gen, bb, hq, hkv, s, d, dtype)
                check_flash_out(
                    f"flash {tname(dtype)} B{bb} Hq{hq} Hkv{hkv} S{s} D{d} "
                    f"causal{causal} window{window} ({fa.body_for(dtype, d)}"
                    f" body, {fa.wide_blocks(dtype, d)} blocks a tile)",
                    fa.flash_attention(q, k, v, causal, window), q, k, v,
                    causal, window, quiet=True)
    torch.cuda.synchronize()
    log(f"  flash at D {WIDE_DIMS} x {len(PAIR_CASES)} cases x 2 types agree")
    for dtype, d in ((torch.bfloat16, 512), (torch.float16, 512),
                     (torch.bfloat16, 1024), (torch.bfloat16, 2048)):
        q, k, v = flash_case(gen, b, 16, 2, PROMPT_LEN, d, dtype)
        ms = time_ms([lambda: fa.flash_attention(q, k, v)], 10)
        lib = time_ms([lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True)], 3)
        plain = time_ms([lambda: ref.attention_ref(q, k, v)], 2)
        log(f"  flash B{b} Hq16 Hkv2 S{PROMPT_LEN} D{d} {tname(dtype)} causal "
            f"({fa.wide_blocks(dtype, d)} blocks a tile): {ms:.4f} ms "
            f"(SDPA {lib:.4f} ms, plain {plain:.4f} ms, bound "
            f"{flash_bound(b, 16, 2, PROMPT_LEN, d, 0, dtype)[0]:.5f} ms)")
        del q, k, v
    free_cuda()


def fp8_serve_shapes(gen):
    """Flash in both float8 types at qwen2.5-3b's prefill (B4 Hq16 Hkv2
    S1000 D128, causal) and paged with float8 caches at its decode (T 1032,
    lengths [1032, 1001, 517, 64]), also under a bf16 q: within one unit in
    the output's last place of the plain version (flash's wgmma body plus
    `fp8_p_term`; the bf16 output within PAGED_BF16_TOL), timed beside it,
    its
    bound and the library call on bf16 copies (`scaled_dot_product_attention`
    has no float8 form: a yardstick of the same function, not of the same
    bytes). Each goes into SERVE_SHAPES."""
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa, ref
    import torch.nn.functional as F

    cfg = configs.get_config(ARCH)
    b, hq, hkv, d = (BATCH, cfg.num_heads, cfg.num_kv_heads,
                     cfg.resolved_head_dim)
    s, t = PROMPT_LEN, PROMPT_LEN + MAX_NEW
    log(f"float8 at {ARCH}'s serve shapes")
    for dtype in FP8:
        q = rand_typed(gen, (b, s, hq, d), dtype, Q_SCALE).transpose(1, 2)
        k = rand_typed(gen, (b, s, hkv, d), dtype).transpose(1, 2)
        v = rand_typed(gen, (b, s, hkv, d), dtype).transpose(1, 2)
        shape = f"{ARCH} B{b} Hq{hq} Hkv{hkv} S{s} D{d} {tname(dtype)}"
        err = check_ulp(f"flash {shape}", fa.flash_attention(q, k, v),
                        ref.attention_ref(q, k, v),
                        extra=fp8_p_term(q, k, v, fa.body_for(dtype, d)))
        bq, bk, bv = (x.to(torch.bfloat16) for x in (q, k, v))
        ms = time_ms([lambda: fa.flash_attention(q, k, v)], 10)
        plain_ms = time_ms([lambda: ref.attention_ref(q, k, v)], 5)
        library_ms = time_ms([lambda: F.scaled_dot_product_attention(
            bq, bk, bv, is_causal=True, enable_gqa=True)], 10)
        bound_ms, bound_by = flash_bound(b, hq, hkv, s, d, 0, dtype)
        log(f"  ({fa.body_for(dtype, d)} body) kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, library on bf16 copies {library_ms:.4f} "
            f"ms, bound {bound_ms:.5f} ms ({bound_by})")
        SERVE_SHAPES.append(dict(
            kernel="flash_attention", shape=shape, max_abs_err=err, ms=ms,
            plain_ms=plain_ms, library_ms=library_ms,
            library="sdpa on bf16 copies", bound_ms=bound_ms,
            bound_by=bound_by))
    lens = torch.tensor([t, s + 1, (t + 2) // 2, 64], dtype=torch.int32,
                        device="cuda")
    mask = (torch.arange(t, device="cuda")[None, :]
            < lens[:, None])[:, None, None, :]
    for q_dtype, dtype in ((torch.float8_e4m3fn, torch.float8_e4m3fn),
                           (torch.float8_e5m2, torch.float8_e5m2),
                           (torch.bfloat16, torch.float8_e4m3fn),
                           (torch.float16, torch.float8_e5m2)):
        sets = [(rand_typed(gen, (b, hq, d), q_dtype, Q_SCALE),
                 rand_typed(gen, (b, t, hkv, d), dtype),
                 rand_typed(gen, (b, t, hkv, d), dtype)) for _ in range(16)]
        q, kc, vc = sets[0]
        shape = (f"{ARCH} B{b} Hq{hq} Hkv{hkv} T{t} D{d} q {tname(q_dtype)} "
                 f"caches {tname(dtype)}")
        got = pa.paged_attention(q, kc, vc, lens)
        want = ref.paged_attention_ref(q, kc, vc, lens)
        err = paged_out_check(f"paged {shape}", got, want)
        wide = [tuple(x.to(torch.bfloat16) for x in st) for st in sets]
        ms = time_ms([lambda st=st: pa.paged_attention(*st, lens)
                      for st in sets], 64)
        plain_ms = time_ms([lambda st=st: ref.paged_attention_ref(*st, lens)
                            for st in sets], 16)
        library_ms = time_ms([lambda w=w: F.scaled_dot_product_attention(
            w[0][:, :, None], w[1].transpose(1, 2), w[2].transpose(1, 2),
            attn_mask=mask, enable_gqa=True) for w in wide], 64)
        bound_ms, bound_by = paged_bound(lens, hq, hkv, d, dtype, q_dtype)
        log(f"  ({pa.body_for(dtype, d)} body, "
            f"{pa.products_on(q_dtype, dtype, d)}) kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, library on bf16 copies {library_ms:.4f} "
            f"ms, bound {bound_ms:.5f} ms ({bound_by})")
        SERVE_SHAPES.append(dict(
            kernel="paged_attention", shape=shape, max_abs_err=err, ms=ms,
            plain_ms=plain_ms, library_ms=library_ms,
            library="sdpa on bf16 copies", bound_ms=bound_ms,
            bound_by=bound_by))
    pairs = [("float8_e4m3fn", "float8_e4m3fn"), ("float8_e5m2", "float8_e5m2"),
             ("bfloat16", "float8_e4m3fn"), ("float16", "float8_e5m2")]
    for (qn, cn), seen in zip(pairs, paged_kernels_seen(pairs, b, hq, hkv, t,
                                                        d)):
        if list(seen.values()) != [1] or "paged_attention_kernel" not in \
                next(iter(seen)):
            raise AssertionError(f"paged q {qn} caches {cn}: one call ran "
                                 f"{seen}, want one paged_attention_kernel "
                                 "... FAIL")
        log(f"  paged q {qn} caches {cn}: one call is one kernel on the "
            f"device (torch.profiler): {next(iter(seen))[:80]}")


# One paged call a (q, caches) type pair under torch.profiler, in a process
# of its own: on the H100 a profiler session after phase 3's other work saw
# no device activity, where a fresh process's sessions see every kernel.
PROFILE_PAGED = """
import json, sys
import torch
from torch.profiler import ProfilerActivity, profile
sys.path.insert(0, sys.argv[1])
from repro_torch.kernels import paged_attention as pa
b, hq, hkv, t, d = json.loads(sys.argv[3])
lens = torch.tensor([t, t - 31, (t + 2) // 2, 64][:b], dtype=torch.int32,
                    device="cuda")
seen = []
for qn, cn in json.loads(sys.argv[2]):
    q = torch.randn(b, hq, d, device="cuda").to(getattr(torch, qn))
    k, v = (torch.randn(b, t, hkv, d, device="cuda").to(getattr(torch, cn))
            for _ in range(2))
    for _ in range(2):          # the first session warms the profiler
        pa.paged_attention(q, k, v, lens)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            pa.paged_attention(q, k, v, lens)
            torch.cuda.synchronize()
    seen.append({e.key: e.count for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA})
print(json.dumps(seen))
"""


def paged_kernels_seen(pairs, b, hq, hkv, t, d, tries=3) -> list:
    """The CUDA kernels (name: launches) torch.profiler sees in one
    `paged_attention` call for each (q type, cache type) name pair, at
    [b, hq, d] q over [b, t, hkv, d] caches, in a process of its own; a
    new process, up to `tries` in all, where a session recorded no kernel
    at all (the profiler's, not the call's: on the H100 a session has
    come back empty after two calls had run, and one call is always at
    least one kernel)."""
    for _ in range(tries):
        proc = subprocess.run(
            [sys.executable, "-c", PROFILE_PAGED, os.path.join(ROOT, "src"),
             json.dumps(pairs), json.dumps([b, hq, hkv, t, d])],
            capture_output=True, text=True, timeout=300)
        if proc.returncode:
            raise AssertionError("the profiled paged calls failed: "
                                 + proc.stderr.strip()[-400:])
        seen = json.loads(proc.stdout.strip().splitlines()[-1])
        if all(seen):
            break
        log(f"  the profiler recorded no kernel in a session: {seen}; "
            "profiling again in a new process")
    return seen


def check_scatter_paths(gen) -> float:
    """async_scatter's plan rule and edges: rows of 8, 12, 16, 512 and 4096
    bytes, bucketed or not as `bucketed` says (asserted by `launch_plan`
    and by the source's own rule, also at the rule's edges; 2^25 updates
    into 1.5 GiB tables of 3- and 6-byte rows down both paths), each at
    M = 1, 7, 131 and 4000 in every op and type, block_m a bound and K from
    1 to 32; a table whose rows are not a whole number of bucket regions,
    one row hit by every update, every update in the last row. Rows
    narrower than a sector run each of these cases down both paths: the
    wrapper's (the rule's plan) and `async_scatter.launch` on the other
    plan (`launch_plan(..., bucket=...)`), so that the bucket pass and the
    bucketed apply meet every edge at any size. The bucket pass against its
    plain version bit for bit (one tile, many tiles, tiles of several
    sub-chunks); the apply's shared memory as Python plans it and as the
    source sizes it; two calls in a row, each on the workspace the other
    left, down both paths for 8-byte rows. Returns the worst f32 error."""
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import async_scatter as asc

    lib = _build.load("async_scatter")
    asc._bind()
    log("async_scatter paths: bucketed below 32-byte rows in tables of 8 GiB "
        "and more by 2^26 updates and more, else straight to the apply; i32 "
        "bit-exact, f32 add within 1e-4")
    worst = 0.0

    def describe(table, idx, op, plan, kw):
        return (f"{str(table.dtype)[6:]} {op} rows of {table.shape[1] * 4} "
                f"B, N{table.shape[0]} M{idx.numel()}"
                f"{f' {kw}' if kw else ''}: "
                f"{'bucket pass + ' if plan.bucket else ''}apply of "
                f"{plan.blocks} blocks, {plan.slots} slots of {plan.span} "
                f"updates, {plan.chunk}-byte reductions")

    def both_paths(table, idx, upd, op, **kw):
        """(plan, result) of the wrapper's call and, for rows narrower than
        a sector, of the launch on the other plan."""
        plan = asc.launch_plan(table, idx.numel(), op, **kw)
        runs = [(plan, asc.async_scatter(table.clone(), idx, upd, op, **kw))]
        if table.shape[1] * table.element_size() < asc.SECTOR:
            other = asc.launch_plan(table, idx.numel(), op,
                                    bucket=not plan.bucket, **kw)
            runs.append((other, asc.launch(table.clone(), idx, upd, op,
                                           other)))
        return runs

    def run(table, idx, upd, op, quiet=True, **kw):
        nonlocal worst
        r = table.shape[1] * 4
        want_bucket = asc.bucketed(r, table.shape[0], idx.numel())
        want = ref.scatter_update_ref(table, idx, upd, op)
        for k, (plan, got) in enumerate(both_paths(table, idx, upd, op,
                                                   **kw)):
            what = describe(table, idx, op, plan, kw)
            if k == 0 and (plan.bucket != want_bucket or bool(
                    lib.async_scatter_bucketed(r, table.shape[0],
                                               idx.numel())) != want_bucket):
                raise AssertionError(f"{what}: want "
                                     f"{'the bucket pass' if want_bucket else 'no bucket pass'}")
            if lib.async_scatter_apply_smem(plan.span, plan.slots, r) \
                    != plan.smem:
                raise AssertionError(f"{what}: Python plans {plan.smem} bytes "
                                     "of shared memory, the source sizes "
                                     f"{lib.async_scatter_apply_smem(plan.span, plan.slots, r)}")
            if table.dtype == torch.float32:
                worst = max(worst, check_close(what, got, want, quiet=quiet,
                                               **SCATTER_TOL))
            else:
                check_same(what, got, want, quiet=quiet)

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
            run(table, idx, upd, op, quiet=m != 4000)
            for bm, k in ((1, 1), (16, 3), (64, 32)):
                if asc.apply_smem(4, k, r) > asc.MAX_SMEM:
                    continue               # refused: checked in the tests
                run(table, idx, upd, op, block_m=bm, num_slots=k)
        m = 4000
        upd = amu_table(gen, (m, r // 4), dtype)
        if dtype == torch.float32:
            # 4000 terms a row: order alone moves a sum of N(0, 1) terms by
            # ~1e-4 of its size; updates of N(0, 1/64^2) keep it in atol
            upd = upd / 64
        for row, what in ((17, "one row hit by every update"),
                          (n - 1, "every update in the last row")):
            idx = torch.full((m,), row, dtype=torch.int32, device="cuda")
            run(table, idx, upd, op, quiet=False)
            log(f"    ({what})")
    log("  rows of 8-4096 B x M 1-4000 x block_m and K agree (rows below "
        "32 B down both paths: the rule's plan and the other one)")
    # the bucket rule at its edges: tables of BUCKET_TABLE bytes and one
    # row less, BUCKET_M updates and one less, GUPS and the [2^24, 3] table
    # over the sweep's M, rows of 31 and 32 bytes
    edges = [(r, n, m) for r in (3, 6, 8, 31, 32, 512)
             for n in (5003, 1 << 24, 1 << 30, -(-asc.BUCKET_TABLE // r),
                       -(-asc.BUCKET_TABLE // r) - 1)
             for m in (1, asc.BUCKET_M - 1, asc.BUCKET_M, 1 << 20, 1 << 22,
                       1 << 24, 1 << 26)]
    for r, n, m in edges:
        if bool(lib.async_scatter_bucketed(r, n, m)) != asc.bucketed(r, n, m):
            raise AssertionError(f"bucket rule at rows of {r} B, N{n} M{m}: "
                                 "the source and scatter_plan differ ... FAIL")
    if not (asc.bucketed(8, 1 << 30, 1 << 26)
            and not asc.bucketed(6, 1 << 24, 1 << 20)):
        raise AssertionError("bucket rule: GUPS must be bucketed and 2^20 "
                             "updates into [2^24, 3] not ... FAIL")
    log(f"  bucket rule: the source and scatter_plan agree at {len(edges)} "
        f"edges (rows < 32 B, tables of {asc.BUCKET_TABLE} B and more, M >= "
        f"{asc.BUCKET_M}; GUPS bucketed, 2^20 updates into [2^24, 3] not)")
    # the word path at scale, down both paths: 2^25 updates into tables of
    # 1.5 GiB and more, rows of 3 and 6 bytes
    for dtype, op, rows in ((torch.bfloat16, "add", 1 << 28),
                            (torch.int8, "add", 3 << 27),
                            (torch.uint16, "xor", 1 << 28)):
        table = rand_typed(gen, (rows, 3), dtype)
        idx = amu_index(gen, rows, 1 << 25)
        upd = rand_typed(gen, (idx.numel(), 3), dtype)
        runs = both_paths(table, idx, upd, op)
        if not any(plan.bucket for plan, _ in runs):
            raise AssertionError("the word-path case is not run bucketed "
                                 "... FAIL")
        for plan, got in runs:
            name = (f"scatter {op} {tname(dtype)} [{rows},3], "
                    f"{idx.numel()} updates "
                    f"({'' if plan.bucket else 'not '}bucketed)")
            if dtype.is_floating_point:
                check_scatter16(name, got, table, idx, upd)
            else:
                check_same(name, got,
                           ref.scatter_update_ref(table, idx, upd, op))
        del table, idx, upd, runs
        free_cuda()

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
            check_same(f"{what}, {name}", g, w, quiet=name != "offsets")

    log("async_scatter: two calls in a row, each on the workspace the "
        "other left")
    for r, dtype, op in ((8, torch.int32, "xor"), (512, torch.float32,
                                                   "add")):
        n, m = (1 << 20, 1 << 20)
        pairs = [(amu_table(gen, (n, r // 4), dtype), amu_index(gen, n, m),
                  amu_table(gen, (m, r // 4), dtype)) for _ in range(2)]
        # the rule's plan (through the wrapper), and below a sector the
        # other one too: each pair of calls back to back
        plan = asc.launch_plan(pairs[0][0], m, op)
        runs = [(plan, [asc.async_scatter(t.clone(), i, u, op)
                        for t, i, u in pairs])]
        if r < asc.SECTOR:
            other = asc.launch_plan(pairs[0][0], m, op,
                                    bucket=not plan.bucket)
            runs.append((other, [asc.launch(t.clone(), i, u, op, other)
                                 for t, i, u in pairs]))
        for plan, outs in runs:
            for k, ((t, i, u), out) in enumerate(zip(pairs, outs)):
                want = ref.scatter_update_ref(t, i, u, op)
                name = (f"{describe(t, i, op, plan, {})}, call {k + 1} "
                        "of 2")
                if dtype == torch.float32:
                    worst = max(worst, check_close(name, out, want,
                                                   **SCATTER_TOL))
                else:
                    check_same(name, out, want)
        del pairs, runs
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
    from repro_torch import configs, convert
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

    # the smoke sizes on the card, kernels and offload on: head size 16, and
    # 8 (phi4-mini's and qwen2.5-32b's), which the kernels run padded to 16
    steps = 3
    for arch in ("qwen2.5-3b", "qwen2-7b", "phi4-mini-3.8b", "qwen2.5-32b"):
        small_cfg = configs.get_smoke_config(arch)
        fa.launches = pa.launches = 0
        small = serve(arch, smoke=True, batch=2, prompt_len=130,
                      max_new=steps + 1, use_kernels=True, offload_kv=True,
                      device="cuda")
        torch.cuda.synchronize()
        n_flash, n_paged = fa.launches, pa.launches
        L = small_cfg.num_layers
        log(f"  {arch} at smoke size (head size "
            f"{small_cfg.resolved_head_dim}, flash {fa.body_for(torch.bfloat16, small_cfg.resolved_head_dim)} "
            f"body, paged {pa.body_for(torch.bfloat16, small_cfg.resolved_head_dim)} body): "
            f"launches flash {n_flash}, paged {n_paged}; offloaded tokens "
            f"identical: {small['tokens_identical']}")
        want_launches(arch, n_flash, n_paged, L, 2 * L * steps)
        if not small["tokens_identical"] or not torch.equal(
                small["tokens"], small["tokens_offload"]):
            raise AssertionError(f"{arch} at smoke size: offloaded decode "
                                 "diverged from the baseline")
        if not torch.isfinite(small["prefill_logits"].float()).all():
            raise AssertionError(f"{arch} at smoke size: non-finite logits")
        kernels[0]["launches"] += n_flash
        kernels[1]["launches"] += n_paged
        # the same weights through the plain attention path: the prefill,
        # then the first decode step from the served (kernel-filled) cache
        params = small["params"]
        cache = lm.init_cache(small_cfg, 2, 130 + steps + 1, device="cuda")
        plain, _ = lm.prefill(small_cfg, params, {"tokens": small["prompts"]},
                              cache, use_kernels=False)
        check_close(f"{arch} at smoke size: prefill last-token logits, "
                    "kernels vs plain path (bf16)", small["prefill_logits"],
                    plain, **LOGITS_TOL)
        tok = small["tokens"][:, :1]
        dec = [lm.decode_step(small_cfg, params, tok,
                              convert.tree_map(torch.clone, small["cache"]),
                              use_kernels=uk)[0] for uk in (True, False)]
        check_close(f"{arch} at smoke size: first decode step's logits, "
                    "kernels vs plain path (bf16)", *dec, **LOGITS_TOL)
        del small, params, cache, plain, dec
    log("  dense archs at smoke size on the card: head sizes 16 and 8 served "
        "through flash and paged")


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


F16_DECODE_STEPS = 8


def kernel_counts(fn) -> dict:
    """The CUDA kernels the profiler sees while `fn` runs: launches by
    name."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key: e.count for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}


def kernel_names(fn) -> list:
    """The CUDA kernels the profiler sees while `fn` runs, by name."""
    return sorted(kernel_counts(fn))


def sdpa_backend(fn) -> str:
    """Which of scaled_dot_product_attention's backends `fn` (one call of
    it) ran: the attention kernels the profiler sees, shortened."""
    names = [n for n in kernel_names(fn)
             if any(w in n.lower() for w in ("attention", "fmha", "flash",
                                              "sdpa", "cudnn", "softmax",
                                              "gemm", "bmm"))]
    return "; ".join(n[:60] for n in names) or "no attention kernel seen"


def run_float16_paths(kernels):
    """Two paths through the model with kernels on: (a) qwen2.5-3b at full
    width cast to float16 (`cast_params_for_compute(params, torch.float16)`,
    as a user of the reference's API may), batch 4, prompt 1000, 8 decode
    steps through `lm.prefill` / `lm.decode_step`; the profiler must see
    flash's and paged's float16 instantiations; prefill and first-step
    logits against `use_kernels=False` on the same weights, whose logits
    must be finite in float16 at this width. (b) qwen2.5-3b's smoke config
    at head size 512 (`dataclasses.replace`): prefill (prompt 130) and 3
    decode steps with kernels, through the wide bodies, logits against the
    plain path."""
    import dataclasses
    from repro_torch import configs, convert
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models import lm

    f16 = torch.float16
    cfg = configs.get_config(ARCH)
    steps = F16_DECODE_STEPS
    log(f"float16: {ARCH} at full width cast to float16, batch {BATCH}, "
        f"prompt {PROMPT_LEN}, {steps} decode steps, use_kernels=True")

    def path():
        gen = torch.Generator(device="cuda").manual_seed(0)
        params = lm.cast_params_for_compute(
            lm.init_model(cfg, gen, device="cuda"), f16)
        prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT_LEN),
                                generator=gen, device="cuda")
        cache = lm.init_cache(cfg, BATCH, PROMPT_LEN + steps + 1, dtype=f16,
                              device="cuda")
        logits, cache = lm.prefill(cfg, params, {"tokens": prompts}, cache,
                                   use_kernels=True, dtype=f16)
        first = convert.tree_map(torch.clone, cache)
        tok = torch.argmax(logits[:, -1], -1)[:, None]
        out = [tok]
        cur = convert.tree_map(torch.clone, cache)
        for _ in range(steps):
            lg, cur = lm.decode_step(cfg, params, tok, cur, use_kernels=True,
                                     dtype=f16)
            tok = torch.argmax(lg[:, -1], -1)[:, None]
            out.append(tok)
        return params, prompts, logits, first, torch.cat(out, 1)

    (params, prompts, logits, first, tokens), n_flash, n_paged = drive_path(
        f"{ARCH} float16", path)
    L = cfg.num_layers
    want_launches(ARCH + " float16", n_flash, n_paged, L, L * steps)
    kernels[0]["launches"] += n_flash
    kernels[1]["launches"] += n_paged
    check_tokens(ARCH + " float16", tokens, cfg.vocab_size,
                 (BATCH, steps + 1))
    if logits.dtype != f16 or first["scan"][0]["k"].dtype != f16:
        raise AssertionError(f"float16 path: logits {logits.dtype}, cache "
                             f"{first['scan'][0]['k'].dtype}")
    check_logits(ARCH + " float16", logits, cfg.vocab_size)
    # which instantiations ran: one decode step under the profiler
    names = kernel_names(lambda: lm.decode_step(
        cfg, params, tokens[:, :1], convert.tree_map(torch.clone, first),
        use_kernels=True, dtype=f16))
    names += kernel_names(lambda: lm.prefill(
        cfg, params, {"tokens": prompts[:, :256]},
        lm.init_cache(cfg, BATCH, 256, dtype=f16, device="cuda"),
        use_kernels=True, dtype=f16))
    ran = [n for n in names if "flash_" in n or "paged_attention_kernel" in n]
    log("  the attention kernels that ran: " + "; ".join(n[:90] for n in ran))
    for kind in ("flash_", "paged_attention_kernel"):
        if not any(kind in n and "__half" in n for n in ran):
            raise AssertionError(f"float16 path: no float16 instantiation of "
                                 f"{kind} ran ... FAIL")
    cache = lm.init_cache(cfg, BATCH, PROMPT_LEN + steps + 1, dtype=f16,
                          device="cuda")
    plain, _ = lm.prefill(cfg, params, {"tokens": prompts}, cache,
                          use_kernels=False, dtype=f16)
    finite = bool(torch.isfinite(plain.float()).all())
    log(f"  the plain path's float16 logits finite: {finite}")
    if not finite:
        raise AssertionError("float16: the plain path's logits are not "
                             "finite at full width")
    check_close(f"{ARCH} float16 prefill last-token logits, kernels vs plain "
                "path", logits, plain, **LOGITS_TOL)
    tok = tokens[:, :1]
    dec = [lm.decode_step(cfg, params, tok,
                          convert.tree_map(torch.clone, first),
                          use_kernels=uk, dtype=f16)[0] for uk in (True, False)]
    check_close(f"{ARCH} float16 first decode step's logits, kernels vs "
                "plain path", *dec, **LOGITS_TOL)
    del params, prompts, logits, first, cache, plain, dec
    free_cuda()

    small = dataclasses.replace(configs.get_smoke_config(ARCH), head_dim=512)
    prompt, steps, b = 130, 3, 2
    log(f"head size 512: {ARCH}'s smoke config with head_dim=512 "
        f"(flash {fa.body_for(torch.bfloat16, 512)}, paged "
        f"{pa.body_for(torch.bfloat16, 512)} body), prompt {prompt}, "
        f"{steps} decode steps")

    def wide():
        gen = torch.Generator(device="cuda").manual_seed(0)
        params = lm.cast_params_for_compute(
            lm.init_model(small, gen, device="cuda"))
        prompts = torch.randint(0, small.vocab_size, (b, prompt),
                                generator=gen, device="cuda")
        caches, logits = {}, {}
        for uk in (True, False):
            cache = lm.init_cache(small, b, prompt + steps + 1,
                                  device="cuda")
            lg, cache = lm.prefill(small, params, {"tokens": prompts}, cache,
                                   use_kernels=uk)
            logits[uk] = [lg]
            caches[uk] = cache
        tok = torch.argmax(logits[True][0][:, -1], -1)[:, None]
        for _ in range(steps):       # both paths decode the same tokens
            for uk in (True, False):
                lg, caches[uk] = lm.decode_step(small, params, tok,
                                                caches[uk], use_kernels=uk)
                logits[uk].append(lg)
            tok = torch.argmax(logits[True][-1][:, -1], -1)[:, None]
        return logits

    logits, n_flash, n_paged = drive_path("head size 512", wide)
    want_launches(f"{ARCH} head size 512", n_flash, n_paged,
                  small.num_layers, small.num_layers * steps)
    kernels[0]["launches"] += n_flash
    kernels[1]["launches"] += n_paged
    for i, (got, want) in enumerate(zip(logits[True], logits[False])):
        check_close(f"head size 512, {'prefill' if i == 0 else f'decode step {i}'}"
                    " logits, kernels vs plain path (bf16)", got, want,
                    **LOGITS_TOL)


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
            check_same(f"{knob}={value}", asc.async_scatter(
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
    check_same("quickstart GUPS xor vs ref.scatter_update_ref", res["out"],
                res["expect"])
    idx, upd, out = res["indices"], res["updates"], res["out"]
    res_table = res["table"]
    del res
    free_cuda()
    # the same xor on a uint32 view of the table: the int32 kernels on the
    # same bits, so the result is the quickstart's bit for bit
    u32 = drive(lambda: ops.scatter_update(res_table.view(torch.uint32), idx,
                                           upd.view(torch.uint32), "xor"))
    if u32.dtype != torch.uint32:
        raise AssertionError(f"uint32 GUPS: result is {u32.dtype}")
    check_same("GUPS xor on a uint32 view vs the int32 result",
                u32.view(torch.int32), out)
    del u32
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
            check_same(name, out, want)
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

    # scatter-add in bf16 at 128-byte rows (red.add.noftz.bf16x2)
    rows, width, m = 1 << 24, 64, 1 << 20
    table = amu_table(gen, (rows, width), torch.bfloat16)
    idx = amu_index(gen, rows, m)
    upd = amu_table(gen, (m, width), torch.bfloat16)
    name = f"scatter add [{rows},{width}] bfloat16, {m} updates"
    out = drive(lambda: ops.scatter_update(table, idx, upd, "add"))
    check_scatter16(name, out, table, idx, upd)
    nbytes, sector_bytes = scatter_bytes(idx, width * 2)
    bound_ms, bound_by = amu_bound(nbytes, m * width)
    ms = time_ms([lambda: asc.async_scatter(out, idx, upd, "add")], 20)
    plain_ms = time_ms([lambda: ref.scatter_update_ref(table, idx, upd,
                                                       "add")], 2, repeats=3)
    library_ms = time_ms([lambda: out.index_add_(0, idx, upd)], 20)
    report(name, "async_scatter", ms=ms, plain_ms=plain_ms,
           library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
           bytes=nbytes, touched_rows=torch.unique(idx).numel(),
           sector_bound_ms=amu_bound(sector_bytes)[0],
           host_us=host_us(lambda: asc.async_scatter(out, idx, upd, "add")))
    del table, idx, upd, out
    free_cuda()

    # the inputs added last: 8/16-bit integer and float8 tables at 64
    # elements a row and at rows of 3 and 6 bytes (the word path: a CAS
    # loop or a word's xor a lane; not bucketed: `bucketed`), bf16 at rows
    # of 6 bytes (a pair reduction a word, -0.0 beside a lone element), 2^20
    # updates of which a quarter go to 4096 hot rows
    rows, m = 1 << 24, 1 << 20
    extra_scatter = 0
    for dtype, op, width in ((torch.int8, "add", 64), (torch.int16, "add", 64),
                             (torch.uint16, "add", 64),
                             (torch.float8_e4m3fn, "add", 64),
                             (torch.float8_e5m2, "add", 64),
                             (torch.int8, "add", 3), (torch.int16, "add", 3),
                             (torch.uint16, "add", 3),
                             (torch.float8_e4m3fn, "add", 3),
                             (torch.float8_e5m2, "add", 6),
                             (torch.int8, "xor", 64), (torch.uint16, "xor", 64),
                             (torch.int8, "xor", 3), (torch.uint16, "xor", 3),
                             (torch.bfloat16, "add", 3)):
        table = rand_typed(gen, (rows, width), dtype)
        idx = amu_index(gen, rows, m)
        idx[::4] %= 4096
        upd = rand_typed(gen, (m, width), dtype)
        row_bytes = width * table.element_size()
        name = (f"scatter {op} [{rows},{width}] {tname(dtype)} ({row_bytes}-"
                f"byte rows), {m} updates")
        out = drive(lambda: ops.scatter_update(table, idx, upd, op))
        extra_scatter += 4 if asc.bucketed(row_bytes, rows, m) else 1
        if dtype.is_floating_point:
            check_scatter16(name, out, table, idx, upd)
        else:
            check_same(name, out, ref.scatter_update_ref(table, idx, upd, op))
        nbytes, sector_bytes = scatter_bytes(idx, row_bytes)
        bound_ms, bound_by = amu_bound(nbytes, m * width)
        ms = time_ms([lambda: asc.async_scatter(out, idx, upd, op)], 20)
        plain_ms = time_ms([lambda: ref.scatter_update_ref(table, idx, upd,
                                                           op)], 2, repeats=3)
        library_ms = None     # torch has no xor and no float8 add to time
        if op == "add" and dtype not in FP8:
            try:
                library_ms = time_ms([lambda: out.index_add_(0, idx, upd)],
                                     20)
            except (RuntimeError, NotImplementedError) as e:
                log(f"    index_add_ does not take {tname(dtype)} here: "
                    f"{str(e).splitlines()[0][:80]}")
        plan = asc.launch_plan(out, m, op)
        report(name, "async_scatter", ms=ms, plain_ms=plain_ms,
               library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
               bytes=nbytes, touched_rows=torch.unique(idx).numel(),
               sector_bound_ms=amu_bound(sector_bytes)[0],
               host_us=host_us(lambda: asc.async_scatter(out, idx, upd, op)))
        log(f"    chunk {plan.chunk} ({'word path' if plan.chunk == 1 else 'reductions'}"
            f"), {plan.launches} launches, spans of {plan.span}")
        del table, idx, upd, out
        free_cuda()

    # gather: 512-byte rows of an 8 GiB table, then the embedding lookup,
    # then rows of 6 and 3 bytes (the element path)
    cfg = configs.get_config(ARCH)
    gathers = [((1 << 24, 128), torch.float32, 1 << 20, "random rows"),
               ((cfg.vocab_size, cfg.d_model), torch.bfloat16,
                BATCH * PROMPT_LEN, f"{ARCH} embedding, {BATCH}x{PROMPT_LEN} "
                "token ids"),
               ((1 << 24, 3), torch.bfloat16, 1 << 20, "rows of 6 bytes"),
               ((1 << 24, 3), torch.int8, 1 << 20, "rows of 3 bytes"),
               ((1 << 24, 64), torch.float8_e4m3fn, 1 << 20,
                "float8 rows of 64 bytes")]
    for i, (shape, dtype, m, what) in enumerate(gathers):
        table = rand_typed(gen, shape, dtype) if dtype in FP8 \
            else amu_table(gen, shape, dtype)
        idx = amu_index(gen, shape[0], m)
        name = f"gather [{shape[0]},{shape[1]}] {str(dtype)[6:]}, {m} {what}"
        out = drive(lambda: ops.gather(table, idx))
        check_same(name, out, ref.gather_ref(table, idx))
        # the library call on the rows' bytes (index_select of float8 rows)
        lib_table = bits(table) if dtype in FP8 else table
        check_same("  (library call agrees)", torch.index_select(
            lib_table, 0, idx), bits(out) if dtype in FP8 else out)
        row_bytes = shape[1] * table.element_size()
        touched = torch.unique(idx).numel()
        nbytes = touched * row_bytes + m * row_bytes + m * 4
        bound_ms, bound_by = amu_bound(nbytes)
        ms = time_ms([lambda: ag.async_gather(table, idx)], 20)
        plain_ms = time_ms([lambda: ref.gather_ref(table, idx)], 20)
        library_ms = time_ms([lambda: torch.index_select(lib_table, 0, idx)],
                             20)
        plan = ag.launch_plan(table, m)
        report(name, "async_gather", ms=ms, plain_ms=plain_ms,
               library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
               bytes=nbytes, touched_rows=touched,
               rows_in_flight_per_sm=plan.rows_in_flight_per_sm,
               host_us=host_us(lambda: ag.async_gather(table, idx)),
               library_host_us=host_us(
                   lambda: torch.index_select(lib_table, 0, idx)))
        log(f"    {plan.blocks} blocks of {plan.rows} rows, {plan.warps} "
            f"warps, {'bulk' if plan.bulk else 'cp.async' if plan.chunk >= 4 else 'element'} path; host "
            f"{cases[-1]['host_us']:.1f} us a call (index_select "
            f"{cases[-1]['library_host_us']:.1f} us)")
        if i == 0:
            gather_main = cases[-1]
        if i >= 2:                  # only the first two sweep their ring
            del table, idx, out, lib_table
            free_cuda()
            continue
        # the paper's "queue length follows demand": ring depth K, on the
        # 8 GiB table and on the embedding table
        log(f"  ring-depth sweep on {name} ({plan.blocks} blocks of "
            f"{plan.rows} indices at K=8):")
        for slots in (1, 2, 4, 8, 16, 32):
            check_same(f"K={slots}", ag.async_gather(
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
        del table, idx, out, lib_table
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
    b, c = randn(gen, (n,), torch.float16), randn(gen, (n,), torch.float16)
    name = f"triad f16 N={n} ({n * 2 / 2**30:.1f} GiB an array)"
    a = drive(lambda: ops.triad(b, c, 3.0))
    check_same(name, a, ref.triad_ref(b, c, 3.0))
    check_close_big("  (library call agrees)", torch.add(b, c, alpha=3.0), a,
                    **TRIAD_TOL[torch.float16])
    report(name, "stream_triad",
           ms=time_ms([lambda: st.stream_triad(b, c, 3.0)], 20),
           plain_ms=time_ms([lambda: ref.triad_ref(b, c, 3.0)], 10),
           library_ms=time_ms([lambda: torch.add(b, c, alpha=3.0)], 20),
           bound_ms=amu_bound(3 * n * 2, 2 * n)[0],
           bound_by=amu_bound(3 * n * 2, 2 * n)[1], bytes=3 * n * 2,
           host_us=host_us(lambda: st.stream_triad(b, c, 3.0)))
    del a, b, c
    free_cuda()
    # the triad in the types added last, bit for bit, each with inputs that
    # pass the type's range (integers drawn over the whole type wrap,
    # float8 drawn wide gives NaN / inf); s = 3.3 is 3 for the integers
    triad_types = (torch.bfloat16, torch.int8, torch.uint8, torch.int16,
                   torch.uint16, torch.int32, torch.uint32, *FP8)
    for dtype in triad_types:
        scale = OVERFLOW_SCALE.get(dtype, 1.0)
        b, c = rand_typed(gen, (n,), dtype, scale), rand_typed(gen, (n,),
                                                               dtype, scale)
        item = b.element_size()
        name = (f"triad {tname(dtype)} N={n} (inputs past the range: "
                f"{'wrap' if not dtype.is_floating_point else 'NaN / inf'})")
        a = drive(lambda: ops.triad(b, c, 3.3))
        check_same(name, a, ref.triad_ref(b, c, 3.3))
        # torch.add has no float8 form, and some versions none for uint16
        # or uint32 on the card; bf16's rounds once (not held, only timed)
        library_ms, alpha = None, ref.round_scalar(3.3, dtype)
        lib_out = None
        if dtype not in FP8:
            try:
                lib_out = torch.add(b, c, alpha=alpha)
            except (RuntimeError, TypeError):
                pass
        if lib_out is not None:
            if not dtype.is_floating_point:
                check_same("  (library call agrees)", lib_out, a)
            library_ms = time_ms([lambda: torch.add(b, c, alpha=alpha)], 20)
        del lib_out
        report(name, "stream_triad",
               ms=time_ms([lambda: st.stream_triad(b, c, 3.3)], 20),
               plain_ms=time_ms([lambda: ref.triad_ref(b, c, 3.3)], 5),
               library_ms=library_ms,
               bound_ms=amu_bound(3 * n * item, 2 * n)[0],
               bound_by=amu_bound(3 * n * item, 2 * n)[1], bytes=3 * n * item,
               host_us=host_us(lambda: st.stream_triad(b, c, 3.3)))
        del a, b, c
        free_cuda()

    # one launch per ops call, but async_scatter's GUPS (8-byte rows) runs
    # the bucket pass's three kernels before its apply: 4 + 4 (its uint32
    # view) + 1 + 1 + 1 (bf16 add), and the later types' scatters (four
    # for a bucketed call, `bucketed`)
    want = {"async_gather": 5, "async_scatter": 11 + extra_scatter,
            "stream_triad": 2 + len(triad_types)}
    log(f"  launches on the AMU path: {counts} (want {want}: one per ops "
        "call, four for each bucketed scatter)")
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


# ------------------------------------------------------------------ examples
EXAMPLE_ARCH = "phi4-mini-3.8b"     # head size 8 at smoke size
EXAMPLE_STEPS, EXAMPLE_FAIL_AT = 30, 15


def run_examples(kernels):
    """The port's counterparts of `examples/` on the card: `serve_paged --lm
    --use-kernels` at phi4-mini-3.8b's smoke size and a prompt of 130 (head
    size 8 through flash and paged; two waves of 15 decode steps), and
    `train_far_memory` for EXAMPLE_STEPS steps with a failure injected at
    EXAMPLE_FAIL_AT (one restart from the step-10 checkpoint)."""
    import tempfile

    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import serve_paged, train_far_memory

    cfg = configs.get_smoke_config(EXAMPLE_ARCH)
    argv = ["--lm", "--use-kernels", "--arch", EXAMPLE_ARCH, "--prompt-len",
            "130"]
    log(f"examples: serve_paged {' '.join(argv)} (head size "
        f"{cfg.resolved_head_dim}, flash {fa.body_for(torch.bfloat16, cfg.resolved_head_dim)} body)")
    res, n_flash, n_paged = drive_path("serve_paged --lm",
                                       lambda: serve_paged.main(argv))
    L, args = cfg.num_layers, serve_paged.parse(argv)
    want_launches("serve_paged", n_flash, n_paged, 2 * L,
                  2 * L * (args.max_new - 1))
    for toks in res["tokens"]:
        check_tokens("serve_paged", toks, cfg.vocab_size,
                     (args.batch, args.max_new))
    kernels[0]["launches"] += n_flash
    kernels[1]["launches"] += n_paged
    log(f"  decode {', '.join(f'{r:.1f}' for r in res['tok_s'])} tok/s a "
        f"wave (host clock; {args.batch} x {args.max_new - 1} steps)")

    ckpt = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    targv = ["--steps", str(EXAMPLE_STEPS), "--fail-at", str(EXAMPLE_FAIL_AT),
             "--ckpt", ckpt]
    log(f"examples: train_far_memory {' '.join(targv[:4])}")
    res, n_flash, n_paged = drive_path(
        "train_far_memory", lambda: train_far_memory.main(targv))
    shutil.rmtree(ckpt, ignore_errors=True)
    want_launches("train_far_memory", n_flash, n_paged, 0, 0)
    restart = EXAMPLE_FAIL_AT // 10 * 10           # the last checkpoint
    want_steps = list(range(EXAMPLE_FAIL_AT)) + list(range(restart,
                                                          EXAMPLE_STEPS))
    if (res["restarts"], res["step"]) != (1, EXAMPLE_STEPS) or \
            [r["step"] for r in res["history"]] != want_steps or \
            not math.isfinite(res["loss"]):
        raise AssertionError(f"train_far_memory: restarts {res['restarts']},"
                             f" ended at step {res['step']}, loss "
                             f"{res['loss']}, steps run "
                             f"{[r['step'] for r in res['history']]}")
    log(f"  {len(res['history'])} steps run (restart from step {restart}), "
        f"final loss {res['loss']:.4f}, first {res['history'][0]['loss']:.4f};"
        f" {res['wall_s']:.1f} s")


# ------------------------------------------------------------------ mutants
# Broken copies of the redesigned kernels that phase 3 must catch, each one
# edit of a source of src/repro_torch/kernels/csrc/: (file, text, its
# replacement). The text must be in the file exactly once, so that a mutant
# always breaks the kernel as it stands.
PAGED_GETFIN = ("    mbar_wait(&full[j % a.slots], (uint32_t)((j / a.slots) & 1));"
                "  // getfin\n")
TRIAD_GETFIN = ("      mbar_wait(&full[t % stages], (uint32_t)((t / stages) & "
                "1));  // getfin\n")
TRIAD_DONE = ("        mbar_wait(&done[t % stages], (uint32_t)((t / stages) & "
              "1));\n")
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
    # the last block of a segment leaves its ticket standing (both bodies:
    # `merge_partials`)
    "paged_ticket": [("paged_attention.cu",
                      "    if (last) atomicExch(&tickets[s], 0);",
                      "")],
    # the merge leaves out the last partial of its second set (of all, where
    # each set takes all of them: HX 2)
    "paged_merge": [("paged_attention.cu",
                     "      const int np_all = first_half ? half : m_n - half;",
                     "      const int np_all = first_half ? half - (HX == 2) "
                     ": m_n - half - 1;")],
    # the threads compute from a slot without waiting for its loads
    "triad_getfin": [("stream_triad.cu", TRIAD_GETFIN, "")],
    # a slot's bulk store is issued before the threads have computed it
    # (the producer does not wait on the step's `done`)
    "triad_store": [("stream_triad.cu", TRIAD_DONE, "")],
    # head sizes below a body's own (Dp): each body stores Dp columns ...
    "flash_wgmma_store_dp": [("flash_attention.cu",
                              "    if (!EXACT && col >= dh) break;     "
                              "// columns dh.. are another head's\n", "")],
    "flash_mma_store_dp": [("flash_attention.cu",
                            "    if (!EXACT && col >= dh) break;     "
                            "// past the head: the next one's\n", "")],
    "flash_fma_store_dp": [("flash_attention.cu",
                            "if (EXACT || col(c) < Dh)",
                            "if (EXACT || col(c) < D)")],
    "paged_store_dp": [("paged_attention.cu",
                        "if (EXACT || d0 + e < Dh) put(o + e, "
                        "acc[x][e] * inv);", "put(o + e, acc[x][e] * inv);"),
                       ("paged_attention.cu",
                        "if (EXACT || d0 + e < Dh) put(o + e, "
                        "as[e] * inv);", "put(o + e, as[e] * inv);"),
                       ("paged_attention.cu",
                        "            if (c0 + pc * WIDE_DC + d0 + e < Dh)\n"
                        "              put(o + pc * WIDE_DC + e, x[e] * inv);",
                        "              put(o + pc * WIDE_DC + e, x[e] * inv);"),
                       ("paged_attention.cu",
                        "if (c0 + pc * WIDE_DC + d0 + e < Dh) put(o + e, "
                        "as[e] * inv);", "put(o + e, as[e] * inv);")],
    # ... scales by 1 / sqrt(Dp) ...
    "flash_scale_dp": [("flash_attention.cu",
                        "static_cast<float>(1.0 / sqrt((double)D));",
                        "static_cast<float>(1.0 / sqrt((double)Dp));")],
    "paged_scale_dp": [("paged_attention.cu",
                        "static_cast<float>(1.0 / sqrt((double)D));",
                        "static_cast<float>(1.0 / sqrt((double)Dp));")],
    # ... or loads the next head's columns into the tail instead of zeros
    "flash_wgmma_load_tail": [("flash_attention.cu",
                               "cuuint64_t dims[4] = {(cuuint64_t)D, 0, 0, "
                               "0}", "cuuint64_t dims[4] = {(cuuint64_t)"
                               "((D + 63) / 64 * 64), 0, 0, 0}")],
    "flash_mma_load_tail": [("flash_attention.cu",
                             "col_in[j] = EXACT || c * 8 < dh;",
                             "col_in[j] = true;")],
    "flash_fma_load_tail": [("flash_attention.cu",
                             "const bool in = row0 + r < S && c * 4 < dh;",
                             "const bool in = row0 + r < S;"),
                            ("flash_attention.cu",
                             "if (i < ROWS * UPR && row0 + r < S && c < dh) {",
                             "if (i < ROWS * UPR && row0 + r < S) {")],
    "paged_load_tail": [("paged_attention.cu",
                         "return c < dh ? row[c] : zero<E>();",
                         "return row[c];")],
    # the wide bodies (D > 256): a block (the pair body: a warpgroup)
    # stores its chunk at the head's first columns ...
    "flash_wgmma_wide_chunk": [("flash_attention.cu",
                                "  T* const ob = o + b * o_sb + h * o_sh + cw;",
                                "  T* const ob = o + b * o_sb + h * o_sh;")],
    "flash_fma_wide_chunk": [("flash_attention.cu",
                              "    E* ob = o + b * o_sb + h * o_sh + vc0;",
                              "    E* ob = o + b * o_sb + h * o_sh;")],
    # ... scales by 1 / sqrt of the chunk's width, not of D ...
    "flash_scale_dc": [("flash_attention.cu",
                        "static_cast<float>(1.0 / sqrt((double)D));",
                        "static_cast<float>(1.0 / sqrt((double)"
                        "(D > 256 ? 256 : D)));")],
    "paged_scale_dc": [("paged_attention.cu",
                        "static_cast<float>(1.0 / sqrt((double)D));",
                        "static_cast<float>(1.0 / sqrt((double)"
                        "(D > 256 ? 256 : D)));")],
    # ... or (paged) takes Q K^T over the first piece's columns only
    "paged_wide_qk": [("paged_attention.cu",
                       "          ok[e] = pc * WIDE_DC + d0 + e < Dh;",
                       "          ok[e] = pc == 0 && d0 + e < Dh;")],
    # float16 operands through a bf16 wgmma (Q K^T at D = 256 and above)
    "flash_f16_as_bf16": [("flash_attention.cu",
                           "    WGMMA_SS_64(\"f16\");",
                           "    WGMMA_SS_64(\"bf16\");")],
    # the element gather copies one byte of each 2-byte element
    "gather_element_byte": [("async_gather.cu",
                             "template <> struct Elem<2> { using type = "
                             "uint16_t; };",
                             "template <> struct Elem<2> { using type = "
                             "uint8_t; };")],
    # a 16-bit add reduces each update on its neighbouring element
    "scatter16_neighbour": [("async_scatter.cu",
                             "    red_add2<E>(dst, *reinterpret_cast<const "
                             "uint32_t*>(src));",
                             "    red_add2<E>(dst, __byte_perm(*reinterpret_"
                             "cast<const uint32_t*>(src), 0, 0x1032));")],
    # the inputs added last: the triad rounding bf16 / fp8 once, at the end
    # (as the port did before it rounded where the reference does) ...
    "triad_one_rounding": [("stream_triad.cu",
                            "    if constexpr (kRoundProduct<E>) sc = "
                            "to_float(from_float<E>(sc));\n", ""),
                           ("stream_triad.cu",
                            "a2[i] = __hadd2_rn(b2[i], __hmul2_rn(s2, "
                            "c2[i]));",
                            "a2[i] = __hfma2(s2, c2[i], b2[i]);")],
    # ... fp8 conversions saturating (e4m3fn 500 -> 448, not NaN: the
    # hardware's conversion without the overflow set after it) ...
    "fp8_satfinite": [("common.cuh",
                       "  return over ? (__nv_fp8_storage_t)",
                       "  return false ? (__nv_fp8_storage_t)")],
    # ... the scatter's CAS as a load, an add and a store ...
    "scatter_cas_store": [("async_scatter.cu",
                           "        got[i] = cas_unit<U>(p[i], seen[i],\n",
                           "        got[i] = seen[i], *reinterpret_cast<"
                           "Unit<U>*>(p[i]) = (\n")],
    # ... its word path taking the byte past the row (a neighbour's xor) ...
    "scatter_word_past_row": [("async_scatter.cu",
                               "    if (o >= 0 && o < R) {",
                               "    if (o >= 0 && o <= R) {")],
    # ... dropping a bf16 / f16 element whose pair is a neighbour's ...
    "scatter16_lone_dropped": [("async_scatter.cu",
                                "      if (!nan16<E>(nb))\n        "
                                "red_add2<E>(p, w | (0x80008000u & "
                                "~inside));\n",
                                "      if (!nan16<E>(nb))\n        ;\n")],
    # ... or reading e5m2 as e4m3
    "fp8_e5m2_as_e4m3": [("common.cuh",
                          "__nv_cvt_fp8_to_halfraw(x.__x, __NV_E5M2)",
                          "__nv_cvt_fp8_to_halfraw(x.__x, __NV_E4M3)")],
    # flash's redesigned bodies: the element loader reading columns past D
    # (the next head's) where it writes zeros ...
    "flash_elem_past_d": [("flash_attention.cu",
                           "const bool col_in = byte < dh * 2;",
                           "const bool col_in = true;"),
                          ("flash_attention.cu",
                           "const int n_col = min(E, dh - c) * IT;",
                           "const int n_col = E * IT;")],
    # ... storing its pieces without the 128-byte swizzle ...
    "flash_elem_unswizzled": [("flash_attention.cu",
                               "  return ((p & 7) ^ (r & 7)) << 4;",
                               "  return (p & 7) << 4;")],
    # ... and the second consumer warpgroup at D = 256 taking the first
    # one's rows for its masks and stores
    "flash_256_rlo": [("flash_attention.cu",
                       "  const int rlo = q0 + wgi * 64;",
                       "  const int rlo = q0 + (D == 256 ? 0 : wgi) * 64;")],
    # paged over fp8 caches on the tensor cores: K's fragments converted as
    # the other kind (e5m2 read as e4m3) ...
    "paged_fp8_k_kind": [("paged_attention.cu",
                          "const int k_e5m2 = a.e5m2;",
                          "const int k_e5m2 = 0;")],
    # ... V's byte permute pairing the wrong keys (rows 2t + 1, 2t for the
    # even columns) ...
    "paged_fp8_v_pairs": [("paged_attention.cu",
                           "const uint32_t sel = nt & 1 ? 0x3131u : "
                           "0x2020u;",
                           "const uint32_t sel = nt & 1 ? 0x3131u : "
                           "0x0202u;")],
    # ... and the output in fp8 saturating (e4m3fn 500 -> 448, not NaN)
    "paged_fp8_out_saturating": [("paged_attention.cu",
                                  "          to_fp8(x, qt == DTYPE_E5M2 ? "
                                  "__NV_E5M2 : __NV_E4M3);",
                                  "          __nv_cvt_float_to_fp8(x, "
                                  "__NV_SATFINITE, qt == DTYPE_E5M2 ? "
                                  "__NV_E5M2 : __NV_E4M3);")],
    # the scatter's lone 16-bit element: the neighbour's half carrying +0.0
    # (which turns a -0.0 neighbour into +0.0) ...
    "scatter16_plus_zero": [("async_scatter.cu",
                             "red_add2<E>(p, w | (0x80008000u & ~inside));",
                             "red_add2<E>(p, w);")],
    # ... and the apply of a call that is not bucketed (K slots: K > 1)
    # reducing each update into the row after its own
    "scatter_unbucketed_next_row": [("async_scatter.cu",
                                     "        reduce_row<W, OP, E>(table, "
                                     "(long long)row * R,",
                                     "        reduce_row<W, OP, E>(table, "
                                     "(long long)(row + (K > 1)) * R,")],
    # flash's fp8 body by TMA: the e4m3 wgmma on e5m2 tiles ...
    "flash_fp8_kind_swapped": [("flash_attention.cu",
                                "    WGMMA_SS8_128(\"e5m2\");",
                                "    WGMMA_SS8_128(\"e4m3\");"),
                               ("flash_attention.cu",
                                "    WGMMA_SS8_64(\"e5m2\");",
                                "    WGMMA_SS8_64(\"e4m3\");")],
    # ... the consumers not waiting for the converted (f16) V slot, nor so
    # for K ...
    "flash_fp8_v_ready_skipped": [("flash_attention.cu",
                                   "      if (!dead) mbar_wait(&v_ready[s], "
                                   "(i / STAGES) & 1);", "")],
    # ... and Q K^T as one chain of all D / 32 k-steps, not chains of 2
    "flash_fp8_chain_unsplit": [("flash_attention.cu",
                                 "        constexpr int CHAIN = 2, CHAINS",
                                 "        constexpr int CHAIN = 8, CHAINS")],
    # paged with segments of several KV heads: warp w reading the rows of
    # the segment's next KV head
    "paged_heads_offset": [("paged_attention.cu",
                            "  const int kvh = HEADS ? hw / a.G : 0;",
                            "  const int kvh = HEADS ? (hw / a.G + 1) % "
                            "a.heads : 0;")],
    # the 16-bit integer add on a returning add: the carry repair dropped
    # (the high half keeps the low half's carry) ...
    "add16_repair_dropped": [("async_scatter.cu",
                              "        red_add(p[i], 0xffff0000u);\n",
                              "        ;\n")],
    # ... a repair on a word only the row's high half touches, by the carry
    # of its element added to the neighbour's low half ...
    "add16_repair_high_half": [("async_scatter.cu",
                                "        red_add(p[i], w);\n",
                                "        old[i] = atom_add(p[i], w);\n"
                                "        lo[i] = w >> 16;\n")],
    # ... paged at 16 query heads a segment: a warp's second head (n-tile
    # 1, heads 8-15) reading the first head's q ...
    "paged_pair_q": [("paged_attention.cu",
                      "const int qrow = (mi >> 1) * 8 + ri;",
                      "const int qrow = ri;")],
    # ... and the last block of a merge group leaving its ticket standing
    # (both bodies: `merge_partials`)
    "paged_group_ticket": [("paged_attention.cu",
                            "      if (last) atomicExch(gt, 0);\n",
                            "")],
    # flash's mma.sync body masking only straddling tiles: the diagonal's
    # tile taken as interior for a warp unless it straddles its last row
    "flash_mma_straddle": [("flash_attention.cu",
                            "(causal && k0 + BN - 1 > rw) ||",
                            "(causal && k0 + BN - 1 > rw + 15) ||")],
    # the triad's steps of 4 / item bulk copies: the last copy of a step
    # not issued at 8 and 16 bits (its bytes never land: the step's
    # mbarrier never completes and the copy is killed) ...
    "triad_step_copy": [("stream_triad.cu",
                         "        for (int j = 0; j < K; ++j) {              "
                         "// one block an aload\n",
                         "        for (int j = 0; j + (K > 1) < K; ++j) {\n")],
    # ... and its 8-bit lanes added as one 32-bit word (b unmasked: a
    # byte's carry reaches the next lane)
    "triad_word_carry": [("stream_triad.cu",
                          "  const uint32_t even = (b & M) + (c & M) * s;",
                          "  const uint32_t even = b + (c & M) * s;")],
    # paged over rows of no whole 16-byte pieces: a warp reading its KV
    # head's rows from the box's first head, not from the segment's place
    # in the box (fp8 D8 at Hkv2: a box of two heads for segments of one) ...
    "paged_run_head": [("paged_attention.cu",
                        "      hoff = h % a.box_heads + kvh;",
                        "      hoff = kvh;")],
    # ... the copy taking a run's heads as contiguous (strided heads) ...
    "paged_copy_head_stride": [("paged_attention.cu",
                                "      const long long ko = r * c.k_t + "
                                "hh * c.k_h + xu * w;",
                                "      const long long ko = r * c.k_t + "
                                "hh * c.units * w + xu * w;")],
    # ... the copy one load short of each head's row ...
    "paged_copy_units": [("paged_attention.cu",
                          "a.box_heads, a.dh * ITEM / a.width};",
                          "a.box_heads, a.dh * ITEM / a.width - 1};")],
    # ... and a lane's columns read as one vector where the row's are no
    # whole vectors (D98 at Dp 128: misaligned)
    "paged_row_vector": [("paged_attention.cu",
                          "  const bool vrow = !HEADS || a.dh % EPL == 0;",
                          "  const bool vrow = true;")],
    # flash's pair body: a warpgroup's own part of S taken without the
    # other's first column of each pair ...
    "flash_pair_exchange": [("flash_attention.cu",
                             "        sacc[4 * j] += x.x;\n", "")],
    # ... and read before the barrier that says the other has written it
    "flash_pair_barrier": [("flash_attention.cu",
                            "      asm volatile(\"bar.sync 1, %0;\\n\" ::\"n\""
                            "(2 * 128) : \"memory\");\n", "")],
    # the scatter's batched compare-and-swaps (8-bit integer and fp8 add):
    # a word whose CAS lost dropped, not retried ...
    "scatter_cas_drop": [("async_scatter.cu",
                          "        live[i] = !same(got[i], seen[i]);    "
                          "// lost: again, from the return\n",
                          "        live[i] = false;\n")],
    # ... and retried with its first load as the expectation, not the
    # returned word (it never wins again: the copy spins and is killed)
    "scatter_cas_first_load": [("async_scatter.cu",
                                "        seen[i] = got[i];\n", "")],
    # paged's tensor-core body over the whole head above 256 columns: Q K^T
    # without K's last 32 columns (the last two k-steps) ...
    "paged_wide_mma_k": [("paged_attention.cu",
                          "          for (int kk = 0; kk < D / 16; kk += 2) {",
                          "          for (int kk = 0; kk < D / 16 - 2; "
                          "kk += 2) {")],
    # ... and P V without a warp's last 16 columns of V
    "paged_wide_mma_v": [("paged_attention.cu",
                          "            for (int i = 0; i < NTW / 2; ++i) {\n"
                          "              uint32_t b4[4];",
                          "            for (int i = 0; i < NTW / 2 - 1; ++i) {\n"
                          "              uint32_t b4[4];")],
    # flash's fma body: K's ring slot freed as soon as it has landed, before
    # Q K^T has read it (the producer refills it under the reads) ...
    "flash_fma_free_early": [
        ("flash_attention.cu",
         "      mbar_wait(&full[sk], (uint32_t)((it / SLOTS) & 1));     "
         "// getfin: K\n",
         "      mbar_wait(&full[sk], (uint32_t)((it / SLOTS) & 1));     "
         "// getfin: K\n      if (lane == 0) mbar_arrive(&empty[sk]);\n"),
        ("flash_attention.cu",
         "        mbar_arrive(&empty[sk]);                  "
         "// K's slot is free\n", "")],
    # ... and Q K^T without waiting for its K tile (getfin)
    "flash_fma_getfin": [("flash_attention.cu",
                          "      mbar_wait(&full[sk], (uint32_t)((it / SLOTS) "
                          "& 1));     // getfin: K\n", "")],
    # its clusters above 256 columns: a CTA that takes its own partial
    # logits for the cluster's ...
    "flash_fma_own_partial": [("flash_attention.cu",
                               "      sum_partials(s, buf(j), ncta);\n",
                               "")],
    # ... the peers' partials read from one buffer (no parity) without
    # waiting for the cluster's arrivals ...
    "flash_fma_xch_unsynced": [
        ("flash_attention.cu",
         "return xch + (j & 1) * 2 * FMA_NT + tid;",
         "return xch + tid;"),
        ("flash_attention.cu",
         "      hopper::mbar_wait_cluster(&xfull[j & 1], "
         "(uint32_t)((j >> 1) & 1));\n", "")],
    # ... a rank's Q from another rank's columns than its K ...
    "flash_fma_rank_cols": [("flash_attention.cu",
                             "fma_aload<E, D, BMF>(Qs, qb + qc0, q_ss,",
                             "fma_aload<E, D, BMF>(Qs, qb + (ncta - 1 - rank)"
                             " * WIDE_DC, q_ss,")],
    # ... and the 64-row tile's rule, the source's unlike the wrapper's
    "flash_fma_rows_rule": [("flash_attention.cu",
                             "(long long)((S + 127) / 128) * B * Hq < sms)",
                             "(long long)((S + 127) / 128) * B * Hq <= sms)")],
    # paged's wide body: a K piece's slot freed as soon as it has landed ...
    "paged_wide_free_early": [
        ("paged_attention.cu",
         "      const int i = it + pc, slot = i % a.slots;\n"
         "      mbar_wait(&full[slot], (uint32_t)((i / a.slots) & 1));   "
         "// getfin\n",
         "      const int i = it + pc, slot = i % a.slots;\n"
         "      mbar_wait(&full[slot], (uint32_t)((i / a.slots) & 1));   "
         "// getfin\n      if (lane == 0) mbar_arrive(&empty[slot]);\n"),
        ("paged_attention.cu",
         "        lgt += part[0];\n      }\n"
         "      __syncwarp();\n      if (lane == 0) mbar_arrive(&empty[slot]);"
         "   // this warp is past it\n",
         "        lgt += part[0];\n      }\n")],
    # ... P V without waiting for its V piece (getfin) ...
    "paged_wide_getfin": [("paged_attention.cu",
                           "      const int i = it + a.npk + pc, slot = i % "
                           "a.slots;\n      mbar_wait(&full[slot], (uint32_t)"
                           "((i / a.slots) & 1));   // getfin\n",
                           "      const int i = it + a.npk + pc, slot = i % "
                           "a.slots;\n")],
    # ... Q K^T skipping each warp's last K piece ...
    "paged_wide_k_piece": [("paged_attention.cu",
                            "        lgt += part[0];\n",
                            "        if (pc + NSET < a.npk) lgt += part[0];\n")],
    # ... only a warp's first piece of columns rescaled by alpha ...
    "paged_wide_rescale": [("paged_attention.cu",
                            "        for (int e = 0; e < EPL; ++e) x[e] *= "
                            "alpha;",
                            "        for (int e = 0; e < EPL; ++e) if (pp "
                            "== 0) x[e] *= alpha;")],
    # ... a merge leaving out its last partial ...
    "paged_wide_merge": [("paged_attention.cu",
                          "              if (k0 + k < m_n) {",
                          "              if (k0 + k < m_n - 1) {")],
    # ... and above 2048 columns (a grid dimension of chunks of 2048; caught
    # only where a head has more than one): a chunk's output written at the
    # head's first columns ...
    "paged_wide_chunk_out": [("paged_attention.cu",
                              "        const long long o = out_index(a, b, h, "
                              "g0, hw) + c0 + d0;",
                              "        const long long o = out_index(a, b, h, "
                              "g0, hw) + d0;"),
                             ("paged_attention.cu",
                              "              out_index(a, b, h, g0, hw) + c0 + "
                              "pc * WIDE_DC + d0;",
                              "              out_index(a, b, h, g0, hw) + "
                              "pc * WIDE_DC + d0;")],
    # ... or its logits over its own columns of K only, not the whole head's
    "paged_wide_chunk_k": [("paged_attention.cu",
                            "        const int col = kv ? c0 + (x - a.npk) * "
                            "WIDE_DC : x * WIDE_DC;",
                            "        const int col = kv ? c0 + (x - a.npk) * "
                            "WIDE_DC : c0 + x * WIDE_DC;")],
}


# ------------------------------------------------------------------ phase 7
PARALLEL_ARCH = "qwen2.5-3b"
PARALLEL_STEPS = 3
PARALLEL_RTOL = 1e-6
# the dry run's cells: every arch at TRAIN_4K on the 16x16 mesh, and the two
# largest on 2x16x16; rwkv6 with the chunk-parallel mixer (the reference's
# `--tune`), since the default per-token scan is a 4096-step Python loop in
# eager, and at chunks of 256 rather than 64 (a fourth of the loop: at 64
# the cell took 139 s of the H100 machine's host, the next slowest 34 s)
DRYRUN_CELLS = [(a, False) for a in (
    "recurrentgemma-9b", "qwen2-vl-2b", "qwen2-7b", "qwen2.5-32b",
    "phi4-mini-3.8b", "qwen2.5-3b", "rwkv6-7b", "kimi-k2-1t-a32b",
    "granite-moe-1b-a400m", "hubert-xlarge")] + [
    ("qwen2.5-32b", True), ("kimi-k2-1t-a32b", True)]
DRYRUN_TUNE = {"rwkv6-7b": ["rwkv.impl=chunked", "rwkv.chunk=256"]}
DRYRUN_TIMEOUT_S = 600
PARALLEL_RESULTS = {}


def kernel_launches() -> dict:
    from repro_torch.kernels import (async_gather, async_scatter,
                                     flash_attention, paged_attention,
                                     stream_triad)
    mods = {"flash_attention": flash_attention,
            "paged_attention": paged_attention, "async_gather": async_gather,
            "async_scatter": async_scatter, "stream_triad": stream_triad}
    return {name: mod.launches for name, mod in mods.items()}


def reset_kernel_launches() -> None:
    from repro_torch.kernels import (async_gather, async_scatter,
                                     flash_attention, paged_attention,
                                     stream_triad)
    for mod in (flash_attention, paged_attention, async_gather,
                async_scatter, stream_triad):
        mod.launches = 0


def _timed_steps(step, params, opt, cfg, shape, label):
    """PARALLEL_STEPS steps on `synthetic_batch` of steps 0, 1, ... ->
    rows of loss, grad norm and ms (host clock around a step ending in a
    synchronise)."""
    from repro_torch.data.pipeline import batch_to, synthetic_batch
    rows = []
    for i in range(PARALLEL_STEPS):
        batch = batch_to(synthetic_batch(cfg, shape, i), "cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        torch.cuda.synchronize()
        rows.append({"loss": float(m["loss"]),
                     "grad_norm": float(m["grad_norm"]),
                     "ms": (time.perf_counter() - t0) * 1e3})
        log(f"  {label} step {i}: loss {rows[-1]['loss']:.6f}, grad norm "
            f"{rows[-1]['grad_norm']:.6f}, {rows[-1]['ms']:.1f} ms")
    return rows


def run_parallel_step():
    """(a) The sharded train step on the card: a one-rank `nccl` group, a
    (1, 1) ("data", "model") DeviceMesh, qwen2.5-3b at full width (the
    training phase's run: B2 S4096, 2 microbatches, remat full, bf16
    compute on fp32 masters, seed 0), PARALLEL_STEPS steps through
    `steps.jit_train_step` on DTensors, then on a freed card as many steps
    of `steps.make_train_step` from the same seed. Losses and grad norms
    must agree to PARALLEL_RTOL of their value."""
    import tempfile

    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    from repro_torch.runtime import steps

    cfg = configs.get_config(PARALLEL_ARCH)
    par = configs.ParallelConfig(remat="full", microbatches=TRAIN_MICRO)
    shape = configs.ShapeConfig("t", TRAIN_SEQ, TRAIN_BATCH,
                                configs.KIND_TRAIN)
    opt_cfg = adamw.AdamWConfig(total_steps=PARALLEL_STEPS)
    log(f"parallel (a): {PARALLEL_ARCH} at full width, B{TRAIN_BATCH} "
        f"S{TRAIN_SEQ}, {TRAIN_MICRO} microbatches, remat full, bf16 "
        f"compute, {PARALLEL_STEPS} steps on a one-rank nccl (1, 1) mesh")
    store = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_pg_"), "store")
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.FileStore(store, 1), rank=0,
                            world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), "cuda")

        def sharded():
            gen = torch.Generator(device="cuda").manual_seed(0)
            params = lm.init_model(cfg, gen, device="cuda")
            opt = adamw.init_state(params)
            step, p_sh, o_sh, _ = steps.jit_train_step(
                cfg, par, mesh, opt_cfg, params, opt, shape)
            params = steps.place_tree(params, p_sh)
            opt = steps.place_tree(opt, o_sh)
            return _timed_steps(step, params, opt, cfg, shape, "sharded")

        def plain():
            gen = torch.Generator(device="cuda").manual_seed(0)
            params = lm.init_model(cfg, gen, device="cuda")
            step = steps.make_train_step(cfg, par, opt_cfg)
            return _timed_steps(step, params, adamw.init_state(params), cfg,
                                shape, "unsharded")

        runs = {}
        for name, fn in (("sharded", sharded), ("unsharded", plain)):
            free_cuda()
            torch.cuda.reset_peak_memory_stats()
            reset_kernel_launches()
            rows = fn()
            counts = kernel_launches()
            if any(counts.values()):
                raise AssertionError(f"parallel (a) {name}: a kernel was "
                                     f"launched: {counts}")
            runs[name] = (rows, torch.cuda.max_memory_allocated() / 2**30)
    finally:
        dist.destroy_process_group()
    (sh, sh_peak), (pl, pl_peak) = runs["sharded"], runs["unsharded"]
    worst = 0.0
    for i, (a, b) in enumerate(zip(sh, pl)):
        for key in ("loss", "grad_norm"):
            rel = abs(a[key] - b[key]) / max(abs(b[key]), 1e-30)
            worst = max(worst, rel)
            if not rel <= PARALLEL_RTOL:
                raise AssertionError(
                    f"parallel (a) step {i} {key}: sharded {a[key]!r}, "
                    f"unsharded {b[key]!r}, relative difference {rel:.3e} > "
                    f"{PARALLEL_RTOL}")
    bit_equal = all(a[k] == b[k] for a, b in zip(sh, pl)
                    for k in ("loss", "grad_norm"))
    ms_sh = [r["ms"] for r in sh[1:]]
    ms_pl = [r["ms"] for r in pl[1:]]
    log(f"  sharded vs unsharded: largest relative difference of a loss or "
        f"grad norm {worst:.3e} (limit {PARALLEL_RTOL}), bit-equal: "
        f"{bit_equal}; steps 1-{PARALLEL_STEPS - 1}: sharded "
        f"{', '.join(f'{m:.1f}' for m in ms_sh)} ms, unsharded "
        f"{', '.join(f'{m:.1f}' for m in ms_pl)} ms (DTensor's host cost "
        f"{sum(ms_sh) / len(ms_sh) - sum(ms_pl) / len(ms_pl):.1f} ms a "
        f"step); peak device memory {sh_peak:.3f} / {pl_peak:.3f} GiB "
        "(torch.cuda.max_memory_allocated)")
    PARALLEL_RESULTS["step"] = {
        "arch": PARALLEL_ARCH, "sharded": sh, "unsharded": pl,
        "max_rel_diff": worst, "bit_equal": bit_equal,
        "peak_gib": {"sharded": sh_peak, "unsharded": pl_peak}}


def run_dryrun_cells():
    """(b) The dry run on fake ranks and fake tensors: DRYRUN_CELLS in
    parallel processes (`python -m repro_torch.launch.dryrun`, no card),
    a row each; every cell must complete, its `argument_gb` must equal the
    bytes of one rank's shares from the specs alone, and its
    useful_flops_ratio must lie in (0, 1.05]."""
    import tempfile

    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import production_mesh_shape

    out_dir = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               CUDA_VISIBLE_DEVICES="")
    workers = max(1, min(len(DRYRUN_CELLS), os.cpu_count() or 1))
    log(f"parallel (b): dry run of {len(DRYRUN_CELLS)} cells at train_4k on "
        f"fake ranks, {workers} processes at a time; H100 rates "
        f"{dryrun.H100}")
    t0 = time.perf_counter()
    pending = list(enumerate(DRYRUN_CELLS))
    running = []
    try:
        while pending or running:
            while pending and len(running) < workers:
                i, (arch, multi) = pending.pop(0)
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--arch", arch, "--shape", "train_4k", "--mesh",
                       "multi" if multi else "single", "--out",
                       os.path.join(out_dir, f"cell{i}.jsonl")]
                for t in DRYRUN_TUNE.get(arch, []):
                    cmd += ["--tune", t]
                with open(os.path.join(out_dir, f"cell{i}.err"), "w") as err:
                    running.append((i, subprocess.Popen(
                        cmd, env=env, cwd=ROOT, stdout=subprocess.DEVNULL,
                        stderr=err)))
            time.sleep(0.5)
            if time.perf_counter() - t0 > DRYRUN_TIMEOUT_S:
                raise AssertionError(f"parallel (b): the dry run took over "
                                     f"{DRYRUN_TIMEOUT_S} s")
            for i, proc in list(running):
                if proc.poll() is None:
                    continue
                running.remove((i, proc))
                if proc.returncode != 0:
                    with open(os.path.join(out_dir, f"cell{i}.err")) as err:
                        tail = err.read()[-3000:]
                    cell = os.path.join(out_dir, f"cell{i}.jsonl")
                    if os.path.exists(cell):
                        with open(cell) as f:
                            tail += f.read()[-3000:]
                    raise AssertionError(
                        f"parallel (b): cell {DRYRUN_CELLS[i]} failed "
                        f"(exit {proc.returncode}):\n{tail}")
    finally:
        for _, proc in running:
            proc.kill()
            proc.wait()
    wall = time.perf_counter() - t0
    rows = []
    for i, (arch, multi) in enumerate(DRYRUN_CELLS):
        with open(os.path.join(out_dir, f"cell{i}.jsonl")) as f:
            res = json.loads(f.readline())
        if res.get("skipped") or "error" in res:
            raise AssertionError(f"parallel (b): {arch} did not complete: "
                                 f"{res}")
        want = dryrun.argument_bytes(arch, "train_4k",
                                     production_mesh_shape(multi)) / 1e9
        if res["mem"]["argument_gb"] != want:
            raise AssertionError(
                f"parallel (b): {arch} argument_gb {res['mem']['argument_gb']}"
                f" against {want} from the specs")
        if not 0 < res["useful_flops_ratio"] <= 1.05:
            raise AssertionError(f"parallel (b): {arch} useful_flops_ratio "
                                 f"{res['useful_flops_ratio']}")
        t = res["terms"]
        coll = ", ".join(f"{k} {v / 1e9:.2f}"
                         for k, v in sorted(res["collectives"].items()))
        log(f"  {arch} on {'2x16x16' if multi else '16x16'}: argument "
            f"{res['mem']['argument_gb'] / 1.073741824:.3f} GiB, eager peak "
            f"{res['mem']['peak_gb'] / 1.073741824:.3f} GiB; "
            f"{res['flops_per_dev'] / 1e12:.2f} TFLOP, HBM "
            f"{res['bytes_per_dev'] / 1e9:.1f} GB, collectives GB {{{coll}}}; "
            f"compute {t['compute_s']:.4f} s, memory {t['memory_s']:.4f} s, "
            f"collective {t['collective_s']:.4f} s -> {res['bottleneck']}; "
            f"useful {res['useful_flops_ratio']:.3f}; host {res['run_s']:.1f} s"
            + (f" (tuned: {' '.join(DRYRUN_TUNE[arch])})"
               if arch in DRYRUN_TUNE else ""))
        rows.append({"arch": arch, "mesh": "2x16x16" if multi else "16x16",
                     **{k: res[k] for k in (
                         "mem", "flops_per_dev", "bytes_per_dev",
                         "collectives", "terms", "bottleneck",
                         "useful_flops_ratio", "run_s")}})
    log(f"  dry run: {len(rows)} cells in {wall:.1f} s of wall time "
        "(modelled figures: counts over the H100's published rates)")
    PARALLEL_RESULTS["dryrun"] = {"wall_s": wall, "cells": rows}


def run_parallel():
    """Phase 7: (a) the sharded train step on the card against the
    unsharded one, (b) the dry run's cells on fake ranks."""
    t0 = time.perf_counter()
    run_parallel_step()
    free_cuda()
    run_dryrun_cells()
    PARALLEL_RESULTS["host_s"] = time.perf_counter() - t0
    log(json.dumps({"parallel": PARALLEL_RESULTS}))
    # the phase in one line, after the long one, so that a short tail of
    # the output still holds it
    st, dr = PARALLEL_RESULTS["step"], PARALLEL_RESULTS["dryrun"]
    log(f"parallel summary: (a) sharded vs unsharded, largest relative "
        f"difference {st['max_rel_diff']:.3e} (limit {PARALLEL_RTOL}), "
        f"bit-equal {st['bit_equal']}; steps 1-{PARALLEL_STEPS - 1} sharded "
        + ", ".join(f"{r['ms']:.1f}" for r in st["sharded"][1:])
        + " ms, unsharded "
        + ", ".join(f"{r['ms']:.1f}" for r in st["unsharded"][1:])
        + f" ms; peak {st['peak_gib']['sharded']:.3f} / "
        f"{st['peak_gib']['unsharded']:.3f} GiB; (b) {len(dr['cells'])} "
        f"dry-run cells checked in {dr['wall_s']:.1f} s of wall time; "
        f"phase 7 {PARALLEL_RESULTS['host_s']:.1f} s of host time")


def mutant_sets() -> dict:
    """The named subsets of MUTANTS that `--mutants` takes, by the source a
    mutant edits, each small enough for one run under an hour: "flash",
    "paged" and "amu" (the gather, the triad, the scatter and their shared
    header)."""
    sets = {"flash": [], "paged": [], "amu": []}
    for name, edits in MUTANTS.items():
        sources = {source for source, _, _ in edits}
        key = ("flash" if sources == {"flash_attention.cu"} else
               "paged" if sources == {"paged_attention.cu"} else "amu")
        sets[key].append(name)
    return sets


def run_mutants(names=(), timeout_s: int = 600) -> bool:
    """Builds each mutant (of `names`, each a mutant or a subset of
    `mutant_sets`, or all) in a copy of src/ and this script under
    build/mutants/ and runs `--kernels-only` there, killed after
    `timeout_s`. Prints each copy's exit code and first failing check;
    true if every copy failed or hung."""
    sets = mutant_sets()
    names = [m for n in names for m in sets.get(n, [n])]
    unknown = set(names) - set(MUTANTS)
    if unknown:
        raise AssertionError(f"no mutants {sorted(unknown)}")
    caught = True
    chosen = [n for n in MUTANTS if not names or n in names]
    from repro_torch.kernels import _build
    _build.build_all()                 # the libraries the copies reuse
    for name in chosen:
        make_mutant(name)
    # each copy's kernels are built, eight builds at a time (each runs one
    # nvcc for its edited source, or one a source where a header is
    # edited), so that the paged source's long builds overlap on the
    # machine's cores; a copy's check starts as soon as its build ends,
    # three checks at a time on the card, beside the later builds
    build = [[sys.executable, "-c", "import sys; sys.path.insert(0, "
              "sys.argv[1]); from repro_torch.kernels import _build; "
              "_build.build_all()",
              os.path.join(ROOT, "build", "mutants", name, "src")]
             for name in chosen]
    checks = [["timeout", "-s", "KILL", str(timeout_s), sys.executable,
               os.path.join(ROOT, "build", "mutants", name, "chip_smoke.py"),
               "--kernels-only"] for name in chosen]
    logs = [os.path.join(ROOT, "build", "mutants", name, "kernels_only.log")
            for name in chosen]
    codes = run_pool(build, checks, logs)
    for name, code, path in zip(chosen, codes, logs):
        with open(path) as f:
            lines = [line.strip() for line in f if line.strip()]
        why = [line for line in lines if line.endswith("FAIL")] \
            or lines[-1:] or ["no output"]
        log(f"mutant {name}: exit {code} "
            f"({'caught' if code else 'NOT CAUGHT'}): {why[0]}")
        caught = caught and code != 0
    return caught


def run_pool(builds, checks, logs) -> list:
    """Runs each of `builds` (output nowhere, eight at a time, whatever its
    exit code) and, once it has ended, checks[i] (three at a time, output
    and errors into logs[i]); returns the checks' exit codes, in order."""
    codes = [None] * len(checks)
    live, first = {}, {}
    todo, pre = [], list(enumerate(builds))
    while todo or live or pre or first:
        while pre and len(first) < 8:
            i, cmd = pre.pop(0)
            first[i] = subprocess.Popen(cmd, stdout=subprocess.DEVNULL,
                                        stderr=subprocess.STDOUT)
        for i, proc in list(first.items()):
            if proc.poll() is not None:
                del first[i]
                todo.append(i)
        while todo and len(live) < 3:
            i = todo.pop(0)
            with open(logs[i], "w") as out:
                live[i] = subprocess.Popen(checks[i], stdout=out,
                                           stderr=subprocess.STDOUT)
        for i, proc in list(live.items()):
            if proc.poll() is not None:
                codes[i] = proc.returncode
                del live[i]
        time.sleep(0.5)
    return codes


def make_mutant(name):
    """The copy of src/ and this script under build/mutants/NAME with the
    mutant's edits made (each text must be in its source exactly once).
    The libraries of this tree's build whose source the mutant leaves as it
    is (all of them but the edited one, none where a header is edited) are
    put in the copy's build directory, so that it compiles the edited
    source alone."""
    from pathlib import Path
    from repro_torch.kernels import _build
    dst = os.path.join(ROOT, "build", "mutants", name)
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "src"), os.path.join(dst, "src"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.abspath(__file__), dst)
    csrc = Path(dst, "src", "repro_torch", "kernels", "csrc")
    for source, old, new in MUTANTS[name]:
        path = csrc / source
        text = path.read_text()
        if text.count(old) != 1:
            raise AssertionError(f"mutant {name}: its text is not in "
                                 f"{source} exactly once")
        path.write_text(text.replace(old, new))
    edited = {source for source, _, _ in MUTANTS[name]}
    if any(s.endswith(".cuh") for s in edited):
        return
    built = _build.build_dir() / _build._source_hash()
    out = (Path(dst) / "build" / "repro_torch_kernels"
           / _build._source_hash(csrc))
    out.mkdir(parents=True, exist_ok=True)
    for lib in built.glob("lib*.so"):
        if f"{lib.stem[3:]}.cu" not in edited:
            shutil.copy(lib, out / lib.name)


# --------------------------------------------------------------------- main
def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after the kernels are built and checked")
    ap.add_argument("--ptxas", action="store_true",
                    help="build with -Xptxas -v and print the compiler's "
                         "report of registers, shared memory and spills")
    ap.add_argument("--mutants", nargs="*", default=None, metavar="NAME",
                    help="only build the broken kernels of MUTANTS (those "
                         "named, or of the subsets named: flash, paged, "
                         "amu; or all) and check that phase 3 fails on "
                         "each")
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
    if args.mutants is not None:
        caught = run_mutants(args.mutants)
        log(card)
        return 0 if caught else 1

    # 2. build
    from repro_torch.kernels import _build
    out_dir = _build.build_all(verbose=args.ptxas)
    log(f"built {len(list(out_dir.glob('lib*.so')))} kernel libraries in "
        f"{_build.build_seconds or 0.0:.1f} s -> {out_dir}; "
        + ", ".join(line.split("\n")[0][3:] for line in _build.build_log))
    if args.ptxas:
        log("\n".join(_build.build_log))
    check_sass(out_dir)

    # 3. kernels against their plain versions
    gen = torch.Generator(device="cuda").manual_seed(0)
    kernels = [check_flash(gen), check_paged(gen)]
    check_fma_bodies(gen)
    check_wide_mma(gen)
    check_cas_batches(gen)
    check_elem_rows_and_pair(gen)
    fuzz_kernels(gen)
    check_offload(gen)
    amu_worst = check_amu_kernels(gen)
    check_every_type(gen)
    check_paged_fp8(gen)
    check_redesigns(gen)
    check_pair_heads_and_add16(gen)
    check_mma_and_triad(gen)
    fp8_serve_shapes(gen)

    # 4. the slice and the later paths, then training; 5. the AMU kernels'
    # own path; 6. the simulator and the whole quickstart; 7. the parallel
    # layer
    log(json.dumps({"serve_shapes": SERVE_SHAPES}))
    if not args.kernels_only:
        run_slice(kernels)
        run_new_paths(kernels)
        run_recurrentgemma(kernels)
        run_float16_paths(kernels)
        run_training(kernels)
        run_amu(kernels, amu_worst)
        run_simulator()
        run_examples(kernels)
        run_parallel()

    # 8. report
    log(f"chip_smoke: all phases passed in {time.time() - t_start:.1f} s")
    if not args.kernels_only:
        log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                            "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
