#!/usr/bin/env python3
"""Where a full-width training step's time goes on one card, and what
slicing the stacked weights once (`unbind`) saves over indexing them.

    python3 train_bench.py [--arch qwen2.5-3b] [--batch 2] [--seq 4096] \
        [--microbatches 2] [--steps 3]

Builds the arch at full width on the card (random weights from seed 0,
float32 masters, AdamW state) and runs `runtime.steps.make_train_step` as
`launch.train` does (remat "full", bf16 compute) on one synthetic batch:

1. step ms, the host clock around a step that ends in a synchronise, with
   the stacked leaves sliced by `lm._unstack` (`unbind`: one `stack` a
   leaf in the backward) and by per-period indexing `t[i]` (every
   period's backward allocates a zero tensor the size of the whole stack
   and adds it into the leaf's gradient), in turns: unbind, index, index,
   unbind, each one warm-up step and then `--steps` timed ones;
2. the step's parts, each alone with CUDA events at the step's shapes: one
   layer forward and forward + backward (full remat runs both a layer a
   microbatch), its attention and its MLP the same way, the chunked
   cross-entropy forward + backward, and `adamw.apply_updates` on the
   model's params; and what they add up to against the step;
3. one profiled step: the device's busy share of it and the kernel time by
   name, the GEMMs summed.

Prints one JSON line, then the card's name and power limit. Needs one
NVIDIA card.
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

GEMM_NAMES = ("gemm", "nvjet", "cutlass", "xmma", "cublas")


def _device_us(evt) -> float:
    return float(getattr(evt, "device_time_total", 0.0)
                 or getattr(evt, "cuda_time_total", 0.0))


def events_ms(fn, iters: int = 3) -> float:
    """ms of one call of `fn` by CUDA events, the mean of `iters` after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("train_bench: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1

    from repro_torch import configs, convert
    from repro_torch.data.pipeline import batch_to, synthetic_batch
    from repro_torch.models import blocks as B
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    from repro_torch.runtime import steps

    dev = torch.device("cuda")
    cfg = configs.get_config(args.arch)
    nmb = args.microbatches
    shape = configs.ShapeConfig("bench", args.seq, args.batch,
                                configs.KIND_TRAIN)
    params = lm.init_model(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    state = adamw.init_state(params)
    step_fn = steps.make_train_step(
        cfg, configs.ParallelConfig(remat="full", microbatches=nmb),
        adamw.AdamWConfig())
    batch = batch_to(synthetic_batch(cfg, shape, 0), dev)
    out = {"arch": args.arch, "batch": args.batch, "seq": args.seq,
           "microbatches": nmb, "card": torch.cuda.get_device_name(0)}

    def step():
        nonlocal params, state
        params, state, _ = step_fn(params, state, batch)
        torch.cuda.synchronize()

    # 1. unbind against per-period indexing, in turns
    by_unbind = lm._unstack

    def by_index(tree, n):
        return [convert.tree_map(lambda t: t[i], tree) for i in range(n)]

    times = {"unbind": [], "index": []}
    for name in ("unbind", "index", "index", "unbind"):
        lm._unstack = by_unbind if name == "unbind" else by_index
        torch.cuda.reset_peak_memory_stats()
        step()
        for _ in range(args.steps):
            t0 = time.perf_counter()
            step()
            times[name].append((time.perf_counter() - t0) * 1e3)
        print(f"{name:>6}: steps {['%.1f' % t for t in times[name][-args.steps:]]}"
              f" ms, peak {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB",
              flush=True)
    lm._unstack = by_unbind
    out["step_ms"] = times
    step_ms = min(times["unbind"])

    # 2. the parts alone, at the step's shapes (bf16 compute, one microbatch)
    mb = args.batch // nmb
    pc = lm.cast_params_for_compute(params)
    layer = convert.tree_map(
        lambda t: t[0].detach().requires_grad_(True), pc["scan"][0])
    kind = cfg.block_pattern[0]
    gen = torch.Generator(device=dev).manual_seed(1)
    h = torch.randn((mb, args.seq, cfg.d_model), generator=gen, device=dev,
                    dtype=torch.bfloat16).requires_grad_(True)
    positions = lm.positions_for(cfg, mb, args.seq, device=dev)

    def fwd_bwd(fn):
        def run():
            fn().float().sum().backward()
        return run

    def no_grad(fn):
        def run():
            with torch.no_grad():
                fn()
        return run

    parts = {
        "layer": lambda: lm._apply_layer(cfg, kind, layer, h, positions, None,
                                         None, False)[0],
        "attention": lambda: B.attention(cfg, layer["mix"], h, positions)[0],
        "mlp": lambda: B.apply_mlp(cfg, layer["ffn"], h),
    }
    if cfg.moe is not None:
        from repro_torch.models import moe as M
        parts["mlp"] = lambda: M.apply_moe(cfg, layer["ffn"], h,
                                           mode="capacity")[0]
    part_ms = {}
    for name, fn in parts.items():
        part_ms[f"{name}_fwd"] = events_ms(no_grad(fn))
        part_ms[f"{name}_fwd_bwd"] = events_ms(fwd_bwd(fn))
    head = {k: pc[k].detach().requires_grad_(True)
            for k in ("embed", "head") if k in pc}
    labels = batch["labels"][:mb]
    part_ms["xent_fwd_bwd"] = events_ms(fwd_bwd(
        lambda: lm.chunked_xent(cfg, head, h, labels)))
    del pc, layer, head, h
    grads = convert.tree_map(torch.ones_like, params)
    part_ms["adamw"] = events_ms(lambda: adamw.apply_updates(
        adamw.AdamWConfig(), params, grads, state), iters=2)
    del grads
    layers = cfg.num_layers * nmb * (part_ms["layer_fwd"]
                                     + part_ms["layer_fwd_bwd"])
    attn = cfg.num_layers * nmb * (part_ms["attention_fwd"]
                                   + part_ms["attention_fwd_bwd"])
    mlp = cfg.num_layers * nmb * (part_ms["mlp_fwd"]
                                  + part_ms["mlp_fwd_bwd"])
    xent = nmb * part_ms["xent_fwd_bwd"]
    out["parts_ms"] = part_ms
    out["step_parts_ms"] = {
        "layers (L x microbatches x (fwd + fwd_bwd))": layers,
        "of which attention": attn, "of which mlp": mlp,
        "xent": xent, "adamw": part_ms["adamw"],
        "rest (step - layers - xent - adamw)":
            step_ms - layers - xent - part_ms["adamw"]}
    print(f"parts of a {step_ms:.1f} ms step: " + ", ".join(
        f"{k} {v:.1f}" for k, v in out["step_parts_ms"].items()), flush=True)

    # 3. one profiled step
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        window_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if _device_us(e) > 0
              and e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(_device_us(e) for e in events) / 1e3
    if busy_ms <= 0:
        raise SystemExit("the profiler recorded no device time")
    gemm_ms = sum(_device_us(e) for e in events
                  if any(g in e.key.lower() for g in GEMM_NAMES)) / 1e3
    top = sorted(events, key=_device_us, reverse=True)[:15]
    out["profile"] = {
        "window_ms": window_ms, "busy_ms": busy_ms, "gemm_ms": gemm_ms,
        "top": [{"kernel": e.key[:100], "ms": _device_us(e) / 1e3,
                 "calls": e.count} for e in top]}
    print(f"profiled step: {window_ms:.1f} ms, device busy {busy_ms:.1f} ms "
          f"({busy_ms / window_ms:.1%}), GEMMs {gemm_ms:.1f} ms "
          f"({gemm_ms / busy_ms:.1%} of busy)")
    print(f"{'device ms':>10} {'calls':>6}  kernel")
    for e in top:
        print(f"{_device_us(e) / 1e3:10.2f} {e.count:6d}  {e.key[:90]}")
    print(json.dumps(out))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
