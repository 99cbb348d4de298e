"""Where the serve path's time goes on the card: a warm prefill and a few
decode steps under `torch.profiler`.

    PYTHONPATH=src python -m repro_torch.launch.trace --arch qwen2.5-3b \
        --use-kernels [--steps 8] [--out trace.json]

Prints the warm prefill time and the decode step time (host clock around
work that ends in a synchronise), the device's busy share of the decode
window (sum of kernel time over the window), and the kernels that take most
of the device time, by name. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import configs
from repro_torch.models import lm


def _device_us(evt) -> float:
    return float(getattr(evt, "device_time_total", 0.0)
                 or getattr(evt, "cuda_time_total", 0.0))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=1000)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--use-kernels", action="store_true")
    ap.add_argument("--out", default="",
                    help="write the decode window's chrome trace here")
    args = ap.parse_args(argv)

    device = lm.resolve_device("cuda")
    cfg = configs.get_config(args.arch)
    gen = torch.Generator(device=device).manual_seed(0)
    params = lm.cast_params_for_compute(lm.init_model(cfg, gen, device=device))
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len))).to(device)
    max_len = args.prompt_len + 2 * args.steps + 2

    def prefill():
        cache = lm.init_cache(cfg, args.batch, max_len, device=device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = lm.prefill(cfg, params, {"tokens": prompts}, cache,
                         use_kernels=args.use_kernels)
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    _, cold_ms = prefill()
    (logits, cache), warm_ms = prefill()
    print(f"[{torch.cuda.get_device_name(0)}] {cfg.name} batch {args.batch} "
          f"prompt {args.prompt_len} use_kernels={args.use_kernels}")
    print(f"prefill: first call {cold_ms:.2f} ms, second call {warm_ms:.2f} ms")

    def decode(n, cache, tok):
        for _ in range(n):
            lg, cache = lm.decode_step(cfg, params, tok, cache,
                                       use_kernels=args.use_kernels)
            tok = torch.argmax(lg[:, -1], -1)[:, None]
        torch.cuda.synchronize()
        return cache, tok

    tok = torch.argmax(logits[:, -1], -1)[:, None]
    cache, tok = decode(2, cache, tok)                    # warm-up
    t0 = time.perf_counter()
    cache, tok = decode(args.steps, cache, tok)
    step_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    print(f"decode: {step_ms:.3f} ms per step unprofiled "
          f"({args.batch * 1e3 / step_ms:.1f} tok/s)")

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        decode(args.steps, cache, tok)
        window_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if _device_us(e) > 0
              and e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(_device_us(e) for e in events) / 1e3
    if busy_ms <= 0:
        raise SystemExit("the profiler recorded no device time")
    print(f"profiled window: {window_ms:.2f} ms for {args.steps} steps; "
          f"device busy {busy_ms:.2f} ms = {busy_ms / window_ms:.1%} "
          f"(idle {1 - busy_ms / window_ms:.1%}); against the unprofiled "
          f"step: {busy_ms / args.steps / step_ms:.1%} busy")
    print(f"{'device ms/step':>15} {'calls/step':>11}  kernel")
    for e in sorted(events, key=_device_us, reverse=True)[:14]:
        print(f"{_device_us(e) / 1e3 / args.steps:15.4f} "
              f"{e.count / args.steps:11.1f}  {e.key[:90]}")
    if args.out:
        prof.export_chrome_trace(args.out)
        print(f"trace written to {args.out}")


if __name__ == "__main__":
    main()
