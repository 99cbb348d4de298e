"""Serving example, two layers of the same mechanism.

The counterpart of `examples/serve_paged.py`, with its flags and its output:

Default: the paged-KV serving workload through the AMU session API (the
port's own copy of the simulator, `repro_torch.amu` / `core.serving`):
open-loop request arrivals gather their KV pages from tiered far memory
(local / CXL / cross-switch) with one AMI vector gather per request, and
per-request completion-latency percentiles come back on `RunStats`. The
synchronous page-fault baseline runs first for the tail-latency contrast.
What it prints are the model's figures (modelled microseconds and MLP), the
same on every machine.

`--lm` instead runs a real transformer decode at smoke size: batched
requests through prefill + decode (`repro_torch.models.lm`), with the decode
attention on the paged_attention CUDA kernel and prompts of 128 tokens or
more on flash_attention (`--use-kernels`). Weights are random from
`--seed`; the prompts are numpy's `default_rng(0)`, as the reference draws
them. Runs on the card unless `--device cpu` is given.

    PYTHONPATH=src python -m repro_torch.launch.serve_paged [--requests N]
    PYTHONPATH=src python -m repro_torch.launch.serve_paged --lm \\
        [--use-kernels] [--arch A] [--device cpu]
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch import configs
from repro_torch.amu import AmuConfig, AmuSession
from repro_torch.core.serving import serve_regions
from repro_torch.models import lm

PLANES = (("page-fault", dict(data_plane="sync")), ("ami", {}),
          ("ami-vector", {}))


def serve_sim(requests: int) -> List[Dict[str, Any]]:
    """The three data planes on `paged_kv_serve`; a row each: `plane`,
    `p50_us`, `p99_us`, `p999_us`, `mean_us`, `mlp` (modelled)."""
    base = AmuConfig(far=serve_regions(requests=requests))
    print(f"=== paged-KV serving, {requests} open-loop requests ===")
    print(f"{'data plane':>12s} {'p50':>8s} {'p99':>8s} {'p999':>8s} "
          f"{'MLP':>6s}")
    rows, sync_mean = [], None
    for label, kw in PLANES:
        cfg = base.derive(vector=(label == "ami-vector"))
        with AmuSession(cfg) as s:
            out = s.run("paged_kv_serve", requests=requests,
                        coroutines=16, **kw)
        if not out.verified:
            raise AssertionError(f"{label}: the served pages are wrong")
        sync_mean = sync_mean or out.req_mean_us
        print(f"{label:>12s} {out.req_p50_us:7.1f}u {out.req_p99_us:7.1f}u "
              f"{out.req_p999_us:7.1f}u {out.mlp:6.2f}"
              + (f"  ({sync_mean / out.req_mean_us:.1f}x mean vs page-fault)"
                 if label != "page-fault" else ""))
        rows.append({"plane": label, "p50_us": out.req_p50_us,
                     "p99_us": out.req_p99_us, "p999_us": out.req_p999_us,
                     "mean_us": out.req_mean_us, "mlp": out.mlp})
    print("\nMLP across concurrent requests is the whole mechanism: the "
          "AMI planes\noverlap every tenant's page gathers where the "
          "page-fault plane blocks.")
    return rows


def serve_lm(args, params=None) -> Dict[str, Any]:
    """Two waves of `args.batch` prompts, each prefilled and decoded for
    `args.max_new - 1` greedy steps. Returns `tokens` (a [B, max_new] tensor
    a wave: the prefill's token, then one a step), `tok_s` a wave and
    `mean_tok_s` (host clock around the decode loop, ending in a device
    synchronise). `params` (e.g. `convert.params_from_numpy` of the
    reference's) replaces the random weights."""
    device = lm.resolve_device(args.device)
    cfg = configs.get_smoke_config(args.arch)
    if params is None:
        gen = torch.Generator(device=device).manual_seed(args.seed)
        params = lm.init_model(cfg, gen, device=device)
    max_len = args.prompt_len + args.max_new
    rng = np.random.default_rng(0)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def serve_wave(wave: int):
        prompts = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (args.batch, args.prompt_len))).to(device)
        cache = lm.init_cache(cfg, args.batch, max_len, device=device)
        logits, cache = lm.prefill(cfg, params, {"tokens": prompts}, cache,
                                   use_kernels=args.use_kernels)
        tok = torch.argmax(logits[:, -1], -1)[:, None]
        toks = [tok]
        sync()
        t0 = time.time()
        for _ in range(args.max_new - 1):
            logits, cache = lm.decode_step(cfg, params, tok, cache,
                                           use_kernels=args.use_kernels)
            tok = torch.argmax(logits[:, -1], -1)[:, None]
            toks.append(tok)
        sync()
        dt = time.time() - t0
        rate = args.batch * (args.max_new - 1) / dt
        print(f"wave {wave}: {rate:8.1f} tok/s "
              f"(paged kernel: {args.use_kernels})")
        return torch.cat(toks, 1).cpu(), rate

    waves = [serve_wave(w) for w in range(2)]
    rates = [r for _, r in waves]
    print(f"mean decode throughput: {sum(rates) / len(rates):.1f} tok/s")
    return {"tokens": [t for t, _ in waves], "tok_s": rates,
            "mean_tok_s": sum(rates) / len(rates)}


def parse(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--lm", action="store_true",
                    help="run the transformer prefill+decode demo instead")
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=48)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--use-kernels", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="where --lm runs (cuda, or cpu for the plain "
                         "versions of the kernels)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of --lm's random weights")
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None, params=None):
    """Runs what the flags ask and returns its figures: `serve_sim`'s rows,
    or `serve_lm`'s result with `--lm` (`params` as there)."""
    args = parse(argv)
    if args.lm:
        return serve_lm(args, params)
    return serve_sim(args.requests)


if __name__ == "__main__":
    main()
