"""Serving entry point: batched prefill + decode loop with the paged KV cache.

The counterpart of `src/repro/launch/serve.py`: requests arrive as one batch,
prefill fills the cache, decode streams tokens; with --use-kernels prefill
attention runs the flash_attention CUDA kernel (prompts of 128 tokens or
more) and decode attention the paged_attention CUDA kernel.

With --offload-kv the KV cache lives in host memory between decode steps
(:class:`~repro_torch.runtime.offload.OffloadedKVCache`): each step fetches
the cache pages through the resident window (prefetch-ahead, AMI-style), runs
decode, and update()s the new pages back. It decodes once without
offload and once with, and requires the generated tokens to be identical.

Runs on the card unless `--device cpu` is given; a card that is not there is
an error, not a reason to carry on on the CPU.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \
        --use-kernels --offload-kv
"""
from __future__ import annotations

import argparse
import threading
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch import configs, convert
from repro_torch.models import lm
from repro_torch.runtime.offload import OffloadedKVCache


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(arch: str, *, smoke: bool = False, batch: int = 4,
          prompt_len: int = 64, max_new: int = 32, use_kernels: bool = False,
          temperature: float = 0.0, offload_kv: bool = False,
          offload_window: int = 2, drain_timeout_s: float = 30.0,
          device="cuda", seed: int = 0) -> Dict[str, Any]:
    """Serve one batch of random prompts; returns tokens, timings and stats.

    Weights are random, drawn from `seed`. Times are host-clock times around work that
    ends in a device synchronise. Keys of the result: `tokens` [B, max_new],
    `prompts`, `prefill_logits` [B, 1, V], `params` (cast for compute), `cache`
    (as prefill left it: the decode runs work on clones),
    `prefill_ms`, `decode_ms`, `decode_tok_s`, and with `offload_kv` also
    `tokens_offload`, `tokens_identical`, `offload_ms`, `offload_tok_s`,
    `offload_pages`, `offload_window`, `offload_stats`."""
    device = lm.resolve_device(device)
    cfg = (configs.get_smoke_config(arch) if smoke
           else configs.get_config(arch))
    if not cfg.is_decoder:
        raise ValueError(f"{arch} is encoder-only; nothing to decode")
    if cfg.frontend is not None:
        raise ValueError(
            f"{arch} takes {cfg.frontend.kind} inputs beside its tokens and "
            "launch.serve feeds token prompts only, as the reference's does: "
            "call lm.prefill with vision_embeds, then lm.decode_step")
    gen = torch.Generator(device=device).manual_seed(seed)
    # cast once: eager PyTorch would otherwise re-read every fp32 weight on
    # each step; the entry points' own cast then returns the tree as it is
    params = lm.cast_params_for_compute(
        lm.init_model(cfg, gen, device=device))
    max_len = prompt_len + max_new

    rng = np.random.default_rng(seed)
    prompts = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (batch, prompt_len))).to(device)

    cache = lm.init_cache(cfg, batch, max_len, device=device)
    _sync(device)
    t0 = time.perf_counter()
    logits, cache = lm.prefill(cfg, params, {"tokens": prompts}, cache,
                               use_kernels=use_kernels)
    _sync(device)
    t_prefill = time.perf_counter() - t0

    def sample(lg: torch.Tensor) -> torch.Tensor:
        if temperature <= 0:
            return torch.argmax(lg[:, -1], dim=-1)[:, None]
        probs = torch.softmax(lg[:, -1].float() / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)

    def run_decode(kv: Optional[OffloadedKVCache] = None) -> torch.Tensor:
        """Decode loop; with `kv`, the cache pages through host memory
        between steps (fetch -> decode -> update). decode_step writes K/V in
        place, so each run works on its own clone of the post-prefill
        cache."""
        cur = convert.tree_map(torch.clone, cache)
        tok = sample(logits)
        out = [tok]
        if kv is not None:
            leaves, treedef = convert.flatten(cur)
            for i, leaf in enumerate(leaves):
                kv.host_put(i, leaf)
            del leaves, cur
            kv.prefetch(0)
        for _ in range(max_new - 1):
            if kv is not None:
                pages = [kv.fetch(i) for i in range(kv.num_layers)]
                cur = convert.unflatten(treedef, pages)
            lg, cur = lm.decode_step(cfg, params, tok, cur,
                                     use_kernels=use_kernels)
            if kv is not None:
                for i, leaf in enumerate(convert.flatten(cur)[0]):
                    kv.update(i, leaf)
            tok = sample(lg)
            out.append(tok)
        _sync(device)
        return torch.cat(out, dim=1)

    steps = max(max_new - 1, 0)
    t0 = time.perf_counter()
    tokens = run_decode()
    t_decode = time.perf_counter() - t0
    result: Dict[str, Any] = {
        "tokens": tokens, "prompts": prompts, "prefill_logits": logits,
        "params": params, "cache": cache, "prefill_ms": t_prefill * 1e3,
        "decode_ms": t_decode * 1e3,
        "decode_tok_s": batch * steps / max(t_decode, 1e-9),
    }

    if offload_kv:
        n_pages = len(convert.flatten(cache)[0])
        kv = OffloadedKVCache(num_layers=n_pages, window=offload_window,
                              device=device)
        t0 = time.perf_counter()
        tokens_off = run_decode(kv)
        t_off = time.perf_counter() - t0
        # drain under a wall-clock watchdog: close() blocks on in-flight
        # uploads and writebacks, so a wedged copy would otherwise hang the
        # caller with no diagnostic
        drain = threading.Thread(target=kv.close, daemon=True)
        drain.start()
        drain.join(timeout=drain_timeout_s)
        if drain.is_alive():
            raise SystemExit(
                f"offload-kv drain hung: close() still blocked after "
                f"{drain_timeout_s:.1f}s (pending uploads: "
                f"{sorted(kv._pending)}, writebacks in flight: "
                f"{kv.writebacks_in_flight()})")
        result.update(
            tokens_offload=tokens_off,
            tokens_identical=bool(torch.equal(tokens, tokens_off)),
            offload_ms=t_off * 1e3,
            offload_tok_s=batch * steps / max(t_off, 1e-9),
            offload_pages=n_pages, offload_window=offload_window,
            offload_stats=dict(kv.stats))
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--use-kernels", action="store_true")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--offload-kv", action="store_true",
                    help="page the KV cache through OffloadedKVCache "
                         "between decode steps and check token identity")
    ap.add_argument("--offload-window", type=int, default=2,
                    help="resident window (device pages) for --offload-kv")
    ap.add_argument("--drain-timeout-s", type=float, default=30.0,
                    help="wall-clock budget for the --offload-kv drain; a "
                         "hung copy fails the run with a diagnostic instead "
                         "of hanging the caller")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; an absent card is an error) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    res = serve(args.arch, smoke=args.smoke, batch=args.batch,
                prompt_len=args.prompt_len, max_new=args.max_new,
                use_kernels=args.use_kernels, temperature=args.temperature,
                offload_kv=args.offload_kv,
                offload_window=args.offload_window,
                drain_timeout_s=args.drain_timeout_s, device=args.device,
                seed=args.seed)
    where = (torch.cuda.get_device_name(torch.device(args.device))
             if torch.device(args.device).type == "cuda" else "cpu")
    print(f"[{where}] prefill: {args.batch}x{args.prompt_len} in "
          f"{res['prefill_ms'] / 1e3:.2f}s | decode: "
          f"{res['decode_tok_s']:,.1f} tok/s | sample row 0: "
          f"{res['tokens'][0, :12].tolist()}")
    if args.offload_kv:
        print(f"offload-kv: {res['offload_pages']} pages, window "
              f"{args.offload_window}, {res['offload_ms'] / 1e3:.2f}s | stats "
              f"{res['offload_stats']} | tokens identical: "
              f"{res['tokens_identical']}")
        if not res["tokens_identical"]:
            raise SystemExit("offloaded decode diverged from baseline")


if __name__ == "__main__":
    main()
