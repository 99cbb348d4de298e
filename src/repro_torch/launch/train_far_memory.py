"""End-to-end training example: a reduced model for a few dozen steps with the
full substrate: gradient accumulation, asynchronous checkpoints, an
injected failure with automatic restart, the straggler monitor.

The counterpart of `examples/train_far_memory.py`, with its flags, its
sizes and its output: the arch's smoke config, AdamW (lr 1e-3, 10 warmup
steps), `make_train_step` with remat "full" and 2 microbatches, a
`CheckpointStore` every 10 steps and a `TrainSupervisor` with a
`StepMonitor`. Weights are random from seed 0, as the reference's are
from `PRNGKey(0)`; the data is `synthetic_batch` of the step. `--ckpt`
defaults to a new temporary directory, so that no earlier run's
checkpoints are restored. Runs on the card unless `--device cpu` is given.

    PYTHONPATH=src python -m repro_torch.launch.train_far_memory \\
        [--steps 60] [--fail-at 25] [--device cpu]
"""
from __future__ import annotations

import argparse
import tempfile
import time
from typing import Any, Dict, List, Optional

import torch

from repro_torch import configs
from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.data.pipeline import batch_to, synthetic_batch
from repro_torch.models import lm
from repro_torch.optim import adamw
from repro_torch.runtime import steps as steps_mod
from repro_torch.runtime.ft import StepMonitor, TrainSupervisor


def parse(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="granite-moe-1b-a400m")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--fail-at", type=int, default=25,
                    help="inject a node failure at this step (-1: off)")
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint directory (default: a new temporary "
                         "one)")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None, params=None) -> Dict[str, Any]:
    """Trains as the flags say and returns `loss` (the last step's),
    `step` (where the run ended), `restarts`, `stragglers`, `wall_s` and
    `history` (per step run: step and loss). `params` (e.g.
    `convert.params_from_numpy` of the reference's) replaces the random
    weights."""
    args = parse(argv)
    device = lm.resolve_device(args.device)
    cfg = configs.get_smoke_config(args.arch)
    shape = configs.ShapeConfig("train", args.seq, args.batch, "train")
    par = configs.ParallelConfig(remat="full", microbatches=2)
    opt_cfg = adamw.AdamWConfig(learning_rate=1e-3, warmup_steps=10,
                                total_steps=args.steps)

    if params is None:
        gen = torch.Generator(device=device).manual_seed(0)
        params = lm.init_model(cfg, gen, device=device)
    opt_state = adamw.init_state(params)
    step_fn = steps_mod.make_train_step(cfg, par, opt_cfg)
    history: List[Dict[str, float]] = []

    def synced_step(p, o, b):
        out = step_fn(p, o, b)
        if device.type == "cuda":
            torch.cuda.synchronize(device)   # the monitor times it whole
        return out

    def batch_fn(step):
        return batch_to(synthetic_batch(cfg, shape, step), device)

    monitor = StepMonitor(on_straggler=lambda s, d, e: print(
        f"  [straggler] step {s}: {d * 1e3:.0f}ms vs ewma {e * 1e3:.0f}ms"))
    sup = TrainSupervisor(
        CheckpointStore(args.ckpt or tempfile.mkdtemp(prefix="repro_ckpt_")),
        checkpoint_every=10, monitor=monitor)
    print(f"training {cfg.name}: {cfg.param_count() / 1e6:.1f}M params, "
          f"{args.steps} steps, failure injected at step {args.fail_at}")
    t0 = time.time()
    state = sup.run({"params": params, "opt_state": opt_state, "step": 0},
                    synced_step, batch_fn, args.steps,
                    fail_at=None if args.fail_at < 0 else args.fail_at,
                    on_step=lambda s, d, m: history.append(
                        {"step": s, "loss": float(m["loss"])}))
    dt = time.time() - t0
    loss = float(state["metrics"]["loss"])
    print(f"done in {dt:.1f}s | final loss {loss:.4f} "
          f"| restarts survived: {sup.restarts} "
          f"| stragglers: {len(monitor.stragglers)}")
    return {"loss": loss, "step": state["step"], "restarts": sup.restarts,
            "stragglers": list(monitor.stragglers), "wall_s": dt,
            "history": history}


if __name__ == "__main__":
    main()
