"""Training entry point: config -> mesh -> sharded state -> supervised loop
with asynchronous checkpoints, straggler detection and restart recovery.

The counterpart of `src/repro/launch/train.py`, with its flags and its
`done:` line. The mesh is the reference's choice: `--production-mesh` is
the 16x16 production mesh (256 ranks, or it raises naming both counts),
more than one rank (under `torchrun`) the debug mesh, else (1, 1). On more
than one rank, params and optimizer state are DTensors on the sharding
rules' placements and the step is `runtime.steps.jit_train_step`;
`--resume` restores onto those placements. On one rank every placement is
Replicate, so the step is the same function as
`runtime.steps.make_train_step` on plain tensors, which runs without
DTensor's host cost per op. The process group is `nccl` on the card and
`gloo` on the CPU, taken from `torchrun`'s environment, or for one process
from a `FileStore` in a temporary directory. Weights are random, drawn from `--seed`, the same
on every rank, and the data is `synthetic_batch` of (step, seed). Remat is
"full", as the reference's launcher sets it. Runs on the card unless
`--device cpu` is given; a card that is not there is an error.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \\
        --steps 4 --batch 2 --seq 4096 --microbatches 2
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \\
        --smoke --device cpu --steps 4 --checkpoint-every 2 [--resume]
    PYTHONPATH=src torchrun --nproc-per-node 8 -m repro_torch.launch.train \\
        --arch qwen2.5-3b --smoke --device cpu --steps 4
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Any, Dict, List, Optional

import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.convert import flatten_with_path, tree_map
from repro_torch.data.pipeline import batch_to, synthetic_batch
from repro_torch.launch.mesh import make_world_mesh
from repro_torch.models import lm
from repro_torch.optim import adamw
from repro_torch.runtime import steps as steps_mod
from repro_torch.runtime.ft import StepMonitor, TrainSupervisor


def default_checkpoint_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def init_process_group(device: torch.device) -> bool:
    """Join the default process group unless one is up: `torchrun`'s
    environment when it is set, else one rank through a `FileStore` in a
    fresh temporary directory. `nccl` on the card, `gloo` on the CPU.
    Returns whether this call made the group (and so should end it)."""
    if dist.is_initialized():
        return False
    backend = "nccl" if device.type == "cuda" else "gloo"
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        if device.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(backend)
    else:
        if device.type == "cuda":
            torch.cuda.set_device(device.index or 0)
        path = os.path.join(tempfile.mkdtemp(prefix="repro_torch_pg_"),
                            "store")
        dist.init_process_group(backend, store=dist.FileStore(path, 1),
                                rank=0, world_size=1)
    return True


def train(arch: str, *, smoke: bool = False, steps: int = 20, batch: int = 8,
          seq: int = 128, checkpoint_dir: Optional[str] = None,
          checkpoint_every: int = 10, microbatches: int = 1,
          resume: bool = False, device="cuda", seed: int = 0,
          production_mesh: bool = False, on_step=None) -> Dict[str, Any]:
    """Train `arch` for `steps` steps (from the latest checkpoint with
    `resume`) on the mesh the reference's launcher picks (see the module
    docstring); returns the final state and the run's numbers. A process
    group this call starts is ended before it returns.

    `on_step(row)` is called after each step with its row of `history`.
    Keys of the result: `state` ({"params", "opt_state", "step",
    "metrics"}, the params and optimizer state as whole plain tensors),
    `start`, `loss` (the last step's), `history` (per step: step, loss,
    grad_norm, lr and ms, the supervisor's time of the step, its batch's
    making included, ending in a device synchronise),
    `wall_s`, `tok_s`, `stragglers`, `restarts`."""
    device = lm.resolve_device(device)
    owns_group = init_process_group(device)
    try:
        return _train(arch, smoke, steps, batch, seq, checkpoint_dir,
                      checkpoint_every, microbatches, resume, device, seed,
                      production_mesh, on_step)
    finally:
        if owns_group:
            dist.destroy_process_group()


def _train(arch, smoke, steps, batch, seq, checkpoint_dir, checkpoint_every,
           microbatches, resume, device, seed, production_mesh, on_step):
    cfg = (configs.get_smoke_config(arch) if smoke
           else configs.get_config(arch))
    shape = configs.ShapeConfig("cli_train", seq, batch, configs.KIND_TRAIN)
    par = configs.ParallelConfig(remat="full", microbatches=microbatches)
    mesh = make_world_mesh(production_mesh, device.type)
    opt_cfg = adamw.AdamWConfig(total_steps=steps)

    gen = torch.Generator(device=device).manual_seed(seed)
    params = lm.init_model(cfg, gen, device=device)
    opt_state = adamw.init_state(params)
    sharded = mesh.size() > 1
    if sharded:
        step_fn, p_sh, o_sh, _ = steps_mod.jit_train_step(
            cfg, par, mesh, opt_cfg, params, opt_state, shape)
        params = steps_mod.place_tree(params, p_sh)
        opt_state = steps_mod.place_tree(opt_state, o_sh)
    else:
        step_fn = steps_mod.make_train_step(cfg, par, opt_cfg)

    store = CheckpointStore(checkpoint_dir or default_checkpoint_dir())
    monitor = StepMonitor(on_straggler=lambda s, d, e: print(
        f"[straggler] step {s}: {d:.3f}s vs ewma {e:.3f}s"))
    sup = TrainSupervisor(store, checkpoint_every=checkpoint_every,
                          monitor=monitor)
    start = 0
    if resume and store.latest_step() is not None:
        # restore leaves directly onto their target placements (elastic:
        # the writer's mesh/layout is irrelevant)
        lookup = dict(flatten_with_path({"params": p_sh,
                                         "opt_state": o_sh})[0]
                      if sharded else [])
        restored, extra = store.restore(
            store.latest_step(), {"params": params, "opt_state": opt_state},
            sharding_fn=(lambda key, leaf: lookup[key]) if lookup else None)
        params, opt_state = restored["params"], restored["opt_state"]
        start = extra["step"]
        print(f"resumed from step {start}")

    history: List[Dict[str, float]] = []

    def batch_fn(step):
        return batch_to(synthetic_batch(cfg, shape, step, seed), device)

    def synced_step(p, o, b):
        out = step_fn(p, o, b)
        _sync(device)                   # the monitor times the step whole
        return out

    def record(step, duration_s, metrics):
        row = {"step": step, "ms": duration_s * 1e3,
               **{k: float(v) for k, v in metrics.items()}}
        history.append(row)
        if on_step is not None:
            on_step(row)

    _sync(device)
    t0 = time.perf_counter()
    state = sup.run({"params": params, "opt_state": opt_state,
                     "step": start}, synced_step, batch_fn, steps,
                    on_step=record)
    _sync(device)
    dt = time.perf_counter() - t0
    # whole tensors for the caller, gathered while the group is up
    if sharded:
        for key in ("params", "opt_state"):
            state[key] = tree_map(lambda t: t.full_tensor(), state[key])
    return {"state": state, "start": start,
            "loss": history[-1]["loss"] if history else None,
            "history": history, "wall_s": dt,
            "tok_s": (steps - start) * shape.tokens_per_step / max(dt, 1e-9),
            "stragglers": list(monitor.stragglers),
            "restarts": sup.restarts}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--checkpoint-dir", default=default_checkpoint_dir())
    ap.add_argument("--checkpoint-every", type=int, default=10)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--production-mesh", action="store_true",
                    help="the 16x16 production mesh: needs 256 ranks")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; an absent card is an error) or cpu")
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds the weights and the synthetic data")
    args = ap.parse_args(argv)

    device = lm.resolve_device(args.device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    res = train(args.arch, smoke=args.smoke, steps=args.steps,
                batch=args.batch, seq=args.seq,
                checkpoint_dir=args.checkpoint_dir,
                checkpoint_every=args.checkpoint_every,
                microbatches=args.microbatches, resume=args.resume,
                device=device, seed=args.seed,
                production_mesh=args.production_mesh, on_step=lambda r: print(
                    f"step {r['step']}: loss {r['loss']:.4f}, grad norm "
                    f"{r['grad_norm']:.4f}, lr {r['lr']:.3e}, "
                    f"{r['ms']:.1f} ms"))
    if device.type == "cuda":
        print(f"[{torch.cuda.get_device_name(device)}] peak device memory "
              f"{torch.cuda.max_memory_allocated(device) / 2**30:.3f} GiB "
              "(torch.cuda.max_memory_allocated)")
    loss = res["loss"] if res["loss"] is not None else float("nan")
    print(f"done: {args.steps} steps, final loss {loss:.4f}, "
          f"{res['tok_s']:,.0f} tok/s, stragglers={len(res['stragglers'])}")


if __name__ == "__main__":
    main()
