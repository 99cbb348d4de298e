"""One rank of a multi-process parallel-layer test (`test_torch_parallel*`).

    python tests/torch_parallel_worker.py JOB RANK WORLD WORKDIR

Reads `WORKDIR/input.pkl`, joins a `gloo` group of WORLD ranks through a
`FileStore` in WORKDIR (no TCP port to share between test workers), runs
JOB and writes `WORKDIR/out<RANK>.pkl`. Imports torch and the port only.
"""
import os
import pickle
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch import configs, convert  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.runtime import hints  # noqa: E402


def _np(t):
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor):
        t = t.full_tensor()
    return convert.tensor_to_numpy(t)


def _config(inp):
    cfg = configs.get_smoke_config(inp["arch"])
    if inp.get("replace"):
        import dataclasses
        cfg = dataclasses.replace(cfg, **inp["replace"])
    return cfg


def _knobs(inp):
    from repro_torch.models import blocks, moe, rwkv6
    for key, val in inp.get("knobs", {}).items():
        group, field = key.split(".")
        {"attn": blocks.ATTN_CONFIG, "moe": moe.MOE_CONFIG,
         "rwkv": rwkv6.RWKV_CONFIG}[group][field] = val


def job_train_step(inp, mesh):
    """Sharded train steps -> per-step metrics, the gathered params and
    the number of distinct shards of each param leaf."""
    from repro_torch.optim import adamw
    from repro_torch.runtime import steps
    cfg = _config(inp)
    par = configs.ParallelConfig(remat="full",
                                 microbatches=inp.get("microbatches", 1))
    shape = configs.ShapeConfig("t", inp["seq"], inp["batch"], "train")
    params = convert.params_from_numpy(inp["params"], device="cpu")
    opt = adamw.init_state(params)
    step, p_sh, _, _ = steps.jit_train_step(
        cfg, par, mesh, adamw.AdamWConfig(total_steps=len(inp["batches"])),
        params, opt, shape, dtype=torch.float32)
    metrics = []
    for b in inp["batches"]:
        batch = {k: torch.from_numpy(v) for k, v in b.items()}
        params, opt, m = step(params, opt, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    leaves, _ = convert.flatten(params)
    shards = [int(np.prod([mesh.shape[i] for i, pl in enumerate(t.placements)
                           if pl.is_shard()])) for t in leaves]
    return {"metrics": metrics, "params": [_np(t) for t in leaves],
            "shards": shards, "step": int(_np(opt["step"]))}


def job_moe(inp, mesh):
    """`apply_moe_sharded` on one layer's FFN -> (out, this rank's aux)."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.models import moe
    cfg = _config(inp)
    p = convert.params_from_numpy(inp["ffn"], device="cpu")
    x = distribute_tensor(torch.from_numpy(inp["x"]), mesh,
                          [Shard(0), Replicate()])
    out, aux = moe.apply_moe_sharded(cfg, p, x)
    return {"out": _np(out), "aux": float(aux.to_local())}


def job_decode(inp, mesh):
    """Prefill then decode steps through DTensor params and a DTensor cache
    on the sharding rules' placements -> the prefill's and each step's
    logits and the final cache, whole."""
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.models import lm
    from repro_torch.runtime import sharding as shd
    from repro_torch.runtime.steps import place_tree
    cfg = _config(inp)
    par = configs.ParallelConfig()
    params = convert.params_from_numpy(inp["params"], device="cpu")
    f32 = torch.float32
    cache = lm.init_cache(cfg, inp["batch"], inp["max_len"], dtype=f32,
                          device="cpu")
    dparams = place_tree(params, shd.params_shardings(cfg, par, mesh,
                                                      params))
    dcache = place_tree(cache, shd.cache_shardings(cfg, par, mesh, cache))
    with implicit_replication():
        out, dcache = lm.prefill(cfg, dparams, {"tokens": torch.from_numpy(
            inp["prompt"])}, dcache, dtype=f32)
        logits = [_np(out)]
        for tok in inp["tokens"]:
            out, dcache = lm.decode_step(cfg, dparams, torch.from_numpy(tok),
                                         dcache, dtype=f32)
            logits.append(_np(out))
    return {"logits": logits,
            "cache": [_np(t) for t in convert.flatten(dcache)[0]],
            "placements": sorted({str(tuple(t.placements))
                                  for t in convert.flatten(dcache)[0]})}


def job_cross_pod(inp, mesh):
    """`compressed_cross_pod_mean` of this rank's grads over "pod"."""
    from repro_torch.optim import adamw
    rank = dist.get_rank()
    grads = convert.params_from_numpy(inp["grads"][rank], device="cpu")
    error = convert.params_from_numpy(inp["error"][rank], device="cpu")
    mean, new_e = adamw.compressed_cross_pod_mean(
        grads, mesh.get_group("pod"), error)
    return {"mean": convert.tree_map(_np, mean),
            "error": convert.tree_map(_np, new_e)}


JOBS = {"train_step": job_train_step, "moe": job_moe,
        "decode": job_decode, "cross_pod": job_cross_pod}


def main(job, rank, world, workdir):
    torch.set_num_threads(1)
    with open(os.path.join(workdir, "input.pkl"), "rb") as f:
        inp = pickle.load(f)
    store = dist.FileStore(os.path.join(workdir, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        mesh = make_mesh(inp["mesh"], inp["axes"], "cpu")
        hints.set_mesh(mesh)
        _knobs(inp)
        out = JOBS[job](inp, mesh)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(workdir, f"out{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
