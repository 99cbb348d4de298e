"""Dry run: every (arch x shape) cell on the production meshes, on fake
ranks and fake tensors -> per-device memory, FLOPs, HBM bytes, collective
bytes and a three-term roofline on the H100's published rates.

The counterpart of `src/repro/launch/dryrun.py`. The reference lowers and
compiles each cell's step for 256 / 512 fake devices and reads the compiled
HLO. The port has no compiler to ask, so it runs the step itself, eagerly:
the process is rank 0 of a `fake` process group of the mesh's world size
(collectives return at once), every tensor is a `FakeTensorMode` tensor
(shapes and types, no storage), and `launch.op_analysis.OpCounter` counts
the ops rank 0 runs on its local shards. Steps are built as the reference
builds them: `use_kernels=False`, params in float32 (bf16 above 100 B
parameters, with bf16 moments), `default_parallel` per cell. Where the
reference weights a scanned body by its trip count, the port runs the step
at 1 and 2 periods of the layer pattern and 1 and 2 microbatches and
extrapolates (`run_cell`); `--full-depth` runs it whole (minutes a cell).

Keys are the reference's where they mean the same. Dropped, being XLA's:
`lower_s`, `compile_s` (the eager runs' host time is `run_s`),
`cost_analysis_flops`, `cost_analysis_bytes`, `while_trips` (a Python loop
has no trip count to recover), `mem.output_gb`, `mem.temp_gb`,
`mem.alias_gb` (no buffer assignment). `mem.argument_gb` is exact (the
local shards of params, optimizer state, batch and cache); `mem.peak_gb` is
the most tensor storage alive at once during the eager run, what eager
PyTorch would hold, not XLA's figure. `op_count` counts the ops rank 0 ran.
All figures are modelled (counts over published peaks), none measured.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-3b \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --out dryrun.jsonl
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import sys
import time
from typing import Any, Dict

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch import configs
from repro_torch.configs.base import KIND_PREFILL, KIND_TRAIN
from repro_torch.convert import flatten
from repro_torch.data.pipeline import input_specs
from repro_torch.launch import op_analysis
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import lm
from repro_torch.optim import adamw
from repro_torch.runtime import hints
from repro_torch.runtime import sharding as shd
from repro_torch.runtime import steps as steps_mod

# ----------------------------------------------------------- H100 rates
# NVIDIA H100 data sheet, SXM part, dense, at its 700 W limit: bf16 tensor
# core peak and HBM3 rate. The link: NVLink 4, 900 GB/s per card both ways
# together, taken as 450 GB/s each way. A mesh axis wider than a node's 8
# cards crosses the network instead (400 Gb/s = 50 GB/s a card on a
# ConnectX-7 NIC), so `collective_s` is a floor there.
H100 = {
    "peak_flops": 989e12,          # bf16 FLOP/s
    "hbm_bytes_per_s": 3.35e12,    # B/s
    "link_bytes_per_s": 450e9,     # B/s each way, NVLink 4
}


@contextlib.contextmanager
def fake_world(world: int, rank: int = 0):
    """This process as `rank` of a `fake` process group of `world` ranks,
    ended on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def _strided_index_math_outside_fake_mode():
    """DTensor works out a strided shard's local indices with a real
    `torch.arange` and `.tolist()`; under `FakeTensorMode` that arange is
    fake and `.tolist()` fails as data-dependent. Run that index arithmetic
    with the fake mode set aside and uncounted (it touches no tensor of
    the step)."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor.placement_types import _StridedShard
    orig = _StridedShard.local_shard_size_and_offset

    def outside(*args, **kwargs):
        with unset_fake_temporarily(), op_analysis.not_counted():
            return orig(*args, **kwargs)

    _StridedShard.local_shard_size_and_offset = outside
    try:
        yield
    finally:
        _StridedShard.local_shard_size_and_offset = orig


def _plain_as_replicated(fn):
    """`fn` with plain tensors made inside it (masks, positions) taken as
    replicated on the mesh, as the sharded train step takes them."""
    from torch.distributed.tensor.experimental import implicit_replication

    def run(*args):
        with implicit_replication():
            return fn(*args)
    return run


# --------------------------------------------------------------- cell builder
def build_cell(arch: str, shape_name: str, mesh, par=None,
               moe_mode: str = "capacity", microbatches: int = 0,
               params_bf16: bool = False, cfg=None, shape=None):
    """((fn, args), "") for one (arch x shape x mesh) cell, or (None,
    reason) where the shape does not apply. Call under a `FakeTensorMode`
    with `mesh` registered (`hints.set_mesh`). `cfg` / `shape` replace the
    arch's config and the named shape (the dry run's cut depths and
    batches)."""
    cfg = cfg or configs.get_config(arch)
    shape = shape or configs.get_shape(shape_name)
    ok, reason = configs.shape_applicable(cfg, shape)
    if not ok:
        return None, reason
    par = par or configs.default_parallel(cfg, shape)
    if microbatches:
        par = dataclasses.replace(par, microbatches=microbatches)
    big = configs.get_config(arch).param_count() > 100e9
    # >=100B-param configs hold weights in bf16 (f32 masters would exceed
    # the fleet's HBM; the optimizer keeps f32 math on bf16 moments)
    p_dtype = torch.bfloat16 if (big or params_bf16) else torch.float32
    params = lm.init_model(cfg, torch.Generator().manual_seed(0),
                           dtype=p_dtype, device="cpu")
    p_sh = shd.params_shardings(cfg, par, mesh, params)
    params = steps_mod.place_tree(params, p_sh)
    # the named shape's batch layout, also for a cut batch
    b_sh = shd.batch_shardings(cfg, par, mesh, configs.get_shape(shape_name))
    batch = {k: distribute_tensor(torch.zeros(v.shape, dtype=v.dtype), mesh,
                                  b_sh.get(k, b_sh["tokens"]).placements)
             for k, v in input_specs(cfg, shape).items()}

    if shape.kind == KIND_TRAIN:
        moment_dtype = torch.bfloat16 if big else torch.float32
        opt_state = adamw.init_state(params, moment_dtype=moment_dtype)
        o_sh = shd.opt_state_shardings(cfg, par, mesh, params)
        opt_state = steps_mod.place_tree(opt_state, o_sh)
        step, _, _, _ = steps_mod.jit_train_step(
            cfg, par, mesh, adamw.AdamWConfig(), params, opt_state, shape,
            use_kernels=False, moe_mode=moe_mode)
        return (step, (params, opt_state, batch)), ""
    if shape.kind == KIND_PREFILL and not cfg.is_decoder:
        # encoder-only: full forward, no cache
        def enc_fwd(params, batch):
            return lm.prefill(cfg, params, batch, None,
                              moe_mode=moe_mode)[0]
        return (_plain_as_replicated(enc_fwd), (params, batch)), ""
    cache = lm.init_cache(cfg, shape.global_batch, shape.seq_len,
                          device="cpu")
    cache = steps_mod.place_tree(cache, shd.cache_shardings(cfg, par, mesh,
                                                             cache))
    if shape.kind == KIND_PREFILL:
        step = steps_mod.make_prefill_step(cfg, par, moe_mode=moe_mode)
        return (_plain_as_replicated(step), (params, batch, cache)), ""
    step = steps_mod.make_serve_step(cfg, par, moe_mode=moe_mode)
    return (_plain_as_replicated(step), (params, batch["tokens"], cache)), ""


def _local_bytes(tree) -> int:
    total = 0
    for t in flatten(tree)[0]:
        if isinstance(t, torch.Tensor):
            t = t.to_local() if isinstance(t, DTensor) else t
            total += t.numel() * t.element_size()
    return total


def argument_bytes(arch: str, shape_name: str, mesh, par=None,
                   params_bf16: bool = False) -> int:
    """The bytes of one rank's share of a cell's arguments (params,
    optimizer state, batch, cache) from the sharding rules' specs alone:
    each leaf's `Sharding.shard_shape` on `mesh` (a `MeshShape` will do)
    times its item size, in the types `build_cell` gives them."""
    cfg = configs.get_config(arch)
    shape = configs.get_shape(shape_name)
    par = par or configs.default_parallel(cfg, shape)
    big = cfg.param_count() > 100e9
    p_dtype = torch.bfloat16 if (big or params_bf16) else torch.float32

    def total(tree, shardings, item=None):
        return sum(math.prod(sh.shard_shape(t.shape))
                   * (item or t.element_size())
                   for t, sh in zip(flatten(tree)[0], flatten(shardings)[0]))

    params = lm.init_model(cfg, dtype=p_dtype, device="meta")
    n = total(params, shd.params_shardings(cfg, par, mesh, params))
    b_sh = shd.batch_shardings(cfg, par, mesh, shape)
    batch = input_specs(cfg, shape)
    n += sum(math.prod(b_sh.get(k, b_sh["tokens"]).shard_shape(t.shape))
             * t.element_size() for k, t in batch.items()
             if shape.kind != "decode" or k == "tokens")
    if shape.kind == KIND_TRAIN:
        o_sh = shd.opt_state_shardings(cfg, par, mesh, params)
        m_item = 2 if big else 4
        n += 2 * total(params, o_sh["m"], m_item) + 4    # m, v; int32 step
    elif shape.kind != KIND_PREFILL or cfg.is_decoder:
        cache = lm.init_cache(cfg, shape.global_batch, shape.seq_len,
                              device="meta")
        n += total(cache, shd.cache_shardings(cfg, par, mesh, cache))
    return n


def _count(fn, args) -> op_analysis.OpCounts:
    counter = op_analysis.OpCounter()
    counter.track(args)
    with counter:
        fn(*args)
    return counter.counts


def _as_vector(c: op_analysis.OpCounts) -> Dict[str, float]:
    out = {"flops": c.flops, "hbm_bytes": c.hbm_bytes,
           "ici_bytes": c.ici_bytes, "collective_count": c.collective_count,
           "op_count": c.op_count}
    for kind in op_analysis.COLLECTIVE_KINDS:
        out["coll:" + kind] = c.by_collective.get(kind, 0.0)
    return out


def _bilinear(f, p_full: int, m_full: int) -> Dict[str, float]:
    """f[(p, m)] for p, m in {1, 2} (where the full value exceeds 1) ->
    the value at (p_full, m_full) of the function a + b p + c m + d p m
    through those points: exact for counts that add up over identical
    periods and identical microbatches, as the reference's HLO analysis
    weights each loop body by its trip count."""
    ps = (1, 2) if p_full > 1 else (p_full,)
    ms = (1, 2) if m_full > 1 else (m_full,)
    out = {}
    for key in f[(ps[0], ms[0])]:
        g = {pm: f[pm][key] for pm in f}
        v = g[(ps[0], ms[0])]
        dp = (g[(2, ms[0])] - v) if len(ps) == 2 else 0.0
        dm = (g[(ps[0], 2)] - v) if len(ms) == 2 else 0.0
        dpm = (g[(2, 2)] - g[(2, 1)] - g[(1, 2)] + v
               if len(ps) == 2 and len(ms) == 2 else 0.0)
        out[key] = (v + (p_full - ps[0]) * dp + (m_full - ms[0]) * dm
                    + (p_full - ps[0]) * (m_full - ms[0]) * dpm)
    return out


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             moe_mode: str = "capacity", microbatches: int = 0,
             params_bf16: bool = False, mesh_shape=None,
             full_depth: bool = False) -> Dict[str, Any]:
    """One cell on the production mesh (or `mesh_shape`, (shape, axes)).

    The state is built at full size for `mem.argument_gb`, checked against
    the bytes the specs give rank 0. The step then runs at 1 and 2 periods
    of the block pattern (the tail kept) and, with microbatches, at 1 and 2
    microbatches of the real microbatch size; the counts are extrapolated
    to the full depth and count (`_bilinear`) and the peak linearly in the
    periods at one microbatch. `full_depth` runs the whole step instead."""
    cfg = configs.get_config(arch)
    shape = configs.get_shape(shape_name)
    ok, reason = configs.shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
                "skipped": True, "reason": reason}
    if mesh_shape is None:
        dims, axes = ((2, 16, 16), ("pod", "data", "model")) if multi_pod \
            else ((16, 16), ("data", "model"))
    else:
        dims, axes = mesh_shape
    chips = math.prod(dims)
    par = configs.default_parallel(cfg, shape)
    if microbatches:
        par = dataclasses.replace(par, microbatches=microbatches)
    period = len(cfg.block_pattern)
    p_full, tail = divmod(cfg.num_layers, period)
    m_full = max(par.microbatches, 1) if shape.kind == KIND_TRAIN else 1
    if full_depth:
        runs = [(p_full, m_full)]
    else:
        runs = [(p, m) for p in ((1, 2) if p_full > 1 else (p_full,))
                for m in ((1, 2) if m_full > 1 else (m_full,))]
    per_micro = shape.global_batch // m_full
    t0 = time.perf_counter()
    counts, peaks = {}, {}
    with fake_world(chips):
        mesh = make_mesh(dims, axes, device_type="cpu")
        hints.set_mesh(mesh)
        try:
            with FakeTensorMode(), _strided_index_math_outside_fake_mode():
                (_, args), _ = build_cell(arch, shape_name, mesh, par,
                                          moe_mode, params_bf16=params_bf16)
                argument = _local_bytes(args)
                want = argument_bytes(arch, shape_name, mesh, par,
                                      params_bf16)
                if argument != want:
                    raise AssertionError(
                        f"{arch} {shape_name}: local shards hold {argument} "
                        f"B, the specs give {want} B")
                del args
                for p, m in runs:
                    run_cfg = dataclasses.replace(
                        cfg, num_layers=p * period + tail)
                    run_shape = dataclasses.replace(
                        shape, global_batch=per_micro * m)
                    (fn, args), _ = build_cell(
                        arch, shape_name, mesh,
                        dataclasses.replace(par, microbatches=m), moe_mode,
                        params_bf16=params_bf16, cfg=run_cfg,
                        shape=run_shape)
                    c = _count(fn, args)
                    del fn, args
                    counts[(p, m)] = _as_vector(c)
                    peaks[(p, m)] = {"peak": c.peak_bytes}
        finally:
            hints.set_mesh_axes(None)
    run_s = time.perf_counter() - t0
    if full_depth:
        tot, peak = counts[runs[0]], peaks[runs[0]]["peak"]
    else:
        tot = _bilinear(counts, p_full, m_full)
        peak = _bilinear({k: v for k, v in peaks.items() if k[1] == 1},
                         p_full, 1)["peak"]
    mult = 6 if shape.kind == KIND_TRAIN else 2
    model_flops = mult * cfg.active_param_count() * shape.tokens_per_step
    terms = {
        "compute_s": tot["flops"] / H100["peak_flops"],
        "memory_s": tot["hbm_bytes"] / H100["hbm_bytes_per_s"],
        "collective_s": tot["ici_bytes"] / H100["link_bytes_per_s"],
    }
    result = {
        "arch": arch, "shape": shape_name, "multi_pod": multi_pod,
        "chips": chips, "skipped": False, "run_s": run_s,
        "depth_runs": [list(r) for r in runs],
        "mem": {"argument_gb": argument / 1e9, "peak_gb": peak / 1e9},
        "flops_per_dev": tot["flops"],
        "bytes_per_dev": tot["hbm_bytes"],
        "collective_bytes_per_dev": tot["ici_bytes"],
        "collectives": {k: tot["coll:" + k]
                        for k in op_analysis.COLLECTIVE_KINDS
                        if tot["coll:" + k]},
        "collective_count": round(tot["collective_count"]),
        "op_count": round(tot["op_count"]),
        "model_flops_total": model_flops,
        "terms": terms,
        "useful_flops_ratio": (model_flops / chips)
        / max(tot["flops"], 1.0),
    }
    result["bottleneck"] = max(terms, key=terms.get)
    result["roofline_frac"] = max(
        result["useful_flops_ratio"] * terms["compute_s"]
        / max(sum(terms.values()), 1e-12), 0.0)
    return result


def apply_tuning(tune) -> None:
    """--tune rwkv.impl=chunked attn.q_chunk=1024 ... (perf iterations)."""
    from repro_torch.models import blocks as _blocks
    from repro_torch.models import lm as _lm
    from repro_torch.models import moe as _moe
    from repro_torch.models import rwkv6 as _rwkv6
    targets = {"attn": _blocks.ATTN_CONFIG, "rwkv": _rwkv6.RWKV_CONFIG,
               "moe": _moe.MOE_CONFIG, "lm": _lm.LM_CONFIG}
    for item in tune:
        key, _, val = item.partition("=")
        group, _, field = key.partition(".")
        cfgd = targets[group]
        old = cfgd[field]
        cfgd[field] = type(old)(int(val) if isinstance(old, int)
                                else float(val) if isinstance(old, float)
                                else val)
        print(f"# tune {group}.{field} = {cfgd[field]}", file=sys.stderr)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="multi-pod dry-run")
    ap.add_argument("--arch", default="all", help="arch id or 'all'")
    ap.add_argument("--shape", default="all", help="shape name or 'all'")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--moe-mode", default="capacity")
    ap.add_argument("--microbatches", type=int, default=0)
    ap.add_argument("--params-bf16", action="store_true")
    ap.add_argument("--tune", action="append", default=[],
                    help="perf knobs, e.g. rwkv.impl=chunked "
                         "attn.chunk_threshold=4096 moe.sharded=1")
    ap.add_argument("--full-depth", action="store_true",
                    help="run every layer and microbatch (slow) instead of "
                         "extrapolating from 1 and 2 of each")
    ap.add_argument("--out", default="", help="append JSONL results here")
    args = ap.parse_args(argv)
    archs = configs.ARCH_IDS if args.arch == "all" else [args.arch]
    shapes = list(configs.SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    apply_tuning(args.tune)
    failures = 0
    for arch in archs:
        for shape_name in shapes:
            for mp in meshes:
                try:
                    res = run_cell(arch, shape_name, mp,
                                   moe_mode=args.moe_mode,
                                   microbatches=args.microbatches,
                                   params_bf16=args.params_bf16,
                                   full_depth=args.full_depth)
                except Exception as e:  # noqa: BLE001 — report and continue
                    res = {"arch": arch, "shape": shape_name,
                           "multi_pod": mp, "error": repr(e)[:500],
                           "skipped": False}
                    failures += 1
                line = json.dumps(res)
                print(line, flush=True)
                if args.out:
                    with open(args.out, "a") as f:
                        f.write(line + "\n")
    if failures:
        print(f"FAILURES: {failures}", file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
