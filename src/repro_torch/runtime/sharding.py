"""Sharding rules: specs for params, optimizer state, caches, and batches on
the production meshes ("pod", "data", "model").

The counterpart of `src/repro/runtime/sharding.py`, rule for rule.

Conventions
-----------
* DP/batch: ("pod", "data") — gradients all-reduce across both axes.
* TP: "model" — attention heads / FFN hidden / vocab / experts.
* FSDP (big models): params additionally sharded over "data" on the largest
  non-TP dimension.
* ZeRO-1: optimizer moments follow the FSDP spec even when params are
  replicated (zero1 flag) — each data shard owns a slice of m/v.
* Sequence parallel: for prefill/long-context cells whose batch cannot
  cover the data axis, the sequence dimension shards over "data".

A spec is a tuple with one entry per tensor dim: None, an axis name, or a
tuple of names — the entries of the reference's `PartitionSpec`, which
`tuple(P)` gives. `to_placements` turns a spec into a DTensor's per-mesh-dim
placements. Leaf classification is name-based over the `keystr` path
strings (`convert.flatten_with_path`). The rules read only the mesh's axis
names and sizes, so they take a `DeviceMesh` or a `launch.mesh.MeshShape`
(production-size specs without 256 ranks). The `*_shardings` functions give
a tree of `Sharding` (mesh, spec) leaves, as the reference's give
`NamedSharding`s; a `Sharding`'s `placements` are what `distribute_tensor`
takes.
"""
from __future__ import annotations

import dataclasses
import math
import re
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

from torch.distributed.tensor import Replicate, Shard

from repro_torch.configs.base import ModelConfig, ParallelConfig, ShapeConfig
from repro_torch.convert import flatten_with_path, unflatten
from repro_torch.launch.mesh import axis_sizes

Params = Any
Spec = Tuple[Any, ...]


def batch_axes(mesh):
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)


def _divisible(n: int, mesh, *axes: str) -> bool:
    sizes = axis_sizes(mesh)
    return n % math.prod(sizes[a] for a in axes) == 0


def to_placements(spec: Spec, mesh) -> Tuple[Any, ...]:
    """Per-mesh-dim placements of `spec`: an entry on tensor dim `d` names
    the mesh dims that shard it, each becoming `Shard(d)`; the rest are
    `Replicate()`. A tuple entry ("pod", "data") shards `d` over pod, then
    data within each pod slice — jax's major-to-minor order, which is
    DTensor's when the names come in mesh order, as the rules give them."""
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} is not in the mesh's "
                             f"axis order {names}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"mesh axis {names[i]!r} shards two dims "
                                 f"in {spec!r}")
            out[i] = Shard(d)
    return tuple(out)


def param_spec(cfg: ModelConfig, par: ParallelConfig, mesh,
               path: str, leaf) -> Spec:
    """Spec for one parameter leaf (path from `flatten_with_path`).

    Stacked scan params have a leading period/layer axis that is never
    sharded; the rules below address the trailing dims.
    """
    dp = batch_axes(mesh)
    shape = tuple(leaf.shape)
    nd = len(shape)

    def fsdp_axis(tp_dim: Optional[int]) -> Optional[int]:
        """Pick the largest non-TP trailing dim divisible by the data axes."""
        if not par.fsdp:
            return None
        best, best_dim = None, 0
        start = 1 if nd >= 3 else 0      # skip the stacked layer axis
        for i in range(start, nd):
            if i == tp_dim:
                continue
            if shape[i] > best_dim and _divisible(shape[i], mesh, *dp):
                best, best_dim = i, shape[i]
        return best

    def spec_with(tp_dim: Optional[int]) -> Spec:
        axes = [None] * nd
        if tp_dim is not None and _divisible(shape[tp_dim], mesh, "model"):
            axes[tp_dim] = "model"
        else:
            tp_dim = None
        fa = fsdp_axis(tp_dim)
        if fa is not None:
            axes[fa] = dp if len(dp) > 1 else dp[0]
        return tuple(axes)

    # ---- embedding / head: vocab over model --------------------------------
    if re.search(r"\['embed'\]|\['head'\]", path):
        vocab_dim = next((i for i, s in enumerate(shape)
                          if s == cfg.vocab_size), 0)
        return spec_with(vocab_dim)
    # ---- MoE experts: expert dim over model (expert parallelism) -----------
    if re.search(r"\['ffn'\].*\['(w_gate|w_up|w_down)'\]", path) \
            and cfg.moe is not None and nd >= 3:
        axes = [None] * nd
        e_dim = nd - 3                   # [..., E, in, out]
        if par.expert_parallel and _divisible(shape[e_dim], mesh, "model"):
            axes[e_dim] = "model"
            if par.fsdp and _divisible(shape[nd - 1], mesh, *dp):
                axes[nd - 1] = dp if len(dp) > 1 else dp[0]
        return tuple(axes)
    if "router" in path:
        return (None,) * nd
    # ---- attention projections: heads (fused out dim) over model -----------
    if re.search(r"\['mix'\].*\['w(q|k|v)'\]", path):
        return spec_with(nd - 1)
    if re.search(r"\['mix'\].*\['wo'\]", path):
        return spec_with(nd - 2)         # input dim = heads*hd
    if re.search(r"\['mix'\].*\['b(q|k|v)'\]", path):
        axes = [None] * nd
        if _divisible(shape[-1], mesh, "model"):
            axes[-1] = "model"
        return tuple(axes)
    # ---- recurrent mixers: width over model ---------------------------------
    if re.search(r"\['mix'\].*\['(w_x|w_y|w_r|w_i|w_k|w_v|w_g|w_w)'\]", path):
        return spec_with(nd - 1)
    if re.search(r"\['mix'\].*\['(w_out|w_o)'\]", path):
        return spec_with(nd - 2)
    # ---- MLP: hidden over model ---------------------------------------------
    if re.search(r"\['ffn'\].*\['(w_gate|w_up)'\]", path):
        return spec_with(nd - 1)
    if re.search(r"\['ffn'\].*\['w_down'\]", path):
        return spec_with(nd - 2)
    # ---- everything else (norms, small vectors): replicated ----------------
    return (None,) * nd


def _map_with_path(fn, tree):
    flat, treedef = flatten_with_path(tree)
    return unflatten(treedef, [fn(path, leaf) for path, leaf in flat])


def _zero1(par: ParallelConfig) -> ParallelConfig:
    return par if par.fsdp else dataclasses.replace(par, fsdp=par.zero1)


def batch_specs(cfg: ModelConfig, par: ParallelConfig, mesh,
                shape: ShapeConfig) -> Dict[str, Spec]:
    dp = batch_axes(mesh)
    sizes = axis_sizes(mesh)
    dp_spec = dp if len(dp) > 1 else dp[0]
    B = shape.global_batch
    dsize = math.prod(sizes[a] for a in dp)
    shard_batch = B % dsize == 0
    seq_axis = None
    if (par.seq_shard and not shard_batch and shape.kind == "prefill"
            and shape.seq_len % sizes["model"] == 0):
        seq_axis = "model"
    b_axis = dp_spec if shard_batch else None
    return {
        "tokens": (b_axis, seq_axis),
        "labels": (b_axis, seq_axis),
        "features": (b_axis, seq_axis, None),
        "vision_embeds": (b_axis, None, None),
    }


def cache_spec(cfg: ModelConfig, par: ParallelConfig, mesh,
               path: str, leaf) -> Spec:
    """KV caches: batch over data axes; sequence (T) over "model" when the
    batch cannot cover the mesh (decode_32k/long_500k flash-decode style);
    recurrent states: width/heads over "model"."""
    dp = batch_axes(mesh)
    sizes = axis_sizes(mesh)
    dp_spec = dp if len(dp) > 1 else dp[0]
    dsize = math.prod(sizes[a] for a in dp)
    msize = sizes["model"]
    shape = tuple(leaf.shape)
    nd = len(shape)
    if "len" in path:
        return ()
    # scan caches carry a leading period axis: [P, B, ...]; tail caches
    # start at the batch dim.
    off = 1 if "'scan'" in path else 0
    axes = [None] * nd
    if "'k'" in path or "'v'" in path:
        b_i, t_i, h_i = off, off + 1, off + 2
        if shape[b_i] % dsize == 0:
            axes[b_i] = dp_spec
        if shape[t_i] % msize == 0 and shape[h_i] % msize != 0:
            axes[t_i] = "model"
        elif shape[h_i] % msize == 0:
            axes[h_i] = "model"
        return tuple(axes)
    if "'s'" in path:      # rwkv6 state [P, B, H, N, N]
        if shape[off] % dsize == 0:
            axes[off] = dp_spec
        if nd > off + 1 and shape[off + 1] % msize == 0:
            axes[off + 1] = "model"
        return tuple(axes)
    if "'h'" in path or "conv" in path or "last_x" in path:
        b_i = off if nd > off else 0
        if nd and shape[b_i] % dsize == 0:
            axes[b_i] = dp_spec
        if shape[nd - 1] % msize == 0:
            axes[nd - 1] = "model"
        return tuple(axes)
    return tuple(axes)


# ------------------------------------------------- specs -> placements
@dataclass(frozen=True, eq=False)
class Sharding:
    """A spec on a mesh: the counterpart of `NamedSharding(mesh, P(*spec))`,
    a leaf of the `*_shardings` trees."""
    mesh: Any
    spec: Spec

    @property
    def placements(self) -> Tuple[Any, ...]:
        return to_placements(self.spec, self.mesh)

    def shard_shape(self, global_shape) -> Tuple[int, ...]:
        """The local shape of each shard (the specs divide their dims)."""
        sizes = axis_sizes(self.mesh)
        out = list(global_shape)
        for d, entry in enumerate(self.spec):
            if entry is not None:
                axes = (entry,) if isinstance(entry, str) else entry
                out[d] //= math.prod(sizes[a] for a in axes)
        return tuple(out)


def params_shardings(cfg: ModelConfig, par: ParallelConfig, mesh,
                     params: Params) -> Params:
    return _map_with_path(lambda path, leaf: Sharding(
        mesh, param_spec(cfg, par, mesh, path, leaf)), params)


def opt_state_shardings(cfg: ModelConfig, par: ParallelConfig, mesh,
                        params: Params) -> Dict[str, Any]:
    """ZeRO-1: moments follow FSDP placement even if params replicate."""
    m = params_shardings(cfg, _zero1(par), mesh, params)
    return {"m": m, "v": m, "step": Sharding(mesh, ())}


def batch_shardings(cfg: ModelConfig, par: ParallelConfig, mesh,
                    shape: ShapeConfig) -> Dict[str, Sharding]:
    return {k: Sharding(mesh, s)
            for k, s in batch_specs(cfg, par, mesh, shape).items()}


def cache_shardings(cfg: ModelConfig, par: ParallelConfig, mesh,
                    cache: Params) -> Params:
    return _map_with_path(lambda path, leaf: Sharding(
        mesh, cache_spec(cfg, par, mesh, path, leaf)), cache)

