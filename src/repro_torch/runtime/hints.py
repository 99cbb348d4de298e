"""Sharding hints for activations inside model code.

The counterpart of `src/repro/runtime/hints.py`. Model code is
mesh-agnostic; the launcher registers the active mesh's axis sizes
(`set_mesh_axes`, `set_mesh`), and `constrain` redistributes a DTensor
activation to the placements of a spec, cleaned as the reference cleans it
(axes missing from the mesh, or not dividing the dim, become None). Without
registered axes, or on a tensor that is not a DTensor, it is the identity,
so tests and single-device runs are untouched. A redistribution that fails
raises: the port runs eagerly, so there is no trace outside a mesh to
excuse.

The rest says to DTensor what XLA's partitioner settles by itself, each
the identity on plain tensors: `whole_groups` gathers a dim before a
reshape splits it into heads where its shards would not hold whole heads,
`reshape` and `grad_as_forward` lay a gradient out as its forward value
was, `gather_fsdp` is the FSDP all-gather of a layer's weights,
`take_rows` the embedding lookup, `write_rows` a cache's in-place row
writes, `local_box` a shard's place in the whole.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional, Sequence, Union

import torch
from torch.distributed.tensor import DTensor, Replicate

_state = threading.local()


def set_mesh_axes(axes: Optional[Dict[str, int]], mesh=None) -> None:
    _state.axes = dict(axes) if axes else None
    _state.mesh = mesh


def set_mesh(mesh) -> None:
    """Register a `DeviceMesh` (or a `launch.mesh.MeshShape`) and its axis
    sizes."""
    set_mesh_axes(dict(zip(mesh.mesh_dim_names, tuple(mesh.shape))), mesh)


def get_mesh():
    return getattr(_state, "mesh", None)


def get_mesh_axes() -> Optional[Dict[str, int]]:
    return getattr(_state, "axes", None)


def axis_size(name: Union[str, Sequence[str]]) -> int:
    axes = get_mesh_axes() or {}
    if isinstance(name, str):
        return axes.get(name, 1)
    n = 1
    for a in name:
        n *= axes.get(a, 1)
    return n


def batch_spec_axes():
    axes = get_mesh_axes() or {}
    return ("pod", "data") if "pod" in axes else ("data",)


def clean_spec(shape, spec, axes: Dict[str, int]):
    """The reference's cleaning: an entry whose axes are not all in the
    mesh, or whose size does not divide its dim, becomes None."""
    clean = []
    for dim, entry in zip(shape, spec):
        if entry is None:
            clean.append(None)
            continue
        names = (entry,) if isinstance(entry, str) else tuple(entry)
        if not all(n in axes for n in names):
            clean.append(None)
            continue
        size = 1
        for n in names:
            size *= axes[n]
        clean.append(entry if dim % size == 0 else None)
    return tuple(clean)


def constrain(x, *spec):
    """`x` redistributed to the placements of the cleaned spec when axes are
    registered and `x` is a DTensor, else `x`. Each spec entry: None | axis
    name | tuple of axis names."""
    axes = get_mesh_axes()
    if axes is None or not isinstance(x, DTensor):
        return x
    from repro_torch.runtime.sharding import to_placements
    mesh = x.device_mesh
    # a shard over a mesh dim of one rank is the whole: say so, since
    # DTensor's views refuse a sharded dim of size 1
    placements = _one_rank_whole(
        mesh, to_placements(clean_spec(x.shape, spec, axes), mesh))
    if _one_rank_whole(mesh, x.placements) == placements:
        return x
    return x.redistribute(mesh, placements)


def _one_rank_whole(mesh, placements):
    """`placements` with every mesh dim of one rank as Replicate: a shard
    or a pending sum over one rank is the whole value already."""
    return tuple(Replicate() if size == 1 else pl
                 for size, pl in zip(mesh.shape, placements))


def whole_groups(x, dim: int, groups: int):
    """`x` about to be split on `dim` into `groups` equal groups (heads):
    a DTensor whose `dim` is sharded over n ranks with `groups` not a
    multiple of n is first gathered on that dim, so that the split is a
    local view. XLA reshards at such a reshape by itself; DTensor's view
    refuses. Otherwise the identity."""
    if not isinstance(x, DTensor):
        return x
    dim = dim % x.ndim
    mesh = x.device_mesh
    n = 1
    for size, pl in zip(mesh.shape, x.placements):
        if pl.is_shard(dim):
            n *= size
    if groups % n == 0:
        return x
    return x.redistribute(mesh, [Replicate() if pl.is_shard(dim) else pl
                                 for pl in x.placements])


class _GradAsForward(torch.autograd.Function):
    """Identity forward; the backward lays the gradient out as the forward's
    value was (a pending sum's gradient replicated)."""

    @staticmethod
    def forward(ctx, x):
        ctx.mesh = x.device_mesh
        ctx.placements = tuple(Replicate() if pl.is_partial() else pl
                               for pl in x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if _one_rank_whole(ctx.mesh, g.placements) != _one_rank_whole(
                ctx.mesh, ctx.placements):
            g = g.redistribute(ctx.mesh, ctx.placements)
        return g


def grad_as_forward(x):
    """`x`; on a DTensor, its gradient is laid out as `x` is before it
    flows on (the all-reduce of Megatron's "f" at a tensor-parallel
    block's input, whose gradients come back as partial sums). The
    identity on plain tensors."""
    if not isinstance(x, DTensor):
        return x
    return _GradAsForward.apply(x)


def reshape(x, shape):
    """`x.reshape(shape)`; on a DTensor, the gradient of the result is laid
    out as the result was before the backward reshapes it back (a gradient
    that arrives sharded where the forward's view was not, e.g. heads over
    "model" that do not divide, would make DTensor refuse that view)."""
    if not isinstance(x, DTensor):
        return x.reshape(shape)
    return grad_as_forward(x.reshape(shape))


def _whole(t):
    """A DTensor's whole value on this rank (a plain tensor as it is)."""
    if not isinstance(t, DTensor):
        return t
    return t.redistribute(t.device_mesh, [Replicate()] * t.device_mesh.ndim
                          ).to_local()


def local_box(t: DTensor):
    """(shape, offset) of this rank's shard of `t` in the global tensor,
    from its `Shard` placements in mesh order (chunks as `torch.chunk`
    cuts them), in plain integers."""
    shape, offset = list(t.shape), [0] * t.ndim
    coord = t.device_mesh.get_coordinate()
    for i, pl in enumerate(t.placements):
        if pl.is_shard():
            d, n = pl.dim, t.device_mesh.shape[i]
            step = -(-shape[d] // n)
            start = min(step * coord[i], shape[d])
            offset[d] += start
            shape[d] = min(step, shape[d] - start)
    return shape, offset


def write_rows(cache, bidx, idx, values) -> None:
    """`cache[bidx, idx] = values` IN PLACE: a decode step's new K/V rows,
    `bidx` the rows 0..B-1 (as [B] or [B, 1]) and `idx` their positions
    ([B] or [B, S]), all (row, position) pairs distinct. On a
    DTensor cache (batch over the data axes, positions or heads over
    "model") each rank writes the pairs that fall in its shard into its
    local tensor; a pair outside it rewrites the value already at its
    clamped place, so no shape depends on the data. DTensor itself has no
    in-place indexed write for a sharded destination."""
    if not isinstance(cache, DTensor):
        cache.index_put_((bidx, idx), values)
        return
    local = cache.to_local()
    shape, offset = local_box(cache)
    rows = slice(offset[0], offset[0] + shape[0])
    idx, values = _whole(idx), _whole(values).to(local.dtype)
    if idx.dim() == 1:                  # one position a row: [B] -> [B, 1]
        idx, values = idx[:, None], values[:, None]
    idx, values = idx[rows] - offset[1], values[rows]
    for d in range(2, cache.ndim):
        values = values.narrow(d, offset[d], shape[d])
    inside = (idx >= 0) & (idx < shape[1])
    idx = idx.clamp(0, shape[1] - 1)
    brow = torch.arange(shape[0], device=local.device)[:, None]
    brow = brow.expand_as(idx)
    inside = inside.reshape(inside.shape + (1,) * (local.ndim - 2))
    local.index_put_((brow, idx), torch.where(inside, values,
                                              local[brow, idx]))


def gather_fsdp(tree):
    """The FSDP all-gather: each DTensor leaf of `tree` with its shards over
    the batch axes ("pod", "data") gathered, its "model" shards kept. Model
    code calls it on a layer's weights where it uses them, so a gathered
    layer lives for that layer only (and under remat is gathered again in
    the backward), whose gradient is then reduce-scattered back. The
    reference leaves this to XLA, which inserts the per-layer all-gather
    itself; DTensor, left alone, would gather the activations too and run
    the product whole on every rank. The identity on plain tensors."""
    def one(t):
        if not isinstance(t, DTensor):
            return t
        names = t.device_mesh.mesh_dim_names or ()
        pl = [Replicate() if p.is_shard() and names[i] in ("pod", "data")
              and t.device_mesh.shape[i] > 1 else p
              for i, p in enumerate(t.placements)]
        return t if pl == list(t.placements) else t.redistribute(
            t.device_mesh, pl)
    if isinstance(tree, dict):
        return {k: gather_fsdp(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(gather_fsdp(v) for v in tree)
    return one(tree)


def take_rows(table, ids):
    """`table[ids]`, the embedding lookup, as `F.embedding` on plain
    tensors and DTensors alike, so that both take the same backward (the
    sum of a token's gradients in one order). DTensor shards it over the
    vocabulary (its rule for indexing a table does not hold on every
    version), and the rows are then all-reduced."""
    out = torch.nn.functional.embedding(ids, table)
    if not isinstance(table, DTensor):
        return out
    # the vocabulary split leaves each row a masked partial sum: settle it
    # here, while the mask still matches the rows' layout
    return out.redistribute(out.device_mesh, [
        Replicate() if pl.is_partial() else pl for pl in out.placements])
