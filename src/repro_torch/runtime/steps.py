"""Step builders: the train step, prefill and one decode step as closures,
shared by the train loop, the serving loop and the dry run.

The counterpart of `src/repro/runtime/steps.py`. PyTorch runs eagerly, so
the closures are plain functions; the train step updates the params and the
optimizer state IN PLACE (see `optim.adamw.apply_updates`), as the
reference's donation lets XLA do. `jit_train_step` is the sharded step: the
same closure on DTensors laid out by the sharding rules, run eagerly.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict

import torch
from torch.distributed.tensor import DTensor, Replicate, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs.base import ModelConfig, ParallelConfig, ShapeConfig
from repro_torch.convert import flatten, unflatten
from repro_torch.models import lm
from repro_torch.optim import adamw
from repro_torch.runtime import hints
from repro_torch.runtime import sharding as shd

Params = Any


def make_train_step(cfg: ModelConfig, par: ParallelConfig,
                    opt_cfg: adamw.AdamWConfig,
                    use_kernels: bool = False,
                    moe_mode: str = "capacity",
                    dtype=torch.bfloat16) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, metrics).

    `dtype` is the compute type of `lm.train_loss` (the reference's step
    always takes its default, bfloat16). The gradients are taken in the
    params' own type, float32 masters or the reference's bf16 weights above
    100 B parameters, as the reference's are.

    par.microbatches > 1 -> gradient accumulation: the batch is split along
    its first dim and each part's gradient is added, in float32, into one
    accumulator, which is then divided by the count (the loss likewise), as
    the reference's scan does; `metrics` then has no `aux_loss`, as there.
    A float32 leaf's accumulator is the `.grad` of its alias
    (`torch.autograd.backward`), so a microbatch's gradient is added as the
    backward reaches it: one float32 gradient tree is held, not two. Another
    type's gradient is widened and added into a float32 accumulator after
    each microbatch.
    """
    n_micro = max(par.microbatches, 1)

    def train_step(params: Params, opt_state: Dict[str, Any],
                   batch: Dict[str, torch.Tensor]):
        leaves, treedef = flatten(params)
        # aliases that share the params' storage and collect the gradients
        alias = [t.detach().requires_grad_(True) for t in leaves]
        p_alias = unflatten(treedef, alias)
        acc = [None] * len(alias)       # float32 sums of other types' grads
        if n_micro == 1:
            loss, metrics = lm.train_loss(
                cfg, p_alias, batch, use_kernels=use_kernels,
                moe_mode=moe_mode, remat=par.remat, dtype=dtype)
            torch.autograd.backward(loss, inputs=alias)
            loss = loss.detach()
            metrics = {k: v.detach() for k, v in metrics.items()}
        else:
            lsum = torch.zeros((), dtype=torch.float32,
                               device=leaves[0].device)
            for i in range(n_micro):
                loss, _ = lm.train_loss(
                    cfg, p_alias, {k: _microbatch(v, i, n_micro)
                                   for k, v in batch.items()},
                    use_kernels=use_kernels, moe_mode=moe_mode,
                    remat=par.remat, dtype=dtype)
                torch.autograd.backward(loss, inputs=alias)
                lsum = lsum + loss.detach()
                for j, a in enumerate(alias):
                    if a.dtype != torch.float32 and a.grad is not None:
                        acc[j] = (a.grad.float() if acc[j] is None
                                  else acc[j].add_(a.grad))
                        a.grad = None
            for a, s in zip(alias, acc):
                g = s if s is not None else a.grad
                if g is not None:
                    g.div_(n_micro)
            loss = lsum / n_micro
            metrics = {}
        # a leaf the loss does not reach has a zero gradient, as in JAX; a
        # DTensor gradient goes to its moment's placements a leaf at a time,
        # so its pending data-parallel sum is not held twice
        flat_m, _ = flatten(opt_state["m"])
        grads = []
        for j, (a, m) in enumerate(zip(alias, flat_m)):
            g = acc[j] if acc[j] is not None else a.grad
            if g is None:
                g = torch.zeros_like(a)
            a.grad = acc[j] = None
            grads.append(adamw.to_moment_layout(g, m))
        grads = unflatten(treedef, grads)
        del p_alias, alias, acc
        params, opt_state, opt_metrics = adamw.apply_updates(
            opt_cfg, params, grads, opt_state)
        metrics = {"loss": loss, **metrics, **opt_metrics}
        return params, opt_state, metrics

    return train_step


def _microbatch(v: torch.Tensor, i: int, n: int) -> torch.Tensor:
    """Rows [i * B/n, (i+1) * B/n) of a batch leaf, the reference's
    microbatch i. A DTensor's rows are gathered, sliced and laid out as the
    batch was, so each microbatch is spread over the data ranks (a reshape
    to [n, B/n, ...] would put microbatch i on the ranks holding its rows,
    or be refused where n does not divide among them)."""
    b = v.shape[0] // n
    if not isinstance(v, DTensor):
        return v.reshape((n, b) + tuple(v.shape[1:]))[i]
    mesh, pl = v.device_mesh, v.placements
    whole = v.redistribute(mesh, [Replicate() if p.is_shard(0) else p
                                  for p in pl])
    ranks = math.prod(mesh.shape[j] for j, p in enumerate(pl)
                      if p.is_shard(0))
    if b == 1 or b % ranks:
        # one row, or rows that do not split evenly: the microbatch stays
        # whole on every rank (DTensor's views refuse a sharded unit dim)
        pl = whole.placements
    return whole[i * b:(i + 1) * b].redistribute(mesh, pl)


def make_prefill_step(cfg: ModelConfig, par: ParallelConfig,
                      use_kernels: bool = False,
                      moe_mode: str = "capacity") -> Callable:
    def prefill_step(params: Params, batch: Dict[str, torch.Tensor],
                     cache: Params):
        return lm.prefill(cfg, params, batch, cache,
                          use_kernels=use_kernels, moe_mode=moe_mode)
    return prefill_step


def make_serve_step(cfg: ModelConfig, par: ParallelConfig,
                    use_kernels: bool = False,
                    moe_mode: str = "capacity") -> Callable:
    """One decode step: (params, tokens [B,1], cache) -> (logits, cache)."""
    def serve_step(params: Params, tokens: torch.Tensor, cache: Params):
        return lm.decode_step(cfg, params, tokens, cache,
                              use_kernels=use_kernels, moe_mode=moe_mode)
    return serve_step


# ------------------------------------------------------- the sharded step
def _place(t, sh: shd.Sharding):
    """`t` as a DTensor on `sh`: moved there if it lies elsewhere, as the
    reference's `in_shardings` would."""
    if isinstance(t, DTensor):
        if tuple(t.placements) == sh.placements:
            return t
        return t.redistribute(sh.mesh, sh.placements)
    return distribute_tensor(t, sh.mesh, sh.placements)


def place_tree(tree, shardings):
    leaves, treedef = flatten(tree)
    shs, _ = flatten(shardings)
    return unflatten(treedef, [_place(t, s) for t, s in zip(leaves, shs)])


def jit_train_step(cfg: ModelConfig, par: ParallelConfig, mesh,
                   opt_cfg: adamw.AdamWConfig, params: Params,
                   opt_state: Params, shape: ShapeConfig,
                   use_kernels: bool = False, moe_mode: str = "capacity",
                   dtype=torch.bfloat16):
    """The sharded train step on `mesh` (a `DeviceMesh`) -> (step, p_sh,
    o_sh, b_sh), as the reference's `jit_train_step` returns it.

    `step(params, opt_state, batch)` runs `make_train_step`'s closure on
    DTensors: params and optimizer state on `p_sh` / `o_sh`, the batch on
    `b_sh` (a leaf that lies elsewhere, or a plain tensor holding the whole
    global value, is moved there first), with the mesh's axes registered for
    the model's `hints` and plain tensors inside the model taken as
    replicated. The state comes back in the same placements, updated in
    place; the metrics are plain tensors, the same on every rank."""
    p_sh = shd.params_shardings(cfg, par, mesh, params)
    o_sh = shd.opt_state_shardings(cfg, par, mesh, params)
    b_sh = shd.batch_shardings(cfg, par, mesh, shape)
    inner = make_train_step(cfg, par, opt_cfg, use_kernels, moe_mode, dtype)

    def step(params: Params, opt_state: Dict[str, Any],
             batch: Dict[str, torch.Tensor]):
        params = place_tree(params, p_sh)
        opt_state = place_tree(opt_state, o_sh)
        batch = {k: _place(v, b_sh.get(k, b_sh["tokens"]))
                 for k, v in batch.items()}
        before = (hints.get_mesh_axes(), hints.get_mesh())
        hints.set_mesh(mesh)
        try:
            with implicit_replication():
                params, opt_state, metrics = inner(params, opt_state, batch)
        finally:
            hints.set_mesh_axes(*before)
        metrics = {k: v.full_tensor() if isinstance(v, DTensor) else v
                   for k, v in metrics.items()}
        return params, opt_state, metrics

    return step, p_sh, o_sh, b_sh
