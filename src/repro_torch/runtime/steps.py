"""Step builders: the train step, prefill and one decode step as closures,
shared by the train loop and the serving loop.

The counterpart of `src/repro/runtime/steps.py`, without `jit_train_step`
(shardings and donation: the parallel layer). PyTorch runs eagerly, so the
closures are plain functions; the train step updates the params and the
optimizer state IN PLACE (see `optim.adamw.apply_updates`), as the
reference's donation lets XLA do.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.convert import flatten, unflatten
from repro_torch.models import lm
from repro_torch.optim import adamw

Params = Any


def make_train_step(cfg: ModelConfig, par: ParallelConfig,
                    opt_cfg: adamw.AdamWConfig,
                    use_kernels: bool = False,
                    moe_mode: str = "capacity",
                    dtype=torch.bfloat16) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, metrics).

    `dtype` is the compute type of `lm.train_loss` (the reference's step
    always takes its default, bfloat16); the params stay float32 masters.

    par.microbatches > 1 -> gradient accumulation: the batch is split along
    its first dim and each part's gradient is added, in float32, into one
    accumulator, which is then divided by the count (the loss likewise), as
    the reference's scan does; `metrics` then has no `aux_loss`, as there.
    The gradients accumulate in the leaves' `.grad` of float32 aliases of the
    params (`torch.autograd.backward`), so a microbatch's gradient is added
    leaf by leaf as the backward reaches it: one float32 gradient tree is
    held, not two.
    """
    n_micro = max(par.microbatches, 1)

    def train_step(params: Params, opt_state: Dict[str, Any],
                   batch: Dict[str, torch.Tensor]):
        leaves, treedef = flatten(params)
        if any(t.dtype != torch.float32 for t in leaves):
            raise TypeError("make_train_step wants float32 master params")
        # aliases that share the params' storage and collect the gradients
        alias = [t.detach().requires_grad_(True) for t in leaves]
        p_alias = unflatten(treedef, alias)
        if n_micro == 1:
            loss, metrics = lm.train_loss(
                cfg, p_alias, batch, use_kernels=use_kernels,
                moe_mode=moe_mode, remat=par.remat, dtype=dtype)
            torch.autograd.backward(loss, inputs=alias)
            loss = loss.detach()
            metrics = {k: v.detach() for k, v in metrics.items()}
        else:
            micro = {k: v.reshape((n_micro, v.shape[0] // n_micro)
                                  + tuple(v.shape[1:]))
                     for k, v in batch.items()}
            lsum = torch.zeros((), dtype=torch.float32,
                               device=leaves[0].device)
            for i in range(n_micro):
                loss, _ = lm.train_loss(
                    cfg, p_alias, {k: v[i] for k, v in micro.items()},
                    use_kernels=use_kernels, moe_mode=moe_mode,
                    remat=par.remat, dtype=dtype)
                torch.autograd.backward(loss, inputs=alias)
                lsum = lsum + loss.detach()
            for a in alias:
                if a.grad is not None:
                    a.grad.div_(n_micro)
            loss = lsum / n_micro
            metrics = {}
        # a leaf the loss does not reach has a zero gradient, as in JAX
        grads = unflatten(treedef, [a.grad if a.grad is not None
                                    else torch.zeros_like(a) for a in alias])
        del p_alias, alias
        params, opt_state, opt_metrics = adamw.apply_updates(
            opt_cfg, params, grads, opt_state)
        metrics = {"loss": loss, **metrics, **opt_metrics}
        return params, opt_state, metrics

    return train_step


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
