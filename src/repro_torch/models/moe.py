"""Mixture-of-Experts FFN (kimi-k2: 384 experts top-8 + 1 shared; granite:
32 experts top-8).

The counterpart of `src/repro/models/moe.py`, with its parameter tree:
`router` [d, E] (fp32 at init), `w_gate` / `w_up` [E, d, ff], `w_down`
[E, ff, d], and a dense `shared` expert where the config has one. Two paths:

* `apply_moe_dense`: every token through every expert's weights, weighted
  by a [T, E] combine matrix that is zero off its top-k;
* `apply_moe_capacity`: tokens sorted into per-expert queues of capacity
  C = ceil(T * k / E * capacity_factor); a pair past its expert's C is
  dropped (Switch-style), as in the reference. At decode (T = batch) C is
  small, so pairs are dropped there too, by design.

The expert products are plain `torch.einsum`s, as they are plain products
outside any Pallas kernel in the reference. A token's k expert outputs are
summed in order j = 0, 1, ... in the working type, the order in which the
reference's sequential scatter-add applies them; an atomic `index_add_`
would sum them in a different order on every run, and `serve` requires the
same tokens with and without offload.

`apply_moe_sharded` (expert parallelism over a mesh) waits for the parallel
layer (ROADMAP A9); without a mesh the reference's `mode="capacity"` runs
`apply_moe_capacity`, and so does this one.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.blocks import _dense_init

Params = Dict[str, Any]


def init_moe(cfg: ModelConfig, gen: torch.Generator, dtype=torch.float32, *,
             device) -> Params:
    m = cfg.moe
    assert m is not None
    d, ff, E = cfg.d_model, m.d_ff_expert, m.num_experts

    def normal(shape, scale):
        w = torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=device)
        return (w * scale).to(dtype)

    p = {"router": _dense_init(gen, d, E, torch.float32, device),
         "w_gate": normal((E, d, ff), 1.0 / math.sqrt(d)),
         "w_up": normal((E, d, ff), 1.0 / math.sqrt(d)),
         "w_down": normal((E, ff, d), 1.0 / math.sqrt(ff))}
    if m.num_shared_experts:
        ffs = ff * m.num_shared_experts
        p["shared"] = {"w_gate": _dense_init(gen, d, ffs, dtype, device),
                       "w_up": _dense_init(gen, d, ffs, dtype, device),
                       "w_down": _dense_init(gen, ffs, d, dtype, device)}
    return p


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """idx [...] -> bool [..., n]. `F.one_hot` checks its input's range with
    a synchronise on the card, once a layer on every decode step."""
    return idx[..., None] == torch.arange(n, device=idx.device)


def route(cfg: ModelConfig, p: Params, x: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k routing. x: [T, d] -> (weights [T, k] in x's type, experts
    [T, k], aux loss in fp32). The router may arrive cast to bf16; the
    reference's fp32 x times it is an fp32 product, so it is widened."""
    m = cfg.moe
    logits = x.float() @ p["router"].float()                      # [T, E]
    probs = torch.softmax(logits, dim=-1)
    weights, experts = torch.topk(probs, m.top_k, dim=-1, sorted=True)
    weights = weights / weights.sum(dim=-1, keepdim=True)
    # aux loss: E * sum_e (fraction of pairs to e) * (mean router prob to e)
    T = x.shape[0]
    frac = _one_hot(experts, m.num_experts).sum(dim=(0, 1)).float() / (
        T * m.top_k)
    aux = m.num_experts * torch.sum(frac * probs.mean(dim=0))
    return weights.to(x.dtype), experts, aux


def _shared(p: Params, xt: torch.Tensor) -> torch.Tensor:
    sp = p["shared"]
    return (F.silu(xt @ sp["w_gate"]) * (xt @ sp["w_up"])) @ sp["w_down"]


def apply_moe_dense(cfg: ModelConfig, p: Params, x: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense dispatch. x: [B, S, d] -> ([B, S, d], aux loss)."""
    m = cfg.moe
    B, S, d = x.shape
    xt = x.reshape(B * S, d)
    weights, experts, aux = route(cfg, p, xt)
    one_hot = _one_hot(experts, m.num_experts).to(x.dtype)        # [T, k, E]
    combine = torch.einsum("tk,tke->te", weights, one_hot)         # [T, E]
    gate = torch.einsum("td,edf->tef", xt, p["w_gate"])
    up = torch.einsum("td,edf->tef", xt, p["w_up"])
    act = F.silu(gate) * up * combine[..., None]                   # [T, E, ff]
    out = torch.einsum("tef,efd->td", act, p["w_down"])
    if m.num_shared_experts:
        out = out + _shared(p, xt)
    return out.reshape(B, S, d), aux


def capacity(cfg: ModelConfig, T: int) -> int:
    """Slots an expert's queue has for T tokens: the reference's expression,
    evaluated in the same order."""
    m = cfg.moe
    return max(1, int(math.ceil(T * m.top_k / m.num_experts
                                * m.capacity_factor)))


def dispatch(cfg: ModelConfig, experts: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]:
    """Where each (token, expert) pair goes. experts: [T, k] ->
    (flat_tok [T*k], slot [T*k] in [0, E*C], keep [T*k] bool, C). Pairs are
    token-major; a pair's place in its expert's queue is the inclusive count
    of earlier pairs to that expert minus 1, and a pair at C or later is
    dropped to the pad slot E*C."""
    T, k = experts.shape
    E, C = cfg.moe.num_experts, capacity(cfg, T)
    flat_e = experts.reshape(-1)
    flat_tok = torch.arange(T, device=experts.device).repeat_interleave(k)
    one_hot = _one_hot(flat_e, E).int()                            # [T*k, E]
    mypos = (torch.cumsum(one_hot, dim=0) - 1).gather(
        1, flat_e[:, None])[:, 0]
    keep = mypos < C
    slot = torch.where(keep, flat_e * C + mypos,
                       torch.full_like(flat_e, E * C))
    return flat_tok, slot, keep, C


def apply_moe_capacity(cfg: ModelConfig, p: Params, x: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Capacity-bounded gathered path. x: [B, S, d] -> ([B, S, d], aux)."""
    m = cfg.moe
    B, S, d = x.shape
    T, E, k = B * S, m.num_experts, m.top_k
    xt = x.reshape(T, d)
    weights, experts, aux = route(cfg, p, xt)
    flat_tok, slot, keep, C = dispatch(cfg, experts)
    # only the pad row E*C is written more than once, and it is discarded
    buf = torch.zeros((E * C + 1, d), dtype=x.dtype, device=x.device)
    buf[slot] = xt[flat_tok]
    grouped = buf[:E * C].reshape(E, C, d)
    gate = torch.einsum("ecd,edf->ecf", grouped, p["w_gate"])
    up = torch.einsum("ecd,edf->ecf", grouped, p["w_up"])
    eout = torch.einsum("ecf,efd->ecd", F.silu(gate) * up,
                        p["w_down"]).reshape(E * C, d)
    eout = torch.cat([eout, eout.new_zeros((1, d))])
    tok_out = eout[slot] * (weights.reshape(-1) * keep)[:, None]   # [T*k, d]
    # a token's k outputs added in pair order, rounded to x's type at each
    # add, as a sequential scatter-add from zeros applies them
    tok_out = tok_out.reshape(T, k, d)
    out = tok_out[:, 0]
    for j in range(1, k):
        out = out + tok_out[:, j]
    if m.num_shared_experts:
        out = out + _shared(p, xt)
    return out.reshape(B, S, d), aux


def apply_moe(cfg: ModelConfig, p: Params, x: torch.Tensor,
              mode: str = "dense") -> Tuple[torch.Tensor, torch.Tensor]:
    if mode == "capacity":
        return apply_moe_capacity(cfg, p, x)
    return apply_moe_dense(cfg, p, x)
