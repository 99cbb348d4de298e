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

`apply_moe_sharded` (`MOE_CONFIG["sharded"]`, expert parallelism over the
"model" axis of the registered mesh) dispatches each rank's local tokens to
its local experts at a local capacity and joins the partial outputs, the
shared expert's included, in one all-reduce over "model". With no mesh, a
"model" axis of 1, or E not a multiple of it, it runs `apply_moe_capacity`,
as the reference's does. `apply_moe_capacity` on a DTensor keeps its global
capacity and runs each "model" shard's experts on local tensors
(`_capacity_sharded`). The plain, global-capacity and expert-parallel
paths run one dispatch body, `_local_experts`, on a range of the experts:
all of them on the plain path.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.configs.base import ModelConfig
from repro_torch.models.blocks import _dense_init
from repro_torch.runtime import hints

Params = Dict[str, Any]

# Execution knobs (perf iterations mutate these)
MOE_CONFIG = {"sharded": 0}   # 1 -> local-capacity expert-parallel dispatch


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


def dispatch(cfg: ModelConfig, experts: torch.Tensor, e0: int = 0,
             n: Optional[int] = None
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]:
    """Where each (token, expert) pair goes. experts: [T, k] ->
    (flat_tok [T*k], slot [T*k] in [0, n*C], keep [T*k] bool, C). Queues
    are those of experts e0 .. e0+n-1 (all E by default), expert e0 + i's
    first slot being i*C; a pair to another expert is not kept. Pairs are
    token-major; a pair's place in its expert's queue is the inclusive count
    of earlier pairs to that expert minus 1, and a pair at C or later is
    dropped to the pad slot n*C."""
    T, k = experts.shape
    E, C = n or cfg.moe.num_experts, capacity(cfg, T)
    flat_e, mine = experts.reshape(-1), None
    if E != cfg.moe.num_experts:
        flat_e = flat_e - e0
        mine = (flat_e >= 0) & (flat_e < E)
        flat_e = torch.where(mine, flat_e, E)    # E: no queue, a zero row
    flat_tok = torch.arange(T, device=experts.device).repeat_interleave(k)
    one_hot = _one_hot(flat_e, E).int()                            # [T*k, E]
    mypos = (torch.cumsum(one_hot, dim=0) - 1).gather(
        1, (flat_e if mine is None else flat_e.clamp_max(E - 1))[:, None]
    )[:, 0]
    keep = mypos < C
    if mine is not None:
        keep = keep & mine
    slot = torch.where(keep, flat_e * C + mypos,
                       torch.full_like(flat_e, E * C))
    return flat_tok, slot, keep, C


def apply_moe_capacity(cfg: ModelConfig, p: Params, x: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Capacity-bounded gathered path. x: [B, S, d] -> ([B, S, d], aux)."""
    m = cfg.moe
    if isinstance(x, DTensor) and m.num_experts % hints.axis_size(
            "model") == 0:
        return _capacity_sharded(cfg, p, x)
    return _local_experts(cfg, x, p["router"], p["w_gate"], p["w_up"],
                          p["w_down"], p.get("shared"), 0, m.num_experts)


def apply_moe(cfg: ModelConfig, p: Params, x: torch.Tensor,
              mode: str = "dense") -> Tuple[torch.Tensor, torch.Tensor]:
    if mode == "capacity":
        if MOE_CONFIG.get("sharded"):
            return apply_moe_sharded(cfg, p, x)
        return apply_moe_capacity(cfg, p, x)
    return apply_moe_dense(cfg, p, x)


class _ScaleGrad(torch.autograd.Function):
    """Identity forward; the backward scales the gradient by `s`."""

    @staticmethod
    def forward(ctx, x, s):
        ctx.s = s
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.s, None


def _local(t, mesh, placements, grad_placements):
    """The local shard of `t` at `placements` (a plain tensor is the whole
    value on every rank); its gradient goes back as `grad_placements`."""
    if not isinstance(t, DTensor):
        t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    return t.redistribute(mesh, placements).to_local(
        grad_placements=grad_placements)


def _local_experts(cfg: ModelConfig, xl, router, wg, wu, wd, shared,
                   e0: int, E_local: int):
    """The capacity path on one rank's tokens xl [Bl, Sl, d]: routed over
    all experts, dispatched to experts e0 .. e0+E_local-1 (weights `wg`,
    `wu`, `wd` theirs) at the capacity of its token count -> (its output,
    partial unless E_local is every expert, [Bl, Sl, d]; its aux loss)."""
    m = cfg.moe
    Bl, Sl, d = xl.shape
    Tl, k = Bl * Sl, m.top_k
    xt = xl.reshape(Tl, d)
    weights, experts, aux = route(cfg, {"router": router}, xt)
    flat_tok, slot, keep, C = dispatch(cfg, experts, e0, E_local)
    # only the pad row E_local*C is written more than once, and it is
    # discarded
    buf = xt.new_zeros((E_local * C + 1, d))
    buf[slot] = xt[flat_tok]
    grouped = buf[:E_local * C].reshape(E_local, C, d)
    gate = torch.einsum("ecd,edf->ecf", grouped, wg)
    up = torch.einsum("ecd,edf->ecf", grouped, wu)
    eout = torch.einsum("ecf,efd->ecd", F.silu(gate) * up,
                        wd).reshape(E_local * C, d)
    eout = torch.cat([eout, eout.new_zeros((1, d))])
    tok_out = eout[slot] * (weights.reshape(-1) * keep)[:, None]   # [T*k, d]
    # a token's k outputs added in pair order, rounded to x's type at each
    # add, as a sequential scatter-add from zeros applies them
    tok_out = tok_out.reshape(Tl, k, d)
    out = tok_out[:, 0]
    for j in range(1, k):
        out = out + tok_out[:, j]
    if shared is not None:
        # sharded, the shared expert's hidden dim is split over "model", so
        # its partial joins the expert partials in ONE all-reduce
        out = out + _shared({"shared": shared}, xt)
    return out.reshape(Bl, Sl, d), aux


def _capacity_sharded(cfg: ModelConfig, p: Params, x: DTensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`apply_moe_capacity` on a DTensor, with its GLOBAL capacity: every
    rank gathers all the tokens (the capacity counts them all), routes them,
    and runs the queues of its own "model" shard's experts; the partial
    outputs are summed over "model" and each data rank keeps its tokens.
    The dispatch's indexing then runs on local tensors (DTensor has no rule
    for it on some versions). The token's outputs are summed over the
    ranks, not in pair order: equal to `apply_moe_capacity` up to
    rounding. The aux loss, of all tokens, is the same on every rank; its
    gradient is scaled by 1 / (the "model" size), over which the router's
    gradient is summed."""
    mesh = x.device_mesh
    names = tuple(mesh.mesh_dim_names)
    msize = hints.axis_size("model")
    E_local = cfg.moe.num_experts // msize
    B, S, d = x.shape

    def pl(**by_axis):
        return [by_axis.get(n, Replicate()) for n in names]

    xl = _local(x, mesh, pl(), pl(model=Partial()))
    router = _local(p["router"], mesh, pl(), pl(model=Partial()))
    experts = [_local(p[n], mesh, pl(model=Shard(0)), pl(model=Shard(0)))
               for n in ("w_gate", "w_up", "w_down")]
    shared = None
    if cfg.moe.num_shared_experts:
        sp = p["shared"]
        shared = {n: _local(sp[n], mesh, pl(model=Shard(dim)),
                            pl(model=Shard(dim)))
                  for n, dim in (("w_gate", 1), ("w_up", 1), ("w_down", 0))}
    e0 = (mesh.get_local_rank(names.index("model")) * E_local
          if "model" in names else 0)
    out_l, aux_l = _local_experts(cfg, xl, router, *experts, shared, e0,
                                  E_local)
    out = DTensor.from_local(out_l, mesh, pl(model=Partial()),
                             run_check=False)
    out = out.redistribute(mesh, x.placements)
    aux = DTensor.from_local(_ScaleGrad.apply(aux_l, 1.0 / msize), mesh,
                             pl(), run_check=False)
    return out, aux


def apply_moe_sharded(cfg: ModelConfig, p: Params, x: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel dispatch with LOCAL capacity on the registered mesh.

    Tokens are batch-sharded over the data axes and replicated over "model";
    experts are sharded over "model". Each rank routes its local tokens,
    dispatches only to its local expert group at a local capacity bound
    (buffers scale with tokens per rank, not global tokens), runs the expert
    FFNs, and the partial outputs are summed over "model" — one all-reduce
    per layer. -> (out, a DTensor on the mesh; aux).

    `aux` is each rank's own load-balancing loss over its local tokens,
    declared replicated without a check, as the reference's `shard_map`
    (out_specs P(), check_vma=False) declares it: rank 0 holds the value the
    reference reads. Its gradient is scaled by 1 / (world size) and the
    weights' gradients are summed over the ranks that share them, as the
    reference's transpose of an unmapped output does.
    """
    mesh = hints.get_mesh()
    m = cfg.moe
    E = m.num_experts
    msize = hints.axis_size("model")
    if mesh is None or msize <= 1 or E % msize != 0:
        return apply_moe_capacity(cfg, p, x)
    names = tuple(mesh.mesh_dim_names)
    dp = hints.batch_spec_axes()
    E_local = E // msize
    mi = names.index("model")

    def pl(**by_axis):
        """Placements: `by_axis[name]` on that mesh dim, else Replicate."""
        return [by_axis.get(n, Replicate()) for n in names]

    on_dp = {a: Shard(0) for a in dp if a in names}
    part_dp = {a: Partial() for a in dp if a in names}
    xl = _local(x, mesh, pl(**on_dp), pl(**on_dp, model=Partial()))
    router = _local(p["router"], mesh, pl(), [Partial()] * len(names))
    experts = [_local(p[n], mesh, pl(model=Shard(0)),
                      pl(**part_dp, model=Shard(0)))
               for n in ("w_gate", "w_up", "w_down")]
    shared = None
    if m.num_shared_experts:
        sp = p["shared"]
        shared = {n: _local(sp[n], mesh, pl(model=Shard(dim)),
                            pl(**part_dp, model=Shard(dim)))
                  for n, dim in (("w_gate", 1), ("w_up", 1), ("w_down", 0))}
    e0 = mesh.get_local_rank(mi) * E_local
    out_l, aux_l = _local_experts(cfg, xl, router, *experts, shared, e0,
                                  E_local)
    out = DTensor.from_local(out_l, mesh, pl(**on_dp, model=Partial()),
                             run_check=False)
    out = out.redistribute(mesh, pl(**on_dp))
    aux = DTensor.from_local(_ScaleGrad.apply(aux_l, 1.0 / mesh.size()),
                             mesh, pl(), run_check=False)
    return out, aux
