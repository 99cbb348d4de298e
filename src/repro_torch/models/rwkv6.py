"""RWKV-6 "Finch" token mixing (arXiv:2404.05892): an attention-free
recurrence with data-dependent decay. The counterpart of
`src/repro/models/rwkv6.py`, with its parameters, types and knobs.

Per head (head size N = cfg.resolved_head_dim), with per-token receptance r,
key k, value v, decay w_t in (0, 1) and bonus u:

    S_t = diag(w_t) S_{t-1} + k_t^T v_t            (state: [N, N])
    o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)

`rwkv6_chunk` is the per-token recurrence (the reference's `lax.scan`, here
a loop over time); `rwkv6_chunk_parallel` the same math as two products a
chunk with the state carried between chunks. Decode is one step of the
first. Token shift (lerp of x_{t-1} and x_t) keeps the last token in the
state. As in the reference, the low-rank decay/mix projections are full-rank
and the gate is silu.

Types, as the reference keeps them: `decay_base` and `bonus` are 1-D and
stay fp32 (under the stacked `"scan"` leaves `cast_params_for_compute` makes
them bf16, as the reference's does); `tanh(lerp @ w_w)` is widened to fp32
before the decay; the mixer runs in fp32 unless `mixer_bf16` is set; the
state and `last_x` are fp32. The mixer's inputs carry the reference's
sharding hint: heads over "model" (the identity without a mesh).
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.configs.base import ModelConfig
from repro_torch.models.blocks import _dense_init
from repro_torch.runtime import hints

Params = Dict[str, Any]

# Execution knobs, the reference's: "scan" = per-token recurrence; "chunked"
# = chunk-parallel form, taken when S > 1 and a whole number of chunks.
RWKV_CONFIG = {"impl": "scan", "chunk": 64, "mixer_bf16": 0}


def init_rwkv6(cfg: ModelConfig, gen: torch.Generator, dtype=torch.float32,
               *, device) -> Params:
    d = cfg.d_model

    def uniform(shape, lo=0.0, hi=1.0):
        u = torch.rand(shape, generator=gen, dtype=torch.float32,
                       device=device)
        return lo + (hi - lo) * u

    w_w = torch.randn((d, d), generator=gen, dtype=torch.float32,
                      device=device) * 0.01 / math.sqrt(d)
    return {
        "w_r": _dense_init(gen, d, d, dtype, device),
        "w_k": _dense_init(gen, d, d, dtype, device),
        "w_v": _dense_init(gen, d, d, dtype, device),
        "w_g": _dense_init(gen, d, d, dtype, device),
        "w_w": w_w.to(dtype),                      # decay projection
        "w_o": _dense_init(gen, d, d, dtype, device),
        "mix": uniform((5, d)).to(dtype),
        "decay_base": uniform((d,), -8.0, -4.0),
        "bonus": torch.zeros((d,), dtype=torch.float32, device=device),
    }


def _token_shift(x: torch.Tensor,
                 last: Optional[torch.Tensor]) -> torch.Tensor:
    """x_{t-1} stream; `last` is the final token of the previous chunk."""
    if last is None:
        last = torch.zeros_like(x[:, :1])
    return torch.cat([last, x[:, :-1]], dim=1)


def _project(cfg: ModelConfig, p: Params, x: torch.Tensor,
             x_prev: torch.Tensor):
    """r, k, v, gate, decay for a chunk. x: [B, S, d]."""
    mix = p["mix"]

    def lerp(i):
        return x + (x_prev - x) * mix[i]
    r = lerp(0) @ p["w_r"]
    k = lerp(1) @ p["w_k"]
    v = lerp(2) @ p["w_v"]
    g = F.silu(lerp(3) @ p["w_g"])
    # data-dependent decay (Finch): w_t = exp(-exp(base + f(x)))
    wlog = p["decay_base"] + torch.tanh(lerp(4) @ p["w_w"]).float()
    w = torch.exp(-torch.exp(wlog))                       # in (0, 1)
    return r, k, v, g, w


def _heads(cfg: ModelConfig, t: torch.Tensor) -> torch.Tensor:
    B, S, _ = t.shape
    return hints.reshape(hints.whole_groups(t, -1, cfg.num_heads),
                         (B, S, cfg.num_heads, cfg.resolved_head_dim))


def _einsum32(eq: str, *ts: torch.Tensor) -> torch.Tensor:
    """`einsum(..., preferred_element_type=float32)`: products of bf16 or
    fp32 values summed and returned in fp32 (bf16 widens exactly)."""
    return torch.einsum(eq, *(t.float() for t in ts))


def rwkv6_chunk_parallel(cfg: ModelConfig, p: Params, r, k, v, w,
                         state: torch.Tensor, chunk: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunk-parallel WKV6: within a chunk of C tokens the recurrence unrolls
    into an intra-chunk lower-triangular product and a carried-state term;
    the state advances once a chunk.

    r/k/v: [B, S, H, N] in the mixer type; w: [B, S, H, N] fp32 in (0, 1);
    state: [B, H, N, N] fp32. Returns (out [B, S, H, N] fp32, final state).
    """
    B, S, H, N = r.shape
    C = min(chunk, S)
    assert S % C == 0, (S, C)
    u = p["bonus"].reshape(H, N)
    tri = torch.tril(torch.ones((C, C), dtype=torch.bool, device=r.device),
                     diagonal=-1)
    s0, outs = state, []
    for c0 in range(0, S, C):
        rc, kc, vc, wc = (t[:, c0:c0 + C] for t in (r, k, v, w))
        rc, kc, vc = (t.float() if t.dtype != torch.bfloat16 else t
                      for t in (rc, kc, vc))
        cw = torch.cumprod(wc, dim=1)              # inclusive decay products
        cwe = cw / wc                              # exclusive (prod_{s<t})
        r_dec = (rc.float() * cwe).to(rc.dtype)
        # carried-state contribution
        o_state = _einsum32("bchn,bhnv->bchv", r_dec, s0.to(rc.dtype))
        # intra-chunk strictly-causal pair contributions
        k_scaled = (kc.float() / cw).to(kc.dtype)
        att = _einsum32("bchn,bshn->bhcs", r_dec, k_scaled)
        att = torch.where(tri[None, None], att, torch.zeros_like(att))
        o_intra = _einsum32("bhcs,bshv->bchv", att.to(vc.dtype), vc)
        # same-token bonus
        diag = _einsum32("bchn,bchn->bch", rc,
                         (u[None, None] * kc.float()).to(kc.dtype))
        outs.append(o_state + o_intra + diag[..., None] * vc)
        # state update: decay the carry, add this chunk's outer products
        decay_all = cw[:, -1]                      # [B, H, N]
        k_carry = (kc.float() * (decay_all[:, None] / cw)).to(kc.dtype)
        s0 = decay_all[..., None] * s0 + _einsum32("bshn,bshv->bhnv",
                                                   k_carry, vc)
    return torch.cat(outs, dim=1), s0


def rwkv6_chunk(cfg: ModelConfig, p: Params, r, k, v, w,
                state: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The per-token recurrence. r/k/v/w: [B, S, H, N] (w fp32); state:
    [B, H, N, N] fp32. Returns (out [B, S, H, N], new state)."""
    u = p["bonus"].reshape(r.shape[2], r.shape[3])
    s, outs = state, []
    for t in range(r.shape[1]):
        r_t, k_t, v_t, w_t = r[:, t], k[:, t], v[:, t], w[:, t]  # [B, H, N]
        kv = torch.einsum("bhk,bhv->bhkv", k_t, v_t)             # [B,H,N,N]
        m = s + u[None, :, :, None] * kv                         # fp32
        outs.append(torch.einsum("bhk,bhkv->bhv", r_t.to(m.dtype), m))
        s = w_t[..., None] * s + kv
    return torch.stack(outs, dim=1), s


def _mix_sharded(cfg: ModelConfig, p: Params, mixer, r, k, v, w, state):
    """`mixer` on DTensors, each rank on its own (batch, head) block: the
    recurrence never mixes heads or sequences, so r / k / v / w keep their
    layout (batch over the data axes, heads over "model"), the state and
    the bonus follow it, and no collective runs inside the scan (DTensor
    has no sharding rule for some of its ops on some versions)."""
    mesh, pl = r.device_mesh, tuple(r.placements)
    spl = tuple(Shard(1) if x.is_shard(2) else x for x in pl)
    shape, off = hints.local_box(r)
    h0, hl = off[2], shape[2]
    if isinstance(state, DTensor):
        s_local = state.redistribute(mesh, spl).to_local()
    else:                                # a fresh zero state, made locally
        s_local = state.new_zeros((shape[0], hl) + tuple(state.shape[2:]))
    bonus = p["bonus"]
    if isinstance(bonus, DTensor):
        # every rank uses its heads' slice: the gradient is a partial sum
        bonus = bonus.redistribute(mesh, [Replicate()] * mesh.ndim).to_local(
            grad_placements=[Partial()] * mesh.ndim)
    bonus = bonus.reshape(cfg.num_heads, -1)[h0:h0 + hl].reshape(-1)
    out, s_new = mixer(cfg, {"bonus": bonus}, *(t.to_local()
                                                 for t in (r, k, v, w)),
                       s_local)
    return (DTensor.from_local(out, mesh, pl),
            DTensor.from_local(s_new, mesh, spl))


def init_rwkv6_state(cfg: ModelConfig, batch: int, *,
                     device) -> Dict[str, torch.Tensor]:
    H, N = cfg.num_heads, cfg.resolved_head_dim
    return {"s": torch.zeros((batch, H, N, N), dtype=torch.float32,
                             device=device),
            "last_x": torch.zeros((batch, 1, cfg.d_model),
                                  dtype=torch.float32, device=device)}


def apply_rwkv6(cfg: ModelConfig, p: Params, x: torch.Tensor,
                state: Optional[Dict[str, torch.Tensor]] = None,
                chunk: int = 256
                ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """RWKV-6 block. x: [B, S, d] -> ([B, S, d], new state or None). The
    new state is made of new tensors; `state` is not written (the model
    layer copies the new state into its cache). `chunk` is unused, as in the
    reference; `RWKV_CONFIG["chunk"]` sets the chunk-parallel form's."""
    B, S, d = x.shape
    H, N = cfg.num_heads, cfg.resolved_head_dim
    s0 = (state["s"] if state is not None
          else torch.zeros((B, H, N, N), dtype=torch.float32,
                           device=x.device))
    last = state["last_x"].to(x.dtype) if state is not None else None
    x_prev = _token_shift(x, last)
    r, k, v, g, w = _project(cfg, p, x, x_prev)
    mix_dtype = (torch.bfloat16 if RWKV_CONFIG.get("mixer_bf16")
                 else torch.float32)
    # mixer runs head-sharded over the "model" axis (64 heads / 16-way TP)
    dp = hints.batch_spec_axes()
    rh, kh, vh = (hints.constrain(_heads(cfg, t), dp, None, "model",
                                  None).to(mix_dtype) for t in (r, k, v))
    wh = hints.constrain(_heads(cfg, w.float()), dp, None, "model", None)
    if (RWKV_CONFIG["impl"] == "chunked" and S > 1
            and S % min(RWKV_CONFIG["chunk"], S) == 0):
        mixer = functools.partial(rwkv6_chunk_parallel,
                                  chunk=RWKV_CONFIG["chunk"])
    else:
        mixer = rwkv6_chunk
    if isinstance(rh, DTensor):
        out, s_new = _mix_sharded(cfg, p, mixer, rh, kh, vh, wh, s0)
    else:
        out, s_new = mixer(cfg, p, rh, kh, vh, wh, s0)
    out = hints.reshape(out.to(x.dtype), (B, S, d))
    out = (out * g) @ p["w_o"]
    new_state = None
    if state is not None:
        new_state = {"s": s_new, "last_x": x[:, -1:].float()}
    return out, new_state
