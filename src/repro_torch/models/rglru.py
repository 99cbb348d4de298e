"""RG-LRU recurrence (RecurrentGemma / Griffin, arXiv:2402.19427): a
real-gated linear recurrent unit behind a short causal conv. The counterpart
of `src/repro/models/rglru.py`, with its parameters, types and state.

    r_t = sigmoid(x_t W_r)                      (recurrence gate)
    i_t = sigmoid(x_t W_i)                      (input gate)
    a_t = a^(c * r_t)          a = sigmoid(Lambda), c = 8
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Prefill runs the recurrence as the same odd/even associative scan that
`jax.lax.associative_scan` runs (about 2 log2 S levels of strided
elementwise ops on [B, S, w]), so the fp32 sums are formed in the
reference's order; decode is one step. The reference computes all of this
outside any Pallas kernel, and so does the port: plain PyTorch. The
recurrence width carries the reference's sharding hint over "model" (the
identity without a mesh).

Types, as the reference keeps them: `lambda` is 1-D fp32, made bf16 under the
stacked `"scan"` leaves by `cast_params_for_compute` (softplus then runs in
bf16, as `jax.nn.softplus` does); the gates, the scan and the state `h` are
fp32; the conv runs in the stream's type and its state is kept in fp32.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.blocks import _dense_init
from repro_torch.runtime import hints

Params = Dict[str, Any]

_C = 8.0          # the paper's fixed temperature on the recurrence gate
_CONV_K = 4       # temporal conv width (Griffin block)


def init_rglru(cfg: ModelConfig, gen: torch.Generator, dtype=torch.float32,
               *, device) -> Params:
    d = cfg.d_model
    w = cfg.rnn_width or d
    # Lambda so that a = sigmoid(Lambda) lies in [0.9, 0.999] (paper init)
    u = 0.9 + 0.099 * torch.rand((w,), generator=gen, dtype=torch.float32,
                                 device=device)
    conv = torch.randn((_CONV_K, w), generator=gen, dtype=torch.float32,
                       device=device) / math.sqrt(_CONV_K)
    return {
        "w_x": _dense_init(gen, d, w, dtype, device),      # input projection
        "w_y": _dense_init(gen, d, w, dtype, device),      # gate branch
        "conv": conv.to(dtype),
        "w_r": _dense_init(gen, w, w, dtype, device),
        "w_i": _dense_init(gen, w, w, dtype, device),
        "lambda": torch.log(u / (1 - u)),
        "w_out": _dense_init(gen, w, d, dtype, device),
    }


def _gates(p: Params, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """a_t and the gated input, both fp32. x: [..., w]."""
    r = torch.sigmoid((x @ p["w_r"]).float())
    i = torch.sigmoid((x @ p["w_i"]).float())
    # softplus in lambda's own type; the product widens to fp32
    log_a = -_C * r * F.softplus(-p["lambda"])
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp_min(1.0 - a.square(), 1e-6)) * i * x.float()
    return a, gated


def _causal_conv(p: Params, x: torch.Tensor,
                 conv_state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv over time. x: [B, S, w] -> (out, last K-1
    inputs)."""
    w = p["conv"]                                     # [K, w]
    if conv_state is None:
        conv_state = x.new_zeros(x.shape[:1] + (_CONV_K - 1, x.shape[-1]))
    xp = torch.cat([conv_state, x], dim=1)            # [B, S+K-1, w]
    S = x.shape[1]
    # summed in the reference's order, from the first tap
    out = sum(xp[:, k:k + S] * w[k] for k in range(_CONV_K))
    return out, xp[:, -(_CONV_K - 1):]


def _combine(c1: List[torch.Tensor],
             c2: List[torch.Tensor]) -> List[torch.Tensor]:
    """(a1, b1) then (a2, b2): h -> a2 (a1 h + b1) + b2."""
    a1, b1 = c1
    a2, b2 = c2
    return [a1 * a2, b1 * a2 + b2]


def _associative_scan(elems: List[torch.Tensor]) -> List[torch.Tensor]:
    """Inclusive scan of `_combine` along dim 1, by the odd/even recursion of
    `jax.lax.associative_scan`: combine adjacent pairs, scan the pairs, then
    fill in the even places from the odd ones."""
    n = elems[0].shape[1]
    if n < 2:
        return elems
    odd = _associative_scan(_combine([e[:, 0:-1:2] for e in elems],
                                     [e[:, 1::2] for e in elems]))
    if n % 2 == 0:
        even = _combine([e[:, :-1] for e in odd], [e[:, 2::2] for e in elems])
    else:
        even = _combine(odd, [e[:, 2::2] for e in elems])
    out = []
    for e, ev, od in zip(elems, even, odd):
        r = e.new_empty(e.shape)
        r[:, 0] = e[:, 0]
        r[:, 2::2] = ev
        r[:, 1::2] = od
        out.append(r)
    return out


def rglru_scan(p: Params, x: torch.Tensor,
               h0: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The whole sequence's recurrence. x: [B, S, w] (after the conv).
    Returns (h [B, S, w] fp32, h_last [B, w])."""
    a, gated = _gates(p, x)                           # [B, S, w] fp32
    if h0 is not None:
        gated[:, 0] += a[:, 0] * h0
    _, h = _associative_scan([a, gated])
    return h, h[:, -1]


def rglru_step(p: Params, x_t: torch.Tensor,
               h_prev: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step. x_t: [B, w] (after the conv), h_prev: [B, w] fp32."""
    a, gated = _gates(p, x_t)
    h = a * h_prev + gated
    return h, h


def init_rglru_state(cfg: ModelConfig, batch: int, *,
                     device) -> Dict[str, torch.Tensor]:
    w = cfg.rnn_width or cfg.d_model
    return {"h": torch.zeros((batch, w), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, _CONV_K - 1, w), dtype=torch.float32,
                                device=device)}


def apply_rglru(cfg: ModelConfig, p: Params, x: torch.Tensor,
                state: Optional[Dict[str, torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Griffin recurrent block. x: [B, S, d] -> [B, S, d].

    state None -> the stateless full-sequence scan (no state out); state
    given -> stateful (a prefill chunk, or S == 1 decode), returning the new
    state as new tensors (the caller copies them where it keeps its cache).
    """
    S = x.shape[1]
    u = x @ p["w_x"]                                  # [B, S, w]
    gate = F.gelu(x @ p["w_y"], approximate="tanh")
    dp = hints.batch_spec_axes()
    u = hints.constrain(u, dp, None, "model")       # recurrence width-sharded
    gate = hints.constrain(gate, dp, None, "model")
    if state is None:
        conv_in, _ = _causal_conv(p, u, None)
        h, _ = rglru_scan(p, conv_in)
        return (h.to(x.dtype) * gate) @ p["w_out"], None
    conv_in, new_conv = _causal_conv(p, u, state["conv"].to(u.dtype))
    if S == 1:
        h_t, h_new = rglru_step(p, conv_in[:, 0], state["h"])
        h = h_t[:, None]
    else:
        h, h_new = rglru_scan(p, conv_in, h0=state["h"])
    out = (h.to(x.dtype) * gate) @ p["w_out"]
    return out, {"h": h_new, "conv": new_conv.float()}
