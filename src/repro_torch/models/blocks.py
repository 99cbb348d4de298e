"""Transformer building blocks: norms, RoPE/M-RoPE, GQA attention (also
sliding-window decode through a ring cache), GLU MLPs.

Plain functions on tensors, params as nested dicts with weights `[in, out]`
used as `x @ W`, as in the reference (`src/repro/models/blocks.py`), so a
reference pytree converts leaf by leaf. Attention dispatches to the CUDA
flash/paged kernels via `repro_torch.kernels.ops` when `use_kernels=True`,
else the plain path. Attention carries the reference's sharding hints
(`runtime.hints.constrain`: the identity without a mesh) and its `pad_heads`
branch, which pads each KV group's query heads to a multiple of the "model"
axis on a model-parallel mesh. As in the reference, only the plain branch
strips the padding again: with `pad_heads` on such a mesh, the flash branch
(`use_kernels`, S >= 128) and the chunked branch (S >= `chunk_threshold`)
reach the `wo` product with the padded head count and fail on its shape.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)

from repro_torch.configs.base import ModelConfig
from repro_torch.runtime import hints

Params = Dict[str, Any]


# --------------------------------------------------------------------- init
def _dense_init(gen: torch.Generator, in_dim: int, out_dim: int, dtype,
                device) -> torch.Tensor:
    scale = 1.0 / math.sqrt(in_dim)
    w = torch.randn((in_dim, out_dim), generator=gen, dtype=torch.float32,
                    device=device)
    return (w * scale).to(dtype)


# -------------------------------------------------------------------- norms
def init_norm(cfg: ModelConfig, dim: int, dtype=torch.float32, *,
              device) -> Params:
    p = {"scale": torch.ones((dim,), dtype=dtype, device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros((dim,), dtype=dtype, device=device)
    return p


def apply_norm(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    if cfg.norm == "layernorm":
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, unbiased=False)
        out = (xf - mu) * torch.rsqrt(var + cfg.norm_eps)
        out = out * p["scale"].float() + p["bias"].float()
    else:  # rmsnorm
        ms = xf.square().mean(dim=-1, keepdim=True)
        out = xf * torch.rsqrt(ms + cfg.norm_eps) * p["scale"].float()
    return out.to(x.dtype)


# --------------------------------------------------------------------- RoPE
def rope_frequencies(head_dim: int, theta: float, *,
                     device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


class RopeTables:
    """cos/sin of the rotary angles for one set of positions, in fp32, with
    the casts to the working types memoised. `forward_blocks` builds one per
    call and every layer's q and k share it: the same arithmetic as computing
    them in each `apply_rope`, some twenty small device ops fewer per layer.

    positions: [B, S] or [3, B, S] for M-RoPE (Qwen2-VL): the D/2 rotary
    frequencies are split into (temporal, height, width) sections, each
    rotated by its own position id. For text tokens the three position
    streams coincide and M-RoPE reduces to standard RoPE.
    """

    def __init__(self, positions: torch.Tensor, head_dim: int, theta: float,
                 mrope_sections: Tuple[int, ...] = ()):
        D, dev = head_dim, positions.device
        freqs = rope_frequencies(D, theta, device=dev)                 # [D/2]
        if mrope_sections and positions.dim() == 3:
            # section id per frequency -> which of the 3 streams to use
            stream = torch.repeat_interleave(
                torch.arange(len(mrope_sections), device=dev),
                torch.tensor(mrope_sections, device=dev),
                output_size=sum(mrope_sections))
            stream = F.pad(stream, (0, D // 2 - stream.numel()))
            pos = positions.float().movedim(0, -1)               # [B,S,3]
            angles = pos[..., stream] * freqs                    # [B,S,D/2]
        else:
            if positions.dim() == 3:
                positions = positions[0]
            angles = positions.float()[..., None] * freqs        # [B,S,D/2]
        self._fp32 = (torch.cos(angles)[..., None, :],           # [B,S,1,D/2]
                      torch.sin(angles)[..., None, :])
        self._cast = {torch.float32: self._fp32}

    def get(self, dtype) -> Tuple[torch.Tensor, torch.Tensor]:
        if dtype not in self._cast:
            self._cast[dtype] = tuple(t.to(dtype) for t in self._fp32)
        return self._cast[dtype]


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               mrope_sections: Tuple[int, ...] = (),
               tables: Optional[RopeTables] = None) -> torch.Tensor:
    """x: [B, S, H, D]; positions: [B, S] or [3, B, S] for M-RoPE. `tables`
    are the angles of these positions if the caller already has them."""
    D = x.shape[-1]
    if tables is None:
        tables = RopeTables(positions, D, theta, mrope_sections)
    # angles in fp32; cos/sin are cast to x.dtype before the multiply
    cos, sin = tables.get(x.dtype)
    x1, x2 = x[..., : D // 2], x[..., D // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


# ---------------------------------------------------------------- attention
def init_attention(cfg: ModelConfig, gen: torch.Generator,
                   dtype=torch.float32, *, device) -> Params:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    p = {
        "wq": _dense_init(gen, d, cfg.num_heads * hd, dtype, device),
        "wk": _dense_init(gen, d, cfg.num_kv_heads * hd, dtype, device),
        "wv": _dense_init(gen, d, cfg.num_kv_heads * hd, dtype, device),
        "wo": _dense_init(gen, cfg.num_heads * hd, d, dtype, device),
    }
    if cfg.qkv_bias:
        for name, n in (("bq", cfg.num_heads), ("bk", cfg.num_kv_heads),
                        ("bv", cfg.num_kv_heads)):
            p[name] = torch.zeros((n * hd,), dtype=dtype, device=device)
    return p


def _attn_mask(S: int, T: int, causal: bool, window: int, q_offset: int, *,
               device) -> torch.Tensor:
    """[S, T] boolean mask. T = total KV length; queries at q_offset..+S."""
    q_pos = torch.arange(S, device=device)[:, None] + q_offset
    k_pos = torch.arange(T, device=device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=device)
    if causal:
        mask &= k_pos <= q_pos
    if window:
        mask &= k_pos > q_pos - window
    return mask


# runtime-tunable attention execution knobs
ATTN_CONFIG = {
    "chunk_threshold": 8192,   # S >= threshold -> chunked (flash-style) path
    "q_chunk": 512,
    "kv_chunk": 1024,
    "pad_heads": 0,            # pad q heads per KV group to a mesh multiple
}


def _chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       causal: bool, window: int,
                       q_offset: int = 0) -> torch.Tensor:
    """Plain PyTorch flash attention: double loop over query/key chunks with
    running softmax stats — O(S) memory instead of O(S^2).

    q: [B, S, H, D] (grouped/repeated to q heads already), k/v same H.
    `q_offset`: the position of q's first row (a block of the queries).
    """
    B, S, H, D = q.shape
    T = k.shape[1]
    qc = min(ATTN_CONFIG["q_chunk"], S)
    kc = min(ATTN_CONFIG["kv_chunk"], T)
    nq, nk = S // qc, T // kc
    scale = 1.0 / math.sqrt(D)
    dev = q.device
    out = torch.empty_like(q)
    for qi in range(nq):
        q32 = q[:, qi * qc:(qi + 1) * qc].float()
        m = torch.full((B, H, qc), -1e30, dtype=torch.float32, device=dev)
        l = torch.zeros((B, H, qc), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, H, qc, D), dtype=torch.float32, device=dev)
        q_pos = q_offset + qi * qc + torch.arange(qc, device=dev)[:, None]
        for ki in range(nk):
            kb = k[:, ki * kc:(ki + 1) * kc].float()
            vb = v[:, ki * kc:(ki + 1) * kc].float()
            logits = torch.einsum("bqhd,bkhd->bhqk", q32, kb) * scale
            k_pos = ki * kc + torch.arange(kc, device=dev)[None, :]
            mask = torch.ones((qc, kc), dtype=torch.bool, device=dev)
            if causal:
                mask &= k_pos <= q_pos
            if window:
                mask &= k_pos > q_pos - window
            logits = logits.masked_fill(~mask[None, None], -1e30)
            m_new = torch.maximum(m, logits.amax(-1))        # [B,H,qc]
            alpha = torch.exp(m - m_new)
            pr = torch.exp(logits - m_new[..., None])
            l = l * alpha + pr.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", pr, vb)
            m = m_new
        blk = acc / l.clamp_min(1e-30)[..., None]            # [B,H,qc,D]
        out[:, qi * qc:(qi + 1) * qc] = blk.movedim(1, 2).to(q.dtype)
    return out


def attention(cfg: ModelConfig, p: Params, x: torch.Tensor,
              positions: torch.Tensor,
              kv_cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              cache_len: Optional[torch.Tensor] = None,
              window: int = 0,
              use_kernels: bool = False,
              return_kv: bool = False,
              rope: Optional[RopeTables] = None
              ) -> Tuple[torch.Tensor, Optional[Tuple]]:
    """GQA attention. x: [B, S, d].

    Training/prefill: kv_cache is None -> self attention over x.
    Decode: kv_cache = (k, v) with [B, T, Hkv, D]; x is the new token(s);
    `cache_len` [B] gives the valid prefix length. Returns (out, new_cache).
    `rope` holds the rotary tables of `positions` if the caller has them.

    Unlike the reference, whose arrays are immutable, the decode path writes
    the new K/V rows into `kv_cache` IN PLACE and returns the same tensors as
    `new_cache`: a caller that wants to keep the old cache clones it first.
    """
    B, S, d = x.shape
    hd = cfg.resolved_head_dim
    Hq, Hkv = cfg.num_heads, cfg.num_kv_heads
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = hints.reshape(hints.whole_groups(q, -1, Hq), (B, S, Hq, hd))
    k = hints.reshape(hints.whole_groups(k, -1, Hkv), (B, S, Hkv, hd))
    v = hints.reshape(hints.whole_groups(v, -1, Hkv), (B, S, Hkv, hd))
    if rope is None:
        rope = RopeTables(positions, hd, cfg.rope_theta, cfg.mrope_sections)
    q = apply_rope(q, positions, cfg.rope_theta, cfg.mrope_sections, rope)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.mrope_sections, rope)
    # sharding hints: shard heads over "model" when divisible, else fall
    # back to sharding the sequence (keeps 28/40-head configs from
    # replicating S x S logits on every chip)
    dp = hints.batch_spec_axes()
    msize = hints.axis_size("model")
    head_ok = msize > 1 and Hq % msize == 0
    kv_ok = msize > 1 and Hkv % msize == 0
    pad_per_group = 0
    if (ATTN_CONFIG["pad_heads"] and msize > 1 and not head_ok
            and kv_cache is None):
        # pad each KV group's query heads so total q heads divide the mesh:
        # zero heads cost (pad/group)/(group) extra attention FLOPs but keep
        # K/V replicated instead of sequence-gathered every layer.
        group = Hq // Hkv
        target_group = group
        while (target_group * Hkv) % msize != 0:
            target_group += 1
        pad_per_group = target_group - group
        if pad_per_group:
            qg = q.reshape(B, S, Hkv, group, hd)
            qg = F.pad(qg, (0, 0, 0, pad_per_group))
            q = qg.reshape(B, S, Hkv * target_group, hd)
            Hq = q.shape[2]
            head_ok = Hq % msize == 0
    if head_ok:
        q = hints.constrain(q, dp, None, "model", None)
        k = hints.constrain(k, dp, None, "model" if kv_ok else None, None)
        v = hints.constrain(v, dp, None, "model" if kv_ok else None, None)
    else:
        q = hints.constrain(q, dp, "model", None, None)
        k = hints.constrain(k, dp, None, None, None)
        v = hints.constrain(v, dp, None, None, None)

    new_cache = None
    if kv_cache is not None:
        ck, cv = kv_cache                              # [B, T, Hkv, D]
        T = ck.shape[1]
        # scatter the new tokens at cache_len (decode: S == 1 typically)
        idx = cache_len[:, None].long() + torch.arange(S, device=x.device)
        bidx = torch.arange(B, device=x.device)[:, None]
        hints.write_rows(ck, bidx, idx, k.to(ck.dtype))
        hints.write_rows(cv, bidx, idx, v.to(cv.dtype))
        new_cache = (ck, cv)
        if use_kernels and S == 1 and window == 0:
            from repro_torch.kernels import ops as kops
            out = kops.paged_attention(q[:, 0], ck, cv, cache_len + S)
            out = out[:, None]
            out = hints.reshape(out, (B, S, Hq * hd)) @ p["wo"]
            return out, new_cache
        k_all, v_all = ck, cv
        # valid-key mask (+ causal within the new tokens + window)
        k_pos = torch.arange(T, device=x.device)[None, None, :]  # [1,1,T]
        q_pos = idx[:, :, None]                                  # [B,S,1]
        mask = k_pos <= q_pos
        if window:
            mask &= k_pos > q_pos - window
        mask = mask[:, None]                                     # [B,1,S,T]
    else:
        k_all, v_all = k, v
        T = S
        if return_kv:
            new_cache = (k, v)
        if use_kernels and cfg.causal and S >= 128:
            from repro_torch.kernels import ops as kops
            out = kops.flash_attention(q, k, v, causal=True, window=window)
            return _merge_heads(out, B, S, Hq, hd, head_ok, dp) @ p["wo"], \
                new_cache
        if S >= ATTN_CONFIG["chunk_threshold"]:
            rep = Hq // Hkv
            k_all, v_all = _heads_like_q(
                torch.repeat_interleave(k, rep, dim=2),
                torch.repeat_interleave(v, rep, dim=2), head_ok, kv_ok, dp)
            if isinstance(q, DTensor):
                out = _on_local_blocks(q, k_all, v_all, lambda ql, kl, vl, o:
                                       _chunked_attention(ql, kl, vl,
                                                          cfg.causal, window,
                                                          q_offset=o))
            else:
                out = _chunked_attention(q, k_all, v_all, cfg.causal, window)
            return _merge_heads(out, B, S, Hq, hd, head_ok, dp) @ p["wo"], \
                new_cache
        mask = _attn_mask(S, T, cfg.causal, window, 0,
                          device=x.device)[None, None]

    # grouped heads: repeat kv
    rep = Hq // Hkv
    k_all, v_all = _heads_like_q(torch.repeat_interleave(k_all, rep, dim=2),
                                 torch.repeat_interleave(v_all, rep, dim=2),
                                 head_ok, kv_ok, dp)
    if isinstance(q, DTensor):
        out = _attend_sharded(q, k_all, v_all, mask, x.dtype)
    else:
        out = _attend(q, k_all, v_all, mask, x.dtype)
    if pad_per_group:
        group = Hq // Hkv
        out = out.reshape(B, S, Hkv, group, hd)[
            :, :, :, :group - pad_per_group]
        Hq = Hkv * (group - pad_per_group)
        out = out.reshape(B, S, Hq, hd)
    return _merge_heads(out, B, S, Hq, hd, head_ok, dp) @ p["wo"], new_cache


def _heads_like_q(k, v, head_ok: bool, kv_ok: bool, dp):
    """K / V repeated to the query heads, split over "model" as q's heads
    are (a local slice of replicated K / V), so both products see one
    layout."""
    if head_ok and not kv_ok:
        k = hints.constrain(k, dp, None, "model", None)
        v = hints.constrain(v, dp, None, "model", None)
    return k, v


def _merge_heads(out, B: int, S: int, Hq: int, hd: int, head_ok: bool, dp):
    """[B, S, Hq, hd] -> [B, S, Hq * hd] for the `wo` product. Queries split
    over the sequence (heads that do not divide "model") are gathered first:
    a product over a split sequence would merge two sharded dims, which
    DTensor refuses on some versions."""
    if not head_ok:
        out = hints.constrain(out, dp, None, None, None)
    return hints.reshape(out, (B, S, Hq * hd))


def _attend(q, k, v, mask, dtype, divide=False):
    """softmax(q k^T / sqrt(D), masked) v over grouped-out heads:
    q [B, S, H, D], k / v [B, T, H, D], mask [B or 1, 1, S, T]. The
    logits are scaled by 1 / sqrt(D), or divided by sqrt(D) with `divide`
    (the ring decode's form, as the reference writes each)."""
    # logits are formed in the working type and only then widened, as the
    # reference does; a cache of another type promotes like jnp.einsum
    qk_t = torch.promote_types(q.dtype, k.dtype)
    logits = torch.einsum("bshd,bthd->bhst", q.to(qk_t), k.to(qk_t))
    if divide:
        logits = logits / math.sqrt(q.shape[-1])
    else:
        logits = logits * (1.0 / math.sqrt(q.shape[-1]))
    logits = logits.float().masked_fill(~mask, -1e30)
    probs = torch.softmax(logits, dim=-1).to(dtype)
    pv_t = torch.promote_types(probs.dtype, v.dtype)
    return torch.einsum("bhst,bthd->bshd", probs.to(pv_t), v.to(pv_t))


def _on_local_blocks(q, k, v, core):
    """`core(q, k, v, q_offset)` on DTensors, each rank on its own (batch,
    head, query) block: q keeps its layout (batch over the data axes, heads
    or queries over "model"), K / V follow q's batch and head layout with
    every position (gathered where the cache splits them); `q_offset` is
    the position of the block's first query. The products then need no
    collective, and DTensor's einsums, which refuse two sharded dims merged
    into one batch dim on some versions, are not asked to."""
    mesh, qpl = q.device_mesh, tuple(q.placements)
    kpl = tuple(Replicate() if pl.is_shard(1) else pl for pl in qpl)
    # a query block's share of the K / V gradient is a partial sum over the
    # ranks that split the queries
    kgrad = tuple(Partial() if pl.is_shard(1) else pl for pl in qpl)
    kl, vl = (t.redistribute(mesh, kpl).to_local(grad_placements=kgrad)
              for t in (k, v))
    out = core(q.to_local(), kl, vl, hints.local_box(q)[1][1])
    return DTensor.from_local(out, mesh, qpl)


def _attend_sharded(q, k, v, mask, dtype, divide=False):
    """`_attend` on local blocks (`_on_local_blocks`), the mask following
    q's batch and query layout."""
    mesh, qpl = q.device_mesh, tuple(q.placements)
    mpl = tuple(Shard(2) if pl.is_shard(1) else
                Shard(0) if pl.is_shard(0) and mask.shape[0] > 1 else
                Replicate() for pl in qpl)
    if isinstance(mask, DTensor):
        mask = mask.redistribute(mesh, mpl).to_local()
    else:
        mask = distribute_tensor(mask, mesh, mpl,
                                 src_data_rank=None).to_local()
    return _on_local_blocks(q, k, v, lambda ql, kl, vl, _: _attend(
        ql, kl, vl, mask, dtype, divide))


def ring_attention_step(cfg: ModelConfig, p: Params, x: torch.Tensor,
                        positions: torch.Tensor, ck: torch.Tensor,
                        cv: torch.Tensor, cache_len: torch.Tensor,
                        rope: Optional[RopeTables] = None
                        ) -> Tuple[torch.Tensor, Tuple[torch.Tensor,
                                                       torch.Tensor]]:
    """Sliding-window decode with a ring-buffered KV cache.

    x: [B, 1, d]; ck/cv: [B, W, Hkv, D] hold the last W tokens' K/V (already
    roped at their absolute positions); cache_len: [B] tokens seen so far.
    The new token's row goes to slot `cache_len % W`, written into ck / cv IN
    PLACE (as `attention` writes its cache); they are returned as they are.
    `rope` holds the rotary tables of `positions` if the caller has them.
    """
    Bsz, S, d = x.shape
    if S != 1:
        raise ValueError(f"ring_attention_step decodes one token, got S={S}")
    hd = cfg.resolved_head_dim
    Hq, Hkv = cfg.num_heads, cfg.num_kv_heads
    Wn = ck.shape[1]
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if rope is None:
        rope = RopeTables(positions, hd, cfg.rope_theta, cfg.mrope_sections)
    q = hints.whole_groups(q, -1, Hq)
    k = hints.whole_groups(k, -1, Hkv)
    v = hints.whole_groups(v, -1, Hkv)
    q = apply_rope(q.reshape(Bsz, 1, Hq, hd), positions, cfg.rope_theta,
                   cfg.mrope_sections, rope)
    k = apply_rope(k.reshape(Bsz, 1, Hkv, hd), positions, cfg.rope_theta,
                   cfg.mrope_sections, rope)
    v = v.reshape(Bsz, 1, Hkv, hd)
    slot = cache_len.long() % Wn                            # [B]
    bidx = torch.arange(Bsz, device=x.device)
    hints.write_rows(ck, bidx, slot, k[:, 0].to(ck.dtype))
    hints.write_rows(cv, bidx, slot, v[:, 0].to(cv.dtype))
    valid = (torch.arange(Wn, device=x.device)[None, :]
             <= torch.clamp_max(cache_len.long(), Wn - 1)[:, None])
    rep = Hq // Hkv
    k_all = torch.repeat_interleave(ck, rep, dim=2)
    v_all = torch.repeat_interleave(cv, rep, dim=2)
    attend = _attend_sharded if isinstance(q, DTensor) else _attend
    out = attend(q, k_all, v_all, valid[:, None, None, :], x.dtype,
                 divide=True)
    out = hints.reshape(out, (Bsz, 1, Hq * hd)) @ p["wo"]
    return out, (ck, cv)


# ---------------------------------------------------------------------- MLP
def init_mlp(cfg: ModelConfig, gen: torch.Generator, dtype=torch.float32,
             d_ff: Optional[int] = None, *, device) -> Params:
    d = cfg.d_model
    ff = d_ff or cfg.d_ff
    if cfg.activation in ("swiglu", "geglu"):
        return {"w_gate": _dense_init(gen, d, ff, dtype, device),
                "w_up": _dense_init(gen, d, ff, dtype, device),
                "w_down": _dense_init(gen, ff, d, dtype, device)}
    return {"w_up": _dense_init(gen, d, ff, dtype, device),
            "w_down": _dense_init(gen, ff, d, dtype, device)}


def apply_mlp(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    if cfg.activation == "swiglu":
        return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]
    if cfg.activation == "geglu":
        return (F.gelu(x @ p["w_gate"], approximate="tanh")
                * (x @ p["w_up"])) @ p["w_down"]
    return F.gelu(x @ p["w_up"], approximate="tanh") @ p["w_down"]
