"""Model assembly: embedding -> block stack -> head, with prefill (stateful)
and decode (single-token, cached) paths, for the dense decoder architectures
(`qwen2.5-3b`, `qwen2-7b`, `phi4-mini-3.8b`, `qwen2.5-32b`).

The counterpart of `src/repro/models/lm.py`. The parameter and cache layout is
the reference's, so its pytrees convert leaf by leaf: layers are stacked over
*periods* of the block pattern, `params["scan"]` is a tuple (one entry per
pattern position) of dicts whose leaves carry a leading `[P, ...]` axis, and
remainder layers sit unstacked under `"tail"`. Where the reference scans over
the stacked axis, this is a Python loop over index views into the leaves.

Not ported yet, each raising `NotImplementedError` with its ROADMAP item:
sliding-window, RG-LRU and RWKV-6 blocks and MoE and the modality frontends
(A7), `train_loss` / `chunked_xent` (A8).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import BLOCK_FULL, ModelConfig
from repro_torch.convert import tree_map
from repro_torch.models import blocks as B

Params = Dict[str, Any]


def _check_supported(cfg: ModelConfig) -> None:
    kinds = set(cfg.block_pattern) - {BLOCK_FULL}
    if kinds:
        raise NotImplementedError(
            f"{cfg.name}: block kinds {sorted(kinds)} are not ported yet "
            "(ROADMAP A7: remaining mixers)")
    if cfg.moe is not None:
        raise NotImplementedError(
            f"{cfg.name}: MoE is not ported yet (ROADMAP A7)")
    if cfg.frontend is not None or cfg.mrope_sections:
        raise NotImplementedError(
            f"{cfg.name}: modality frontends and M-RoPE positions are not "
            "ported yet (ROADMAP A7)")


def resolve_device(device) -> torch.device:
    """`device` as a torch.device; raises when it names a card that is not
    there. Nothing carries on on the CPU because it found no GPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} was asked for but torch.cuda.is_available()"
            " is False; pass device='cpu' to run on the CPU")
    return device


# ==================================================================== init
def _init_layer(cfg: ModelConfig, kind: str, gen: torch.Generator, dtype,
                device) -> Params:
    if kind != BLOCK_FULL:
        raise NotImplementedError(
            f"block kind {kind!r} is not ported yet (ROADMAP A7)")
    return {"norm1": B.init_norm(cfg, cfg.d_model, device=device),
            "norm2": B.init_norm(cfg, cfg.d_model, device=device),
            "mix": B.init_attention(cfg, gen, dtype, device=device),
            "ffn": B.init_mlp(cfg, gen, dtype, device=device)}


def _init_period(cfg: ModelConfig, gen: torch.Generator, dtype,
                 device) -> Tuple[Params, ...]:
    return tuple(_init_layer(cfg, kind, gen, dtype, device)
                 for kind in cfg.block_pattern)


def _stack(trees):
    """Stack equal-structured trees leaf by leaf along a new leading axis."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_stack([t[i] for t in trees])
                           for i in range(len(first)))
    return torch.stack(trees)


def init_model(cfg: ModelConfig, gen: Optional[torch.Generator] = None,
               dtype=torch.float32, device="cuda") -> Params:
    """Random weights in the reference's layout, drawn from `gen` (a
    `torch.Generator` on `device`; seeded 0 if None). Asking for a card that
    is not there raises. The draws differ from the reference's for the same
    seed; parity tests carry weights across with `repro_torch.convert`."""
    _check_supported(cfg)
    device = resolve_device(device)
    if gen is None:
        gen = torch.Generator(device=device).manual_seed(0)
    period = len(cfg.block_pattern)
    n_periods, n_tail = divmod(cfg.num_layers, period)
    params: Params = {}
    emb = torch.randn((cfg.vocab_size, cfg.d_model), generator=gen,
                      dtype=torch.float32, device=device)
    params["embed"] = (emb * 0.02).to(dtype)
    if n_periods:
        params["scan"] = _stack([_init_period(cfg, gen, dtype, device)
                                 for _ in range(n_periods)])
    if n_tail:
        params["tail"] = [
            _init_layer(cfg, cfg.block_pattern[i % period], gen, dtype, device)
            for i in range(n_tail)]
    params["final_norm"] = B.init_norm(cfg, cfg.d_model, device=device)
    if not cfg.tie_embeddings:
        params["head"] = B._dense_init(gen, cfg.d_model, cfg.vocab_size,
                                       dtype, device)
    return params


# =================================================================== caches
def init_layer_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                     dtype=torch.bfloat16, device="cuda") -> Params:
    hd, hkv = cfg.resolved_head_dim, cfg.num_kv_heads
    if kind != BLOCK_FULL:
        raise NotImplementedError(
            f"block kind {kind!r} is not ported yet (ROADMAP A7)")
    return {"k": torch.zeros((batch, max_len, hkv, hd), dtype=dtype,
                             device=device),
            "v": torch.zeros((batch, max_len, hkv, hd), dtype=dtype,
                             device=device)}


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda") -> Params:
    """Decode cache tree: {"scan": leaves [P, ...], "tail": [...],
    "len": [B]} — `len` (int32) is the shared valid-prefix length."""
    _check_supported(cfg)
    device = resolve_device(device)
    period = len(cfg.block_pattern)
    n_periods, n_tail = divmod(cfg.num_layers, period)
    cache: Params = {"len": torch.zeros((batch,), dtype=torch.int32,
                                        device=device)}
    if n_periods:
        cache["scan"] = _stack([
            tuple(init_layer_cache(cfg, kind, batch, max_len, dtype, device)
                  for kind in cfg.block_pattern)
            for _ in range(n_periods)])
    if n_tail:
        cache["tail"] = [init_layer_cache(cfg, cfg.block_pattern[i % period],
                                          batch, max_len, dtype, device)
                         for i in range(n_tail)]
    return cache


# =================================================================== layers
def _apply_layer(cfg: ModelConfig, kind: str, p: Params, x: torch.Tensor,
                 positions: torch.Tensor, cache: Optional[Params],
                 cache_len: Optional[torch.Tensor], use_kernels: bool,
                 rope: Optional[B.RopeTables] = None
                 ) -> Tuple[torch.Tensor, Optional[Params]]:
    """One block. `cache["k"]` / `cache["v"]` are written IN PLACE (prefill
    fills the prefix, decode scatters the new row) and returned."""
    if kind != BLOCK_FULL:
        raise NotImplementedError(
            f"block kind {kind!r} is not ported yet (ROADMAP A7)")
    h = B.apply_norm(cfg, p["norm1"], x)
    new_cache = None
    if cache is not None:
        if h.shape[1] > 1:
            # full-attention prefill: run self-attention and bulk-fill the
            # cache prefix — avoids the [S, T_max] masked-cache path entirely.
            out, kv = B.attention(cfg, p["mix"], h, positions,
                                  use_kernels=use_kernels, return_kv=True,
                                  rope=rope)
            S = h.shape[1]
            cache["k"][:, :S] = kv[0].to(cache["k"].dtype)
            cache["v"][:, :S] = kv[1].to(cache["v"].dtype)
            nc = (cache["k"], cache["v"])
        else:
            out, nc = B.attention(cfg, p["mix"], h, positions,
                                  kv_cache=(cache["k"], cache["v"]),
                                  cache_len=cache_len,
                                  use_kernels=use_kernels, rope=rope)
        new_cache = {"k": nc[0], "v": nc[1]}
    else:
        out, _ = B.attention(cfg, p["mix"], h, positions,
                             use_kernels=use_kernels, rope=rope)
    x = x + out
    h2 = B.apply_norm(cfg, p["norm2"], x)
    return x + B.apply_mlp(cfg, p["ffn"], h2), new_cache


# ================================================================== forward
def forward_blocks(cfg: ModelConfig, params: Params, x: torch.Tensor,
                   positions: torch.Tensor, cache: Optional[Params] = None,
                   use_kernels: bool = False
                   ) -> Tuple[torch.Tensor, Optional[Params]]:
    """The block stack. With a cache, its K/V leaves are updated in place and
    the returned tree holds the same tensors (`len` is left to the caller)."""
    period = len(cfg.block_pattern)
    n_periods, n_tail = divmod(cfg.num_layers, period)
    cache_len = cache["len"] if cache is not None else None
    new_cache: Optional[Params] = {} if cache is not None else None
    # one set of rotary tables for the whole stack, not two per layer
    rope = B.RopeTables(positions, cfg.resolved_head_dim, cfg.rope_theta,
                        cfg.mrope_sections)

    for i in range(n_periods):
        for j, kind in enumerate(cfg.block_pattern):
            p_ij = tree_map(lambda t: t[i], params["scan"][j])
            c_ij = (None if cache is None
                    else tree_map(lambda t: t[i], cache["scan"][j]))
            x, _ = _apply_layer(cfg, kind, p_ij, x, positions, c_ij,
                                cache_len, use_kernels, rope)
    if n_periods and cache is not None:
        new_cache["scan"] = cache["scan"]
    if n_tail:
        for i in range(n_tail):
            kind = cfg.block_pattern[i % period]
            c_i = cache["tail"][i] if cache is not None else None
            x, _ = _apply_layer(cfg, kind, params["tail"][i], x, positions,
                                c_i, cache_len, use_kernels, rope)
        if cache is not None:
            new_cache["tail"] = cache["tail"]
    return x, new_cache


def embed_inputs(cfg: ModelConfig, params: Params, inputs: Dict[str, Any],
                 dtype=torch.bfloat16) -> torch.Tensor:
    """tokens -> [B, S, d] stream."""
    if cfg.frontend is not None:
        raise NotImplementedError(
            f"{cfg.name}: modality frontends are not ported yet (ROADMAP A7)")
    return params["embed"][inputs["tokens"]].to(dtype)


def positions_for(cfg: ModelConfig, batch: int, seq: int, offset=0, *,
                  device) -> torch.Tensor:
    if cfg.mrope_sections:
        raise NotImplementedError(
            f"{cfg.name}: M-RoPE positions are not ported yet (ROADMAP A7)")
    pos = torch.arange(seq, device=device)[None, :]
    if isinstance(offset, int):
        return (pos + offset).expand(batch, seq)
    return pos + offset[:, None]


def _head_logits(cfg: ModelConfig, params: Params,
                 x: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        return x @ params["embed"].to(x.dtype).T
    return x @ params["head"]


def cast_params_for_compute(params: Params, dtype=torch.bfloat16) -> Params:
    """Cast >=2D float32 weights to the compute dtype; 1D scales/biases and
    integer leaves keep their dtype. Idempotent: a tree that is already cast
    comes back as it is, leaf for leaf, so the entry points may call it on
    every step while `serve` casts once before its loop."""
    def cast(t):
        if (isinstance(t, torch.Tensor) and t.dtype == torch.float32
                and t.dim() >= 2):
            return t.to(dtype)
        return t
    return tree_map(cast, params)


# ============================================================== entrypoints
def train_loss(*args, **kwargs):
    raise NotImplementedError(
        "train_loss / chunked_xent are not ported yet (ROADMAP A8: training)")


chunked_xent = train_loss


@torch.no_grad()
def prefill(cfg: ModelConfig, params: Params, inputs: Dict[str, Any],
            cache: Params, use_kernels: bool = False,
            dtype=torch.bfloat16) -> Tuple[torch.Tensor, Params]:
    """Decoder prefill: returns last-position logits [B, 1, V] and the filled
    cache. The cache's K/V tensors are filled in place; the returned tree
    holds them with a new `len`."""
    _check_supported(cfg)
    params = cast_params_for_compute(params, dtype)
    x = embed_inputs(cfg, params, inputs, dtype)
    Bsz, S = x.shape[:2]
    positions = positions_for(cfg, Bsz, S, device=x.device)
    x, new_cache = forward_blocks(cfg, params, x, positions,
                                  cache if cfg.is_decoder else None,
                                  use_kernels)
    x = B.apply_norm(cfg, params["final_norm"], x)
    logits = _head_logits(cfg, params, x[:, -1:])
    if new_cache is not None:
        new_cache["len"] = cache["len"] + S
    return logits, new_cache


@torch.no_grad()
def decode_step(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                cache: Params, use_kernels: bool = False,
                dtype=torch.bfloat16) -> Tuple[torch.Tensor, Params]:
    """One decode step: tokens [B, 1] + cache -> logits [B, 1, V] + cache.
    The new K/V row is written into the cache's tensors in place; the
    returned tree holds them with `len + 1` (a new tensor: the old `len` is
    not touched)."""
    _check_supported(cfg)
    params = cast_params_for_compute(params, dtype)
    x = params["embed"][tokens]
    Bsz = x.shape[0]
    positions = positions_for(cfg, Bsz, 1, offset=cache["len"],
                              device=x.device)
    x, new_cache = forward_blocks(cfg, params, x, positions, cache,
                                  use_kernels)
    x = B.apply_norm(cfg, params["final_norm"], x)
    logits = _head_logits(cfg, params, x)
    new_cache["len"] = cache["len"] + 1
    return logits, new_cache
