"""Model assembly: embedding (or a modality frontend) -> block stack -> head,
with prefill (stateful; an encoder forward for encoders) and decode
(single-token, cached) paths, for the dense decoders (`qwen2.5-3b`,
`qwen2-7b`, `phi4-mini-3.8b`, `qwen2.5-32b`), the MoE decoders
(`granite-moe-1b-a400m`, `kimi-k2-1t-a32b`), the vision decoder with M-RoPE
(`qwen2-vl-2b`), the audio encoder (`hubert-xlarge`), the attention-free
`rwkv6-7b` and the hybrid `recurrentgemma-9b` (RG-LRU blocks and
sliding-window attention whose decode cache is a ring of the last `window`
tokens).

The counterpart of `src/repro/models/lm.py`. The parameter and cache layout is
the reference's, so its pytrees convert leaf by leaf: layers are stacked over
*periods* of the block pattern, `params["scan"]` is a tuple (one entry per
pattern position) of dicts whose leaves carry a leading `[P, ...]` axis, and
remainder layers sit unstacked under `"tail"`. Where the reference scans over
the stacked axis, this is a Python loop over views into the leaves (each
leaf `unbind`-ed once), and the cache's leaves are written in place through
those views.

Training: `train_loss` runs the same stack under autograd, with the
reference's remat modes as `torch.utils.checkpoint` around each period
(`_remat_wrap`), and `chunked_xent` computes the loss one sequence chunk at a
time.

On a mesh (DTensor params and inputs, `runtime.steps.jit_train_step`) the
same code runs on DTensors: the reference's hints (`LM_CONFIG`'s
sequence-parallel residual among them) plus the ones DTensor needs said
(`runtime.hints`): each layer's weights gathered over the data axes where
they are used (FSDP), the residual stream all-reduced as it joins and its
gradient too (`_residual`), and a DTensor cache written through
`hints.write_rows`.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor
from torch.utils import checkpoint as ckpt

from repro_torch.configs.base import (BLOCK_FULL, BLOCK_LOCAL, BLOCK_RGLRU,
                                      BLOCK_RWKV6, ModelConfig)
from repro_torch.convert import flatten, tree_map, unflatten
from repro_torch.models import blocks as B
from repro_torch.models import frontends as F
from repro_torch.models import moe as M
from repro_torch.models import rglru as R
from repro_torch.models import rwkv6 as W
from repro_torch.runtime import hints

Params = Dict[str, Any]

LM_CONFIG = {"seq_parallel_residual": 0}   # 1 -> Korthikanti-style SP


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
    p: Params = {"norm1": B.init_norm(cfg, cfg.d_model, device=device),
                 "norm2": B.init_norm(cfg, cfg.d_model, device=device)}
    if kind in (BLOCK_FULL, BLOCK_LOCAL):
        p["mix"] = B.init_attention(cfg, gen, dtype, device=device)
    elif kind == BLOCK_RGLRU:
        p["mix"] = R.init_rglru(cfg, gen, dtype, device=device)
    elif kind == BLOCK_RWKV6:
        p["mix"] = W.init_rwkv6(cfg, gen, dtype, device=device)
    else:
        raise ValueError(kind)
    if cfg.moe is not None:
        p["ffn"] = M.init_moe(cfg, gen, dtype, device=device)
    else:
        p["ffn"] = B.init_mlp(cfg, gen, dtype, device=device)
    return p


def _init_period(cfg: ModelConfig, gen: torch.Generator, dtype,
                 device) -> Tuple[Params, ...]:
    return tuple(_init_layer(cfg, kind, gen, dtype, device)
                 for kind in cfg.block_pattern)


def _stacked(n: int, make):
    """n trees from `make()`, in call order, stacked leaf by leaf along a new
    leading axis. Each is copied into its place as soon as it is made, so at
    most one unstacked tree is held beside the stack (rwkv6-7b's fp32
    weights are 38 GB: the stack and a full set of copies would not fit)."""
    leaves, treedef = flatten(make())
    out = [t.new_empty((n,) + tuple(t.shape)) for t in leaves]
    for i in range(n):
        if i:
            leaves, _ = flatten(make())
        for dst, src in zip(out, leaves):
            dst[i].copy_(src)
        leaves = None
    return unflatten(treedef, out)


def init_model(cfg: ModelConfig, gen: Optional[torch.Generator] = None,
               dtype=torch.float32, device="cuda") -> Params:
    """Random weights in the reference's layout, drawn from `gen` (a
    `torch.Generator` on `device`; seeded 0 if None). Asking for a card that
    is not there raises. The draws differ from the reference's for the same
    seed; parity tests carry weights across with `repro_torch.convert`.
    `device="meta"` gives the shapes and types alone (no generator)."""
    device = resolve_device(device)
    if gen is None and device.type != "meta":
        gen = torch.Generator(device=device).manual_seed(0)
    period = len(cfg.block_pattern)
    n_periods, n_tail = divmod(cfg.num_layers, period)
    params: Params = {}
    if cfg.frontend is None or cfg.frontend.kind == "vision":
        emb = torch.randn((cfg.vocab_size, cfg.d_model), generator=gen,
                          dtype=torch.float32, device=device)
        params["embed"] = (emb * 0.02).to(dtype)
    if cfg.frontend is not None:
        params["frontend"] = F.init_frontend(cfg, gen, dtype, device=device)
    if n_periods:
        params["scan"] = _stacked(
            n_periods, lambda: _init_period(cfg, gen, dtype, device))
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
    """A sliding-window layer keeps the last min(window, max_len) tokens."""
    hd, hkv = cfg.resolved_head_dim, cfg.num_kv_heads
    if kind in (BLOCK_FULL, BLOCK_LOCAL):
        t = (min(cfg.window_size or max_len, max_len) if kind == BLOCK_LOCAL
             else max_len)
        return {"k": torch.zeros((batch, t, hkv, hd), dtype=dtype,
                                 device=device),
                "v": torch.zeros((batch, t, hkv, hd), dtype=dtype,
                                 device=device)}
    if kind == BLOCK_RGLRU:
        return R.init_rglru_state(cfg, batch, device=device)
    if kind == BLOCK_RWKV6:
        return W.init_rwkv6_state(cfg, batch, device=device)
    raise ValueError(kind)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda") -> Params:
    """Decode cache tree: {"scan": leaves [P, ...], "tail": [...],
    "len": [B]} — `len` (int32) is the shared valid-prefix length."""
    device = resolve_device(device)
    period = len(cfg.block_pattern)
    n_periods, n_tail = divmod(cfg.num_layers, period)
    cache: Params = {"len": torch.zeros((batch,), dtype=torch.int32,
                                        device=device)}
    if n_periods:
        cache["scan"] = _stacked(n_periods, lambda: tuple(
            init_layer_cache(cfg, kind, batch, max_len, dtype, device)
            for kind in cfg.block_pattern))
    if n_tail:
        cache["tail"] = [init_layer_cache(cfg, cfg.block_pattern[i % period],
                                          batch, max_len, dtype, device)
                         for i in range(n_tail)]
    return cache


# =================================================================== layers
def _apply_layer(cfg: ModelConfig, kind: str, p: Params, x: torch.Tensor,
                 positions: torch.Tensor, cache: Optional[Params],
                 cache_len: Optional[torch.Tensor], use_kernels: bool,
                 moe_mode: str = "capacity",
                 rope: Optional[B.RopeTables] = None
                 ) -> Tuple[torch.Tensor, Optional[Params],
                            Optional[torch.Tensor]]:
    """One block -> (x, cache, aux). The cache's leaves are written IN PLACE
    and returned: attention's `k` / `v` (prefill fills the prefix, or for a
    sliding-window layer the ring slots of the last `window` tokens; decode
    scatters the new row), RG-LRU's `h` / `conv` and RWKV-6's `s` / `last_x`
    (copied over whole). `aux` is the MoE load-balancing loss, None for a
    dense FFN (the reference's zero)."""
    p = hints.gather_fsdp(p)
    if LM_CONFIG["seq_parallel_residual"] and x.shape[1] > 1:
        # sequence-parallel residual stream: norms/elementwise run with S
        # sharded over "model", gathered at the matmul boundaries
        x = hints.constrain(x, hints.batch_spec_axes(), "model", None)
    h = hints.grad_as_forward(B.apply_norm(cfg, p["norm1"], x))
    new_cache = None
    window = cfg.window_size if kind == BLOCK_LOCAL else 0
    if kind in (BLOCK_FULL, BLOCK_LOCAL):
        if cache is not None:
            S = h.shape[1]
            if kind == BLOCK_LOCAL and S == 1:
                # decode through the ring-buffered window cache
                out, nc = B.ring_attention_step(
                    cfg, p["mix"], h, positions, cache["k"], cache["v"],
                    cache_len, rope=rope)
            elif kind == BLOCK_LOCAL or S > 1:
                # prefill: self-attention over the prompt, then fill the
                # cache — the prefix for full attention (avoiding the
                # [S, T_max] masked-cache path), for a window the ring with
                # the last W tokens (slot = absolute position mod W)
                out, kv = B.attention(cfg, p["mix"], h, positions,
                                      window=window, use_kernels=use_kernels,
                                      return_kv=True, rope=rope)
                if kind == BLOCK_LOCAL:
                    Wn = cache["k"].shape[1]
                    take = min(Wn, S)
                    slots = torch.arange(S - take, S, device=h.device) % Wn
                    for name, t in zip("kv", kv):
                        _fill(cache[name], slots, t[:, -take:])
                else:
                    for name, t in zip("kv", kv):
                        _fill(cache[name], slice(0, S), t)
                nc = (cache["k"], cache["v"])
            else:
                out, nc = B.attention(cfg, p["mix"], h, positions,
                                      kv_cache=(cache["k"], cache["v"]),
                                      cache_len=cache_len,
                                      use_kernels=use_kernels, rope=rope)
            new_cache = {"k": nc[0], "v": nc[1]}
        else:
            out, _ = B.attention(cfg, p["mix"], h, positions, window=window,
                                 use_kernels=use_kernels, rope=rope)
    else:
        mix = R.apply_rglru if kind == BLOCK_RGLRU else W.apply_rwkv6
        out, state = mix(cfg, p["mix"], h, cache)
        if cache is not None:
            # the callers hand back the cache tree they were given, so the
            # new state goes into its tensors (views into stacked leaves)
            for name, t in state.items():
                cache[name].copy_(t)
            new_cache = cache
    x = x + _residual(out)
    h2 = hints.grad_as_forward(B.apply_norm(cfg, p["norm2"], x))
    if cfg.moe is not None:
        ffn_out, aux = M.apply_moe(cfg, p["ffn"], h2, mode=moe_mode)
    else:
        ffn_out, aux = B.apply_mlp(cfg, p["ffn"], h2), None
    return x + _residual(ffn_out), new_cache, aux


def _residual(x: torch.Tensor) -> torch.Tensor:
    """The residual stream's layout on a mesh: batch over the data axes,
    the rest whole on every "model" rank, or the sequence over "model"
    under `seq_parallel_residual`. Applied to the stream's input and to
    each sublayer's output before it joins the stream, so a sublayer's
    partial sums are all-reduced there (Megatron's "g"); a sublayer's
    input takes `hints.grad_as_forward` (its "f"), so the stream's
    gradient is whole too. XLA settles the stream so by itself; DTensor,
    left alone, may keep it partial or sharded on the hidden dim and then
    gather the next product's weights whole instead."""
    if LM_CONFIG["seq_parallel_residual"] and x.shape[1] > 1:
        return hints.constrain(x, hints.batch_spec_axes(), "model", None)
    return hints.constrain(x, hints.batch_spec_axes(), None, None)


def _fill(cache: torch.Tensor, where, values: torch.Tensor) -> None:
    """cache[:, where] = values, IN PLACE (`where` a slice or the positions'
    indices). A DTensor cache takes the rows through `hints.write_rows`: a
    slice of a DTensor is a new tensor, so assigning into it would leave
    the cache as it was."""
    values = values.to(cache.dtype)
    if not isinstance(cache, DTensor):
        cache[:, where] = values
        return
    pos = (torch.arange(where.start, where.stop, device=values.device)
           if isinstance(where, slice) else where)
    B = cache.shape[0]
    hints.write_rows(cache, torch.arange(B, device=values.device)[:, None],
                     pos[None, :].expand(B, -1), values)


# ================================================================== forward
# What "selective" remat keeps: the products without batch dimensions, as
# `jax.checkpoint_policies.dots_with_no_batch_dims_saveable` does. `x @ W`
# with a 2-D weight reaches aten as `mm` (or `addmm`); einsums over a batch
# dimension reach it as `bmm` and are recomputed with everything else.
_SAVED_BY_SELECTIVE = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _selective_policy(ctx, op, *args, **kwargs):
    if op in _SAVED_BY_SELECTIVE:
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _remat_wrap(fn: Callable, remat: str) -> Callable:
    """`fn` under the reference's remat mode: "full" keeps only its inputs
    and recomputes the rest in the backward, "selective" also keeps the
    products without batch dimensions, "none" keeps everything."""
    if remat == "none":
        return fn
    if remat == "full":
        return functools.partial(ckpt.checkpoint, fn, use_reentrant=False)
    if remat == "selective":
        return functools.partial(
            ckpt.checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(
                ckpt.create_selective_checkpoint_contexts, _selective_policy))
    raise ValueError(f"remat must be none, full or selective, got {remat!r}")


def _unstack(tree, n: int) -> List[Any]:
    """The n per-period trees of a stacked tree. Each leaf is sliced once,
    by `unbind`: under autograd its backward is one `stack` a leaf, where
    indexing `t[i]` would make every period's backward allocate a zero
    tensor the size of the whole stack and add it into the leaf's gradient.
    The slices are views, so a cache is still written in place."""
    leaves, treedef = flatten(tree)
    cols = [t.unbind(0) for t in leaves]
    return [unflatten(treedef, [c[i] for c in cols]) for i in range(n)]


def forward_blocks(cfg: ModelConfig, params: Params, x: torch.Tensor,
                   positions: torch.Tensor, cache: Optional[Params] = None,
                   use_kernels: bool = False, moe_mode: str = "capacity",
                   remat: str = "none"
                   ) -> Tuple[torch.Tensor, Optional[Params], torch.Tensor]:
    """The block stack -> (x, cache, aux summed over the layers, fp32). With
    a cache, its leaves are updated in place and the returned tree holds the
    same tensors (`len` is left to the caller). `remat` wraps each period of
    the stack, not the tail, as the reference's scan body."""
    period = len(cfg.block_pattern)
    n_periods, n_tail = divmod(cfg.num_layers, period)
    cache_len = cache["len"] if cache is not None else None
    x = _residual(x)
    new_cache: Optional[Params] = {} if cache is not None else None
    # one set of rotary tables for the whole stack, not two per layer; cast
    # before the first period, so a recomputed period finds the cast made
    rope = None
    if {BLOCK_FULL, BLOCK_LOCAL} & set(cfg.block_pattern):
        rope = B.RopeTables(positions, cfg.resolved_head_dim, cfg.rope_theta,
                            cfg.mrope_sections)
        rope.get(x.dtype)
    auxes = []

    def period_body(x, pparams, pcache):
        out_aux = []
        for j, kind in enumerate(cfg.block_pattern):
            x, _, aux = _apply_layer(cfg, kind, pparams[j], x, positions,
                                     None if pcache is None else pcache[j],
                                     cache_len, use_kernels, moe_mode, rope)
            if aux is not None:
                out_aux.append(aux)
        return x, out_aux

    if n_periods:
        body = _remat_wrap(period_body, remat)
        pparams = _unstack(params["scan"], n_periods)
        pcaches = (_unstack(cache["scan"], n_periods) if cache is not None
                   else [None] * n_periods)
        for pp, pc in zip(pparams, pcaches):
            x, out_aux = body(x, pp, pc)
            auxes.extend(out_aux)
        if cache is not None:
            new_cache["scan"] = cache["scan"]
    if n_tail:
        for i in range(n_tail):
            x, _, aux = _apply_layer(
                cfg, cfg.block_pattern[i % period], params["tail"][i], x,
                positions, cache["tail"][i] if cache is not None else None,
                cache_len, use_kernels, moe_mode, rope)
            if aux is not None:
                auxes.append(aux)
        if cache is not None:
            new_cache["tail"] = cache["tail"]
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for aux in auxes:
        aux_total = aux_total + aux
    return x, new_cache, aux_total


def embed_inputs(cfg: ModelConfig, params: Params, inputs: Dict[str, Any],
                 dtype=torch.bfloat16) -> torch.Tensor:
    """tokens (with `vision_embeds` [B, prefix_len, feature_dim] for a vision
    frontend) or audio `features` [B, S, feature_dim] -> [B, S, d] stream."""
    if cfg.frontend is not None and cfg.frontend.kind == "audio":
        return F.apply_audio_features(cfg, hints.gather_fsdp(
            params["frontend"]), inputs["features"].to(dtype))
    x = hints.take_rows(hints.gather_fsdp(params["embed"]).to(dtype),
                        inputs["tokens"])
    if cfg.frontend is not None and cfg.frontend.kind == "vision":
        x = F.apply_vision_prefix(cfg, hints.gather_fsdp(params["frontend"]),
                                  x, inputs["vision_embeds"])
    return x


def positions_for(cfg: ModelConfig, batch: int, seq: int, offset=0, *,
                  device) -> torch.Tensor:
    """[B, S] positions, or M-RoPE's [3, B, S] where the config has
    sections; `offset` is an int or a [B] tensor (decode)."""
    if cfg.mrope_sections:
        return F.mrope_positions(cfg, batch, seq, offset, device=device)
    pos = torch.arange(seq, device=device)[None, :]
    if isinstance(offset, int):
        return (pos + offset).expand(batch, seq)
    return pos + offset[:, None]


def _head_logits(cfg: ModelConfig, params: Params,
                 x: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        return x @ hints.gather_fsdp(params["embed"]).to(x.dtype).T
    return x @ hints.gather_fsdp(params["head"])


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


def chunked_xent(cfg: ModelConfig, params: Params, x: torch.Tensor,
                 labels: torch.Tensor, chunk: int = 512) -> torch.Tensor:
    """Mean cross-entropy without the full [B, S, V] logits: each sequence
    chunk runs under `checkpoint`, so its [B, chunk, V] fp32 logits exist
    one chunk at a time, in the backward too. As in the reference, only the
    first (S // chunk) * chunk positions count."""
    Bsz, S, _ = x.shape
    chunk = min(chunk, S)
    n = S // chunk
    # the head's FSDP gather once for all chunks
    params = {k: hints.gather_fsdp(params[k]) for k in ("embed", "head")
              if k in params}

    def chunk_loss(xm, lm):
        logits = _head_logits(cfg, params, xm).float()
        logz = torch.logsumexp(logits, dim=-1, keepdim=True)
        # the gold logit keeps its trailing unit dim: on vocab-sharded
        # DTensor logits the gather's masked partial result carries a mask
        # of that shape, which indexing the dim away would not update
        gold = logits.gather(-1, lm[..., None].long())
        return (logz - gold).sum()

    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n):
        sl = slice(i * chunk, (i + 1) * chunk)
        total = total + ckpt.checkpoint(chunk_loss, x[:, sl], labels[:, sl],
                                        use_reentrant=False)
    return total / (Bsz * n * chunk)


# ============================================================== entrypoints
def train_loss(cfg: ModelConfig, params: Params, inputs: Dict[str, Any],
               use_kernels: bool = False, moe_mode: str = "capacity",
               remat: str = "selective", dtype=torch.bfloat16
               ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Full-sequence LM (or masked-frame) loss -> (loss, {"aux_loss"}),
    differentiable in `params` (the fp32 masters: the cast for compute is
    part of the graph). With `use_kernels` the causal attention of the
    forward runs the flash kernel, which has no backward: under autograd it
    raises NotImplementedError, as `jax.grad` fails on the reference's."""
    params = cast_params_for_compute(params, dtype)
    x = embed_inputs(cfg, params, inputs, dtype)
    Bsz, S = x.shape[:2]
    positions = positions_for(cfg, Bsz, S, device=x.device)
    x, _, aux = forward_blocks(cfg, params, x, positions, None,
                               use_kernels, moe_mode, remat)
    # the head's gradient comes back whole into the stream (see _residual)
    x = hints.grad_as_forward(B.apply_norm(cfg, params["final_norm"], x))
    loss = chunked_xent(cfg, params, x, inputs["labels"])
    if cfg.moe is not None:
        loss = loss + cfg.moe.load_balance_loss_weight * aux / cfg.num_layers
    return loss, {"aux_loss": aux}


@torch.no_grad()
def prefill(cfg: ModelConfig, params: Params, inputs: Dict[str, Any],
            cache: Optional[Params], use_kernels: bool = False,
            moe_mode: str = "capacity",
            dtype=torch.bfloat16) -> Tuple[torch.Tensor, Optional[Params]]:
    """Encoder forward / decoder prefill: returns last-position logits
    [B, 1, V] and, for a decoder, the filled cache. The cache's tensors are
    filled in place; the returned tree holds them with a new `len`. An
    encoder takes no cache (`cache=None`) and returns None for it."""
    params = cast_params_for_compute(params, dtype)
    x = embed_inputs(cfg, params, inputs, dtype)
    Bsz, S = x.shape[:2]
    positions = positions_for(cfg, Bsz, S, device=x.device)
    x, new_cache, _ = forward_blocks(cfg, params, x, positions,
                                     cache if cfg.is_decoder else None,
                                     use_kernels, moe_mode)
    x = B.apply_norm(cfg, params["final_norm"], x)
    logits = _head_logits(cfg, params, x[:, -1:])
    if new_cache is not None:
        new_cache["len"] = cache["len"] + S
    return logits, new_cache


@torch.no_grad()
def decode_step(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                cache: Params, use_kernels: bool = False,
                moe_mode: str = "capacity",
                dtype=torch.bfloat16) -> Tuple[torch.Tensor, Params]:
    """One decode step: tokens [B, 1] + cache -> logits [B, 1, V] + cache.
    The new K/V row (or RWKV-6 state) is written into the cache's tensors in
    place; the returned tree holds them with `len + 1` (a new tensor: the old
    `len` is not touched)."""
    params = cast_params_for_compute(params, dtype)
    x = hints.take_rows(hints.gather_fsdp(params["embed"]), tokens)
    Bsz = x.shape[0]
    positions = positions_for(cfg, Bsz, 1, offset=cache["len"],
                              device=x.device)
    x, new_cache, _ = forward_blocks(cfg, params, x, positions, cache,
                                     use_kernels, moe_mode)
    x = B.apply_norm(cfg, params["final_norm"], x)
    logits = _head_logits(cfg, params, x)
    new_cache["len"] = cache["len"] + 1
    return logits, new_cache
