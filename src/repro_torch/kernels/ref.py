"""Plain PyTorch versions of the kernels.

The CPU tests run these, and `chip_smoke.py` holds each CUDA kernel against
its plain version on the card. The kernel wrappers take them only for tensors
that lie on the CPU.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def gather_ref(table: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """Plain version of async_gather: out[i] = table[indices[i]]."""
    return table[indices.long()]


def scatter_update_ref(table: torch.Tensor, indices: torch.Tensor,
                       updates: torch.Tensor, op: str = "add") -> torch.Tensor:
    """Plain version of async_scatter, as a new tensor:
    table[indices[j]] op= updates[j] for every j.

    add is `index_add` (the CPU sums a row's updates in index order, the
    card in the order its atomics land). xor is applied in rounds:
    round r takes the r-th update of every row hit at least r+1 times, so
    within a round the rows are distinct and one indexed xor applies them;
    the rounds number the largest multiplicity of a row, not M, and xor
    commutes, so the result is exact."""
    idx = indices.long()
    if op == "add":
        return table.index_add(0, idx, updates)
    if op != "xor":
        raise ValueError(op)
    out = table.clone()
    if idx.numel() == 0:
        return out
    order = torch.argsort(idx, stable=True)
    sidx = idx[order]
    pos = torch.arange(sidx.numel(), device=idx.device)
    first = torch.ones_like(sidx, dtype=torch.bool)
    first[1:] = sidx[1:] != sidx[:-1]
    # rank of each update among those of its row, in index order
    rank = pos - torch.cummax(torch.where(first, pos, 0), 0).values
    for r in range(int(rank.max()) + 1):
        sel = order[rank == r]
        rows = idx[sel]
        out[rows] = out[rows] ^ updates[sel]
    return out


def scatter_bucket_ref(indices: torch.Tensor, updates: torch.Tensor,
                       shift: int, buckets: int):
    """Plain version of async_scatter's bucket pass: (indices, updates,
    offsets) with the updates in stable order of idx >> shift, and offsets
    [buckets + 1] the first place of each region's updates, then M (the
    exclusive scan of the regions' histogram)."""
    key = indices.long() >> shift
    order = torch.argsort(key, stable=True)
    offsets = torch.zeros(buckets + 1, dtype=torch.int32,
                          device=indices.device)
    offsets[1:] = torch.cumsum(torch.bincount(key, minlength=buckets), 0)
    return indices[order], updates[order], offsets


def round_scalar(s: float, dtype: torch.dtype) -> float:
    """s rounded to `dtype`, as the reference's triad rounds its scalar."""
    return float(torch.tensor(s, dtype=dtype))


def triad_ref(b: torch.Tensor, c: torch.Tensor, s: float) -> torch.Tensor:
    """Plain version of stream_triad: a = b + s * c, with s rounded to the
    arrays' type, the rest in float32 (product and sum each rounded) and one
    rounding to the arrays' type at the end."""
    s = round_scalar(s, b.dtype)
    return (b.float() + s * c.float()).to(b.dtype)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, window: int = 0,
                  scale: Optional[float] = None) -> torch.Tensor:
    """Plain version of flash_attention. q: [B, Hq, S, D]; k/v: [B, Hkv, T, D].
    GQA: q head h attends kv head h // (Hq // Hkv)."""
    B, Hq, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    rep = Hq // Hkv
    k = torch.repeat_interleave(k, rep, dim=1)
    v = torch.repeat_interleave(v, rep, dim=1)
    scale = scale or 1.0 / math.sqrt(D)
    logits = torch.einsum("bhsd,bhtd->bhst", q.float(), k.float()) * scale
    dev = q.device
    q_pos = torch.arange(S, device=dev)[:, None] + (T - S)  # queries at the tail
    k_pos = torch.arange(T, device=dev)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=dev)
    if causal:
        mask &= k_pos <= q_pos
    if window:
        mask &= k_pos > q_pos - window
    logits = torch.where(mask[None, None], logits,
                         torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhst,bhtd->bhsd", probs, v.float())
    return out.to(q.dtype)


def paged_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                        v_cache: torch.Tensor,
                        lengths: torch.Tensor) -> torch.Tensor:
    """Plain version of paged_attention (decode).
    q: [B, Hq, D]; caches: [B, T, Hkv, D]; lengths: [B] valid prefix.

    A sequence of length 0 gets 0 in every head, as the reference kernel
    (`repro.kernels.paged_attention`) gives it: it skips every page and
    divides a zero sum by max(l, 1e-30). A softmax over a row with every key
    masked would give the mean of V instead."""
    B, Hq, D = q.shape
    T, Hkv = k_cache.shape[1], k_cache.shape[2]
    rep = Hq // Hkv
    k = torch.repeat_interleave(k_cache, rep, dim=2)       # [B, T, Hq, D]
    v = torch.repeat_interleave(v_cache, rep, dim=2)
    logits = torch.einsum("bhd,bthd->bht", q.float(),
                          k.float()) / math.sqrt(D)
    mask = torch.arange(T, device=q.device)[None, :] < lengths[:, None]
    logits = torch.where(mask[:, None, :], logits,
                         torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bht,bthd->bhd", probs, v.float())
    out = torch.where((lengths > 0)[:, None, None], out, torch.zeros_like(out))
    return out.to(q.dtype)
