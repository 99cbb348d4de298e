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
FP8_TYPES = (torch.float8_e4m3fn, torch.float8_e5m2)
INT_TYPES = (torch.int8, torch.uint8, torch.int16, torch.uint16, torch.int32,
             torch.uint32)
# The byte of an overflow, and the least magnitude that rounds to it (past
# the largest finite value, 448 in e4m3fn and 57344 in e5m2, by half a step;
# at 464 e4m3fn rounds to even, 448, at 61440 e5m2 to even, inf).
_FP8_OVER = {torch.float8_e4m3fn: (0x7F, 464.0, False),
             torch.float8_e5m2: (0x7C, 61440.0, True)}


def to_fp8(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """float -> float8 as XLA converts, and as `to_fp8` of csrc/common.cuh
    does on the card: to nearest even, with no saturation. A magnitude that
    rounds past the largest finite value gives NaN in e4m3fn (which has no
    infinity: 500.0 -> NaN) and +-inf in e5m2 (1e5 -> inf). torch's own
    `.to` saturates e4m3fn at 448, so the overflow is set here, on the
    bytes."""
    byte, limit, at_limit = _FP8_OVER[dtype]
    x = x.float()
    bits = x.to(dtype).view(torch.uint8)
    over = (x.abs() >= limit) if at_limit else (x.abs() > limit)
    special = torch.where(x < 0, byte | 0x80, byte).to(torch.uint8)
    return torch.where(over, special, bits).view(dtype)


def to_int(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """float -> integer as XLA converts, and as `to_int` of
    csrc/common.cuh: toward zero, saturated at the type's range, NaN -> 0
    (int8: 300.0 -> 127, 2.7 -> 2; uint8: -1.5 -> 0). torch's `.to`
    wraps or is undefined out of range. Taken in float64, exact for every
    int32."""
    info = torch.iinfo(dtype)
    x = x.double()
    x = torch.where(torch.isnan(x), torch.zeros_like(x), x)
    return x.trunc().clamp(info.min, info.max).to(dtype)


def from_float(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x (float32) in `dtype` as the reference's `.astype` gives it: float8
    by `to_fp8`, integers by `to_int`, other floats by `.to`."""
    if dtype in FP8_TYPES:
        return to_fp8(x, dtype)
    if dtype in INT_TYPES:
        return to_int(x, dtype)
    return x.to(dtype)


def _signed(t: torch.Tensor) -> torch.Tensor:
    """uint16 / uint32 as the signed type of their width, the same bits:
    torch's CPU lacks their add and index_add, and two's-complement add and
    xor do not depend on the sign."""
    view = {torch.uint16: torch.int16, torch.uint32: torch.int32}
    return t.view(view[t.dtype]) if t.dtype in view else t


def gather_ref(table: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """Plain version of async_gather: out[i] = table[indices[i]] (float8
    rows moved as their bytes)."""
    if table.dtype in FP8_TYPES:
        return table.view(torch.uint8)[indices.long()].view(table.dtype)
    return table[indices.long()]


def scatter_update_ref(table: torch.Tensor, indices: torch.Tensor,
                       updates: torch.Tensor, op: str = "add") -> torch.Tensor:
    """Plain version of async_scatter, as a new tensor:
    table[indices[j]] op= updates[j] for every j.

    add is `index_add` (the CPU sums a row's updates in index order, the
    card in the order its atomics land; integers wrap). xor and float8 add
    are applied in rounds: round r takes the r-th update of every row hit
    at least r+1 times, so within a round the rows are distinct and one
    indexed op applies them; the rounds number the largest multiplicity of
    a row, not M. xor commutes, so the result is exact; float8 add is
    widened to float32 and rounded back (`to_fp8`) after every add, which
    is the reference's sum in index order. uint16 and uint32 run on a
    signed view of the same bits (`_signed`)."""
    if op not in ("add", "xor"):
        raise ValueError(op)
    if table.dtype in (torch.uint16, torch.uint32):
        return scatter_update_ref(_signed(table), indices, _signed(updates),
                                  op).view(table.dtype)
    idx = indices.long()
    fp8 = table.dtype in FP8_TYPES
    if op == "add" and not fp8:
        return table.index_add(0, idx, updates)
    out = table.clone()
    if idx.numel() == 0:
        return out
    if fp8:         # rows moved as bytes, added in float32
        out, updates = out.view(torch.uint8), updates.view(torch.uint8)
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
        if fp8:
            dt = table.dtype
            out[rows] = to_fp8(out[rows].view(dt).float()
                               + updates[sel].view(dt).float(),
                               dt).view(torch.uint8)
        else:
            out[rows] = out[rows] ^ updates[sel]
    return out.view(table.dtype)


def scatter_add16_limit(table: torch.Tensor, indices: torch.Tensor,
                        updates: torch.Tensor) -> torch.Tensor:
    """How far apart two right answers of a bfloat16 / float16 / float8
    scatter-add may be, elementwise, as float32 [N, D]. Each add rounds to
    the type, so an element hit c times is c roundings of partial sums away
    from the exact sum, each at most u |partial| (u the type's unit
    roundoff, 2^-8 in bf16, 2^-11 in f16, 2^-4 in e4m3fn, 2^-3 in e5m2),
    and every partial is at most (1 + u)^c (|t| + sum |u_j|); two orders
    (the reference's update order, the card's order) are within twice
    that: 2 c u (1 + u)^c (|t| + sum |u_j|). float8 adds, for the partials
    that fall below its smallest normal, half its smallest subnormal a
    rounding (2^-10 in e4m3fn, 2^-17 in e5m2), twice c of them. An element
    no update hits has limit 0."""
    finfo = torch.finfo(table.dtype)
    u = finfo.eps / 2
    idx = indices.long()
    count = torch.bincount(idx, minlength=table.shape[0]).float()[:, None]
    mag = table.float().abs().index_add(0, idx, updates.float().abs())
    limit = 2 * count * u * (1 + u) ** count * mag
    if table.dtype in FP8_TYPES:
        limit = limit + count * finfo.tiny * finfo.eps
    return limit


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


# the triad's types whose product s * c the reference rounds before the add
ROUND_PRODUCT = (torch.bfloat16, *FP8_TYPES)


def round_scalar(s: float, dtype: torch.dtype):
    """s in `dtype`, as the reference's triad makes its scalar: a traced
    float32 (so s is rounded to float32 first), then `jnp.array([s],
    dtype)` inside the jit, XLA's conversion: a float type rounds (float8
    by `to_fp8`: 500.0 -> NaN in e4m3fn), an integer type takes it toward
    zero, saturated, NaN -> 0 (`to_int`: 300.0 -> 127 in int8). A float
    for float types, an int for integer types."""
    x = from_float(torch.tensor([float(s)], dtype=torch.float32), dtype)
    return int(x) if dtype in INT_TYPES else float(x.float())


def triad_ref(b: torch.Tensor, c: torch.Tensor, s: float) -> torch.Tensor:
    """Plain version of stream_triad: a = b + s * c in the arrays' type, as
    the reference computes it. s is made the type's first
    (`round_scalar`). Floats are widened to float32, where the product of
    two 8- or 16-bit values is exact: bfloat16 and float8 round the product
    s * c to their type and then the sum again, as the reference's kernel
    does on its CPU backend; float16 rounds once, at the end (so does that
    kernel there: its float16 product stays in float32), and float32 rounds
    the product and the sum in float32. Integers wrap (two's complement),
    computed in int64 and cut to the type's bits."""
    dtype = b.dtype
    s = round_scalar(s, dtype)
    if dtype in INT_TYPES:
        sb, sc = _signed(b), _signed(c)
        info = torch.iinfo(sb.dtype)
        x = (sb.long() + s * sc.long()) & ((1 << info.bits) - 1)
        if info.min < 0:
            x = x - ((x >> (info.bits - 1)) << info.bits)   # signed range
        return x.to(sb.dtype).view(dtype)
    prod = s * c.float()
    if dtype in ROUND_PRODUCT:
        prod = from_float(prod, dtype).float()
    return from_float(b.float() + prod, dtype)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, window: int = 0,
                  scale: Optional[float] = None) -> torch.Tensor:
    """Plain version of flash_attention. q: [B, Hq, S, D]; k/v: [B, Hkv, T, D].
    GQA: q head h attends kv head h // (Hq // Hkv)."""
    B, Hq, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    rep = Hq // Hkv
    k = torch.repeat_interleave(k.float(), rep, dim=1)
    v = torch.repeat_interleave(v.float(), rep, dim=1)
    scale = scale or 1.0 / math.sqrt(D)
    logits = torch.einsum("bhsd,bhtd->bhst", q.float(), k) * scale
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
    out = torch.einsum("bhst,bhtd->bhsd", probs, v)
    return from_float(out, q.dtype)


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
    k = torch.repeat_interleave(k_cache.float(), rep, dim=2)  # [B, T, Hq, D]
    v = torch.repeat_interleave(v_cache.float(), rep, dim=2)
    logits = torch.einsum("bhd,bthd->bht", q.float(), k) / math.sqrt(D)
    mask = torch.arange(T, device=q.device)[None, :] < lengths[:, None]
    logits = torch.where(mask[:, None, :], logits,
                         torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bht,bthd->bhd", probs, v)
    out = torch.where((lengths > 0)[:, None, None], out, torch.zeros_like(out))
    return from_float(out, q.dtype)
