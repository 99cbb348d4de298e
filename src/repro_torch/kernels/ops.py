"""Public wrappers around the kernels: the layout glue between the callers'
tensors and the kernels'.

`gather`, `scatter_update` and `triad` are the AMU kernels' entry points
(`launch/quickstart.py` and `chip_smoke.py` drive them). The model layer
(`repro_torch.models.blocks`) calls the attention wrappers when
`use_kernels=True`. The reference's glue pads to the block size (a sink row
for scatter) and swaps axes with copies; the Hopper kernels mask the ragged
edge themselves and read through strides, so here nothing is padded and the
attention wrappers hand over views.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.async_gather import async_gather as _gather
from repro_torch.kernels.async_scatter import async_scatter as _scatter
from repro_torch.kernels.flash_attention import flash_attention as _flash
from repro_torch.kernels.paged_attention import paged_attention as _paged
from repro_torch.kernels.stream_triad import stream_triad as _triad


def gather(table: torch.Tensor, indices: torch.Tensor,
           block_m: int = 256, num_slots: int = 8) -> torch.Tensor:
    """Embedding/GUPS gather: out[i] = table[indices[i]]."""
    return _gather(table, indices.to(torch.int32), block_m=block_m,
                   num_slots=num_slots)


def scatter_update(table: torch.Tensor, indices: torch.Tensor,
                   updates: torch.Tensor, op: str = "add",
                   block_m: int = 256, num_slots: int = 8) -> torch.Tensor:
    """RMW scatter: a new table with table[idx[j]] op= updates[j]. `table`
    is left as it was (the kernel updates a clone in place)."""
    return _scatter(table.clone(), indices.to(torch.int32), updates, op=op,
                    block_m=block_m, num_slots=num_slots)


def triad(b: torch.Tensor, c: torch.Tensor, s: float,
          block: int = 512) -> torch.Tensor:
    """STREAM triad a = b + s * c, any length."""
    return _triad(b, c, s, block=block)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0,
                    block_q: int = 128, block_k: int = 128) -> torch.Tensor:
    """Model-layer layout: q [B, S, Hq, D], k/v [B, S, Hkv, D] ->
    [B, S, Hq, D]."""
    out = _flash(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                 causal=causal, window=window, block_q=block_q,
                 block_k=block_k)
    return out.transpose(1, 2)


def paged_attention(q: torch.Tensor, k_cache: torch.Tensor,
                    v_cache: torch.Tensor, lengths: torch.Tensor,
                    page: int = 512) -> torch.Tensor:
    """Decode attention. q: [B, Hq, D]; caches [B, T, Hkv, D]; lengths [B]."""
    return _paged(q, k_cache, v_cache, lengths.to(torch.int32), page=page)


__all__ = ["gather", "scatter_update", "triad", "flash_attention",
           "paged_attention", "ref"]
