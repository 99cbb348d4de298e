"""Public wrappers around the attention kernels: the layout glue between the
model layer's [B, S, H, D] tensors and the kernels' layouts.

The model layer (`repro_torch.models.blocks`) calls these when
`use_kernels=True`. The reference's glue pads S and T to the block size and
swaps axes with copies; the Hopper kernels mask the ragged edge themselves and
read through strides, so here both wrappers hand over views.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import flash_attention as _flash
from repro_torch.kernels.paged_attention import paged_attention as _paged


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


__all__ = ["flash_attention", "paged_attention", "ref"]
