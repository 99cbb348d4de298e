"""Modality frontend stubs, the counterpart of `src/repro/models/frontends.py`.

The configs name the transformer backbone only; the caller hands over
precomputed patch (vision) or frame (audio) embeddings, and the one real
parameter is their projection into d_model, `proj` [feature_dim, d_model].
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.blocks import _dense_init

Params = Dict[str, Any]


def init_frontend(cfg: ModelConfig, gen: torch.Generator, dtype=torch.float32,
                  *, device) -> Params:
    assert cfg.frontend is not None
    return {"proj": _dense_init(gen, cfg.frontend.feature_dim, cfg.d_model,
                                dtype, device)}


def apply_vision_prefix(cfg: ModelConfig, p: Params, x: torch.Tensor,
                        vision_embeds: torch.Tensor) -> torch.Tensor:
    """Overwrite the first `prefix_len` positions of the token-embedding
    stream with projected patch embeddings. x: [B, S, d];
    vision_embeds: [B, prefix_len, feature_dim]."""
    vis = vision_embeds.to(x.dtype) @ p["proj"]
    n = cfg.frontend.prefix_len
    return torch.cat([vis[:, :n], x[:, n:]], dim=1)


def apply_audio_features(cfg: ModelConfig, p: Params,
                         features: torch.Tensor) -> torch.Tensor:
    """Project precomputed frames into the model stream.
    features: [B, S, feature_dim] -> [B, S, d]."""
    return features @ p["proj"]


def mrope_positions(cfg: ModelConfig, batch: int, seq: int, offset=0, *,
                    device) -> torch.Tensor:
    """M-RoPE position ids [3, B, S] int32 (Qwen2-VL). The image prefix takes
    a 2D (h, w) grid at temporal position 0; text continues all three
    streams from the prefix. `offset` is an int or a [B] tensor (decode)."""
    n = cfg.frontend.prefix_len if cfg.frontend else 0
    side = max(1, int(n ** 0.5))
    if isinstance(offset, int):
        offset = torch.full((batch,), offset, dtype=torch.int32,
                            device=device)
    pos = (torch.arange(seq, dtype=torch.int32, device=device)[None, :]
           + offset.to(torch.int32)[:, None])                        # [B, S]
    text = pos - n + 1
    prefix = pos < n
    t_pos = torch.where(prefix, torch.zeros_like(pos), text)
    h_pos = torch.where(prefix, pos // side, text)
    w_pos = torch.where(prefix, pos % side, text)
    return torch.stack([t_pos, h_pos, w_pos])                        # [3, B, S]
