"""Architecture registry: ``--arch <id>`` resolves through here.

`default_parallel` of the reference comes with the parallel layer.
"""
from __future__ import annotations

import importlib
from typing import Dict, List, Tuple

from repro_torch.configs.base import (  # noqa: F401  (re-exported public API)
    BLOCK_FULL, BLOCK_LOCAL, BLOCK_RGLRU, BLOCK_RWKV6,
    DECODE_32K, LONG_500K, PREFILL_32K, SHAPES, TRAIN_4K,
    EngineConfig, FrontendConfig, ModelConfig, MoEConfig, ParallelConfig,
    RunConfig, ShapeConfig, shape_applicable,
    KIND_TRAIN, KIND_PREFILL, KIND_DECODE,
)

# arch id -> module name under repro_torch.configs
_ARCH_MODULES: Dict[str, str] = {
    "recurrentgemma-9b": "recurrentgemma_9b",
    "qwen2-vl-2b": "qwen2_vl_2b",
    "qwen2-7b": "qwen2_7b",
    "qwen2.5-32b": "qwen2_5_32b",
    "phi4-mini-3.8b": "phi4_mini_3_8b",
    "qwen2.5-3b": "qwen2_5_3b",
    "rwkv6-7b": "rwkv6_7b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "hubert-xlarge": "hubert_xlarge",
}

ARCH_IDS: Tuple[str, ...] = tuple(_ARCH_MODULES)


def _module(arch: str):
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {', '.join(ARCH_IDS)}")
    return importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke()


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


def all_cells() -> List[Tuple[str, str, bool, str]]:
    """Every (arch, shape) pair with its applicability verdict.

    Returns list of (arch_id, shape_name, applicable, reason) — 40 rows.
    """
    rows = []
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape_name, shape in SHAPES.items():
            ok, reason = shape_applicable(cfg, shape)
            rows.append((arch, shape_name, ok, reason))
    return rows
