"""Architecture registry: ``--arch <id>`` resolves through here."""
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


def default_parallel(model: ModelConfig, shape: ShapeConfig) -> ParallelConfig:
    """Per-arch default parallelism on the production meshes.

    FSDP for >= ~7B-param models (params cannot replicate across `data`);
    sequence sharding when the batch can't cover the data axis.
    """
    big = model.param_count() >= 5_000_000_000
    seq_shard = shape.kind != KIND_TRAIN and shape.global_batch < 16
    micro = 1
    if shape.kind == KIND_TRAIN:
        # size the gradient-accumulation factor so the per-microstep saved
        # activation stacks (~3.5 B/token/layer/d_model under full remat)
        # fit alongside params in 16 GB HBM (16-way data sharding assumed)
        tokens_dev = shape.tokens_per_step // 16
        est = tokens_dev * model.d_model * model.num_layers * 3.5
        micro = 1
        while micro < 16 and est / micro > 5e9:
            micro *= 2
    return ParallelConfig(
        fsdp=big,
        zero1=True,
        seq_shard=seq_shard,
        remat="full" if shape.kind == KIND_TRAIN else "none",
        scan_layers=True,
        expert_parallel=model.moe is not None,
        microbatches=micro,
    )


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
