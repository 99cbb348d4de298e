"""recurrentgemma-9b — hybrid RG-LRU + local attention, 1:2 pattern.

38L d_model=4096 16H (MQA kv=1) d_ff=12288 vocab=256000, head_dim=256,
sliding window 2048 on the attention layers. [arXiv:2402.19427; unverified]
"""
from repro_torch.configs.base import (BLOCK_LOCAL, BLOCK_RGLRU, ModelConfig)

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    block_pattern=(BLOCK_RGLRU, BLOCK_RGLRU, BLOCK_LOCAL),
    window_size=2048,
    rnn_width=4096,
    activation="geglu",
    norm="rmsnorm",
    rope_theta=10000.0,
    tie_embeddings=True,
    source="[arXiv:2402.19427; unverified]",
    notes="RG-LRU + local attn 1:2; sub-quadratic -> runs long_500k",
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b-smoke",
        family="hybrid",
        num_layers=3,
        d_model=64,
        num_heads=4,
        num_kv_heads=1,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        block_pattern=(BLOCK_RGLRU, BLOCK_RGLRU, BLOCK_LOCAL),
        window_size=16,
        rnn_width=64,
        activation="geglu",
        tie_embeddings=True,
    )
