"""qwen2.5-3b — dense GQA decoder with QKV bias.

36L d_model=2048 16H (GQA kv=2) d_ff=11008 vocab=151936.
[hf:Qwen/Qwen2.5-0.5B family card; hf]
"""
from repro_torch.configs.base import BLOCK_FULL, ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-3b",
    family="dense",
    num_layers=36,
    d_model=2048,
    num_heads=16,
    num_kv_heads=2,
    head_dim=128,
    d_ff=11008,
    vocab_size=151936,
    block_pattern=(BLOCK_FULL,),
    qkv_bias=True,
    tie_embeddings=True,
    activation="swiglu",
    rope_theta=1000000.0,
    source="[hf:Qwen/Qwen2.5-0.5B; hf]",
    notes="GQA + QKV bias; long_500k skipped (pure full attention)",
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-3b-smoke",
        family="dense",
        num_layers=3,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=160,
        vocab_size=512,
        qkv_bias=True,
        tie_embeddings=True,
    )
