"""qwen2.5-32b — dense GQA decoder with QKV bias.

64L d_model=5120 40H (GQA kv=8) d_ff=27648 vocab=152064.
[hf:Qwen/Qwen2.5-0.5B family card; hf]
"""
from repro_torch.configs.base import BLOCK_FULL, ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=27648,
    vocab_size=152064,
    block_pattern=(BLOCK_FULL,),
    qkv_bias=True,
    activation="swiglu",
    rope_theta=1000000.0,
    source="[hf:Qwen/Qwen2.5-0.5B; hf]",
    notes="GQA + QKV bias; long_500k skipped (pure full attention)",
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-32b-smoke",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=8,
        num_kv_heads=2,
        head_dim=8,
        d_ff=192,
        vocab_size=512,
        qkv_bias=True,
    )
