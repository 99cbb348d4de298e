"""phi4-mini-3.8b — dense GQA decoder, RoPE + SwiGLU, no QKV bias.

32L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=200064. [arXiv:2412.08905; hf]
"""
from repro_torch.configs.base import BLOCK_FULL, ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b",
    family="dense",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=200064,
    block_pattern=(BLOCK_FULL,),
    qkv_bias=False,
    tie_embeddings=True,
    activation="swiglu",
    rope_theta=10000.0,
    source="[arXiv:2412.08905; hf]",
    notes="RoPE SwiGLU GQA; long_500k skipped (pure full attention)",
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="phi4-mini-3.8b-smoke",
        family="dense",
        num_layers=2,
        d_model=48,
        num_heads=6,
        num_kv_heads=2,
        head_dim=8,
        d_ff=96,
        vocab_size=512,
        tie_embeddings=True,
    )
