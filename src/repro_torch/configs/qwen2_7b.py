"""qwen2-7b — dense GQA decoder with QKV bias.

28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064. [arXiv:2407.10671; hf]
"""
from repro_torch.configs.base import BLOCK_FULL, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-7b",
    family="dense",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    head_dim=128,
    d_ff=18944,
    vocab_size=152064,
    block_pattern=(BLOCK_FULL,),
    qkv_bias=True,
    activation="swiglu",
    rope_theta=1000000.0,
    source="[arXiv:2407.10671; hf]",
    notes="GQA + QKV bias; long_500k skipped (pure full attention)",
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen2-7b-smoke",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        qkv_bias=True,
    )
