"""qwen2-vl-2b — VLM decoder backbone with M-RoPE.

28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936. The vision frontend is
a STUB: input_specs() provides precomputed patch embeddings for a 256-position
image prefix. [arXiv:2409.12191; hf]
"""
from repro_torch.configs.base import BLOCK_FULL, FrontendConfig, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab_size=151936,
    block_pattern=(BLOCK_FULL,),
    qkv_bias=True,
    tie_embeddings=True,
    activation="swiglu",
    rope_theta=1000000.0,
    mrope_sections=(16, 24, 24),  # temporal/height/width splits of head_dim/2
    frontend=FrontendConfig(kind="vision", feature_dim=1280, prefix_len=256),
    source="[arXiv:2409.12191; hf]",
    notes="M-RoPE, dynamic resolution (frontend stubbed as patch embeddings)",
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-2b-smoke",
        family="vlm",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        qkv_bias=True,
        tie_embeddings=True,
        mrope_sections=(2, 3, 3),
        frontend=FrontendConfig(kind="vision", feature_dim=32, prefix_len=8),
    )
