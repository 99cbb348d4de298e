"""granite-moe-1b-a400m — small MoE, 32 experts top-8.

24L d_model=1024 16H (GQA kv=8) d_ff_expert=512 vocab=49155.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]
"""
from repro_torch.configs.base import BLOCK_FULL, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab_size=49155,
    block_pattern=(BLOCK_FULL,),
    tie_embeddings=True,
    activation="swiglu",
    rope_theta=10000.0,
    moe=MoEConfig(num_experts=32, top_k=8, d_ff_expert=512),
    source="[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]",
    notes="32 experts top-8; long_500k skipped (pure full attention)",
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-1b-a400m-smoke",
        family="moe",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=32,
        vocab_size=512,
        tie_embeddings=True,
        moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=32),
    )
