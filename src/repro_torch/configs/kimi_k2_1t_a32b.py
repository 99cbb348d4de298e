"""kimi-k2-1t-a32b — trillion-parameter MoE (paper-table config).

61L d_model=7168 64H (GQA kv=8) d_ff_expert=2048 vocab=163840,
MoE 384 experts top-8 + 1 shared expert. head_dim pinned to 128 so the
matrix units see aligned tiles (7168/64=112 is not; the o-proj absorbs the
difference).
[arXiv:2501.kimi2; unverified]
"""
from repro_torch.configs.base import BLOCK_FULL, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=2048,  # == expert d_ff; dense path unused (all layers MoE)
    vocab_size=163840,
    block_pattern=(BLOCK_FULL,),
    activation="swiglu",
    rope_theta=50000.0,
    moe=MoEConfig(num_experts=384, top_k=8, d_ff_expert=2048,
                  num_shared_experts=1),
    source="[arXiv:2501.kimi2; unverified]",
    notes=("~1.03T total / ~32B active params; expert-parallel over the model "
           "axis (384/16 = 24 experts per group); long_500k skipped "
           "(pure full attention)"),
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="kimi-k2-1t-a32b-smoke",
        family="moe",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=32,
        vocab_size=512,
        moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=32,
                      num_shared_experts=1),
    )
