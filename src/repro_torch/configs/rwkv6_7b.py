"""rwkv6-7b "Finch" — attention-free, data-dependent decay.

32L d_model=4096 d_ff=14336 vocab=65536. Head size 64 -> 64 mixing heads.
[arXiv:2404.05892; hf]
"""
from repro_torch.configs.base import BLOCK_RWKV6, ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    num_layers=32,
    d_model=4096,
    num_heads=64,       # rwkv6 head_size=64 -> 4096/64 heads
    num_kv_heads=64,
    head_dim=64,
    d_ff=14336,
    vocab_size=65536,
    block_pattern=(BLOCK_RWKV6,),
    rnn_width=4096,
    activation="swiglu",
    norm="layernorm",
    source="[arXiv:2404.05892; hf]",
    notes="attention-free; sub-quadratic -> runs long_500k",
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-7b-smoke",
        family="ssm",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        block_pattern=(BLOCK_RWKV6,),
        rnn_width=64,
        norm="layernorm",
    )
