"""hubert-xlarge — encoder-only audio transformer (w2v2-style backbone).

48L d_model=1280 16H (MHA kv=16) d_ff=5120 vocab=504 (k-means unit targets).
The conv feature extractor is a STUB: input_specs() provides precomputed frame
embeddings. Encoder-only -> no decode shapes. [arXiv:2106.07447; unverified]
"""
from repro_torch.configs.base import BLOCK_FULL, FrontendConfig, ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    num_layers=48,
    d_model=1280,
    num_heads=16,
    num_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab_size=504,
    block_pattern=(BLOCK_FULL,),
    activation="gelu",
    norm="layernorm",
    causal=False,
    is_decoder=False,
    frontend=FrontendConfig(kind="audio", feature_dim=512),
    source="[arXiv:2106.07447; unverified]",
    notes="encoder-only (bidirectional); decode_32k/long_500k skipped",
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="hubert-xlarge-smoke",
        family="audio",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=64,
        activation="gelu",
        norm="layernorm",
        causal=False,
        is_decoder=False,
        frontend=FrontendConfig(kind="audio", feature_dim=32),
    )
