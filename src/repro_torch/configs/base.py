"""Config dataclasses for models, shapes, parallelism, and the AMU engine.

Every assigned architecture is expressed as a :class:`ModelConfig`. Configs are
frozen dataclasses so they can be hashed and compared structurally in tests.

This is the port's own copy of the reference package's `configs/base.py`;
a test pins every field of every architecture equal between the two.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Block kinds: per-layer token-mixing modules. `block_pattern` is cycled over
# the layer stack (e.g. RecurrentGemma's ("rglru", "rglru", "local") 1:2 mix).
# ---------------------------------------------------------------------------
BLOCK_FULL = "full"      # full causal (or bidirectional for encoders) attention
BLOCK_LOCAL = "local"    # sliding-window attention
BLOCK_RGLRU = "rglru"    # RG-LRU linear recurrence (RecurrentGemma / Griffin)
BLOCK_RWKV6 = "rwkv6"    # RWKV-6 "Finch" data-dependent decay mixer

SUBQUADRATIC_BLOCKS = frozenset({BLOCK_RGLRU, BLOCK_RWKV6, BLOCK_LOCAL})


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared_experts: int = 0
    router_jitter: float = 0.0
    load_balance_loss_weight: float = 0.01
    # capacity factor for dropless-vs-capacity dispatch; the dense-routing path
    # used for dry-runs ignores it, the dispatch kernel honours it.
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class FrontendConfig:
    """Modality frontend STUB: the dry-run/input pipeline provides precomputed
    patch/frame embeddings; only the projection into d_model is modeled."""
    kind: str                 # "vision" | "audio"
    feature_dim: int          # dim of the precomputed embeddings
    prefix_len: int = 0       # vision: number of patch positions at seq start


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str               # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0         # 0 -> d_model // num_heads
    block_pattern: Tuple[str, ...] = (BLOCK_FULL,)
    window_size: int = 0      # for BLOCK_LOCAL
    qkv_bias: bool = False
    tie_embeddings: bool = False
    activation: str = "swiglu"   # swiglu | geglu | gelu
    norm: str = "rmsnorm"        # rmsnorm | layernorm
    norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    mrope_sections: Tuple[int, ...] = ()   # Qwen2-VL M-RoPE (t, h, w) splits
    rnn_width: int = 0        # rglru/rwkv6 recurrence width (0 -> d_model)
    causal: bool = True       # False for encoder-only (hubert)
    is_decoder: bool = True   # False -> no decode/serve step (encoder-only)
    moe: Optional[MoEConfig] = None
    frontend: Optional[FrontendConfig] = None
    source: str = ""          # provenance note "[arXiv:...; tier]"
    notes: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        pat = self.block_pattern
        return tuple(pat[i % len(pat)] for i in range(self.num_layers))

    @property
    def is_subquadratic(self) -> bool:
        """True if *every* layer avoids full quadratic attention (long_500k ok)."""
        return all(k in SUBQUADRATIC_BLOCKS for k in self.layer_kinds)

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, hd = self.d_model, self.resolved_head_dim
        n_q, n_kv = self.num_heads, self.num_kv_heads
        emb = self.vocab_size * d
        head = 0 if self.tie_embeddings else self.vocab_size * d
        total = emb + head + d  # final norm
        for kind in self.layer_kinds:
            total += 2 * d  # pre norms
            if kind in (BLOCK_FULL, BLOCK_LOCAL):
                qkv = d * (n_q * hd) + 2 * d * (n_kv * hd)
                if self.qkv_bias:
                    qkv += (n_q + 2 * n_kv) * hd
                total += qkv + (n_q * hd) * d
            elif kind == BLOCK_RGLRU:
                w = self.rnn_width or d
                # input/gate projections + recurrence params + out proj
                total += 2 * d * w + 3 * w + w * d + w * w // max(self.num_heads, 1)
            elif kind == BLOCK_RWKV6:
                w = self.rnn_width or d
                # r,k,v,g,decay projections + out proj + mix/decay/bonus vecs
                total += 5 * d * w + w * d + 7 * d
            if self.moe is not None:
                m = self.moe
                total += d * m.num_experts  # router
                total += m.num_experts * 3 * d * m.d_ff_expert
                total += m.num_shared_experts * 3 * d * m.d_ff_expert
            else:
                n_mat = 3 if self.activation in ("swiglu", "geglu") else 2
                total += n_mat * d * self.d_ff
        return total

    def active_param_count(self) -> int:
        """Activated params per token (MoE: only top_k + shared experts)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        dense_like = dataclasses.replace(self, moe=None, d_ff=0)
        base = dense_like.param_count() - 2 * self.num_layers * 0
        active_ffn = self.num_layers * (
            self.d_model * m.num_experts  # router always runs
            + (m.top_k + m.num_shared_experts) * 3 * self.d_model * m.d_ff_expert
        )
        return base + active_ffn


# ---------------------------------------------------------------------------
# Input shapes
# ---------------------------------------------------------------------------
KIND_TRAIN = "train"
KIND_PREFILL = "prefill"
KIND_DECODE = "decode"


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def tokens_per_step(self) -> int:
        if self.kind == KIND_DECODE:
            return self.global_batch  # one new token per sequence
        return self.seq_len * self.global_batch


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, KIND_TRAIN)
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, KIND_PREFILL)
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, KIND_DECODE)
LONG_500K = ShapeConfig("long_500k", 524288, 1, KIND_DECODE)

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


def shape_applicable(model: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """(applicable, reason). Encoder-only archs skip decode; pure full-attention
    archs skip long_500k (needs sub-quadratic mixing) per the assignment."""
    if shape.kind == KIND_DECODE and not model.is_decoder:
        return False, "encoder-only arch has no decode step"
    if shape.name == "long_500k" and not model.is_subquadratic:
        return False, "pure full-attention arch: 512k decode needs sub-quadratic mixing"
    if shape.kind == KIND_PREFILL and not model.is_decoder:
        # encoder forward over 32k frames is well-defined; keep it.
        return True, "encoder forward (no KV cache)"
    return True, ""


# ---------------------------------------------------------------------------
# Parallelism / runtime
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ParallelConfig:
    fsdp: bool = False           # shard params over the data axis (ZeRO-3 style)
    zero1: bool = True           # shard optimizer state over the data axis
    seq_shard: bool = False      # sequence parallelism over the data axis
    remat: str = "selective"     # none | selective | full
    scan_layers: bool = True
    expert_parallel: bool = True # shard MoE experts over the model axis
    donate_state: bool = True
    grad_compression: str = "none"  # none | int8 (error-feedback)
    overlap_collectives: bool = True  # latency-hiding pass in sharding rules
    microbatches: int = 1        # gradient-accumulation steps per train step


@dataclass(frozen=True)
class EngineConfig:
    """AsyncMemoryEngine (the paper's AMU) configuration.

    Mirrors Table 1's configuration registers: `queue_length` == number of
    outstanding request slots (paper: SPM metadata area length), `granularity`
    == bytes moved per aload/astore, `spm_bytes` == SPM capacity (paper: 64 KB
    of L2; here: the on-chip slot-ring budget).
    """
    queue_length: int = 256
    granularity: int = 64
    spm_bytes: int = 64 * 1024
    batch_ids: int = 31          # list-vector register capacity (paper: 31 IDs)
    disambiguation: str = "software"  # software | none


@dataclass(frozen=True)
class RunConfig:
    model: ModelConfig
    shape: ShapeConfig
    parallel: ParallelConfig = ParallelConfig()
    engine: EngineConfig = EngineConfig()
    seed: int = 0
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    steps: int = 200
    checkpoint_every: int = 50
    microbatch: int = 0          # 0 -> no gradient accumulation
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
