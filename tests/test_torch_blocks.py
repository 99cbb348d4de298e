"""`repro_torch.models.blocks` against `repro.models.blocks` on the same
numpy inputs and converted weights, fp32, atol 1e-4 (sums in another order)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import blocks as jblocks
from repro_torch import configs, convert
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import paged_attention as tpaged
from repro_torch.models import blocks, lm

from test_torch_util import random_like, to_jax, to_np, to_torch

TOL = dict(atol=1e-4, rtol=1e-4)


def _cfgs(**changes):
    """The qwen2.5-3b smoke config on both sides, with fields replaced."""
    return (dataclasses.replace(configs.get_smoke_config("qwen2.5-3b"),
                                **changes),
            dataclasses.replace(jconfigs.get_smoke_config("qwen2.5-3b"),
                                **changes))


@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_norm(norm, dtype):
    cfg, jcfg = _cfgs(norm=norm)
    rng = np.random.default_rng(0)
    p = random_like(jblocks.init_norm(jcfg, 64), rng)
    x = jnp.array(rng.standard_normal((2, 5, 64)) * 3.0, getattr(jnp, dtype))
    got = blocks.apply_norm(cfg, convert.params_from_numpy(p, device="cpu"),
                            to_torch(x))
    want = jblocks.apply_norm(jcfg, to_jax(p), x)
    assert got.dtype == getattr(torch, dtype)
    tol = TOL if dtype == "float32" else dict(atol=3e-2, rtol=3e-2)
    np.testing.assert_allclose(to_np(got), to_np(want), **tol)


@pytest.mark.parametrize("fn", ["init_norm", "init_attention", "init_mlp",
                                "rope_frequencies", "_attn_mask",
                                "positions_for"])
def test_models_take_no_default_device(fn):
    """The tensor-making helpers of `models` name their device: forgetting it
    is a TypeError, not CPU tensors beside a model on the card."""
    cfg, _ = _cfgs()
    gen = torch.Generator()
    target, args = {
        "init_norm": (blocks.init_norm, (cfg, 64, torch.float32)),
        "init_attention": (blocks.init_attention, (cfg, gen, torch.float32)),
        "init_mlp": (blocks.init_mlp, (cfg, gen, torch.float32, None)),
        "rope_frequencies": (blocks.rope_frequencies, (16, 10000.0)),
        "_attn_mask": (blocks._attn_mask, (4, 4, True, 0, 0)),
        "positions_for": (lm.positions_for, (cfg, 2, 4, 0)),
    }[fn]
    with pytest.raises(TypeError, match="device"):
        target(*args)
    with pytest.raises(TypeError):
        target(*args, "cpu")                      # keyword only
    assert target(*args, device="cpu") is not None


def test_init_norm_and_attention_shapes():
    cfg, jcfg = _cfgs(norm="layernorm")
    gen = torch.Generator().manual_seed(0)
    mine = {"norm": blocks.init_norm(cfg, 64, device="cpu"),
            "mix": blocks.init_attention(cfg, gen, device="cpu"),
            "ffn": blocks.init_mlp(cfg, gen, device="cpu")}
    key = jax.random.PRNGKey(0)
    theirs = {"norm": jblocks.init_norm(jcfg, 64),
              "mix": jblocks.init_attention(jcfg, key),
              "ffn": jblocks.init_mlp(jcfg, key)}
    a, _ = convert.flatten(mine)
    b = jax.tree.leaves(theirs)
    assert [tuple(t.shape) for t in a] == [tuple(t.shape) for t in b]
    # 1/sqrt(in_dim) scaling of the dense init
    assert abs(float(mine["mix"]["wq"].std()) - 1 / 8) < 0.02


@pytest.mark.parametrize("theta", [10000.0, 1000000.0])
def test_apply_rope(theta):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 8, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 5000, (2, 8))
    got = blocks.apply_rope(to_torch(x), torch.from_numpy(pos), theta)
    want = jblocks.apply_rope(jnp.array(x), jnp.array(pos), theta)
    np.testing.assert_allclose(to_np(got), to_np(want), atol=2e-5)


def test_apply_rope_bf16_casts_cos_sin_first():
    rng = np.random.default_rng(2)
    x = jnp.array(rng.standard_normal((1, 6, 2, 32)), jnp.bfloat16)
    pos = np.arange(6)[None] + 100
    got = blocks.apply_rope(to_torch(x), torch.from_numpy(pos), 10000.0)
    want = jblocks.apply_rope(x, jnp.array(pos), 10000.0)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(to_np(got), to_np(want), atol=3e-2)


def test_apply_mrope():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 8, 4, 16)).astype(np.float32)
    pos3 = rng.integers(0, 64, (3, 2, 8))
    got = blocks.apply_rope(to_torch(x), torch.from_numpy(pos3), 10000.0,
                            mrope_sections=(2, 3, 3))
    want = jblocks.apply_rope(jnp.array(x), jnp.array(pos3), 10000.0,
                              mrope_sections=(2, 3, 3))
    np.testing.assert_allclose(to_np(got), to_np(want), atol=2e-5)
    # three position streams but no sections: the first stream is used
    got = blocks.apply_rope(to_torch(x), torch.from_numpy(pos3), 10000.0)
    want = jblocks.apply_rope(jnp.array(x), jnp.array(pos3), 10000.0)
    np.testing.assert_allclose(to_np(got), to_np(want), atol=2e-5)


def test_mrope_text_equals_rope():
    """For pure text (three equal position streams), M-RoPE == RoPE."""
    x = to_torch(np.random.default_rng(0).standard_normal((2, 8, 4, 16))
                 .astype(np.float32))
    pos = torch.arange(8)[None].expand(2, 8)
    pos3 = torch.stack([pos, pos, pos])
    a = blocks.apply_rope(x, pos, 10000.0)
    b = blocks.apply_rope(x, pos3, 10000.0, mrope_sections=(2, 3, 3))
    np.testing.assert_allclose(to_np(a), to_np(b), atol=1e-6)


@pytest.mark.parametrize("activation", ["swiglu", "geglu", "gelu"])
def test_apply_mlp(activation):
    cfg, jcfg = _cfgs(activation=activation)
    rng = np.random.default_rng(4)
    p = random_like(jblocks.init_mlp(jcfg, jax.random.PRNGKey(0)), rng)
    x = rng.standard_normal((2, 7, 64)).astype(np.float32)
    got = blocks.apply_mlp(cfg, convert.params_from_numpy(p, device="cpu"),
                           to_torch(x))
    want = jblocks.apply_mlp(jcfg, to_jax(p), jnp.array(x))
    assert set(p) == set(blocks.init_mlp(cfg, torch.Generator(),
                                         device="cpu"))
    np.testing.assert_allclose(to_np(got), to_np(want), **TOL)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 24), (False, 0)])
def test_chunked_attention_matches_naive(causal, window):
    """The chunked path equals the reference's chunked path and the plain
    masked softmax, with chunks smaller than the sequence."""
    rng = np.random.default_rng(5)
    q = (rng.standard_normal((2, 64, 4, 16)) * 0.5).astype(np.float32)
    k = (rng.standard_normal((2, 64, 4, 16)) * 0.5).astype(np.float32)
    v = rng.standard_normal((2, 64, 4, 16)).astype(np.float32)
    old, jold = dict(blocks.ATTN_CONFIG), dict(jblocks.ATTN_CONFIG)
    try:
        blocks.ATTN_CONFIG.update(q_chunk=16, kv_chunk=32)
        jblocks.ATTN_CONFIG.update(q_chunk=16, kv_chunk=32)
        got = blocks._chunked_attention(to_torch(q), to_torch(k), to_torch(v),
                                        causal, window)
        want = jblocks._chunked_attention(jnp.array(q), jnp.array(k),
                                          jnp.array(v), causal, window)
    finally:
        blocks.ATTN_CONFIG.update(old)
        jblocks.ATTN_CONFIG.update(jold)
    np.testing.assert_allclose(to_np(got), to_np(want), **TOL)
    from repro_torch.kernels import ref
    naive = ref.attention_ref(to_torch(q).transpose(1, 2),
                              to_torch(k).transpose(1, 2),
                              to_torch(v).transpose(1, 2), causal, window)
    np.testing.assert_allclose(to_np(got), to_np(naive.transpose(1, 2)),
                               **TOL)


def _attention_setup(seed, S, **changes):
    cfg, jcfg = _cfgs(**changes)
    rng = np.random.default_rng(seed)
    p = random_like(jblocks.init_attention(jcfg, jax.random.PRNGKey(0)), rng)
    x = rng.standard_normal((2, S, 64)).astype(np.float32)
    return cfg, jcfg, rng, p, x


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("window", [0, 32])
def test_attention_prefill(use_kernels, window):
    """S = 128: with use_kernels both sides go through flash_attention (the
    reference in interpret mode, the port through its wrapper)."""
    cfg, jcfg, rng, p, x = _attention_setup(6, 128)
    pos = np.broadcast_to(np.arange(128)[None], (2, 128))
    before = tflash.launches
    got, kv = blocks.attention(cfg, convert.params_from_numpy(p, device="cpu"),
                               to_torch(x), torch.from_numpy(pos.copy()),
                               window=window,
                               use_kernels=use_kernels, return_kv=True)
    want, jkv = jblocks.attention(jcfg, to_jax(p), jnp.array(x),
                                  jnp.array(pos), window=window,
                                  use_kernels=use_kernels, return_kv=True)
    assert tflash.launches == before          # no CUDA launch on the CPU
    np.testing.assert_allclose(to_np(got), to_np(want), **TOL)
    for a, b in zip(kv, jkv):
        np.testing.assert_allclose(to_np(a), to_np(b), **TOL)


def test_attention_long_sequence_takes_chunked_path():
    cfg, jcfg, rng, p, x = _attention_setup(7, 64, qkv_bias=False)
    pos = np.broadcast_to(np.arange(64)[None], (2, 64))
    old, jold = dict(blocks.ATTN_CONFIG), dict(jblocks.ATTN_CONFIG)
    try:
        for c in (blocks.ATTN_CONFIG, jblocks.ATTN_CONFIG):
            c.update(chunk_threshold=1, q_chunk=16, kv_chunk=16)
        got, _ = blocks.attention(
            cfg, convert.params_from_numpy(p, device="cpu"), to_torch(x),
            torch.from_numpy(pos.copy()))
        want, _ = jblocks.attention(jcfg, to_jax(p), jnp.array(x),
                                    jnp.array(pos))
    finally:
        blocks.ATTN_CONFIG.update(old)
        jblocks.ATTN_CONFIG.update(jold)
    np.testing.assert_allclose(to_np(got), to_np(want), **TOL)


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("S", [1, 3])
def test_attention_cached_decode(use_kernels, S):
    """New tokens scattered at cache_len (different per row), then attention
    over the valid prefix; S == 1 with use_kernels is the paged kernel."""
    cfg, jcfg, rng, p, x = _attention_setup(8, S)
    T = 40
    ck = (rng.standard_normal((2, T, 2, 16)) * 0.5).astype(np.float32)
    cv = rng.standard_normal((2, T, 2, 16)).astype(np.float32)
    cache_len = np.array([17, 30], np.int32)
    pos = cache_len[:, None] + np.arange(S)[None]
    tk, tv = to_torch(ck), to_torch(cv)
    before = tpaged.launches
    got, new = blocks.attention(cfg, convert.params_from_numpy(p, device="cpu"),
                                to_torch(x), torch.from_numpy(pos),
                                kv_cache=(tk, tv),
                                cache_len=torch.from_numpy(cache_len),
                                use_kernels=use_kernels)
    want, jnew = jblocks.attention(jcfg, to_jax(p), jnp.array(x),
                                   jnp.array(pos),
                                   kv_cache=(jnp.array(ck), jnp.array(cv)),
                                   cache_len=jnp.array(cache_len),
                                   use_kernels=use_kernels)
    assert tpaged.launches == before
    np.testing.assert_allclose(to_np(got), to_np(want), **TOL)
    # the port writes the cache in place and hands the same tensors back
    assert new[0] is tk and new[1] is tv
    np.testing.assert_allclose(to_np(tk), to_np(jnew[0]), **TOL)
    np.testing.assert_allclose(to_np(tv), to_np(jnew[1]), **TOL)
    assert not np.array_equal(to_np(tk), ck)
