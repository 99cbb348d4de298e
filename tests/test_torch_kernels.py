"""The port's plain attention versions and `ops` wrappers against the JAX
reference: its `ref.py` oracles and its Pallas kernels in interpret mode, at
every parametrisation of tests/test_kernels.py. (The CUDA kernels themselves
are held against these plain versions on the card by `chip_smoke.py`.)"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops, ref as jref
from repro.kernels.flash_attention import flash_attention as jflash
from repro.kernels.paged_attention import paged_attention as jpaged
from repro_torch.kernels import ops, ref
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import paged_attention as tpaged

from test_torch_util import BF16_TOL, FP32_TOL, to_np, to_torch


def _flash_inputs(seed, b, hq, hkv, s, d):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal((b, hq, s, d)) * 0.3).astype(np.float32),
            (rng.standard_normal((b, hkv, s, d)) * 0.3).astype(np.float32),
            rng.standard_normal((b, hkv, s, d)).astype(np.float32))


@pytest.mark.parametrize("b,hq,hkv,s,d,bq,bk", [
    (2, 4, 2, 256, 64, 64, 64),
    (1, 8, 1, 128, 128, 128, 128),   # MQA
    (2, 2, 2, 512, 32, 128, 64),     # MHA, rectangular blocks
])
@pytest.mark.parametrize("window", [0, 64])
def test_flash_attention(b, hq, hkv, s, d, bq, bk, window):
    q, k, v = _flash_inputs(0, b, hq, hkv, s, d)
    jq, jk, jv = jnp.array(q), jnp.array(k), jnp.array(v)
    tq, tk, tv = to_torch(q), to_torch(k), to_torch(v)
    plain = ref.attention_ref(tq, tk, tv, causal=True, window=window)
    wrapped = tflash.flash_attention(tq, tk, tv, causal=True, window=window,
                                     block_q=bq, block_k=bk)
    assert torch.equal(plain, wrapped)       # CPU tensor -> the plain version
    np.testing.assert_allclose(
        to_np(plain), to_np(jref.attention_ref(jq, jk, jv, causal=True,
                                               window=window)), **FP32_TOL)
    np.testing.assert_allclose(
        to_np(plain), to_np(jflash(jq, jk, jv, causal=True, window=window,
                                   block_q=bq, block_k=bk, interpret=True)),
        **FP32_TOL)


def test_flash_attention_bf16():
    q, k, v = _flash_inputs(1, 1, 4, 2, 128, 64)
    jq, jk, jv = (jnp.array(a, jnp.bfloat16) for a in (q, k, v))
    tq, tk, tv = to_torch(jq), to_torch(jk), to_torch(jv)
    assert tq.dtype == torch.bfloat16
    out = tflash.flash_attention(tq, tk, tv)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(to_np(out),
                               to_np(jref.attention_ref(jq, jk, jv)),
                               **BF16_TOL)
    np.testing.assert_allclose(
        to_np(out), to_np(jflash(jq, jk, jv, block_q=64, block_k=64,
                                 interpret=True)), **BF16_TOL)


@pytest.mark.parametrize("dtype,d,body", [
    (torch.float32, 16, "fma"), (torch.float32, 32, "fma"),
    (torch.float32, 64, "fma"), (torch.float32, 128, "fma"),
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 16, "mma"), (torch.bfloat16, 32, "mma")])
def test_flash_body_rule(dtype, d, body):
    """Which kernel body a launch runs is a fixed rule on (type, head size);
    `chip_smoke.py` holds the CUDA source's rule to this one."""
    assert tflash.body_for(dtype, d) == body


def test_flash_body_rule_refuses_what_no_body_takes():
    with pytest.raises(ValueError, match="head dim"):
        tflash.body_for(torch.bfloat16, 256)
    with pytest.raises(TypeError, match="no body"):
        tflash.body_for(torch.float16, 64)


@pytest.mark.parametrize("causal,window,t", [(False, 0, 96), (True, 16, 96),
                                             (True, 0, 160)])
def test_attention_ref_tail_offset_and_masks(causal, window, t):
    """Non-causal, windowed, and T > S (queries at the sequence tail)."""
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 4, 96, 32)).astype(np.float32)
    k = rng.standard_normal((2, 2, t, 32)).astype(np.float32)
    v = rng.standard_normal((2, 2, t, 32)).astype(np.float32)
    got = ref.attention_ref(to_torch(q), to_torch(k), to_torch(v),
                            causal=causal, window=window)
    want = jref.attention_ref(jnp.array(q), jnp.array(k), jnp.array(v),
                              causal=causal, window=window)
    np.testing.assert_allclose(to_np(got), to_np(want), **FP32_TOL)


@pytest.mark.parametrize("b,hq,hkv,t,d,page", [
    (3, 8, 2, 1024, 64, 256),
    (1, 4, 4, 512, 128, 512),    # MHA
    (2, 16, 2, 2048, 64, 512),   # deep GQA
])
def test_paged_attention(b, hq, hkv, t, d, page):
    rng = np.random.default_rng(3)
    q = (rng.standard_normal((b, hq, d)) * 0.3).astype(np.float32)
    kc = (rng.standard_normal((b, t, hkv, d)) * 0.3).astype(np.float32)
    vc = rng.standard_normal((b, t, hkv, d)).astype(np.float32)
    lens = rng.integers(1, t + 1, b).astype(np.int32)
    tq, tk, tv, tl = (to_torch(a) for a in (q, kc, vc, lens))
    plain = ref.paged_attention_ref(tq, tk, tv, tl)
    assert torch.equal(plain,
                       tpaged.paged_attention(tq, tk, tv, tl, page=page))
    jq, jk, jv, jl = (jnp.array(a) for a in (q, kc, vc, lens))
    np.testing.assert_allclose(
        to_np(plain), to_np(jref.paged_attention_ref(jq, jk, jv, jl)),
        **FP32_TOL)
    np.testing.assert_allclose(
        to_np(plain), to_np(jpaged(jq, jk, jv, jl, page=page,
                                   interpret=True)), **FP32_TOL)


@pytest.mark.parametrize("window", [0, 48])
def test_ops_flash_attention_ragged(window):
    """Model-layer layout [B, S, H, D] at S = 200: the reference pads to the
    block size, the port masks the ragged edge."""
    rng = np.random.default_rng(4)
    q = (rng.standard_normal((2, 200, 4, 32)) * 0.3).astype(np.float32)
    k = (rng.standard_normal((2, 200, 2, 32)) * 0.3).astype(np.float32)
    v = rng.standard_normal((2, 200, 2, 32)).astype(np.float32)
    got = ops.flash_attention(to_torch(q), to_torch(k), to_torch(v),
                              causal=True, window=window)
    assert got.shape == (2, 200, 4, 32)
    want = jops.flash_attention(jnp.array(q), jnp.array(k), jnp.array(v),
                                causal=True, window=window)
    np.testing.assert_allclose(to_np(got), to_np(want), **FP32_TOL)


@pytest.mark.parametrize("dtype,tol", [("float32", FP32_TOL),
                                       ("bfloat16", BF16_TOL)])
def test_ops_paged_attention_ragged(dtype, tol):
    """T = 700 against page = 512: the reference pads the caches, the port
    takes any T; fp32 and bf16 caches; int64 lengths are narrowed."""
    rng = np.random.default_rng(5)
    jdt = getattr(jnp, dtype)
    q = jnp.array(rng.standard_normal((2, 8, 64)) * 0.3, jdt)
    kc = jnp.array(rng.standard_normal((2, 700, 2, 64)) * 0.3, jdt)
    vc = jnp.array(rng.standard_normal((2, 700, 2, 64)), jdt)
    lens = np.array([700, 513])
    got = ops.paged_attention(to_torch(q), to_torch(kc), to_torch(vc),
                              torch.from_numpy(lens), page=512)
    assert got.dtype == getattr(torch, dtype) and got.shape == (2, 8, 64)
    want = jops.paged_attention(q, kc, vc, jnp.array(lens), page=512)
    np.testing.assert_allclose(to_np(got), to_np(want), **tol)


@pytest.mark.parametrize("b,hq,hkv,t,page", [
    (4, 16, 2, 1032, 512), (3, 8, 2, 1024, 256), (1, 4, 4, 512, 512),
    (128, 16, 2, 32768, 512), (1, 1, 1, 1, 512), (2, 4, 2, 700, 64)])
def test_paged_split_plan(b, hq, hkv, t, page):
    """The kernel's launch plan covers the cache, never walks more than a
    page per block, and leaves no empty split."""
    nsplit, rows = tpaged.split_plan(b, hq, hkv, t, page)
    assert nsplit * rows >= t > (nsplit - 1) * rows
    assert 1 <= rows <= max(1, min(page, t))
