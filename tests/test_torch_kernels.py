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


@pytest.mark.parametrize("window", [0, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_head_dim_256(window, dtype):
    """recurrentgemma-9b's head size with MQA (one KV head for four query
    heads) and a window shorter than S: the plain version (what a CPU
    tensor runs) against the reference's Pallas kernel in interpret mode."""
    q, k, v = _flash_inputs(5, 1, 4, 1, 256, 256)
    jdt = getattr(jnp, dtype)
    jq, jk, jv = (jnp.array(a, jdt) for a in (q, k, v))
    tq, tk, tv = to_torch(jq), to_torch(jk), to_torch(jv)
    out = tflash.flash_attention(tq, tk, tv, causal=True, window=window)
    assert out.dtype == getattr(torch, dtype) and out.shape == tq.shape
    assert torch.equal(out, ref.attention_ref(tq, tk, tv, True, window))
    tol = FP32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(
        to_np(out), to_np(jflash(jq, jk, jv, causal=True, window=window,
                                 interpret=True)), **tol)


@pytest.mark.parametrize("dtype,d,body", [
    (torch.float32, 16, "fma"), (torch.float32, 32, "fma"),
    (torch.float32, 64, "fma"), (torch.float32, 128, "fma"),
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 16, "mma"), (torch.bfloat16, 32, "mma"),
    (torch.float32, 256, "fma"), (torch.bfloat16, 256, "wgmma"),
    # head sizes between the bodies' own run the body for Dp: fp32 always
    # on FMAs, bf16 by the 16-byte pieces of its rows (rows of no whole
    # pieces on wgmma with the element loader where Dp is 64 to 256)
    (torch.float32, 1, "fma"), (torch.float32, 80, "fma"),
    (torch.bfloat16, 8, "mma"), (torch.bfloat16, 24, "mma"),
    (torch.bfloat16, 80, "wgmma"), (torch.bfloat16, 96, "wgmma"),
    (torch.bfloat16, 192, "wgmma"), (torch.bfloat16, 1, "fma"),
    (torch.bfloat16, 7, "fma"), (torch.bfloat16, 100, "wgmma_elem"),
    (torch.bfloat16, 255, "wgmma_elem"),
    # float16 takes bfloat16's bodies; above 256 the wide bodies, in chunks
    (torch.float16, 8, "mma"), (torch.float16, 128, "wgmma"),
    (torch.float16, 100, "wgmma_elem"), (torch.float16, 512, "wgmma"),
    (torch.bfloat16, 264, "wgmma"), (torch.bfloat16, 300, "fma"),
    (torch.float32, 2048, "fma"),
    (torch.float16, 200, "wgmma"), (torch.float16, 196, "wgmma_elem"),
    (torch.float32, 100, "fma"),
    (torch.bfloat16, 33, "wgmma_elem"), (torch.bfloat16, 31, "fma")])
def test_flash_body_rule(dtype, d, body):
    """Which kernel body a launch runs is a fixed rule on (type, head size);
    `chip_smoke.py` holds the CUDA source's rule to this one at every head
    size."""
    assert tflash.body_for(dtype, d) == body


@pytest.mark.parametrize("dtype,d", [("bfloat16", 100), ("float16", 100),
                                     ("bfloat16", 196), ("float16", 255)])
def test_flash_attention_on_the_element_route(dtype, d):
    """16-bit rows of no whole 16-byte pieces at Dp 64-256, which the card
    runs on its wgmma body with the element loader: the port's wrapper (its
    plain version on the CPU) against the reference's Pallas kernel in
    interpret mode, not causal and causal with a window, GQA group 4."""
    assert tflash.body_for(getattr(torch, dtype), d) == "wgmma_elem"
    q, k, v = _flash_inputs(11 + d, 1, 8, 2, 128, d)
    jdt = getattr(jnp, dtype)
    jq, jk, jv = (jnp.array(a, jdt) for a in (q, k, v))
    tq, tk, tv = to_torch(jq), to_torch(jk), to_torch(jv)
    for causal, window in ((False, 0), (True, 40)):
        out = tflash.flash_attention(tq, tk, tv, causal=causal, window=window)
        assert out.dtype == tq.dtype and out.shape == tq.shape
        np.testing.assert_allclose(
            to_np(out), to_np(jflash(jq, jk, jv, causal=causal, window=window,
                                     block_q=64, block_k=64,
                                     interpret=True)), **BF16_TOL)


@pytest.mark.parametrize("q_dtype,kv_dtype", [
    (torch.bfloat16, torch.float32), (torch.float16, torch.bfloat16),
    (torch.float32, torch.float16)])
@pytest.mark.parametrize("d", [8, 128, 512])
def test_flash_body_rule_for_mixed_types(q_dtype, kv_dtype, d):
    """q, k, v of more than one type run the fma body on float32 copies."""
    assert tflash.body_for(q_dtype, d, kv_dtype) == "fma"


@pytest.mark.parametrize("d,dp", [(1, 16), (8, 16), (16, 16), (17, 32),
                                  (80, 128), (129, 256), (256, 256),
                                  (257, 512), (300, 512), (512, 512),
                                  (1000, 1024), (2048, 2048)])
def test_padded_head_dim_and_the_paged_body(d, dp):
    assert tflash.padded_head_dim("flash_attention", d) == dp
    assert tpaged.body_for(torch.float32, d) == (
        "tma" if d % 4 == 0 else "element")
    for dtype in (torch.bfloat16, torch.float16):
        assert tpaged.body_for(dtype, d) == (
            "tma" if d % 8 == 0 else "element")


_RULE_TYPES = (torch.float32, torch.bfloat16, torch.float16,
               torch.float8_e4m3fn, torch.float8_e5m2, torch.int8)


@pytest.mark.parametrize("q_dtype", _RULE_TYPES)
@pytest.mark.parametrize("cache_dtype", _RULE_TYPES)
def test_paged_products_rule(q_dtype, cache_dtype):
    """Where paged's two products run, at every head size 1-600: on the
    tensor cores ("mma") on the TMA ring (rows of whole 16-byte pieces) at
    a padded head size of 64 to 256, with 16-bit caches under a q of their
    type and float8 caches under a 16-bit or float8 q (read in its own
    type); fp32 FMAs ("fma") elsewhere, integer caches and any q beside
    them on float32 copies. q is read in its own type beside 16-bit and
    float8 caches if it is a float type, beside float32 caches if it is
    float32, else widened to float32. `chip_smoke.py` holds the CUDA
    source's rule (`paged_attention_products`) to this one."""
    fp8 = (torch.float8_e4m3fn, torch.float8_e5m2)
    cache = cache_dtype if cache_dtype != torch.int8 else torch.float32
    if cache != torch.float32:
        q = q_dtype if q_dtype != torch.int8 else torch.float32
    else:
        q = q_dtype if q_dtype == cache else torch.float32
    assert tpaged.kernel_types(q_dtype, cache_dtype) == (q, cache)
    for d in range(1, 601):
        dp = tflash.padded_head_dim("paged_attention", d)
        tma = d * cache.itemsize % 16 == 0
        mma = tma and 64 <= dp <= 256 and (
            (cache in (torch.bfloat16, torch.float16) and q == cache)
            or (cache in fp8 and q != torch.float32))
        assert tpaged.products_on(q_dtype, cache_dtype, d) == \
            ("mma" if mma else "fma"), d


@pytest.mark.parametrize("d,itemsize,rows,chunks", [
    (128, 2, 32, 1), (256, 4, 32, 1), (257, 2, 32, 2), (512, 2, 32, 2),
    (1024, 4, 12, 4), (2048, 2, 14, 8), (2048, 4, 7, 8)])
def test_paged_plan_above_256_columns(d, itemsize, rows, chunks):
    """Above 256 columns the head is split into chunks of 256 output
    columns, each with its own blocks (the SMs shared among them), and a
    slot row holds all of K's columns and a chunk of V's, so an aload takes
    fewer rows: at most SLOT_BYTES of them."""
    plan = tpaged.paged_plan(4, 16, 2, 1032, 512, 132, d, itemsize)
    assert (plan.rows, plan.chunks) == (rows, chunks)
    assert plan.blocks <= 132 // chunks
    if chunks > 1:
        assert plan.rows * (chunks + 1) * 256 * itemsize <= tpaged.SLOT_BYTES


def test_flash_body_rule_refuses_what_no_body_takes():
    with pytest.raises(ValueError, match="head dim 0 is not positive"):
        tflash.body_for(torch.bfloat16, 0)
    with pytest.raises(ValueError, match="head dim 0 is not positive"):
        tpaged.body_for(torch.bfloat16, 0)
    for dtype in (torch.float64, torch.int64):
        with pytest.raises(TypeError, match="takes float32, bfloat16, "):
            tflash.body_for(dtype, 64)
        with pytest.raises(TypeError, match="takes float32, bfloat16, "):
            tpaged.body_for(dtype, 64)


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


@pytest.mark.parametrize("lens", [[0, 40], [0, 0], [64, 0], [0, 1]])
def test_paged_attention_length_zero(lens):
    """A sequence of length 0 gets 0, as the reference kernel gives it (it
    skips every page); the other rows are the softmax as before."""
    rng = np.random.default_rng(6)
    q = (rng.standard_normal((2, 4, 16)) * 0.3).astype(np.float32)
    kc = (rng.standard_normal((2, 64, 2, 16)) * 0.3).astype(np.float32)
    vc = rng.standard_normal((2, 64, 2, 16)).astype(np.float32)
    lens = np.array(lens, np.int32)
    got = tpaged.paged_attention(*(to_torch(a) for a in (q, kc, vc, lens)),
                                 page=32)
    jq, jk, jv, jl = (jnp.array(a) for a in (q, kc, vc, lens))
    want = to_np(jpaged(jq, jk, jv, jl, page=32, interpret=True))
    np.testing.assert_allclose(to_np(got), want, **FP32_TOL)
    assert not np.any(to_np(got)[lens == 0])


def _split_lengths(rng, b, t):
    """Random lengths with 0 and T among them where B allows."""
    lens = rng.integers(0, t + 1, b)
    lens[0] = 0
    lens[-1] = t
    return lens


@pytest.mark.parametrize("b,hq,hkv,t,d,page", [
    (4, 16, 2, 1032, 128, 512), (3, 8, 2, 1024, 64, 256),
    (1, 4, 4, 512, 128, 512), (1, 16, 2, 32768, 128, 512),
    (128, 16, 2, 32768, 128, 512), (128, 24, 8, 300, 64, 16),
    (1, 1, 1, 1, 16, 512), (2, 4, 2, 700, 16, 64), (4, 40, 8, 1032, 128, 7),
    (4, 32, 2, 100, 32, 512)])
def test_paged_split_plan(b, hq, hkv, t, d, page):
    """The kernel's split of the valid rows, derived from `lengths` on the
    device and mirrored here: every valid (sequence, KV head, head group,
    row) is fetched exactly once, no aload fetches more than `page` rows or
    crosses a segment, the blocks share the rows evenly, and each segment's
    partials fit the workspace without overlapping another's."""
    rng = np.random.default_rng(b * 7 + t)
    lens = _split_lengths(rng, b, t)
    plan = tpaged.paged_plan(b, hq, hkv, t, page, sms=132)
    assert 1 <= plan.blocks <= 132
    assert 1 <= plan.rows <= max(1, min(page, t, tpaged.CHUNK_ROWS))
    hg = hkv * plan.ngc
    assert plan.ngc * tpaged.GC >= hq // hkv and plan.segments == b * hg
    chunks = tpaged.block_chunks(lens, t, hg, plan.blocks, plan.rows)
    total = int(np.minimum(lens, t).sum()) * hg
    per = -(-total // plan.blocks) if total else 0
    seen = {}
    blocks_of = {}
    for i, block in enumerate(chunks):
        assert sum(n for _, _, n in block) <= per
        for s, t0, n in block:
            assert 1 <= n <= plan.rows
            seen.setdefault(s, []).append((t0, n))
            blocks_of.setdefault(s, set()).add(i)
    slots = set()
    for s in range(plan.segments):
        n_valid = int(lens[s // hg])
        got = sorted(seen.get(s, []))
        row = 0
        for t0, n in got:                  # the chunks tile [0, length)
            assert t0 == row
            row += n
        assert row == n_valid
        if n_valid:
            prefix = np.concatenate([[0], np.cumsum(lens)])
            start = int(prefix[s // hg]) * hg + (s % hg) * n_valid
            first, count = tpaged.pieces(n_valid, start, per)
            assert blocks_of[s] == set(range(first, first + count))
            mine = {first + s + k for k in range(count)}
            assert not mine & slots and max(mine) < plan.blocks + plan.segments
            slots |= mine


def test_paged_locate_matches_a_linear_walk():
    prefix = [0, 0, 5, 5, 6, 20]           # lengths 0, 5, 0, 1, 14
    hg, rows = 3, []
    for b in range(5):
        n = prefix[b + 1] - prefix[b]
        rows += [(b * hg + j, t, prefix[b] * hg + (j + 1) * n)
                 for j in range(hg) for t in range(n)]
    assert [tpaged.locate(prefix, hg, g) for g in range(len(rows))] == rows


# head sizes between the bodies' own, 256, and above 256 (the wide bodies:
# 257 and 300 a chunk and a tail, 512 two whole chunks, 1024 four)
PADDED_DIMS = [1, 7, 8, 24, 80, 96, 256, 257, 300, 512, 1024]
# the bf16 limit for float16 too: its unit roundoff is 8x smaller
TOLS = {"float32": FP32_TOL, "bfloat16": BF16_TOL, "float16": BF16_TOL}


@pytest.mark.parametrize("d", PADDED_DIMS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_flash_attention_at_every_head_size(d, dtype):
    """Every head size, in every float type: the port's wrapper (its plain
    version on the CPU) against the reference's Pallas kernel in interpret
    mode, GQA group 2, a window shorter than S."""
    q, k, v = _flash_inputs(7 + d, 1, 4, 2, 128, d)
    jdt = getattr(jnp, dtype)
    jq, jk, jv = (jnp.array(a, jdt) for a in (q, k, v))
    tq, tk, tv = to_torch(jq), to_torch(jk), to_torch(jv)
    out = tflash.flash_attention(tq, tk, tv, causal=True, window=48)
    assert out.dtype == getattr(torch, dtype) and out.shape == tq.shape
    np.testing.assert_allclose(
        to_np(out), to_np(jflash(jq, jk, jv, causal=True, window=48,
                                 block_q=64, block_k=64, interpret=True)),
        **TOLS[dtype])


@pytest.mark.parametrize("d", PADDED_DIMS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_paged_attention_at_every_head_size(d, dtype):
    """The same head sizes through paged attention, lengths 0, a middle one
    and T, against the reference's Pallas kernel in interpret mode."""
    rng = np.random.default_rng(8 + d)
    jdt = getattr(jnp, dtype)
    q = jnp.array(rng.standard_normal((3, 8, d)) * 0.3, jdt)
    kc = jnp.array(rng.standard_normal((3, 96, 2, d)) * 0.3, jdt)
    vc = jnp.array(rng.standard_normal((3, 96, 2, d)), jdt)
    lens = np.array([0, 41, 96], np.int32)
    out = tpaged.paged_attention(to_torch(q), to_torch(kc), to_torch(vc),
                                 torch.from_numpy(lens), page=32)
    assert out.dtype == getattr(torch, dtype) and out.shape == (3, 8, d)
    np.testing.assert_allclose(
        to_np(out), to_np(jpaged(q, kc, vc, jnp.array(lens), page=32,
                                 interpret=True)), **TOLS[dtype])


# q of one type, k and v of another: the reference casts each operand to
# float32 in its body and returns q's type
MIXED = [("bfloat16", "float32"), ("float16", "bfloat16"),
         ("float32", "float16")]


@pytest.mark.parametrize("q_dtype,kv_dtype", MIXED)
@pytest.mark.parametrize("d", [64, 300])
def test_flash_attention_mixed_types(q_dtype, kv_dtype, d):
    q, k, v = _flash_inputs(9 + d, 1, 4, 2, 128, d)
    jq = jnp.array(q, getattr(jnp, q_dtype))
    jk, jv = (jnp.array(a, getattr(jnp, kv_dtype)) for a in (k, v))
    tq, tk, tv = to_torch(jq), to_torch(jk), to_torch(jv)
    out = tflash.flash_attention(tq, tk, tv, causal=True, window=48)
    assert out.dtype == tq.dtype and out.shape == tq.shape
    assert torch.equal(out, ref.attention_ref(tq, tk, tv, True, 48))
    np.testing.assert_allclose(
        to_np(out), to_np(jflash(jq, jk, jv, causal=True, window=48,
                                 block_q=64, block_k=64, interpret=True)),
        **TOLS[q_dtype])


@pytest.mark.parametrize("q_dtype,kv_dtype", MIXED)
@pytest.mark.parametrize("d", [64, 300])
def test_paged_attention_mixed_types(q_dtype, kv_dtype, d):
    rng = np.random.default_rng(10 + d)
    q = jnp.array(rng.standard_normal((3, 8, d)) * 0.3, getattr(jnp, q_dtype))
    kc, vc = (jnp.array(rng.standard_normal((3, 96, 2, d)) * s,
                        getattr(jnp, kv_dtype)) for s in (0.3, 1.0))
    lens = np.array([0, 41, 96], np.int32)
    tq, tk, tv = to_torch(q), to_torch(kc), to_torch(vc)
    out = tpaged.paged_attention(tq, tk, tv, torch.from_numpy(lens), page=32)
    assert out.dtype == tq.dtype and out.shape == (3, 8, d)
    np.testing.assert_allclose(
        to_np(out), to_np(jpaged(q, kc, vc, jnp.array(lens), page=32,
                                 interpret=True)), **TOLS[q_dtype])
