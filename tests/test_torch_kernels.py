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


def _caches(dtype, b, t, hkv, d, pad=0, offset=0):
    """k and v [b, t, hkv, d] of `dtype`: heads `pad` elements apart
    beyond d (strided heads), the start `offset` elements in."""
    n = b * t * hkv * (d + pad)
    flat = torch.zeros(2 * (n + offset + 64), dtype=dtype)
    k, v = (flat[i * (n + offset + 64) + offset:][:n].view(
        b, t, hkv, d + pad)[..., :d] for i in (0, 1))
    return k, v


# (cache type, q type, D, Hq, Hkv, pad, offset, route, KV heads a box):
# runs of heads by TMA where one head's row is no whole 16-byte pieces but
# a run of them is (fp8 D8 at Hkv2: a token's two heads for segments of
# one; D100 at Hkv16: 8 heads, a segment's), and the copy where no run is
# (fp8 D100 at Hkv2: a token of 200 bytes; Hkv1 at fp8 D8; odd Hkv * D),
# the heads are strided or a start is not on 16 bytes
_ROUTES = [
    (torch.float8_e4m3fn, torch.float8_e4m3fn, 8, 16, 2, 0, 0, "run", 2),
    (torch.float8_e5m2, torch.bfloat16, 8, 16, 2, 0, 0, "run", 2),
    (torch.float8_e4m3fn, torch.float8_e4m3fn, 8, 16, 1, 0, 0, "element", 0),
    (torch.float8_e4m3fn, torch.float8_e4m3fn, 100, 16, 2, 0, 0, "element",
     0),
    (torch.float8_e5m2, torch.float8_e5m2, 100, 16, 16, 0, 0, "run", 8),
    (torch.bfloat16, torch.bfloat16, 100, 16, 16, 0, 0, "run", 8),
    (torch.float16, torch.float16, 100, 16, 2, 0, 0, "run", 2),
    (torch.bfloat16, torch.bfloat16, 100, 32, 2, 0, 0, "run", 2),
    (torch.bfloat16, torch.float32, 100, 16, 16, 0, 0, "run", 8),
    (torch.bfloat16, torch.bfloat16, 100, 16, 16, 4, 0, "element", 0),
    (torch.float16, torch.float16, 100, 16, 16, 0, 1, "element", 0),
    (torch.bfloat16, torch.bfloat16, 7, 8, 1, 0, 0, "element", 0),
    (torch.bfloat16, torch.bfloat16, 7, 12, 4, 0, 0, "element", 0),
    (torch.bfloat16, torch.bfloat16, 7, 16, 16, 0, 0, "run", 8),
    (torch.float32, torch.float32, 7, 16, 16, 0, 0, "run", 8),
    (torch.float32, torch.float32, 7, 16, 2, 0, 0, "element", 0),
    (torch.bfloat16, torch.bfloat16, 128, 16, 2, 0, 0, "tma", 0),
    (torch.bfloat16, torch.bfloat16, 300, 16, 16, 0, 0, "element", 0),
]


@pytest.mark.parametrize("dtype,q_dtype,d,hq,hkv,pad,offset,want,box",
                         _ROUTES)
def test_paged_route_over_runs_of_heads(dtype, q_dtype, d, hq, hkv, pad,
                                        offset, want, box):
    """How a call loads rows of no whole 16-byte pieces (`route`): by TMA
    boxes of a run of `run_heads` KV heads of a token over the caches'
    [B, T, Hkv * D] view where the heads are contiguous, the other strides
    and the starts multiples of 16 bytes and the run's row whole pieces,
    else by the producer warp's copy. `chip_smoke.py` holds the CUDA
    source's `paged_attention_run` to `run_heads`."""
    k, v = _caches(dtype, 2, 40, hkv, d, pad, offset)
    q = torch.zeros((2, hq, d), dtype=q_dtype)
    assert tpaged.route(q, k, v) == want
    strides, aligned = tpaged.cache_facts(k, v)
    assert aligned == (offset * dtype.itemsize % 16 == 0)
    assert tpaged.run_heads(q_dtype, dtype, d, hq, hkv, strides,
                            aligned) == box
    if box:
        heads = tpaged.kv_heads(q_dtype, dtype, d, hq, hkv)
        assert box % heads == 0 and hkv % box == 0
        assert box * d * dtype.itemsize % 16 == 0
        w = tpaged.box_width(box * d, dtype.itemsize)
        assert w <= 256 and box * d % w == 0 and box * d // w <= 256
        assert w * dtype.itemsize % 16 == 0


@pytest.mark.parametrize("n,itemsize,w", [
    (16, 1, 16), (800, 2, 200), (800, 1, 160), (56, 2, 56), (2040, 4, 204),
    (4080, 1, 240), (256, 2, 256), (264, 2, 88)])
def test_paged_box_width(n, itemsize, w):
    """A run's TMA box: the widest divisor of n of at most 256 elements and
    whole 16-byte pieces, at most 256 of them across."""
    assert tpaged.box_width(n, itemsize) == w


_RULE_TYPES = (torch.float32, torch.bfloat16, torch.float16,
               torch.float8_e4m3fn, torch.float8_e5m2, torch.int8)


@pytest.mark.parametrize("q_dtype", _RULE_TYPES)
@pytest.mark.parametrize("cache_dtype", _RULE_TYPES)
def test_paged_products_rule(q_dtype, cache_dtype):
    """Where paged's two products run, at every head size 1-600: on the
    tensor cores ("mma") on the TMA ring (rows of whole 16-byte pieces),
    with 16-bit caches under a q of their type at a padded head size of 64
    to 256 and of 512 (256 < D <= 512: the whole head a block) and float8
    caches under a 16-bit or float8 q (read in its own type) at 64 to 256;
    fp32 FMAs ("fma") elsewhere, integer caches and any q beside
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
        mma = tma and dp >= 64 and (
            (cache in (torch.bfloat16, torch.float16) and q == cache
             and dp <= 512)
            or (cache in fp8 and q != torch.float32 and dp <= 256))
        assert tpaged.products_on(q_dtype, cache_dtype, d) == \
            ("mma" if mma else "fma"), d


@pytest.mark.parametrize("d,itemsize,rows,chunks", [
    (128, 2, 32, 1), (256, 4, 32, 1), (257, 2, 32, 1), (512, 2, 32, 1),
    (1024, 4, 32, 1), (2048, 2, 32, 1), (2048, 4, 32, 1), (264, 2, 32, 1),
    (300, 4, 32, 1), (512, 4, 32, 1), (520, 2, 32, 1), (1024, 2, 32, 1),
    (2049, 4, 32, 2), (4096, 2, 32, 2), (4352, 4, 32, 3)])
def test_paged_plan_above_256_columns(d, itemsize, rows, chunks):
    """Above 256 columns a block takes the whole head. On FMAs (fp32
    caches, 16-bit rows of no whole 16-byte pieces, D > 512: the wide
    body) an aload is one piece of 256 columns of K or of V, so it keeps
    its 32 rows at every head size, and the head is one chunk up to 2048
    columns (K read once), chunks of 2048 above, each with its own blocks
    (the SMs shared among them). 16-bit rows of whole pieces up to 512
    columns (bf16 here, q of its type) run on the tensor cores, a slot row
    all of K's and V's 512 columns: at most SLOT_BYTES of them, 32 rows."""
    dtype = {2: torch.bfloat16, 4: torch.float32}[itemsize]
    products = tpaged.products_on(dtype, dtype, d, 16, 2)
    if d > 256:
        assert (products == "mma") == (itemsize == 2 and d <= 512
                                       and d % 8 == 0)
    plan = tpaged.paged_plan(4, 16, 2, 1032, 512, 132, d, itemsize,
                             products=products)
    assert (plan.rows, plan.chunks) == (rows, chunks)
    assert plan.blocks <= 132 // chunks
    dp = tflash.padded_head_dim("paged_attention", d)
    if products == "mma":
        assert plan.rows * 2 * dp * itemsize <= tpaged.SLOT_BYTES
    elif d > 256:
        assert plan.chunks == -(-(dp // 256) // tpaged.WIDE_PIECES)
        assert plan.rows * 256 * itemsize <= 32768     # a slot: one piece


@pytest.mark.parametrize("q_dtype,cache_dtype,d,hq,hkv,want", [
    (torch.bfloat16, torch.bfloat16, 512, 16, 2, "mma"),
    (torch.float16, torch.float16, 512, 16, 2, "mma"),
    (torch.bfloat16, torch.bfloat16, 264, 16, 2, "mma"),
    (torch.float16, torch.float16, 504, 16, 1, "mma"),
    (torch.bfloat16, torch.bfloat16, 384, 4, 4, "mma"),
    (torch.bfloat16, torch.bfloat16, 304, 32, 2, "mma"),
    (torch.bfloat16, torch.bfloat16, 520, 16, 2, "fma"),
    (torch.bfloat16, torch.bfloat16, 1024, 16, 2, "fma"),
    (torch.bfloat16, torch.bfloat16, 257, 16, 2, "fma"),
    (torch.float16, torch.float16, 500, 16, 2, "fma"),
    (torch.float32, torch.float32, 512, 16, 2, "fma"),
    (torch.float8_e4m3fn, torch.float8_e4m3fn, 512, 16, 2, "fma"),
    (torch.bfloat16, torch.float8_e5m2, 512, 16, 2, "fma"),
    (torch.float32, torch.bfloat16, 512, 16, 2, "fma"),
    (torch.float16, torch.bfloat16, 512, 16, 2, "fma"),
    (torch.int8, torch.int8, 512, 16, 2, "fma")])
def test_paged_whole_head_on_the_tensor_cores(q_dtype, cache_dtype, d, hq,
                                              hkv, want):
    """Above 256 columns the tensor-core body takes the whole head a block
    (one chunk, K read once) for bf16 and f16 caches under a q of their
    type whose rows are whole 16-byte pieces, up to 512 columns; fp32 and
    float8 caches, a q of another type, integers, rows of no whole pieces
    (257, 500 in 16 bits) and heads above 512 take the wide body on FMAs,
    which also takes the whole head a block (its pieces through the ring):
    one chunk either way up to 2048 columns."""
    assert tpaged.products_on(q_dtype, cache_dtype, d, hq, hkv) == want
    assert tpaged.kv_heads(q_dtype, cache_dtype, d, hq, hkv) == 1
    assert tpaged.query_heads(q_dtype, cache_dtype, d, hq, hkv) == 8
    _, kv = tpaged.kernel_types(q_dtype, cache_dtype)
    plan = tpaged.paged_plan(4, hq, hkv, 1032, 512, 132, d, kv.itemsize,
                             products=want)
    assert plan.chunks == 1
    assert plan.segments == 4 * hkv * -(-(hq // hkv) // 8)


@pytest.mark.parametrize("dtype,d,blocks", [
    (torch.bfloat16, 256, 1), (torch.bfloat16, 264, 1),
    (torch.float16, 304, 1), (torch.bfloat16, 512, 1),
    (torch.bfloat16, 520, 2), (torch.float16, 1024, 2),
    (torch.bfloat16, 1032, 3), (torch.bfloat16, 2048, 4),
    (torch.bfloat16, 500, 2),
    (torch.float32, 512, 2), (torch.float8_e4m3fn, 512, 2),
    (torch.float32, 64, 1), (torch.int8, 300, 2),
    (torch.float32, 1024, 4), (torch.float32, 2048, 8),
    (torch.float32, 2304, 16), (torch.float32, 4352, 24),
    (torch.bfloat16, 2306, 16), (torch.float16, 4096, 8)])
def test_flash_wide_blocks(dtype, d, blocks):
    """Blocks a (head, query tile) above 256 columns (`wide_blocks`): in
    the wgmma body one a 512-column chunk of the output (the pair body: two
    consumer warpgroups of 256 columns add their parts of Q K^T), in the
    fma body (fp32, integers, fp8 and 16-bit rows of no whole 16-byte
    pieces: bf16 D500) the CTAs of its clusters, one a 256-column piece,
    8 a chunk of 2048 columns above 2048. `chip_smoke.py` holds the CUDA
    source's `flash_attention_wide_blocks` to it."""
    assert tflash.wide_blocks(dtype, d) == blocks


@pytest.mark.parametrize("dtype,d,cluster,passes", [
    (torch.float32, 256, 1, 1), (torch.float32, 257, 2, 1),
    (torch.float32, 512, 2, 1), (torch.float32, 513, 3, 1),
    (torch.float32, 1100, 5, 1), (torch.float32, 2048, 8, 1),
    (torch.float32, 2049, 8, 2), (torch.float32, 2304, 8, 2),
    (torch.float32, 4352, 8, 3), (torch.int8, 1024, 4, 1),
    (torch.bfloat16, 500, 2, 1), (torch.float8_e5m2, 640, 3, 1),
    (torch.bfloat16, 512, 1, 1), (torch.bfloat16, 2048, 1, 4),
    (torch.float16, 128, 1, 1)])
def test_flash_fma_cluster_and_passes(dtype, d, cluster, passes):
    """CTAs a cluster (`fma_cluster`): in the fma body above 256 columns
    one a 256-column piece of the head, 8 at most; 1 elsewhere. Q K^T passes
    a query tile (`qk_passes`): one up to 2048 columns in the fma body (512
    in the pair body), one a chunk above. `chip_smoke.py` holds the
    source's `flash_attention_cluster` to it."""
    assert tflash.fma_cluster(dtype, d) == cluster
    assert tflash.qk_passes(dtype, d) == passes
    if tflash.body_for(dtype, d) == "fma" and d > 256:
        assert tflash.wide_blocks(dtype, d) == cluster * passes


@pytest.mark.parametrize("dtype,d,b,hq,s,sms,rows", [
    (torch.int8, 64, 2, 8, 200, 132, 64),      # 32 blocks of 128 rows
    (torch.int8, 64, 2, 8, 1100, 132, 128),    # 144
    (torch.float32, 128, 4, 16, 1000, 132, 128),   # qwen2.5-3b's prefill
    (torch.float32, 128, 1, 66, 256, 132, 128),    # 132 blocks: a wave
    (torch.float32, 128, 1, 131, 128, 132, 64),
    (torch.float32, 128, 1, 66, 256, 133, 64),
    (torch.float32, 100, 2, 8, 200, 132, 64),      # Dp 128
    (torch.float32, 64, 1, 1, 1, 1, 128),          # one block, one SM
    (torch.float32, 32, 1, 1, 100, 132, 128),      # Dp 32: 128 always
    (torch.float32, 16, 1, 1, 100, 132, 128),
    (torch.float32, 256, 4, 16, 1000, 132, 64),
    (torch.float32, 512, 1, 1, 10, 132, 64),
    (torch.bfloat16, 12, 1, 1, 10, 132, 128),      # fp8 / 16-bit at Dp 16
    (torch.bfloat16, 64, 1, 1, 10, 132, 0),        # the wgmma body
    (torch.int16, 128, 2, 8, 200, 132, 64)])
def test_flash_fma_rows(dtype, d, b, hq, s, sms, rows):
    """Query rows a block of the fma body (`fma_rows`): 64 at Dp 64 and 128
    where 128-row tiles give fewer blocks than the card has SMs, else 128;
    128 at Dp 16 and 32, 64 at 256 and above; 0 where another body runs.
    `chip_smoke.py` holds the source's `flash_attention_fma_rows` to it
    over a grid of (B, Hq, S)."""
    assert tflash.fma_rows(dtype, d, b, hq, s, sms) == rows


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
    (4, 32, 2, 100, 32, 512), (4, 16, 1, 4128, 256, 512),
    (4, 12, 1, 700, 208, 64), (3, 32, 2, 300, 256, 16),
    (5, 24, 1, 1032, 144, 512), (4, 16, 1, 4128, 128, 512)])
def test_paged_split_plan(b, hq, hkv, t, d, page):
    """The kernel's split of the valid rows, derived from `lengths` on the
    device and mirrored here: every valid (sequence, KV head, head group,
    row) is fetched exactly once, no aload fetches more than `page` rows or
    crosses a segment, the blocks share the rows evenly, and each segment's
    partials fit the workspace without overlapping another's. bf16 caches:
    above 8 query heads a KV head on the tensor cores at a padded head size
    of 256 a group is 16 heads (`query_heads`), so at up to 16 every valid
    row of a KV head is fetched once."""
    rng = np.random.default_rng(b * 7 + t)
    lens = _split_lengths(rng, b, t)
    g = hq // hkv
    group = tpaged.query_heads(torch.bfloat16, torch.bfloat16, d, hq, hkv)
    mma256 = d * 2 % 16 == 0 and tflash.padded_head_dim(
        "paged_attention", d) == 256
    assert group == (2 * tpaged.GC if g > tpaged.GC and mma256
                     else tpaged.GC)
    plan = tpaged.paged_plan(b, hq, hkv, t, page, sms=132, group=group)
    assert 1 <= plan.blocks <= 132
    assert 1 <= plan.rows <= max(1, min(page, t, tpaged.CHUNK_ROWS))
    hg = hkv * plan.ngc
    assert plan.group == group and plan.ngc == -(-g // group)
    assert plan.ngc * group >= g and plan.segments == b * hg
    if group > tpaged.GC and g <= group:   # each KV head's rows once
        assert plan.ngc == 1 and plan.segments == b * hkv
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


# (Hq, Hkv) layouts at which the split rules are held: G of 1 to 32, KV
# heads that 8 / G does not divide, and groups of 16 query heads that are
# not whole or more than one
_LAYOUTS = ((16, 16), (16, 8), (16, 4), (16, 2), (16, 1), (6, 6), (12, 6),
            (3, 3), (20, 4), (24, 8), (12, 1), (32, 2), (24, 1))
_RULE_DIMS = list(range(1, 1101)) + [2048]


@pytest.mark.parametrize("hq,hkv", _LAYOUTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16, torch.float8_e4m3fn,
                                   torch.float8_e5m2])
def test_paged_heads_and_products_rule(hq, hkv, dtype):
    """KV heads a segment (`kv_heads`) and where the products run
    (`products_on`), q of the caches' type, at every head size from 1 to
    1100 and 2048: below 8 query heads a KV head (G dividing 8), 16-bit
    caches on the TMA ring at a padded head size of 64 to 256 take 8 / G
    KV heads a segment (halved until it divides Hkv), on FMAs, at G = 1
    and, where the head size is not the padded one, at G of 2 and 4, and
    so do rows of no whole 16-byte pieces in every type at every G
    dividing 8 up to a padded head size of 256;
    elsewhere one, on mma.sync where `products` took it before (16-bit
    caches also at a padded head size of 512, the whole head a block, and
    the wide body's FMAs above it); above 8
    query heads a KV head on mma.sync at a padded head size of 256 a
    segment serves 16 of them (`query_heads`), else 8. `chip_smoke.py`
    holds the CUDA source's rules (`paged_attention_heads`,
    `paged_attention_products`, `paged_attention_group`) to these."""
    g = hq // hkv
    for d in _RULE_DIMS:
        dp = tflash.padded_head_dim("paged_attention", d)
        tma = d * dtype.itemsize % 16 == 0
        heads = 1
        if g < 8 and 8 % g == 0 and dp <= 256 and (not tma or (
                dtype in (torch.bfloat16, torch.float16) and dp >= 64
                and (g == 1 or d != dp))):
            heads = 8 // g
            while hkv % heads:
                heads //= 2
        mma = tma and dp >= 64 and (
            (dtype in (torch.float8_e4m3fn, torch.float8_e5m2)
             and dp <= 256)
            or (dtype in (torch.bfloat16, torch.float16) and heads == 1
                and dp <= 512))
        assert tpaged.kv_heads(dtype, dtype, d, hq, hkv) == heads, d
        assert tpaged.products_on(dtype, dtype, d, hq, hkv) == (
            "mma" if mma else "fma"), d
        assert tpaged.query_heads(dtype, dtype, d, hq, hkv) == (
            16 if mma and g > 8 and dp == 256 else 8), d


@pytest.mark.parametrize("g", [1, 2, 8, 16])
@pytest.mark.parametrize("b,hkv,t,d,page", [
    (4, 16, 1032, 80, 512), (3, 8, 300, 64, 16), (2, 4, 700, 128, 64),
    (5, 2, 64, 256, 512), (1, 16, 4096, 80, 512)])
def test_paged_split_in_segments_of_several_kv_heads(g, b, hkv, t, d, page):
    _check_split_of_segments(g, b, hkv, t, d, page, torch.bfloat16)


@pytest.mark.parametrize("g", [1, 2, 8, 16])
@pytest.mark.parametrize("b,hkv,t,d,page,dtype", [
    (4, 16, 1032, 100, 512, torch.bfloat16),
    (4, 2, 1032, 100, 512, torch.float16),
    (4, 2, 1032, 8, 512, torch.float8_e4m3fn),
    (3, 16, 300, 100, 16, torch.float8_e5m2),
    (2, 8, 333, 7, 64, torch.float32)])
def test_paged_split_of_element_rows(g, b, hkv, t, d, page, dtype):
    """The same for rows of no whole 16-byte pieces (the body of unpadded
    slots, `route` "run" or "element"), which take segments of several KV
    heads in every type below 8 query heads a KV head, and whose slot rows
    hold `run_heads` KV heads where a run of them is whole pieces (fp8 D8
    at Hkv2: both KV heads of a token, for segments of one)."""
    _check_split_of_segments(g, b, hkv, t, d, page, dtype)


def _check_split_of_segments(g, b, hkv, t, d, page, dtype):
    """The split where a segment takes several KV heads (below 8 query
    heads a KV head), bf16: `block_chunks`, `locate` and `pieces` against a
    brute-force walk of the rows. The walk lays out, sequence by sequence,
    each run of `PagedPlan.heads` KV heads and its valid rows; the blocks'
    chunks must be that order cut into runs of ceil(W / blocks) rows, every
    (sequence, KV head, row) fetched once, no chunk past `rows` rows or
    across a segment, an aload within HEADS_SLOT_BYTES, and each segment's
    partials at the blocks that hold its rows. At 16 query heads a KV head
    and a padded head size of 256 a segment serves all 16 (`query_heads`):
    each valid row of a KV head is fetched once, not once for each group of
    8."""
    hq = g * hkv
    rng = np.random.default_rng(g * 31 + b * 7 + t)
    lens = _split_lengths(rng, b, t)
    heads = tpaged.kv_heads(dtype, dtype, d, hq, hkv)
    padded = d != tflash.padded_head_dim("paged_attention", d)
    assert heads == (min(8 // g, hkv) if g == 1 or g < 8 and padded else 1)
    group = tpaged.query_heads(dtype, dtype, d, hq, hkv)
    assert group == (16 if g == 16 and d == 256 else 8)
    cache = torch.empty((b, t, hkv, d), dtype=dtype)
    box = tpaged.run_heads(dtype, dtype, d, hq, hkv,
                           *tpaged.cache_facts(cache, cache))
    element = tpaged.body_for(dtype, d) == "element"
    assert box == 0 or (element and box % heads == 0)
    plan = tpaged.paged_plan(b, hq, hkv, t, page, 132, d, dtype.itemsize,
                             heads, group, box)
    assert plan.box_heads == (box or heads)
    hg = hkv // heads * plan.ngc
    assert plan.heads == heads and plan.segments == b * hg
    assert plan.ngc * plan.group >= g and (heads == 1
                                           or heads * g <= tpaged.GC)
    assert plan.ngc == 1 or g > plan.group
    assert 1 <= plan.rows <= min(page, t, tpaged.CHUNK_ROWS)
    if plan.box_heads > 1 or element:
        assert (2 * plan.rows * plan.box_heads * d * dtype.itemsize
                <= tpaged.HEADS_SLOT_BYTES)
    walk = [(i, j, r) for i in range(b) for j in range(hg)
            for r in range(int(lens[i]))]
    chunks = tpaged.block_chunks(lens, t, hg, plan.blocks, plan.rows)
    per = -(-len(walk) // plan.blocks) if walk else 0
    got, holders = [], {}
    for blk, block in enumerate(chunks):
        assert len(got) == min(blk * per, len(walk))
        for s, t0, n in block:
            assert 1 <= n <= plan.rows and t0 + n <= int(lens[s // hg])
            got += [(s // hg, s % hg, t0 + r) for r in range(n)]
            holders.setdefault(s, set()).add(blk)
    assert got == walk
    ngc = plan.ngc                     # (heads > 1: one group of 8)
    fetched = sorted((i, j // ngc * heads + kv, j % ngc, r)
                     for i, j, r in got for kv in range(heads))
    assert fetched == sorted((i, h, grp, r) for i in range(b)
                             for h in range(hkv) for grp in range(ngc)
                             for r in range(int(lens[i])))
    prefix = [0] + list(np.cumsum(lens))
    for row, (i, j, r) in enumerate(walk):
        assert tpaged.locate(prefix, hg, row) == (
            i * hg + j, r, prefix[i] * hg + (j + 1) * int(lens[i]))
    for s, blocks in holders.items():
        n = int(lens[s // hg])
        first, count = tpaged.pieces(n, prefix[s // hg] * hg + s % hg * n,
                                     per)
        assert blocks == set(range(first, first + count))


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


@pytest.mark.parametrize("hq,hkv,d", [(4, 4, 80), (4, 4, 64), (8, 4, 96),
                                      (8, 2, 80), (6, 6, 128)])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_paged_attention_at_one_to_four_query_heads_a_kv_head(hq, hkv, d,
                                                               dtype):
    """Layouts whose segments take several KV heads on the card (G = 1,
    and G of 2 and 4 below a padded head size; `kv_heads`), lengths 0, a
    middle one and T: the wrapper's
    plain version against the reference's Pallas kernel in interpret
    mode."""
    assert tpaged.kv_heads(getattr(torch, dtype), getattr(torch, dtype), d,
                           hq, hkv) > 1
    rng = np.random.default_rng(hq * 13 + d)
    jdt = getattr(jnp, dtype)
    q = jnp.array(rng.standard_normal((3, hq, d)) * 0.3, jdt)
    kc = jnp.array(rng.standard_normal((3, 96, hkv, d)) * 0.3, jdt)
    vc = jnp.array(rng.standard_normal((3, 96, hkv, d)), jdt)
    lens = np.array([0, 41, 96], np.int32)
    out = tpaged.paged_attention(to_torch(q), to_torch(kc), to_torch(vc),
                                 torch.from_numpy(lens), page=32)
    assert out.dtype == getattr(torch, dtype) and out.shape == (3, hq, d)
    np.testing.assert_allclose(
        to_np(out), to_np(jpaged(q, kc, vc, jnp.array(lens), page=32,
                                 interpret=True)), **TOLS[dtype])


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


@pytest.mark.parametrize("dtype,d,hq,hkv,pad", [
    ("bfloat16", 100, 8, 8, 0), ("float16", 100, 16, 2, 0),
    ("bfloat16", 100, 8, 8, 4), ("float32", 7, 8, 8, 0),
    ("bfloat16", 7, 12, 4, 0)])
def test_paged_attention_on_the_element_rows_routes(dtype, d, hq, hkv, pad):
    """Rows of no whole 16-byte pieces on each of their routes on the card
    (`route`: TMA runs of heads at D100 G1 and G8 and at fp32 D7 G1; the
    copy for strided heads, `pad` elements past each, and for bf16 D7 at
    G3), lengths 0, a middle one and T: the wrapper's plain version against
    the reference's Pallas kernel in interpret mode."""
    rng = np.random.default_rng(hq * 17 + d + pad)
    jdt = getattr(jnp, dtype)
    q = jnp.array(rng.standard_normal((3, hq, d)) * 0.3, jdt)
    kc = jnp.array(rng.standard_normal((3, 64, hkv, d)) * 0.3, jdt)
    vc = jnp.array(rng.standard_normal((3, 64, hkv, d)), jdt)
    lens = np.array([0, 41, 64], np.int32)
    tk, tv = _caches(getattr(torch, dtype), 3, 64, hkv, d, pad)
    tk.copy_(to_torch(kc))
    tv.copy_(to_torch(vc))
    tq = to_torch(q)
    assert tpaged.route(tq, tk, tv) == ("element" if pad or hq == 12
                                        else "run")
    out = tpaged.paged_attention(tq, tk, tv, torch.from_numpy(lens), page=32)
    assert out.dtype == getattr(torch, dtype) and out.shape == (3, hq, d)
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


# -------------------------------------------- the two FMA bodies' designs
def _paged_wide_walk(q, k, v, lens, blocks, rows):
    """A numpy model of paged attention's wide body
    (`paged_wide_kernel` of csrc/paged_attention.cu) over float32 q [B, Hq,
    D] and caches [B, T, Hkv, D]: the blocks' shares and chunks of rows as
    `block_chunks` gives them; a block's segment the whole head (above 2048
    columns, chunks of the output of WIDE_PIECES pieces of 256 columns,
    each its own blocks); each chunk of rows' K pieces, all of the head's,
    summed into the logits by the two warp parities (even and odd pieces)
    before the softmax, its V pieces into accumulators of all the column
    chunk's columns; a partial a block where a segment spans several,
    merged in the two levels of MERGE_GROUP. Returns the output [B, Hq, D]
    and the aloads of K a (b, KV head, piece) counted in rows."""
    B, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    dp = tflash.padded_head_dim("paged_attention", D)
    npk = dp // 256

    def pad(a):
        return np.pad(a.astype(np.float64),
                      [(0, 0)] * (a.ndim - 1) + [(0, dp - D)])
    q, k, v = pad(q), pad(k), pad(v)
    ngc = -(-G // tpaged.GC)
    hg = Hkv * ngc
    scale = 1.0 / np.sqrt(D)
    lens = [min(max(int(n), 0), T) for n in lens]
    prefix = np.concatenate([[0], np.cumsum(lens)])
    W = int(prefix[-1]) * hg
    per = -(-W // blocks) if W else 0
    out = np.zeros((B, Hq, dp))
    loads = {}
    share = tpaged.block_chunks(lens, T, hg, blocks, rows)

    def merge(parts):
        m = np.max([p[0] for p in parts], axis=0)
        w = [np.exp(p[0] - m) for p in parts]
        return (m, sum(wi * p[1] for wi, p in zip(w, parts)),
                sum(wi[:, None] * p[2] for wi, p in zip(w, parts)))
    for c0 in range(0, npk, tpaged.WIDE_PIECES):
        cols = slice(c0 * 256, min(npk, c0 + tpaged.WIDE_PIECES) * 256)
        partials = {}
        for blk, chunks in enumerate(share):
            state = None

            def flush(state):
                s, m, l, acc = state
                b, j = divmod(s, hg)
                start = int(prefix[b]) * hg + j * lens[b]
                first, count = tpaged.pieces(lens[b], start, per)
                if count == 1:
                    h0 = (j // ngc) * G + (j % ngc) * tpaged.GC
                    out[b, h0:h0 + len(m), cols] = acc / l[:, None]
                else:
                    partials.setdefault(s, []).append((m, l, acc))
            for s, t0, n in chunks:
                b, j = divmod(s, hg)
                h, g0 = j // ngc, (j % ngc) * tpaged.GC
                heads = slice(h * G + g0, h * G + min(G, g0 + tpaged.GC))
                if state is None or state[0] != s:
                    if state is not None:
                        flush(state)
                    gn = heads.stop - heads.start
                    state = (s, np.full(gn, -1e30), np.zeros(gn),
                             np.zeros((gn, cols.stop - cols.start)))
                _, m, l, acc = state
                rows_ = slice(t0, t0 + n)
                logit = np.zeros((heads.stop - heads.start, n))
                for parity in (0, 1):
                    part = 0.0
                    for p in range(parity, npk, 2):
                        pc = slice(p * 256, (p + 1) * 256)
                        part = part + q[b, heads, pc] @ k[b, rows_, h, pc].T
                        key = (b, h, p)
                        loads[key] = loads.get(key, 0) + n
                    logit = logit + part
                logit = logit * scale
                m_new = np.maximum(m, logit.max(1))
                alpha = np.exp(m - m_new)
                p_ = np.exp(logit - m_new[:, None])
                state = (s, m_new, l * alpha + p_.sum(1),
                         acc * alpha[:, None] + p_ @ v[b, rows_, h, cols])
            if state is not None:
                flush(state)
        for s, parts in partials.items():       # the two levels
            groups = [merge(parts[i:i + tpaged.MERGE_GROUP])
                      for i in range(0, len(parts), tpaged.MERGE_GROUP)]
            m, l, acc = merge(groups)
            b, j = divmod(s, hg)
            h0 = (j // ngc) * G + (j % ngc) * tpaged.GC
            out[b, h0:h0 + len(m), cols] = acc / l[:, None]
    return out[:, :, :D], loads


@pytest.mark.parametrize("d,dtype,hq,hkv,t,lens", [
    (300, torch.float32, 8, 2, 333, (0, 1, 200, 333)),
    (1024, torch.float32, 16, 1, 900, (900, 517)),
    (2048, torch.float32, 8, 2, 200, (200, 3, 64, 0)),
    (520, torch.float8_e4m3fn, 8, 1, 1200, (1200, 1000)),
    (2304, torch.float32, 8, 1, 300, (300, 41))])
def test_paged_wide_walk_model(d, dtype, hq, hkv, t, lens):
    """The wide body's walk (`_paged_wide_walk`: the whole head a segment,
    up to 2048 columns, chunks of 2048 above; K's pieces summed before the
    softmax, V's pieces into all the chunk's columns, the two-level merge)
    equals the plain version, at the plan's blocks and rows, and reads each
    valid K row once a column chunk: one aload of each (row, piece) a
    segment of a KV head and a chunk."""
    rng = np.random.default_rng(d + hq)
    B = len(lens)
    q = (rng.standard_normal((B, hq, d)) * 2).astype(np.float32)
    kc = to_torch(rng.standard_normal((B, t, hkv, d)).astype(np.float32))
    vc = to_torch(rng.standard_normal((B, t, hkv, d)).astype(np.float32))
    kc, vc = ref.from_float(kc, dtype), ref.from_float(vc, dtype)
    plan = tpaged.paged_plan(B, hq, hkv, t, 512, 132, d, dtype.itemsize,
                             products=tpaged.products_on(torch.float32, dtype,
                                                         d, hq, hkv))
    assert plan.chunks == -(-d // 2048) and plan.rows == 32
    lens_t = torch.tensor(lens, dtype=torch.int32)
    got, loads = _paged_wide_walk(q, kc.float().numpy(), vc.float().numpy(),
                                  lens, plan.blocks, plan.rows)
    want = ref.paged_attention_ref(to_torch(q), kc, vc, lens_t)
    np.testing.assert_allclose(got, to_np(want), **FP32_TOL)
    dp = tflash.padded_head_dim("paged_attention", d)
    ngc = -(-(hq // hkv) // tpaged.GC)
    assert loads == {(b, h, p): plan.chunks * ngc * n
                     for b, n in enumerate(lens)
                     for h in range(hkv) for p in range(dp // 256) if n}


# csrc/flash_attention.cu's `FmaRing`: (query rows a block, keys a K or V
# tile, ring slots) of the fma body at each Dp (at 64 and 128 also its
# 64-row tiles, `fma_rows`; 256 is also a CTA's of its clusters above)
FMA_RING = {16: ((128, 64, 4),), 32: ((128, 64, 4),),
            64: ((128, 64, 4), (64, 64, 4)),
            128: ((128, 64, 3), (64, 64, 4)), 256: ((64, 32, 4),)}


def _fma_tiles(q0, s, bm, bn, causal, window):
    """The KV tiles the fma body's block at q0 loads: `kt_lo`, `kt_hi`."""
    nkt = -(-s // bn)
    kt_hi = min(nkt, (min(q0 + bm, s) - 1) // bn + 1) if causal else nkt
    kt_lo = (q0 - window + 1) // bn if window > 0 and q0 - window + 1 > 0 \
        else 0
    return kt_lo, kt_hi


def _fma_ring_run(items, slots, seed, warps=8):
    """One interleaving, drawn from `seed`, of the fma body's producer warp
    and its consumer warps over `items` ring items (K and V of each tile in
    turn), with the mbarriers' phase arithmetic of the source: the producer
    waits on slot i % slots's `empty` at parity (i / slots - 1) & 1 before
    it refills it (from item `slots` on), a consumer on its `full` at
    parity (i / slots) & 1 (a barrier whose completed phases number c
    passes a wait at parity p where c % 2 != p); each warp frees a slot
    after reading it, and the consumers meet at two barriers a tile. Checks
    that every item is read by every warp once, landed, and that no slot is
    refilled before every warp has freed it."""
    import random
    rnd = random.Random(seed)
    full, empty, freed = [0] * slots, [0] * slots, [0] * slots
    content = [None] * slots              # (item, landed)
    inflight, issued, reads = [], 0, {}
    prog = []                             # a warp's steps, tile by tile
    for t in range(items // 2):
        prog += [("wait", 2 * t), ("read", 2 * t), ("free", 2 * t), ("bar",),
                 ("bar",), ("wait", 2 * t + 1), ("read", 2 * t + 1),
                 ("free", 2 * t + 1)]
    pc, at_bar, bar_gen = [0] * warps, [0] * warps, 0
    while issued < items or inflight or any(p < len(prog) for p in pc):
        moves = []
        if issued < items:
            slot = issued % slots
            if issued < slots or empty[slot] % 2 != (issued // slots - 1) % 2:
                moves.append("issue")
        if inflight:
            moves.append("land")
        for w in range(warps):
            if pc[w] < len(prog):
                step = prog[pc[w]]
                if step[0] == "wait":
                    slot = step[1] % slots
                    if full[slot] % 2 != (step[1] // slots) % 2:
                        moves.append(w)
                elif step[0] == "bar":
                    if at_bar[w] <= bar_gen:
                        moves.append(w)
                else:
                    moves.append(w)
        assert moves, "deadlock"
        move = rnd.choice(moves)
        if move == "issue":
            slot = issued % slots
            if issued >= slots:           # every warp freed the slot's last
                assert freed[slot] == (issued // slots) * warps, issued
            content[slot] = (issued, False)
            inflight.append(slot)
            issued += 1
        elif move == "land":
            slot = inflight.pop(rnd.randrange(len(inflight)))
            content[slot] = (content[slot][0], True)
            full[slot] += 1
        else:
            w = move
            step = prog[pc[w]]
            if step[0] == "read":
                assert content[step[1] % slots] == (step[1], True), step
                reads[step[1]] = reads.get(step[1], 0) + 1
            elif step[0] == "free":
                slot = step[1] % slots
                freed[slot] += 1
                if freed[slot] % warps == 0:
                    empty[slot] += 1
            elif step[0] == "bar":
                at_bar[w] += 1
                if all(a > bar_gen for a in at_bar):
                    bar_gen += 1
                pc[w] += 1
                continue
            pc[w] += 1
    assert reads == {i: warps for i in range(items)}


@pytest.mark.parametrize("dp", sorted(FMA_RING))
@pytest.mark.parametrize("s,causal,window", [
    (1000, True, 0), (333, True, 48), (200, False, 0), (130, False, 63),
    (1, True, 0), (4096, True, 2048)])
def test_flash_fma_ring_model(dp, s, causal, window):
    """The fma body's ring over the tiles its blocks take: the tile range
    (`kt_lo`, `kt_hi`) holds every KV tile with a key some row of the query
    tile attends to and no other, and the ring's stage and phase arithmetic
    (`_fma_ring_run`, three interleavings a query tile) consumes every tile
    once and frees every slot before it is refilled."""
    pos = np.arange(s)
    for bm, bn, slots in FMA_RING[dp]:
        for qt in range(-(-s // bm)):
            q0 = qt * bm
            r = pos[q0:q0 + bm, None]
            ok = np.ones((len(r), s), bool)
            if causal:
                ok &= pos[None, :] <= r
            if window:
                ok &= pos[None, :] > r - window
            wanted = [kt for kt in range(-(-s // bn))
                      if ok[:, kt * bn:(kt + 1) * bn].any()]
            lo, hi = _fma_tiles(q0, s, bm, bn, causal, window)
            assert wanted == list(range(lo, hi)), (qt, lo, hi)
            if qt % 7 == 0 or qt == -(-s // bm) - 1:
                for seed in range(3):
                    _fma_ring_run(2 * (hi - lo), slots, seed + 31 * qt)


def _fma_cluster_plan(d):
    """The fma body's clusters above 256 columns (`flash_fma_kernel` with
    WIDE): n CTAs a cluster and the chunks of n pieces, and for (chunk,
    rank) the 256-column pieces it sums Q K^T over and its output piece
    (None past the head)."""
    npc = -(-d // 256)
    n = min(npc, tflash.FMA_CLUSTER)
    chunks = -(-npc // n)
    return n, chunks, {(c, r): (list(range(r, npc, n)),
                                c * n + r if c * n + r < npc else None)
                       for c in range(chunks) for r in range(n)}


def _fma_exchange_run(n, tiles, seed, warps=2, parity=True):
    """One interleaving, drawn from `seed`, of the exchange of partial
    logits in a cluster of n CTAs of `warps` consumer warps over `tiles`
    tiles, with the source's order and barrier arithmetic: a warp posts
    tile 0's partials (writes its part of its CTA's buffer of parity 0 and
    arrives on that parity's barrier of every CTA: n * warps arrivals a
    phase), then at each tile t waits on its own CTA's barrier of parity t
    % 2 at parity (t // 2) % 2 (a barrier whose completed phases number c
    passes a wait at parity p where c % 2 != p), reads its part of every
    CTA's buffer in rank order and posts tile t + 1's (`parity` False: one
    buffer and one barrier); after the last tile every warp meets the
    others at the cluster barrier before its CTA exits. Checks that every
    read sees the buffer of its own tile, of a CTA that has not exited."""
    import random
    rnd = random.Random(seed)
    buf = {}                              # (cta, parity, warp) -> tile
    arrivals = {(c, p): 0 for c in range(n) for p in range(2)}
    prog = [("write", 0), ("arrive", 0)]
    for t in range(tiles):
        prog += [("wait", t)] + [("read", t, p) for p in range(n)]
        if t + 1 < tiles:
            prog += [("write", t + 1), ("arrive", t + 1)]
    prog += [("cluster",), ("exit",)]
    agents = [(c, w) for c in range(n) for w in range(warps)]
    pc = {a: 0 for a in agents}
    at_cluster, exited, reads = set(), set(), 0
    while any(pc[a] < len(prog) for a in agents):
        moves = []
        for a in agents:
            if pc[a] == len(prog):
                continue
            step = prog[pc[a]]
            if step[0] == "wait":
                t = step[1]
                done = arrivals[(a[0], t % 2 if parity else 0)] // (n * warps)
                if done % 2 != (t // 2 if parity else t) % 2:
                    moves.append(a)
            elif step[0] == "exit":
                if len(at_cluster) == len(agents):
                    moves.append(a)
            else:
                moves.append(a)
        assert moves, "deadlock"
        a = rnd.choice(moves)
        (c, w), step = a, prog[pc[a]]
        par = step[1] % 2 if parity and len(step) > 1 else 0
        if step[0] == "write":
            buf[(c, par, w)] = step[1]
        elif step[0] == "arrive":
            for p in range(n):
                arrivals[(p, par)] += 1
        elif step[0] == "read":
            p = step[2]
            assert p not in exited, (a, step)
            assert buf[(p, par, w)] == step[1], (a, step, buf[(p, par, w)])
            reads += 1
        elif step[0] == "cluster":
            at_cluster.add(a)
        elif step[0] == "exit":
            if all(pc[(c, x)] >= len(prog) - 1 for x in range(warps)):
                exited.add(c)
        pc[a] += 1
    return reads


@pytest.mark.parametrize("n,tiles", [(2, 5), (3, 4), (8, 3), (5, 6)])
def test_flash_fma_exchange_model(n, tiles):
    """The cluster's exchange of partial logits, double-buffered by tile
    parity with one barrier a tile, a tile's partials posted once the wait
    for the tile before it is over: under random interleavings every read
    sees the partials of its own tile and no CTA exits before its peers
    have read it; with one buffer some interleaving reads another tile's."""
    for seed in range(40):
        assert _fma_exchange_run(n, tiles, seed) == n * 2 * tiles * n
    failed = 0
    for seed in range(200):
        try:
            _fma_exchange_run(n, tiles, seed, parity=False)
        except AssertionError:
            failed += 1
    assert failed


def _fma_cluster_walk(q, k, v, causal, window):
    """The fma body's clusters above 256 columns in numpy, its tiles (64
    query rows, 32 keys) and its arithmetic: each CTA's partial logits over
    its pieces, the cluster's sum in rank order (checked against Q K^T over
    the whole head), then each CTA's softmax and P V over its own piece of
    the output. Returns the output and how many CTAs wrote each column."""
    b_, hq, s, d = q.shape
    group = hq // k.shape[1]
    n, chunks, plan = _fma_cluster_plan(d)
    bm, bn = 64, 32
    out = np.full(q.shape, np.nan, np.float32)
    writes = np.zeros(d, int)
    scale = 1 / np.sqrt(d)
    for b in range(b_):
        for h in range(hq):
            qh, kh = q[b, h], k[b, h // group]
            # V's columns past D load as zeros
            vh = np.pad(v[b, h // group], ((0, 0), (0, -d % 256)))
            for q0 in range(0, s, bm):
                rows = np.arange(q0, min(q0 + bm, s))
                lo, hi = _fma_tiles(q0, s, bm, bn, causal, window)
                for c in range(chunks):
                    m = np.full((n, len(rows)), -np.inf, np.float32)
                    l = np.zeros((n, len(rows)), np.float32)
                    acc = np.zeros((n, len(rows), 256), np.float32)
                    for kt in range(lo, hi):
                        keys = np.arange(kt * bn, min(kt * bn + bn, s))
                        part = [sum(qh[rows][:, p * 256:p * 256 + 256]
                                    @ kh[keys][:, p * 256:p * 256 + 256].T
                                    for p in plan[(c, r)][0])
                                for r in range(n)]
                        logits = np.zeros_like(part[0])
                        for r in range(n):        # rank order
                            logits = logits + part[r]
                        np.testing.assert_allclose(
                            logits, qh[rows] @ kh[keys].T, rtol=1e-5,
                            atol=1e-5)
                        ok = np.ones(logits.shape, bool)
                        if causal:
                            ok &= keys[None, :] <= rows[:, None]
                        if window:
                            ok &= keys[None, :] > rows[:, None] - window
                        x = np.where(ok, logits * scale, -np.inf)
                        for r in range(n):
                            vp = plan[(c, r)][1]
                            if vp is None:
                                continue
                            mn = np.maximum(m[r], x.max(1))
                            safe = np.where(np.isinf(mn), 0, mn)
                            p = np.exp(x - safe[:, None])
                            alpha = np.exp(np.where(np.isinf(m[r]), -np.inf,
                                                    m[r] - safe))
                            l[r] = l[r] * alpha + p.sum(1)
                            acc[r] = acc[r] * alpha[:, None] + p @ \
                                vh[keys][:, vp * 256:vp * 256 + 256]
                            m[r] = mn
                    for r in range(n):
                        vp = plan[(c, r)][1]
                        if vp is None:
                            continue
                        cols = np.arange(vp * 256, min(vp * 256 + 256, d))
                        out[b, h, rows[:, None], cols[None, :]] = \
                            acc[r][:, :len(cols)] / l[r][:, None]
                        if b == h == q0 == 0:
                            writes[cols] += 1
    return out, writes


@pytest.mark.parametrize("d,causal,window", [
    (300, True, 0), (512, True, 40), (1100, False, 0), (2304, True, 0),
    (4352, True, 70)])
def test_flash_fma_cluster_walk_model(d, causal, window):
    """The fma body's clusters above 256 columns, modelled in numpy: every
    output column < D is written by exactly one CTA, every piece of the
    head's Q K^T is summed by one CTA of each cluster, the partial logits
    summed in rank order are Q K^T over the whole head, and the output
    equals the reference's `attention_ref` at the float32 tolerance (S
    ragged against the 64-row tiles); above 2048 columns two and three
    chunks of 8 pieces, the last of one piece."""
    n, chunks, plan = _fma_cluster_plan(d)
    for c in range(chunks):
        assert sorted(p for r in range(n) for p in plan[(c, r)][0]) == \
            list(range(-(-d // 256)))
    q, k, v = _flash_inputs(5 + d, 1, 2, 1, 100, d)
    out, writes = _fma_cluster_walk(q, k, v, causal, window)
    assert (writes == 1).all()
    want = jref.attention_ref(jnp.array(q), jnp.array(k), jnp.array(v),
                              causal=causal, window=window)
    np.testing.assert_allclose(out, to_np(want), **FP32_TOL)


@pytest.mark.parametrize("dtype,d", [
    ("float32", 12), ("float32", 100), ("float32", 256), ("int8", 64),
    ("bfloat16", 12)])
def test_flash_fma_body_against_the_reference(dtype, d):
    """The inputs flash's fma body takes on the card (float32 at D 12, 100
    and 256; int8 on float32 copies; bf16 rows of no whole 16-byte pieces
    at D 12): the wrapper's plain version against the reference's Pallas
    kernel in interpret mode, causal with a window, GQA group 2."""
    assert tflash.body_for(getattr(torch, dtype), d) == "fma"
    q, k, v = _flash_inputs(11 + d, 1, 4, 2, 192, d)
    if dtype == "int8":
        q, k, v = ((a * 40).round().clip(-128, 127) for a in (q, k, v))
    jdt = getattr(jnp, dtype)
    jq, jk, jv = (jnp.array(a, jdt) for a in (q, k, v))
    tq, tk, tv = to_torch(jq), to_torch(jk), to_torch(jv)
    out = tflash.flash_attention(tq, tk, tv, causal=True, window=48)
    assert out.dtype == getattr(torch, dtype) and out.shape == tq.shape
    want = to_np(jflash(jq, jk, jv, causal=True, window=48, block_q=64,
                        block_k=64, interpret=True))
    if dtype == "int8":       # the same cut toward zero: within one unit
        np.testing.assert_allclose(to_np(out), want, atol=1, rtol=0)
    else:
        np.testing.assert_allclose(to_np(out), want, **TOLS[dtype])


def test_paged_wide_body_against_the_reference():
    """The wide body's inputs at D 300 in float32 (two pieces of 256, the
    second past D but for 44 columns), lengths 0, 1, a middle one and T:
    the wrapper's plain version against the reference's Pallas kernel in
    interpret mode."""
    assert tpaged.products_on(torch.float32, torch.float32, 300) == "fma"
    rng = np.random.default_rng(300)
    q = jnp.array(rng.standard_normal((4, 8, 300)) * 0.3, jnp.float32)
    kc = jnp.array(rng.standard_normal((4, 96, 2, 300)) * 0.3, jnp.float32)
    vc = jnp.array(rng.standard_normal((4, 96, 2, 300)), jnp.float32)
    lens = np.array([0, 1, 41, 96], np.int32)
    out = tpaged.paged_attention(to_torch(q), to_torch(kc), to_torch(vc),
                                 torch.from_numpy(lens), page=32)
    np.testing.assert_allclose(
        to_np(out), to_np(jpaged(q, kc, vc, jnp.array(lens), page=32,
                                 interpret=True)), **FP32_TOL)
