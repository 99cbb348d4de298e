"""Every input type the TPU kernels take, through the port, against the
reference's Pallas kernels in interpret mode (`repro.kernels`, on the CPU).

The reference's kernels were probed for what they take (JAX 0.9.0, x64
off): 8- and 16-bit integers, float8_e4m3fn and float8_e5m2 beside the
float types, and scatter rows of any width. Each (kernel, type) pair below
makes its inputs with numpy from a seed, runs them through the reference's
kernel and through the port's wrapper (on the CPU: its plain version in
`repro_torch.kernels.ref`), and holds the two together:

- integers and the triad (every type) and float8 scatter-add: equal, NaN
  positions included;
- bfloat16 / float16 scatter-add: within `ref.scatter_add16_limit` (the
  reference rounds after every add, the plain version's `index_add` once);
- attention in float8 or an integer type: within one unit in the last place
  of the output type (both compute in float32, in other orders, and round
  once at the end).

The conversions both sides agree on are pinned first: XLA converts float to
int toward zero with saturation and NaN -> 0, and float to float8 to nearest
even without saturation (e4m3fn overflows to NaN, e5m2 to inf), where
torch's own `.to` saturates e4m3fn. The CUDA kernels are held against the
same plain versions on the card by `chip_smoke.py`.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.async_gather import async_gather as jgather
from repro.kernels.flash_attention import flash_attention as jflash
from repro.kernels.paged_attention import paged_attention as jpaged
from repro.kernels.stream_triad import stream_triad as jtriad
from repro_torch import convert
from repro_torch.kernels import async_gather as tgather
from repro_torch.kernels import async_scatter as tscatter
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import paged_attention as tpaged
from repro_torch.kernels import ref
from repro_torch.kernels import stream_triad as ttriad

from test_torch_util import to_np, to_torch

INTS = ["int8", "uint8", "int16", "uint16", "int32", "uint32"]
FP8 = ["float8_e4m3fn", "float8_e5m2"]


def _ints(rng, shape, name, lo=None, hi=None):
    info = np.iinfo(name)
    return rng.integers(info.min if lo is None else lo,
                        info.max if hi is None else hi, shape,
                        endpoint=True).astype(name)


def _floats(rng, shape, name, scale=1.0):
    return np.asarray(jnp.asarray(rng.standard_normal(shape) * scale,
                                  getattr(jnp, name)))


def _same(got, want):
    """Equal, NaN where the other is NaN."""
    got, want = to_np(got), to_np(want)
    assert got.shape == want.shape
    if got.dtype.kind == "f":
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        ok = ~np.isnan(want)
        got, want = got[ok], want[ok]
    np.testing.assert_array_equal(got, want)


def _ulp(x, name):
    """One unit in the last place of type `name` at |x| (float32 array)."""
    if name in INTS:
        return np.ones_like(x)
    fi = ml_dtypes.finfo(getattr(ml_dtypes, name, None) or np.dtype(name))
    e = np.floor(np.log2(np.maximum(np.abs(x), float(fi.tiny))))
    return np.exp2(e) * float(fi.eps)


def _within_one_ulp(got, want, name):
    got, want = to_np(got).astype(np.float32), to_np(want).astype(np.float32)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    got, want = got[ok], want[ok]
    step = _ulp(np.maximum(np.abs(got), np.abs(want)), name)
    assert np.all(np.abs(got - want) <= step), \
        np.max(np.abs(got - want) / step)


# ----------------------------------------------------------- conversions
@pytest.mark.parametrize("name,x,want", [
    ("int8", 300.0, 127), ("int8", -300.0, -128), ("int8", 2.7, 2),
    ("int8", float("nan"), 0), ("uint8", -1.5, 0), ("uint8", 300.0, 255),
    ("int16", -40000.5, -32768), ("uint16", 70000.0, 65535),
    ("int32", 3e9, 2 ** 31 - 1), ("uint32", -2.5, 0)])
def test_float_to_int_truncates_and_saturates_on_both_sides(name, x, want):
    j = np.asarray(jnp.asarray([x], jnp.float32).astype(getattr(jnp, name)))
    t = ref.to_int(torch.tensor([x]), getattr(torch, name))
    assert int(j[0]) == want and int(t[0]) == want


@pytest.mark.parametrize("name,x,want", [
    ("float8_e4m3fn", 500.0, float("nan")),
    ("float8_e4m3fn", -500.0, float("nan")),
    ("float8_e4m3fn", 464.0, 448.0),          # the tie rounds to even, 448
    ("float8_e4m3fn", 465.0, float("nan")),
    ("float8_e4m3fn", 3.3, 3.25),
    ("float8_e5m2", 1e5, float("inf")),
    ("float8_e5m2", -1e5, float("-inf")),
    ("float8_e5m2", 61440.0, float("inf")),   # the tie rounds to even, inf
    ("float8_e5m2", 61439.0, 57344.0),
    ("float8_e5m2", 3.3, 3.5)])
def test_float_to_fp8_does_not_saturate_on_either_side(name, x, want):
    j = to_np(jnp.asarray([x], jnp.float32).astype(getattr(jnp, name)))[0]
    t = float(ref.to_fp8(torch.tensor([x]), getattr(torch, name)).float())
    if np.isnan(want):
        assert np.isnan(j) and np.isnan(t)
    else:
        assert j == want and t == want
    if name == "float8_e4m3fn" and abs(x) > 464:   # torch's .to saturates
        assert float(torch.tensor([x]).to(getattr(torch, name))[0]) != t


@pytest.mark.parametrize("name", FP8 + INTS)
def test_conversions_agree_over_a_sweep(name):
    """Seeded floats over 12 decades, every midpoint between two float8
    values and its neighbours, and the specials: the reference's `astype`
    and `ref.from_float` give the same values."""
    rng = np.random.default_rng(60)
    x = rng.standard_normal(20000) * 10.0 ** rng.uniform(-6, 6, 20000)
    special = [0.0, -0.0, np.nan, np.inf, -np.inf, 448, 464, 480, 57344,
               61440, 2 ** 31, -2 ** 31 - 1, 65535.5, -0.5]
    x = np.concatenate([x, special]).astype(np.float32)
    if name in FP8:
        v = np.arange(256, dtype=np.uint8).view(getattr(ml_dtypes, name))
        v = np.sort(v.astype(np.float64)[np.isfinite(v.astype(np.float64))])
        mid = ((v[1:] + v[:-1]) / 2).astype(np.float32)
        x = np.concatenate([x, mid, np.nextafter(mid, np.float32(np.inf)),
                            np.nextafter(mid, np.float32(-np.inf))])
    want = jnp.asarray(x).astype(getattr(jnp, name))
    _same(ref.from_float(torch.from_numpy(x), getattr(torch, name)), want)


def test_convert_moves_float8_and_uint16_leaves_both_ways():
    """ml_dtypes float8 and numpy uint16 leaves through
    `tensor_from_numpy` / `tensor_to_numpy`: the same bits, float8 widened
    to float32 on the way back (NaN and inf kept)."""
    for name in FP8:
        a = np.array([1.5, -448.0, np.nan, 0.0, -0.0, 2 ** -9],
                     dtype=getattr(ml_dtypes, name))
        t = convert.tensor_from_numpy(a, device="cpu")
        assert t.dtype == getattr(torch, name)
        np.testing.assert_array_equal(t.view(torch.uint8).numpy(),
                                      a.view(np.uint8))
        back = convert.tensor_to_numpy(t)
        assert back.dtype == np.float32
        np.testing.assert_array_equal(back, a.astype(np.float32))
    u = np.array([0, 1, 40000, 65535], dtype=np.uint16)
    t = convert.tensor_from_numpy(u, device="cpu")
    assert t.dtype == torch.uint16
    back = convert.tensor_to_numpy(t)
    assert back.dtype == np.uint16 and np.array_equal(back, u)


# ------------------------------------------------------------------ triad
def _triad_inputs(name, n, seed, overflow=False):
    rng = np.random.default_rng(seed)
    if name in INTS:
        return _ints(rng, n, name), _ints(rng, n, name)
    scale = {"float8_e4m3fn": 200.0, "float8_e5m2": 30000.0,
             "float16": 3e4, "bfloat16": 1e38}[name] if overflow else 4.0
    return _floats(rng, n, name, scale), _floats(rng, n, name, scale)


@pytest.mark.parametrize("name", ["bfloat16", "float16"] + FP8 + INTS)
@pytest.mark.parametrize("s", [3.3, -0.7, 2.0])
@pytest.mark.parametrize("overflow", [False, True])
def test_triad_is_the_reference_bit_for_bit(name, s, overflow):
    """a = b + s * c, N = 4096 (block 512): the port's plain version equals
    the reference's kernel everywhere. The overflow cases draw floats large
    enough that s * c or the sum passes the type's largest value (float8
    gives NaN / inf, bfloat16 and float16 inf); integers wrap in every case
    (their inputs span the whole type)."""
    b, c = _triad_inputs(name, 4096, 61 + int(overflow), overflow)
    want = jtriad(jnp.asarray(b), jnp.asarray(c), s, interpret=True)
    got = ttriad.stream_triad(to_torch(b), to_torch(c), s)
    assert got.dtype == getattr(torch, name)
    _same(got, want)
    if overflow and name not in INTS:
        assert not np.isfinite(to_np(got)).all()


@pytest.mark.parametrize("name,b,c,s,want", [
    ("int8", 100, 100, 2.7, 44), ("uint8", 200, 100, 1.0, 44),
    ("int16", 30000, 30000, 1.0, -5536), ("int32", 2 ** 30, 2 ** 30, 3.0,
                                          0)])
def test_integer_triad_wraps(name, b, c, s, want):
    """s toward zero (2.7 -> 2), then two's-complement wrap: 100 + 2 * 100
    = 300 = 44 in int8, on both sides."""
    jb = jnp.full((512,), b, getattr(jnp, name))
    jc = jnp.full((512,), c, getattr(jnp, name))
    assert int(jtriad(jb, jc, s, interpret=True)[0]) == want
    got = ttriad.stream_triad(to_torch(jb), to_torch(jc), s)
    assert int(got[0]) == want and bool((got == got[0]).all())


@pytest.mark.parametrize("name,s,want", [
    ("int8", 300.0, 127), ("int8", -300.0, -128), ("uint8", -1.5, 0),
    ("int32", 1e10, 2 ** 31 - 1), ("int16", float("nan"), 0),
    ("int32", 16777217.0, 16777216)])
def test_integer_triad_converts_its_scalar_as_the_reference(name, s, want):
    """The reference's kernel takes s as a traced float32 and makes it the
    arrays' type inside the jit, by XLA's conversion: toward zero,
    saturated, NaN -> 0 (16777217 is 2^24 in float32 first). With b = 0
    and c = 1 the triad shows the converted s."""
    b, c = np.zeros(512, name), np.ones(512, name)
    j = jtriad(jnp.asarray(b), jnp.asarray(c), s, interpret=True)
    got = ttriad.stream_triad(to_torch(b), to_torch(c), s)
    assert int(to_np(j)[0]) == want and int(got[0]) == want
    assert ref.round_scalar(s, getattr(torch, name)) == want


def test_int32_triad_is_taken_now():
    """Refused before (the kernel took floats only); now the reference's
    result: int32 at s = 3 on seeded integers."""
    rng = np.random.default_rng(62)
    b, c = _ints(rng, 1000, "int32", -1000, 1000), \
        _ints(rng, 1000, "int32", -1000, 1000)
    got = ttriad.stream_triad(torch.from_numpy(b), torch.from_numpy(c), 3.0)
    assert got.dtype == torch.int32
    _same(got, jops.triad(jnp.asarray(b), jnp.asarray(c), 3.0))


# ----------------------------------------------------------------- gather
@pytest.mark.parametrize("name,d", [("float8_e4m3fn", 64), ("float8_e5m2", 3),
                                    ("uint16", 8), ("uint16", 3),
                                    ("int16", 5), ("uint8", 7)])
def test_gather_moves_every_type(name, d):
    rng = np.random.default_rng(63)
    n, m = 100, 64
    table = _floats(rng, (n, d), name, 50.0) if name in FP8 \
        else _ints(rng, (n, d), name)
    idx = rng.integers(0, n, m).astype(np.int32)
    want = jgather(jnp.asarray(table), jnp.asarray(idx), block_m=32,
                   num_slots=4, interpret=True)
    got = tgather.async_gather(to_torch(table), torch.from_numpy(idx),
                               block_m=32, num_slots=4)
    assert got.dtype == getattr(torch, name)
    _same(got, want)


# ---------------------------------------------------------------- scatter
def _scatter_inputs(name, n, d, m, seed):
    rng = np.random.default_rng(seed)
    if name in FP8:
        scale = 2.0 if name == "float8_e4m3fn" else 100.0
        table = _floats(rng, (n, d), name, scale)
        upd = _floats(rng, (m, d), name, scale)
    elif name in ("bfloat16", "float16"):
        table, upd = _floats(rng, (n, d), name), _floats(rng, (m, d), name)
    else:
        table, upd = _ints(rng, (n, d), name), _ints(rng, (m, d), name)
    idx = rng.integers(0, n, m).astype(np.int32)
    return table, idx, upd


def _scatter_both(name, op, n, d, m, seed):
    table, idx, upd = _scatter_inputs(name, n, d, m, seed)
    want = jops.scatter_update(jnp.asarray(table), jnp.asarray(idx),
                               jnp.asarray(upd), op=op, block_m=64)
    t = to_torch(table)
    got = tscatter.async_scatter(t, torch.from_numpy(idx), to_torch(upd), op,
                                 block_m=64)
    assert got is t and got.dtype == getattr(torch, name)
    return got, want, (table, idx, upd)


@pytest.mark.parametrize("name", ["int8", "uint8", "int16", "uint16"])
@pytest.mark.parametrize("op", ["add", "xor"])
@pytest.mark.parametrize("d", [1, 3, 4, 6, 64])
def test_small_integer_scatter_is_exact(name, op, d):
    """8- and 16-bit integer tables, add (wrapping) and xor, at rows of 1
    to 128 bytes, 200 updates into 40 rows (each row hit ~5 times)."""
    got, want, _ = _scatter_both(name, op, 40, d, 200, 64 + d)
    _same(got, want)


@pytest.mark.parametrize("name", FP8)
@pytest.mark.parametrize("d", [1, 3, 6, 64])
def test_fp8_scatter_add_is_the_reference_in_index_order(name, d):
    """float8 add, each sum rounded back without saturation: the plain
    version applies a row's updates in rounds, in index order, which is the
    reference's order, so the two are equal (NaN where a partial sum passes
    e4m3fn's range included). The card adds in its own order: `chip_smoke`
    holds it within `ref.scatter_add16_limit`."""
    got, want, (table, idx, upd) = _scatter_both(name, "add", 40, d, 200,
                                                 70 + d)
    _same(got, want)
    limit = ref.scatter_add16_limit(to_torch(table), torch.from_numpy(idx),
                                    to_torch(upd))
    assert limit.shape == got.shape and bool((limit > 0).any())


@pytest.mark.parametrize("name", ["bfloat16", "float16"])
@pytest.mark.parametrize("d", [1, 3, 5])
def test_16bit_float_scatter_add_at_odd_widths(name, d):
    """bf16 / f16 rows of an odd element count (2, 6, 10 bytes; the bf16
    [*, 3] table was refused before): within `ref.scatter_add16_limit` of
    the reference, which rounds after every add."""
    got, want, (table, idx, upd) = _scatter_both(name, "add", 40, d, 200,
                                                 80 + d)
    limit = ref.scatter_add16_limit(to_torch(table), torch.from_numpy(idx),
                                    to_torch(upd))
    err = (got.float() - torch.tensor(to_np(want))).abs()
    assert bool((err <= limit).all()), float((err - limit).max())


# The bits an untouched neighbour of a 16-bit row holds below: -0.0 and
# +0.0, NaNs of several payloads (quiet, signalling, either sign), the
# infinities and subnormals
NEIGHBOURS = {"bfloat16": [0x8000, 0x0000, 0x7FC0, 0x7FC1, 0xFFFF, 0x7F81,
                           0xFFA5, 0x7F80, 0xFF80, 0x0001, 0x8001],
              "float16": [0x8000, 0x0000, 0x7E00, 0x7E01, 0xFFFF, 0x7C01,
                          0xFCA5, 0x7C00, 0xFC00, 0x0001, 0x8001]}


@pytest.mark.parametrize("name", ["bfloat16", "float16"])
@pytest.mark.parametrize("d", [1, 3, 5])
@pytest.mark.parametrize("parity", [0, 1])
def test_16bit_scatter_add_leaves_its_neighbours_alone(name, d, parity):
    """bf16 / f16 add into rows of 1, 3 and 5 elements (2, 6 and 10 bytes)
    where only the rows of one parity are hit, so that each 4-byte word the
    card's word path reduces with one element of a hit row holds one of a
    row no update touches; those rows hold NEIGHBOURS. Against the
    reference's kernel: the hit rows within `ref.scatter_add16_limit`, the
    others bit for bit where they are not NaN (-0.0 stays -0.0) and NaN
    where they are: on the CPU both sides pass the table through float32,
    which keeps no NaN's payload. The card's kernel keeps every bit
    (`chip_smoke.check_scatter16_neighbours`)."""
    rng = np.random.default_rng(110 + d + parity)
    n, m = 40, 200
    table = _floats(rng, (n, d), name).copy()
    other = np.arange(1 - parity, n, 2)
    pattern = np.array(NEIGHBOURS[name], np.uint16)
    table.view(np.uint16)[other] = pattern[
        np.arange(other.size * d) % pattern.size].reshape(-1, d)
    idx = (parity + 2 * rng.integers(0, n // 2, m)).astype(np.int32)
    upd = _floats(rng, (m, d), name)
    want = np.asarray(jops.scatter_update(
        jnp.asarray(table), jnp.asarray(idx), jnp.asarray(upd), op="add",
        block_m=64))
    got = tscatter.async_scatter(to_torch(table), torch.from_numpy(idx),
                                 to_torch(upd), "add", block_m=64)
    hit = np.unique(idx)
    limit = to_np(ref.scatter_add16_limit(to_torch(table),
                                          torch.from_numpy(idx),
                                          to_torch(upd)))[hit]
    err = np.abs(to_np(got)[hit] - want[hit].astype(np.float32))
    assert np.all(err <= limit), float(np.max(err - limit))
    kept = np.setdiff1d(np.arange(n), hit)
    nan = np.isnan(table[kept].astype(np.float32))
    for out in (got.view(torch.int16).numpy().view(np.uint16),
                want.view(np.uint16)):
        np.testing.assert_array_equal(
            np.isnan(out[kept].view(table.dtype).astype(np.float32)), nan)
        np.testing.assert_array_equal(out[kept][~nan],
                                      table[kept].view(np.uint16)[~nan])


@pytest.mark.parametrize("name", ["float8_e4m3fn", "float8_e5m2", "int8",
                                  "uint16"])
def test_scatter_refuses_xor_on_a_float_and_64_bits(name):
    """What the reference refuses stays refused: xor on a float table
    (jnp's ^ takes no float), and 64-bit tables (made 32-bit by the
    reference before its kernel runs)."""
    table = torch.zeros(4, 4, dtype=getattr(torch, name))
    idx = torch.zeros(3, dtype=torch.int32)
    upd = torch.zeros(3, 4, dtype=table.dtype)
    if name in FP8:
        with pytest.raises(TypeError, match="xor takes"):
            tscatter.async_scatter(table, idx, upd, "xor")
    else:
        tscatter.async_scatter(table, idx, upd, "xor")
    with pytest.raises(TypeError, match="add takes"):
        tscatter.async_scatter(table.long(), idx, upd.long(), "add")


@pytest.mark.parametrize("name,d,word", [
    ("int8", 64, False), ("float8_e4m3fn", 3, True), ("bfloat16", 3, True),
    ("bfloat16", 4, False), ("int32", 2, False), ("uint16", 3, True),
    ("int8", 3, True), ("int8", 20, True), ("uint8", 32, False),
    ("float8_e5m2", 48, False), ("int16", 64, True), ("uint16", 8, True)])
def test_scatter_plan_takes_the_word_path(name, d, word):
    """8/16-bit integers, float8 and rows of no whole 4-byte words reduce an
    aligned word a lane (chunk 1), but the add by compare-and-swap (int8,
    uint8, float8: `CAS_TYPES`) of rows of whole 16-byte units on a table
    that starts on one takes a 16-byte unit a lane (chunk 16); their spans
    are a multiple of 16 updates where a row is no whole words (16 such
    rows are whole 16-byte pieces), else of 4."""
    dtype = getattr(torch, name)
    row = d * dtype.itemsize
    plan = tscatter.scatter_plan(row, 1 << 24, 1 << 20, 256, 8,
                                 min(16, tscatter.REDUCE_WIDTH["add", dtype]),
                                 132, lambda chunk, smem: 4,
                                 dtype in tscatter.WORD_TYPES, None,
                                 dtype in tscatter.CAS_TYPES)
    assert (plan.chunk == 1) == word
    assert plan.chunk in (1, 4, 16)
    if dtype in tscatter.CAS_TYPES:
        assert plan.chunk == (16 if row % 16 == 0 else 1)
    unit = 4 if row % 4 == 0 else 16
    assert plan.span % unit == 0
    assert plan.lanes == 1 << (min(32, -(-row // max(plan.chunk, 4)))
                               .bit_length() - 1)


@pytest.mark.parametrize("row", [1, 3, 6, 10, 31])
def test_scatter_bucket_takes_rows_of_any_byte_count(row):
    """The bucket pass's plain version on uint8 rows of `row` bytes: a
    stable counting sort by region, the offsets its histogram's scan."""
    rng = np.random.default_rng(65)
    n, m = 5000, 3000
    idx = torch.from_numpy(rng.integers(0, n, m).astype(np.int32))
    upd = torch.from_numpy(_ints(rng, (m, row), "uint8"))
    out_idx, out_upd, offsets = tscatter.scatter_bucket(idx, upd, n)
    shift, buckets, *_ = tscatter.bucket_layout(n, m, row, 1)
    key = idx.long() >> shift
    order = torch.argsort(key, stable=True)
    assert torch.equal(out_idx, idx[order]) and torch.equal(out_upd,
                                                            upd[order])
    assert offsets[-1] == m and torch.equal(
        offsets[1:] - offsets[:-1], torch.bincount(key, minlength=buckets)
        .int())


# -------------------------------------------------------------- attention
def _attn_inputs(name, shapes, seed):
    rng = np.random.default_rng(seed)
    out = []
    for shape in shapes:
        if name in INTS:
            out.append(_ints(rng, shape, name, -3 if "u" not in name else 0,
                             3))
        else:
            out.append(_floats(rng, shape, name, 0.5))
    return out


@pytest.mark.parametrize("name", FP8 + ["int8", "int32", "uint8", "int16"])
@pytest.mark.parametrize("d", [16, 8])
def test_flash_takes_fp8_and_integers(name, d):
    """float8 q, k, v read in place (the kernel's fma body on the card);
    integers on float32 copies, the output cut toward zero as the
    reference's `.astype` cuts it (int32 was refused here before). Within
    one unit in the output type's last place of the reference's kernel."""
    q, k, v = _attn_inputs(name, [(1, 4, 128, d), (1, 2, 128, d),
                                  (1, 2, 128, d)], 90 + d)
    want = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                  block_q=64, block_k=64, interpret=True)
    got = tflash.flash_attention(to_torch(q), to_torch(k), to_torch(v))
    assert got.dtype == getattr(torch, name)
    _within_one_ulp(got, want, name)
    assert tflash.body_for(getattr(torch, name), d) == "fma"


@pytest.mark.parametrize("d,body", [(128, "wgmma"), (64, "wgmma"),
                                    (80, "wgmma"), (256, "wgmma"),
                                    (100, "wgmma_elem"), (8, "fma"),
                                    (32, "fma"), (512, "fma"),
                                    (72, "wgmma_elem"), (200, "wgmma_elem"),
                                    (33, "wgmma_elem"), (24, "fma")])
def test_flash_fp8_body_rule(d, body):
    """float8 rows of whole 16-byte pieces at Dp 64-256 take the wgmma body
    by TMA (Q K^T on the fp8 wgmma, V converted to f16 by its producer
    warpgroup), other rows at those Dp the same body with the element
    loader (converted as they are loaded); Dp 16-32 and above 256 the fma
    body. The card holds the source's rule to this one
    (`chip_smoke.py`)."""
    for dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
        assert tflash.body_for(dtype, d) == body


@pytest.mark.parametrize("q_name", FP8 + ["bfloat16", "float16", "float32"])
@pytest.mark.parametrize("kv_name", FP8)
def test_fp8_rules_at_every_head_size(q_name, kv_name):
    """The body rules of float8 inputs at every head size from 0 to 1100
    and 2048, as `chip_smoke.py` holds the sources' to the wrappers': flash
    (q, k, v of one float8 type) on the wgmma body by TMA (Q K^T on the
    fp8 wgmma) where the rows are whole 16-byte pieces and Dp is 64 to 256,
    with the element loader at the other D of those Dp, else fma; paged
    over float8 caches on the TMA ring at D % 16 == 0, its products on
    mma.sync at Dp 64 to 256 under a q of 16 bits or float8; one KV head a
    segment at every GQA layout on the TMA ring (`kv_heads` takes several
    there for 16-bit caches only), 8 / G below 8 query heads a KV head
    where the rows are no whole 16-byte pieces, up to Dp 256."""
    q, kv = getattr(torch, q_name), getattr(torch, kv_name)
    for d in range(0, 1101):
        if d == 0:
            with pytest.raises(ValueError):
                tflash.body_for(kv, d)
            continue
        dp = tflash.padded_head_dim("flash_attention", d)
        tc = 64 <= dp <= 256
        if q == kv:
            assert tflash.body_for(kv, d) == (
                "fma" if not tc else "wgmma" if d % 16 == 0
                else "wgmma_elem"), d
        assert tpaged.body_for(kv, d) == ("tma" if d % 16 == 0
                                          else "element"), d
        for hq, hkv in ((16, 16), (16, 2), (16, 1)):
            assert tpaged.kv_heads(q, kv, d, hq, hkv) == (
                8 if hq == hkv and d % 16 and dp <= 256 else 1), d
            assert tpaged.products_on(q, kv, d, hq, hkv) == (
                "mma" if d % 16 == 0 and tc and q != torch.float32
                else "fma"), d
    assert tflash.body_for(kv, 2048) == "fma"


@pytest.mark.parametrize("name", FP8)
@pytest.mark.parametrize("d", [100, 72])
def test_flash_fp8_on_the_element_route(name, d):
    """float8 rows of no whole 16-byte pieces at Dp 64-256 (the card's
    wgmma body with the element loader): within one unit in the last place
    of the reference's kernel in interpret mode, window 40."""
    dtype = getattr(torch, name)
    assert tflash.body_for(dtype, d) == "wgmma_elem"
    q, k, v = _attn_inputs(name, [(1, 4, 128, d), (1, 2, 128, d),
                                  (1, 2, 128, d)], 97 + d)
    want = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                  window=40, block_q=64, block_k=64, interpret=True)
    got = tflash.flash_attention(to_torch(q), to_torch(k), to_torch(v),
                                 window=40)
    assert got.dtype == dtype
    _within_one_ulp(got, want, name)


@pytest.mark.parametrize("q_name,kv_name", [
    ("float8_e4m3fn", "float8_e4m3fn"), ("float8_e5m2", "float8_e5m2"),
    ("bfloat16", "float8_e4m3fn"), ("bfloat16", "float8_e5m2"),
    ("int8", "int8"), ("float32", "int16")])
@pytest.mark.parametrize("d", [16, 24])
def test_paged_takes_fp8_caches_and_integers(q_name, kv_name, d):
    """float8 caches (a bf16 q beside them is the layout of fp8 KV caches),
    integer caches on float32 copies; lengths 0, 1 and T. Within one unit
    in the last place of q's type of the reference's kernel (a float32 q
    within tests/test_kernels.py's float32 limit)."""
    B, hq, hkv, t = 3, 4, 2, 64
    q, = _attn_inputs(q_name, [(B, hq, d)], 95)
    kc, vc = _attn_inputs(kv_name, [(B, t, hkv, d), (B, t, hkv, d)], 96 + d)
    lens = np.array([t, 1, 0], np.int32)
    want = jpaged(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                  jnp.asarray(lens), page=32, interpret=True)
    got = tpaged.paged_attention(to_torch(q), to_torch(kc), to_torch(vc),
                                 torch.from_numpy(lens))
    assert got.dtype == getattr(torch, q_name)
    if q_name == "float32":             # tests/test_kernels.py's fp32 limit
        np.testing.assert_allclose(to_np(got), to_np(want), atol=2e-5,
                                   rtol=1e-4)
    else:
        _within_one_ulp(got, want, q_name)
    kv = getattr(torch, kv_name)
    assert tpaged.body_for(kv, d) == (
        "tma" if d * (kv.itemsize if kv in tflash.KERNEL_TYPES else 4) % 16
        == 0 else "element")


@pytest.mark.parametrize("q_name,kv_name,d,hq,hkv,route", [
    ("float8_e4m3fn", "float8_e4m3fn", 8, 16, 2, "run"),
    ("bfloat16", "float8_e5m2", 8, 16, 2, "run"),
    ("float8_e4m3fn", "float8_e4m3fn", 100, 16, 2, "element"),
    ("float8_e5m2", "float8_e5m2", 100, 8, 8, "run"),
    ("float16", "float8_e4m3fn", 8, 4, 1, "element")])
def test_paged_fp8_caches_of_element_rows(q_name, kv_name, d, hq, hkv, route):
    """float8 caches whose rows are no whole 16-byte pieces: on the card the
    body of unpadded slots, by TMA boxes of a run of heads (a token's two
    heads at D8 Hkv2, 8 at D100 Hkv8) or by the producer warp's copy (D100
    at Hkv2: a token is 200 bytes; Hkv1 at D8), `route`. Lengths 0, 1 and
    T: the wrapper's CPU path within one unit in the last place of q's
    type of the reference's kernel."""
    B, t = 3, 64
    q, = _attn_inputs(q_name, [(B, hq, d)], 140 + d + hkv)
    kc, vc = _attn_inputs(kv_name, [(B, t, hkv, d), (B, t, hkv, d)],
                          141 + d + hkv)
    lens = np.array([t, 1, 0], np.int32)
    want = jpaged(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                  jnp.asarray(lens), page=32, interpret=True)
    tq, tk, tv = to_torch(q), to_torch(kc), to_torch(vc)
    assert tpaged.route(tq, tk, tv) == route
    got = tpaged.paged_attention(tq, tk, tv, torch.from_numpy(lens))
    assert got.dtype == getattr(torch, q_name)
    _within_one_ulp(got, want, q_name)


@pytest.mark.parametrize("q_name", FP8 + ["bfloat16", "float16"])
@pytest.mark.parametrize("kv_name", FP8)
@pytest.mark.parametrize("d", [64, 80, 128])
def test_paged_fp8_caches_under_a_16bit_or_fp8_q(q_name, kv_name, d):
    """float8 caches under a q of 16 bits or float8, read in its own type:
    on the card one kernel with both products on the tensor cores
    (`products_on`; K and V converted to f16, or bf16 under a bf16 q, in
    registers) that writes the output in q's type. Lengths 0, 1 and T, GQA
    group 2, D = Dp and D < Dp (80). The wrapper's CPU path within one unit
    in the last place of q's type of the reference's kernel."""
    B, hq, hkv, t = 3, 4, 2, 64
    q, = _attn_inputs(q_name, [(B, hq, d)], 130 + d)
    kc, vc = _attn_inputs(kv_name, [(B, t, hkv, d), (B, t, hkv, d)], 131 + d)
    lens = np.array([t, 1, 0], np.int32)
    want = jpaged(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                  jnp.asarray(lens), page=32, interpret=True)
    got = tpaged.paged_attention(to_torch(q), to_torch(kc), to_torch(vc),
                                 torch.from_numpy(lens))
    assert got.dtype == getattr(torch, q_name)
    _within_one_ulp(got, want, q_name)
    assert tpaged.products_on(getattr(torch, q_name), getattr(torch, kv_name),
                              d) == "mma"
