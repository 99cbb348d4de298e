"""The port's AMU kernels (async_gather, async_scatter, stream_triad), their
`ops` glue and the quickstart's kernel half against the JAX reference: its
`ref.py` oracles and its Pallas kernels in interpret mode, at every
parametrisation of tests/test_kernels.py. On the CPU each wrapper runs its
plain version; the CUDA kernels are held against these plain versions on the
card by `chip_smoke.py`."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops, ref as jref
from repro.kernels.async_gather import async_gather as jgather
from repro.kernels.async_scatter import async_scatter as jscatter
from repro.kernels.stream_triad import stream_triad as jtriad
from repro_torch.kernels import async_gather as tgather
from repro_torch.kernels import async_scatter as tscatter
from repro_torch.kernels import ops, ref
from repro_torch.kernels import stream_triad as ttriad
from repro_torch.launch import quickstart

from test_torch_util import to_np, to_torch

SCATTER_TOL = dict(atol=1e-4, rtol=1e-4)     # tests/test_kernels.py


def _tol(dtype):
    """float32: tests/test_kernels.py's triad limit (the reference's CPU
    contracts b + s * c into one FMA, the port rounds the product and the
    sum). bfloat16 and float16 are equal: the port rounds where the
    reference's kernel does (bfloat16 the product and the sum, float16
    once)."""
    if dtype == "float32":
        return dict(atol=1e-6, rtol=1e-6)
    return dict(atol=0, rtol=0)


# The reference's eager `ref.triad_ref` rounds float16 after the product and
# after the sum, its kernel (and the port) once at the end: the two differ by
# up to half a step of |s c| (2^-11 of it, ~6e-3 at |s c| = 12) and a step
# of the result (2^-10).
F16_REF_TOL = dict(atol=1e-2, rtol=2e-3)


# ------------------------------------------------------------- async_gather
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
@pytest.mark.parametrize("n,d,m,bm,k", [
    (64, 128, 256, 128, 8),
    (512, 256, 128, 64, 4),
    (33, 128, 64, 32, 2),
    (1024, 512, 512, 256, 16),
])
def test_async_gather(n, d, m, bm, k, dtype):
    rng = np.random.default_rng(10)
    if dtype == "int32":
        table = jnp.array(rng.integers(0, 1 << 20, (n, d)), jnp.int32)
    else:
        table = jnp.array(rng.standard_normal((n, d)), getattr(jnp, dtype))
    idx = jnp.array(rng.integers(0, n, m), jnp.int32)
    got = tgather.async_gather(to_torch(table), to_torch(idx), block_m=bm,
                               num_slots=k)
    assert got.dtype == getattr(torch, dtype) and got.shape == (m, d)
    np.testing.assert_array_equal(
        to_np(got), to_np(jgather(table, idx, block_m=bm, num_slots=k,
                                  interpret=True)))
    np.testing.assert_array_equal(to_np(got),
                                  to_np(jref.gather_ref(table, idx)))


@pytest.mark.parametrize("dtype,d", [
    ("bfloat16", 3), ("int8", 3), ("float16", 1), ("int8", 1), ("int8", 2),
    ("bfloat16", 5), ("int8", 4099)])
def test_async_gather_any_row_width(dtype, d):
    """Rows of 6, 3, 2, 1, 2 and 10 bytes and a long row of 4099 bytes, which
    neither cp.async nor a bulk copy can move: the element path's plain
    version against the reference's Pallas kernel, bit for bit."""
    rng = np.random.default_rng(16 + d)
    n, m = 100, 64
    if dtype == "int8":
        table = jnp.array(rng.integers(-128, 128, (n, d)), jnp.int8)
    else:
        table = jnp.array(rng.standard_normal((n, d)), getattr(jnp, dtype))
    idx = jnp.array(rng.integers(0, n, m), jnp.int32)
    got = tgather.async_gather(to_torch(table), to_torch(idx), block_m=32,
                               num_slots=4)
    assert got.dtype == getattr(torch, dtype) and got.shape == (m, d)
    assert tgather.gather_path(d * got.element_size(), 16)[1] < 4
    np.testing.assert_array_equal(
        to_np(got), to_np(jgather(table, idx, block_m=32, num_slots=4,
                                  interpret=True)))


# ------------------------------------------------------------ async_scatter
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("n,d,m,bm", [(64, 128, 256, 128), (8, 2, 64, 32)])
def test_async_scatter_add_16bit(dtype, n, d, m, bm):
    """bf16 and f16 add with conflicts: the reference adds in update order,
    rounding after each add; the port's plain version (and the card's L2)
    in another order. They agree within `ref.scatter_add16_limit`, 2 c u
    (1 + u)^c (|t| + sum |u_j|) for an element hit c times."""
    rng = np.random.default_rng(17)
    jdt = getattr(jnp, dtype)
    table = jnp.array(rng.standard_normal((n, d)), jdt)
    idx = jnp.array(rng.integers(0, n, m), jnp.int32)
    upd = jnp.array(rng.standard_normal((m, d)), jdt)
    tt, ti, tu = to_torch(table), to_torch(idx), to_torch(upd)
    limit = ref.scatter_add16_limit(tt, ti, tu)
    got = tscatter.async_scatter(tt.clone(), ti, tu, op="add", block_m=bm)
    assert got.dtype == getattr(torch, dtype)
    want = torch.tensor(to_np(jscatter(table, idx, upd, op="add",
                                       block_m=bm, interpret=True)))
    err = (got.float() - want.float()).abs()
    assert bool((err <= limit).all()), float((err - limit).max())
    # each order is within half the limit of the exact sum
    exact = tt.double().index_add(0, ti.long(), tu.double())
    for x in (got, want):
        assert bool(((x.double() - exact).abs() <= limit / 2).all())
    untouched = limit == 0
    assert torch.equal(got.float()[untouched], tt.float()[untouched])


@pytest.mark.parametrize("op", ["add", "xor"])
def test_async_scatter_uint32(op):
    """uint32 add and xor, exact: the int32 kernels on an int32 view of the
    same bits (two's-complement add and xor ignore the sign), against the
    reference on uint32."""
    rng = np.random.default_rng(18)
    n, d, m = 32, 4, 256
    table = rng.integers(0, 1 << 32, (n, d), dtype=np.uint64).astype(np.uint32)
    idx = rng.integers(0, n, m).astype(np.int32)
    upd = rng.integers(0, 1 << 32, (m, d), dtype=np.uint64).astype(np.uint32)
    tt = torch.from_numpy(table.copy())
    got = tscatter.async_scatter(tt, torch.from_numpy(idx),
                                 torch.from_numpy(upd), op=op, block_m=128)
    assert got is tt and got.dtype == torch.uint32
    jt, ji, ju = jnp.array(table), jnp.array(idx), jnp.array(upd)
    want = np.asarray(jscatter(jt, ji, ju, op=op, block_m=128,
                               interpret=True))
    np.testing.assert_array_equal(got.view(torch.int32).numpy(),
                                  want.view(np.int32))
    np.testing.assert_array_equal(
        got.view(torch.int32).numpy(),
        np.asarray(jref.scatter_update_ref(jt, ji, ju, op)).view(np.int32))


@pytest.mark.parametrize("n,d,m,bm,k", [
    (64, 128, 256, 128, 8),   # heavy conflicts
    (8, 128, 64, 32, 4),      # extreme conflicts
    (1024, 256, 128, 128, 8), # sparse
    (16, 8, 128, 64, 8),
])
def test_async_scatter_add(n, d, m, bm, k):
    rng = np.random.default_rng(11)
    table = rng.standard_normal((n, d)).astype(np.float32)
    idx = rng.integers(0, n, m).astype(np.int32)
    upd = rng.standard_normal((m, d)).astype(np.float32)
    tt = to_torch(table)
    got = tscatter.async_scatter(tt, to_torch(idx), to_torch(upd), op="add",
                                 block_m=bm, num_slots=k)
    assert got is tt                          # in place, as the kernel is
    jt, ji, ju = jnp.array(table), jnp.array(idx), jnp.array(upd)
    np.testing.assert_allclose(
        to_np(got), to_np(jscatter(jt, ji, ju, op="add", block_m=bm,
                                   num_slots=k, interpret=True)),
        **SCATTER_TOL)
    np.testing.assert_allclose(
        to_np(got), to_np(jref.scatter_update_ref(jt, ji, ju, "add")),
        **SCATTER_TOL)


def test_async_scatter_xor_gups():
    """GUPS semantics: integer xor RMW with many conflicts, exact."""
    rng = np.random.default_rng(12)
    n, d, m = 32, 8, 256
    table = rng.integers(0, 1 << 30, (n, d)).astype(np.int32)
    idx = rng.integers(0, n, m).astype(np.int32)
    upd = rng.integers(0, 1 << 30, (m, d)).astype(np.int32)
    got = tscatter.async_scatter(to_torch(table), to_torch(idx),
                                 to_torch(upd), op="xor", block_m=128,
                                 num_slots=8)
    jt, ji, ju = jnp.array(table), jnp.array(idx), jnp.array(upd)
    np.testing.assert_array_equal(
        to_np(got), to_np(jscatter(jt, ji, ju, op="xor", block_m=128,
                                   num_slots=8, interpret=True)))
    np.testing.assert_array_equal(
        to_np(got), to_np(jref.scatter_update_ref(jt, ji, ju, "xor")))


def _fuzz_cases():
    """The 10 seeded cases of tests/test_kernels.py::test_async_scatter_fuzz,
    drawn in its order."""
    rng = np.random.default_rng(7)
    cases = []
    for _ in range(10):
        n = int(rng.integers(4, 128))
        bm = int(rng.choice([16, 64]))
        m = bm * int(rng.integers(1, 4))
        k = int(rng.choice([2, 4, 8]))
        table = rng.standard_normal((n, 32)).astype(np.float32)
        idx = rng.integers(0, n, m).astype(np.int32)
        upd = rng.standard_normal((m, 32)).astype(np.float32)
        cases.append((bm, k, table, idx, upd))
    return cases


@pytest.mark.parametrize("case", range(10))
def test_async_scatter_fuzz(case):
    """Against the reference's oracle only (its interpret-mode fuzz is a slow
    test there)."""
    bm, k, table, idx, upd = _fuzz_cases()[case]
    got = tscatter.async_scatter(to_torch(table), to_torch(idx),
                                 to_torch(upd), op="add", block_m=bm,
                                 num_slots=k)
    np.testing.assert_allclose(
        to_np(got), to_np(jref.scatter_update_ref(
            jnp.array(table), jnp.array(idx), jnp.array(upd), "add")),
        **SCATTER_TOL)


def test_scatter_xor_rounds_equal_a_python_loop():
    """The plain xor applies its updates in rounds of distinct rows; a loop
    over every update in order gives the same table."""
    rng = np.random.default_rng(13)
    table = rng.integers(-(1 << 31), 1 << 31, (8, 4), dtype=np.int64)
    table = torch.from_numpy(table.astype(np.int32))
    idx = torch.from_numpy(rng.integers(0, 8, 512).astype(np.int32))
    upd = torch.from_numpy(
        rng.integers(-(1 << 31), 1 << 31, (512, 4)).astype(np.int32))
    want = table.clone()
    for j in range(512):
        want[idx[j]] ^= upd[j]
    got = ref.scatter_update_ref(table, idx, upd, op="xor")
    assert torch.equal(got, want)
    assert not torch.equal(got, table)


def test_scatter_update_keeps_its_input_and_async_scatter_does_not():
    rng = np.random.default_rng(14)
    table = to_torch(rng.standard_normal((40, 16)).astype(np.float32))
    idx = to_torch(rng.integers(0, 40, 100).astype(np.int32))
    upd = to_torch(rng.standard_normal((100, 16)).astype(np.float32))
    before = table.clone()
    out = ops.scatter_update(table, idx, upd)
    assert torch.equal(table, before) and out is not table
    again = tscatter.async_scatter(table, idx, upd)
    assert again is table and torch.equal(table, out)
    assert not torch.equal(table, before)


# -------------------------------------------------------------- stream_triad
@pytest.mark.parametrize("n,block", [(4096, 512), (8192, 1024), (512, 512)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_stream_triad(n, block, dtype):
    rng = np.random.default_rng(15)
    jdt = getattr(jnp, dtype)
    b = jnp.array(rng.standard_normal(n), jdt)
    c = jnp.array(rng.standard_normal(n), jdt)
    got = ttriad.stream_triad(to_torch(b), to_torch(c), 3.0, block=block)
    assert got.dtype == getattr(torch, dtype) and got.shape == (n,)
    np.testing.assert_allclose(
        to_np(got), to_np(jtriad(b, c, 3.0, block=block, interpret=True)),
        **_tol(dtype))
    np.testing.assert_allclose(to_np(got), to_np(jref.triad_ref(b, c, 3.0)),
                               **(F16_REF_TOL if dtype == "float16"
                                  else _tol(dtype)))


def test_triad_rounds_the_scalar_to_the_arrays_type():
    """s = 1 + 3/512 is not a bf16 value; rounded it is 1 + 1/128, and
    -128 + 128 s is then 1, where the unrounded s would give 0.75."""
    b = torch.full((4,), -128.0, dtype=torch.bfloat16)
    c = torch.full((4,), 128.0, dtype=torch.bfloat16)
    s = 1.0 + 3.0 / 512
    got = ttriad.stream_triad(b, c, s)
    assert torch.equal(got, torch.ones(4, dtype=torch.bfloat16))
    want = jref.triad_ref(jnp.array(to_np(b), jnp.bfloat16),
                          jnp.array(to_np(c), jnp.bfloat16),
                          float(np.float32(s)))
    np.testing.assert_array_equal(to_np(got), to_np(want))


@pytest.mark.parametrize("n", [0, 1, 3, 7, 4097, (1 << 20) + 5, 1 << 28])
@pytest.mark.parametrize("item,block,stages", [(4, 512, 4), (2, 512, 4),
                                               (4, 1024, 2), (2, 128, 8),
                                               (1, 512, 4), (1, 128, 8),
                                               (1, 1024, 2), (2, 256, 3),
                                               (4, 512, 1), (2, 512, 1),
                                               (1, 512, 1), (1, 8192, 4),
                                               (1, 4096, 8), (2, 4096, 4),
                                               (4, 4096, 4)])
def test_triad_plan_covers_the_arrays_once(n, item, block, stages):
    """The kernel's grid-stride steps and its scalar tail cover [0, N)
    exactly once. A step is `block` x STEP_ITEM bytes in every type where
    `stages` of them fit (`step_blocks`: at most STEP_ITEM / item bulk
    copies of at most `block` elements each, whole 16-byte chunks),
    consecutive within the step. The plan gives a block one thread a
    16-byte chunk of a step (128 at block 512, whatever the type), keeps its
    loads in flight near INFLIGHT_BYTES an SM and its blocks within an SM's
    shared memory and threads."""
    k = ttriad.step_blocks(item, block, stages)
    step_bytes = k * block * item
    assert k == ttriad.STEP_ITEM // item \
        or stages * 2 * block * ttriad.STEP_ITEM > ttriad.MAX_SMEM
    smem = 2 * stages * step_bytes + 16 * stages       # slots and barriers
    assert smem <= ttriad.MAX_SMEM
    plan = ttriad.triad_plan(n, item, block, stages, sms=132, smem=smem)
    assert plan.per_sm * (smem + 1024) <= ttriad.SM_SMEM
    assert plan.per_sm * (plan.threads + 32) <= 2048    # and a producer warp
    assert plan.threads == min(256, max(32, step_bytes // 16))
    if block == 512:
        assert plan.threads == 128
    assert 1 <= plan.per_sm and plan.blocks <= max(1, plan.per_sm * 132)
    inflight = plan.per_sm * stages * 2 * step_bytes
    assert plan.per_sm == 2 or inflight < ttriad.INFLIGHT_BYTES \
        + stages * 2 * step_bytes
    if n > 1 << 24:
        return                   # the cover below walks every step
    vec = 16 // item
    steps, (tail0, tail) = ttriad.triad_steps(n, item, block, stages,
                                              plan.blocks)
    assert len(steps) == plan.blocks and 0 <= tail < vec
    assert sum(map(len, steps)) == -(-(n // vec) // (step_bytes // 16))
    covered = np.zeros(n, np.int32)
    for block_steps in steps:
        for copies in block_steps:
            assert 1 <= len(copies) <= k
            assert sum(count for _, count in copies) * item <= step_bytes
            for (first, count), nxt in zip(copies, copies[1:]):
                assert nxt[0] == first + count      # one step, consecutive
            for first, count in copies:
                assert 0 < count <= block
                assert count % vec == 0 and first % vec == 0
                covered[first:first + count] += 1
    covered[tail0:tail0 + tail] += 1
    assert covered.min(initial=1) == 1 and covered.max(initial=1) == 1


@pytest.mark.parametrize("item", [1, 2, 4])
def test_triad_step_blocks_take_every_ring_of_one_block_a_step(item):
    """`step_blocks` takes every (block, stages) whose ring of one block a
    step fits, whatever the type, as the reference takes any block: 4 /
    item blocks a step where they fit, else the most that fit (a power of
    two), and 0, a refusal on every device, only where one block does not."""
    full = ttriad.STEP_ITEM // item
    for stages in (1, 2, 3, 4, 8):
        for block in range(128, 32768 + 1, 128):
            def ring(k):
                return stages * (2 * k * block * item + 16)
            k = ttriad.step_blocks(item, block, stages)
            if ring(1) > ttriad.MAX_SMEM:
                assert k == 0
                continue
            assert k in (1, 2, 4) and k <= full \
                and ring(k) <= ttriad.MAX_SMEM
            assert k == full or ring(2 * k) > ttriad.MAX_SMEM
    assert ttriad.step_blocks(1, 8192, 4) == 2     # 4 x 32 KB rings pass
    assert ttriad.step_blocks(1, 4096, 8) == 2
    assert ttriad.step_blocks(2, 8192, 4) == 1
    b = torch.zeros(16, dtype={1: torch.int8, 2: torch.int16,
                               4: torch.int32}[item])
    torch.testing.assert_close(ttriad.stream_triad(b, b, 1.0, 8192, 2), b)
    with pytest.raises(ValueError, match="do not fit"):
        ttriad.stream_triad(b, b, 1.0, block=32768 // item, stages=4)


# ------------------------------------------------------------- ops wrappers
@pytest.mark.parametrize("m", [37, 1000])
def test_ops_paths_at_lengths_off_the_block(m):
    """The reference pads to the block (a sink row for scatter); the port's
    kernels mask the tail. int64 indices are narrowed as the reference
    does."""
    rng = np.random.default_rng(16)
    table = jnp.array(rng.standard_normal((100, 64)), jnp.float32)
    idx = rng.integers(0, 100, m)
    tt, ti = to_torch(table), torch.from_numpy(idx)
    np.testing.assert_array_equal(
        to_np(ops.gather(tt, ti, block_m=16)),
        to_np(jops.gather(table, jnp.array(idx, jnp.int32), block_m=16)))
    upd = jnp.array(rng.standard_normal((m, 64)), jnp.float32)
    np.testing.assert_allclose(
        to_np(ops.scatter_update(tt, ti, to_torch(upd), block_m=16,
                                 num_slots=4)),
        to_np(jops.scatter_update(table, jnp.array(idx, jnp.int32), upd,
                                  block_m=16, num_slots=4)), **SCATTER_TOL)
    b = jnp.array(rng.standard_normal(m), jnp.float32)
    c = jnp.array(rng.standard_normal(m), jnp.float32)
    np.testing.assert_allclose(
        to_np(ops.triad(to_torch(b), to_torch(c), 2.5, block=512)),
        to_np(jops.triad(b, c, 2.5, block=512)), **_tol("float32"))


# --------------------------------------------------------- quickstart twin
def test_quickstart_twin_at_its_shape(capsys):
    """The reference quickstart's kernel half: its draws (numpy seed 0, a
    [4096, 128] int32 table, 512 updates, 8 slots), the port's xor scatter,
    the reference's oracle."""
    res = quickstart.gups(device="cpu")
    assert res["ok"]
    rng = np.random.default_rng(0)
    table = jnp.array(rng.integers(0, 1 << 30, (4096, 128)), jnp.int32)
    idx = jnp.array(rng.integers(0, 4096, 512), jnp.int32)
    upd = jnp.array(rng.integers(0, 1 << 30, (512, 128)), jnp.int32)
    np.testing.assert_array_equal(to_np(res["table"]), np.asarray(table))
    np.testing.assert_array_equal(
        to_np(res["out"]),
        np.asarray(jref.scatter_update_ref(table, idx, upd, op="xor")))
    assert quickstart.main(["--device", "cpu", "--table-rows", "64",
                            "--row-width", "2", "--updates", "300"]) == 0
    assert capsys.readouterr().out.rstrip().endswith("OK")


def test_quickstart_device_source_draws_on_the_device():
    a = quickstart.gups(table_rows=64, row_width=2, updates=100,
                        device="cpu", source="device")
    b = quickstart.gups(table_rows=64, row_width=2, updates=100,
                        device="cpu", source="device")
    assert a["ok"] and torch.equal(a["out"], b["out"])
    assert a["table"].dtype == torch.int32 and a["table"].shape == (64, 2)


# --------------------------------------------------------------- refusals
def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("call,exc,match", [
    (lambda: tscatter.async_scatter(torch.zeros(4, 4), _i32(3),
                                    torch.zeros(3, 4), op="xor"),
     TypeError, "xor takes"),
    (lambda: tscatter.async_scatter(torch.zeros(4, 4, dtype=torch.bfloat16),
                                    _i32(3),
                                    torch.zeros(3, 4, dtype=torch.bfloat16),
                                    op="xor"),
     TypeError, "xor takes"),
    (lambda: tscatter.async_scatter(torch.zeros(4, 4), _i32(3),
                                    torch.zeros(3, 4), op="max"),
     ValueError, "op"),
    (lambda: tscatter.async_scatter(torch.zeros(4, 4), _i32(3),
                                    torch.zeros(2, 4)),
     ValueError, "updates"),
    (lambda: tscatter.async_scatter(
        torch.zeros(4, 3, dtype=torch.float8_e4m3fn), _i32(3),
        torch.zeros(3, 3, dtype=torch.float8_e4m3fn), op="xor"),
     TypeError, "xor takes"),
    (lambda: tgather.async_gather(torch.zeros(4, 4), torch.zeros(3).long()),
     TypeError, "int32"),
    (lambda: tgather.async_gather(torch.zeros(4, 60000), _i32(3),
                                  num_slots=1),
     ValueError, "shared memory"),
    (lambda: ttriad.stream_triad(torch.zeros(8, dtype=torch.int64),
                                 torch.zeros(8, dtype=torch.int64), 1.0),
     TypeError, "64-bit types"),
    (lambda: ttriad.stream_triad(torch.zeros(8), torch.zeros(8), 1.0,
                                 block=100),
     ValueError, "multiple of 128"),
    (lambda: tgather.async_gather(_meta(4, 4), _meta(3, dtype=torch.int32)),
     ValueError, "unsupported device"),
    (lambda: tgather.async_gather(torch.zeros(2, 29100), _i32(1),
                                  num_slots=1),
     ValueError, "shared memory"),
    (lambda: tscatter.async_scatter(_meta(4, 4), _meta(3, dtype=torch.int32),
                                    _meta(3, 4)),
     ValueError, "unsupported device"),
    (lambda: ttriad.stream_triad(_meta(8), _meta(8), 1.0),
     ValueError, "unsupported device"),
], ids=["xor-on-f32", "bf16-scatter", "unknown-op", "updates-shape",
        "xor-on-fp8", "int64-indices", "ring-too-large", "int64-triad",
        "triad-block", "meta-gather", "bulk-ring-too-large", "meta-scatter",
        "meta-triad"])
def test_wrappers_refuse_what_the_kernels_do_not_take(call, exc, match):
    """Checked on every device alike, so the CPU sees the card's refusals."""
    with pytest.raises(exc, match=match):
        call()


def _i32(m):
    return torch.zeros(m, dtype=torch.int32)


@pytest.mark.parametrize("row_bytes,chunk,lanes,warps", [
    (8, 8, 1, 4),          # HPCC rows: a ring a lane
    (12, 4, 2, 4),         # three 4-byte chunks, two lanes
    (512, 16, 32, 4),      # the quickstart's rows: a ring a warp
    (4096, 16, 32, 4),     # qwen2.5-3b's embedding rows, bf16
])
def test_ring_plan(row_bytes, chunk, lanes, warps):
    plan = tgather.ring_plan(row_bytes, 256, 8)
    assert (plan.chunk, plan.lanes, plan.warps) == (chunk, lanes, warps)
    assert plan.smem == 1024 + plan.rings * 8 * row_bytes
    assert plan.smem <= tgather.MAX_SMEM
    # deep rings of wide rows take fewer warps, never more room than a block
    deep = tgather.ring_plan(row_bytes, 256, 32)
    assert deep.smem <= tgather.MAX_SMEM and deep.warps <= warps


# ----------------------------------------------------------- gather plan
def _h100_blocks_per_sm(bulk, chunk, warps, smem):
    """An H100's occupancy limits at the gather's block shapes: 32 blocks,
    64 warps and 228 KB of shared memory an SM, 1 KB of it reserved a block
    (the kernels' few dozen registers bind at none of these sizes)."""
    return min(32, 64 // warps, 233472 // (smem + 1024))


@pytest.mark.parametrize("row_bytes,m,align,bulk,blocks", [
    (4096, 4000, 16, True, ">=132"),    # qwen2.5-3b's embedding fills the card
    (512, 1 << 20, 16, True, 4096),     # the 8 GiB table: 4096 blocks of 256
    (4096, 1, 16, True, 1),
    (4096, 7, 16, True, 7),
    (512, 131, 16, True, 131),
    (4096, 4000, 4, False, ">=132"),    # a 4-byte aligned table: cp.async
    (8, 1000, 16, False, None),         # HPCC rows: cp.async, a lane a ring
    (12, 333, 4, False, None),
])
def test_gather_plan(row_bytes, m, align, bulk, blocks):
    plan = tgather.gather_plan(row_bytes, m, 256, 8, align, 132,
                               _h100_blocks_per_sm)
    assert plan.bulk == bulk
    assert plan.rows * plan.blocks >= m > plan.rows * (plan.blocks - 1)
    assert plan.rows <= 256 and plan.smem <= tgather.MAX_SMEM
    assert plan.smem == tgather.gather_smem(plan.bulk, plan.rings, plan.rows,
                                            8, row_bytes)
    assert plan.per_sm == _h100_blocks_per_sm(plan.bulk, plan.chunk,
                                              plan.warps, plan.smem)
    if blocks == ">=132":
        assert plan.blocks >= 132
        assert plan.blocks <= plan.per_sm * 132      # one wave
        if plan.rows > plan.rings:                   # and no fewer rows would
            fewer = tgather.gather_smem(plan.bulk, plan.rings,
                                        plan.rows - plan.rings, 8, row_bytes)
            assert -(-m // (plan.rows - plan.rings)) > 132 * \
                _h100_blocks_per_sm(plan.bulk, plan.chunk, plan.warps, fewer)
    elif blocks is not None:
        assert plan.blocks == blocks
    assert 0 < plan.rows_in_flight_per_sm <= 8 * plan.rings * plan.per_sm


@pytest.mark.parametrize("num_slots", [2, 8, 32])
def test_gather_ring_has_no_more_slots_than_rows(num_slots):
    """A bulk ring that carries fewer rows than K has a slot a row (and one
    to drain), so from K = 2 on qwen2.5-3b's embedding gets one plan: 500
    blocks of 8 rows, 4 rings of 2 rows each."""
    plan = tgather.gather_plan(4096, 4000, 256, num_slots, 16, 132,
                               _h100_blocks_per_sm)
    assert (plan.blocks, plan.rows, plan.warps) == (500, 8, 4)
    assert plan.smem == tgather.gather_smem(True, 4, 8, 2, 4096)
    assert plan.rows_in_flight_per_sm == 2 * 4 * 4


@pytest.mark.parametrize("row_bytes", [16, 48, 512, 4096, 8, 12, 20, 4100])
@pytest.mark.parametrize("align", [16, 8, 4])
def test_gather_path_rule(row_bytes, align):
    """Bulk copies iff the row is a multiple of 16 bytes and every pointer
    16-byte aligned; otherwise the widest cp.async chunk both allow."""
    bulk, chunk, lanes = tgather.gather_path(row_bytes, align)
    assert bulk == (row_bytes % 16 == 0 and align == 16)
    assert chunk == max(w for w in (4, 8, 16)
                        if row_bytes % w == 0 and align % w == 0)
    assert lanes & (lanes - 1) == 0 and lanes <= min(32, row_bytes // chunk)


@pytest.mark.parametrize("block_m", [1, 7, 256, 4096])
def test_gather_plan_takes_block_m_as_a_bound(block_m):
    for row_bytes, m in ((4096, 4000), (512, 1 << 20), (8, 1000)):
        plan = tgather.gather_plan(row_bytes, m, block_m, 8, 16, 132,
                                   _h100_blocks_per_sm)
        assert plan.rows <= block_m
        assert plan.rows * plan.blocks >= m > plan.rows * (plan.blocks - 1)
