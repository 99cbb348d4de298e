"""The port's async_scatter plan and bucket pass against the JAX reference.

`scatter_plan` is a pure function of the shapes and the card, so its cover
of M, its shared memory and its path rule are checked here with an H100's
132 SMs and occupancy passed in. The bucket pass's plain version
(`ref.scatter_bucket_ref`) is checked for what the CUDA pass must match bit
for bit on the card (`chip_smoke.py`): a stable order and offsets that scan
the regions' histogram. The plain bucket pass followed by the plain apply
must give the reference's scatter (`repro.kernels.async_scatter` in
interpret mode, `repro.kernels.ref`): int32 exactly, float32 within 1e-4."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.async_scatter import async_scatter as jscatter
from repro_torch.kernels import async_scatter as asc
from repro_torch.kernels import ref

from test_torch_util import to_np, to_torch

SCATTER_TOL = dict(atol=1e-4, rtol=1e-4)     # tests/test_kernels.py


def _h100_blocks_per_sm(chunk, smem):
    """An H100's occupancy limits at the apply's block of 4 warps: 32
    blocks, 64 warps and 228 KB of shared memory an SM, 1 KB of it reserved
    a block (its ~30 registers bind at none of these sizes)."""
    return min(32, 64 // 4, 233472 // (smem + 1024))


def _plan(row_bytes, n, m, block_m=256, num_slots=8, align=8):
    return asc.scatter_plan(row_bytes, n, m, block_m, num_slots, align, 132,
                            _h100_blocks_per_sm)


# ------------------------------------------------------------------ plan
@pytest.mark.parametrize("row_bytes,n,m,block_m,num_slots", [
    (8, 1 << 30, 1 << 26, 256, 8),       # GUPS
    (512, 1 << 24, 1 << 20, 256, 8),     # the quickstart's rows, 8 GiB
    (8, 1000, 1, 256, 8),
    (12, 77, 7, 64, 3),
    (16, 5003, 131, 256, 8),
    (512, 1000, 4000, 256, 8),
    (4096, 3000, 4000, 1, 1),
    (8, 1 << 30, 1 << 26, 256, 32),      # the deepest ring of the K sweep
    (4, 10, 1003, 16, 2),
    (28, 1 << 20, (1 << 22) + 5, 7, 16),
])
def test_scatter_plan_covers_m_once_and_fits(row_bytes, n, m, block_m,
                                             num_slots):
    """The bulk-copied updates (M less M mod 4) are spans x span, the last
    span short; spans of a multiple of 4 and at most block_m (at least 4);
    the shared memory is the source's layout and fits; every SM has a span
    where M allows. Rows of 32 bytes and more: a persistent grid of
    BLOCKS_PER_SM an SM at most, a span at a time through K slots. The
    bucketed stream (rows narrower than a sector in a call of many updates,
    `bucketed`): a block one span of at most BUCKET_SPAN updates in one
    slot, a block for every span; the bucket pass tiles M once."""
    plan = _plan(row_bytes, n, m, block_m, num_slots)
    m4 = m - m % 4
    assert plan.span % 4 == 0 and 4 <= plan.span <= max(4, block_m)
    assert plan.spans * plan.span >= m4 > (plan.spans - 1) * plan.span \
        or plan.spans == m4 == 0
    assert plan.smem == asc.apply_smem(plan.span, plan.slots, row_bytes)
    assert plan.smem <= asc.MAX_SMEM
    assert plan.per_sm == _h100_blocks_per_sm(plan.chunk, plan.smem)
    if plan.bucket:
        assert plan.slots == 1 and plan.span <= asc.BUCKET_SPAN
        assert plan.blocks == max(1, plan.spans)
    else:
        assert plan.slots == num_slots
        per = (asc.NARROW_BLOCKS_PER_SM if row_bytes < asc.SECTOR
               else asc.BLOCKS_PER_SM)
        assert plan.blocks == max(1, min(plan.spans, min(per, plan.per_sm)
                                         * 132))
    if m4 >= 4 * 132:
        assert plan.spans >= 132
    assert plan.bucket == asc.bucketed(row_bytes, n, m)
    assert plan.bucket == (row_bytes < asc.SECTOR and m >= asc.BUCKET_M
                           and n * row_bytes >= asc.BUCKET_TABLE)
    assert plan.launches == (4 if plan.bucket else 1)
    if plan.bucket:
        assert plan.tile % plan.sub == 0
        assert plan.tiles * plan.tile >= m > (plan.tiles - 1) * plan.tile
        assert plan.buckets << plan.shift >= n \
            > (plan.buckets - 1) << plan.shift
        assert plan.buckets <= asc.MAX_BUCKETS
        assert plan.sub * (4 + row_bytes) <= 65536


@pytest.mark.parametrize("row_bytes,n,m,bucket", [
    (8, 1 << 30, 1 << 26, True),         # GUPS, bucketed as measured
    (8, 1 << 30, 1 << 24, False),        # the sweep: faster not bucketed
    (8, 1 << 30, 1 << 25, False),        # ... and even at 2^25
    (8, 1 << 30, (1 << 26) - 1, False),  # BUCKET_M
    (8, 1 << 31, 1 << 26, True),         # BUCKET_TABLE: GUPS's 8 GiB
    (8, (1 << 30) - 1, 1 << 26, False),
    (6, 1 << 24, 1 << 20, False),        # bf16 [2^24, 3] at 2^20 updates
    (6, 1 << 24, 1 << 26, False),        # ... faster at every M swept
    (6, 1 << 26, 1 << 26, False),        # ... so [2^26, 3] (384 MiB)
    (6, 1 << 28, 1 << 26, False),        # ... and [2^28, 3] (1.5 GiB)
    (6, 1 << 31, 1 << 26, True),         # a 12 GiB table of 6-byte rows
    (3, 5003, 4000, False), (6, 1 << 28, 1 << 25, False),
    (31, 1 << 30, 1 << 26, True), (32, 1 << 30, 1 << 26, False),
    (512, 1 << 24, 1 << 20, False)])
def test_scatter_bucket_rule_at_its_edges(row_bytes, n, m, bucket):
    """Bucketed by table region iff the row is narrower than a sector, the
    table holds at least BUCKET_TABLE bytes and the call at least BUCKET_M
    updates: the rule fitted to the H100 sweep of M, bucketed and not, on
    [2^24, 3], [2^26, 3] and [2^28, 3] bf16 and at GUPS (PERF.md), both
    edges on measured points; `chip_smoke.py` holds the source's
    `async_scatter_bucketed` to it."""
    assert asc.bucketed(row_bytes, n, m) == bucket
    plan = _plan(row_bytes, n, m)
    assert plan.bucket == bucket and plan.launches == (4 if bucket else 1)


@pytest.mark.parametrize("bucket", [True, False])
@pytest.mark.parametrize("row_bytes,n,m", [
    (8, 5003, 4000), (3, 5003, 1), (12, 5003, 131), (6, 1 << 24, 1 << 20),
    (8, 1 << 30, 1 << 26), (31, 77, 7), (32, 1000, 4000),
    (512, 1000, 4000)])
def test_scatter_plan_takes_the_path_it_is_given(row_bytes, n, m, bucket):
    """`bucket` overrides the rule for rows narrower than a sector (the
    card's checks run every edge down both paths, whatever its size), and
    is ignored for wider rows, which the bucket pass does not take; the
    plan is then the one the rule would give on that path."""
    plan = asc.scatter_plan(row_bytes, n, m, 256, 8, 8, 132,
                            _h100_blocks_per_sm, bucket=bucket)
    assert plan.bucket == (bucket and row_bytes < asc.SECTOR)
    assert plan.launches == (4 if plan.bucket else 1)
    if plan.bucket:
        assert plan.slots == 1 and plan.span <= asc.BUCKET_SPAN
        assert plan.blocks == max(1, plan.spans)
        assert plan.tiles * plan.tile >= m > (plan.tiles - 1) * plan.tile
        assert plan.buckets << plan.shift >= n \
            > (plan.buckets - 1) << plan.shift
    else:
        assert plan.slots == 8 and plan.tiles == 0
    if plan.bucket == asc.bucketed(row_bytes, n, m):
        assert plan == _plan(row_bytes, n, m)


def test_scatter_plan_at_gups_and_at_512_byte_rows():
    """GUPS: 256 regions of 2^22 rows (32 MB), 528 tiles of 32 sub-chunks,
    then a block for every 64 updates of the bucketed stream in one slot,
    one b64 reduction a lane, 16 blocks an SM. 512-byte rows: no bucket pass,
    a warp a row, two persistent blocks an SM, spans sized for them."""
    gups = _plan(8, 1 << 30, 1 << 26)
    assert (gups.bucket, gups.shift, gups.buckets, gups.tiles) == \
        (True, 22, 256, 512)
    assert gups.tile == 32 * gups.sub == 32 * 4096
    assert (gups.span, gups.slots, gups.blocks, gups.chunk, gups.lanes) == \
        (64, 1, 1 << 20, 8, 1)
    assert gups.updates_in_flight_per_sm == 64 * 16
    wide = _plan(512, 1 << 24, 1 << 20)
    assert not wide.bucket and wide.lanes == 32 and wide.blocks == 264
    assert wide.slots == 8 and wide.updates_in_flight_per_sm == 8 * 24 * 2
    assert 2 * (wide.smem + 1024) <= 233472 < 2 * (
        asc.apply_smem(wide.span + 4, 8, 512) + 1024)


@pytest.mark.parametrize("op,dtype,align,chunk", [
    ("xor", torch.int32, 16, 8),      # red.xor.b64, never two at a stride
    ("add", torch.int32, 16, 4),      # red.add.s32
    ("add", torch.float32, 16, 16),   # atomicAdd(float4)
    ("add", torch.float32, 8, 8),     # a table 8 bytes off 16
    ("xor", torch.int32, 4, 4),
])
def test_scatter_plan_reduces_one_instruction_a_chunk(op, dtype, align,
                                                      chunk):
    plan = _plan(512, 1 << 24, 1 << 20,
                 align=min(align, asc.REDUCE_WIDTH[op, dtype]))
    assert plan.chunk == chunk
    assert plan.lanes == min(32, 512 // chunk)


@pytest.mark.parametrize("num_slots", [1, 2, 4, 8, 16, 32])
def test_gups_ring_depth_does_not_move_the_bucketed_plan(num_slots):
    """On the bucketed stream a block is one slot of one span: the K sweep
    of chip_smoke.py at GUPS leaves the plan as it is."""
    plan = _plan(8, 1 << 30, 1 << 26, num_slots=num_slots)
    assert plan == _plan(8, 1 << 30, 1 << 26, num_slots=1)


@pytest.mark.parametrize("block_m,in_flight", [(8, 128), (16, 256),
                                               (32, 512), (64, 1024),
                                               (256, 1024)])
def test_gups_block_m_sets_the_updates_in_flight(block_m, in_flight):
    """block_m is the knob of the bucketed stream: 16 blocks an SM of up to
    BUCKET_SPAN updates each."""
    plan = _plan(8, 1 << 30, 1 << 26, block_m=block_m)
    assert plan.span == min(block_m, asc.BUCKET_SPAN)
    assert plan.updates_in_flight_per_sm == in_flight


def test_scatter_refuses_a_ring_that_cannot_fit():
    with pytest.raises(ValueError, match="shared memory"):
        _plan(4096, 1000, 4000, num_slots=32)
    table = torch.zeros(4, 1024)
    with pytest.raises(ValueError, match="shared memory"):
        asc.async_scatter(table, torch.zeros(3, dtype=torch.int32),
                          torch.zeros(3, 1024), num_slots=32)


# ------------------------------------------------------------ bucket pass
@pytest.mark.parametrize("n,m,row", [(1000, 4000, 2), (5003, 10007, 3),
                                     (1 << 20, 50000, 2), (7, 64, 4)])
def test_scatter_bucket_ref_is_a_stable_counting_sort(n, m, row):
    """The offsets are the exclusive scan of the regions' histogram, the
    order is a permutation, and within a region it keeps the input's
    order."""
    rng = np.random.default_rng(20)
    idx = rng.integers(0, n, m).astype(np.int32)
    upd = rng.integers(-(1 << 30), 1 << 30, (m, row)).astype(np.int32)
    shift, buckets, *_ = asc.bucket_layout(n, m, row * 4, 132)
    sidx, supd, offsets = ref.scatter_bucket_ref(
        torch.from_numpy(idx), torch.from_numpy(upd), shift, buckets)
    key = idx.astype(np.int64) >> shift
    hist = np.bincount(key, minlength=buckets)
    np.testing.assert_array_equal(
        offsets.numpy(), np.concatenate([[0], np.cumsum(hist)]))
    order = np.argsort(key, kind="stable")
    np.testing.assert_array_equal(sidx.numpy(), idx[order])
    np.testing.assert_array_equal(supd.numpy(), upd[order])
    for b in range(0, buckets, max(1, buckets // 50)):
        lo, hi = offsets[b].item(), offsets[b + 1].item()
        assert (sidx[lo:hi].numpy() >> shift == b).all()


def test_scatter_bucket_on_the_cpu_is_the_plain_version():
    rng = np.random.default_rng(21)
    idx = torch.from_numpy(rng.integers(0, 3000, 999).astype(np.int32))
    upd = torch.from_numpy(rng.standard_normal((999, 3)).astype(np.float32))
    got = asc.scatter_bucket(idx, upd, 3000)
    shift, buckets, *_ = asc.bucket_layout(3000, 999, 12, 132)
    assert (shift, buckets) == (4, 188)
    for g, w in zip(got, ref.scatter_bucket_ref(idx, upd, shift, buckets)):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="below 32"):
        asc.scatter_bucket(idx, torch.zeros(999, 8), 3000)


def _inputs(n, d, m, dtype, rng, idx=None):
    if dtype == "float32":
        table = rng.standard_normal((n, d)).astype(np.float32)
        upd = rng.standard_normal((m, d)).astype(np.float32)
    else:
        table = rng.integers(0, 1 << 30, (n, d)).astype(np.int32)
        upd = rng.integers(0, 1 << 30, (m, d)).astype(np.int32)
    if idx is None:
        idx = rng.integers(0, n, m)
    return table, idx.astype(np.int32), upd


@pytest.mark.parametrize("n,d,m,dtype,op,kind", [
    (1 << 12, 2, 4096, "int32", "xor", "random"),       # 8-byte rows, GUPS
    (1 << 12, 2, 4096, "int32", "add", "random"),
    (1 << 12, 2, 4096, "float32", "add", "random"),
    (64, 2, 256, "int32", "xor", "one row"),             # every update, row 17
    (64, 2, 256, "float32", "add", "one row"),
    (64, 3, 333, "int32", "xor", "last row"),            # 12-byte rows
    (3000, 3, 1003, "int32", "add", "random"),           # ragged M
    (3000, 4, 1001, "float32", "add", "random"),         # 16-byte rows
    (77, 2, 7, "int32", "xor", "random"),
    (5003, 2, 4096, "int32", "xor", "duplicates"),       # each row 8 times
])
def test_bucket_then_apply_equals_the_reference(n, d, m, dtype, op, kind):
    """The plain bucket pass, then the plain apply on its order, against
    the reference's oracle and, where M is a whole number of its blocks, its
    Pallas kernel in interpret mode."""
    rng = np.random.default_rng(22)
    idx = {"random": None, "one row": np.full(m, 17),
           "last row": np.full(m, n - 1),
           "duplicates": np.repeat(rng.integers(0, n, m // 8), 8)}[kind]
    table, idx, upd = _inputs(n, d, m, dtype, rng, idx)
    shift, buckets, *_ = asc.bucket_layout(n, m, d * 4, 132)
    sidx, supd, offsets = ref.scatter_bucket_ref(to_torch(idx),
                                                 to_torch(upd), shift,
                                                 buckets)
    assert offsets[-1].item() == m
    got = asc.async_scatter(to_torch(table), sidx, supd, op)
    jt, ji, ju = jnp.array(table), jnp.array(idx), jnp.array(upd)
    want = [jref.scatter_update_ref(jt, ji, ju, op)]
    if m % 256 == 0:
        want.append(jscatter(jt, ji, ju, op=op, block_m=256, num_slots=8,
                             interpret=True))
    for w in want:
        if dtype == "float32":
            np.testing.assert_allclose(to_np(got), to_np(w), **SCATTER_TOL)
        else:
            np.testing.assert_array_equal(to_np(got), to_np(w))
