"""async_scatter — read-modify-write rows of a table in place:
table[idx[j]] op= updates[j], op in {add, xor}.

The counterpart of `src/repro/kernels/async_scatter.py`: the CUDA source is
`csrc/async_scatter.cu` (its header note says how the reference's CAM-free
conflict check maps onto reductions at L2, and how the AMI ring reads in the
apply kernel), the plain versions are `ref.scatter_update_ref`
and, for the bucket pass, `ref.scatter_bucket_ref`. Arguments are checked
the same way on every device; then a CPU tensor runs the plain version and a
CUDA tensor launches the kernels or raises. Both update `table` in place and
return it, as the reference's kernel does through `input_output_aliases`;
`ops.scatter_update` keeps the reference's value semantics by cloning first.

`scatter_plan` lays a call over the card: whether its updates are bucketed
by table region first (rows narrower than a 32-byte sector: the fixed rule of
the source, `async_scatter_bucketed`), how the bucket pass tiles them, how
many updates a slot of the apply kernel holds, and its grid: a block a
64-update span of the bucketed stream, in the stream's order, or a
persistent K-slot ring for wider rows.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple, Tuple

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.async_gather import MAX_SMEM, _align, check_ring_args

OPS = {"add": 0, "xor": 1}          # `enum Op` of csrc/async_scatter.cu
TYPES = {"add": (torch.float32, torch.int32), "xor": (torch.int32,)}
# the widest single reduction of each (op, type): red.xor.b64, red.add.s32,
# the vector atomicAdd(float4); wider chunks of xor or int32 add would be
# several reductions a lane at a stride, each sector met more than once
REDUCE_WIDTH = {("xor", torch.int32): 8, ("add", torch.int32): 4,
                ("add", torch.float32): 16}
SECTOR = 32             # bytes of an L2 sector: narrower rows are bucketed
MAX_BUCKETS = 256       # table regions of the bucket pass (32 MB at GUPS)
BLOCKS_PER_SM = 2       # persistent apply blocks an SM (of 4 warps each)
BUCKET_SPAN = 64        # updates a block takes of the bucketed stream

launches = 0            # +1 for every launch of a CUDA kernel, nowhere else


class ScatterPlan(NamedTuple):
    """How a call of `async_scatter` covers M updates on a card."""
    bucket: bool        # updates bucketed by table region before the apply
    shift: int          # bucket = idx >> shift
    buckets: int        # table regions
    sub: int            # updates a bucket-pass block sorts at a time
    tile: int           # updates a bucket-pass block takes
    tiles: int          # blocks of each bucket-pass kernel
    chunk: int          # bytes one reduction takes: 16, 8 or 4
    lanes: int          # lanes that share one update row
    span: int           # updates a slot of the apply's ring (a multiple of 4)
    spans: int          # slots of work: the bulk-copied updates over span
    blocks: int         # blocks of the apply, grid-stride over the spans
    smem: int           # shared-memory bytes an apply block
    per_sm: int         # apply blocks an SM holds at once (occupancy)
    slots: int          # K: spans in flight in a block (1 when bucketed)
    sms: int            # SMs of the card

    @property
    def launches(self) -> int:
        """Kernels a call launches: the bucket pass's three, the apply."""
        return 4 if self.bucket else 1

    @property
    def updates_in_flight_per_sm(self) -> int:
        """The paper's memory-level parallelism: updates whose aload is in
        flight, K spans a block (fewer where a block has fewer to take) x
        the blocks an SM runs at once."""
        depth = min(self.slots, _ceil(self.spans, self.blocks))
        return depth * self.span * min(self.per_sm, _ceil(self.blocks,
                                                          self.sms))


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def apply_smem(span: int, num_slots: int, row_bytes: int) -> int:
    """Shared memory of an apply block, as csrc/async_scatter.cu's
    `apply_smem` lays it out: K full and K empty mbarriers, the span of each
    slot, then K slots of span indices and span rows."""
    slots = _ceil(2 * num_slots * 8 + num_slots * 4, 16) * 16
    return slots + num_slots * span * (4 + row_bytes)


def bucket_layout(n: int, m: int, row_bytes: int,
                  sms: int) -> Tuple[int, int, int, int, int]:
    """(shift, buckets, sub, tile, tiles) of the bucket pass: regions of
    2^shift rows, the fewest that make at most MAX_BUCKETS of them (one row
    each for tables of up to MAX_BUCKETS rows); sub-chunks of 4096 updates
    (2048 for rows over 12 bytes), whose indices and rows take at most 64 KB
    of shared memory sorted; about four tiles an SM."""
    shift = max(0, (n - 1).bit_length() - (MAX_BUCKETS.bit_length() - 1))
    buckets = ((n - 1) >> shift) + 1
    sub = 4096 if (4 + row_bytes) * 4096 <= 65536 else 2048
    tile = sub * _ceil(max(1, _ceil(m, sub)), 4 * sms)
    return shift, buckets, sub, tile, max(1, _ceil(m, tile))


def scatter_plan(row_bytes: int, n: int, m: int, block_m: int,
                 num_slots: int, align: int, sms: int,
                 blocks_per_sm: Callable[[int, int], int]) -> ScatterPlan:
    """The call of `m` updates of `row_bytes` into a table of `n` rows on a
    card of `sms` SMs. `align` is the largest of 16, 8, 4 dividing the
    table's address and the op's widest reduction (REDUCE_WIDTH): the
    reduction's chunk is the widest of 16, 8, 4 dividing it and the row.
    `blocks_per_sm(chunk, smem)` is the apply's occupancy.

    Bucketed iff the row is narrower than a sector. A span of the apply
    takes at most `block_m` updates (rounded down to a multiple of 4, the
    bulk copies' unit, and at least 4) and no more than a share of the
    card's M (so that every SM gets a span where M allows). The bucketed
    stream: spans of at most BUCKET_SPAN, one slot a block and a block a
    span, so that the card's blocks walk the stream in order with few
    updates in flight (`num_slots` does not apply). Wider rows: K slots a
    block, spans small enough to leave room for BLOCKS_PER_SM blocks an SM,
    a persistent grid of BLOCKS_PER_SM blocks an SM, or fewer if the spans
    or the occupancy are fewer. Raises where K slots of 4 updates do not
    fit."""
    chunk = next((w for w in (16, 8, 4)
                  if row_bytes % w == 0 and align % w == 0), None)
    if chunk is None:
        raise ValueError("rows must be a multiple of 4 bytes and the table "
                         "start on a 4-byte boundary")
    lanes = 1 << (min(32, row_bytes // chunk).bit_length() - 1)
    m4 = m - m % 4
    bucket = row_bytes < SECTOR
    # a span: at most block_m updates, no more than a share of M an SM
    span = min(max(4, block_m // 4 * 4), max(4, m4 // sms // 4 * 4))
    if bucket:      # a block one span of BUCKET_SPAN at most, one slot
        span, slots = min(span, BUCKET_SPAN), 1
    else:           # K slots of a span, leaving room for two blocks an SM
        slots = num_slots
        budget = MAX_SMEM // BLOCKS_PER_SM - 1024
        while span > 4 and apply_smem(span, slots, row_bytes) > budget:
            span -= 4
    smem = apply_smem(span, slots, row_bytes)
    if smem > MAX_SMEM:
        raise ValueError(f"{num_slots} slots of 4 updates of {row_bytes}-"
                         f"byte rows do not fit in {MAX_SMEM} bytes of "
                         "shared memory")
    per_sm = blocks_per_sm(chunk, smem)
    if per_sm < 1:
        raise ValueError(f"an apply block of {smem} bytes of shared memory "
                         "does not fit on an SM")
    spans = _ceil(m4, span)
    if bucket:      # a block a span, the blocks in the stream's order
        blocks = max(1, spans)
    else:           # persistent, a span at a time through the K slots
        blocks = max(1, min(spans, min(BLOCKS_PER_SM, per_sm) * sms))
    shift, buckets, sub, tile, tiles = (bucket_layout(n, m, row_bytes, sms)
                                        if bucket else (0, 0, 0, 0, 0))
    return ScatterPlan(bucket, shift, buckets, sub, tile, tiles, chunk, lanes,
                       span, spans, blocks, smem, per_sm, slots, sms)


def _bind():
    lib = _build.load("async_scatter")
    fn = lib.async_scatter_launch
    if not fn.argtypes:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, p, p, ll, ll, i, i, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
        lib.async_scatter_bucket_launch.argtypes = [p, p, p, p, p, p, p, ll,
                                                    ll, i, i, i, i, i, i, p]
        lib.async_scatter_bucket_launch.restype = ctypes.c_int
        lib.async_scatter_blocks_per_sm.argtypes = [i, i, i, i,
                                                    ctypes.POINTER(i)]
        lib.async_scatter_blocks_per_sm.restype = ctypes.c_int
        lib.async_scatter_apply_smem.argtypes = [i, i, i]
        lib.async_scatter_apply_smem.restype = ctypes.c_longlong
        lib.async_scatter_bucketed.argtypes = [i]
        lib.async_scatter_bucketed.restype = ctypes.c_int
    return lib, fn


@functools.lru_cache(maxsize=None)
def _blocks_per_sm(device: int, op: str, dtype: torch.dtype, chunk: int,
                   smem: int) -> int:
    """The runtime's occupancy calculator, asked once per plan shape."""
    lib, _ = _bind()
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device):
        _build.check(lib, lib.async_scatter_blocks_per_sm(
            OPS[op], _build.DTYPE_CODES[dtype], chunk, smem,
            ctypes.byref(blocks)), "async_scatter occupancy")
    return blocks.value


@functools.lru_cache(maxsize=4096)
def _card_plan(device: int, op: str, dtype: torch.dtype, row_bytes: int,
               n: int, m: int, block_m: int, num_slots: int,
               align: int) -> ScatterPlan:
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return scatter_plan(row_bytes, n, m, block_m, num_slots, align, sms,
                        functools.partial(_blocks_per_sm, device, op, dtype))


def launch_plan(table: torch.Tensor, m: int, op: str = "add",
                block_m: int = 256, num_slots: int = 8) -> ScatterPlan:
    """The plan `async_scatter` launches for `m` updates of this CUDA table,
    cached per type, row, table size, M and card."""
    n, d = table.shape
    return _card_plan(table.device.index, op, table.dtype,
                      d * table.element_size(), n, m, block_m, num_slots,
                      min(_align(table.data_ptr()),
                          REDUCE_WIDTH[op, table.dtype]))


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """x itself where it starts on a 16-byte boundary (the bulk copies'
    unit), else a copy that does."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _bucket(indices: torch.Tensor, updates: torch.Tensor, n: int,
            layout: Tuple[int, int, int, int, int]):
    """The bucket pass on the card (`layout` from `bucket_layout`): three
    launches."""
    global launches
    shift, buckets, sub, tile, tiles = layout
    m, dev = indices.shape[0], indices.device
    out_idx = torch.empty(m, dtype=torch.int32, device=dev)
    out_upd = torch.empty_like(updates)
    counts = torch.empty(buckets * tiles, dtype=torch.int32, device=dev)
    totals = torch.empty(buckets, dtype=torch.int32, device=dev)
    offsets = torch.empty(buckets + 1, dtype=torch.int32, device=dev)
    lib, _ = _bind()
    with torch.cuda.device(dev):
        code = lib.async_scatter_bucket_launch(
            indices.data_ptr(), updates.data_ptr(), out_idx.data_ptr(),
            out_upd.data_ptr(), counts.data_ptr(), totals.data_ptr(),
            offsets.data_ptr(), n, m, updates.shape[1] *
            updates.element_size(), shift, buckets, sub, tile, tiles,
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, code, "async_scatter bucket pass")
    launches += 3
    return out_idx, out_upd, offsets


def scatter_bucket(indices: torch.Tensor, updates: torch.Tensor,
                   n: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The bucket pass alone, as `async_scatter` runs it for a table of `n`
    rows: (indices, updates, offsets) in stable order of idx >> shift, the
    shift from `bucket_layout`; offsets: each region's first place, then M.
    Rows narrower than a sector only, as the rule gives them the pass. A
    CPU tensor runs `ref.scatter_bucket_ref`, a CUDA tensor the pass's
    three kernels (an index outside [0, n) traps there)."""
    m = indices.shape[0]
    if indices.dim() != 1 or indices.dtype != torch.int32 \
            or updates.dim() != 2 or updates.shape[0] != m \
            or updates.device != indices.device:
        raise ValueError("scatter_bucket: want int32 indices [M] and "
                         "updates [M, D] on one device")
    row_bytes = updates.shape[1] * updates.element_size()
    if row_bytes % 4 or not 0 < row_bytes < SECTOR or m >= 1 << 31:
        raise ValueError(f"scatter_bucket: rows of {row_bytes} bytes (a "
                         f"multiple of 4 below {SECTOR}) and M {m} < 2^31")
    if indices.device.type == "cpu":
        shift, buckets, *_ = bucket_layout(n, m, row_bytes, 1)
        return ref.scatter_bucket_ref(indices, updates, shift, buckets)
    sms = torch.cuda.get_device_properties(
        indices.device).multi_processor_count
    return _bucket(_aligned(indices), _aligned(updates), n,
                   bucket_layout(n, m, row_bytes, sms))


def async_scatter(table: torch.Tensor, indices: torch.Tensor,
                  updates: torch.Tensor, op: str = "add", block_m: int = 256,
                  num_slots: int = 8) -> torch.Tensor:
    """table[indices[j]] op= updates[j] for every j, in place; returns table.

    table: [N, D] float32 (add) or int32 (add, xor); indices: [M] int32 in
    [0, N); updates: [M, D] of the table's type. Rows hit more than once get
    every update: int32 exactly, float32 in the order the card applies them.
    A span of the apply takes at most `block_m` updates and `num_slots`
    spans are in flight in each block of rows of 32 bytes and more; rows
    narrower than a sector are bucketed by table region first and applied a
    span of at most 64 updates a block (`scatter_plan`). Any M is taken."""
    global launches
    if op not in OPS:
        raise ValueError(f"async_scatter: op {op!r} is not add or xor")
    row_bytes = check_ring_args("async_scatter", table, indices, block_m,
                                num_slots)
    if table.dtype not in TYPES[op]:
        raise TypeError(f"async_scatter: {op} takes "
                        f"{', '.join(map(str, TYPES[op]))} tables, got "
                        f"{table.dtype}")
    M, (N, D) = indices.shape[0], table.shape
    if updates.dtype != table.dtype or tuple(updates.shape) != (M, D) \
            or updates.device != table.device:
        raise ValueError(f"async_scatter: want updates [{M}, {D}] "
                         f"{table.dtype} on {table.device}, got "
                         f"{tuple(updates.shape)} {updates.dtype} on "
                         f"{updates.device}")
    if apply_smem(4, num_slots, row_bytes) > MAX_SMEM:
        raise ValueError(f"async_scatter: {num_slots} slots of 4 updates of "
                         f"{row_bytes}-byte rows do not fit in {MAX_SMEM} "
                         "bytes of shared memory")
    if M >= 1 << 31:
        raise ValueError(f"async_scatter: {M} updates; the kernels count "
                         "them in 32 bits")
    if table.device.type == "cpu":
        return table.copy_(ref.scatter_update_ref(table, indices, updates, op))
    if not table.is_contiguous():
        raise ValueError("async_scatter: the table is updated in place and "
                         "must be contiguous")
    if M == 0:
        return table
    indices, updates = _aligned(indices), _aligned(updates)
    plan = launch_plan(table, M, op, block_m, num_slots)
    if plan.bucket:
        indices, updates, _ = _bucket(indices, updates, N, (
            plan.shift, plan.buckets, plan.sub, plan.tile, plan.tiles))
    lib, fn = _bind()
    with torch.cuda.device(table.device):
        code = fn(table.data_ptr(), indices.data_ptr(), updates.data_ptr(), N,
                  M, row_bytes, plan.span, plan.slots, plan.chunk, plan.lanes,
                  plan.blocks, OPS[op],
                  _build.DTYPE_CODES[table.dtype],
                  torch.cuda.current_stream().cuda_stream)
    _build.check(lib, code, "async_scatter launch")
    launches += 1
    return table
