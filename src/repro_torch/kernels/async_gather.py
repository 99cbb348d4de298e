"""async_gather — the AMU mechanism as a Hopper kernel: out[i] = table[idx[i]].

The counterpart of `src/repro/kernels/async_gather.py`: the CUDA source is
`csrc/async_gather.cu` (its header note maps the reference's DMA ring onto
bulk copies and mbarriers, or cp.async, and says what bounds it), the plain
version is `ref.gather_ref`. Arguments are checked the same way on every
device; then a CPU tensor runs the plain version and a CUDA tensor launches
the kernel or raises.

`gather_plan` lays a launch over the card: how many rows a block takes, how
many warps it has, and which path its rows take (the bulk-copy ring for rows
that are a multiple of 16 bytes with 16-byte aligned pointers, the cp.async
ring for every other row). `ring_plan` is the scatter kernel's plan, which
takes `block_m` rows a block as the reference does.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple

import torch

from repro_torch.kernels import _build, ref

MAX_SMEM = 232448       # shared memory a block may use (csrc/amu_ring.cuh)
_WARPS = 4              # warps a block, fewer only where the ring needs room

launches = 0            # +1 for every launch of the CUDA kernel, nowhere else


class RingPlan(NamedTuple):
    """How a block of the gather / scatter kernels lays out its rings."""
    chunk: int          # bytes one cp.async moves: 16, 8 or 4
    lanes: int          # lanes that share one ring (one row at a time)
    warps: int          # warps a block
    smem: int           # shared-memory bytes a block: indices + K slots a ring

    @property
    def rings(self) -> int:
        return self.warps * 32 // self.lanes


def ring_plan(row_bytes: int, block_m: int, num_slots: int,
              *ptrs: int) -> RingPlan:
    """The widest chunk that divides the row and keeps every pointer aligned;
    a ring as wide as the row's chunks (at most a warp, a power of two); four
    warps a block unless K slots a ring do not fit. Raises where even one
    ring does not fit in shared memory."""
    _, chunk, lanes = gather_path(row_bytes, _align(*ptrs))
    idx_bytes = _round16(block_m * 4)
    warps = _WARPS

    def smem(w):
        return idx_bytes + w * (32 // lanes) * num_slots * row_bytes
    while warps > 1 and smem(warps) > MAX_SMEM:
        warps //= 2
    if smem(warps) > MAX_SMEM:
        raise ValueError(f"{num_slots} slots of {row_bytes}-byte rows do not "
                         f"fit in {MAX_SMEM} bytes of shared memory")
    return RingPlan(chunk, lanes, warps, smem(warps))


def check_ring_args(name: str, table: torch.Tensor, indices: torch.Tensor,
                    block_m: int, num_slots: int) -> int:
    """Checks shared by the gather and scatter wrappers, the same on every
    device; returns the row's bytes."""
    if table.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {table.device}")
    if indices.device != table.device:
        raise ValueError(f"{name}: table on {table.device}, indices on "
                         f"{indices.device}")
    if table.dim() != 2 or indices.dim() != 1:
        raise ValueError(f"{name}: want table [N, D] and indices [M], got "
                         f"{tuple(table.shape)} and {tuple(indices.shape)}")
    if indices.dtype != torch.int32:
        raise TypeError(f"{name}: indices must be int32, got {indices.dtype}")
    if block_m < 1 or num_slots < 1:
        raise ValueError(f"{name}: block_m {block_m} and num_slots "
                         f"{num_slots} must be positive")
    row_bytes = table.shape[1] * table.element_size()
    if row_bytes == 0 or row_bytes % 4:
        raise ValueError(f"{name}: a row of {row_bytes} bytes is not a "
                         "multiple of 4 bytes, the kernel's smallest copy")
    ring_plan(row_bytes, block_m, num_slots)       # raises if it cannot fit
    return row_bytes


class GatherPlan(NamedTuple):
    """How a launch of the gather kernel covers M rows on a card."""
    bulk: bool          # rows by cp.async.bulk into mbarrier slots
    chunk: int          # bytes one cp.async moves (16 on the bulk path)
    lanes: int          # lanes that share one ring (one row at a time)
    warps: int          # warps a block
    rows: int           # rows a block takes
    blocks: int         # blocks of the launch
    smem: int           # shared-memory bytes a block
    per_sm: int         # blocks of this plan one SM holds at once
    slots: int          # K: rows in flight in a ring
    sms: int            # SMs of the card

    @property
    def rings(self) -> int:
        return self.warps * 32 // self.lanes

    @property
    def rows_in_flight_per_sm(self) -> int:
        """The paper's memory-level parallelism of this launch: rows in
        flight a ring (K, or fewer where a ring carries fewer rows) x rings
        a block x the blocks an SM runs at once."""
        depth = min(self.slots, -(-self.rows // self.rings))
        return depth * self.rings * min(self.per_sm,
                                        -(-self.blocks // self.sms))


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def gather_smem(bulk: bool, rings: int, rows: int, num_slots: int,
                row_bytes: int) -> int:
    """Shared memory of a gather block, laid out as csrc/async_gather.cu
    does: (bulk) an mbarrier a slot, the block's indices, rings of
    min(K, rows a ring) + 1 slots; (cp.async) the indices, rings of K
    slots."""
    if bulk:
        slots = rings * (min(num_slots, -(-rows // rings)) + 1)
        return _round16(slots * 8) + _round16(rows * 4) + slots * row_bytes
    return _round16(rows * 4) + rings * num_slots * row_bytes


def gather_path(row_bytes: int, align: int):
    """(bulk, chunk, lanes): the bulk-copy ring iff the row is a multiple of
    16 bytes and every pointer 16-byte aligned, else cp.async chunks of the
    widest of 16/8/4 bytes that divides the row and the pointers; a ring as
    wide as the row's chunks (at most a warp, a power of two)."""
    chunk = next((w for w in (16, 8, 4)
                  if row_bytes % w == 0 and align % w == 0), None)
    if chunk is None:
        raise ValueError("rows must be a multiple of 4 bytes and start on a "
                         "4-byte boundary")
    lanes = 1 << (min(32, row_bytes // chunk).bit_length() - 1)
    return chunk == 16, chunk, lanes


def gather_plan(row_bytes: int, m: int, block_m: int, num_slots: int,
                align: int, sms: int,
                blocks_per_sm: Callable[[bool, int, int, int], int]
                ) -> GatherPlan:
    """The launch of `m` rows on a card of `sms` SMs. `align` is the largest
    of 16, 8, 4 dividing the table's and the output's addresses;
    `blocks_per_sm(bulk, chunk, warps, smem)` the occupancy of a plan.

    For 4, 2, then 1 warps a block: the fewest rows a block, a multiple of
    its ring count and at most `block_m`, with which every block of the
    launch is resident at once (blocks <= sms x blocks an SM holds), else
    `block_m` rows. The first of these plans whose grid reaches min(sms, m)
    blocks is taken, else the one with the most blocks. So a ring carries
    as few rows as the card allows, the rows of an SM are issued by as many
    rings as it holds, and no SM is left without work where there are rows
    for it. `block_m` is only an upper bound."""
    bulk, chunk, lanes = gather_path(row_bytes, align)
    best = None
    for warps in (4, 2, 1):
        rings = warps * 32 // lanes
        plan = None
        for rows in [*range(rings, block_m, rings), block_m]:
            smem = gather_smem(bulk, rings, rows, num_slots, row_bytes)
            per_sm = blocks_per_sm(bulk, chunk, warps, smem) \
                if smem <= MAX_SMEM else 0
            if per_sm < 1:
                break                 # more rows only take more room
            blocks = -(-m // rows)
            plan = GatherPlan(bulk, chunk, lanes, warps, rows, blocks, smem,
                              per_sm, num_slots, sms)
            if blocks <= per_sm * sms:
                break
        if plan is None:
            continue
        if plan.blocks >= min(sms, m):
            return plan
        if best is None or plan.blocks > best.blocks:
            best = plan
    if best is None:
        raise ValueError(f"{num_slots} slots of {row_bytes}-byte rows do not "
                         f"fit in {MAX_SMEM} bytes of shared memory")
    return best


def _align(*ptrs: int) -> int:
    return next(w for w in (16, 8, 4, 2, 1) if all(p % w == 0 for p in ptrs))


def _bind():
    lib = _build.load("async_gather")
    fn = lib.async_gather_launch
    if not fn.argtypes:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, p, p, ll, ll, i, i, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
        occ = lib.async_gather_blocks_per_sm
        occ.argtypes = [i, i, i, i, ctypes.POINTER(i)]
        occ.restype = ctypes.c_int
    return lib, fn


@functools.lru_cache(maxsize=None)
def _blocks_per_sm(device: int, bulk: bool, chunk: int, warps: int,
                   smem: int) -> int:
    """The runtime's occupancy calculator, asked once per plan shape."""
    lib, _ = _bind()
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device):
        _build.check(lib, lib.async_gather_blocks_per_sm(
            int(bulk), chunk, warps, smem, ctypes.byref(blocks)),
            "async_gather occupancy")
    return blocks.value


@functools.lru_cache(maxsize=4096)
def _card_plan(device: int, row_bytes: int, m: int, block_m: int,
               num_slots: int, align: int) -> GatherPlan:
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return gather_plan(row_bytes, m, block_m, num_slots, align, sms,
                       functools.partial(_blocks_per_sm, device))


def launch_plan(table: torch.Tensor, m: int, block_m: int = 256,
                num_slots: int = 8) -> GatherPlan:
    """The plan `async_gather` launches for `m` rows of this CUDA table (the
    output is allocated 16-byte aligned), cached per shape and alignment."""
    row_bytes = table.shape[1] * table.element_size()
    return _card_plan(table.device.index, row_bytes, m, block_m, num_slots,
                      _align(table.data_ptr(), 16))


def async_gather(table: torch.Tensor, indices: torch.Tensor,
                 block_m: int = 256, num_slots: int = 8) -> torch.Tensor:
    """out[i] = table[indices[i]]; table: [N, D] of any type whose rows are a
    multiple of 4 bytes, indices: [M] int32 in [0, N).

    A block takes at most `block_m` indices (fewer where that fills the
    card: `gather_plan`) and `num_slots` rows are in flight in each of its
    rings. Any M is taken: the ragged tail is masked in the kernel, nothing
    is padded. The copy is bit-exact."""
    global launches
    row_bytes = check_ring_args("async_gather", table, indices, block_m,
                                num_slots)
    bulk, _, lanes = gather_path(row_bytes, 16)     # the smallest block
    if gather_smem(bulk, 32 // lanes, 1, num_slots, row_bytes) > MAX_SMEM:
        raise ValueError(f"async_gather: a ring of {row_bytes}-byte rows "
                         f"does not fit in {MAX_SMEM} bytes of shared memory")
    if table.device.type == "cpu":
        return ref.gather_ref(table, indices)
    if not table.is_contiguous():
        raise ValueError("async_gather: the table must be contiguous (a copy "
                         "of it would cost more than the gather)")
    indices = indices.contiguous()
    M, (N, D) = indices.shape[0], table.shape
    out = torch.empty((M, D), dtype=table.dtype, device=table.device)
    if M == 0:
        return out
    plan = _card_plan(table.device.index, row_bytes, M, block_m, num_slots,
                      _align(table.data_ptr(), out.data_ptr()))
    lib, fn = _bind()
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(table.data_ptr(), indices.data_ptr(), out.data_ptr(), N, M,
                  row_bytes, plan.rows, num_slots, int(plan.bulk), plan.chunk,
                  plan.lanes, plan.warps, plan.smem, stream)
    _build.check(lib, code, "async_gather launch")
    launches += 1
    return out
