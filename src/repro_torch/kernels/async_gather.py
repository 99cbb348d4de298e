"""async_gather — the AMU mechanism as a Hopper kernel: out[i] = table[idx[i]].

The counterpart of `src/repro/kernels/async_gather.py`: the CUDA source is
`csrc/async_gather.cu` (its header note maps the reference's DMA ring onto
cp.async and says what bounds it), the plain version is `ref.gather_ref`.
Arguments are checked the same way on every device; then a CPU tensor runs
the plain version and a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

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
    chunk = next((w for w in (16, 8, 4)
                  if row_bytes % w == 0 and all(p % w == 0 for p in ptrs)),
                 None)
    if chunk is None:
        raise ValueError("rows must be a multiple of 4 bytes and start on a "
                         "4-byte boundary")
    lanes = 1 << (min(32, row_bytes // chunk).bit_length() - 1)
    idx_bytes = -(-block_m * 4 // 16) * 16
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


def _bind():
    lib = _build.load("async_gather")
    fn = lib.async_gather_launch
    if not fn.argtypes:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, p, p, ll, ll, i, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
        occ = lib.async_gather_blocks_per_sm
        occ.argtypes = [i, i, i, ctypes.POINTER(i)]
        occ.restype = ctypes.c_int
    return lib, fn


def async_gather(table: torch.Tensor, indices: torch.Tensor,
                 block_m: int = 256, num_slots: int = 8) -> torch.Tensor:
    """out[i] = table[indices[i]]; table: [N, D] of any type whose rows are a
    multiple of 4 bytes, indices: [M] int32 in [0, N).

    `block_m` indices go to one block of the kernel and `num_slots` rows are
    in flight in each of its rings. Any M is taken: the ragged tail is masked
    in the kernel, nothing is padded. The copy is bit-exact."""
    global launches
    row_bytes = check_ring_args("async_gather", table, indices, block_m,
                                num_slots)
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
    plan = ring_plan(row_bytes, block_m, num_slots, table.data_ptr())
    lib, fn = _bind()
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(table.data_ptr(), indices.data_ptr(), out.data_ptr(), N, M,
                  row_bytes, block_m, num_slots, plan.chunk, plan.lanes,
                  plan.warps, plan.smem, stream)
    _build.check(lib, code, "async_gather launch")
    launches += 1
    return out


def rows_in_flight_per_sm(row_bytes: int, block_m: int = 256,
                          num_slots: int = 8) -> int:
    """The paper's memory-level parallelism for this launch on the current
    card: K x rings a block x blocks an SM holds at once (as the runtime's
    occupancy calculator reports them)."""
    plan = ring_plan(row_bytes, block_m, num_slots)
    lib, _ = _bind()
    blocks = ctypes.c_int(0)
    _build.check(lib, lib.async_gather_blocks_per_sm(
        plan.chunk, plan.warps, plan.smem, ctypes.byref(blocks)),
        "async_gather occupancy")
    return num_slots * plan.rings * blocks.value
