"""async_scatter — read-modify-write rows of a table in place:
table[idx[j]] op= updates[j], op in {add, xor}.

The counterpart of `src/repro/kernels/async_scatter.py`: the CUDA source is
`csrc/async_scatter.cu` (its header note says how the reference's CAM-free
conflict check maps onto reductions at L2), the plain version is
`ref.scatter_update_ref`. Arguments are checked the same way on every device;
then a CPU tensor runs the plain version and a CUDA tensor launches the
kernel or raises. Both update `table` in place and return it, as the
reference's kernel does through `input_output_aliases`; `ops.scatter_update`
keeps the reference's value semantics by cloning first.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.async_gather import check_ring_args, ring_plan

OPS = {"add": 0, "xor": 1}          # `enum Op` of csrc/async_scatter.cu
TYPES = {"add": (torch.float32, torch.int32), "xor": (torch.int32,)}

launches = 0            # +1 for every launch of the CUDA kernel, nowhere else


def _bind():
    lib = _build.load("async_scatter")
    fn = lib.async_scatter_launch
    if not fn.argtypes:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, p, p, ll, ll, i, i, i, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return lib, fn


def async_scatter(table: torch.Tensor, indices: torch.Tensor,
                  updates: torch.Tensor, op: str = "add", block_m: int = 256,
                  num_slots: int = 8) -> torch.Tensor:
    """table[indices[j]] op= updates[j] for every j, in place; returns table.

    table: [N, D] float32 (add) or int32 (add, xor); indices: [M] int32 in
    [0, N); updates: [M, D] of the table's type. Rows hit more than once get
    every update: int32 exactly, float32 in the order the card applies them.
    `block_m` updates go to one block of the kernel and `num_slots` update
    rows are in flight in each of its rings. Any M is taken."""
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
    if table.device.type == "cpu":
        return table.copy_(ref.scatter_update_ref(table, indices, updates, op))
    if not table.is_contiguous():
        raise ValueError("async_scatter: the table is updated in place and "
                         "must be contiguous")
    indices, updates = indices.contiguous(), updates.contiguous()
    if M == 0:
        return table
    plan = ring_plan(row_bytes, block_m, num_slots, table.data_ptr(),
                     updates.data_ptr())
    lib, fn = _bind()
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(table.data_ptr(), indices.data_ptr(), updates.data_ptr(), N,
                  M, row_bytes, block_m, num_slots, plan.chunk, plan.lanes,
                  plan.warps, plan.smem, OPS[op],
                  _build.DTYPE_CODES[table.dtype], stream)
    _build.check(lib, code, "async_scatter launch")
    launches += 1
    return table
