"""stream_triad — STREAM triad a = b + s * c, streamed block by block.

The counterpart of `src/repro/kernels/stream_triad.py`: the CUDA source is
`csrc/stream_triad.cu` (its header note says what bounds it and how the
reference's pipelined blocks become a ring of bulk copies), the plain version
is `ref.triad_ref`. Arguments are checked the same way on every device; then
a CPU tensor runs the plain version and a CUDA tensor launches the kernel or
raises.

`triad_plan` lays a launch over the card; `triad_steps` mirrors, for the CPU
tests, which elements each block of the kernel moves, step by step and copy
by copy. A step is sized in bytes: `block` x STEP_ITEM bytes of b and of c
in every type, 4 / item of the reference's `block`s, each one bulk copy;
`step_blocks` takes fewer where the ring would not fit in shared memory.
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Tuple

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.async_gather import MAX_SMEM

TYPES = (torch.float32, torch.bfloat16, torch.float16, torch.float8_e4m3fn,
         torch.float8_e5m2, torch.int8, torch.uint8, torch.int16,
         torch.uint16, torch.int32, torch.uint32)
SM_SMEM = 233472        # shared memory of one SM, 1 KB of it reserved a block
INFLIGHT_BYTES = 48 * 1024   # loads in flight an SM: ~latency x bandwidth
STEP_ITEM = 4           # a step is at most `block` elements of this many
                        # bytes (`step_blocks`)

launches = 0            # +1 for every launch of the CUDA kernel, nowhere else


class TriadPlan(NamedTuple):
    """How a launch of the triad kernel covers the arrays on a card."""
    threads: int        # computing threads a block: one a 16-byte chunk of
                        # a step (the launch adds the producer warp)
    per_sm: int         # blocks an SM
    blocks: int         # blocks of the launch


def step_blocks(item: int, block: int, stages: int) -> int:
    """The reference's blocks (one bulk copy each of b and of c) a step of
    the kernel: STEP_ITEM / item, so that a step moves `block` x STEP_ITEM
    bytes whatever the type, halved while `stages` steps of b and of c and
    their two mbarriers a stage (the bytes the source's `stream_triad_smem`
    gives) would pass MAX_SMEM; 0 where one block a step does not fit."""
    k = STEP_ITEM // item
    while k and stages * (2 * k * block * item + 16) > MAX_SMEM:
        k //= 2
    return k


def triad_plan(n: int, item: int, block: int, stages: int, sms: int,
               smem: int) -> TriadPlan:
    """Steps of `step_blocks` blocks, `block` x STEP_ITEM bytes in every
    type where they fit (128 computing threads at the default block of 512:
    one 16-byte chunk each, beside the producer warp); blocks an SM such
    that their loads in flight (stages x a step of b and c each) come to
    about INFLIGHT_BYTES, at least two and as many as shared memory (`smem`
    bytes a block, as the kernel's source sizes it) and threads allow; no
    more blocks than steps."""
    step_bytes = step_blocks(item, block, stages) * block * item
    cb = step_bytes // 16                     # chunks a step
    threads = min(256, max(32, -(-cb // 32) * 32))
    per_sm = max(2, -(-INFLIGHT_BYTES // (stages * 2 * step_bytes)))
    per_sm = max(1, min(per_sm, SM_SMEM // (smem + 1024),
                        2048 // (threads + 32)))
    steps = -(-(n // (16 // item)) // cb)
    return TriadPlan(threads, per_sm, max(1, min(steps, per_sm * sms)))


def triad_steps(n: int, item: int, block: int, stages: int, blocks: int
                ) -> Tuple[List[List[List[Tuple[int, int]]]],
                           Tuple[int, int]]:
    """What the kernel moves: for each block, its steps, grid-stride, each
    step its bulk copies (aloads) as (first element, elements): at most
    `step_blocks` copies of at most `block` elements, whole 16-byte chunks
    only; and the scalar tail (first element, elements) the last block
    does."""
    vec = 16 // item
    bc = block // vec                         # chunks a copy
    k = step_blocks(item, block, stages)      # copies a step
    nc = n // vec
    steps = -(-nc // (bc * k))
    per_block = [[[(c * vec, min(bc, nc - c) * vec)
                   for c in range(t * bc * k, min(nc, (t + 1) * bc * k), bc)]
                  for t in range(i, steps, blocks)] for i in range(blocks)]
    return per_block, (nc * vec, n - nc * vec)


def _bind():
    lib = _build.load("stream_triad")
    fn = lib.stream_triad_launch
    if not fn.argtypes:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, ctypes.c_longlong, ctypes.c_double, i, i,
                       i, i, i, i, p]
        fn.restype = ctypes.c_int
        lib.stream_triad_smem.argtypes = [ctypes.c_longlong, i]
        lib.stream_triad_smem.restype = ctypes.c_longlong
    return lib, fn


@functools.lru_cache(maxsize=None)
def _card_plan(device: int, dtype: torch.dtype, block: int,
               stages: int) -> TriadPlan:
    """The plan of a launch as long as the card's grid, once per (device,
    type, block, stages); `stream_triad` cuts its grid to the steps."""
    lib, _ = _bind()
    item = dtype.itemsize
    smem = lib.stream_triad_smem(
        step_blocks(item, block, stages) * block * item, stages)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return triad_plan(1 << 62, item, block, stages, sms, smem)


def _kernel_scalar(s: float, dtype: torch.dtype) -> float:
    """s as the kernel takes it: rounded to a float type here, or, for an
    integer type, in float32, which the kernel converts (`to_int` of
    csrc/common.cuh: toward zero, saturated, NaN -> 0)."""
    if dtype in ref.INT_TYPES:
        return float(torch.tensor(float(s), dtype=torch.float32))
    return ref.round_scalar(s, dtype)


def stream_triad(b: torch.Tensor, c: torch.Tensor, s: float,
                 block: int = 512, stages: int = 4) -> torch.Tensor:
    """b, c: [N] of one of `TYPES` -> a = b + s * c in their type.

    `block` elements (a multiple of 128, as in the reference) are the unit
    one bulk copy of the kernel streams, the aload granularity; a step is
    `block` x STEP_ITEM bytes in every type (4 / item such copies of b and
    of c, fewer where `stages` such steps would not fit: `step_blocks`),
    and `stages` steps are in flight in each block of the kernel. Any N is
    taken: the ragged tail is masked, nothing is padded. The result is the reference's bit for bit
    but in float32 (`ref.triad_ref`): s is made the arrays' type first
    (`ref.round_scalar`: an integer type's s toward zero and saturated),
    bfloat16 and float8 round the product and then the sum, float16 rounds
    once, float8 overflows to NaN (e4m3fn) or inf (e5m2), and integers
    wrap."""
    global launches
    if b.device.type not in ("cpu", "cuda"):
        raise ValueError(f"stream_triad: unsupported device {b.device}")
    if b.dim() != 1 or c.shape != b.shape or c.dtype != b.dtype \
            or c.device != b.device:
        raise ValueError("stream_triad: want b and c of one shape [N], type "
                         f"and device, got {tuple(b.shape)} {b.dtype} "
                         f"{b.device} and {tuple(c.shape)} {c.dtype} "
                         f"{c.device}")
    if b.dtype not in TYPES:
        raise TypeError(f"stream_triad: takes "
                        f"{', '.join(str(t)[6:] for t in TYPES)}, got "
                        f"{b.dtype} (64-bit types: the reference makes them "
                        "32-bit before any kernel runs)")
    if block < 128 or block % 128 or stages < 1:
        raise ValueError(f"stream_triad: block {block} must be a positive "
                         f"multiple of 128 and stages {stages} positive")
    k = step_blocks(b.element_size(), block, stages)
    if not k:
        raise ValueError(f"stream_triad: {stages} stages of {block} "
                         f"elements of b and of c do not fit in {MAX_SMEM} "
                         "bytes of shared memory")
    if b.device.type == "cpu":
        return ref.triad_ref(b, c, s)
    b, c = b.contiguous(), c.contiguous()
    if b.data_ptr() % 16 or c.data_ptr() % 16:
        raise ValueError("stream_triad: b and c must start on a 16-byte "
                         "boundary")
    a = torch.empty_like(b)
    if b.numel() == 0:
        return a
    plan = _card_plan(b.device.index, b.dtype, block, stages)
    steps = -(-(b.numel() // (16 // b.element_size()))
              // (k * block * b.element_size() // 16))
    lib, fn = _bind()
    with torch.cuda.device(b.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(b.data_ptr(), c.data_ptr(), a.data_ptr(), b.numel(),
                  _kernel_scalar(s, b.dtype), block, stages, k,
                  max(1, min(steps, plan.blocks)), plan.threads,
                  _build.DTYPE_CODES[b.dtype], stream)
    _build.check(lib, code, "stream_triad launch")
    launches += 1
    return a
