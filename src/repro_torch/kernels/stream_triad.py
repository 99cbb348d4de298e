"""stream_triad — STREAM triad a = b + s * c, streamed block by block.

The counterpart of `src/repro/kernels/stream_triad.py`: the CUDA source is
`csrc/stream_triad.cu` (its header note says what bounds it and how the
reference's pipelined blocks become a cp.async ring), the plain version is
`ref.triad_ref`. Arguments are checked the same way on every device; then a
CPU tensor runs the plain version and a CUDA tensor launches the kernel or
raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.async_gather import MAX_SMEM

TYPES = (torch.float32, torch.bfloat16)

launches = 0            # +1 for every launch of the CUDA kernel, nowhere else


def _bind():
    lib = _build.load("stream_triad")
    fn = lib.stream_triad_launch
    if not fn.argtypes:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, ctypes.c_longlong, ctypes.c_float, i, i, i, p]
        fn.restype = ctypes.c_int
    return lib, fn


def stream_triad(b: torch.Tensor, c: torch.Tensor, s: float,
                 block: int = 512, stages: int = 4) -> torch.Tensor:
    """b, c: [N] float32 or bfloat16 -> a = b + s * c in their type.

    `block` elements (a multiple of 128, as in the reference) are the unit
    one step of the kernel streams, the aload granularity; `stages` steps are
    in flight in each block of the kernel. Any N is taken: the ragged tail is
    masked, nothing is padded. s is rounded to the arrays' type first and the
    rest is computed in float32, rounded once at the end."""
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
        raise TypeError(f"stream_triad: takes float32 or bfloat16, got "
                        f"{b.dtype}")
    if block < 128 or block % 128 or stages < 1:
        raise ValueError(f"stream_triad: block {block} must be a positive "
                         f"multiple of 128 and stages {stages} positive")
    if stages * 2 * block * b.element_size() > MAX_SMEM:
        raise ValueError(f"stream_triad: {stages} stages of {block} elements "
                         f"do not fit in {MAX_SMEM} bytes of shared memory")
    if b.device.type == "cpu":
        return ref.triad_ref(b, c, s)
    b, c = b.contiguous(), c.contiguous()
    if b.data_ptr() % 16 or c.data_ptr() % 16:
        raise ValueError("stream_triad: b and c must start on a 16-byte "
                         "boundary")
    a = torch.empty_like(b)
    if b.numel() == 0:
        return a
    lib, fn = _bind()
    with torch.cuda.device(b.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(b.data_ptr(), c.data_ptr(), a.data_ptr(), b.numel(),
                  ref.round_scalar(s, b.dtype), block, stages,
                  _build.DTYPE_CODES[b.dtype], stream)
    _build.check(lib, code, "stream_triad launch")
    launches += 1
    return a
