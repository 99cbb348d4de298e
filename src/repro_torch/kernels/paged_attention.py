"""paged_attention — single-token decode attention over the KV cache.

The Hopper counterpart of `src/repro/kernels/paged_attention.py`: the CUDA
source is `csrc/paged_attention.cu` (its header note says what bounds it and
what the design does about that), the plain version is
`ref.paged_attention_ref`. A CPU tensor runs the plain version; a CUDA tensor
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build, ref

HEAD_DIMS = (16, 32, 64, 128)
_GROUP_CHUNK = 8        # GC of the kernel: query heads served by one block
_MIN_SPLIT_ROWS = 64    # do not cut the cache finer than this
_TARGET_BLOCKS = 264    # two blocks for each of the card's 132 SMs

launches = 0            # +1 for every launch of the CUDA kernel, nowhere else


def _bind():
    lib = _build.load("paged_attention")
    fn = lib.paged_attention_launch
    if not fn.argtypes:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, i, i,
                       ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, i, p]
        fn.restype = ctypes.c_int
    return lib, fn


def split_plan(B: int, Hq: int, Hkv: int, T: int, page: int):
    """(nsplit, rows_per_split): a block walks at most one page, and the
    cache is cut finer while the grid would not fill the card."""
    blocks = B * Hkv * -(-(Hq // Hkv) // _GROUP_CHUNK)
    page = max(1, min(page, T))
    nsplit = max(-(-T // page),
                 min(-(-T // _MIN_SPLIT_ROWS), -(-_TARGET_BLOCKS // blocks)))
    rows = -(-T // nsplit)
    return -(-T // rows), rows


def paged_attention(q: torch.Tensor, k_cache: torch.Tensor,
                    v_cache: torch.Tensor, lengths: torch.Tensor,
                    page: int = 512) -> torch.Tensor:
    """q: [B, Hq, D]; k_cache/v_cache: [B, T, Hkv, D]; lengths: [B] ->
    out [B, Hq, D] in q.dtype.

    `page` is the fetch granularity: no block of the kernel walks more rows
    than that. Any T is taken (the ragged tail is masked, nothing is padded)
    and the caches are read through their strides."""
    global launches
    if q.device.type == "cpu":
        return ref.paged_attention_ref(q, k_cache, v_cache, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    if q.dim() != 3 or k_cache.dim() != 4 or v_cache.shape != k_cache.shape:
        raise ValueError("paged_attention: want q [B,Hq,D] and caches "
                         f"[B,T,Hkv,D], got {tuple(q.shape)}, "
                         f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    B, Hq, D = q.shape
    T, Hkv = k_cache.shape[1], k_cache.shape[2]
    if k_cache.shape[0] != B or k_cache.shape[3] != D or Hq % Hkv:
        raise ValueError(f"paged_attention: q {tuple(q.shape)} does not fit "
                         f"caches {tuple(k_cache.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"paged_attention: head dim {D} not in {HEAD_DIMS}")
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise TypeError("paged_attention: q and caches must share float32 or "
                        f"bfloat16, got {q.dtype}, {k_cache.dtype}, "
                        f"{v_cache.dtype}")
    if lengths.dtype != torch.int32 or lengths.shape != (B,) \
            or not lengths.is_contiguous():
        raise TypeError("paged_attention: lengths must be contiguous int32 "
                        f"[{B}], got {lengths.dtype} {tuple(lengths.shape)}")
    vec = max(D // 32, 1)                  # elements a lane loads at once
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if t.device != q.device or lengths.device != q.device:
            raise ValueError("paged_attention: tensors on different devices")
        if t.stride(-1) != 1 or any(s % vec for s in t.stride()[:-1]) \
                or t.data_ptr() % 16:
            raise ValueError(f"paged_attention: {name} needs a unit last "
                             f"stride, other strides in multiples of {vec} "
                             f"and a 16-byte aligned start, got strides "
                             f"{t.stride()}")

    nsplit, rows = split_plan(B, Hq, Hkv, T, page)
    out = torch.empty((B, Hq, D), dtype=q.dtype, device=q.device)
    part_acc = torch.empty((B, Hq, nsplit, D), dtype=torch.float32,
                           device=q.device)
    part_ml = torch.empty((2, B, Hq, nsplit), dtype=torch.float32,
                          device=q.device)
    strides = (ctypes.c_longlong * 8)(
        q.stride(0), q.stride(1),
        k_cache.stride(0), k_cache.stride(1), k_cache.stride(2),
        v_cache.stride(0), v_cache.stride(1), v_cache.stride(2))
    lib, fn = _bind()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                  lengths.data_ptr(), out.data_ptr(), part_acc.data_ptr(),
                  part_ml[0].data_ptr(), part_ml[1].data_ptr(), B, Hq, Hkv, T,
                  D, nsplit, rows, strides, 1.0 / math.sqrt(D),
                  _build.DTYPE_CODES[q.dtype], stream)
    _build.check(lib, code, "paged_attention launch")
    launches += 1
    return out
