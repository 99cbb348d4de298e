"""flash_attention — blockwise causal / sliding-window self-attention.

The Hopper counterpart of `src/repro/kernels/flash_attention.py`: the CUDA
source is `csrc/flash_attention.cu` (its header note says what bounds it and
what the design does about that), the plain version is `ref.attention_ref`.
A CPU tensor runs the plain version; a CUDA tensor launches the kernel or
raises.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build, ref

HEAD_DIMS = (16, 32, 64, 128, 256)

launches = 0            # +1 for every launch of the CUDA kernel, nowhere else


def body_for(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel body a launch runs, a fixed rule on (type, head size) that
    `flash_attention_launch` in csrc/flash_attention.cu applies: "fma"
    (fp32 FMAs, every head size) for float32; "wgmma" (TMA + wgmma, the
    Hopper body) for bfloat16 at 64, 128 and 256 (at 256 with 64 x 64 tiles
    and one consumer warpgroup); "mma" (mma.sync) for bfloat16 at 16 and
    32."""
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {head_dim} not in "
                         f"{HEAD_DIMS}")
    if dtype == torch.float32:
        return "fma"
    if dtype == torch.bfloat16:
        return "wgmma" if head_dim >= 64 else "mma"
    raise TypeError(f"flash_attention: no body for {dtype}")


def _bind():
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_launch
    if not fn.argtypes:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, i, i, i, i, i, ctypes.c_float,
                       ctypes.POINTER(ctypes.c_longlong), i, p]
        fn.restype = ctypes.c_int
    return lib, fn


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0,
                    block_q: int = 128, block_k: int = 128) -> torch.Tensor:
    """q: [B, Hq, S, D]; k, v: [B, Hkv, S, D] -> [B, Hq, S, D] in q.dtype.

    `block_q` / `block_k` are kept for the reference's signature; they do not
    change the result and the kernel chooses its own tiles. Any S is taken
    (the ragged edge is masked in the kernel) and the operands are read
    through their strides, so a transposed view of [B, S, H, D] costs no
    copy; the output has q's layout. Which body runs is `body_for`: bf16 at
    head size 64, 128 or 256 loads its tiles by TMA and multiplies with
    wgmma.

    Both devices refuse the same inputs: ranks, shapes, GQA divisibility,
    head size, dtypes, `window` and devices are checked before a CPU tensor
    goes to the plain version. Only the stride and alignment checks, which
    describe the kernel's 16-byte loads, come after, for CUDA tensors.

    There is no backward: under autograd, with an input that requires grad,
    it raises NotImplementedError on every device, the CPU's plain version
    included, as `jax.grad` of the reference's Pallas kernel fails."""
    global launches
    del block_q, block_k
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise NotImplementedError(
            "flash_attention has no backward, as the reference's Pallas "
            "kernel has none (jax.grad of it fails): train with "
            "use_kernels=False, or run the forward under torch.no_grad()")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError("flash_attention: want q [B,Hq,S,D] and k, v "
                         f"[B,Hkv,S,D], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Hq, S, D = q.shape
    Hkv = k.shape[1]
    if k.shape[0] != B or k.shape[2] != S or k.shape[3] != D or Hq % Hkv:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not fit "
                         f"k {tuple(k.shape)} (self-attention, S == T)")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D} not in {HEAD_DIMS}")
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError("flash_attention: q, k, v must share float32 or "
                        f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if window < 0:
        raise ValueError(f"flash_attention: window must be >= 0, got {window}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: tensors on different devices")
    if q.device.type == "cpu":
        return ref.attention_ref(q, k, v, causal=causal, window=window)
    out = torch.empty_like(q)              # keeps q's (dense) strides
    chunk = 16 // q.element_size()         # elements of one 16-byte load
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        if t.stride(-1) != 1 or any(s % chunk for s in t.stride()[:-1]) \
                or t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} needs a unit last "
                             f"stride, other strides in multiples of {chunk} "
                             f"and a 16-byte aligned start, got strides "
                             f"{t.stride()}")
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    lib, fn = _bind()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  B, Hq, Hkv, S, D, int(bool(causal)), int(window),
                  1.0 / math.sqrt(D), strides,
                  _build.DTYPE_CODES[q.dtype], stream)
    _build.check(lib, code, "flash_attention launch")
    launches += 1
    return out
