"""flash_attention — blockwise causal / sliding-window self-attention.

The Hopper counterpart of `src/repro/kernels/flash_attention.py`: the CUDA
source is `csrc/flash_attention.cu` (its header note says what bounds it and
what the design does about that), the plain version is `ref.attention_ref`.
A CPU tensor runs the plain version; a CUDA tensor launches the kernel or
raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build, ref

HEAD_DIMS = (16, 32, 64, 128, 256)   # the head sizes the bodies are built at
CHUNK_DIM = HEAD_DIMS[-1]   # above it a launch splits the head into chunks
FMA_CLUSTER = 8             # CTAs a cluster of the fma body at most
# the types the kernels read in place; integers (and mixed types) take
# float32 copies, the reference's `.astype(float32)`
KERNEL_TYPES = (torch.float32, torch.bfloat16, torch.float16,
                *ref.FP8_TYPES)
TYPES = (*KERNEL_TYPES, *ref.INT_TYPES)

launches = 0            # +1 for every launch of the CUDA kernel, nowhere else


def padded_head_dim(name: str, head_dim: int) -> int:
    """Dp: the smallest of `HEAD_DIMS` that is at least `head_dim`, the head
    size of the body a launch at `head_dim` runs (its columns past
    `head_dim` loaded as zeros and never stored); above CHUNK_DIM, the
    CHUNK_DIM-column chunks that cover the head, each the output columns of
    its own blocks or warpgroups (the wide bodies: `wide_blocks`). Both
    attention kernels take every
    head size from 1 up, as the TPU kernels' whole-head BlockSpecs do;
    `name` is the kernel that refuses a head size below 1."""
    if head_dim < 1:
        raise ValueError(f"{name}: head dim {head_dim} is not positive")
    if head_dim > CHUNK_DIM:
        return -(-head_dim // CHUNK_DIM) * CHUNK_DIM
    return next(dp for dp in HEAD_DIMS if head_dim <= dp)


def check_types(name: str, *dtypes: torch.dtype) -> None:
    """Refuses a type the attention kernels do not take (`name` the
    kernel), the same on every device: 64-bit types (the reference makes
    them 32-bit before any kernel runs), bool, complex."""
    for dtype in dtypes:
        if dtype not in TYPES:
            raise TypeError(f"{name}: takes float32, bfloat16, float16, "
                            "float8_e4m3fn, float8_e5m2 and 8-, 16- and "
                            f"32-bit integers, got "
                            f"{', '.join(map(str, dtypes))}")


def body_for(dtype: torch.dtype, head_dim: int,
             kv_dtype: Optional[torch.dtype] = None) -> str:
    """The kernel body a launch runs, a fixed rule on (types, head size)
    that `flash_attention_launch` in csrc/flash_attention.cu applies, with
    Dp = `padded_head_dim`:

    - "fma" (FMAs in fp32 on 8 x 8 register tiles, K and V through a
      ring filled by a producer warpgroup): float32 at every head size;
      integers and q, k, v of more than one type (`kv_dtype` k's and v's
      where it is not q's: the wrapper widens all three to float32, the
      reference's arithmetic); and bfloat16, float16 and float8 rows that
      TMA cannot load (below) where Dp is 16 or 32, or above 256. Its
      query rows a block: `fma_rows`; above 256 columns a cluster of CTAs
      a query tile, each owning 256 columns: `fma_cluster`.
    - "wgmma" (TMA + wgmma, the Hopper body): bfloat16 and float16 rows of
      whole 16-byte pieces (head_dim % 8 == 0) at Dp of 64 and up (two
      consumer warpgroups; at 256 with 64-key tiles, a producer warpgroup
      that hands its registers to them with setmaxnreg, and the two taking
      turns at the tensor cores; above 256 two consumer warpgroups of 256
      columns each that add their parts of Q K^T, a block the whole head up
      to 512 and a chunk of 512 output columns above, Q and K then
      streamed in 64-column pieces: `wide_blocks`); float8 (e4m3fn, e5m2) rows of
      whole 16-byte pieces (head_dim % 16 == 0) at Dp 64 to 256, Q K^T on
      the fp8 wgmma of their kind straight from the TMA tiles, V converted
      to f16 (exact) by the producer warpgroup for an f16 P V.
    - "wgmma_elem" (the same wgmma body, its tiles copied by element by a
      producer warpgroup, fp8 converted to f16 as it is loaded): bfloat16
      and float16 at head_dim % 8 != 0 and float8 at head_dim % 16 != 0,
      where Dp is 64 to 256. It takes any strides.
    - "mma" (mma.sync): bfloat16 and float16 rows of whole 16-byte pieces
      at Dp of 16 and 32."""
    dp = padded_head_dim("flash_attention", head_dim)
    check_types("flash_attention", dtype,
                *(() if kv_dtype is None else (kv_dtype,)))
    if kv_dtype is not None and kv_dtype != dtype:
        return "fma"
    tensor_cores = 64 <= dp <= CHUNK_DIM      # the head sizes of wgmma_elem
    if dtype in ref.FP8_TYPES:
        if not tensor_cores:
            return "fma"
        return "wgmma" if head_dim % 16 == 0 else "wgmma_elem"
    if dtype not in (torch.bfloat16, torch.float16):
        return "fma"
    if head_dim % 8:
        return "wgmma_elem" if tensor_cores else "fma"
    return "wgmma" if dp >= 64 else "mma"


def fma_cluster(dtype: torch.dtype, head_dim: int,
                kv_dtype: Optional[torch.dtype] = None) -> int:
    """CTAs a cluster of a launch, the rule `flash_attention_cluster` of
    csrc/flash_attention.cu applies: in the "fma" body above CHUNK_DIM,
    one a CHUNK_DIM-column piece of the head, at most FMA_CLUSTER (the
    portable cluster size). CTA r sums Q K^T over pieces r, r + n, ... of
    the head, the cluster adds its n partial logit tiles through
    distributed shared memory in rank order (the same fp32 logits in every
    CTA), and each CTA runs the softmax and P V over its own piece of the
    output. 1 for every other launch."""
    dp = padded_head_dim("flash_attention", head_dim)
    if body_for(dtype, head_dim, kv_dtype) != "fma" or dp <= CHUNK_DIM:
        return 1
    return min(dp // CHUNK_DIM, FMA_CLUSTER)


def wide_blocks(dtype: torch.dtype, head_dim: int,
                kv_dtype: Optional[torch.dtype] = None) -> int:
    """Blocks a launch gives each (head, query tile), the rule
    `flash_attention_wide_blocks` of csrc/flash_attention.cu applies: 1 up
    to CHUNK_DIM; in the "wgmma" body above, one a 2 CHUNK_DIM-column chunk
    of the output (the pair body: two consumer warpgroups of a block each
    own CHUNK_DIM columns and add their parts of Q K^T, so up to 2
    CHUNK_DIM it is done once a tile); in the "fma" body above CHUNK_DIM,
    the CTAs of its clusters (`fma_cluster`): one a CHUNK_DIM-column piece
    up to FMA_CLUSTER pieces (2048 columns), Q K^T summed once a tile
    across the cluster; above, a cluster of FMA_CLUSTER for every chunk of
    FMA_CLUSTER pieces of the output, a grid dimension, each cluster
    summing all of Q K^T, so Q K^T is done `qk_passes` times. Either way
    the clusters' CTAs times the passes."""
    return fma_cluster(dtype, head_dim, kv_dtype) * qk_passes(
        dtype, head_dim, kv_dtype)


def qk_passes(dtype: torch.dtype, head_dim: int,
              kv_dtype: Optional[torch.dtype] = None) -> int:
    """How many times a launch computes each query tile's Q K^T over the
    whole head: once up to 2 CHUNK_DIM columns in the "wgmma" body (the
    pair body) and up to FMA_CLUSTER CHUNK_DIM in the "fma" body (a
    cluster), once a chunk above (at D 2304: 2 in the fma body, 5 in the
    pair body)."""
    body = body_for(dtype, head_dim, kv_dtype)
    dp = padded_head_dim("flash_attention", head_dim)
    if dp <= CHUNK_DIM:
        return 1
    if body == "wgmma":
        return -(-head_dim // (2 * CHUNK_DIM))
    return -(-(dp // CHUNK_DIM) // FMA_CLUSTER)


def fma_rows(dtype: torch.dtype, head_dim: int, b: int, hq: int, s: int,
             sms: int, kv_dtype: Optional[torch.dtype] = None) -> int:
    """Query rows a block of the "fma" body for `b` x `hq` heads of `s`
    rows on a card of `sms` SMs (`torch.cuda.get_device_properties(
    device).multi_processor_count`), the rule `fma_rows` of
    csrc/flash_attention.cu applies: 64 at Dp CHUNK_DIM and above (the
    clusters' CTAs too); at Dp 64 and 128, 64 where tiles of 128 rows
    would give fewer blocks than the card has SMs (int8 at B2 Hq8 S200
    D64 on an H100: 32 blocks at 128 rows, so 64), else 128; 128 at Dp 16
    and 32. 0 where another body runs."""
    if body_for(dtype, head_dim, kv_dtype) != "fma":
        return 0
    dp = padded_head_dim("flash_attention", head_dim)
    if dp >= CHUNK_DIM:
        return 64
    if dp in (64, 128) and -(-s // 128) * b * hq < sms:
        return 64
    return 128


def _bind():
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_launch
    if not fn.argtypes:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, i, i, i, i, i,
                       ctypes.POINTER(ctypes.c_longlong), i, p]
        fn.restype = ctypes.c_int
        for name, n in (("flash_attention_wide_blocks", 2),
                        ("flash_attention_cluster", 2),
                        ("flash_attention_fma_rows", 6),
                        ("flash_attention_fma_clusters", 1)):
            getattr(lib, name).argtypes = [i] * n
            getattr(lib, name).restype = ctypes.c_int
    return lib, fn


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           out: torch.Tensor, causal: bool, window: int) -> None:
    """One launch of the CUDA kernel into `out` ([B, Hq, S, D], any strides
    the body takes), with no check: `flash_attention` checks first."""
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    B, Hq, S, D = q.shape
    lib, fn = _bind()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  B, Hq, k.shape[1], S, D, int(bool(causal)), int(window),
                  strides, _build.DTYPE_CODES[q.dtype], stream)
    _build.check(lib, code, "flash_attention launch")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0,
                    block_q: int = 128, block_k: int = 128) -> torch.Tensor:
    """q: [B, Hq, S, D]; k, v: [B, Hkv, S, D] -> [B, Hq, S, D] in q.dtype.

    `block_q` / `block_k` are kept for the reference's signature; they do not
    change the result and the kernel chooses its own tiles. Any S is taken
    (the ragged edge is masked in the kernel) and the operands are read
    through their strides, so a transposed view of [B, S, H, D] costs no
    copy; the output has q's layout. Every head size from 1 up is taken,
    in float32, bfloat16 and float16, and q, k, v of different types (the
    reference casts each to float32 in its body and returns q's type; the
    wrapper widens all three to float32 copies, exact for 16-bit types,
    runs the float32 body and casts the result to q's type). Which body
    runs is `body_for`: 16-bit and float8 rows at a head size that pads to
    64 to 256 multiply with wgmma, their tiles loaded by TMA where the rows
    are whole 16-byte pieces and by element otherwise (16-bit rows of whole
    pieces above 256 too, two warpgroups a block: `wide_blocks`).
    float8_e4m3fn and float8_e5m2 are
    read in place, and the output rounded to them without saturation
    (`ref.to_fp8`);
    8-, 16- and 32-bit integers run on float32 copies and the output is
    cut toward zero (`ref.to_int`), as the reference's `.astype`.

    Both devices refuse the same inputs: ranks, shapes, GQA divisibility,
    head size, dtypes, `window` and devices are checked before a CPU tensor
    goes to the plain version. Only the stride and alignment checks, which
    describe the kernel's 16-byte loads (none where the fma body runs at a
    head size not in `HEAD_DIMS`, or the element loader: they load by
    element), come after, for CUDA tensors.

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
    dp = padded_head_dim("flash_attention", D)
    check_types("flash_attention", q.dtype, k.dtype, v.dtype)
    if window < 0:
        raise ValueError(f"flash_attention: window must be >= 0, got {window}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: tensors on different devices")
    if q.device.type == "cpu":
        return ref.attention_ref(q, k, v, causal=causal, window=window)
    if not q.dtype == k.dtype == v.dtype or q.dtype not in KERNEL_TYPES:
        q32, k32, v32 = q.float(), k.float(), v.float()   # the float32 body
        return ref.from_float(flash_attention(q32, k32, v32, causal, window),
                              q.dtype)
    out = torch.empty_like(q)              # keeps q's (dense) strides
    # elements of one 16-byte load; the fma body and the element loader
    # load by element, but the fma body in float32 at a head size of
    # `HEAD_DIMS` does not
    by_element = body_for(q.dtype, D) in ("fma", "wgmma_elem") and not (
        q.dtype == torch.float32 and dp == D)
    chunk = 1 if by_element else 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        if t.stride(-1) != 1 or any(s % chunk for s in t.stride()[:-1]) \
                or t.data_ptr() % (chunk * t.element_size()):
            raise ValueError(f"flash_attention: {name} needs a unit last "
                             f"stride, other strides in multiples of {chunk} "
                             f"and a start aligned to {chunk} elements, got "
                             f"strides {t.stride()}")
    launch(q, k, v, out, causal, window)
    launches += 1
    return out
