"""paged_attention — single-token decode attention over the KV cache.

The Hopper counterpart of `src/repro/kernels/paged_attention.py`: the CUDA
source is `csrc/paged_attention.cu` (its header note says what bounds it and
what the design does about that), the plain version is
`ref.paged_attention_ref`. A CPU tensor runs the plain version; a CUDA tensor
launches the kernel or raises.

`paged_plan` lays a launch over the card from the shapes alone (the host
never reads `lengths`): how many blocks and how many rows one aload fetches.
The kernel's source sizes a block's ring of slots and its shared memory
(`ring` asks it). `block_chunks` mirrors, for the CPU tests, how the kernel
splits the valid rows among the blocks on the device.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, List, NamedTuple, Sequence, Tuple

import torch

from repro_torch.kernels import _build, ref

HEAD_DIMS = (16, 32, 64, 128)
GC = 8                  # query heads a block serves, a warp each
CHUNK_ROWS = 32         # most rows one aload fetches (a lane a row)

launches = 0            # +1 for every launch of the CUDA kernel, nowhere else


class PagedPlan(NamedTuple):
    """How a launch of the paged kernel covers the cache on a card."""
    blocks: int         # blocks of the launch
    rows: int           # rows one aload fetches: min(page, CHUNK_ROWS, T)
    segments: int       # (b, kv head, group of GC query heads) triples
    ngc: int            # groups of GC query heads a KV head


def paged_plan(B: int, Hq: int, Hkv: int, T: int, page: int,
               sms: int) -> PagedPlan:
    """The launch for a cache of B x T rows a KV head on a card of `sms`
    SMs, from the shapes only: one block an SM (its ring takes the SM's
    shared memory), no more blocks than the cache has aloads' worth of rows;
    an aload fetches at most `page` rows."""
    ngc = -(-(Hq // Hkv) // GC)
    rows = max(1, min(page, CHUNK_ROWS, T))
    segments = B * Hkv * ngc
    return PagedPlan(max(1, min(sms, -(-segments * T // rows))), rows,
                     segments, ngc)


def block_chunks(lengths: Sequence[int], T: int, hg: int, blocks: int,
                 rows: int) -> List[List[Tuple[int, int, int]]]:
    """The chunks each block fetches, as the kernel derives them from
    `lengths` on the device: a list a block of (segment, first row, rows).

    Segment s = b * hg + j is the j-th (KV head, head group) of sequence b;
    it has min(max(lengths[b], 0), T) valid rows. The valid rows of all
    segments, laid end to end, are cut into `blocks` runs of
    ceil(W / blocks) rows (W the total), so every block but the last has the
    same number of valid rows; a run is fetched in chunks of at most `rows`
    rows that never cross a segment."""
    lens = [min(max(int(n), 0), T) for n in lengths]
    prefix = [0]
    for n in lens:
        prefix.append(prefix[-1] + n)
    W = prefix[-1] * hg
    per = -(-W // blocks) if W else 0
    out = []
    for i in range(blocks):
        lo, hi = min(i * per, W), min((i + 1) * per, W)
        chunks, g = [], lo
        while g < hi:
            s, t, end = locate(prefix, hg, g)
            n = min(rows, end - g, hi - g)
            chunks.append((s, t, n))
            g += n
        out.append(chunks)
    return out


def locate(prefix: Sequence[int], hg: int, g: int) -> Tuple[int, int, int]:
    """(segment, row in it, end of the segment in the global row order) of
    global valid row g: the device's binary search over the prefix sums."""
    lo, hi = 0, len(prefix) - 2        # the last b with prefix[b] * hg <= g
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if prefix[mid] * hg <= g:
            lo = mid
        else:
            hi = mid - 1
    b = lo
    n = prefix[b + 1] - prefix[b]
    off = g - prefix[b] * hg
    j = off // n
    return b * hg + j, off % n, prefix[b] * hg + (j + 1) * n


def pieces(length: int, start: int, per: int) -> Tuple[int, int]:
    """(first block, blocks) of a segment of `length` valid rows starting at
    global row `start`, with `per` rows a block: the partials it is merged
    from. Its partials sit at `first + segment + k` of the workspace."""
    first = start // per
    return first, (start + length - 1) // per - first + 1


def _bind():
    lib = _build.load("paged_attention")
    fn = lib.paged_attention_launch
    if not fn.argtypes:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, i, i,
                       ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, i, p]
        fn.restype = ctypes.c_int
        lib.paged_attention_ring.argtypes = [i, i, i, i,
                                             ctypes.POINTER(ctypes.c_int)]
        lib.paged_attention_ring.restype = ctypes.c_int
    return lib, fn


@functools.lru_cache(maxsize=None)
def _sms(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=4096)
def _ring(B: int, D: int, rows: int, dtype: torch.dtype) -> Tuple[int, int]:
    lib, _ = _bind()
    smem = ctypes.c_int(0)
    slots = lib.paged_attention_ring(B, D, rows, _build.DTYPE_CODES[dtype],
                                     ctypes.byref(smem))
    if slots <= 0:
        raise ValueError(f"paged_attention: no ring for a batch of {B} at "
                         f"head size {D} fits in shared memory")
    return slots, smem.value


@functools.lru_cache(maxsize=4096)
def _card_plan(device: int, B: int, Hq: int, Hkv: int, T: int, D: int,
               dtype: torch.dtype, page: int) -> PagedPlan:
    plan = paged_plan(B, Hq, Hkv, T, page, _sms(device))
    _ring(B, D, plan.rows, dtype)         # refuses what the launch would
    return plan


def launch_plan(q: torch.Tensor, k_cache: torch.Tensor,
                page: int = 512) -> PagedPlan:
    """The plan `paged_attention` launches for these CUDA tensors."""
    B, Hq, D = q.shape
    return _card_plan(q.device.index, B, Hq, k_cache.shape[2],
                      k_cache.shape[1], D, q.dtype, page)


def ring(q: torch.Tensor, k_cache: torch.Tensor,
         page: int = 512) -> Tuple[int, int]:
    """(slots, shared-memory bytes) of the ring a block of the kernel takes
    for these CUDA tensors, as csrc/paged_attention.cu sizes it: the deepest
    of at most 8 slots that fits one block an SM."""
    plan = launch_plan(q, k_cache, page)
    return _ring(q.shape[0], q.shape[2], plan.rows, q.dtype)


# Partials and tickets, allocated once per (device, stream) and grown: the
# kernel's last block of a segment resets its ticket to 0, so the tickets are
# zero between launches and calls on one stream can share them.
_workspace: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}


def workspace(device: torch.device, stream: int, floats: int,
              tickets: int) -> Tuple[torch.Tensor, torch.Tensor]:
    key = (device.index, stream)
    part, tick = _workspace.get(key, (None, None))
    if part is None or part.numel() < floats:
        part = torch.empty(floats, dtype=torch.float32, device=device)
    if tick is None or tick.numel() < tickets:
        tick = torch.zeros(tickets, dtype=torch.int32, device=device)
    _workspace[key] = (part, tick)
    return part, tick


def paged_attention(q: torch.Tensor, k_cache: torch.Tensor,
                    v_cache: torch.Tensor, lengths: torch.Tensor,
                    page: int = 512) -> torch.Tensor:
    """q: [B, Hq, D]; k_cache/v_cache: [B, T, Hkv, D]; lengths: [B] ->
    out [B, Hq, D] in q.dtype. A sequence of length 0 gets 0.

    `page` is the fetch granularity: no aload of the kernel fetches more
    rows than that. Any T is taken (nothing is padded) and the caches are
    read in place through their strides, which must keep every row 16-byte
    aligned. `lengths` is read on the device only.

    Both devices refuse the same inputs: ranks, shapes, GQA divisibility,
    head size, dtypes, `lengths` (contiguous int32 [B]) and devices are
    checked before a CPU tensor goes to the plain version. Only the stride
    and alignment checks, which describe the kernel's loads, come after, for
    CUDA tensors."""
    global launches
    if q.device.type not in ("cpu", "cuda"):
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
    if not (k_cache.device == v_cache.device == lengths.device == q.device):
        raise ValueError("paged_attention: tensors on different devices")
    if q.device.type == "cpu":
        return ref.paged_attention_ref(q, k_cache, v_cache, lengths)
    row = 16 // q.element_size()           # elements in 16 bytes
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        if t.stride(-1) != 1 or any(s % row for s in t.stride()[:-1]) \
                or t.data_ptr() % 16:
            raise ValueError(f"paged_attention: {name} needs a unit last "
                             f"stride, other strides in multiples of {row} "
                             f"(16 bytes) and a 16-byte aligned start, got "
                             f"strides {t.stride()}")
    vec = max(D // 32, 1)                  # elements of q a lane loads
    if q.stride(-1) != 1 or any(s % vec for s in q.stride()[:-1]) \
            or q.data_ptr() % (vec * q.element_size()):
        raise ValueError(f"paged_attention: q needs a unit last stride, "
                         f"other strides in multiples of {vec} and a start "
                         f"aligned to {vec} elements, got {q.stride()}")
    out = torch.empty((B, Hq, D), dtype=q.dtype, device=q.device)
    if B == 0 or Hq == 0:
        return out
    plan = launch_plan(q, k_cache, page)
    strides = (ctypes.c_longlong * 8)(
        q.stride(0), q.stride(1),
        k_cache.stride(0), k_cache.stride(1), k_cache.stride(2),
        v_cache.stride(0), v_cache.stride(1), v_cache.stride(2))
    lib, fn = _bind()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        part, tick = workspace(
            q.device, stream,
            (plan.blocks + plan.segments) * GC * (D + 2), plan.segments)
        code = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                  lengths.data_ptr(), out.data_ptr(), part.data_ptr(),
                  tick.data_ptr(), B, Hq, Hkv, T, D, plan.blocks, plan.rows,
                  plan.ngc, strides,
                  1.0 / math.sqrt(D), _build.DTYPE_CODES[q.dtype], stream)
    _build.check(lib, code, "paged_attention launch")
    launches += 1
    return out
