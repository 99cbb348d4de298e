"""paged_attention — single-token decode attention over the KV cache.

The Hopper counterpart of `src/repro/kernels/paged_attention.py`: the CUDA
source is `csrc/paged_attention.cu` (its header note says what bounds it and
what the design does about that), the plain version is
`ref.paged_attention_ref`. A CPU tensor runs the plain version; a CUDA tensor
launches the kernel or raises.

`paged_plan` lays a launch over the card from the shapes alone (the host
never reads `lengths`): how many blocks, how many rows one aload fetches,
how many KV heads a segment takes (`kv_heads`) and how many query heads a
segment of one KV head serves (`query_heads`). The kernel's source
sizes a block's ring of slots and its shared memory (`ring` asks it).
`block_chunks` mirrors, for the CPU tests, how the kernel splits the valid
rows among the blocks on the device.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, NamedTuple, Sequence, Tuple

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.flash_attention import (CHUNK_DIM, HEAD_DIMS,
                                                 KERNEL_TYPES, check_types,
                                                 padded_head_dim)

GC = 8                  # query heads a block serves, a warp each
MERGE_GROUP = 8         # blocks of a first-level merge (csrc's MERGE_GROUP)
CHUNK_ROWS = 32         # most rows one aload fetches (a lane a row)
# the most bytes of a slot of the tensor-core body over the whole head above
# CHUNK_DIM (its rows hold all of K's and V's columns)
SLOT_BYTES = 65536
# CHUNK_DIM-column pieces a block of the wide body takes (csrc's
# WIDE_PIECES): the whole head up to 2048 columns, one chunk
WIDE_PIECES = 8
# the most bytes of a slot whose rows hold several KV heads (`kv_heads`)
HEADS_SLOT_BYTES = 65536
# the widest head the tensor-core body takes whole, a block over all its
# columns (csrc's MMA_WIDE; `products_on`): 16-bit caches under a q of their
# type up to here run no chunks
MMA_WIDE = 512

launches = 0            # +1 for every launch of the CUDA kernel, nowhere else


class PagedPlan(NamedTuple):
    """How a launch of the paged kernel covers the cache on a card."""
    blocks: int         # blocks of the launch (of each chunk)
    rows: int           # rows one aload fetches: min(page, CHUNK_ROWS, T)
    segments: int       # (b, kv head, group of `group` query heads)
                        # triples, or (b, run of `heads` KV heads) pairs
    ngc: int            # groups of `group` query heads a KV head
    chunks: int = 1     # chunks of WIDE_PIECES CHUNK_DIM-column pieces of
                        # the output a head (the wide body above 2048
                        # columns, each chunk's blocks over all of K's
                        # columns; else 1)
    heads: int = 1      # KV heads a segment (`kv_heads`)
    group: int = GC     # query heads a group (`query_heads`): GC or 2 GC
    box_heads: int = 1  # KV heads a slot row holds (`run_heads`, else heads)


def paged_plan(B: int, Hq: int, Hkv: int, T: int, page: int, sms: int,
               head_dim: int = 0, itemsize: int = 2,
               heads: int = 1, group: int = GC,
               box_heads: int = 0, products: str = "fma") -> PagedPlan:
    """The launch for a cache of B x T rows a KV head on a card of `sms`
    SMs, from the shapes only: one block an SM (its ring takes the SM's
    shared memory), no more blocks than the cache has aloads' worth of rows;
    an aload fetches at most `page` rows. Above CHUNK_DIM columns a block
    takes the whole head: on the tensor cores (up to MMA_WIDE columns,
    `products` "mma", as `products_on` gives it) a slot row holds all of
    K's and V's columns, at most SLOT_BYTES of them (`itemsize` the
    caches') an aload; on FMAs (the wide body) an aload is one piece of
    CHUNK_DIM columns of K or of V, and above WIDE_PIECES pieces (2048
    columns) the output is split into `chunks` of that many, each its own
    set of blocks (the SMs shared among them) that reads all of K's pieces
    (the logits are over the whole head) and the chunk's of V. A segment of
    `heads` KV heads
    (`kv_heads`; more than one only below GC query heads a KV head) takes
    a row of all of them an aload row, so an aload takes at most
    HEADS_SLOT_BYTES of K and V; so does a slot of unpadded rows (rows of
    no whole 16-byte pieces up to CHUNK_DIM columns), whose rows hold
    `box_heads` KV heads (`run_heads`; `heads` where 0). A segment of one
    KV head serves `group` of its query heads (`query_heads`): ceil(Hq /
    Hkv / group) segments a KV head, each of which fetches all its valid
    rows."""
    box_heads = box_heads or heads
    ngc = -(-(Hq // Hkv) // group)
    rows = max(1, min(page, CHUNK_ROWS, T))
    wide = -(-head_dim // CHUNK_DIM)        # CHUNK_DIM-column pieces
    chunks = 1
    if head_dim > CHUNK_DIM and products == "mma":
        rows = max(1, min(rows, SLOT_BYTES // (2 * wide * CHUNK_DIM
                                               * itemsize)))
    elif head_dim > CHUNK_DIM:
        chunks = -(-wide // WIDE_PIECES)
    unpadded = head_dim * itemsize % 16 != 0 and head_dim <= CHUNK_DIM
    if box_heads > 1 or unpadded:
        rows = max(1, min(rows, HEADS_SLOT_BYTES // (2 * box_heads * head_dim
                                                     * itemsize)))
    segments = B * (Hkv // heads) * ngc
    sms = max(1, sms // chunks)
    return PagedPlan(max(1, min(sms, -(-segments * T // rows))), rows,
                     segments, ngc, chunks, heads, group, box_heads)


def block_chunks(lengths: Sequence[int], T: int, hg: int, blocks: int,
                 rows: int) -> List[List[Tuple[int, int, int]]]:
    """The chunks each block fetches, as the kernel derives them from
    `lengths` on the device: a list a block of (segment, first row, rows).

    Segment s = b * hg + j is the j-th (KV head, query head group) of
    sequence b, or its j-th run of `PagedPlan.heads` KV heads (whose aload
    rows hold a row of each); it has min(max(lengths[b], 0), T) valid
    rows. The valid rows of all segments, laid end to end, are cut into
    `blocks` runs of ceil(W / blocks) rows (W the total), so every block
    but the last has the same number of valid rows; a run is fetched in
    chunks of at most `rows` rows that never cross a segment."""
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


def body_for(dtype: torch.dtype, head_dim: int) -> str:
    """The body a launch runs for caches of type `dtype`, a fixed rule on
    (type, head size) that `paged_attention_launch` in
    csrc/paged_attention.cu applies, for the body built at Dp =
    `padded_head_dim` (columns past `head_dim` zero and never stored; above
    256 the whole head a block, on the tensor cores up to MMA_WIDE, else
    in the wide body on FMAs, pieces of 256 columns through its ring:
    `products_on`, `paged_plan`): "tma" (the
    TMA page ring; where its products run: `products_on`) where a row of
    `head_dim` elements is a whole number of 16-byte pieces (float8: D %
    16 == 0), "element" (rows of no whole pieces: unpadded slots, loaded
    by TMA boxes of a run of the heads of a token where the caches allow,
    else copied by the producer warp, `route`; both products on FMAs)
    elsewhere. Integer caches run on float32 copies."""
    padded_head_dim("paged_attention", head_dim)        # refuses 0
    check_types("paged_attention", dtype)
    if dtype not in KERNEL_TYPES:
        dtype = torch.float32
    return "tma" if head_dim * dtype.itemsize % 16 == 0 else "element"


def kernel_types(q_dtype: torch.dtype, cache_dtype: torch.dtype
                 ) -> Tuple[torch.dtype, torch.dtype]:
    """(q's, the caches') type as the kernel reads them: caches of a type
    no body takes (integers) as float32 copies; beside 16-bit and float8
    caches q in its own type if it is float32, bfloat16, float16 or float8,
    beside float32 caches if it is float32; any other q widened to
    float32."""
    if cache_dtype not in KERNEL_TYPES:
        cache_dtype = torch.float32
    own = (q_dtype == cache_dtype if cache_dtype == torch.float32
           else q_dtype in KERNEL_TYPES)
    return (q_dtype if own else torch.float32), cache_dtype


def kv_heads(q_dtype: torch.dtype, cache_dtype: torch.dtype,
             head_dim: int, hq: int, hkv: int) -> int:
    """KV heads a segment of the launch, the rule `kv_run` of
    csrc/paged_attention.cu applies (`paged_attention_heads`) to the types
    `kernel_types` gives: where a KV head has fewer than GC query heads
    (G = hq / hkv dividing GC) at a padded head size of at most 256, rows
    of no whole 16-byte pieces (`body_for` "element") in every type under
    any q, and 16-bit caches under a q of their type on the TMA ring at a
    padded head size of 64 to 256, take GC / G KV heads a segment (halved
    until it divides hkv), so that every warp of a set has a query head:
    the first at every such G, the second at G = 1 and, where the head
    size is not the padded one, at G of 2 and 4; 1 elsewhere."""
    body = body_for(cache_dtype, head_dim)
    check_types("paged_attention", q_dtype)
    q_dtype, cache_dtype = kernel_types(q_dtype, cache_dtype)
    dp = padded_head_dim("paged_attention", head_dim)
    g = hq // hkv if hkv > 0 else 0
    if dp > CHUNK_DIM or not 1 <= g < GC or GC % g:
        return 1
    if body == "tma" and (cache_dtype not in (torch.bfloat16, torch.float16)
                          or q_dtype != cache_dtype or dp < 64
                          or (g > 1 and head_dim == dp)):
        return 1
    r = GC // g
    while hkv % r:
        r //= 2
    return r


def box_width(n: int, itemsize: int) -> int:
    """A TMA box's innermost extent for a run of n elements whose bytes are
    whole 16-byte pieces, as `box_width` of csrc/paged_attention.cu: the
    widest of at most 256 elements, a whole number of pieces, that divides
    n, with at most 256 boxes of it across; 0 where none."""
    u = 16 // itemsize
    k = n // u
    for d in range(256 // u, 0, -1):
        if k % d == 0:
            return u * d if k // d <= 256 else 0
    return 0


def run_heads(q_dtype: torch.dtype, cache_dtype: torch.dtype,
              head_dim: int, hq: int, hkv: int,
              strides: Sequence[int], aligned: bool) -> int:
    """KV heads of one TMA box where a row of `head_dim` elements is no
    whole number of 16-byte pieces but a run of the heads of a token is,
    the rule `run_box` of csrc/paged_attention.cu applies
    (`paged_attention_run`): the smallest multiple of `kv_heads` that
    divides hkv and whose rows are whole pieces, where both caches' heads
    are contiguous and their other strides multiples of 16 bytes
    (`strides`: k's and v's [B, T, Hkv] strides in elements), both starts
    16-byte aligned (`aligned`), the run cut into TMA boxes (`box_width`)
    and two of its rows within HEADS_SLOT_BYTES; 0 where not: the producer
    warp copies the rows (`route` "element")."""
    if body_for(cache_dtype, head_dim) != "element":
        return 0
    heads = kv_heads(q_dtype, cache_dtype, head_dim, hq, hkv)
    _, cache_dtype = kernel_types(q_dtype, cache_dtype)
    item = cache_dtype.itemsize
    if padded_head_dim("paged_attention", head_dim) > CHUNK_DIM \
            or not aligned:
        return 0
    for i in (0, 3):
        sb, st, sh = strides[i:i + 3]
        if sh != head_dim or st * item % 16 or sb * item % 16:
            return 0
    for rb in range(heads, hkv + 1, heads):
        if hkv % rb or rb * head_dim * item % 16:
            continue
        ok = box_width(rb * head_dim, item) > 0 \
            and 2 * rb * head_dim * item <= HEADS_SLOT_BYTES
        return rb if ok else 0
    return 0


def cache_facts(k_cache: torch.Tensor, v_cache: torch.Tensor
                ) -> Tuple[Tuple[int, ...], bool]:
    """What `run_heads` reads of the caches: k's and v's [B, T, Hkv]
    strides, and whether both start on 16 bytes."""
    return ((*k_cache.stride()[:3], *v_cache.stride()[:3]),
            (k_cache.data_ptr() | v_cache.data_ptr()) % 16 == 0)


def route(q: torch.Tensor, k_cache: torch.Tensor,
          v_cache: torch.Tensor) -> str:
    """How a call on these tensors loads its slots: "tma" (`body_for`'s
    TMA ring), "run" (rows of no whole 16-byte pieces by TMA boxes of a
    run of `run_heads` KV heads) or "element" (the producer warp copies
    them, in loads as wide as the rows, strides and starts allow)."""
    if body_for(k_cache.dtype, q.shape[-1]) == "tma":
        return "tma"
    strides, aligned = cache_facts(k_cache, v_cache)
    return "run" if run_heads(q.dtype, k_cache.dtype, q.shape[-1],
                              q.shape[1], k_cache.shape[2], strides,
                              aligned) else "element"


def query_heads(q_dtype: torch.dtype, cache_dtype: torch.dtype,
                head_dim: int, hq: int, hkv: int) -> int:
    """Query heads a segment of one KV head serves, the rule `group_heads`
    of csrc/paged_attention.cu applies (`paged_attention_group`): 2 GC
    where a KV head has more than GC query heads and the products run on
    the tensor cores (`products_on` "mma") at a padded head size of 256, so
    that each K and V row enters the ring once for up to 16 heads, every
    warp of a set taking two; GC elsewhere."""
    g = hq // hkv if hkv > 0 else 0
    if g <= GC or padded_head_dim("paged_attention", head_dim) != CHUNK_DIM:
        return GC
    return (2 * GC if products_on(q_dtype, cache_dtype, head_dim, hq, hkv)
            == "mma" else GC)


def products_on(q_dtype: torch.dtype, cache_dtype: torch.dtype,
                head_dim: int, hq: int = GC, hkv: int = 1) -> str:
    """Where a launch's two products run, the rule `products` of
    csrc/paged_attention.cu applies (`paged_attention_products`) to the
    types `kernel_types` gives: "mma" (mma.sync on the tensor cores) on the
    TMA ring, with 16-bit caches under a q of their type at a padded head
    size of 64 to 256 or of MMA_WIDE (256 < D <= 512: a block over the
    whole head, `paged_plan`'s chunks 1) in segments of one KV head
    (`kv_heads` 1: hq / hkv, GC by default, at least GC or not dividing
    it), or float8 caches under a q of 16 bits or float8 at a padded head
    size of 64 to 256 (K and V converted to f16, or to bf16 under a bf16
    q, in registers); "fma" (fp32 FMAs: a lane on D / 32 columns of every
    row of the chunk) elsewhere."""
    body = body_for(cache_dtype, head_dim)
    check_types("paged_attention", q_dtype)
    heads = kv_heads(q_dtype, cache_dtype, head_dim, hq, hkv)
    q_dtype, cache_dtype = kernel_types(q_dtype, cache_dtype)
    dp = padded_head_dim("paged_attention", head_dim)
    if body != "tma" or dp < 64:
        return "fma"
    if cache_dtype in (torch.bfloat16, torch.float16):
        return ("mma" if q_dtype == cache_dtype and heads == 1
                and dp <= MMA_WIDE else "fma")
    if cache_dtype in ref.FP8_TYPES and dp <= CHUNK_DIM:
        return "mma" if q_dtype != torch.float32 else "fma"
    return "fma"


def _bind():
    lib = _build.load("paged_attention")
    fn = lib.paged_attention_launch
    if not fn.argtypes:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, i, i,
                       ctypes.POINTER(ctypes.c_longlong), i, i, p]
        fn.restype = ctypes.c_int
        lib.paged_attention_ring.argtypes = [i, i, i, i, i, i, i,
                                             ctypes.POINTER(ctypes.c_int)]
        lib.paged_attention_ring.restype = ctypes.c_int
        for rule in (lib.paged_attention_products, lib.paged_attention_heads,
                     lib.paged_attention_group, lib.paged_attention_chunks):
            rule.argtypes = [i, i, i, i, i]
            rule.restype = ctypes.c_int
        lib.paged_attention_run.argtypes = [
            i, i, i, i, i, ctypes.POINTER(ctypes.c_longlong), i]
        lib.paged_attention_run.restype = ctypes.c_int
    return lib, fn


@functools.lru_cache(maxsize=None)
def _sms(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=4096)
def _ring(B: int, D: int, rows: int, dtype: torch.dtype, q_dtype: torch.dtype,
          heads: int = 1, group: int = GC) -> Tuple[int, int]:
    lib, _ = _bind()
    smem = ctypes.c_int(0)
    slots = lib.paged_attention_ring(B, D, rows, _build.DTYPE_CODES[dtype],
                                     _build.DTYPE_CODES[q_dtype], heads,
                                     group, ctypes.byref(smem))
    if slots <= 0:
        raise ValueError(f"paged_attention: no ring for a batch of {B} at "
                         f"head size {D} fits in shared memory")
    return slots, smem.value


@functools.lru_cache(maxsize=4096)
def _card_plan(device: int, B: int, Hq: int, Hkv: int, T: int, D: int,
               dtype: torch.dtype, page: int, q_dtype: torch.dtype,
               box: int = 0) -> PagedPlan:
    heads = kv_heads(q_dtype, dtype, D, Hq, Hkv)
    plan = paged_plan(B, Hq, Hkv, T, page, _sms(device), D, dtype.itemsize,
                      heads, query_heads(q_dtype, dtype, D, Hq, Hkv), box,
                      products_on(q_dtype, dtype, D, Hq, Hkv))
    _ring(B, D, plan.rows, dtype, kernel_types(q_dtype, dtype)[0],
          plan.box_heads, plan.group)                            # as launch
    return plan


def launch_plan(q: torch.Tensor, k_cache: torch.Tensor, page: int = 512,
                v_cache: torch.Tensor = None) -> PagedPlan:
    """The plan `paged_attention` launches for these CUDA tensors (q of
    the type `kernel_types` gives it; v_cache of k_cache's strides where
    not given)."""
    B, Hq, D = q.shape
    strides, aligned = cache_facts(k_cache,
                                   k_cache if v_cache is None else v_cache)
    box = run_heads(q.dtype, k_cache.dtype, D, Hq, k_cache.shape[2],
                    strides, aligned)
    return _card_plan(q.device.index, B, Hq, k_cache.shape[2],
                      k_cache.shape[1], D, k_cache.dtype, page, q.dtype, box)


def ring(q: torch.Tensor, k_cache: torch.Tensor, page: int = 512,
         v_cache: torch.Tensor = None) -> Tuple[int, int]:
    """(slots, shared-memory bytes) of the ring a block of the kernel takes
    for these CUDA tensors, as csrc/paged_attention.cu sizes it: the deepest
    of at most 8 slots that fits one block an SM."""
    plan = launch_plan(q, k_cache, page, v_cache)
    return _ring(q.shape[0], q.shape[2], plan.rows, k_cache.dtype,
                 kernel_types(q.dtype, k_cache.dtype)[0], plan.box_heads,
                 plan.group)


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
    rows than that. Any T and every head size D from 1 up is taken
    (`body_for`: the TMA ring where a row is a whole number of 16-byte
    pieces, which then needs every cache row 16-byte aligned; elsewhere the
    body that copies by element), in float32, bfloat16, float16,
    float8_e4m3fn and float8_e5m2, and 8-, 16- and 32-bit integers. Types
    may differ, as the reference casts each operand to float32 in its body:
    the kernel reads the caches in their own type and q in its own where
    `kernel_types` says so (beside 16-bit and float8 caches a float32,
    16-bit or float8 q, such as a bf16 q over an fp8 KV cache: the call is
    one kernel that writes the output in q's type, float8 without
    saturation; `products_on` says where its products run); any other q
    (an integer, or beside float32 caches a narrower float) is widened to
    float32 (a copy of q alone) and the result cast to q's type as the
    reference's `.astype` casts (`ref.from_float`: integers toward zero).
    k and v of two different types, or of an integer type, are both
    widened to float32 copies first. The caches are read in place through
    their strides. `lengths` is read on the device only.

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
    padded_head_dim("paged_attention", D)
    check_types("paged_attention", q.dtype, k_cache.dtype, v_cache.dtype)
    if lengths.dtype != torch.int32 or lengths.shape != (B,) \
            or not lengths.is_contiguous():
        raise TypeError("paged_attention: lengths must be contiguous int32 "
                        f"[{B}], got {lengths.dtype} {tuple(lengths.shape)}")
    if not (k_cache.device == v_cache.device == lengths.device == q.device):
        raise ValueError("paged_attention: tensors on different devices")
    if q.device.type == "cpu":
        return ref.paged_attention_ref(q, k_cache, v_cache, lengths)
    if k_cache.dtype != v_cache.dtype or k_cache.dtype not in KERNEL_TYPES:
        k_cache, v_cache = k_cache.float(), v_cache.float()   # one type
    out_dtype = q.dtype
    if kernel_types(q.dtype, k_cache.dtype)[0] != q.dtype:
        q = q.float()                      # widened, read against the caches
    body = body_for(k_cache.dtype, D)
    # the TMA ring loads 16-byte rows, the element body by element; q is
    # loaded by vectors of D / 32 elements at the head sizes of `HEAD_DIMS`
    row = 16 // k_cache.element_size() if body == "tma" else 1
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        if t.stride(-1) != 1 or any(s % row for s in t.stride()[:-1]) \
                or t.data_ptr() % (row * t.element_size()):
            raise ValueError(f"paged_attention: {name} needs a unit last "
                             f"stride, other strides in multiples of {row} "
                             f"and a start aligned to {row} elements, got "
                             f"strides {t.stride()}")
    # (a q of another type than the caches', and any q beside float8
    # caches, is loaded by element)
    vec = max(D // 32, 1) if D in HEAD_DIMS and q.dtype == k_cache.dtype \
        and q.dtype not in ref.FP8_TYPES else 1
    if q.stride(-1) != 1 or any(s % vec for s in q.stride()[:-1]) \
            or q.data_ptr() % (vec * q.element_size()):
        raise ValueError(f"paged_attention: q needs a unit last stride, "
                         f"other strides in multiples of {vec} and a start "
                         f"aligned to {vec} elements, got {q.stride()}")
    out = torch.empty((B, Hq, D), dtype=q.dtype, device=q.device)
    if B == 0 or Hq == 0:
        return out.to(out_dtype)
    launch(q, k_cache, v_cache, lengths, out, page)
    launches += 1
    return out if out.dtype == out_dtype else ref.from_float(out, out_dtype)


def launch(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
           lengths: torch.Tensor, out: torch.Tensor, page: int = 512) -> None:
    """One launch of the CUDA kernel into `out` ([B, Hq, D], unit last
    stride, q's type), with no check: `paged_attention` checks first. q has
    the type `kernel_types` gives it."""
    B, Hq, D = q.shape
    T, Hkv = k_cache.shape[1], k_cache.shape[2]
    plan = launch_plan(q, k_cache, page, v_cache)
    strides = (ctypes.c_longlong * 10)(
        q.stride(0), q.stride(1),
        k_cache.stride(0), k_cache.stride(1), k_cache.stride(2),
        v_cache.stride(0), v_cache.stride(1), v_cache.stride(2),
        out.stride(0), out.stride(1))
    # columns of a head's partial: the whole head's, a chunk's above 2048
    width = min(padded_head_dim("paged_attention", D),
                WIDE_PIECES * CHUNK_DIM)
    lib, fn = _bind()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        part, tick = workspace(
            q.device, stream,
            plan.chunks * (plan.blocks + plan.segments) * plan.group
            * (width + 2),
            plan.chunks * plan.segments * (1 + -(-plan.blocks
                                                 // MERGE_GROUP)))
        code = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                  lengths.data_ptr(), out.data_ptr(), part.data_ptr(),
                  tick.data_ptr(), B, Hq, Hkv, T, D, plan.blocks, plan.rows,
                  plan.ngc, strides, _build.DTYPE_CODES[k_cache.dtype],
                  _build.DTYPE_CODES[q.dtype], stream)
    _build.check(lib, code, "paged_attention launch")
