// async_scatter: table[idx[j]] op= upd[j] in place, op in {add, xor}: the
// update stream through a ring of bulk copies, the read-modify-write done by
// the L2's atomic units, and the many updates of rows narrower than a
// 32-byte sector into a table of 8 GiB or more bucketed by table region
// first.
//
// Replaces the TPU kernel `_scatter_kernel` / `async_scatter` of
// src/repro/kernels/async_scatter.py. There a grid step loads table rows K
// ahead into a VMEM ring (aload), modifies them in VMEM, stores them back with
// async copies that drain lazily (astore), and keeps the result right with a
// CAM-free software check (paper 5.1): at consume time it scans the last 2K-1
// indices for a store to the same row and, on a hit, drains stores up to the
// youngest conflicting one and loads again. Conflicts between grid steps need
// nothing, because the TPU runs the grid in order.
//
// The hazard on Hopper: blocks run at the same time on 132 SMs, so a row
// updated by two blocks would race between one block's load and the other's
// store. So the RMW leaves the SM: each update is a non-returning reduction at
// L2 (red.global.add.f32 / .add.s32 / .xor.b32 / .xor.b64 / .add.noftz.bf16x2
// / .add.noftz.f16x2, and for f32 rows of 8 or 16 bytes the vector
// atomicAdd(float2 / float4) of sm_90 with its result unused). The L2's atomic unit orders conflicting updates to a row, so the
// scan, the drain and the watermark have nothing left to do.
//
// AMI mapping of the apply kernel (`scatter_apply_kernel`):
//   aload  -> one cp.async.bulk of a span of indices and one of its update
//             rows into slot t % K, the slot's full mbarrier armed with
//             expect_tx(their bytes) by the producer lane;
//   getfin -> try_wait.parity on that full mbarrier, by every consumer;
//   SPM    -> the K slots;
//   astore -> the reductions, issued from the slot and never waited on.
// A slot is refilled only after every consumer warp has arrived on its empty
// mbarrier. A block is one producer warp and three consumer warps; its
// blocks take the spans grid-stride, planned by `scatter_plan` in
// async_scatter.py (a fixed rule):
//   - a call that is not bucketed: a persistent grid (two blocks an SM;
//     eight for rows narrower than a sector, whose lanes wait on more round
//     trips an update: 0.0702 ms against 0.1005 with two, bf16 into
//     [2^24, 3]), a span at a time through the K-slot ring;
//   - the bucketed stream: one slot, a block a span of at most 64 updates
//     and a block for every span, so that the hardware hands the blocks out
//     in the stream's order and the updates in flight on the card (blocks
//     an SM x 64) lie in one table region at a time. Here the grid is the
//     ring. A narrower window read faster (blocks of 256, 128, 64 updates);
//     a block's updates split over slots, a ticket (its round trip queues
//     behind the reductions at L2) and a persistent grid-stride grid (its
//     blocks drift apart in the stream) all read slower (PERF.md).
//
// The bucket pass (rows narrower than 32 bytes, a table of 2^33 bytes or
// more, 2^26 updates or more; a fixed rule, `async_scatter_bucketed` below
// and `bucketed` in async_scatter.py, fitted to the H100: into bf16 tables
// of [2^24, 3] to [2^28, 3] (96 MiB to 1.5 GiB) the apply alone was faster
// at every M from 2^20 to 2^26, at GUPS's 8 GiB faster up to 2^24, even at
// 2^25 and slower at 2^26, PERF.md): a
// stable counting sort
// of the (index, update row) pairs by idx >> shift into at most 256 table
// regions (32 MB each at GUPS's [2^30, 2] int32, within the 50 MB L2), in
// three kernels: `scatter_count_kernel` (a histogram per tile in shared
// memory; an index outside [0, N) traps here), `scatter_scan_kernel` (each
// bucket's tile counts scanned), `scatter_bucket_kernel` (each tile in
// sub-chunks that arrive by bulk copy, two slots deep: per-warp
// histograms, a stable local sort into shared memory by ballots over the
// bucket's bits, then the sub-chunk leaves bucket by bucket, neighbouring
// threads on neighbouring words). `ref.scatter_bucket_ref` gives the same
// order bit for bit.
//
// The word path (`chunk` 1 of the plan): 8- and 16-bit integers, fp8, and
// rows of any byte count (bf16 / f16 rows of an odd element count, rows of
// 3 or 6 bytes). A lane takes one of the aligned 4-byte words that hold part
// of a row (the table starts on 4 bytes; a row may start on any byte), with
// the update's bytes in their places and zeros elsewhere:
//   - xor: red.global.xor.b32 on the word: xor with 0 leaves a neighbour's
//     byte alone, so this is exact and needs no CAS (8/16-bit rows of whole
//     words run the int32 kernels on a view instead, as uint32 does);
//   - int16 / uint16 add: a returning add of the word and a carry repair
//     (`add16_rows`), no CAS. The L2 has no 16-bit integer reduction, but
//     its 32-bit add sums both halves at once but for one carry, out of the
//     low half into the high one. So each aligned word that holds part of
//     the row changes by one of three rules:
//       both halves in the row: one atom.global.add.u32 of w = hi << 16 |
//         lo, its old value kept; when c = ((old & 0xffff) + lo) >> 16 is
//         1, one red.global.add.u32 of 0xffff0000 follows, which takes the
//         carry out of the high half again;
//       only the high half in the row: a plain red.global.add.u32 of
//         hi << 16 (the carry out of bit 31 falls away: the int16 wrap);
//       only the low half in the row (rows of an odd element count): the
//         atom and repair of the first rule with 0 in the high half, so the
//         neighbour comes out bit for bit.
//     Exact in any order: no operation ever adds anything into the low
//     half but the rows' own lo, so the low half that an atom returns is
//     its true running sum (mod 2^16) and each computed carry is the true
//     one; the word ends as init + sum(w) - 2^16 sum(c) (mod 2^32), which
//     is the lane-wise wrapping sum, whenever each repair lands. A lane's
//     atoms are independent, so it issues ADD16_BATCH of them (over its
//     words and updates) before it reads any return and sends the repairs
//     after: issue early, wait late, where a CAS loop waits on a load and
//     a CAS round trip (and a retry on every lost race) for each word,
//     one word after the other;
//   - int8 / uint8 add: compare-and-swap of the word, adding per byte
//     (__vadd4, no carry between lanes of the word; adding 0 leaves a
//     neighbour alone); exact in any order, wrapping as the reference. The
//     16-bit rule does not carry over: a byte's carry lands in the next
//     byte, whose own carry another update may compute before the repair
//     lands. Bytes [0xff, 0xff, 0, 0]; A adds 1 to byte 0, B adds 1 to byte
//     1; A's atom (the word reads [0, 0, 1, 0]), B's atom (B sees byte 1 at
//     0, so no carry), A's repair of its one carry: [0, 0, 1, 0], where the
//     lane-wise sum is [0, 0, 0, 0];
//   - fp8 add: the same compare-and-swap, each of the row's bytes widened
//     to fp32, added and rounded back without saturation (`to_fp8`) at
//     every add, in the order the CASes win; a neighbour's byte is kept as
//     it is (adding +0.0 would turn its -0.0 into +0.0).
//   Both by `cas_rows`: a lane fills the B places of a batch with its next
//   units (over its units and updates), issues all their loads
//   (ld.global.cg) before it reads one, computes each new unit, issues
//   every CAS before it reads a return, and keeps each unit whose CAS lost
//   in its place, with the returned bytes as the next expectation (no
//   reload), beside the fresh units of the next batch. A CAS wins only
//   where the unit is still what the new one was computed from, so each
//   update is applied exactly once, to the unit as it stood: int8 is the
//   lane-wise wrapping sum in any order, fp8 one add and rounding an update
//   in the order the CASes win. A batch may hold one unit twice (a hot row
//   twice in a lane's updates): the second CAS loses to the first and takes
//   the first's result as its expectation. A CAS fails only because another
//   one changed the unit, so some CAS always wins: no deadlock and no
//   livelock. (Combining such a pair in registers would be exact for int8
//   only; it is not done.) What the parent's loop (a load and a CAS round
//   trip a word, one word after the other) measured (H100, 2^20 updates
//   into [2^24, 64], PERF.md): hot rows (a quarter into 4096) and uniform
//   ones alike, int8 0.59 ms where a xor of the same words (a reduction,
//   no CAS) took 0.10: the L2's compare-and-swaps a word set the pace, more
//   than the round trips (8 words a lane in flight took int8 only to 0.55
//   uniform, and hot rows to 0.64). So a row of whole 16-byte units on a
//   table that starts on one (the plan's chunk 16) swaps a unit at once
//   (atom.global.cas.b128, a quarter of the CASes), the group's lanes over
//   the (update, unit) pairs, B = CAS_BATCH (2) in flight: int8 0.27 hot,
//   0.23 uniform; 8 units in flight lost more races on hot rows (0.41, fp8
//   1.32). Other rows swap a word, one in flight (CAS_BATCH_WORD 1): on
//   3-byte rows 2 to 8 words in flight took the uniform case from 0.079 to
//   0.060-0.065 ms but the hot one from 0.17 to 0.23-0.34 (85 updates a hot
//   word: lost races).
//   - bf16 / f16 add: a word wholly in the row takes the pair reduction
//     (red.add.noftz.bf16x2 / .f16x2, a native REDG); a word holding one
//     element of the row, its pair a neighbour's, takes the pair reduction
//     too, with -0.0 in the neighbour's half: x + (-0.0) is x bit for bit
//     for every x but NaN (+0.0 would turn a -0.0 into +0.0), subnormals
//     kept under noftz. The L2's add does not keep a NaN's payload, so the
//     lane first reads the word (ld.global.cg) and a NaN neighbour takes
//     the scalar red.add.noftz.bf16 / .f16 instead, which ptxas makes a CAS
//     loop (sm_90 has no 16-bit RED): a neighbour no update of the call
//     touches cannot change under the read, so its bits are kept; one that
//     its own updates make NaN stays NaN (the add pins no payload). The
//     scalar form on every such
//     word, as before, cost 0.1609 ms at bf16 [2^24, 3] against 0.1186
//     with the read (bucketed both; PERF.md).
// The bucket pass and the apply move such rows by byte (the bulk copies'
// unit is then 16 updates: 16 x R is a whole number of 16-byte pieces).
//
// Consequences: i32 add and xor are exact whatever the order; f32 add is
// exact per update but the additions to one row land in the order the L2
// sees them, so a row hit more than once may differ from a sequential sum in
// its last bits (held to the reference tests' 1e-4, SCATTER_TOL). bf16 and
// f16 add round after every add, as the reference does in update order, but
// in the L2's order: an element hit c times may differ from the in-order sum
// by c rounding steps each way, at most 2 c u (1 + u)^c (|t| + sum |u_j|)
// with u the type's unit roundoff (`ref.scatter_add16_limit`). The kernel
// updates `table` in place (the reference's input_output_aliases={2: 0});
// ops.scatter_update clones first.
//
// Bound on this card: bytes, counted two ways. The byte bound reads and
// writes each touched row once and reads each index and update once; the
// sector bound moves the table in 32-byte sectors (read and written back),
// which at HPCC's 8-byte rows is 2.5x the byte bound. Measured beyond both
// (PERF.md): the L2's atomic units take about 22 G sector-reductions a
// second on an H100, so reductions one a sector cap GUPS (2^26 updates) near
// 3.0 ms in any order.

#include <type_traits>

#include "amu_ring.cuh"
#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace repro;
using namespace repro::hopper;

enum Op { OP_ADD = 0, OP_XOR = 1 };

constexpr int SECTOR = 32;           // rows narrower than this are bucketed
constexpr int APPLY_THREADS = 128;   // one producer warp, three consumer warps
constexpr int PASS_THREADS = 512;    // the bucket pass's blocks

__device__ __forceinline__ void red_add(float* p, float v) {
  asm volatile("red.global.add.f32 [%0], %1;\n" ::"l"(p), "f"(v) : "memory");
}
__device__ __forceinline__ void red_add(int* p, int v) {
  asm volatile("red.global.add.s32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}
__device__ __forceinline__ void red_xor(uint32_t* p, uint32_t v) {
  asm volatile("red.global.xor.b32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}
__device__ __forceinline__ void red_xor(unsigned long long* p,
                                        unsigned long long v) {
  asm volatile("red.global.xor.b64 [%0], %1;\n" ::"l"(p), "l"(v) : "memory");
}

// Two 16-bit elements added at once, each rounded to its type after its
// add (bf16 on sm_90; f16 since sm_60).
template <typename E>
__device__ __forceinline__ void red_add2(unsigned char* p, uint32_t v) {
  if constexpr (std::is_same_v<E, __half>)
    asm volatile("red.global.add.noftz.f16x2 [%0], %1;\n" ::"l"(p), "r"(v)
                 : "memory");
  else
    asm volatile("red.global.add.noftz.bf16x2 [%0], %1;\n" ::"l"(p), "r"(v)
                 : "memory");
}

// Whether the 16-bit value h (the low half) is a NaN of E's format.
template <typename E>
__device__ __forceinline__ bool nan16(uint32_t h) {
  return (h & 0x7fffu) > (std::is_same_v<E, __half> ? 0x7c00u : 0x7f80u);
}

// One 16-bit element (the low half of v), rounded to its type (sm_90): no
// L2 reduction this narrow exists, so ptxas makes it a CAS loop on the word.
template <typename E>
__device__ __forceinline__ void red_add1(unsigned char* p, uint32_t v) {
  const unsigned short h = (unsigned short)v;
  if constexpr (std::is_same_v<E, __half>)
    asm volatile("red.global.add.noftz.f16 [%0], %1;\n" ::"l"(p), "h"(h)
                 : "memory");
  else
    asm volatile("red.global.add.noftz.bf16 [%0], %1;\n" ::"l"(p), "h"(h)
                 : "memory");
}

__device__ __forceinline__ void red_add(uint32_t* p, uint32_t v) {
  asm volatile("red.global.add.u32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

// *p += v at L2, returning the word before.
__device__ __forceinline__ uint32_t atom_add(uint32_t* p, uint32_t v) {
  uint32_t old;
  asm volatile("atom.global.add.u32 %0, [%1], %2;\n"
               : "=r"(old)
               : "l"(p), "r"(v)
               : "memory");
  return old;
}

// The bytes of `inside` of old plus those of w, each fp8 byte widened to
// fp32, added and rounded back (`to_fp8`: no saturation); the others kept.
template <typename E>
__device__ __forceinline__ uint32_t add_fp8(uint32_t old, uint32_t w,
                                            uint32_t inside) {
  uint32_t r = old;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (!((inside >> (8 * i)) & 0xffu)) continue;
    E x, y;
    x.__x = (__nv_fp8_storage_t)(old >> (8 * i));
    y.__x = (__nv_fp8_storage_t)(w >> (8 * i));
    const E sum = from_float<E>(__fadd_rn(to_float(x), to_float(y)));
    r = (r & ~(0xffu << (8 * i))) | ((uint32_t)sum.__x << (8 * i));
  }
  return r;
}

template <typename E>
constexpr bool is_16bit_float =
    std::is_same_v<E, __nv_bfloat16> || std::is_same_v<E, __half>;

// The astore of one W-byte chunk, one reduction: dst op= the chunk at src.
template <int W, int OP, typename E>
__device__ __forceinline__ void reduce_chunk(unsigned char* dst,
                                             const unsigned char* src) {
  if constexpr (OP == OP_XOR && W == 8) {
    red_xor(reinterpret_cast<unsigned long long*>(dst),
            *reinterpret_cast<const unsigned long long*>(src));
  } else if constexpr (OP == OP_XOR) {
    static_assert(W == 4, "xor reduces 8 or 4 bytes at once");
    red_xor(reinterpret_cast<uint32_t*>(dst),
            *reinterpret_cast<const uint32_t*>(src));
  } else if constexpr (std::is_same_v<E, float> && W == 16) {
    (void)atomicAdd(reinterpret_cast<float4*>(dst),
                    *reinterpret_cast<const float4*>(src));
  } else if constexpr (std::is_same_v<E, float> && W == 8) {
    (void)atomicAdd(reinterpret_cast<float2*>(dst),
                    *reinterpret_cast<const float2*>(src));
  } else if constexpr (is_16bit_float<E>) {
    static_assert(W == 4, "16-bit add reduces two elements at once");
    red_add2<E>(dst, *reinterpret_cast<const uint32_t*>(src));
  } else {
    static_assert(W == 4, "int32 add reduces 4 bytes at once");
    red_add(reinterpret_cast<E*>(dst), *reinterpret_cast<const E*>(src));
  }
}

// The word path's astore of one aligned word of the table: w holds the
// update's bytes of it (zero elsewhere), `inside` 0xff in each byte of the
// row. E: bf16, f16; any for xor. (The 16-bit integer add: `add16_rows`;
// the 8-bit integer and fp8 add: `cas_rows`.)
template <int OP, typename E>
__device__ __forceinline__ void reduce_word(uint32_t* dst, uint32_t w,
                                            uint32_t inside) {
  if constexpr (OP == OP_XOR) {
    red_xor(dst, w);
  } else if constexpr (is_16bit_float<E>) {
    unsigned char* p = reinterpret_cast<unsigned char*>(dst);
    if (inside == 0xffffffffu) {
      red_add2<E>(p, w);
    } else {
      // one element of the row, the other half a neighbour's: the pair
      // reduction with -0.0 there, unless the neighbour is NaN (the note at
      // the top)
      const uint32_t cur = __ldcg(dst);
      const uint32_t nb = inside == 0x0000ffffu ? cur >> 16 : cur & 0xffffu;
      if (!nan16<E>(nb))
        red_add2<E>(p, w | (0x80008000u & ~inside));
      else if (inside == 0x0000ffffu)        // one element: the row's last
        red_add1<E>(p, w);
      else                                   // one element: the row's first
        red_add1<E>(p + 2, w >> 16);
    }
  } else {
    static_assert(OP == OP_XOR || is_16bit_float<E>,
                  "8-bit adds: `cas_rows`; 16-bit integer adds: `add16_rows`");
  }
}

// The update's bytes of the row's k-th aligned word (zero elsewhere) and
// `inside`, 0xff in each byte of the row; lead: the row's first byte in its
// word.
__device__ __forceinline__ void row_word(const unsigned char* src, int R,
                                         int lead, int k, uint32_t& w,
                                         uint32_t& inside) {
  w = 0;
  inside = 0;
  if ((R & 3) == 0) {                        // whole words (lead is 0)
    w = reinterpret_cast<const uint32_t*>(src)[k];
    inside = 0xffffffffu;
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int o = k * 4 + i - lead;          // the byte's place in the row
    if (o >= 0 && o < R) {
      w |= (uint32_t)src[o] << (8 * i);
      inside |= 0xffu << (8 * i);
    }
  }
}

__device__ __forceinline__ void check_row(int row, long long N) {
  if ((unsigned long long)(long long)row >= (unsigned long long)N) __trap();
}

// Words of a batch of the 16-bit integer add that a lane issues before it
// reads a return (the note at the top).
constexpr int ADD16_BATCH = 8;

// The 16-bit integer add (int16, uint16) of n update rows of R bytes, the
// rows `rows[u]` of the table, from src (u * R on), lanes sub, sub + L, ...
// of group g of G: the lane's words of updates g, g + G, ... in batches of
// ADD16_BATCH returning adds, each batch's carry repairs after it (the note
// at the top).
__device__ __forceinline__ void add16_rows(unsigned char* table,
                                           const int* rows,
                                           const unsigned char* src, int n,
                                           int R, int g, int G, int sub,
                                           int L, long long N) {
  int u = g, k = sub;                        // the next update and word
  while (u < n) {
    uint32_t* p[ADD16_BATCH];
    uint32_t old[ADD16_BATCH], lo[ADD16_BATCH];
#pragma unroll
    for (int i = 0; i < ADD16_BATCH; ++i) {
      lo[i] = 0;                             // no repair
      if (u >= n) continue;
      const int row = rows[u];
      check_row(row, N);
      const long long at = (long long)row * R;
      const int lead = (int)(at & 3);
      uint32_t w, inside;
      row_word(src + (size_t)u * R, R, lead, k, w, inside);
      p[i] = reinterpret_cast<uint32_t*>(table + (at - lead)) + k;
      if (inside == 0xffff0000u) {           // the high half alone
        red_add(p[i], w);
      } else {                               // the low half in the row
        old[i] = atom_add(p[i], w);
        lo[i] = w & 0xffffu;
      }
      k += L;
      if (k >= (lead + R + 3) >> 2) {        // the row's words are done
        k = sub;
        u += G;
      }
    }
#pragma unroll
    for (int i = 0; i < ADD16_BATCH; ++i)     // the carries out of the low half
      if (lo[i] && (old[i] & 0xffffu) + lo[i] > 0xffffu)
        red_add(p[i], 0xffff0000u);
  }
}

// The 8-bit integer and fp8 add's compare-and-swaps (the note at the top):
// the bytes one swaps where the rows are whole units of them and the table
// starts on one (the plan's chunk; else a word, chunk 1), and how many a
// lane keeps in flight, of units and of words.
constexpr int CAS_UNIT = 16;
constexpr int CAS_BATCH = 2;
constexpr int CAS_BATCH_WORD = 1;

// U bytes of the table as words: what one compare-and-swap reads and swaps
// (U 4 or 16: atom.global.cas.b32 or .b128).
template <int U>
struct Unit {
  uint32_t w[U / 4];
};

template <int U>
__device__ __forceinline__ Unit<U> ld_unit(const uint32_t* p) {
  Unit<U> x;
  if constexpr (U == 16) {
    const uint4 v = __ldcg(reinterpret_cast<const uint4*>(p));
    x.w[0] = v.x; x.w[1] = v.y; x.w[2] = v.z; x.w[3] = v.w;
  } else {
    x.w[0] = __ldcg(p);
  }
  return x;
}

__device__ __forceinline__ unsigned long long join(uint32_t lo, uint32_t hi) {
  return (unsigned long long)hi << 32 | lo;
}

// *p = v where *p is `e`, at L2; returns the bytes before.
template <int U>
__device__ __forceinline__ Unit<U> cas_unit(uint32_t* p, const Unit<U>& e,
                                            const Unit<U>& v) {
  Unit<U> o;
  if constexpr (U == 16) {
    unsigned long long lo, hi;
    asm volatile(
        "{\n.reg .b128 e, v, o;\nmov.b128 e, {%2, %3};\n"
        "mov.b128 v, {%4, %5};\natom.global.cas.b128 o, [%6], e, v;\n"
        "mov.b128 {%0, %1}, o;\n}\n"
        : "=l"(lo), "=l"(hi)
        : "l"(join(e.w[0], e.w[1])), "l"(join(e.w[2], e.w[3])),
          "l"(join(v.w[0], v.w[1])), "l"(join(v.w[2], v.w[3])), "l"(p)
        : "memory");
    o.w[0] = (uint32_t)lo; o.w[1] = (uint32_t)(lo >> 32);
    o.w[2] = (uint32_t)hi; o.w[3] = (uint32_t)(hi >> 32);
  } else {
    asm volatile("atom.global.cas.b32 %0, [%1], %2, %3;\n"
                 : "=r"(o.w[0])
                 : "l"(p), "r"(e.w[0]), "r"(v.w[0])
                 : "memory");
  }
  return o;
}

template <int U>
__device__ __forceinline__ bool same(const Unit<U>& a, const Unit<U>& b) {
  bool eq = true;
#pragma unroll
  for (int j = 0; j < U / 4; ++j) eq = eq && a.w[j] == b.w[j];
  return eq;
}

// The update's bytes w (zero elsewhere; `inside` 0xff in each byte of the
// row) added into `old`, word by word: per byte, wrapping, for int8 /
// uint8; each fp8 byte of the row widened, added and rounded back
// (`add_fp8`), the others kept.
template <typename E, int U>
__device__ __forceinline__ Unit<U> add_bytes(const Unit<U>& old,
                                             const Unit<U>& w,
                                             const Unit<U>& inside) {
  Unit<U> r;
#pragma unroll
  for (int j = 0; j < U / 4; ++j) {
    if constexpr (is_fp8<E>) r.w[j] = add_fp8<E>(old.w[j], w.w[j], inside.w[j]);
    else r.w[j] = __vadd4(old.w[j], w.w[j]);
  }
  return r;
}

// The 8-bit integer add (int8, uint8: E uint8_t) or fp8 add of n update
// rows of R bytes, the rows `rows[u]` of the table, from src (u * R on),
// lanes sub, sub + L, ... of group g of G, by compare-and-swaps of U bytes
// in batches of B: U 4, the row's aligned words (a row may start on any
// byte), each lane its words of updates g, g + G, ...; U 16 where R is a
// whole number of units and the table starts on one, the group's lanes
// over the (update, unit) pairs of its updates in turn. The lane's
// next units fill the B places of a batch, every fresh unit's load issued
// before any is read, then every place's CAS before any return is read; a
// place whose CAS lost keeps its unit, the returned bytes its next
// expectation, into the next batch beside fresh units (the note at the
// top).
template <typename E, int U, int B>
__device__ __forceinline__ void cas_rows(unsigned char* table,
                                         const int* rows,
                                         const unsigned char* src, int n,
                                         int R, int g, int G, int sub,
                                         int L, long long N) {
  constexpr int NW = U / 4;                  // words a unit
  const int nu = R / U;                      // units a row (U > 4)
  int u = g, k = sub;                        // U 4: the next update and word
  int f = sub;                               // U > 4: the next pair
  // the lane's next unit: its place and the update's bytes of it
  auto next = [&](uint32_t*& p, Unit<U>& w, Unit<U>& inside) -> bool {
    if constexpr (U == 4) {
      if (u >= n) return false;
      const int row = rows[u];
      check_row(row, N);
      const long long at = (long long)row * R;
      const int lead = (int)(at & 3);
      row_word(src + (size_t)u * R, R, lead, k, w.w[0], inside.w[0]);
      p = reinterpret_cast<uint32_t*>(table + (at - lead)) + k;
      k += L;
      if (k >= (lead + R + 3) >> 2) {        // the row's words are done
        k = sub;
        u += G;
      }
    } else {
      const int q = f / nu, uu = g + G * q, kk = f - q * nu;
      if (uu >= n) return false;
      const int row = rows[uu];
      check_row(row, N);
#pragma unroll
      for (int j = 0; j < NW; ++j)
        row_word(src + (size_t)uu * R, R, 0, kk * NW + j, w.w[j],
                 inside.w[j]);
      p = reinterpret_cast<uint32_t*>(table + (long long)row * R) + kk * NW;
      f += L;
    }
    return true;
  };
  uint32_t* p[B];
  Unit<U> w[B], inside[B], seen[B];
  bool live[B];                              // a unit not yet added
#pragma unroll
  for (int i = 0; i < B; ++i) live[i] = false;
  for (;;) {
    bool any = false;
#pragma unroll
    for (int i = 0; i < B; ++i) {            // fresh units: their loads
      if (!live[i] && next(p[i], w[i], inside[i])) {
        seen[i] = ld_unit<U>(p[i]);
        live[i] = true;
      }
      any |= live[i];
    }
    if (!any) return;
    Unit<U> got[B];
#pragma unroll
    for (int i = 0; i < B; ++i)              // every CAS, then the returns
      if (live[i])
        got[i] = cas_unit<U>(p[i], seen[i],
                             add_bytes<E, U>(seen[i], w[i], inside[i]));
#pragma unroll
    for (int i = 0; i < B; ++i) {
      if (live[i]) {
        live[i] = !same(got[i], seen[i]);    // lost: again, from the return
        seen[i] = got[i];
      }
    }
  }
}

// One update row of R bytes (from src) reduced into the table at byte `at`,
// lanes sub, sub + L, ... of a group of L: W bytes a reduction, or the word
// path (W == 1), the row's aligned words.
template <int W, int OP, typename E>
__device__ __forceinline__ void reduce_row(unsigned char* table, long long at,
                                           const unsigned char* src, int R,
                                           int sub, int L) {
  if constexpr (W == 1) {
    const int lead = (int)(at & 3);          // the row's first byte in its word
    uint32_t* words = reinterpret_cast<uint32_t*>(table + (at - lead));
    const int nw = (lead + R + 3) >> 2;
    for (int k = sub; k < nw; k += L) {
      uint32_t w, inside;
      row_word(src, R, lead, k, w, inside);
      reduce_word<OP, E>(words + k, w, inside);
    }
  } else {
    for (int k = sub; k < R / W; k += L)
      reduce_chunk<W, OP, E>(table + at + k * W, src + k * W);
  }
}

// ------------------------------------------------------------ apply kernel
// A block's shared memory: K full and K empty mbarriers, the span each slot
// holds, then K slots of [span indices | span update rows]. span is a
// multiple of 4 where R is (of 16 elsewhere), so every part starts on 16
// bytes. The launch
// sizes it from this function; apply_smem in async_scatter.py mirrors it for
// the planner, and chip_smoke.py holds the two equal.
struct ApplySmem {
  size_t which, slots, rows, slot, bytes;
};

__host__ __device__ inline ApplySmem apply_smem(int span, int K, int R) {
  ApplySmem m;
  m.which = (size_t)2 * K * 8;
  m.slots = (m.which + (size_t)K * 4 + 15) & ~(size_t)15;
  m.rows = (size_t)span * 4;
  m.slot = m.rows + (size_t)span * R;
  m.bytes = m.slots + (size_t)K * m.slot;
  return m;
}

template <int W, int OP, typename E>
__global__ void __launch_bounds__(APPLY_THREADS)
scatter_apply_kernel(unsigned char* __restrict__ table,
                     const int* __restrict__ idx,
                     const unsigned char* __restrict__ upd, long long N,
                     long long M, int R, int span, int K, int L) {
  extern __shared__ __align__(16) unsigned char smem[];
  const ApplySmem lay = apply_smem(span, K, R);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + K;
  int* which = reinterpret_cast<int*>(smem + lay.which);   // span of a slot
  unsigned char* slots = smem + lay.slots;
  const int consumers = (int)(blockDim.x >> 5) - 1;        // consumer warps
  // updates a bulk copy takes a whole number of (16 bytes of rows and of
  // indices); the last M mod unit are too short for one
  const int unit = R % 4 ? 16 : 4;
  const long long M4 = M - M % unit;
  const long long nspans = (M4 + span - 1) / span;

  for (int i = threadIdx.x; i < K; i += blockDim.x) {
    mbar_init(&full[i], 1);
    mbar_init(&empty[i], consumers);
  }
  fence_barrier_init();
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (warp == 0) {                     // the producer lane keeps K in flight
    if (lane != 0) return;
    for (int t = 0;; ++t) {            // the spans, grid-stride
      const int s = t % K;
      if (t >= K)                      // every consumer warp has left slot s
        mbar_wait(&empty[s], (uint32_t)((t / K - 1) & 1));
      const long long sp = blockIdx.x + (long long)gridDim.x * t;
      if (sp >= nspans) {              // no span left: tell the consumers
        which[s] = -1;
        mbar_arrive(&full[s]);
        return;
      }
      which[s] = (int)sp;
      const long long first = sp * span;
      const uint32_t n = (uint32_t)min((long long)span, M4 - first);
      unsigned char* dst = slots + (size_t)s * lay.slot;
      mbar_arrive_expect_tx(&full[s], n * (4 + (uint32_t)R));   // aload
      bulk_load(dst, idx + first, n * 4, &full[s]);
      bulk_load(dst + lay.rows, upd + first * R, n * (uint32_t)R, &full[s]);
    }
  }

  // consumers: groups of L lanes share an update row, W bytes a reduction
  // (the 16-bit integer add: `add16_rows`; the 8-bit integer and fp8 add:
  // `cas_rows`)
  constexpr bool ADD16 =
      W == 1 && OP == OP_ADD && std::is_same_v<E, uint16_t>;
  constexpr bool CAS = OP == OP_ADD &&
                       (std::is_same_v<E, uint8_t> || is_fp8<E>);
  static_assert(!CAS || W == 1 || W == CAS_UNIT, "CAS: words or units");
  const int c = threadIdx.x - 32;
  const int G = consumers * 32 / L, g = c / L, sub = c % L;
  // n update rows (rows[u] of the table, from src)
  auto apply = [&](const int* rows, const unsigned char* src, int n) {
    if constexpr (ADD16) {
      add16_rows(table, rows, src, n, R, g, G, sub, L, N);
    } else if constexpr (CAS) {      // units of W bytes (1: words)
      cas_rows<E, W == 1 ? 4 : W, W == 1 ? CAS_BATCH_WORD : CAS_BATCH>(
          table, rows, src, n, R, g, G, sub, L, N);
    } else {
      for (int u = g; u < n; u += G) {
        const int row = rows[u];
        check_row(row, N);
        reduce_row<W, OP, E>(table, (long long)row * R, src + (size_t)u * R,
                             R, sub, L);
      }
    }
  };
  if (blockIdx.x == 0)                 // the last M mod unit, from global
    apply(idx + M4, upd + M4 * R, (int)(M - M4));
  for (int t = 0;; ++t) {
    const int s = t % K;
    mbar_wait(&full[s], (uint32_t)((t / K) & 1));  // getfin
    const int sp = which[s];
    if (sp < 0) return;
    const int n = (int)min((long long)span, M4 - (long long)sp * span);
    const unsigned char* slot = slots + (size_t)s * lay.slot;
    const int* sidx = reinterpret_cast<const int*>(slot);
    apply(sidx, slot + lay.rows, n);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);          // the slot may refill
  }
}

// ------------------------------------------------------------ bucket pass
// In-place exclusive scan of data[0, n) in shared memory by the whole block
// (blockDim.x a multiple of 32, at most 1024); returns the total. scratch:
// 33 ints of shared memory.
__device__ int block_exclusive_scan(int* data, int n, int* scratch) {
  const int per = (n + blockDim.x - 1) / blockDim.x;
  const int lo = min(n, (int)threadIdx.x * per), hi = min(n, lo + per);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum += data[i];
  int x = sum;                                     // inclusive within the warp
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) scratch[warp] = x;
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    int w = lane < nw ? scratch[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    scratch[lane] = w;                             // inclusive over warps
    if (lane == 31) scratch[32] = w;
  }
  __syncthreads();
  int run = (warp ? scratch[warp - 1] : 0) + x - sum;
  for (int i = lo; i < hi; ++i) {
    const int t = data[i];
    data[i] = run;
    run += t;
  }
  const int total = scratch[32];
  __syncthreads();
  return total;
}

// counts[b * tiles + tile]: updates of tile `tile` in bucket b.
__global__ void __launch_bounds__(PASS_THREADS)
scatter_count_kernel(const int* __restrict__ idx, int* __restrict__ counts,
                     long long N, long long M, int shift, int B, int tile,
                     int tiles) {
  extern __shared__ int hist[];
  for (int b = threadIdx.x; b < B; b += blockDim.x) hist[b] = 0;
  __syncthreads();
  const long long first = (long long)blockIdx.x * tile;
  const long long end = min(M, first + tile);
#pragma unroll 4
  for (long long j = first + threadIdx.x; j < end; j += blockDim.x) {
    const int row = idx[j];
    check_row(row, N);
    atomicAdd(&hist[row >> shift], 1);
  }
  __syncthreads();
  for (int b = threadIdx.x; b < B; b += blockDim.x)
    counts[(size_t)b * tiles + blockIdx.x] = hist[b];
}

// Block b: counts[b * tiles ...] scanned in place (exclusive), and the
// bucket's size into totals[b].
__global__ void __launch_bounds__(PASS_THREADS)
scatter_scan_kernel(int* __restrict__ counts, int* __restrict__ totals,
                    int tiles) {
  __shared__ int buf[1024];
  __shared__ int scratch[33];
  int* row = counts + (size_t)blockIdx.x * tiles;
  int carry = 0;
  for (int base = 0; base < tiles; base += 1024) {
    const int n = min(1024, tiles - base);
    for (int i = threadIdx.x; i < n; i += blockDim.x) buf[i] = row[base + i];
    __syncthreads();
    const int total = block_exclusive_scan(buf, n, scratch);
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      row[base + i] = buf[i] + carry;
    carry += total;
    __syncthreads();
  }
  if (threadIdx.x == 0) totals[blockIdx.x] = carry;
}

// The bucket kernel's shared memory: two input mbarriers, per-warp
// histograms (16-bit counts, two to a word: a sub-chunk holds at most 4096
// updates), a sub-chunk's bucket counts and first places, the tile's cursor
// in each bucket, scan scratch, two input slots (indices, rows) so that the
// next sub-chunk loads while this one is sorted, then the sorted sub-chunk.
struct BucketSmem {
  size_t hist, count, start, cursor, scratch, in, in_rows, slot, sidx, srow,
      bytes;
};

__host__ __device__ inline BucketSmem bucket_smem(int B, int warps, int sub,
                                                  int R) {
  BucketSmem m;
  size_t o = 16;                                   // two mbarriers
  m.hist = o;
  o += ((size_t)warps * ((B + 1) & ~1) * 2 + 15) & ~(size_t)15;
  m.count = o;
  o += (size_t)B * 4;
  m.start = o;
  o += (size_t)B * 4;
  m.cursor = o;
  o += (size_t)B * 4;
  m.scratch = o;
  o += 33 * 4;
  o = (o + 15) & ~(size_t)15;
  m.in = o;                                        // slot i at in + i * slot
  m.in_rows = (size_t)sub * 4;                     // within a slot
  m.slot = (size_t)sub * (4 + R);
  o += 2 * m.slot;
  m.sidx = o;
  o += (size_t)sub * 4;
  m.srow = o;
  o += (size_t)sub * R;
  m.bytes = o;
  return m;
}

// The lanes of this warp whose key is mine (`ok` lanes only): one ballot a
// bit of the key, `bits` bits.
__device__ __forceinline__ unsigned key_peers(int key, int bits, bool ok) {
  unsigned peers = __ballot_sync(0xffffffffu, ok);
  for (int i = 0; i < bits; ++i) {
    const bool bit = (key >> i) & 1;
    const unsigned set = __ballot_sync(0xffffffffu, bit);
    peers &= bit ? set : ~set;
  }
  return ok ? peers : 0u;
}

// Tile blockIdx.x (`tile` updates from blockIdx.x * tile) into its places of
// the bucketed stream, `sub` updates at a time. A sub-chunk arrives in shared
// memory by two bulk copies (the last M mod 4 updates by plain loads) while
// the one before it is sorted. Each warp takes a contiguous piece of it and
// walks it 32 at a time in order: lanes of one bucket find each other by
// ballots over the bucket's bits, so a lane's place is its warp's count so
// far in the bucket plus the lanes below it; warps' places follow warp
// order, sub-chunks sub-chunk order and tiles tile order (the scanned
// counts): the sort is stable. The sorted sub-chunk leaves bucket by bucket,
// neighbouring threads on neighbouring words. RW: 4-byte words a row, moved
// as the widest of 16-, 8- and 4-byte words that divides it (V); RW = 0:
// rows of any byte count Rb (no whole 4-byte words), moved by byte, whose
// bulk copies take 16 updates at a time.
template <int RW>
__global__ void __launch_bounds__(PASS_THREADS)
scatter_bucket_kernel(const int* __restrict__ idx,
                      const unsigned char* __restrict__ upd,
                      int* __restrict__ out_idx,
                      unsigned char* __restrict__ out_rows,
                      const int* __restrict__ counts,
                      const int* __restrict__ totals,
                      int* __restrict__ offsets, long long M, int shift,
                      int B, int sub, int tile, int tiles, int Rb) {
  const int R = RW ? RW * 4 : Rb;
  using V = std::conditional_t<
      RW == 0, unsigned char,
      typename Chunk<RW % 4 == 0 ? 16 : RW % 2 == 0 ? 8 : 4>::type>;
  const int VW = R / (int)sizeof(V);                 // words of V a row
  constexpr unsigned UNIT = RW ? 4 : 16;             // updates a bulk copy
  extern __shared__ __align__(16) unsigned char smem[];
  const int W = blockDim.x >> 5, warp = threadIdx.x >> 5,
            lane = threadIdx.x & 31;
  const BucketSmem lay = bucket_smem(B, W, sub, R);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  const int BH = (B + 1) & ~1;                       // a warp's counts
  uint16_t* hist = reinterpret_cast<uint16_t*>(smem + lay.hist);
  int* count = reinterpret_cast<int*>(smem + lay.count);
  int* start = reinterpret_cast<int*>(smem + lay.start);
  int* cursor = reinterpret_cast<int*>(smem + lay.cursor);
  int* scratch = reinterpret_cast<int*>(smem + lay.scratch);
  int* sidx = reinterpret_cast<int*>(smem + lay.sidx);
  V* srow = reinterpret_cast<V*>(smem + lay.srow);
  V* out_words = reinterpret_cast<V*>(out_rows);
  const int bits = 32 - __clz(max(B - 1, 1));        // bits of a bucket
  const long long tile0 = (long long)blockIdx.x * tile;
  const long long tile_end = min(M, tile0 + tile);
  auto in_idx = [&](int k) {
    return reinterpret_cast<int*>(smem + lay.in + (k & 1) * lay.slot);
  };
  auto in_rows = [&](int k) {
    return reinterpret_cast<V*>(smem + lay.in + (k & 1) * lay.slot +
                                lay.in_rows);
  };
  auto issue = [&](int k) {                          // aload of sub-chunk k
    const long long first = tile0 + (long long)k * sub;
    if (first >= tile_end) return;
    const uint32_t n4 =
        (uint32_t)min((long long)sub, tile_end - first) & ~(UNIT - 1);
    mbar_arrive_expect_tx(&bar[k & 1], n4 * (4 + (uint32_t)R));
    if (n4) {
      bulk_load(in_idx(k), idx + first, n4 * 4, &bar[k & 1]);
      bulk_load(in_rows(k), upd + first * R, n4 * (uint32_t)R, &bar[k & 1]);
    }
  };

  if (threadIdx.x == 0) {
    mbar_init(&bar[0], 1);
    mbar_init(&bar[1], 1);
    fence_barrier_init();
    issue(0);
  }
  // the buckets' first places (a scan of their sizes), then this tile's
  for (int b = threadIdx.x; b < B; b += blockDim.x) start[b] = totals[b];
  __syncthreads();
  block_exclusive_scan(start, B, scratch);
  for (int b = threadIdx.x; b < B; b += blockDim.x) {
    cursor[b] = start[b] + counts[(size_t)b * tiles + blockIdx.x];
    if (blockIdx.x == 0) offsets[b] = start[b];
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) offsets[B] = (int)M;

  uint16_t* h = hist + (size_t)warp * BH;            // this warp's counts
  unsigned* h2 = reinterpret_cast<unsigned*>(h);     // two to a word
  int k = 0;
  for (long long first = tile0; first < tile_end; first += sub, ++k) {
    const int n = (int)min((long long)sub, tile_end - first);
    const int per = ((n + W - 1) / W + 31) & ~31;    // whole steps of 32
    const int lo = min(n, warp * per), hi = min(n, lo + per);
    int* xi = in_idx(k);
    V* xr = in_rows(k);
    if (threadIdx.x == 0) issue(k + 1);   // its slot was left a round ago
    for (int i = threadIdx.x; i < W * BH / 2; i += blockDim.x)
      reinterpret_cast<unsigned*>(hist)[i] = 0;
    mbar_wait(&bar[k & 1], (uint32_t)((k >> 1) & 1));          // getfin
    for (int i = (n & ~(int)(UNIT - 1)) + threadIdx.x; i < n;
         i += blockDim.x) {
      xi[i] = idx[first + i];                        // too short to bulk copy
#pragma unroll
      for (int w = 0; w < VW; ++w)
        xr[(size_t)i * VW + w] =
            reinterpret_cast<const V*>(upd + (first + i) * R)[w];
    }
    __syncthreads();
    for (int i = lo + lane; i < hi; i += 32) {                   // count
      const int b = xi[i] >> shift;
      atomicAdd(&h2[b >> 1], 1u << ((b & 1) * 16));
    }
    __syncthreads();
    for (int b = threadIdx.x; b < B; b += blockDim.x) {
      int run = 0;                                   // warps in order
      for (int w = 0; w < W; ++w) {
        const int t = hist[(size_t)w * BH + b];
        hist[(size_t)w * BH + b] = (uint16_t)run;
        run += t;
      }
      count[b] = run;
      start[b] = run;
    }
    __syncthreads();
    block_exclusive_scan(start, B, scratch);         // buckets in order
    for (int i = lo + lane; i - lane < hi; i += 32) {          // place
      const bool ok = i < hi;
      const int v = ok ? xi[i] : 0;
      const int b = v >> shift;
      const unsigned peers = key_peers(b, bits, ok);
      if (ok) {
        const int pos = start[b] + h[b] + __popc(peers & ((1u << lane) - 1));
        sidx[pos] = v;
#pragma unroll
        for (int w = 0; w < VW; ++w)
          srow[(size_t)pos * VW + w] = xr[(size_t)i * VW + w];
      }
      __syncwarp();
      if (ok && lane == __ffs(peers) - 1) h[b] += __popc(peers);
      __syncwarp();
    }
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += blockDim.x) {         // write out
      const int v = sidx[i], b = v >> shift;
      out_idx[cursor[b] + i - start[b]] = v;
    }
    for (int q = threadIdx.x; q < n * VW; q += blockDim.x) {
      const int e = q / VW, b = sidx[e] >> shift;
      out_words[(size_t)(cursor[b] + e - start[b]) * VW + (q - e * VW)] =
          srow[q];
    }
    __syncthreads();
    for (int b = threadIdx.x; b < B; b += blockDim.x) cursor[b] += count[b];
  }
}

// ----------------------------------------------------------------- launch
template <int W, int OP, typename E>
cudaError_t apply(void* table, const void* idx, const void* upd, long long N,
                  long long M, int R, int span, int K, int L, int blocks,
                  cudaStream_t stream) {
  const size_t smem = apply_smem(span, K, R).bytes;
  if (smem > (size_t)MAX_SMEM) return cudaErrorInvalidValue;
  static SmemAllowance allowance;
  cudaError_t err =
      allow_smem(allowance, scatter_apply_kernel<W, OP, E>, MAX_SMEM);
  if (err != cudaSuccess) return err;
  scatter_apply_kernel<W, OP, E><<<blocks, APPLY_THREADS, smem, stream>>>(
      static_cast<unsigned char*>(table), static_cast<const int*>(idx),
      static_cast<const unsigned char*>(upd), N, M, R, span, K, L);
  return cudaGetLastError();
}

template <int W, int OP, typename E>
cudaError_t occupancy(int smem, int* blocks) {
  static SmemAllowance allowance;
  cudaError_t err =
      allow_smem(allowance, scatter_apply_kernel<W, OP, E>, MAX_SMEM);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, scatter_apply_kernel<W, OP, E>, APPLY_THREADS, smem);
}

// The instantiation for (op, dtype, chunk): one reduction a chunk, as wide
// as the op has one (REDUCE_WIDTH in async_scatter.py): f32 add 16, 8 or 4
// bytes (atomicAdd of float4, float2, red.add.f32), i32 add 4, bf16 and f16
// add 4 (red.add.noftz.bf16x2 / .f16x2), i32 xor 8 or 4. (uint32 tables
// come as int32 views: two's-complement add and xor ignore the sign.) A
// wider chunk of xor or int add would be several reductions a lane at a
// stride, meeting each sector more than once. chunk 1: the word path, for
// xor of any type, and add of 8/16-bit integers (either sign: one
// instantiation a width), fp8, and bf16 / f16 rows of no whole words.
template <template <int, int, typename> class F, typename... A>
cudaError_t dispatch(int op, int dtype, int chunk, A... args) {
  if (chunk == 1 && op == OP_XOR) return F<1, OP_XOR, uint32_t>::run(args...);
  if (chunk == 1 && op == OP_ADD) {
    switch (dtype) {
      case DTYPE_BF16: return F<1, OP_ADD, __nv_bfloat16>::run(args...);
      case DTYPE_F16: return F<1, OP_ADD, __half>::run(args...);
      case DTYPE_I8:
      case DTYPE_U8: return F<1, OP_ADD, uint8_t>::run(args...);
      case DTYPE_I16:
      case DTYPE_U16: return F<1, OP_ADD, uint16_t>::run(args...);
      case DTYPE_E4M3: return F<1, OP_ADD, fp8_e4m3>::run(args...);
      case DTYPE_E5M2: return F<1, OP_ADD, fp8_e5m2>::run(args...);
    }
    return cudaErrorInvalidValue;
  }
  if (chunk == CAS_UNIT && op == OP_ADD) {     // 16-byte compare-and-swaps
    switch (dtype) {
      case DTYPE_I8:
      case DTYPE_U8: return F<CAS_UNIT, OP_ADD, uint8_t>::run(args...);
      case DTYPE_E4M3: return F<CAS_UNIT, OP_ADD, fp8_e4m3>::run(args...);
      case DTYPE_E5M2: return F<CAS_UNIT, OP_ADD, fp8_e5m2>::run(args...);
    }
  }
  if (op == OP_ADD && dtype == DTYPE_F32) {
    switch (chunk) {
      case 16: return F<16, OP_ADD, float>::run(args...);
      case 8: return F<8, OP_ADD, float>::run(args...);
      case 4: return F<4, OP_ADD, float>::run(args...);
    }
  }
  if (op == OP_ADD && dtype == DTYPE_I32 && chunk == 4)
    return F<4, OP_ADD, int>::run(args...);
  if (op == OP_ADD && dtype == DTYPE_BF16 && chunk == 4)
    return F<4, OP_ADD, __nv_bfloat16>::run(args...);
  if (op == OP_ADD && dtype == DTYPE_F16 && chunk == 4)
    return F<4, OP_ADD, __half>::run(args...);
  if (op == OP_XOR && dtype == DTYPE_I32) {
    switch (chunk) {
      case 8: return F<8, OP_XOR, uint32_t>::run(args...);
      case 4: return F<4, OP_XOR, uint32_t>::run(args...);
    }
  }
  return cudaErrorInvalidValue;
}

template <int W, int OP, typename E>
struct Apply {
  template <typename... A>
  static cudaError_t run(A... args) {
    return apply<W, OP, E>(args...);
  }
};

template <int W, int OP, typename E>
struct Occupancy {
  template <typename... A>
  static cudaError_t run(A... args) {
    return occupancy<W, OP, E>(args...);
  }
};

}  // namespace

// The fixed rule of the path: 1 where M updates of rows of R bytes into a
// table of N rows are bucketed by table region before the apply (rows
// narrower than a 32-byte sector, a table of 2^33 bytes or more and 2^26
// updates or more), else 0.
extern "C" int async_scatter_bucketed(int R, long long N, long long M) {
  return R < SECTOR && N * R >= (1LL << 33) && M >= (1LL << 26) ? 1 : 0;
}

// Shared-memory bytes of an apply block: K slots of `span` updates of R bytes.
extern "C" long long async_scatter_apply_smem(int span, int K, int R) {
  return (long long)apply_smem(span, K, R).bytes;
}

// The apply: every update of idx / upd (the caller's, or the bucketed
// stream's) reduced into the table. chunk: bytes a reduction (16, 8 or 4,
// dividing R and the table's alignment; 16 also the 8-bit integer and fp8
// add's compare-and-swap of a 16-byte unit), or 1: the word path (the table
// starts on 4 bytes); span: updates a slot (a multiple of 4, of 16 where R
// is not a multiple of 4); K: slots a block; lanes: L, lanes that share a row; blocks: the grid,
// whose blocks take the spans grid-stride. idx and upd start on 16-byte
// boundaries. All planned by `scatter_plan`.
extern "C" int async_scatter_launch(void* table, const void* idx,
                                    const void* upd, long long N, long long M,
                                    int R, int span, int K, int chunk,
                                    int lanes, int blocks, int op, int dtype,
                                    void* stream) {
  return (int)dispatch<Apply>(op, dtype, chunk, table, idx, upd, N, M, R,
                              span, K, lanes, blocks,
                              static_cast<cudaStream_t>(stream));
}

// Blocks of the apply kernel one SM holds at once with `smem` bytes each.
extern "C" int async_scatter_blocks_per_sm(int op, int dtype, int chunk,
                                           int smem, int* blocks) {
  return (int)dispatch<Occupancy>(op, dtype, chunk, smem, blocks);
}

// The bucket pass, three launches: idx / upd (M updates of R bytes, 16-byte
// aligned) into out_idx / out_rows in stable order of idx >> shift, with the
// B + 1 bucket offsets. counts: B * tiles ints, totals: B ints of scratch;
// `tiles` blocks of `tile` updates, each in sub-chunks of `sub`.
extern "C" int async_scatter_bucket_launch(
    const void* idx, const void* upd, void* out_idx, void* out_rows,
    void* counts, void* totals, void* offsets, long long N, long long M,
    int R, int shift, int B, int sub, int tile, int tiles, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* in = static_cast<const int*>(idx);
  int* cnt = static_cast<int*>(counts);
  int* tot = static_cast<int*>(totals);
  const size_t smem = bucket_smem(B, PASS_THREADS / 32, sub, R).bytes;
  if (smem > (size_t)MAX_SMEM || (size_t)B * 4 > (size_t)MAX_SMEM ||
      R < 1 || R >= SECTOR || B > 2 * 32768)
    return (int)cudaErrorInvalidValue;
  static SmemAllowance allow_count;
  cudaError_t err = allow_smem(allow_count, scatter_count_kernel, MAX_SMEM);
  if (err != cudaSuccess) return (int)err;
  scatter_count_kernel<<<tiles, PASS_THREADS, (size_t)B * 4, s>>>(
      in, cnt, N, M, shift, B, tile, tiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  scatter_scan_kernel<<<B, PASS_THREADS, 0, s>>>(cnt, tot, tiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  switch (R % 4 ? 0 : R / 4) {
#define BUCKET_CASE(RW)                                                      \
  case RW: {                                                                 \
    static SmemAllowance allowance;                                          \
    err = allow_smem(allowance, scatter_bucket_kernel<RW>, MAX_SMEM);        \
    if (err != cudaSuccess) return (int)err;                                 \
    scatter_bucket_kernel<RW><<<tiles, PASS_THREADS, smem, s>>>(             \
        in, static_cast<const unsigned char*>(upd),                          \
        static_cast<int*>(out_idx), static_cast<unsigned char*>(out_rows),   \
        cnt, tot, static_cast<int*>(offsets), M, shift, B, sub, tile,        \
        tiles, R);                                                           \
    return (int)cudaGetLastError();                                          \
  }
    BUCKET_CASE(0) BUCKET_CASE(1) BUCKET_CASE(2) BUCKET_CASE(3)
    BUCKET_CASE(4)
    BUCKET_CASE(5) BUCKET_CASE(6) BUCKET_CASE(7)
#undef BUCKET_CASE
  }
  return (int)cudaErrorInvalidValue;
}
