// async_scatter: table[idx[j]] op= upd[j] in place, op in {add, xor}: the
// update stream through a ring of bulk copies, the read-modify-write done by
// the L2's atomic units, and the updates of rows narrower than a 32-byte
// sector bucketed by table region first.
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
// L2 (red.global.add.f32 / .add.s32 / .xor.b32 / .xor.b64, and for f32 rows of
// 8 or 16 bytes the vector atomicAdd(float2 / float4) of sm_90 with its result
// unused). The L2's atomic unit orders conflicting updates to a row, so the
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
//   - rows of 32 bytes and more: a persistent grid (two blocks an SM), a
//     span at a time through the K-slot ring;
//   - the bucketed stream: one slot, a block a span of at most 64 updates
//     and a block for every span, so that the hardware hands the blocks out
//     in the stream's order and the updates in flight on the card (blocks
//     an SM x 64) lie in one table region at a time. Here the grid is the
//     ring. A narrower window read faster (blocks of 256, 128, 64 updates);
//     a block's updates split over slots, a ticket (its round trip queues
//     behind the reductions at L2) and a persistent grid-stride grid (its
//     blocks drift apart in the stream) all read slower (PERF.md).
//
// The bucket pass (rows narrower than 32 bytes; a fixed rule,
// `async_scatter_bucketed` below and `scatter_plan`): a stable counting sort
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
// Consequences: i32 add and xor are exact whatever the order; f32 add is
// exact per update but the additions to one row land in the order the L2
// sees them, so a row hit more than once may differ from a sequential sum in
// its last bits (held to the reference tests' 1e-4, SCATTER_TOL). The kernel
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
  } else {
    static_assert(W == 4, "int32 add reduces 4 bytes at once");
    red_add(reinterpret_cast<E*>(dst), *reinterpret_cast<const E*>(src));
  }
}

__device__ __forceinline__ void check_row(int row, long long N) {
  if ((unsigned long long)(long long)row >= (unsigned long long)N) __trap();
}

// ------------------------------------------------------------ apply kernel
// A block's shared memory: K full and K empty mbarriers, the span each slot
// holds, then K slots of [span indices | span update rows]. span is a
// multiple of 4 and R of 4, so every part starts on 16 bytes. The launch
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
  const long long M4 = M & ~3LL;       // the rest is too short for a bulk copy
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
  const int c = threadIdx.x - 32;
  const int G = consumers * 32 / L, g = c / L, sub = c % L;
  const int nchunk = R / W;
  if (blockIdx.x == 0) {               // the last M mod 4 updates, from global
    for (long long j = M4 + g; j < M; j += G) {
      const int row = idx[j];
      check_row(row, N);
      for (int k = sub; k < nchunk; k += L)
        reduce_chunk<W, OP, E>(table + (long long)row * R + k * W,
                               upd + j * R + k * W);
    }
  }
  for (int t = 0;; ++t) {
    const int s = t % K;
    mbar_wait(&full[s], (uint32_t)((t / K) & 1));  // getfin
    const int sp = which[s];
    if (sp < 0) return;
    const int n = (int)min((long long)span, M4 - (long long)sp * span);
    const unsigned char* slot = slots + (size_t)s * lay.slot;
    const int* sidx = reinterpret_cast<const int*>(slot);
    const unsigned char* rows = slot + lay.rows;
    for (int u = g; u < n; u += G) {
      const int row = sidx[u];
      check_row(row, N);
      unsigned char* dst = table + (long long)row * R;
      for (int k = sub; k < nchunk; k += L)
        reduce_chunk<W, OP, E>(dst + k * W, rows + (size_t)u * R + k * W);
    }
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
// as the widest of 16-, 8- and 4-byte words that divides it (V).
template <int RW>
__global__ void __launch_bounds__(PASS_THREADS)
scatter_bucket_kernel(const int* __restrict__ idx,
                      const unsigned char* __restrict__ upd,
                      int* __restrict__ out_idx,
                      unsigned char* __restrict__ out_rows,
                      const int* __restrict__ counts,
                      const int* __restrict__ totals,
                      int* __restrict__ offsets, long long M, int shift,
                      int B, int sub, int tile, int tiles) {
  constexpr int R = RW * 4;
  using V = typename Chunk<RW % 4 == 0 ? 16 : RW % 2 == 0 ? 8 : 4>::type;
  constexpr int VW = R / (int)sizeof(V);             // words of V a row
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
    const uint32_t n4 = (uint32_t)min((long long)sub, tile_end - first) & ~3u;
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
    for (int i = (n & ~3) + threadIdx.x; i < n; i += blockDim.x) {
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
// bytes (atomicAdd of float4, float2, red.add.f32), i32 add 4, i32 xor 8 or
// 4. A wider chunk of xor or int add would be several reductions a lane at a
// stride, meeting each sector more than once.
template <template <int, int, typename> class F, typename... A>
cudaError_t dispatch(int op, int dtype, int chunk, A... args) {
  if (op == OP_ADD && dtype == DTYPE_F32) {
    switch (chunk) {
      case 16: return F<16, OP_ADD, float>::run(args...);
      case 8: return F<8, OP_ADD, float>::run(args...);
      case 4: return F<4, OP_ADD, float>::run(args...);
    }
  }
  if (op == OP_ADD && dtype == DTYPE_I32 && chunk == 4)
    return F<4, OP_ADD, int>::run(args...);
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

// The fixed rule of the path: 1 where rows of R bytes are bucketed by table
// region before the apply (narrower than a 32-byte sector), else 0.
extern "C" int async_scatter_bucketed(int R) { return R < SECTOR ? 1 : 0; }

// Shared-memory bytes of an apply block: K slots of `span` updates of R bytes.
extern "C" long long async_scatter_apply_smem(int span, int K, int R) {
  return (long long)apply_smem(span, K, R).bytes;
}

// The apply: every update of idx / upd (the caller's, or the bucketed
// stream's) reduced into the table. chunk: bytes a reduction (16, 8 or 4,
// dividing R and the table's alignment); span: updates a slot (a multiple of
// 4); K: slots a block; lanes: L, lanes that share a row; blocks: the grid,
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
      R % 4 || R < 4 || R >= SECTOR || B > 2 * 32768)
    return (int)cudaErrorInvalidValue;
  static SmemAllowance allow_count;
  cudaError_t err = allow_smem(allow_count, scatter_count_kernel, MAX_SMEM);
  if (err != cudaSuccess) return (int)err;
  scatter_count_kernel<<<tiles, PASS_THREADS, (size_t)B * 4, s>>>(
      in, cnt, N, M, shift, B, tile, tiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  scatter_scan_kernel<<<B, PASS_THREADS, 0, s>>>(cnt, tot, tiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  switch (R / 4) {
#define BUCKET_CASE(RW)                                                      \
  case RW: {                                                                 \
    static SmemAllowance allowance;                                          \
    err = allow_smem(allowance, scatter_bucket_kernel<RW>, MAX_SMEM);        \
    if (err != cudaSuccess) return (int)err;                                 \
    scatter_bucket_kernel<RW><<<tiles, PASS_THREADS, smem, s>>>(             \
        in, static_cast<const unsigned char*>(upd),                          \
        static_cast<int*>(out_idx), static_cast<unsigned char*>(out_rows),   \
        cnt, tot, static_cast<int*>(offsets), M, shift, B, sub, tile,        \
        tiles);                                                              \
    return (int)cudaGetLastError();                                          \
  }
    BUCKET_CASE(1) BUCKET_CASE(2) BUCKET_CASE(3) BUCKET_CASE(4)
    BUCKET_CASE(5) BUCKET_CASE(6) BUCKET_CASE(7)
#undef BUCKET_CASE
  }
  return (int)cudaErrorInvalidValue;
}
