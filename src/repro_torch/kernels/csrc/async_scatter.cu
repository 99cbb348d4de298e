// async_scatter: table[idx[j]] op= upd[j] in place, op in {add, xor}, the
// update rows streamed through a K-deep ring of asynchronous copies and the
// read-modify-write done by the L2's atomic units.
//
// Replaces the TPU kernel `_scatter_kernel` / `async_scatter` of
// src/repro/kernels/async_scatter.py. There a grid step loads table rows K
// ahead into a VMEM ring (aload), modifies them in VMEM, stores them back with
// async copies that drain lazily (astore), and keeps the result right with a
// CAM-free software check (paper 5.1): at consume time it scans the last 2K-1
// indices for a store to the same row and, on a hit, drains stores up to the
// youngest conflicting one (an SMEM watermark makes each store waited once)
// and loads again. Conflicts between grid steps need nothing, because the TPU
// runs the grid in order.
//
// The hazard on Hopper: blocks run at the same time on 132 SMs, so a row
// updated by two blocks would race between one block's load and the other's
// store; the per-block scan cannot see across blocks. So the RMW leaves the
// SM: each update is a non-returning reduction at L2,
//
//   red.global.add.f32 / .add.s32 / .xor.b32 / .xor.b64, and for f32 rows of
//   8 or 16 bytes the vector atomicAdd(float2 / float4) of sm_90, whose
//   result is unused, so it too is issued and never waited on.
//
// A `red` is the AMI astore with no getfin: the L2's atomic unit orders
// conflicting updates to a row, so the disambiguation scan, the drain and the
// watermark have nothing left to do, and a table row never travels to the SM.
// What still travels is the update stream, and that goes through the ring:
// one block (CTA) per `block_m` updates, its indices staged in shared memory,
// rings of L lanes (as in async_gather.cu) holding K update rows each in
// flight as cp.async copies (one commit group per row, wait until K-1 are
// pending, consume, refill the slot with row j+K). The ragged tail of M is
// masked; an index outside [0, N) traps.
//
// Consequences: i32 add and xor are exact whatever the order; f32 add is
// exact per update but the order of the additions to one row is the order in
// which the L2 sees them, so a row hit more than once may differ from a
// sequential sum in its last bits (held to the reference tests' 1e-4).
// The kernel updates `table` in place (the counterpart of the reference's
// input_output_aliases={2: 0}); ops.scatter_update clones first.
//
// Bound on this card: bytes. Each touched table row is read and written once
// by the L2 (the RMW happens there), and each update row and index is read
// once. At HPCC's 8-byte rows each update still moves a 32-byte sector both
// ways, so the byte bound, which counts 8, cannot be reached within ~4x.

#include <type_traits>

#include "amu_ring.cuh"
#include "common.cuh"

namespace {

using namespace repro;

enum Op { OP_ADD = 0, OP_XOR = 1 };

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

// The astore of one W-byte chunk: dst op= the chunk in shared memory.
template <int W, int OP, typename E>
__device__ __forceinline__ void reduce_chunk(unsigned char* dst,
                                             const unsigned char* src) {
  if constexpr (OP == OP_XOR) {
    if constexpr (W >= 8) {
#pragma unroll
      for (int k = 0; k < W / 8; ++k)
        red_xor(reinterpret_cast<unsigned long long*>(dst) + k,
                reinterpret_cast<const unsigned long long*>(src)[k]);
    } else {
      red_xor(reinterpret_cast<uint32_t*>(dst),
              *reinterpret_cast<const uint32_t*>(src));
    }
  } else if constexpr (std::is_same_v<E, float> && W == 16) {
    (void)atomicAdd(reinterpret_cast<float4*>(dst),
                    *reinterpret_cast<const float4*>(src));
  } else if constexpr (std::is_same_v<E, float> && W == 8) {
    (void)atomicAdd(reinterpret_cast<float2*>(dst),
                    *reinterpret_cast<const float2*>(src));
  } else {
#pragma unroll
    for (int k = 0; k < W / 4; ++k)
      red_add(reinterpret_cast<E*>(dst) + k,
              reinterpret_cast<const E*>(src)[k]);
  }
}

template <int W, int OP, typename E>
__global__ void __launch_bounds__(128)
async_scatter_kernel(unsigned char* __restrict__ table,
                     const int* __restrict__ idx,
                     const unsigned char* __restrict__ upd, long long N,
                     long long M, int R, int block_m, int K, int L) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* idx_s = reinterpret_cast<int*>(smem);
  unsigned char* slots = smem + ((block_m * 4 + 15) & ~15);

  const long long base = (long long)blockIdx.x * block_m;
  const int rows = (int)min((long long)block_m, M - base);
  for (int t = threadIdx.x; t < rows; t += blockDim.x) idx_s[t] = idx[base + t];
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rpw = 32 / L;                        // rings a warp
  const int NR = (blockDim.x >> 5) * rpw;        // rings a block
  const int r = warp * rpw + lane / L;           // this lane's ring
  const int sub = lane % L;                      // its place in the ring
  const int nchunk = R / W;
  const int T = r < rows ? (rows - 1 - r) / NR + 1 : 0;   // rows of the ring
  if (T == 0) return;

  auto slot = [&](int t) {
    return slots + ((size_t)(t % K) * NR + r) * (size_t)R;
  };
  auto issue = [&](int t) {                      // aload of update row t
    if (t < T) {
      const unsigned char* src = upd + (base + r + (long long)t * NR) * R;
      unsigned char* dst = slot(t);
      for (int c = sub; c < nchunk; c += L)
        ring_copy<W>(dst + c * W, src + c * W);
    }
    ring_commit();
  };

  for (int t = 0; t < K; ++t) issue(t);          // prime: K rows in flight
  for (int t = 0; t < T; ++t) {
    ring_wait(K - 1);                            // getfin for update row t
    const int row = idx_s[r + t * NR];
    if ((unsigned long long)(long long)row >= (unsigned long long)N) __trap();
    unsigned char* dst = table + (long long)row * R;
    const unsigned char* s = slot(t);
    for (int c = sub; c < nchunk; c += L)
      reduce_chunk<W, OP, E>(dst + c * W, s + c * W);   // astore, no getfin
    issue(t + K);                                // reuse the freed slot
  }
}

template <int W, int OP, typename E>
cudaError_t launch(void* table, const void* idx, const void* upd, long long N,
                   long long M, int R, int block_m, int K, int L, int nwarps,
                   int smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      async_scatter_kernel<W, OP, E>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long grid = (M + block_m - 1) / block_m;
  async_scatter_kernel<W, OP, E><<<(unsigned)grid, nwarps * 32, smem, stream>>>(
      static_cast<unsigned char*>(table), static_cast<const int*>(idx),
      static_cast<const unsigned char*>(upd), N, M, R, block_m, K, L);
  return cudaGetLastError();
}

template <int OP, typename E>
cudaError_t launch_chunk(int chunk, void* table, const void* idx,
                         const void* upd, long long N, long long M, int R,
                         int block_m, int K, int L, int nwarps, int smem,
                         cudaStream_t s) {
#define SCATTER_CASE(W)                                                      \
  case W:                                                                    \
    return launch<W, OP, E>(table, idx, upd, N, M, R, block_m, K, L, nwarps, \
                            smem, s)
  switch (chunk) {
    SCATTER_CASE(16);
    SCATTER_CASE(8);
    SCATTER_CASE(4);
  }
#undef SCATTER_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// op: 0 add, 1 xor; dtype: enum DType (f32 add, i32 add, i32 xor). chunk,
// lanes, nwarps and smem are planned by the wrapper, as for async_gather
// (`ring_plan` in async_gather.py).
extern "C" int async_scatter_launch(void* table, const void* idx,
                                    const void* upd, long long N, long long M,
                                    int R, int block_m, int K, int chunk,
                                    int lanes, int nwarps, int smem, int op,
                                    int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (op == OP_ADD && dtype == DTYPE_F32)
    return (int)launch_chunk<OP_ADD, float>(chunk, table, idx, upd, N, M, R,
                                            block_m, K, lanes, nwarps, smem, s);
  if (op == OP_ADD && dtype == DTYPE_I32)
    return (int)launch_chunk<OP_ADD, int>(chunk, table, idx, upd, N, M, R,
                                          block_m, K, lanes, nwarps, smem, s);
  if (op == OP_XOR && dtype == DTYPE_I32)
    return (int)launch_chunk<OP_XOR, uint32_t>(chunk, table, idx, upd, N, M,
                                               R, block_m, K, lanes, nwarps,
                                               smem, s);
  return (int)cudaErrorInvalidValue;
}
