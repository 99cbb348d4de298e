// async_gather: out[i] = table[idx[i]], rows fetched through a K-deep ring of
// asynchronous copies.
//
// Replaces the TPU kernel `_gather_kernel` / `async_gather` of
// src/repro/kernels/async_gather.py. There one grid step takes `block_m`
// indices (scalar-prefetched to SMEM), primes K row DMAs into a VMEM slot
// ring, and for each row waits on its slot's semaphore, copies the slot to the
// output block and re-issues the slot for row j+K. Here:
//
//   - one block (CTA) per `block_m` indices; the block first stages its
//     indices in shared memory (the scalar prefetch);
//   - the block's lanes form rings of L lanes (L = the chunks of a row, at
//     most 32, rounded down to a power of two): 512-byte rows take a whole
//     warp per ring, HPCC's 8-byte rows one lane per ring, so a warp runs
//     32/L rings side by side. Ring r takes rows r, r+NR, r+2NR, ... of the
//     block (NR rings a block);
//   - each ring owns K row slots in shared memory (slot-major, so the lanes
//     of a warp touch neighbouring bytes: no bank conflicts at any L). A row
//     is requested as cp.async copies of the widest chunk that divides the
//     row (16, 8 or 4 bytes), one commit group per row; the ring primes K
//     rows, then for each row waits until K-1 groups are pending (getfin),
//     copies the slot to the output row and refills the slot with row j+K;
//   - the ragged tail of M is masked, not padded; an index outside [0, N)
//     traps, as a device-side assert would.
//
// Bound on this card: bytes. Nothing is computed; every row is read once and
// written once, at random rows of a table far larger than the 50 MB L2. What
// hides the latency of a random row is the number of rows in flight, the
// paper's memory-level parallelism: K x (rings per SM). With 4 warps a block,
// 512-byte rows (one ring a warp) and K = 8, a block holds 17 KB of slots and
// indices and an SM 12 blocks (shared memory is the limit), so 12 x 4 x 8 =
// 384 rows, 192 KB, are in flight per SM, against the ~20 KB per SM that
// 3.35 TB/s times ~0.8 us of latency asks for. At 8-byte rows the same
// block runs 128 rings. `rows_in_flight_per_sm` in async_gather.py computes
// the figure for any row size and K from the occupancy the runtime reports,
// and chip_smoke.py prints it beside each depth of its sweep: where the grid
// fills every SM with a dozen blocks, K = 1 (48 rows an SM) already moves
// bytes at the rate K = 8 does, and depth only pays where blocks are few.

#include "amu_ring.cuh"
#include "common.cuh"

namespace {

using namespace repro;

template <int W>
__global__ void __launch_bounds__(128)
async_gather_kernel(const unsigned char* __restrict__ table,
                    const int* __restrict__ idx, unsigned char* __restrict__ out,
                    long long N, long long M, int R, int block_m, int K,
                    int L) {
  using C = typename Chunk<W>::type;
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
  auto issue = [&](int t) {                      // aload of the ring's row t
    if (t < T) {
      const int row = idx_s[r + t * NR];
      if ((unsigned long long)(long long)row >= (unsigned long long)N) __trap();
      const unsigned char* src = table + (long long)row * R;
      unsigned char* dst = slot(t);
      for (int c = sub; c < nchunk; c += L)
        ring_copy<W>(dst + c * W, src + c * W);
    }
    ring_commit();
  };

  for (int t = 0; t < K; ++t) issue(t);          // prime: K rows in flight
  for (int t = 0; t < T; ++t) {
    ring_wait(K - 1);                            // getfin for row t
    const unsigned char* s = slot(t);
    unsigned char* o = out + (base + r + (long long)t * NR) * R;
    for (int c = sub; c < nchunk; c += L)
      *reinterpret_cast<C*>(o + c * W) = *reinterpret_cast<const C*>(s + c * W);
    issue(t + K);                                // reuse the freed slot
  }
}

template <int W>
cudaError_t launch(const void* table, const void* idx, void* out, long long N,
                   long long M, int R, int block_m, int K, int L, int nwarps,
                   int smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      async_gather_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const long long grid = (M + block_m - 1) / block_m;
  async_gather_kernel<W><<<(unsigned)grid, nwarps * 32, smem, stream>>>(
      static_cast<const unsigned char*>(table), static_cast<const int*>(idx),
      static_cast<unsigned char*>(out), N, M, R, block_m, K, L);
  return cudaGetLastError();
}

template <int W>
cudaError_t occupancy(int nwarps, int smem, int* blocks) {
  cudaError_t err = cudaFuncSetAttribute(
      async_gather_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, async_gather_kernel<W>, nwarps * 32, smem);
}

}  // namespace

// chunk: bytes a cp.async moves (16, 8 or 4, dividing R); lanes: L;
// nwarps: warps a block; smem: the block's shared memory, its indices
// (rounded up to 16 bytes) then nwarps * 32 / L rings of K slots of R bytes.
// The wrapper plans all four (`ring_plan` in async_gather.py).
extern "C" int async_gather_launch(const void* table, const void* idx,
                                   void* out, long long N, long long M, int R,
                                   int block_m, int K, int chunk, int lanes,
                                   int nwarps, int smem, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GATHER_CASE(W)                                                  \
  case W:                                                               \
    return (int)launch<W>(table, idx, out, N, M, R, block_m, K, lanes, \
                          nwarps, smem, s)
  switch (chunk) {
    GATHER_CASE(16);
    GATHER_CASE(8);
    GATHER_CASE(4);
  }
#undef GATHER_CASE
  return (int)cudaErrorInvalidValue;
}

// Blocks of the kernel one SM holds at once for this plan.
extern "C" int async_gather_blocks_per_sm(int chunk, int nwarps, int smem,
                                          int* blocks) {
  switch (chunk) {
    case 16: return (int)occupancy<16>(nwarps, smem, blocks);
    case 8: return (int)occupancy<8>(nwarps, smem, blocks);
    case 4: return (int)occupancy<4>(nwarps, smem, blocks);
  }
  return (int)cudaErrorInvalidValue;
}
