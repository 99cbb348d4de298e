// async_gather: out[i] = table[idx[i]], rows fetched through a K-deep ring of
// asynchronous copies.
//
// Replaces the TPU kernel `_gather_kernel` / `async_gather` of
// src/repro/kernels/async_gather.py. There one grid step takes `block_m`
// indices (scalar-prefetched to SMEM), primes K row DMAs into a VMEM slot
// ring, and for each row waits on its slot's semaphore, copies the slot to the
// output block and re-issues the slot for row j+K.
//
// Bound on this card: bytes. Nothing is computed; every row is read once and
// written once, at random rows of a table far larger than the 50 MB L2. What
// hides the latency of a random row is the number of rows in flight, the
// paper's memory-level parallelism, and that only counts on SMs that have
// work: the launch must cover the card. Two things would hold a direct
// transcription back at qwen2.5-3b's embedding shape (4000 ids of 4 KB
// rows): a block per `block_m` = 256 ids gives 16 blocks for 132 SMs, and a
// row that goes cp.async -> shared -> registers -> global costs one warp 256
// 16-byte instructions.
//
// Design:
//   - the block plan comes from M and the card (`gather_plan` in
//     async_gather.py): the most warps a block (4, 2, 1) and the fewest rows
//     a block (a multiple of its rings, at most block_m) with which the whole
//     launch is resident at once and the grid reaches min(SMs, M) blocks, so
//     that a ring carries as few rows as the card allows. 4000 ids of 4 KB
//     rows make 500 blocks of 8 rows, 2 a ring; 2^20 ids of 512-byte rows
//     keep 4096 blocks of 256. `block_m` is only an upper bound and the
//     result does not depend on it;
//   - a block stages its indices in shared memory (the scalar prefetch); its
//     lanes form rings of L lanes (L = the row's 16-byte chunks, at most 32,
//     a power of two): a warp per ring for rows of 512 bytes and more;
//   - the path is a fixed rule by row size and alignment, not a fallback:
//     * bulk (`async_gather_bulk_kernel`): rows that are a multiple of 16
//       bytes with the table and the output 16-byte aligned. The ring's first
//       lane drives it: aload = one cp.async.bulk of the whole row into slot
//       t % (K+1), completing on the slot's mbarrier armed with expect_tx(row
//       bytes); getfin = try_wait.parity on that mbarrier; the row leaves by a
//       shared -> global cp.async.bulk (bulk group), and a slot is refilled
//       only after wait_group.read says the store before it has read it. K
//       rows are in flight while one more slot drains, so K keeps its meaning
//       for the ring-depth sweep (a ring of fewer than K rows has a slot a
//       row). The row never passes through registers;
//     * cp.async (`async_gather_kernel`, csrc/amu_ring.cuh): every other row
//       (8- and 12-byte rows, rows or tables only 4- or 8-byte aligned):
//       chunks of the widest of 16/8/4 bytes that divides the row and the
//       pointers, one commit group a row, wait_group K-1 (getfin), then the
//       slot goes through registers to the output and is refilled with row
//       t+K;
//   - the ragged tail of M is masked, not padded; an index outside [0, N)
//     traps, as a device-side assert would.

#include "amu_ring.cuh"
#include "common.cuh"
#include "hopper.cuh"

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

// Shared memory of a bulk block: NR * NS mbarriers, the block's indices,
// then NR rings of NS slots of R bytes (slot-major), each region 16-byte
// aligned. gather_smem in async_gather.py computes the same size.
__global__ void __launch_bounds__(128)
async_gather_bulk_kernel(const unsigned char* __restrict__ table,
                         const int* __restrict__ idx,
                         unsigned char* __restrict__ out, long long N,
                         long long M, int R, int block_m, int K, int L) {
  using namespace hopper;
  extern __shared__ __align__(16) unsigned char smem[];
  const int NR = blockDim.x / L;                 // rings a block
  // slots a ring: K in flight and one draining, or one a row where a ring
  // has fewer than K rows
  const int NS = min(K, (block_m + NR - 1) / NR) + 1;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  int* idx_s = reinterpret_cast<int*>(smem + ((NR * NS * 8 + 15) & ~15));
  unsigned char* slots =
      reinterpret_cast<unsigned char*>(idx_s) + ((block_m * 4 + 15) & ~15);

  const long long base = (long long)blockIdx.x * block_m;
  const int rows = (int)min((long long)block_m, M - base);
  for (int t = threadIdx.x; t < rows; t += blockDim.x) idx_s[t] = idx[base + t];
  for (int i = threadIdx.x; i < NR * NS; i += blockDim.x) mbar_init(&bars[i], 1);
  fence_barrier_init();
  __syncthreads();
  if (threadIdx.x % L != 0) return;              // the ring's first lane drives it

  const int r = threadIdx.x / L;                 // this lane's ring
  const int T = r < rows ? (rows - 1 - r) / NR + 1 : 0;   // rows of the ring
  auto slot = [&](int t) {
    return slots + ((size_t)(t % NS) * NR + r) * (size_t)R;
  };
  auto bar = [&](int t) { return &bars[r * NS + t % NS]; };
  auto issue = [&](int t) {                      // aload of the ring's row t
    const int row = idx_s[r + t * NR];
    if ((unsigned long long)(long long)row >= (unsigned long long)N) __trap();
    mbar_arrive_expect_tx(bar(t), (uint32_t)R);
    bulk_load(slot(t), table + (long long)row * R, (uint32_t)R, bar(t));
  };

  for (int t = 0; t < min(K, T); ++t) issue(t);  // prime: K rows in flight
  for (int t = 0; t < T; ++t) {
    mbar_wait(bar(t), (uint32_t)((t / NS) & 1)); // getfin for row t
    fence_proxy_async();
    bulk_store(out + (base + r + (long long)t * NR) * R, slot(t), (uint32_t)R);
    bulk_commit();
    if (t + K < T) {
      // row t+K goes to the slot of row t-1, whose store must have read it
      bulk_wait_read<1>();
      issue(t + K);
    }
  }
  bulk_wait_read<0>();           // the slots stay until every store read them
}

template <typename Kernel>
cudaError_t launch_kernel(Kernel kernel, hopper::SmemAllowance& allowance,
                          const void* table, const void* idx, void* out,
                          long long N, long long M, int R, int block_m, int K,
                          int L, int nwarps, int smem, cudaStream_t stream) {
  cudaError_t err = hopper::allow_smem(allowance, kernel, MAX_SMEM);
  if (err != cudaSuccess) return err;
  const long long grid = (M + block_m - 1) / block_m;
  kernel<<<(unsigned)grid, nwarps * 32, smem, stream>>>(
      static_cast<const unsigned char*>(table), static_cast<const int*>(idx),
      static_cast<unsigned char*>(out), N, M, R, block_m, K, L);
  return cudaGetLastError();
}

// The allowance of each kernel, set once per device.
hopper::SmemAllowance allow_bulk, allow_w16, allow_w8, allow_w4;

template <typename Kernel>
cudaError_t occupancy(Kernel kernel, hopper::SmemAllowance& allowance,
                      int nwarps, int smem, int* blocks) {
  cudaError_t err = hopper::allow_smem(allowance, kernel, MAX_SMEM);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                       nwarps * 32, smem);
}

}  // namespace

// bulk: 1 for the bulk-copy ring (then chunk is 16), 0 for cp.async chunks of
// `chunk` bytes (16, 8 or 4, dividing R); block_m: rows a block; lanes: L;
// nwarps: warps a block; smem: the block's shared memory. The wrapper plans
// them all (`gather_plan` in async_gather.py).
extern "C" int async_gather_launch(const void* table, const void* idx,
                                   void* out, long long N, long long M, int R,
                                   int block_m, int K, int bulk, int chunk,
                                   int lanes, int nwarps, int smem,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bulk)
    return (int)launch_kernel(async_gather_bulk_kernel, allow_bulk, table,
                              idx, out, N, M, R, block_m, K, lanes, nwarps,
                              smem, s);
  switch (chunk) {
    case 16:
      return (int)launch_kernel(async_gather_kernel<16>, allow_w16, table,
                                idx, out, N, M, R, block_m, K, lanes, nwarps,
                                smem, s);
    case 8:
      return (int)launch_kernel(async_gather_kernel<8>, allow_w8, table, idx,
                                out, N, M, R, block_m, K, lanes, nwarps, smem,
                                s);
    case 4:
      return (int)launch_kernel(async_gather_kernel<4>, allow_w4, table, idx,
                                out, N, M, R, block_m, K, lanes, nwarps, smem,
                                s);
  }
  return (int)cudaErrorInvalidValue;
}

// Blocks of the kernel one SM holds at once for this plan.
extern "C" int async_gather_blocks_per_sm(int bulk, int chunk, int nwarps,
                                          int smem, int* blocks) {
  if (bulk)
    return (int)occupancy(async_gather_bulk_kernel, allow_bulk, nwarps, smem,
                          blocks);
  switch (chunk) {
    case 16:
      return (int)occupancy(async_gather_kernel<16>, allow_w16, nwarps, smem,
                            blocks);
    case 8:
      return (int)occupancy(async_gather_kernel<8>, allow_w8, nwarps, smem,
                            blocks);
    case 4:
      return (int)occupancy(async_gather_kernel<4>, allow_w4, nwarps, smem,
                            blocks);
  }
  return (int)cudaErrorInvalidValue;
}

