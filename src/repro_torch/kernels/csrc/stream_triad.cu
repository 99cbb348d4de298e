// stream_triad: STREAM's triad a = b + s * c, streamed in steps through a
// ring of bulk copies.
//
// Replaces the TPU kernel `_triad_kernel` / `stream_triad` of
// src/repro/kernels/stream_triad.py. There each grid step's `block` elements
// of b and c arrive in VMEM by DMAs the Pallas pipeline issues one step ahead
// (double buffering), and the block is the paper's aload granularity. Here:
//
//   - a persistent grid walks the arrays in `block`-element steps,
//     grid-stride, so neighbouring blocks (CTAs) stream neighbouring bytes;
//   - aload = one elected thread arms slot t % stages's mbarrier with
//     expect_tx(bytes of b and c) and issues one cp.async.bulk of the step
//     of b and one of c into the slot; `stages` steps are in flight a CTA.
//     getfin = every thread waits try_wait.parity on the slot's mbarrier,
//     then computes 16 bytes at a time from the slot into one of two output
//     slots; astore = the elected thread sends the output slot to a by one
//     shared -> global cp.async.bulk (a bulk group). The input slot is
//     refilled with step t + stages as soon as every thread is past it; an
//     output slot is written again only after wait_group.read says the store
//     two steps back has read it. No thread issues a copy of its own, and a
//     byte passes through registers once, for the arithmetic;
//   - the grid is planned from the card (`triad_plan` in stream_triad.py):
//     CTAs an SM such that the loads in flight an SM are ~latency x
//     bandwidth (24 KB, at least two CTAs) and not ten times that, cached with the kernel's
//     shared-memory allowance, which is set once per device;
//   - the arithmetic is fp32, b + s * c with s rounded to the arrays' type
//     first (as the reference does) and the product and sum rounded
//     separately (no FMA contraction), so the result equals the plain
//     version's bit for bit; bf16 and f16 are rounded once, at the end;
//   - the ragged tail is masked: the last step moves only its whole 16-byte
//     chunks, and the last N mod 4 (f32) or N mod 8 (bf16, f16) elements,
//     too few for a bulk copy, are done by the last CTA with scalar loads.
//
// Bound on this card: bytes (12 bytes a float32 element, 2 operations).

#include "amu_ring.cuh"
#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace repro;
using namespace repro::hopper;

template <typename E>
__device__ __forceinline__ E triad(E b, E c, float s) {
  return from_float<E>(__fadd_rn(to_float(b), __fmul_rn(s, to_float(c))));
}

// A block's shared memory: an mbarrier a stage, then from `in` on the
// `stages` input slots (a step of b, then of c) and the two output slots.
// The kernel carves it and the launch sizes it from this one function.
struct TriadSmem {
  size_t in, outs, bytes;
};

template <typename E>
__host__ __device__ TriadSmem triad_smem(int block, int stages) {
  const size_t step = (size_t)block * sizeof(E);
  TriadSmem m;
  m.in = ((size_t)stages * 8 + 15) & ~(size_t)15;
  m.outs = m.in + (size_t)stages * 2 * step;
  m.bytes = m.outs + 2 * step;
  return m;
}

template <typename E>
__global__ void __launch_bounds__(256)
stream_triad_kernel(const E* __restrict__ b, const E* __restrict__ c,
                    E* __restrict__ a, long long N, float s, int block,
                    int stages) {
  constexpr int VEC = 16 / sizeof(E);              // elements a chunk
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t step_bytes = (size_t)block * sizeof(E);
  const TriadSmem L = triad_smem<E>(block, stages);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  unsigned char* in = smem + L.in;                 // (b, c) a slot
  unsigned char* outs = smem + L.outs;             // 2 slots
  const int CB = block / VEC;                      // chunks a step
  const long long NC = N / VEC;                    // whole chunks
  const long long nsteps = (NC + CB - 1) / CB;
  const long long G = gridDim.x;
  const int T = blockIdx.x < nsteps
                    ? (int)((nsteps - 1 - blockIdx.x) / G + 1) : 0;
  const bool elected = threadIdx.x == 0;

  for (int i = threadIdx.x; i < stages; i += blockDim.x)
    mbar_init(&full[i], 1);
  fence_barrier_init();
  __syncthreads();

  auto first_chunk = [&](int t) {
    return (blockIdx.x + t * G) * (long long)CB;
  };
  auto issue = [&](int t) {                        // aload of step t
    if (t >= T) return;
    const long long c0 = first_chunk(t);
    const uint32_t bytes = (uint32_t)min((long long)CB, NC - c0) * 16;
    uint64_t* bar = &full[t % stages];
    unsigned char* dst = in + (size_t)(t % stages) * 2 * step_bytes;
    mbar_arrive_expect_tx(bar, 2 * bytes);
    bulk_load(dst, b + c0 * VEC, bytes, bar);
    bulk_load(dst + step_bytes, c + c0 * VEC, bytes, bar);
  };

  using Pack = Vec<E, VEC>;                        // 16 bytes
  if (elected)
    for (int t = 0; t < stages; ++t) issue(t);     // prime
  for (int t = 0; t < T; ++t) {
    const long long c0 = first_chunk(t);
    const int nc = (int)min((long long)CB, NC - c0);
    const unsigned char* src = in + (size_t)(t % stages) * 2 * step_bytes;
    unsigned char* dst = outs + (size_t)(t & 1) * step_bytes;
    mbar_wait(&full[t % stages], (uint32_t)((t / stages) & 1));  // getfin
    for (int k = threadIdx.x; k < nc; k += blockDim.x) {
      const Pack vb = *reinterpret_cast<const Pack*>(src + k * 16);
      const Pack vc = *reinterpret_cast<const Pack*>(src + step_bytes + k * 16);
      Pack va;
#pragma unroll
      for (int i = 0; i < VEC; ++i) va.v[i] = triad(vb.v[i], vc.v[i], s);
      *reinterpret_cast<Pack*>(dst + k * 16) = va;
    }
    fence_proxy_async();               // the writes above, before the store
    __syncthreads();                   // every thread is past both slots
    if (elected) {
      bulk_store(a + c0 * VEC, dst, (uint32_t)nc * 16);   // astore
      bulk_commit();
      issue(t + stages);               // refill the input slot
      bulk_wait_read<1>();             // step t-1's store has read its slot
    }
    __syncthreads();
  }
  if (elected) bulk_wait_read<0>();    // the slots stay until read
  if (blockIdx.x == gridDim.x - 1) {   // the sub-chunk tail
    for (long long e = NC * VEC + threadIdx.x; e < N; e += blockDim.x)
      a[e] = triad(b[e], c[e], s);
  }
}

template <typename E>
cudaError_t launch(const void* b, const void* c, void* a, long long N,
                   float s, int block, int stages, int grid, int threads,
                   cudaStream_t stream) {
  const size_t smem = triad_smem<E>(block, stages).bytes;
  if (smem > (size_t)MAX_SMEM) return cudaErrorInvalidValue;
  static SmemAllowance allowance;
  cudaError_t err = allow_smem(allowance, stream_triad_kernel<E>, MAX_SMEM);
  if (err != cudaSuccess) return err;
  stream_triad_kernel<E><<<grid, threads, smem, stream>>>(
      static_cast<const E*>(b), static_cast<const E*>(c), static_cast<E*>(a),
      N, s, block, stages);
  return cudaGetLastError();
}

}  // namespace

// s is already rounded to the arrays' type; block is a multiple of 128;
// b, c and a start on 16-byte boundaries. grid, threads: `triad_plan` of
// stream_triad.py; the launch sizes the shared memory itself
// (`stream_triad_smem`) and refuses a ring that does not fit.
extern "C" int stream_triad_launch(const void* b, const void* c, void* a,
                                   long long N, float s, int block,
                                   int stages, int grid, int threads,
                                   int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_F32)
    return (int)launch<float>(b, c, a, N, s, block, stages, grid, threads,
                              st);
  if (dtype == DTYPE_BF16)
    return (int)launch<__nv_bfloat16>(b, c, a, N, s, block, stages, grid,
                                      threads, st);
  if (dtype == DTYPE_F16)
    return (int)launch<__half>(b, c, a, N, s, block, stages, grid, threads,
                               st);
  return (int)cudaErrorInvalidValue;
}

// Shared-memory bytes a block of the launch takes; -1 for a type it does not
// take.
extern "C" long long stream_triad_smem(int block, int stages, int dtype) {
  if (dtype == DTYPE_F32)
    return (long long)triad_smem<float>(block, stages).bytes;
  if (dtype == DTYPE_BF16)
    return (long long)triad_smem<__nv_bfloat16>(block, stages).bytes;
  if (dtype == DTYPE_F16)
    return (long long)triad_smem<__half>(block, stages).bytes;
  return -1;
}
