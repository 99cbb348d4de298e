// stream_triad: STREAM's triad a = b + s * c, streamed in blocks through a
// ring of asynchronous copies.
//
// Replaces the TPU kernel `_triad_kernel` / `stream_triad` of
// src/repro/kernels/stream_triad.py. There each grid step's `block` elements
// of b and c arrive in VMEM by DMAs the Pallas pipeline issues one step ahead
// (double buffering), and the block is the paper's aload granularity. Here:
//
//   - a persistent grid (as many blocks (CTAs) as the SMs hold at once) walks
//     the arrays in `block`-element steps, grid-stride, so neighbouring CTAs
//     stream neighbouring bytes;
//   - each CTA keeps `stages` steps in flight: a step is the cp.async copies
//     (16 bytes each, bypassing L1) of its b and c into one shared-memory
//     slot, one commit group; the CTA primes `stages` steps, then for each
//     waits until stages-1 groups are pending (getfin), computes from the slot
//     and stores 16 bytes a thread, and refills the slot with the step
//     `stages` ahead. `block` and `stages` are launch parameters;
//   - the arithmetic is fp32, b + s * c with s rounded to the arrays' type
//     first (as the reference does) and the product and sum rounded
//     separately (no FMA contraction), so the result equals the plain
//     version's bit for bit; bf16 is rounded once, at the end;
//   - the ragged tail is masked: steps past N copy nothing, and the last
//     N mod 8 (or 4) elements, too few for a 16-byte copy, are done by the
//     last CTA with scalar loads.
//
// Bound on this card: bytes (12 bytes a float32 element, 2 operations).
// At 3.35 TB/s the ~20 KB per SM of bytes in flight that the latency asks
// for is what the ring supplies: with block = 512 fp32 and 4 stages a CTA has
// 12 KB in flight and an SM holds several CTAs.

#include <algorithm>

#include "amu_ring.cuh"
#include "common.cuh"

namespace {

using namespace repro;

template <typename E>
__global__ void __launch_bounds__(256)
stream_triad_kernel(const E* __restrict__ b, const E* __restrict__ c,
                    E* __restrict__ a, long long N, float s, int block,
                    int stages) {
  constexpr int VEC = 16 / sizeof(E);              // elements a chunk
  extern __shared__ __align__(16) unsigned char smem[];
  const int CB = block / VEC;                      // chunks a step
  const long long NC = N / VEC;                    // whole chunks
  const long long nsteps = (NC + CB - 1) / CB;
  const long long G = gridDim.x;
  const int T = blockIdx.x < nsteps
                    ? (int)((nsteps - 1 - blockIdx.x) / G + 1) : 0;

  auto slot = [&](int t) {
    return smem + (size_t)(t % stages) * 2 * CB * 16;
  };
  auto issue = [&](int t) {                        // aload of step t
    if (t < T) {
      const long long c0 = (blockIdx.x + t * G) * (long long)CB;
      unsigned char* dst = slot(t);
      for (int k = threadIdx.x; k < CB && c0 + k < NC; k += blockDim.x) {
        ring_copy<16>(dst + k * 16, b + (c0 + k) * VEC);
        ring_copy<16>(dst + (CB + k) * 16, c + (c0 + k) * VEC);
      }
    }
    ring_commit();
  };

  using Pack = Vec<E, VEC>;                         // 16 bytes
  if (T > 0) {
    for (int t = 0; t < stages; ++t) issue(t);     // prime
    for (int t = 0; t < T; ++t) {
      ring_wait(stages - 1);                       // getfin for step t
      const long long c0 = (blockIdx.x + t * G) * (long long)CB;
      const unsigned char* src = slot(t);
      for (int k = threadIdx.x; k < CB && c0 + k < NC; k += blockDim.x) {
        const Pack vb = *reinterpret_cast<const Pack*>(src + k * 16);
        const Pack vc = *reinterpret_cast<const Pack*>(src + (CB + k) * 16);
        Pack va;
#pragma unroll
        for (int i = 0; i < VEC; ++i)
          va.v[i] = from_float<E>(
              __fadd_rn(to_float(vb.v[i]), __fmul_rn(s, to_float(vc.v[i]))));
        *reinterpret_cast<Pack*>(a + (c0 + k) * VEC) = va;
      }
      issue(t + stages);                           // reuse the freed slot
    }
  }
  if (blockIdx.x == gridDim.x - 1) {               // the sub-chunk tail
    for (long long e = NC * VEC + threadIdx.x; e < N; e += blockDim.x)
      a[e] = from_float<E>(
          __fadd_rn(to_float(b[e]), __fmul_rn(s, to_float(c[e]))));
  }
}

template <typename E>
cudaError_t launch(const void* b, const void* c, void* a, long long N,
                   float s, int block, int stages, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(E);
  const int CB = block / VEC;
  const int threads = std::min(256, std::max(32, (CB + 31) / 32 * 32));
  const size_t smem = (size_t)stages * 2 * CB * 16;
  cudaError_t err = cudaFuncSetAttribute(
      stream_triad_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, stream_triad_kernel<E>, threads, smem);
  if (err != cudaSuccess) return err;
  const long long nsteps = (N / VEC + CB - 1) / CB;
  const long long grid =
      std::max(1LL, std::min(nsteps, (long long)sms * std::max(per_sm, 1)));
  stream_triad_kernel<E><<<(unsigned)grid, threads, smem, stream>>>(
      static_cast<const E*>(b), static_cast<const E*>(c), static_cast<E*>(a),
      N, s, block, stages);
  return cudaGetLastError();
}

}  // namespace

// s is already rounded to the arrays' type; block is a multiple of 128.
extern "C" int stream_triad_launch(const void* b, const void* c, void* a,
                                   long long N, float s, int block,
                                   int stages, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_F32)
    return (int)launch<float>(b, c, a, N, s, block, stages, st);
  if (dtype == DTYPE_BF16)
    return (int)launch<__nv_bfloat16>(b, c, a, N, s, block, stages, st);
  return (int)cudaErrorInvalidValue;
}
