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
//   - the arithmetic rounds where the reference's does (on its CPU
//     backend, interpret mode), so the result equals the plain version's,
//     and the reference's, bit for bit: s is made the arrays' type first
//     (a float type's by the wrapper; an integer type's here, from fp32 by
//     `to_int`: toward zero, saturated, NaN -> 0, as the reference's jit
//     converts its traced scalar); floats are widened to fp32, where the
//     product of two
//     8- or 16-bit values is exact; bf16 and fp8 (e4m3fn, e5m2) round s * c
//     to their type and then round the sum again, f16 rounds once, at the
//     end, and f32 rounds the product and the sum (no FMA contraction: the
//     reference contracts on its CPU, within 1e-6); fp8 rounds without
//     saturation (`to_fp8`: e4m3fn overflows to NaN, e5m2 to inf).
//     Integers (8, 16 and 32 bits, signed or not) wrap, as two's
//     complement in 32-bit unsigned arithmetic cut to the type;
//     bf16 runs on pairs: mul.rn.bf16x2 then add.rn.bf16x2, each
//     correctly rounded, which are those two roundings (`__hmul2_rn`,
//     `__hadd2_rn`: the compiler may not fuse them into one fma, which
//     would round once);
//   - 16 bytes are 4 f32 / int32, 8 bf16 / f16 / int16, 16 int8 or fp8
//     elements. The ragged tail is masked: the last step moves only its
//     whole 16-byte chunks, and the last N mod (16 / item) elements, too
//     few for a bulk copy, are done by the last CTA with scalar loads.
//
// Bound on this card: bytes (12 bytes a float32 element, 2 operations).

#include <type_traits>

#include "amu_ring.cuh"
#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace repro;
using namespace repro::hopper;

// The reference rounds s * c to bf16 and to fp8 before the add; f16 and
// f32 keep it in fp32 (where it is exact for f16).
template <typename E>
constexpr bool kRoundProduct =
    std::is_same_v<E, __nv_bfloat16> || is_fp8<E>;

// s: the arrays' type as a float (floats) or the type itself (integers)
template <typename E>
using Scalar = std::conditional_t<std::is_integral_v<E>, E, float>;

template <typename E>
__device__ __forceinline__ E triad(E b, E c, Scalar<E> s) {
  if constexpr (std::is_integral_v<E>) {
    return (E)((uint32_t)b + (uint32_t)s * (uint32_t)c);
  } else {
    float sc = __fmul_rn(s, to_float(c));
    if constexpr (kRoundProduct<E>) sc = to_float(from_float<E>(sc));
    return from_float<E>(__fadd_rn(to_float(b), sc));
  }
}

// A 16-byte chunk: bf16 as pairs (the product rounded, then the sum, as
// triad() rounds them one element at a time), other types by element.
template <typename E, int N>
__device__ __forceinline__ void triad_chunk(const Vec<E, N>& b,
                                            const Vec<E, N>& c, Vec<E, N>& a,
                                            Scalar<E> s) {
  if constexpr (std::is_same_v<E, __nv_bfloat16>) {
    const __nv_bfloat162 s2 = __float2bfloat162_rn(s);   // exact: s is bf16
    const auto* b2 = reinterpret_cast<const __nv_bfloat162*>(b.v);
    const auto* c2 = reinterpret_cast<const __nv_bfloat162*>(c.v);
    auto* a2 = reinterpret_cast<__nv_bfloat162*>(a.v);
#pragma unroll
    for (int i = 0; i < N / 2; ++i)   // _rn: never contracted to one fma
      a2[i] = __hadd2_rn(b2[i], __hmul2_rn(s2, c2[i]));
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) a.v[i] = triad(b.v[i], c.v[i], s);
  }
}

// A block's shared memory: an mbarrier a stage, then from `in` on the
// `stages` input slots (a step of b, then of c) and the two output slots.
// The kernel carves it and the launch sizes it from this one function.
struct TriadSmem {
  size_t in, outs, bytes;
};

__host__ __device__ inline TriadSmem triad_smem(int block, int stages,
                                                int item) {
  const size_t step = (size_t)block * item;
  TriadSmem m;
  m.in = ((size_t)stages * 8 + 15) & ~(size_t)15;
  m.outs = m.in + (size_t)stages * 2 * step;
  m.bytes = m.outs + 2 * step;
  return m;
}

template <typename E>
__global__ void __launch_bounds__(256)
stream_triad_kernel(const E* __restrict__ b, const E* __restrict__ c,
                    E* __restrict__ a, long long N, double s_in, int block,
                    int stages) {
  constexpr int VEC = 16 / sizeof(E);              // elements a chunk
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t step_bytes = (size_t)block * sizeof(E);
  const TriadSmem L = triad_smem(block, stages, sizeof(E));
  // s: a float type's value already, or an integer type's in fp32
  Scalar<E> s;
  if constexpr (std::is_integral_v<E>) s = to_int<E>(s_in);
  else s = (float)s_in;
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
      triad_chunk(vb, vc, va, s);
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
                   double s, int block, int stages, int grid, int threads,
                   cudaStream_t stream) {
  const size_t smem = triad_smem(block, stages, sizeof(E)).bytes;
  if (smem > (size_t)MAX_SMEM) return cudaErrorInvalidValue;
  static SmemAllowance allowance;
  cudaError_t err = allow_smem(allowance, stream_triad_kernel<E>, MAX_SMEM);
  if (err != cudaSuccess) return err;
  stream_triad_kernel<E><<<grid, threads, smem, stream>>>(
      static_cast<const E*>(b), static_cast<const E*>(c), static_cast<E*>(a),
      N, s, block, stages);
  return cudaGetLastError();
}

// f(E{}) for the element type of `dtype`; -1 for a type the kernel does not
// take.
template <typename F>
int with_type(int dtype, F&& f) {
  switch (dtype) {
    case DTYPE_F32: return (int)f(float{});
    case DTYPE_BF16: return (int)f(__nv_bfloat16{});
    case DTYPE_F16: return (int)f(__half{});
    case DTYPE_E4M3: return (int)f(fp8_e4m3{});
    case DTYPE_E5M2: return (int)f(fp8_e5m2{});
    case DTYPE_I8: return (int)f(int8_t{});
    case DTYPE_U8: return (int)f(uint8_t{});
    case DTYPE_I16: return (int)f(int16_t{});
    case DTYPE_U16: return (int)f(uint16_t{});
    case DTYPE_I32: return (int)f(int32_t{});
    case DTYPE_U32: return (int)f(uint32_t{});
  }
  return -1;
}

int item_size(int dtype) {
  return with_type(dtype, [](auto e) { return (int)sizeof(e); });
}

}  // namespace

// s is already the arrays' type for float types, and for integer types the
// fp32 scalar the kernel converts (`to_int`); block is a
// multiple of 128; b, c and a start on 16-byte boundaries. grid, threads:
// `triad_plan` of stream_triad.py; the launch sizes the shared memory itself
// (`stream_triad_smem`) and refuses a ring that does not fit. Returns 0, a
// cudaError_t, or -1 for a type it does not take.
extern "C" int stream_triad_launch(const void* b, const void* c, void* a,
                                   long long N, double s, int block,
                                   int stages, int grid, int threads,
                                   int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_type(dtype, [&](auto e) {
    return launch<decltype(e)>(b, c, a, N, s, block, stages, grid, threads,
                               st);
  });
}

// Shared-memory bytes a block of the launch takes; -1 for a type it does not
// take.
extern "C" long long stream_triad_smem(int block, int stages, int dtype) {
  const int item = item_size(dtype);
  return item < 0 ? -1 : (long long)triad_smem(block, stages, item).bytes;
}
