// stream_triad: STREAM's triad a = b + s * c, streamed in steps through a
// ring of bulk copies.
//
// Replaces the TPU kernel `_triad_kernel` / `stream_triad` of
// src/repro/kernels/stream_triad.py. There each grid step's `block` elements
// of b and c arrive in VMEM by DMAs the Pallas pipeline issues one step ahead
// (double buffering), and the block is the paper's aload granularity. Here:
//
//   - a persistent grid walks the arrays in steps, grid-stride, so
//     neighbouring blocks (CTAs) stream neighbouring bytes. A step is sized
//     in bytes, not elements: `block` x 4 bytes of b and of c whatever the
//     type (2 KB at the default block of 512), so it holds K = 4 / item of
//     the reference's `block`s (4 at 8 bits, 2 at 16, 1 at 32), fewer where
//     `stages` such steps would not fit in shared memory (`step_blocks` in
//     stream_triad.py chooses K; the kernel is instantiated at each);
//   - aload = one cp.async.bulk of one `block` of b or c. A block has a
//     producer warp beside its computing threads (128 at the default block:
//     one 16-byte chunk of a step each). The producer's lane 0 arms slot
//     t % stages's `full` mbarrier with expect_tx(bytes of the step's b and
//     c) and issues the step's 2 x 4 / item copies into the slot, all
//     completing on that one barrier. getfin = each computing thread waits
//     try_wait.parity on `full`, computes its 16 bytes and writes them over
//     its b in the slot; each computing warp then arrives on the slot's
//     `done` mbarrier. astore = the producer waits on `done` and sends the
//     step from the slot to a by one shared -> global cp.async.bulk (a bulk
//     group); once wait_group.read says the store of the step before has
//     read its slot, it refills that slot with the step `stages` after it
//     (with one stage, the store just issued: it waits for that store to
//     have read the only slot, then refills it with the next step).
//     No thread issues a copy of its own, a byte passes through registers
//     once, for the arithmetic, and no barrier joins the whole block;
//   - what bounds a step is its fixed cost, not its bytes. Steps of
//     `block` elements, with one elected thread storing, refilling and
//     waiting between two barriers of the whole block, paid it 4x as often
//     a byte at 8 bits and 2x at 16 as at 32, in blocks of one or two warps
//     (int8 and f16 at 1.24x and 1.14x `torch.add`'s time). Steps sized in
//     bytes with that same loop were slower at 8 bits (PERF.md): the
//     computing threads waited at the barriers while one thread issued the
//     step's eight 512-byte copies and its store. With a producer warp the
//     copies and the store run beside the arithmetic of the steps that
//     have landed;
//   - the grid is planned from the card (`triad_plan` in stream_triad.py):
//     CTAs an SM such that the loads in flight an SM are ~latency x
//     bandwidth (48 KB, at least two CTAs; 24 KB was slower, 64 KB slower
//     at 16 and 32 bits) and not ten times that, cached with the kernel's
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
//   - 8- and 16-bit integers go a 32-bit word (4 or 2 lanes) at a time
//     (`triad_word`): the even lanes (mask M = 0x00FF00FF, or 0x0000FFFF)
//     and the odd lanes (~M) each take one multiply-add of the word's
//     masked b and c by s (s's low 8 or 16 bits), and each lane keeps the
//     low bits of its own sum. That is exact: a lane's product of two
//     values below 2^8 (2^16) fits its 16 (32) bits, so at 8 bits no
//     product or sum carries out of its 16-bit lane, an odd lane's carry
//     into the masked-out byte above it stops there (at most 0xFE + 1),
//     and at 16 bits what passes bit 31 is lost mod 2^32; two's complement
//     makes signed and unsigned one computation. Three logic operations and
//     two multiply-adds a word, where element by element each lane took
//     its extraction, product and packing;
//   - 16 bytes are 4 f32 / int32, 8 bf16 / f16 / int16, 16 int8 or fp8
//     elements. The ragged tail is masked: the last step moves only its
//     whole 16-byte chunks (its copies past them are not issued), and the
//     last N mod (16 / item) elements, too few for a bulk copy, are done by
//     the last CTA with scalar loads.
//
// Bound on this card: bytes (3 x item bytes an element, 2 operations).

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

// 8- and 16-bit integers a word at a time: b + s * c in each lane, s the
// lanes' bits (the note at the top says why it is exact)
template <typename E>
__device__ __forceinline__ uint32_t triad_word(uint32_t b, uint32_t c,
                                               uint32_t s) {
  constexpr uint32_t M = sizeof(E) == 1 ? 0x00FF00FFu : 0x0000FFFFu;
  const uint32_t even = (b & M) + (c & M) * s;
  const uint32_t odd = (b & ~M) + (c & ~M) * s;
  return (even & M) | (odd & ~M);
}

// A 16-byte chunk: bf16 as pairs (the product rounded, then the sum, as
// triad() rounds them one element at a time), 8- and 16-bit integers as
// words, other types by element.
template <typename E, int N>
__device__ __forceinline__ void triad_chunk(const Vec<E, N>& b,
                                            const Vec<E, N>& c, Vec<E, N>& a,
                                            Scalar<E> s) {
  if constexpr (std::is_integral_v<E> && sizeof(E) < 4) {
    const uint32_t sw = (uint32_t)(std::make_unsigned_t<E>)s;
    const auto* bw = reinterpret_cast<const uint32_t*>(b.v);
    const auto* cw = reinterpret_cast<const uint32_t*>(c.v);
    auto* aw = reinterpret_cast<uint32_t*>(a.v);
#pragma unroll
    for (int i = 0; i < 4; ++i) aw[i] = triad_word<E>(bw[i], cw[i], sw);
  } else if constexpr (std::is_same_v<E, __nv_bfloat16>) {
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

// A block's shared memory: two mbarriers a stage (`full`: the step's copies
// landed; `done`: every computing warp wrote its result), then from `in` on
// the `stages` slots, a step of b then of c each; a step's result is
// written over its b, from where it is stored. The kernel carves it and the
// launch sizes it from this one function.
struct TriadSmem {
  size_t in, bytes;
};

__host__ __device__ inline TriadSmem triad_smem(size_t step, int stages) {
  TriadSmem m;
  m.in = ((size_t)stages * 16 + 15) & ~(size_t)15;
  m.bytes = m.in + (size_t)stages * 2 * step;
  return m;
}

// Steps whose stores may still be reading their slots when a slot is
// refilled: the producer refills the slot of step t - LAG after storing t
// (where stages > LAG; else the slot of t itself, once its store read it).
constexpr int LAG = 1;

// K: the reference's blocks (bulk copies of b and of c) a step
template <typename E, int K>
__global__ void __launch_bounds__(288)
stream_triad_kernel(const E* __restrict__ b, const E* __restrict__ c,
                    E* __restrict__ a, long long N, double s_in, int block,
                    int stages) {
  constexpr int VEC = 16 / sizeof(E);              // elements a chunk
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t block_bytes = (size_t)block * sizeof(E);
  const size_t step_bytes = block_bytes * K;
  const TriadSmem L = triad_smem(step_bytes, stages);
  // s: a float type's value already, or an integer type's in fp32
  Scalar<E> s;
  if constexpr (std::is_integral_v<E>) s = to_int<E>(s_in);
  else s = (float)s_in;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* done = full + stages;
  unsigned char* in = smem + L.in;                 // (b, c) a slot
  const int BC = block / VEC;                      // chunks an aload
  const int CB = BC * K;                           // chunks a step
  const long long NC = N / VEC;                    // whole chunks
  const long long nsteps = (NC + CB - 1) / CB;
  const long long G = gridDim.x;
  const int T = blockIdx.x < nsteps
                    ? (int)((nsteps - 1 - blockIdx.x) / G + 1) : 0;
  const int workers = blockDim.x - 32;             // the last warp produces
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0)
    for (int i = 0; i < stages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&done[i], workers / 32);
    }
  fence_barrier_init();
  __syncthreads();

  auto first_chunk = [&](int t) {
    return (blockIdx.x + t * G) * (long long)CB;
  };
  auto slot = [&](int t) { return in + (size_t)(t % stages) * 2 * step_bytes; };

  using Pack = Vec<E, VEC>;                        // 16 bytes
  if (threadIdx.x >= workers) {                    // the producer warp
    if (lane == 0) {
      auto issue = [&](int t) {                    // aload of step t
        if (t >= T) return;
        const long long c0 = first_chunk(t);
        const uint32_t bytes = (uint32_t)min((long long)CB, NC - c0) * 16;
        uint64_t* bar = &full[t % stages];
        unsigned char* dst = slot(t);
        mbar_arrive_expect_tx(bar, 2 * bytes);
#pragma unroll
        for (int j = 0; j < K; ++j) {              // one block an aload
          const long long cj = c0 + (long long)j * BC;
          if (cj >= NC) break;
          const uint32_t n = (uint32_t)min((long long)BC, NC - cj) * 16;
          bulk_load(dst + j * block_bytes, b + cj * VEC, n, bar);
          bulk_load(dst + step_bytes + j * block_bytes, c + cj * VEC, n, bar);
        }
      };
      for (int t = 0; t < stages; ++t) issue(t);   // prime
      for (int t = 0; t < T; ++t) {
        const long long c0 = first_chunk(t);
        const int nc = (int)min((long long)CB, NC - c0);
        mbar_wait(&done[t % stages], (uint32_t)((t / stages) & 1));
        bulk_store(a + c0 * VEC, slot(t), (uint32_t)nc * 16);   // astore
        bulk_commit();
        if (stages <= LAG) {           // one slot: step t's store read it
          bulk_wait_read<0>();
          issue(t + stages);
        } else if (t >= LAG) {         // step t - LAG's store has read it
          bulk_wait_read<LAG>();
          issue(t - LAG + stages);     // refill its slot
        }
      }
      bulk_wait_read<0>();             // the slots stay until read
    }
  } else {                                         // the computing warps
    for (int t = 0; t < T; ++t) {
      const long long c0 = first_chunk(t);
      const int nc = (int)min((long long)CB, NC - c0);
      unsigned char* src = slot(t);
      mbar_wait(&full[t % stages], (uint32_t)((t / stages) & 1));  // getfin
      for (int k = threadIdx.x; k < nc; k += workers) {
        const Pack vb = *reinterpret_cast<const Pack*>(src + k * 16);
        const Pack vc = *reinterpret_cast<const Pack*>(src + step_bytes + k * 16);
        Pack va;
        triad_chunk(vb, vc, va, s);
        *reinterpret_cast<Pack*>(src + k * 16) = va;
      }
      fence_proxy_async();             // the writes above, before the store
      __syncwarp();
      if (lane == 0) mbar_arrive(&done[t % stages]);
    }
  }
  if (blockIdx.x == gridDim.x - 1) {   // the sub-chunk tail
    for (long long e = NC * VEC + threadIdx.x; e < N; e += blockDim.x)
      a[e] = triad(b[e], c[e], s);
  }
}

template <typename E, int K>
cudaError_t launch_k(const void* b, const void* c, void* a, long long N,
                     double s, int block, int stages, int grid,
                     int threads, cudaStream_t stream) {
  const size_t smem =
      triad_smem((size_t)block * sizeof(E) * K, stages).bytes;
  if (smem > (size_t)MAX_SMEM) return cudaErrorInvalidValue;
  static SmemAllowance allowance;
  cudaError_t err =
      allow_smem(allowance, stream_triad_kernel<E, K>, MAX_SMEM);
  if (err != cudaSuccess) return err;
  stream_triad_kernel<E, K><<<grid, threads + 32, smem, stream>>>(
      static_cast<const E*>(b), static_cast<const E*>(c), static_cast<E*>(a),
      N, s, block, stages);
  return cudaGetLastError();
}

// K of 1, 2 or 4 blocks a step, a step of at most 4 bytes an element of
// the block (as `step_blocks` chooses it)
template <typename E>
cudaError_t launch(const void* b, const void* c, void* a, long long N,
                   double s, int block, int stages, int k, int grid,
                   int threads, cudaStream_t stream) {
  switch (k) {
    case 1:
      return launch_k<E, 1>(b, c, a, N, s, block, stages, grid, threads,
                            stream);
    case 2:
      if constexpr (sizeof(E) <= 2)
        return launch_k<E, 2>(b, c, a, N, s, block, stages, grid, threads,
                              stream);
      break;
    case 4:
      if constexpr (sizeof(E) == 1)
        return launch_k<E, 4>(b, c, a, N, s, block, stages, grid, threads,
                              stream);
      break;
  }
  return cudaErrorInvalidValue;
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

}  // namespace

// s is already the arrays' type for float types, and for integer types the
// fp32 scalar the kernel converts (`to_int`); block is a
// multiple of 128; k blocks a step (`step_blocks` of stream_triad.py); b, c
// and a start on 16-byte boundaries. grid, threads (the computing threads;
// the launch adds the producer warp): `triad_plan` of stream_triad.py; the
// launch sizes the shared memory itself (`stream_triad_smem`) and refuses a
// ring that does not fit. Returns 0, a cudaError_t, or -1 for a type it
// does not take.
extern "C" int stream_triad_launch(const void* b, const void* c, void* a,
                                   long long N, double s, int block,
                                   int stages, int k, int grid, int threads,
                                   int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_type(dtype, [&](auto e) {
    return launch<decltype(e)>(b, c, a, N, s, block, stages, k, grid,
                               threads, st);
  });
}

// Shared-memory bytes a block of the launch takes: `stages` steps of
// `step_bytes` of b and of c, and their mbarriers.
extern "C" long long stream_triad_smem(long long step_bytes, int stages) {
  return (long long)triad_smem((size_t)step_bytes, stages).bytes;
}
