// Hopper building blocks shared by the kernels that use TMA, mbarriers and
// wgmma: raw PTX for sm_90a, no library.
//
//   mbarrier  init / arrive / arrive.expect_tx / try_wait.parity: a barrier
//             in shared memory that counts both thread arrivals and the bytes
//             an asynchronous copy still owes it (complete_tx);
//   TMA       cp.async.bulk.tensor (a tile through a tensor map) and
//             cp.async.bulk (contiguous bytes), both completing on an
//             mbarrier; the shared -> global bulk copy with its bulk groups;
//   wgmma     the shared-memory matrix descriptor for 128-byte swizzled
//             tiles, fence / commit_group / wait_group;
//   clusters  a cluster's size, `mapa` addresses of another CTA's shared
//             memory, arrivals on its mbarriers and loads from it, the
//             cluster barrier;
//   roles     setmaxnreg (registers handed between warpgroups);
//   math      ex2 on the special-function unit;
//   host      the tensor-map encoder, taken from the driver through the
//             runtime (cudaGetDriverEntryPoint), so no -lcuda is needed.
// Used by flash_attention (wgmma body; the fma body's clusters),
// async_gather (bulk-copy ring), paged_attention (TMA page ring) and
// stream_triad (bulk-copy ring).
#pragma once

#include <cuda.h>            // CUtensorMap and its enums: types only
#include <cudaTypedefs.h>    // PFN_cuTensorMapEncodeTiled_v12000
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {
namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------------ mbarrier
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// After the barriers are initialised, before any thread or copy uses them.
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Orders this thread's shared-memory accesses (generic proxy) before the
// asynchronous proxy's (TMA, bulk copies, wgmma operand reads).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// One arrival, and `bytes` more that copies must deliver before the phase
// can complete.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Spins until the phase of parity `parity` has completed. A fresh barrier is
// in phase 0, so waiting on parity 1 returns at once: a producer waiting for
// a free slot starts one parity ahead of its consumers.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// ------------------------------------------------------------------ clusters
// The number of CTAs in this CTA's cluster.
__device__ __forceinline__ uint32_t cluster_size() {
  uint32_t n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(n));
  return n;
}

// The address in CTA `rank`'s shared memory (the cluster's window) of the
// variable at `p` in this CTA's.
__device__ __forceinline__ uint32_t cluster_addr(const void* p,
                                                 uint32_t rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(a)
               : "r"(smem_u32(p)), "r"(rank));
  return a;
}

// One arrival on the barrier at `bar` of CTA `rank`, releasing this
// thread's (and, after a warp barrier, its warp's) earlier writes to the
// cluster: a MEMBAR.ALL.GPU in SASS, one for a warp whose lanes arrive at
// once, so a warp that signals several CTAs gives each a lane.
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar,
                                                    uint32_t rank) {
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(
          cluster_addr(bar, rank))
      : "memory");
}

// `mbar_wait` whose completion acquires what the arrivals of other CTAs of
// the cluster released.
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar,
                                                  uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// 16 bytes at `addr` of the cluster's shared-memory window (`cluster_addr`).
__device__ __forceinline__ float4 ld_cluster_f4(uint32_t addr) {
  float4 x;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(x.x), "=f"(x.y), "=f"(x.z), "=f"(x.w)
               : "r"(addr)
               : "memory");
  return x;
}

// The cluster barrier: every thread of every CTA of the cluster that has
// not exited arrives (releasing its writes) before any passes the wait.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// ----------------------------------------------------------------------- TMA
// A 4-d box of `map` at coordinates (c0 innermost .. c3) into shared memory;
// the bytes complete on `bar`. Elements outside the tensor arrive as zeros.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// `bytes` contiguous bytes global -> shared, completing on `bar` (both
// addresses and the size multiples of 16).
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// `bytes` contiguous bytes shared -> global, tracked by bulk groups.
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::
                   "l"(dst),
               "r"(smem_u32(src)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// At most N of this thread's bulk groups still reading shared memory. Their
// writes to global memory need no wait: they are visible when the kernel
// ends.
template <int N> __device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// --------------------------------------------------------------------- wgmma
// Matrix descriptor of a tile in shared memory laid out as TMA writes it with
// CU_TENSOR_MAP_SWIZZLE_128B: rows of 128 bytes, 8-row groups of 1024 bytes
// (the swizzle atom; its base must be 1024-byte aligned). The stride field
// is the 1024-byte group stride: a K-major operand (K within the row) steps
// by it from one 8-row group to the next, an MN-major operand (N within the
// row) along K. The leading field, `lbo`, is read only for an MN-major
// operand wider than one atom (64 bf16 columns): the bytes from one 64-column
// atom to the next. Moving along K inside a K-major atom is done by adding
// the byte offset to `addr` (multiples of 32 bytes).
__device__ __forceinline__ uint64_t wgmma_desc_sw128(uint32_t addr,
                                                     uint32_t lbo = 1024) {
  constexpr uint64_t group = 1024 >> 4;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         (group << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// ------------------------------------------------------ warp specialisation
// A warpgroup lowers (dec) or raises (inc) the registers of each of its
// threads to N, its four warps together: a producer warpgroup hands its
// registers to the consumer warpgroups. The roles must not reconverge after
// it, or the compiler ignores it.
template <int N> __device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N> __device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// 2^x on the special-function unit, denormals flushed (exp2f adds a fix-up
// for them that a softmax does not need).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Pins registers that an asynchronous wgmma reads or writes at this point of
// the program, so that the compiler moves no access to them across a
// fence / wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// -------------------------------------------------------------------- host
// Sets a kernel's dynamic shared-memory allowance once per device: the
// attribute is a permission, not an amount, so one call covers every launch
// of that kernel. The caller keeps one `SmemAllowance` per kernel (a static
// in the launch function).
struct SmemAllowance {
  bool done[64] = {};
};

template <typename Kernel>
cudaError_t allow_smem(SmemAllowance& state, Kernel kernel, int bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && state.done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess && dev < 64) state.done[dev] = true;
  return err;
}

// cuTensorMapEncodeTiled for a tensor of `rank` dims (innermost first, dim 0
// contiguous), strides in bytes of dims 1.., zero fill out of bounds.
inline cudaError_t encode_tensor_map(CUtensorMap* map,
                                     CUtensorMapDataType type, int rank,
                                     const void* base, const cuuint64_t* dims,
                                     const cuuint64_t* strides,
                                     const cuuint32_t* box,
                                     CUtensorMapSwizzle swizzle) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                              cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return cudaErrorNotSupported;
    encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }
  cuuint32_t elem_strides[5] = {1, 1, 1, 1, 1};
  const CUresult res = encode(
      map, type, rank, const_cast<void*>(base), dims, strides, box,
      elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace hopper
}  // namespace repro
