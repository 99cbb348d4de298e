// The AMI request ring of the AMU kernels (async_gather, async_scatter,
// stream_triad) in its Hopper form:
//
//   aload    -> cp.async of one chunk (4, 8 or 16 bytes) into a shared-memory
//               slot, issued and forgotten;
//   request  -> one commit group per row (or block): the group is the
//               request ID, its place in the ring the slot index;
//   getfin   -> cp.async.wait_group K-1 right before the slot is consumed:
//               of the K requests in flight, the oldest has landed;
//   SPM      -> the K slots of shared memory.
//
// A thread only ever reads back the chunks it copied itself, so wait_group,
// which speaks for the calling thread's own copies, is all the
// synchronisation a ring needs: no barrier between the lanes of a ring.
//
// The bulk-copy form (async_gather's rows that are a multiple of 16 bytes,
// 16-byte aligned; the PTX is in csrc/hopper.cuh):
//
//   aload    -> one cp.async.bulk of the whole row global -> shared, issued
//               by one lane, which first arms the slot's mbarrier with
//               expect_tx(row bytes);
//   request  -> the slot's mbarrier phase: its parity names the use of the
//               slot, the slot index the request;
//   getfin   -> mbarrier.try_wait.parity: the copy has delivered every byte
//               it owed the barrier (a short copy never completes the phase);
//   SPM      -> K+1 slots: K rows in flight, one leaving by a shared ->
//               global cp.async.bulk, refilled only after
//               cp.async.bulk.wait_group.read says that store has read it.
//
// Here the completion is counted in bytes by the barrier the reader waits on,
// not inferred from the issuing thread's own group count, so a consumer that
// skipped its getfin would read a slot no copy has finished.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

// One aload: `W` bytes from global to shared memory. 16-byte copies bypass L1
// (.cg): a row is read once; 4- and 8-byte copies only exist as .ca.
template <int W>
__device__ __forceinline__ void ring_copy(void* smem, const void* gmem) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  if constexpr (W == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(addr),
                 "l"(gmem)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(addr),
                 "l"(gmem), "n"(W)
                 : "memory");
  }
}

// Closes the request: every copy issued since the last commit is one group.
// A thread commits once per ring step even when it issued nothing, so that
// "K-1 groups pending" means the same thing on every lane and at the tail.
__device__ __forceinline__ void ring_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void ring_wait_n() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// getfin: wait until at most `pending` of this thread's groups are still in
// flight. wait_group takes an immediate, and the ring depth is a launch
// parameter, so the depth is dispatched here (uniform across the warp);
// beyond 63 it waits for all, which is right but overlaps nothing.
__device__ __forceinline__ void ring_wait(int pending) {
  switch (pending) {
#define REPRO_RING_WAIT(N) \
  case N:                  \
    ring_wait_n<N>();      \
    return;
#define REPRO_RING_WAIT8(B)                                               \
  REPRO_RING_WAIT(B + 0) REPRO_RING_WAIT(B + 1) REPRO_RING_WAIT(B + 2)    \
  REPRO_RING_WAIT(B + 3) REPRO_RING_WAIT(B + 4) REPRO_RING_WAIT(B + 5)    \
  REPRO_RING_WAIT(B + 6) REPRO_RING_WAIT(B + 7)
    REPRO_RING_WAIT8(0) REPRO_RING_WAIT8(8) REPRO_RING_WAIT8(16)
    REPRO_RING_WAIT8(24) REPRO_RING_WAIT8(32) REPRO_RING_WAIT8(40)
    REPRO_RING_WAIT8(48) REPRO_RING_WAIT8(56)
#undef REPRO_RING_WAIT8
#undef REPRO_RING_WAIT
    default:
      ring_wait_n<0>();
  }
}

// `W` bytes as one load or store (W = 4, 8, 16).
template <int W> struct Chunk;
template <> struct Chunk<4> { using type = uint32_t; };
template <> struct Chunk<8> { using type = uint2; };
template <> struct Chunk<16> { using type = uint4; };

// Shared-memory bytes a ring launch may use (the H100's 227 KB a block).
constexpr int MAX_SMEM = 232448;

}  // namespace repro
