// flash_attention: blockwise causal / sliding-window self-attention with GQA.
//
// Replaces the TPU kernel `_flash_kernel` / `flash_attention` of
// src/repro/kernels/flash_attention.py. There the KV axis is the innermost,
// sequential grid axis and (m, l, acc) live in scratch across its steps. Here
// one block owns a tile of 64 query rows of one (b, q-head) and loops over the
// 64-key tiles that causality and the window leave it; (m, l, acc) stay in
// registers for the whole loop and the [S, S] logits never reach device
// memory. Q, K, V and the output are addressed through their strides, so the
// model's [B, S, H, D] layout is read in place, and the ragged edge (S not a
// multiple of the tile) is masked in the kernel: no pad, no transpose copy.
// Blocks with the most KV tiles (the last query tiles) are scheduled first.
//
// Bound on this card: operations. A block reads its Q tile once and each K/V
// tile once per 64 rows, so at S = 1000, D = 128 the kernel does some hundreds
// of operations per byte of Q+K+V+O. Two bodies, chosen by the input type:
//
// * float32 -> `flash_fma_kernel`: both products as fp32 FMAs on the CUDA
//   cores, a 4x4 (Q K^T) and a 4x(D/16) (P V) register tile per thread. TF32
//   would not hold the fp32 tolerance (atol 2e-5). Rows of the shared tiles
//   are padded by one word so the 16 threads that read 16 different K rows
//   hit 16 different banks.
// * bfloat16 -> `flash_mma_kernel`: both products on the tensor cores
//   (mma.sync.m16n8k16, bf16 operands, fp32 accumulation) in the
//   FlashAttention-2 register layout: a warp owns 16 query rows, its logits
//   never leave registers, and P is rounded to bf16 only as the left operand
//   of the second product.
//
//   Its K/V tiles come through a ring of two shared-memory slots filled by
//   cp.async: the next tile's copies are issued before the current tile's
//   products and waited for just before they are used, so the loads of tile
//   i+1 overlap the arithmetic of tile i (the paper's aload / getfin / slot
//   ring, at tile granularity).
//
// wgmma, TMA and a deeper ring are left to a later change.

#include "common.cuh"

namespace {

using namespace repro;

constexpr int BM = 64;        // query rows per block
constexpr int BN = 64;        // keys per tile

// ---------------------------------------------------------------------------
// float32 on the CUDA cores. 256 threads: 16 (ty, rows) x 16 (tx, columns).
constexpr int NT = 256;
constexpr int RPT = 4;        // rows per thread: ty*4 .. ty*4+3
constexpr int CPT = 4;        // logit columns per thread: tx + 16*j
constexpr int PS = BN + 4;    // row stride of the P tile (see bank note below)

template <int D> struct FmaCfg {
  static constexpr int WS = D + 1;                // padded row stride (floats)
  static constexpr int WPT = (D + 15) / 16;       // output columns per thread
  static constexpr size_t SMEM =
      sizeof(float) * ((size_t)(BM + 2 * BN) * WS + BM * PS);
};

// rows [row0, row0 + ROWS) of a [*, D] operand -> shared memory, zero past S
template <int D, int ROWS>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src,
                                              long long row_stride, int row0,
                                              int S) {
  constexpr int CPR = D / 4;                      // 16-byte chunks per row
  for (int idx = threadIdx.x; idx < ROWS * CPR; idx += NT) {
    const int r = idx / CPR, c = idx % CPR;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < S)
      val = *reinterpret_cast<const float4*>(src + (row0 + r) * row_stride +
                                             c * 4);
    float* p = dst + r * FmaCfg<D>::WS + c * 4;
    p[0] = val.x; p[1] = val.y; p[2] = val.z; p[3] = val.w;
  }
}

template <int D>
__global__ void __launch_bounds__(NT)
flash_fma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int S,
                 int group, int causal, int window, float scale,
                 long long q_sb, long long q_sh, long long q_ss,
                 long long k_sb, long long k_sh, long long k_ss,
                 long long v_sb, long long v_sh, long long v_ss,
                 long long o_sb, long long o_sh, long long o_ss) {
  constexpr int WS = FmaCfg<D>::WS, WPT = FmaCfg<D>::WPT;
  extern __shared__ float smem_f32[];
  float* Qs = smem_f32;
  float* Ks = Qs + BM * WS;
  float* Vs = Ks + BN * WS;
  float* Ps = Vs + BN * WS;

  const int qt = gridDim.x - 1 - blockIdx.x;      // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / group;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = qt * BM;

  const float* qb = q + b * q_sb + h * q_sh;
  const float* kb = k + b * k_sb + hk * k_sh;
  const float* vb = v + b * v_sb + hk * v_sh;

  load_tile_f32<D, BM>(Qs, qb, q_ss, q0, S);

  // KV tiles that causality and the window leave to this query tile
  const int nkt = (S + BN - 1) / BN;
  const int q_last = min(q0 + BM, S) - 1;
  const int kt_hi = causal ? min(nkt, q_last / BN + 1) : nkt;
  int kt_lo = 0;
  if (window > 0 && q0 - window + 1 > 0) kt_lo = (q0 - window + 1) / BN;

  float m[RPT], l[RPT], acc[RPT][WPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < WPT; ++c) acc[i][c] = 0.f;
  }

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * BN;
    __syncthreads();              // the last tile's readers are done
    load_tile_f32<D, BN>(Ks, kb, k_ss, k0, S);
    load_tile_f32<D, BN>(Vs, vb, v_ss, k0, S);
    __syncthreads();

    // logits: rows ty*4+i, columns tx+16*j. The 16 tx of a half-warp read 16
    // K rows whose stride WS is odd: 16 different banks. The two ty of a warp
    // read the same K words (broadcast) and Q rows 4*WS words apart.
    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int w = 0; w < D; ++w) {
      float a[RPT], bb[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) a[i] = Qs[(ty * RPT + i) * WS + w];
#pragma unroll
      for (int j = 0; j < CPT; ++j) bb[j] = Ks[(tx + 16 * j) * WS + w];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = fmaf(a[i], bb[j], s[i][j]);
    }

    // mask, online softmax; P goes to shared memory for the second product.
    // PS = BN + 4 puts the two ty of a warp 16 banks apart.
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = q0 + ty * RPT + i;
      float tmax = NEG_INF;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int c = k0 + tx + 16 * j;
        bool ok = c < S;
        if (causal) ok = ok && (c <= r);
        if (window > 0) ok = ok && (c > r - window);
        s[i][j] = ok ? s[i][j] * scale : NEG_INF;
        tmax = fmaxf(tmax, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
      const float m_new = fmaxf(m[i], tmax);
      const float alpha = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float p = expf(s[i][j] - m_new);
        psum += p;
        Ps[(ty * RPT + i) * PS + tx + 16 * j] = p;
      }
      l[i] = l[i] * alpha + psum;     // this thread's share of the row sum
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < WPT; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    // acc += P V: rows ty*4+i, output columns tx+16*jj
#pragma unroll 4
    for (int n = 0; n < BN; ++n) {
      float p[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) p[i] = Ps[(ty * RPT + i) * PS + n];
#pragma unroll
      for (int jj = 0; jj < WPT; ++jj) {
        const int c = tx + 16 * jj;
        if (c < D) {
          const float vv = Vs[n * WS + c];
#pragma unroll
          for (int i = 0; i < RPT; ++i) acc[i][jj] = fmaf(p[i], vv, acc[i][jj]);
        }
      }
    }
  }

  float* ob = o + b * o_sb + h * o_sh;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    float lsum = l[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      lsum += __shfl_xor_sync(0xffffffffu, lsum, off);
    const float inv = 1.f / fmaxf(lsum, 1e-30f);
    const int r = q0 + ty * RPT + i;
    if (r < S) {
#pragma unroll
      for (int jj = 0; jj < WPT; ++jj) {
        const int c = tx + 16 * jj;
        if (c < D) ob[r * o_ss + c] = acc[i][jj] * inv;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16 on the tensor cores. Block = 4 warps x 16 query rows.
// Fragment layouts of mma.sync.m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16x16, row): a0 = (g, 2t..2t+1)  a1 = (g+8, 2t..)  a2 = (g, 2t+8..)
//                   a3 = (g+8, 2t+8..)
//   B (16x8, col):  b0 = (k 2t..2t+1, n g)   b1 = (k 2t+8..2t+9, n g)
//   C (16x8):       c0, c1 = (g, 2t..2t+1)   c2, c3 = (g+8, 2t..2t+1)
// K rows are [key][d], which is B in "col" form for Q K^T; V rows [key][d]
// are B for P V only transposed, which ldmatrix.trans does on the way in.
// Rows are padded by 4 words (WS % 8 == 4): the 8 g x 4 t word reads of a B
// fragment hit 32 different banks, and rows stay 16-byte aligned for ldmatrix.
constexpr int MMA_NT = 128;
constexpr int SLOTS = 2;      // K/V tiles in flight or in use (the slot ring)
static_assert(BM == BN, "the Q tile borrows a K slot");

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* smem_ptr) {
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem_ptr));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

template <int D> struct MmaCfg {
  static constexpr int NW = D / 2;                // words per row
  static constexpr int WS = NW + 4;               // padded row stride (words)
  static constexpr int TILE = BN * WS;            // words of one K or V tile
  // a ring of SLOTS (K, V) tile pairs; the Q tile borrows the last slot's K
  // area until its fragments are in registers
  static constexpr size_t SMEM = sizeof(uint32_t) * (size_t)SLOTS * 2 * TILE;
};

// The AMI pattern in its Hopper form: aload = cp.async (16 bytes a request,
// issued and forgotten), request group = commit_group, getfin = wait_group.
__device__ __forceinline__ void cp_async_16(void* smem_ptr, const void* gmem,
                                            int src_bytes) {
  // src_bytes < 16 zero-fills the rest of the 16 bytes (0: nothing is read)
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem_ptr));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(addr),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// issue the copies of rows [row0, row0 + BN) of a [*, D] bf16 operand into a
// shared tile; rows past S are zero-filled. Returns at once.
template <int D>
__device__ __forceinline__ void issue_tile(uint32_t* dst,
                                           const __nv_bfloat16* src,
                                           long long row_stride, int row0,
                                           int S) {
  constexpr int CPR = D / 8;                      // 16-byte chunks per row
  for (int idx = threadIdx.x; idx < BN * CPR; idx += MMA_NT) {
    const int r = idx / CPR, c = idx % CPR;
    const bool in = row0 + r < S;
    cp_async_16(dst + r * MmaCfg<D>::WS + c * 4,
                src + (in ? row0 + r : 0) * row_stride + c * 8, in ? 16 : 0);
  }
}

template <int D>
__global__ void __launch_bounds__(MMA_NT)
flash_mma_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o, int S, int group, int causal,
                 int window, float scale, long long q_sb, long long q_sh,
                 long long q_ss, long long k_sb, long long k_sh,
                 long long k_ss, long long v_sb, long long v_sh,
                 long long v_ss, long long o_sb, long long o_sh,
                 long long o_ss) {
  constexpr int WS = MmaCfg<D>::WS;
  constexpr int KS = D / 16;            // k-steps of Q K^T
  constexpr int NB = BN / 8;            // 8-key column blocks of the logits
  constexpr int DB = D / 8;             // 8-wide column blocks of the output
  extern __shared__ uint32_t smem[];
  constexpr int TILE = MmaCfg<D>::TILE;
  uint32_t* Qs = smem + (SLOTS - 1) * 2 * TILE;   // the last slot's K area

  const int qt = gridDim.x - 1 - blockIdx.x;      // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / group;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = qt * BM;

  const __nv_bfloat16* qb = q + b * q_sb + h * q_sh;
  const __nv_bfloat16* kb = k + b * k_sb + hk * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + hk * v_sh;

  issue_tile<D>(Qs, qb, q_ss, q0, S);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qa[KS][4];                   // this warp's 16 query rows, all of D
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const uint32_t* base = Qs + (warp * 16 + g) * WS + ks * 8 + t;
    qa[ks][0] = base[0];
    qa[ks][1] = base[8 * WS];
    qa[ks][2] = base[4];
    qa[ks][3] = base[8 * WS + 4];
  }

  const int nkt = (S + BN - 1) / BN;
  const int q_last = min(q0 + BM, S) - 1;
  const int kt_hi = causal ? min(nkt, q_last / BN + 1) : nkt;
  int kt_lo = 0;
  if (window > 0 && q0 - window + 1 > 0) kt_lo = (q0 - window + 1) / BN;

  // rows r0 = g and r1 = g + 8 of the warp's 16
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
  float acc[DB][4];
#pragma unroll
  for (int d = 0; d < DB; ++d)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[d][c] = 0.f;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;

  // Q's fragments are in registers: its shared memory is a free slot now
  __syncthreads();
  auto issue = [&](int kt) {          // aload of KV tile kt into its slot
    uint32_t* slot = smem + ((kt - kt_lo) % SLOTS) * 2 * TILE;
    issue_tile<D>(slot, kb, k_ss, kt * BN, S);
    issue_tile<D>(slot + TILE, vb, v_ss, kt * BN, S);
    cp_async_commit();
  };
  issue(kt_lo);
  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * BN;
    // issue the next tile early, wait for this one late
    if (kt + 1 < kt_hi) {
      issue(kt + 1);
      cp_async_wait<SLOTS - 1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint32_t* Ks = smem + ((kt - kt_lo) % SLOTS) * 2 * TILE;
    const uint32_t* Vs = Ks + TILE;

    float s[NB][4];
#pragma unroll
    for (int n = 0; n < NB; ++n) {
#pragma unroll
      for (int c = 0; c < 4; ++c) s[n][c] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const uint32_t* kp = Ks + (n * 8 + g) * WS + ks * 8 + t;
        mma_bf16_16816(s[n], qa[ks], kp[0], kp[4]);
      }
    }

    // mask and online softmax on the fragment: c0, c1 belong to row r0,
    // c2, c3 to row r1; a row's 64 logits sit in the 4 lanes of a quad
    float tmax0 = NEG_INF, tmax1 = NEG_INF;
#pragma unroll
    for (int n = 0; n < NB; ++n) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = k0 + n * 8 + 2 * t + (c & 1);
        const int r = (c < 2) ? r0 : r1;
        bool ok = col < S;
        if (causal) ok = ok && (col <= r);
        if (window > 0) ok = ok && (col > r - window);
        s[n][c] = ok ? s[n][c] * scale : NEG_INF;
      }
      tmax0 = fmaxf(tmax0, fmaxf(s[n][0], s[n][1]));
      tmax1 = fmaxf(tmax1, fmaxf(s[n][2], s[n][3]));
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      tmax0 = fmaxf(tmax0, __shfl_xor_sync(0xffffffffu, tmax0, off));
      tmax1 = fmaxf(tmax1, __shfl_xor_sync(0xffffffffu, tmax1, off));
    }
    const float mn0 = fmaxf(m0, tmax0), mn1 = fmaxf(m1, tmax1);
    const float alpha0 = expf(m0 - mn0), alpha1 = expf(m1 - mn1);
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      s[n][0] = expf(s[n][0] - mn0);
      s[n][1] = expf(s[n][1] - mn0);
      s[n][2] = expf(s[n][2] - mn1);
      s[n][3] = expf(s[n][3] - mn1);
      ps0 += s[n][0] + s[n][1];
      ps1 += s[n][2] + s[n][3];
    }
    l0 = l0 * alpha0 + ps0;       // this lane's share of the row sums
    l1 = l1 * alpha1 + ps1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int d = 0; d < DB; ++d) {
      acc[d][0] *= alpha0;
      acc[d][1] *= alpha0;
      acc[d][2] *= alpha1;
      acc[d][3] *= alpha1;
    }

    // acc += P V: the logit fragments of key blocks 2kk, 2kk+1 are the A
    // fragment of k-step kk
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      // lanes 0-7, 8-15, 16-23, 24-31 address the rows of four 8x8 blocks:
      // keys +0 / +8 of d-block 2dp, then keys +0 / +8 of d-block 2dp+1
      const uint32_t* vrow =
          Vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * WS +
          (lane >> 4) * 4;
#pragma unroll
      for (int dp = 0; dp < DB / 2; ++dp) {
        uint32_t vfrag[4];
        ldmatrix_x4_trans(vfrag, vrow + dp * 8);
        mma_bf16_16816(acc[2 * dp], pa, vfrag[0], vfrag[1]);
        mma_bf16_16816(acc[2 * dp + 1], pa, vfrag[2], vfrag[3]);
      }
    }
    __syncthreads();              // this slot is free for the tile after next
  }

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  __nv_bfloat16* ob = o + b * o_sb + h * o_sh;
#pragma unroll
  for (int d = 0; d < DB; ++d) {
    const int col = d * 8 + 2 * t;
    if (r0 < S)
      *reinterpret_cast<uint32_t*>(ob + r0 * o_ss + col) =
          pack_bf16(acc[d][0] * inv0, acc[d][1] * inv0);
    if (r1 < S)
      *reinterpret_cast<uint32_t*>(ob + r1 * o_ss + col) =
          pack_bf16(acc[d][2] * inv1, acc[d][3] * inv1);
  }
}

template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o,
                       int B, int Hq, int Hkv, int S, int causal, int window,
                       float scale, const long long* st, cudaStream_t stream) {
  auto kernel = flash_mma_kernel<D>;
  const size_t smem = MmaCfg<D>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + BM - 1) / BM, Hq, B);
  using bf16 = __nv_bfloat16;
  kernel<<<grid, MMA_NT, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), S, Hq / Hkv, causal,
      window, scale, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], st[9], st[10], st[11]);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_fma(const void* q, const void* k, const void* v, void* o,
                       int B, int Hq, int Hkv, int S, int causal, int window,
                       float scale, const long long* st, cudaStream_t stream) {
  auto kernel = flash_fma_kernel<D>;
  const size_t smem = FmaCfg<D>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + BM - 1) / BM, Hq, B);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, Hq / Hkv,
      causal, window, scale, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], st[9], st[10], st[11]);
  return cudaGetLastError();
}

}  // namespace

// q, o [B, Hq, S, D]; k, v [B, Hkv, S, D]; last stride 1, the others given in
// elements as strides = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
// o_sb, o_sh, o_ss}. float32 runs on the CUDA cores, bfloat16 on the tensor
// cores. Returns 0 or a cudaError_t; -1 for a head size or type it does not
// take.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int Hq,
                                      int Hkv, int S, int D, int causal,
                                      int window, float scale,
                                      const long long* strides, int dtype,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FLASH_CASE(LAUNCH, DIM)                                            \
  case DIM:                                                                \
    return static_cast<int>(LAUNCH<DIM>(q, k, v, o, B, Hq, Hkv, S, causal, \
                                        window, scale, strides, s))
#define FLASH_DIMS(LAUNCH)      \
  switch (D) {                  \
    FLASH_CASE(LAUNCH, 16);     \
    FLASH_CASE(LAUNCH, 32);     \
    FLASH_CASE(LAUNCH, 64);     \
    FLASH_CASE(LAUNCH, 128);    \
    default: return -1;         \
  }
  if (dtype == DTYPE_F32) {
    FLASH_DIMS(launch_fma)
  } else if (dtype == DTYPE_BF16) {
    FLASH_DIMS(launch_mma)
  }
  return -1;
#undef FLASH_DIMS
#undef FLASH_CASE
}
