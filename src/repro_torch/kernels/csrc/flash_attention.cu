// flash_attention: blockwise causal / sliding-window self-attention with GQA.
//
// Replaces the TPU kernel `_flash_kernel` / `flash_attention` of
// src/repro/kernels/flash_attention.py. There the KV axis is the innermost,
// sequential grid axis and (m, l, acc) live in scratch across its steps. Here
// one block owns a tile of query rows of one (b, q-head) and loops over the
// KV tiles that causality and the window leave it; (m, l, acc) stay in
// registers for the whole loop and the [S, S] logits never reach device
// memory. Q, K, V and the output are addressed through their strides, so the
// model's [B, S, H, D] layout is read in place, and the ragged edge (S not a
// multiple of the tile) is masked in the kernel: no pad, no transpose copy.
// Blocks with the most KV tiles (the last query tiles) are scheduled first.
//
// Bound on this card: operations. At the serve shape (B = 4, Hq = 16, S =
// 1000, D = 128, bf16, causal) the two products are 16.4 GFLOP against 37 MB
// of Q, K, V and O, some 440 operations a byte, above the H100's ~295
// FLOP/byte ridge. Only wgmma reaches the tensor cores' full rate.
//
// Which body runs is a fixed rule on (type, head size), stated here, in
// `flash_attention_body` below and in the wrapper (`body_for`):
//
// * float32, any D -> `flash_fma_kernel`: both products as fp32 FMAs on the
//   CUDA cores, a 4x4 (Q K^T) and a 4x(D/16) (P V) register tile per thread,
//   64x64 tiles. TF32 would not hold the fp32 tolerance (atol 2e-5). Rows of
//   the shared tiles are padded by one word so the 16 threads that read 16
//   different K rows hit 16 different banks.
// * bfloat16, D = 64 or 128 -> `flash_wgmma_kernel`, designed for Hopper:
//   - a block of 288 threads: two consumer warpgroups of 64 query rows each
//     (BM = 128) and one producer warp; one block an SM (161 KB of shared
//     memory at D = 128);
//   - the producer warp's one lane is the AMI at tile granularity: aload =
//     TMA (cp.async.bulk.tensor) of the next K and V tiles (BN = 128 keys)
//     into a 2-stage ring of shared-memory slots; getfin = the consumers'
//     wait on the stage's *full* mbarrier, which the copies complete by
//     their byte count; a slot is freed when each consumer warp has arrived
//     on the stage's *empty* mbarrier, which the producer waits on before it
//     refills the stage. No consumer thread computes an address or holds a
//     register for a copy;
//   - tensor maps describe the caller's strided [B, H, S, D] views (dims
//     innermost first, the outer three by ascending stride), 128-byte
//     swizzle, boxes of 64 columns (two a row at D = 128). TMA zero-fills
//     rows past S and never reads the next head or batch; logits of keys >= S
//     are still masked (a zero key row gives logit 0, not -inf);
//   - S = Q K^T by wgmma.m64n128k16 with Q and K both K-major in shared
//     memory; O += P V by one wgmma.m64nDk16 a 16-key step with P from
//     registers (the S accumulator rounded to bf16 in place: its layout is
//     the A fragment's) and V from shared memory as a transposed (MN-major)
//     operand spanning both 64-column boxes, so there is no ldmatrix.trans
//     and no shared-memory traffic per warp beyond what the tensor core
//     reads once for the warpgroup;
//   - masks are applied only on tiles that straddle the diagonal, the window
//     edge or S; a tile masked whole for a warpgroup is skipped;
//   - the exponentials are the next limit: the SM's special-function unit
//     does 16 ex2 a clock against 1024 bf16 FMAs of the tensor cores, so a
//     128x128 tile's softmax takes about half as long as its two products;
//     each p is one FFMA and one ex2.approx;
//   - the bytes are the third: a 128x128 tile pair reads 64 KB of K and V
//     through the L2 for 8.4 MFLOP, so the tensor cores' rate asks ~7.7 TB/s
//     of the L2 across the card;
//   - the query tile is the slowest grid dimension, heaviest first across
//     all heads and batches, so causal attention's light tiles fill the
//     last wave.
//   Output goes from registers to q's strides.
// * bfloat16, D = 16 or 32 -> `flash_mma_kernel` (FlashAttention-2 on
//   mma.sync.m16n8k16, 64x64 tiles, a 2-slot cp.async K/V ring): a wgmma
//   tile of 16 or 32 columns would waste most of each 128-byte swizzle row,
//   and no architecture the port serves has such heads at full size.
//
// Left for a later change: one K/V tile load serving the blocks of all the
// query heads of a GQA group (a cluster and TMA multicast; today each of the
// 8 query heads of a KV head at qwen2.5-3b's shape loads the same tiles),
// persistent blocks (one tile's epilogue and the next one's first loads
// under the products), the next tile's Q K^T issued before this tile's
// softmax (registers for two S tiles, given by a producer warpgroup that
// hands its registers over with setmaxnreg), and D = 16 / 32 on wgmma. Two
// consumer warpgroups taking turns at the tensor cores (named barriers) were
// tried and measured no faster (PERF.md).

#include "common.cuh"
#include "hopper.cuh"

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

// ---------------------------------------------------------------------------
// bfloat16 at D = 64 / 128 on wgmma, tiles by TMA (see the note at the top).
namespace wg {

constexpr int BM = 128;          // query rows a block, 64 a consumer warpgroup
constexpr int BN = 128;          // keys a KV tile
// K/V tile pairs in flight or in use (a third stage measured no faster)
constexpr int STAGES = 2;
constexpr int CONSUMERS = 2;     // consumer warpgroups
constexpr int PRODUCER = CONSUMERS * 4;           // the producer's warp index
constexpr int THREADS = CONSUMERS * 128 + 32;
constexpr int BOX = 64;          // columns a TMA box: one 128-byte swizzle row
constexpr int ROW = BOX * 2;     // bytes of a box row
// below any real logit in log2 units, above any masked one (NEG_INF times
// the scale): the running max of a row that has met no key yet
constexpr float NO_KEY = NEG_INF * 1e-10f;

template <int D> struct Cfg {
  static constexpr int BOXES = D / BOX;           // boxes across a row
  static constexpr int Q_BYTES = BM * D * 2;
  static constexpr int TILE = BN * D * 2;         // one K or one V tile
  // + 1 KB to align the tiles to the 1024-byte swizzle atom
  static constexpr int SMEM = 1024 + Q_BYTES + STAGES * 2 * TILE;
};

// S[64 x 128] (+)= A[64 x 16] B[16 x 128]: A and B from shared memory,
// both K-major; scale_d 0 overwrites S, 1 accumulates.
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t da,
                                                    uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// O[64 x N] += A[64 x 16] B[16 x N], N = 64 or 128: A from registers (the
// fragment of mma.sync's A, one 16-row slice a warp), B from shared memory
// MN-major (transposed: N within the row, 64 columns a swizzle atom, the
// atoms `lbo` bytes apart in the descriptor).
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_tb(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// One TMA box: `pos` packs the places (1..3) of the S, H and B dimensions in
// the map, which orders them by stride (`flash_map`).
__device__ __forceinline__ void load_box(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int pos, int col,
                                         int row, int head, int batch) {
  auto at = [&](int place) {
    return place == (pos & 3) ? row : place == ((pos >> 2) & 3) ? head : batch;
  };
  hopper::tma_load_4d(dst, map, bar, col, at(1), at(2), at(3));
}

}  // namespace wg

template <int D>
__global__ void __launch_bounds__(wg::THREADS, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   __nv_bfloat16* __restrict__ o, int S, int group,
                   int causal, int window, float scale_log2, int q_pos,
                   int k_pos, int v_pos, long long o_sb, long long o_sh,
                   long long o_ss) {
  using namespace hopper;
  using wg::load_box;
  using wg::NO_KEY;
  using wg::wgmma_m64n128k16_ss;
  using wg::wgmma_rs_tb;
  using C = wg::Cfg<D>;
  // wg's tile sizes, shadowing the 64-row tiles of the other two bodies
  constexpr int BM = wg::BM, BN = wg::BN, STAGES = wg::STAGES;
  constexpr int CONSUMERS = wg::CONSUMERS, BOX = wg::BOX, ROW = wg::ROW;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t q_full, full[STAGES], empty[STAGES];
  const uint32_t pad = (1024 - (smem_u32(smem_raw) & 1023)) & 1023;
  unsigned char* Qs = smem_raw + pad;             // [BOXES][BM][64] swizzled
  unsigned char* KV = Qs + C::Q_BYTES;            // stage s: K then V tile

  // the query tile is the slowest grid dimension, counted down: every
  // (head, batch) block of the heaviest tile is dispatched before any of
  // the next, so the light tiles fill the last wave
  const int qt = gridDim.z - 1 - blockIdx.z;
  const int h = blockIdx.x, b = blockIdx.y;
  const int hk = h / group;
  const int q0 = qt * BM;
  const int nkt = (S + BN - 1) / BN;
  const int q_last = min(q0 + BM, S) - 1;
  const int kt_hi = causal ? min(nkt, q_last / BN + 1) : nkt;
  int kt_lo = 0;
  if (window > 0 && q0 - window + 1 > 0) kt_lo = (q0 - window + 1) / BN;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    mbar_init(&q_full, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS * 4);        // one arrival a warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == wg::PRODUCER) {                     // aload, one lane
    if (lane == 0) {
      mbar_arrive_expect_tx(&q_full, C::Q_BYTES);
#pragma unroll
      for (int x = 0; x < C::BOXES; ++x)
        load_box(Qs + x * BM * ROW, &tq, &q_full, q_pos, x * BOX, q0, h, b);
      for (int kt = kt_lo, i = 0; kt < kt_hi; ++kt, ++i) {
        const int s = i % STAGES;
        mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);   // the slot is free
        mbar_arrive_expect_tx(&full[s], 2 * C::TILE);
        unsigned char* ks = KV + s * 2 * C::TILE;
#pragma unroll
        for (int x = 0; x < C::BOXES; ++x) {
          load_box(ks + x * BN * ROW, &tk, &full[s], k_pos, x * BOX, kt * BN,
                   hk, b);
          load_box(ks + C::TILE + x * BN * ROW, &tv, &full[s], v_pos,
                   x * BOX, kt * BN, hk, b);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wgi owns rows rlo .. rlo + 63 of the tile; in the
  // accumulators (the mma.sync C layout, one 16-row slice a warp) this
  // thread holds rows r0 = g and r1 = g + 8 of its warp's slice, columns
  // 8j + 2t and 8j + 2t + 1 of every 8-column block j
  const int wgi = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  const int rlo = q0 + wgi * 64;
  const int r0 = rlo + (warp & 3) * 16 + g, r1 = r0 + 8;
  const uint32_t q_addr = smem_u32(Qs) + wgi * 64 * ROW;

  float oacc[D / 2];                              // O: 64 x D a warpgroup
#pragma unroll
  for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;   // log2 units

  mbar_wait(&q_full, 0);
  for (int kt = kt_lo, i = 0; kt < kt_hi; ++kt, ++i) {
    const int s = i % STAGES;
    const int k0 = kt * BN;
    // a tile every key of which is masked for all 64 rows is skipped
    const bool dead = (causal && k0 > rlo + 63) ||
                      (window > 0 && k0 + BN - 1 <= rlo - window);
    mbar_wait(&full[s], (i / STAGES) & 1);        // getfin
    if (!dead) {
      const uint32_t k_addr = smem_u32(KV + s * 2 * C::TILE);
      const uint32_t v_addr = k_addr + C::TILE;

      // S = Q K^T: D / 16 k-steps, 4 in each 64-column box
      float sacc[64];
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const uint32_t off = (ks % 4) * 32;     // 16 columns, 32 bytes
        wgmma_m64n128k16_ss(
            sacc, wgmma_desc_sw128(q_addr + (ks / 4) * BM * ROW + off),
            wgmma_desc_sw128(k_addr + (ks / 4) * BN * ROW + off), ks > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sacc);

      // mask only where the tile straddles S, the diagonal or the window
      // edge; the max is taken on the raw logits (the scale is positive),
      // then p = 2^(s * scale * log2 e - m) is one FFMA and one ex2
      const bool edge = k0 + BN > S || (causal && k0 + BN - 1 > rlo) ||
                        (window > 0 && k0 <= rlo + 63 - window);
      if (edge) {
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int col = k0 + 8 * j + 2 * t + (c & 1);
            const int r = c < 2 ? r0 : r1;
            bool ok = col < S;
            if (causal) ok = ok && col <= r;
            if (window > 0) ok = ok && col > r - window;
            if (!ok) sacc[4 * j + c] = NEG_INF;
          }
      }
      float tmax0 = NEG_INF, tmax1 = NEG_INF;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        tmax0 = fmaxf(tmax0, fmaxf(sacc[4 * j], sacc[4 * j + 1]));
        tmax1 = fmaxf(tmax1, fmaxf(sacc[4 * j + 2], sacc[4 * j + 3]));
      }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {     // a row lives in a quad
        tmax0 = fmaxf(tmax0, __shfl_xor_sync(0xffffffffu, tmax0, off));
        tmax1 = fmaxf(tmax1, __shfl_xor_sync(0xffffffffu, tmax1, off));
      }
      const float mn0 = fmaxf(m0, tmax0 * scale_log2);
      const float mn1 = fmaxf(m1, tmax1 * scale_log2);
      const float alpha0 = fast_exp2(m0 - mn0), alpha1 = fast_exp2(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      // A row that has met no key yet has its max at the mask's level, where
      // the FFMA's unrounded product and the rounded max differ by ~1e22:
      // subtract 0 there, so that its masked p are 2^-1e29 = 0, not 2^1e22.
      const float sub0 = mn0 > NO_KEY ? mn0 : 0.f;
      const float sub1 = mn1 > NO_KEY ? mn1 : 0.f;
      float ps0 = 0.f, ps1 = 0.f;
      uint32_t pa[BN / 16][4];                    // P as wgmma's A fragments
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const float p0 = fast_exp2(fmaf(sacc[4 * j], scale_log2, -sub0));
        const float p1 = fast_exp2(fmaf(sacc[4 * j + 1], scale_log2, -sub0));
        const float p2 = fast_exp2(fmaf(sacc[4 * j + 2], scale_log2, -sub1));
        const float p3 = fast_exp2(fmaf(sacc[4 * j + 3], scale_log2, -sub1));
        ps0 += p0 + p1;
        ps1 += p2 + p3;
        // keys 16kk .. 16kk+15 are column blocks 2kk (a0, a1) and 2kk+1
        // (a2, a3), rows g (a0, a2) and g + 8 (a1, a3)
        pa[j / 2][(j & 1) * 2] = pack_bf16(p0, p1);
        pa[j / 2][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
      }
      l0 = l0 * alpha0 + ps0;                     // this lane's share
      l1 = l1 * alpha1 + ps1;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        oacc[4 * j] *= alpha0;
        oacc[4 * j + 1] *= alpha0;
        oacc[4 * j + 2] *= alpha1;
        oacc[4 * j + 3] *= alpha1;
      }

      // O += P V: BN / 16 k-steps of 16 keys (2048 bytes of each V box), one
      // instruction of N = D a step, the boxes BN * ROW bytes apart
      fence_regs(oacc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        wgmma_rs_tb(oacc, pa[kk],
                    wgmma_desc_sw128(v_addr + kk * 16 * ROW, BN * ROW));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(oacc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);        // this warp is done with s
  }

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  __nv_bfloat16* ob = o + b * o_sb + h * o_sh;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + 2 * t;
    if (r0 < S)
      *reinterpret_cast<uint32_t*>(ob + r0 * o_ss + col) =
          pack_bf16(oacc[4 * j] * inv0, oacc[4 * j + 1] * inv0);
    if (r1 < S)
      *reinterpret_cast<uint32_t*>(ob + r1 * o_ss + col) =
          pack_bf16(oacc[4 * j + 2] * inv1, oacc[4 * j + 3] * inv1);
  }
}

// The tensor map of a [B, H, S, D] bf16 operand with element strides (sb,
// sh, ss, 1): dims innermost first, D then the other three by ascending
// stride, so that the map is a packed order whatever the caller's layout
// (the model hands over [B, S, H, D] viewed as [B, H, S, D]). Boxes of 64
// columns x `rows` rows of one head of one batch. `pos` gets the places of S,
// H and B (2 bits each).
cudaError_t flash_map(CUtensorMap* map, const void* base, int D, int S, int H,
                      int B, long long sb, long long sh, long long ss,
                      int rows, int* pos) {
  struct Dim {
    long long stride;
    int size, box, which;
  } dim[3] = {{ss, S, rows, 0}, {sh, H, 1, 1}, {sb, B, 1, 2}};
  for (int i = 0; i < 3; ++i)
    for (int j = i + 1; j < 3; ++j)
      if (dim[j].stride < dim[i].stride) {
        const Dim tmp = dim[i];
        dim[i] = dim[j];
        dim[j] = tmp;
      }
  cuuint64_t dims[4] = {(cuuint64_t)D, 0, 0, 0}, strides[3];
  cuuint32_t box[4] = {(cuuint32_t)wg::BOX, 0, 0, 0};
  *pos = 0;
  for (int i = 0; i < 3; ++i) {
    dims[i + 1] = (cuuint64_t)dim[i].size;
    strides[i] = (cuuint64_t)dim[i].stride * 2;
    box[i + 1] = (cuuint32_t)dim[i].box;
    *pos |= (i + 1) << (2 * dim[i].which);
  }
  return hopper::encode_tensor_map_bf16(map, base, 4, dims, strides, box);
}

template <int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* o,
                         int B, int Hq, int Hkv, int S, int causal, int window,
                         float scale, const long long* st,
                         cudaStream_t stream) {
  static hopper::SmemAllowance allowance;
  auto kernel = flash_wgmma_kernel<D>;
  cudaError_t err = hopper::allow_smem(allowance, kernel, wg::Cfg<D>::SMEM);
  if (err != cudaSuccess) return err;
  CUtensorMap tq, tk, tv;
  int q_pos, k_pos, v_pos;
  if ((err = flash_map(&tq, q, D, S, Hq, B, st[0], st[1], st[2], wg::BM,
                       &q_pos)) != cudaSuccess ||
      (err = flash_map(&tk, k, D, S, Hkv, B, st[3], st[4], st[5], wg::BN,
                       &k_pos)) != cudaSuccess ||
      (err = flash_map(&tv, v, D, S, Hkv, B, st[6], st[7], st[8], wg::BN,
                       &v_pos)) != cudaSuccess)
    return err;
  dim3 grid(Hq, B, (S + wg::BM - 1) / wg::BM);   // query tiles last
  kernel<<<grid, wg::THREADS, wg::Cfg<D>::SMEM, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), S, Hq / Hkv, causal, window,
      scale * 1.4426950408889634f, q_pos, k_pos, v_pos, st[9], st[10],
      st[11]);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o,
                       int B, int Hq, int Hkv, int S, int causal, int window,
                       float scale, const long long* st, cudaStream_t stream) {
  static hopper::SmemAllowance allowance;
  auto kernel = flash_mma_kernel<D>;
  const size_t smem = MmaCfg<D>::SMEM;
  cudaError_t err = hopper::allow_smem(allowance, kernel, (int)smem);
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
  static hopper::SmemAllowance allowance;
  auto kernel = flash_fma_kernel<D>;
  const size_t smem = FmaCfg<D>::SMEM;
  cudaError_t err = hopper::allow_smem(allowance, kernel, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + BM - 1) / BM, Hq, B);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, Hq / Hkv,
      causal, window, scale, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], st[9], st[10], st[11]);
  return cudaGetLastError();
}

enum Body { BODY_NONE = -1, BODY_FMA = 0, BODY_WGMMA = 1, BODY_MMA = 2 };

// The fixed rule of the note at the top: float32 -> fma at every head size;
// bfloat16 -> wgmma at 64 and 128, mma.sync at 16 and 32.
Body body_for(int dtype, int D) {
  if (D != 16 && D != 32 && D != 64 && D != 128) return BODY_NONE;
  if (dtype == DTYPE_F32) return BODY_FMA;
  if (dtype == DTYPE_BF16) return D >= 64 ? BODY_WGMMA : BODY_MMA;
  return BODY_NONE;
}

}  // namespace

// The body `flash_attention_launch` runs for (dtype, D): 0 fma, 1 wgmma,
// 2 mma.sync, -1 none (the wrapper's `body_for` states the same rule).
extern "C" int flash_attention_body(int dtype, int D) {
  return static_cast<int>(body_for(dtype, D));
}

// q, o [B, Hq, S, D]; k, v [B, Hkv, S, D]; last stride 1, the others given in
// elements as strides = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
// o_sb, o_sh, o_ss}, multiples of 8 (16 bytes), starts 16-byte aligned.
// Returns 0 or a cudaError_t; -1 for a head size or type it does not take.
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
  switch (body_for(dtype, D)) {
    case BODY_FMA:
      switch (D) {
        FLASH_CASE(launch_fma, 16);
        FLASH_CASE(launch_fma, 32);
        FLASH_CASE(launch_fma, 64);
        FLASH_CASE(launch_fma, 128);
      }
      break;
    case BODY_WGMMA:
      switch (D) {
        FLASH_CASE(launch_wgmma, 64);
        FLASH_CASE(launch_wgmma, 128);
      }
      break;
    case BODY_MMA:
      switch (D) {
        FLASH_CASE(launch_mma, 16);
        FLASH_CASE(launch_mma, 32);
      }
      break;
    case BODY_NONE:
      break;
  }
  return -1;
#undef FLASH_CASE
}
