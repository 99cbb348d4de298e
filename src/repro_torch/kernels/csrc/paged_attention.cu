// paged_attention: single-token decode attention over a contiguous KV cache
// with a valid prefix per sequence.
//
// Replaces the TPU kernel `_paged_kernel` / `paged_attention` of
// src/repro/kernels/paged_attention.py. There the page axis is a sequential
// grid axis that carries (m, l, acc) in scratch from one page to the next.
// CUDA blocks run in no order and share nothing, so here the cache is cut
// into splits of at most one page: block (split, kv-head, b) walks the rows of
// its split in a loop and writes a partial (m, l, acc) per query head, and a
// second small kernel merges the partials of a head and divides by
// max(l, 1e-30).
//
// Bound on this card: bytes. Every valid K and V row is read once and used
// for one dot product and one update per query head of the group (G = 8 at
// full width), far below the operations per byte the card needs to be compute
// bound. So the design is about bytes: one block serves the whole GQA group so
// K and V are read once per KV head, not once per query head; rows past
// lengths[b] are never touched; each lane reads its share of a row as one
// vector and a warp reads a whole row as one contiguous run; each warp issues
// the loads of its next row before it computes on the current one (issue
// early, wait late); the cache is read in place through its strides, whatever
// T is, so nothing is padded or copied.
//
// Arithmetic is fp32 FMAs with fp32 (m, l, acc) and expf for fp32 and bf16
// inputs alike; the output is cast to the input type.

#include "common.cuh"

namespace {

using namespace repro;

constexpr int GC = 8;      // query heads of one KV group served by one block
constexpr int NWARP = 4;   // warps per block; each takes every NWARP-th row

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T, int D>
__global__ void __launch_bounds__(NWARP * 32)
paged_partial_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const int* __restrict__ lengths,
                     float* __restrict__ part_acc, float* __restrict__ part_m,
                     float* __restrict__ part_l, int Hq, int G, int T_len,
                     int nsplit, int rows_per_split, long long q_sb,
                     long long q_sh, long long k_sb, long long k_st,
                     long long k_sh, long long v_sb, long long v_st,
                     long long v_sh, float scale) {
  constexpr int EPL = (D >= 32) ? D / 32 : 1;   // elements per lane
  const int split = blockIdx.x;
  const int ngc = (G + GC - 1) / GC;
  const int hkv = blockIdx.y / ngc;
  const int g0 = (blockIdx.y % ngc) * GC;
  const int gn = min(GC, G - g0);
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int d0 = lane * EPL;
  const bool active = d0 < D;

  const int len = min(lengths[b], T_len);
  const int t0 = split * rows_per_split;
  const int t1 = min(t0 + rows_per_split, len);

  float qr[GC][EPL];
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    if (g < gn && active) {
      load_vec<T, EPL>(q + b * q_sb + (long long)(hkv * G + g0 + g) * q_sh + d0,
                       qr[g]);
    } else {
#pragma unroll
      for (int e = 0; e < EPL; ++e) qr[g][e] = 0.f;
    }
  }

  float m[GC], l[GC], acc[GC][EPL];
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;
  }

  const T* kb = k + b * k_sb + hkv * k_sh + d0;
  const T* vb = v + b * v_sb + hkv * v_sh + d0;
  float kc[EPL], vc[EPL], kn[EPL], vn[EPL];
#pragma unroll
  for (int e = 0; e < EPL; ++e) kc[e] = vc[e] = kn[e] = vn[e] = 0.f;

  int t = t0 + warp;
  if (t < t1 && active) {
    load_vec<T, EPL>(kb + t * k_st, kc);
    load_vec<T, EPL>(vb + t * v_st, vc);
  }
  for (; t < t1; t += NWARP) {
    const int tn = t + NWARP;
    if (tn < t1 && active) {            // issue the next row's loads early
      load_vec<T, EPL>(kb + tn * k_st, kn);
      load_vec<T, EPL>(vb + tn * v_st, vn);
    }
    float s[GC];
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      float d = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) d = fmaf(qr[g][e], kc[e], d);
      s[g] = d;
    }
#pragma unroll
    for (int g = 0; g < GC; ++g) s[g] = warp_sum(s[g]) * scale;
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      const float m_new = fmaxf(m[g], s[g]);
      const float alpha = expf(m[g] - m_new);
      const float p = expf(s[g] - m_new);
      l[g] = l[g] * alpha + p;
#pragma unroll
      for (int e = 0; e < EPL; ++e)
        acc[g][e] = fmaf(p, vc[e], acc[g][e] * alpha);
      m[g] = m_new;
    }
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      kc[e] = kn[e];
      vc[e] = vn[e];
    }
  }

  // merge the warps' running states; a warp that saw no row holds
  // (NEG_INF, 0, 0) and gets weight 0 (or 1 times zeros if none saw a row)
  __shared__ float sm_m[NWARP][GC];
  __shared__ float sm_l[NWARP][GC];
  __shared__ float sm_acc[NWARP][GC][D];
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    if (lane == 0) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
    if (active) {
#pragma unroll
      for (int e = 0; e < EPL; ++e) sm_acc[warp][g][d0 + e] = acc[g][e];
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < gn * D; idx += NWARP * 32) {
    const int g = idx / D, d = idx % D;
    float mx = sm_m[0][g];
#pragma unroll
    for (int w = 1; w < NWARP; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float ls = 0.f, as = 0.f;
#pragma unroll
    for (int w = 0; w < NWARP; ++w) {
      const float wgt = expf(sm_m[w][g] - mx);
      ls = fmaf(sm_l[w][g], wgt, ls);
      as = fmaf(sm_acc[w][g][d], wgt, as);
    }
    const long long row =
        ((long long)b * Hq + (hkv * G + g0 + g)) * nsplit + split;
    part_acc[row * D + d] = as;
    if (d == 0) {
      part_m[row] = mx;
      part_l[row] = ls;
    }
  }
}

// out[b, hq, :] from the nsplit partials of that head.
template <typename T>
__global__ void paged_reduce_kernel(const float* __restrict__ part_acc,
                                    const float* __restrict__ part_m,
                                    const float* __restrict__ part_l,
                                    T* __restrict__ out, int nsplit, int D) {
  const long long row = (long long)blockIdx.y * gridDim.x + blockIdx.x;
  const float* pm = part_m + row * nsplit;
  const float* pl = part_l + row * nsplit;
  float mx = NEG_INF;
  for (int s = 0; s < nsplit; ++s) mx = fmaxf(mx, pm[s]);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float ls = 0.f, as = 0.f;
    for (int s = 0; s < nsplit; ++s) {
      const float wgt = expf(pm[s] - mx);
      ls = fmaf(pl[s], wgt, ls);
      as = fmaf(part_acc[(row * nsplit + s) * D + d], wgt, as);
    }
    out[row * D + d] = from_float<T>(as / fmaxf(ls, 1e-30f));
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* lengths, void* out, float* part_acc,
                   float* part_m, float* part_l, int B, int Hq, int Hkv,
                   int T_len, int nsplit, int rows_per_split,
                   const long long* st, float scale, cudaStream_t stream) {
  const int G = Hq / Hkv;
  const int ngc = (G + GC - 1) / GC;
  dim3 grid(nsplit, Hkv * ngc, B);
  paged_partial_kernel<T, D><<<grid, NWARP * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, part_acc, part_m, part_l, Hq, G,
      T_len, nsplit, rows_per_split, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  paged_reduce_kernel<T><<<dim3(Hq, B), 128, 0, stream>>>(
      part_acc, part_m, part_l, static_cast<T*>(out), nsplit, D);
  return cudaGetLastError();
}

}  // namespace

// q [B, Hq, D] (strides q_sb, q_sh, 1), k/v [B, T, Hkv, D] (strides sb, st,
// sh, 1), lengths [B] int32, out [B, Hq, D] contiguous; part_acc
// [B, Hq, nsplit, D], part_m and part_l [B, Hq, nsplit] fp32 scratch.
// strides: {q_sb, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh} in elements.
// Returns 0 or a cudaError_t; -1 for a head size or type it does not take.
extern "C" int paged_attention_launch(
    const void* q, const void* k, const void* v, const void* lengths,
    void* out, void* part_acc, void* part_m, void* part_l, int B, int Hq,
    int Hkv, int T_len, int D, int nsplit, int rows_per_split,
    const long long* strides, float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PAGED_CASE(TYPE, DIM)                                                 \
  return static_cast<int>(launch<TYPE, DIM>(                                  \
      q, k, v, static_cast<const int*>(lengths), out,                         \
      static_cast<float*>(part_acc), static_cast<float*>(part_m),             \
      static_cast<float*>(part_l), B, Hq, Hkv, T_len, nsplit, rows_per_split, \
      strides, scale, s))
#define PAGED_DIMS(TYPE)                \
  switch (D) {                          \
    case 16: PAGED_CASE(TYPE, 16);      \
    case 32: PAGED_CASE(TYPE, 32);      \
    case 64: PAGED_CASE(TYPE, 64);      \
    case 128: PAGED_CASE(TYPE, 128);    \
    default: return -1;                 \
  }
  if (dtype == DTYPE_F32) {
    PAGED_DIMS(float)
  } else if (dtype == DTYPE_BF16) {
    PAGED_DIMS(__nv_bfloat16)
  }
  return -1;
#undef PAGED_DIMS
#undef PAGED_CASE
}
