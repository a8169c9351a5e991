// K9: the FRExt transform-size decision of a P picture, for Hopper (sm_90a).
//
// Replaces h264_tpu/encoder/rd.py:1071-1113, the T8 stage of
// `rd_p_pipeline` (lencod transform8x8.c:1452 Mode_Decision_for_8x8
// Transform): every MB's winning luma prediction is re-coded with the 8x8
// transform and kept when
//   D_8 + lambda (cb8 + 1) < D_4 + lambda (cb4 + 1)
// (strictly: a tie keeps 4x4), for inter, non-skip winners whose units are
// all at least 8x8.  Plain version: h264_tpu_torch/encoder/rd_p.py
// `t8_decide_plain`; wrapper kernels/t8.py.
//
// Per MB: the residual orig - pred, the forward 8x8 butterflies of its four
// 8x8 blocks (along x, then along y, with the reference's >>1 / >>2: the
// two passes do not commute), quant with the inter offset 342 << (5 + qp/6)
// and the sign kept, dequant rshift_rnd_sf((lev * normAdjust8 * 16) <<
// qp/6, 6), the inverse butterflies and the recon (rr + (pred << 6) + 32)
// >> 6 clipped to 0..255; then D_8 and D_4 (the SSD of the 8x8 recon and of
// the 4x4 winner's recon), cb8 (2 bitlen(|l|) + 2 per nonzero level, 4 per
// nonzero 8x8 block) and cb4 (`_coef_bits` of every 4x4 block of the
// winner's levels), and the decision with `_lam_cost`'s split product.
// Exactness: int32 arithmetic with arithmetic right shifts on negative
// intermediates (nvcc's `>>` on int), products formed unsigned (common.cuh
// `mul`, `shl`).  Levels stay below 8192 (|level| <= 3264: the DC of a
// +-255 residual at QP 0), where `bitlen` equals the reference's float32
// form.  Integer sums in shared memory with atomics are exact in any order.
//
// Design.  One block of 256 threads per MB, one thread per sample of the
// MB in the 8x8 levels' order (thread t: block t >> 6, row (t >> 3) & 7,
// column t & 7), so the levels are written coalesced.  Each pass is one
// shared-memory step: every thread reads its row (or column) segment of 8
// samples, runs the 8-point butterfly and keeps its own output.  Thread 0
// decides; every thread then writes its level, 4x4 level and recon sample.
//
// Bound.  Bytes: orig, pred, the 4x4 recon and levels read once; the 8x8
// levels, the 4x4 levels and the recon written once (about 2.85 MB per
// CIF picture), which lead.  Operations: the function needs about 37
// integer operations per sample (the 8-point butterflies of two forward
// and two inverse passes, quant, dequant, recon, two SSD terms, the
// bits); this kernel takes about 230 as written (every thread of a row or
// column computes its whole butterfly of ~40, and the shared sums).

#include "common.cuh"

namespace {

constexpr int kCSkip = 4, kCP8x8 = 3;  // winner codes (rd_p.C_SKIP, C_P8x8)

// encoder MF8 (quant) and normAdjust8x8 (dequant) per qp%6 and position
// class (ops/quant.py _M8, _V8)
__constant__ int kM8[6][6] = {
    {13107, 11428, 20972, 12222, 16777, 15481},
    {11916, 10826, 19174, 11058, 14980, 14290},
    {10082, 8943, 15978, 9675, 12710, 11985},
    {9362, 8228, 14913, 8931, 11984, 11259},
    {8192, 7346, 13159, 7740, 10486, 9777},
    {7282, 6428, 11570, 6830, 9118, 8640}};
__constant__ int kV8[6][6] = {
    {20, 18, 32, 19, 25, 24}, {22, 19, 35, 21, 28, 26},
    {26, 23, 42, 24, 33, 31}, {28, 25, 45, 26, 35, 33},
    {32, 28, 51, 30, 40, 38}, {36, 32, 58, 34, 46, 43}};

// position class of (row i, column j) of an 8x8 block (ops/quant.py _class8)
__device__ __forceinline__ int cls8(int i, int j) {
  if ((i & 3) == 0 && (j & 3) == 0) return 0;
  if ((i & 1) && (j & 1)) return 1;
  if ((i & 3) == 2 && (j & 3) == 2) return 2;
  if (((i & 3) == 0 && (j & 1)) || ((i & 1) && (j & 3) == 0)) return 3;
  if (((i & 3) == 0 && (j & 3) == 2) || ((i & 3) == 2 && (j & 3) == 0)) return 4;
  return 5;
}

// output k of the forward 8-point butterfly (ops/transforms.py _fwd8_1d)
__device__ int fwd8_at(const int* p, int k) {
  const int s0 = p[0] + p[7], s1 = p[1] + p[6], s2 = p[2] + p[5],
            s3 = p[3] + p[4];
  const int b0 = s0 + s3, b1 = s1 + s2, b2 = s0 - s3, b3 = s1 - s2;
  const int d0 = p[0] - p[7], d1 = p[1] - p[6], d2 = p[2] - p[5],
            d3 = p[3] - p[4];
  const int b4 = d1 + d2 + ((d0 >> 1) + d0);
  const int b5 = d0 - d3 - ((d2 >> 1) + d2);
  const int b6 = d0 + d3 - ((d1 >> 1) + d1);
  const int b7 = d1 - d2 + ((d3 >> 1) + d3);
  const int o[8] = {b0 + b1,  b4 + (b7 >> 2), b2 + (b3 >> 1), b5 + (b6 >> 2),
                    b0 - b1,  b6 - (b5 >> 2), (b2 >> 1) - b3, (b4 >> 2) - b7};
  int r = o[0];
#pragma unroll
  for (int q = 1; q < 8; ++q) r = q == k ? o[q] : r;
  return r;
}

// output k of the inverse 8-point butterfly (ops/transforms.py _inv8_1d)
__device__ int inv8_at(const int* p, int k) {
  const int a0 = p[0] + p[4], a4 = p[0] - p[4];
  const int a2 = (p[2] >> 1) - p[6], a6 = p[2] + (p[6] >> 1);
  const int b0 = a0 + a6, b2 = a4 + a2, b4 = a4 - a2, b6 = a0 - a6;
  const int a1 = -p[3] + p[5] - p[7] - (p[7] >> 1);
  const int a3 = p[1] + p[7] - p[3] - (p[3] >> 1);
  const int a5 = -p[1] + p[7] + p[5] + (p[5] >> 1);
  const int a7 = p[3] + p[5] + p[1] + (p[1] >> 1);
  const int b1 = a1 + (a7 >> 2), b7 = a7 - (a1 >> 2);
  const int b3 = a3 + (a5 >> 2), b5 = (a3 >> 2) - a5;
  const int o[8] = {b0 + b7, b2 + b5, b4 + b3, b6 + b1,
                    b6 - b1, b4 - b3, b2 - b5, b0 - b7};
  int r = o[0];
#pragma unroll
  for (int q = 1; q < 8; ++q) r = q == k ? o[q] : r;
  return r;
}

// one separable pass over the MB's four 8x8 blocks: `dst` at this
// thread's sample (y, x) gets output `k` of the butterfly over its row
// segment (along x, `col` false) or column segment (along y) of `src`
template <bool kFwd>
__device__ __forceinline__ int pass(const int* src, int y, int x, bool col) {
  int v[8];
  if (col) {
    const int top = 16 * (y & 8) + x;
#pragma unroll
    for (int q = 0; q < 8; ++q) v[q] = src[top + 16 * q];
  } else {
    const int left = 16 * y + (x & 8);
#pragma unroll
    for (int q = 0; q < 8; ++q) v[q] = src[left + q];
  }
  const int k = col ? (y & 7) : (x & 7);
  return kFwd ? fwd8_at(v, k) : inv8_at(v, k);
}

__global__ void __launch_bounds__(256)
t8_kernel(const int* __restrict__ orig, const int* __restrict__ pred,
          const int* __restrict__ rec4, const int* __restrict__ lev4,
          const int* __restrict__ win, const int* __restrict__ sub,
          const unsigned char* __restrict__ intra, int qp, int lam,
          int* t8_out, int* lev8_out, int* lev4_out, int* rec_out) {
  __shared__ int sa[256], sb[256];  // MB samples, raster
  __shared__ int s_d8, s_d4, s_cb8, s_nz8[4], s_lb4[16], s_n4[16], s_use;
  const int mb = blockIdx.x, t = threadIdx.x;
  const int y = 8 * (t >> 7) + ((t >> 3) & 7), x = 8 * ((t >> 6) & 1) + (t & 7);
  const int pix = 16 * y + x;
  const size_t base = (size_t)mb * 256;
  if (t < 16) {
    s_lb4[t] = 0;
    s_n4[t] = 0;
  }
  if (t < 4) s_nz8[t] = 0;
  if (t == 0) {
    s_d8 = 0;
    s_d4 = 0;
    s_cb8 = 0;
  }
  const int o = orig[base + pix], p = pred[base + pix];
  sa[pix] = o - p;
  __syncthreads();
  sb[pix] = pass<true>(sa, y, x, false);
  __syncthreads();
  const int c = pass<true>(sb, y, x, true);
  const int per = qp / 6, rem = qp % 6, cl = cls8(y & 7, x & 7);
  const int lev = quant(c, kM8[rem][cl], 342 << (5 + per), 16 + per);
  sa[pix] = (shl(mul(lev, kV8[rem][cl] * 16), per) + 32) >> 6;
  __syncthreads();
  sb[pix] = pass<false>(sa, y, x, false);
  __syncthreads();
  const int rr = pass<false>(sb, y, x, true);
  const int r8 = clip255((rr + shl(p, 6) + 32) >> 6);
  const int r4 = rec4[base + pix], l4 = lev4[base + t];
  const int e8 = o - r8, e4 = o - r4;
  atomicAdd(&s_d8, e8 * e8);
  atomicAdd(&s_d4, e4 * e4);
  if (lev != 0) {
    atomicAdd(&s_cb8, 2 * bitlen(abs(lev)) + 2);
    atomicOr(&s_nz8[t >> 6], 1);
  }
  if (l4 != 0) {  // 4x4 block t >> 4 of the (br, bc, y, x) level layout
    atomicAdd(&s_lb4[t >> 4], 2 * bitlen(abs(l4)) + 1);
    atomicAdd(&s_n4[t >> 4], 1);
  }
  __syncthreads();
  if (t == 0) {
    int cb8 = s_cb8, cb4 = 0;
    for (int b = 0; b < 4; ++b) cb8 += s_nz8[b] ? 4 : 0;
    for (int b = 0; b < 16; ++b)
      cb4 += s_n4[b] > 0 ? s_lb4[b] + s_n4[b] + 2 : 0;
    const int w = win[mb];
    bool ok = intra[mb] == 0 && w != kCSkip;
    if (w == kCP8x8)
      for (int u = 0; u < 4; ++u) ok = ok && sub[4 * mb + u] == 0;
    s_use = ok && s_d8 + lam_cost(lam, cb8 + 1) < s_d4 + lam_cost(lam, cb4 + 1);
    t8_out[mb] = s_use;
  }
  __syncthreads();
  const bool use = s_use != 0;
  lev8_out[base + t] = use ? lev : 0;
  lev4_out[base + t] = use ? 0 : l4;
  rec_out[base + pix] = use ? r8 : r4;
}

}  // namespace

extern "C" int t8_decide(const int* orig, const int* pred, const int* rec4,
                         const int* lev4, const int* win, const int* sub,
                         const unsigned char* intra, int n_mb, int qp, int lam,
                         int* t8, int* lev8, int* lev4_out, int* rec_out,
                         void* stream) {
  t8_kernel<<<n_mb, 256, 0, (cudaStream_t)stream>>>(
      orig, pred, rec4, lev4, win, sub, intra, qp, lam, t8, lev8, lev4_out,
      rec_out);
  return (int)cudaGetLastError();
}
