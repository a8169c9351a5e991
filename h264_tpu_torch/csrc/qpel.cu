// K4: quarter-pel luma and 1/8-pel chroma sampling from the reference
// banks of P and B pictures, for Hopper (sm_90a).
//
// Replaces, in h264_tpu/encoder/rd.py:
//   qpel_refine  `refine_unit` / `refine_parts` (rd.py:540-598, and the
//                sub-8x8 refinement :679-695): the 49-point quarter-pel
//                refinement of n units of one shape, SATD + lambda_satd *
//                mv bits, first minimum in `_REFINE` order (dy outer);
//   mc_luma      `_mc_luma_unit` (rd.py:145) and the skip prediction
//                (:848-864), weighted by the unit's reference when WP is on;
//   mc_chroma    `_mc_chroma_unit` (rd.py:159) as `chroma_pred_mb`
//                (:1040-1057) uses it: one 2x2 1/8-pel bilinear chroma
//                block per 4x4 luma block; chroma is never weighted;
//   mc_luma_win  `_dynfrac_mc` (rd.py:1911) of n h x w units, as the B
//                picture's L0-at-PMV candidate (:2277) uses it;
//   mc_chroma_b  the B picture's `chroma_pred_mb` (:2453-2470): per 8x8
//                luma unit one 4x4 chroma unit from each list
//                (`_mc_chroma_unit`, pad = PAD), averaged, or one list's.
// Plain versions: h264_tpu_torch/encoder/rd_p.py `qpel_refine_plain`,
// `mc_luma_plain`, `mc_chroma_plain`; rd_b.py `mc_luma_win_plain`,
// `mc_chroma_b_plain`; wrapper kernels/qpel.py.
//
// Design.  One __device__ sampler: a quarter-pel luma sample is the
// rounded mean of the two bank samples (planes G, b, h, j) that `_QTAB`
// picks for the mv's fraction; every coordinate is clamped to the bank,
// which equals the reference's reads from its edge-widened banks.  The B
// entries read the unwidened banks as the reference does, through the
// window samplers of qpel.cuh, which clamp each unit's window START (the
// unit's samples shift together), as `dynamic_slice` does.
// qpel_refine gives each unit a block of 256 threads: (candidate, 4x4
// block) pairs compute 16 predicted samples, the residual's Hadamard and
// its rounded half-sum; 49 threads add their candidate's blocks and the
// rate; the first minimum wins and the block writes its prediction.
// mc_luma, mc_chroma, mc_luma_win and mc_chroma_b give each output sample
// a thread.
//
// Bound.  qpel_refine: operations (49 candidates x the unit's samples x 8
// integer operations: the rounded mean, the residual, its Hadamard share
// and the absolute sum; WP once per window sample), and bank reads
// through L1/L2; mc_* move bytes.
//
// ptxas (sm_90a, nvcc -O3): refine_kernel 74 registers, 4,356 B shared
// memory; mc_luma_kernel / mc_chroma_kernel 20-24 registers; no spills.

#include "qpel.cuh"

namespace {

// quarter-pel sample at picture position (y, x) with mv (mvx, mvy) from one
// reference's (4, Hp, Wp) bank
__device__ __forceinline__ int qsample(const int* bank, int Hp, int Wp, int y,
                                       int x, int mvx, int mvy) {
  const int iy = y + (mvy >> 2) + kPad, ix = x + (mvx >> 2) + kPad;
  const int* t = kQtab[(mvy & 3) * 4 + (mvx & 3)];
  const size_t plane = (size_t)Hp * Wp;
  int a = bank[t[0] * plane + (size_t)clampi(iy + t[1], Hp - 1) * Wp +
               clampi(ix + t[2], Wp - 1)];
  int b = bank[t[3] * plane + (size_t)clampi(iy + t[4], Hp - 1) * Wp +
               clampi(ix + t[5], Wp - 1)];
  return (a + b + 1) >> 1;
}

constexpr int kRefineThreads = 256;

__global__ void __launch_bounds__(kRefineThreads)
refine_kernel(const int* __restrict__ banks, const int* __restrict__ cur_y,
              const int* __restrict__ ref, const int* __restrict__ imvx,
              const int* __restrict__ imvy, const int* __restrict__ y0s,
              const int* __restrict__ x0s, const int* __restrict__ pxs,
              const int* __restrict__ pys, const int* __restrict__ wp_w,
              const int* __restrict__ wp_o, int use_wp, int Hp, int Wp, int W,
              int lam_satd, int h, int w, int* out_mvx, int* out_mvy,
              int* out_pred, int* out_cost) {
  __shared__ int orig[256];
  __shared__ int satd4[49 * 16];
  __shared__ int cost[49];
  const int tid = threadIdx.x, u = blockIdx.x;
  const int r = ref[u], y0 = y0s[u], x0 = x0s[u];
  const int bx4 = w >> 2, nblk = (h >> 2) * bx4;
  const int bmvx = 4 * imvx[u], bmvy = 4 * imvy[u];
  const int* bank = banks + (size_t)r * 4 * Hp * Wp;
  const int ww = use_wp ? wp_w[r] : 32, wo = use_wp ? wp_o[r] : 0;
  for (int k = tid; k < h * w; k += kRefineThreads)
    orig[k] = cur_y[(size_t)(y0 + k / w) * W + x0 + k % w];
  __syncthreads();
  for (int task = tid; task < 49 * nblk; task += kRefineThreads) {
    const int c = task / nblk, blk = task % nblk;
    const int mvx = bmvx + c % 7 - 3, mvy = bmvy + c / 7 - 3;
    const int by = 4 * (blk / bx4), bx = 4 * (blk % bx4);
    int d[16];
    for (int k = 0; k < 16; ++k) {
      int y = by + (k >> 2), x = bx + (k & 3);
      int p = qsample(bank, Hp, Wp, y0 + y, x0 + x, mvx, mvy);
      if (use_wp) p = wp_affine(p, ww, wo);
      d[k] = orig[y * w + x] - p;
    }
    hadamard4x4(d);
    int s = 0;
    for (int k = 0; k < 16; ++k) s += abs(d[k]);
    satd4[task] = (s + 1) >> 1;
  }
  __syncthreads();
  if (tid < 49) {
    int s = 0;
    for (int blk = 0; blk < nblk; ++blk) s += satd4[tid * nblk + blk];
    const int mvx = bmvx + tid % 7 - 3, mvy = bmvy + tid / 7 - 3;
    cost[tid] = s + lam_cost(lam_satd, mv_bits(mvx - pxs[u]) +
                                           mv_bits(mvy - pys[u]));
  }
  __syncthreads();
  int best = 0;
  for (int c = 1; c < 49; ++c)
    if (cost[c] < cost[best]) best = c;
  const int mvx = bmvx + best % 7 - 3, mvy = bmvy + best / 7 - 3;
  for (int k = tid; k < h * w; k += kRefineThreads) {
    int p = qsample(bank, Hp, Wp, y0 + k / w, x0 + k % w, mvx, mvy);
    out_pred[(size_t)u * h * w + k] = use_wp ? wp_affine(p, ww, wo) : p;
  }
  if (tid == 0) {
    out_mvx[u] = mvx;
    out_mvy[u] = mvy;
    out_cost[u] = cost[best];
  }
}

__global__ void mc_luma_kernel(const int* __restrict__ banks,
                               const int* __restrict__ ref,
                               const int* __restrict__ mvx,
                               const int* __restrict__ mvy,
                               const int* __restrict__ y0s,
                               const int* __restrict__ x0s,
                               const int* __restrict__ wp_w,
                               const int* __restrict__ wp_o, int use_wp,
                               int Hp, int Wp, int n, int h, int w, int* out) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n * h * w) return;
  const int u = k / (h * w), s = k % (h * w);
  const int r = ref[u];
  int p = qsample(banks + (size_t)r * 4 * Hp * Wp, Hp, Wp, y0s[u] + s / w,
                  x0s[u] + s % w, mvx[u], mvy[u]);
  out[k] = use_wp ? wp_affine(p, wp_w[r], wp_o[r]) : p;
}

// output (n_mb, 2, 8, 8): chroma sample (yy, xx) of plane ch belongs to
// luma 4x4 block (yy >> 1, xx >> 1) of the MB, i.e. unit b8 and
// sub-position q, whose mv (1/8 chroma pel) and reference it uses
__global__ void mc_chroma_kernel(const int* __restrict__ cpads,
                                 const int* __restrict__ ref8,
                                 const int* __restrict__ mv4x,
                                 const int* __restrict__ mv4y, int n_mb,
                                 int n_mx, int Hcp, int Wcp, int* out) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n_mb * 128) return;
  const int mb = k >> 7, ch = (k >> 6) & 1, yy = (k >> 3) & 7, xx = k & 7;
  const int by = yy >> 1, bx = xx >> 1;
  const int b8 = 2 * (by >> 1) + (bx >> 1), q = 2 * (by & 1) + (bx & 1);
  const int r = ref8[mb * 4 + b8];
  const int mx = mv4x[(mb * 4 + b8) * 4 + q], my = mv4y[(mb * 4 + b8) * 4 + q];
  const int yi = 8 * (mb / n_mx) + yy + (my >> 3) + kPad;
  const int xi = 8 * (mb % n_mx) + xx + (mx >> 3) + kPad;
  const int fx = mx & 7, fy = my & 7;
  const int* P = cpads + ((size_t)r * 2 + ch) * Hcp * Wcp;
  const int y_0 = clampi(yi, Hcp - 1), y_1 = clampi(yi + 1, Hcp - 1);
  const int x_0 = clampi(xi, Wcp - 1), x_1 = clampi(xi + 1, Wcp - 1);
  out[k] = ((8 - fx) * (8 - fy) * P[(size_t)y_0 * Wcp + x_0] +
            fx * (8 - fy) * P[(size_t)y_0 * Wcp + x_1] +
            (8 - fx) * fy * P[(size_t)y_1 * Wcp + x_0] +
            fx * fy * P[(size_t)y_1 * Wcp + x_1] + 32) >> 6;
}

__global__ void mc_luma_win_kernel(const int* __restrict__ banks,
                                   const int* __restrict__ ref,
                                   const int* __restrict__ mvx,
                                   const int* __restrict__ mvy,
                                   const int* __restrict__ y0s,
                                   const int* __restrict__ x0s, int NR,
                                   int Hp, int Wp, int n, int h, int w,
                                   int* out) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n * h * w) return;
  const int u = k / (h * w), s = k % (h * w);
  const int r = slice_start(ref[u], NR, 1);
  out[k] = win_qsample(banks + (size_t)r * 4 * Hp * Wp, Hp, Wp, y0s[u],
                       x0s[u], h, w, mvx[u], mvy[u], s / w, s % w);
}

// output (n_mb, 2, 8, 8): chroma sample (yy, xx) of plane ch belongs to the
// 4x4 chroma unit of 8x8 luma unit b8 = 2 (yy >> 2) + (xx >> 2); list 0
// reads reference idx0 of cpads0, list 1 the anchor cpads1
__global__ void mc_chroma_b_kernel(
    const int* __restrict__ cpads0, const int* __restrict__ cpads1,
    const int* __restrict__ idx0, const int* __restrict__ m0x,
    const int* __restrict__ m0y, const int* __restrict__ m1x,
    const int* __restrict__ m1y, const unsigned char* __restrict__ u0,
    const unsigned char* __restrict__ u1, int NR0, int n_mb, int n_mx,
    int Hcp, int Wcp, int* out) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n_mb * 128) return;
  const int mb = k >> 7, ch = (k >> 6) & 1, yy = (k >> 3) & 7, xx = k & 7;
  const int b8 = 2 * (yy >> 2) + (xx >> 2), u = mb * 4 + b8;
  const int yc = 8 * (mb / n_mx) + 4 * (b8 >> 1);
  const int xc = 8 * (mb % n_mx) + 4 * (b8 & 1);
  const size_t plane = (size_t)Hcp * Wcp;
  const int r = slice_start(idx0[u], NR0, 1);
  const int c0 = win_csample(cpads0 + ((size_t)r * 2 + ch) * plane, Hcp, Wcp,
                             yc, xc, 4, 4, m0x[u], m0y[u], yy & 3, xx & 3);
  const int c1 = win_csample(cpads1 + ch * plane, Hcp, Wcp, yc, xc, 4, 4,
                             m1x[u], m1y[u], yy & 3, xx & 3);
  out[k] = (u0[u] && u1[u]) ? (c0 + c1 + 1) >> 1 : (u0[u] ? c0 : c1);
}

}  // namespace

extern "C" int qpel_refine(const int* banks, const int* cur_y, const int* ref,
                           const int* imvx, const int* imvy, const int* y0,
                           const int* x0, const int* px, const int* py,
                           const int* wp_w, const int* wp_o, int use_wp,
                           int n, int Hp, int Wp, int W, int lam_satd, int h,
                           int w, int* mvx, int* mvy, int* pred, int* cost,
                           void* stream) {
  refine_kernel<<<n, kRefineThreads, 0, (cudaStream_t)stream>>>(
      banks, cur_y, ref, imvx, imvy, y0, x0, px, py, wp_w, wp_o, use_wp, Hp,
      Wp, W, lam_satd, h, w, mvx, mvy, pred, cost);
  return (int)cudaGetLastError();
}

extern "C" int mc_luma(const int* banks, const int* ref, const int* mvx,
                       const int* mvy, const int* y0, const int* x0,
                       const int* wp_w, const int* wp_o, int use_wp, int n,
                       int Hp, int Wp, int h, int w, int* out, void* stream) {
  const int total = n * h * w;
  mc_luma_kernel<<<(total + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      banks, ref, mvx, mvy, y0, x0, wp_w, wp_o, use_wp, Hp, Wp, n, h, w, out);
  return (int)cudaGetLastError();
}

extern "C" int mc_chroma(const int* cpads, const int* ref8, const int* mv4x,
                         const int* mv4y, int n_mb, int n_mx, int Hcp, int Wcp,
                         int* out, void* stream) {
  const int total = n_mb * 128;
  mc_chroma_kernel<<<(total + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      cpads, ref8, mv4x, mv4y, n_mb, n_mx, Hcp, Wcp, out);
  return (int)cudaGetLastError();
}

extern "C" int mc_luma_win(const int* banks, const int* ref, const int* mvx,
                           const int* mvy, const int* y0, const int* x0,
                           int NR, int Hp, int Wp, int n, int h, int w,
                           int* out, void* stream) {
  const int total = n * h * w;
  mc_luma_win_kernel<<<(total + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      banks, ref, mvx, mvy, y0, x0, NR, Hp, Wp, n, h, w, out);
  return (int)cudaGetLastError();
}

extern "C" int mc_chroma_b(const int* cpads0, const int* cpads1,
                           const int* idx0, const int* m0x, const int* m0y,
                           const int* m1x, const int* m1y,
                           const unsigned char* u0, const unsigned char* u1,
                           int NR0, int n_mb, int n_mx, int Hcp, int Wcp,
                           int* out, void* stream) {
  const int total = n_mb * 128;
  mc_chroma_b_kernel<<<(total + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      cpads0, cpads1, idx0, m0x, m0y, m1x, m1y, u0, u1, NR0, n_mb, n_mx, Hcp,
      Wcp, out);
  return (int)cudaGetLastError();
}
