// K13: the quarter-pel refinement and the residual coding of the legacy P
// picture, for Hopper (sm_90a).
//
// Replaces h264_tpu/encoder/fast.py:160-296 (inside `_p_frame_core`, the
// jitted `p_frame_pipeline` / `p_frame_device`).  Per MB, from its integer
// vector (K12):
//   1. the 49 quarter-pel offsets of `_REFINE` (dy outer, dx inner, -3..3)
//      around it: the 16x16 prediction of each from the padded plane G and
//      the half-pel planes b, h, j (fast.py:166-192, the reference's 15
//      static window cases), its SSD plus lam_cost(lambda_me, bits(mvx) +
//      bits(mvy)); the first minimum by strict <;
//   2. luma: the residual, the 4x4 forward transform, inter quantization
//      (offset 342 << (4 + qp/6)), dequantization, the inverse transform and
//      the recon clipped to 0..255 (fast.py:231-240);
//   3. chroma, U and V: the 8x8 1/8-pel bilinear prediction from the 9x9
//      window at (mv >> 3) with fraction mv & 7 (arithmetic shift and mask,
//      as the reference on negative vectors), 4x4 forward transforms, the
//      2x2 Hadamard of the DC and its quantization, the AC quantization, the
//      dequantization (the DC one truncating), the inverse and the recon
//      (fast.py:246-293).
// Plain version: h264_tpu_torch/encoder/fast.py `refine_tq_plain`; wrapper
// kernels/p16.py `p16_refine`.
//
// Windows: b, h and j are 5 samples smaller than G and indexed 2 samples
// up and left of it (the reference's `iy - 2 + oy`); each plane is passed
// with its own row stride, so they may be views of a K2 bank (whose half-
// pel planes are the same samples shifted by 2).  Every window start is
// placed as the reference's dynamic_slice places it (a negative start plus
// the axis length, clamped); at R <= 28 none moves.
//
// Exactness: int32 throughout with wrapping products (the reference's
// "int64" casts run as int32 under JAX's default), arithmetic shifts; the
// SSD of a candidate is at most 256 * 255^2.
//
// Design.  One block of 256 threads per MB.  Candidates: each warp takes
// every eighth of the 49, each lane 8 of its 256 samples, a shuffle sum
// per candidate; thread 0 picks the winner.  Then every thread forms one
// luma prediction sample; 16 threads code the 4x4 blocks while 128 form
// the chroma predictions; 8 threads transform the chroma blocks, 2 code
// the DC and 8 the AC and the recon.
//
// Bound.  Bytes: the current planes and the planes' windows each MB's
// candidates read (at most 18 x 18 of G and of b, h and j, 9 x 9 of U and
// V per MB), the outputs once.  Operations: per candidate and sample the
// prediction (two reads, a rounded mean) and the squared error, 49 x 256
// per MB; the transform, quant and recon per sample.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCand = 49;

struct Plane {
  const int* p;
  int rows, cols, stride;
};

// where dynamic_slice starts a window of `size` on an axis of length L
// asked to start at s
__device__ __forceinline__ int slice_start(int s, int L, int size) {
  return clampi(s < 0 ? s + L : s, L - size);
}

// sample (r, c) of the 16x16 window of P asked to start at (sy, sx)
__device__ __forceinline__ int win(const Plane& P, int sy, int sx, int r,
                                   int c) {
  const int y = slice_start(sy, P.rows, 16) + r;
  const int x = slice_start(sx, P.cols, 16) + c;
  return P.p[(size_t)y * P.stride + x];
}

__device__ __forceinline__ int avg(int p, int q) { return (p + q + 1) >> 1; }

// sample (r, c) of the quarter-pel window at padded integer position
// (iy, ix) with the fraction (dx, dy): the reference's
// `qpel_window_static`, case by case
__device__ int qsample(const Plane& G, const Plane& B, const Plane& Hh,
                       const Plane& J, int iy, int ix, int dx, int dy, int r,
                       int c) {
  const int by = iy - 2, bx = ix - 2;
  if (dx == 0 && dy == 0) return win(G, iy, ix, r, c);
  if (dy == 0) {
    if (dx == 1) return avg(win(G, iy, ix, r, c), win(B, by, bx, r, c));
    if (dx == 2) return win(B, by, bx, r, c);
    return avg(win(B, by, bx, r, c), win(G, iy, ix + 1, r, c));
  }
  if (dx == 0) {
    if (dy == 1) return avg(win(G, iy, ix, r, c), win(Hh, by, bx, r, c));
    if (dy == 2) return win(Hh, by, bx, r, c);
    return avg(win(Hh, by, bx, r, c), win(G, iy + 1, ix, r, c));
  }
  if (dx == 2 && dy == 2) return win(J, by, bx, r, c);
  if (dx == 2)
    return dy == 1 ? avg(win(B, by, bx, r, c), win(J, by, bx, r, c))
                   : avg(win(J, by, bx, r, c), win(B, by + 1, bx, r, c));
  if (dy == 2)
    return dx == 1 ? avg(win(Hh, by, bx, r, c), win(J, by, bx, r, c))
                   : avg(win(J, by, bx, r, c), win(Hh, by, bx + 1, r, c));
  const int bb = dy == 1 ? win(B, by, bx, r, c) : win(B, by + 1, bx, r, c);
  const int hh = dx == 1 ? win(Hh, by, bx, r, c) : win(Hh, by, bx + 1, r, c);
  return avg(bb, hh);
}

struct Args {
  const int *cur_y, *cur_u, *cur_v, *int_mvx, *int_mvy;
  Plane G, B, Hh, J, U, V;
  int W, n_mx, qp, qp_c, lam;
  int *mvx, *mvy, *lev, *rec_y, *lev_c[2], *dc_c[2], *rec_c[2];
};

__global__ void __launch_bounds__(kThreads) p16_refine_kernel(const Args a) {
  __shared__ int orig[256], pred[256], cost[kCand], pick;
  __shared__ int cpred[2][64], cco[2][4][16], cdc[2][4], cdeq[2][4];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int mb = blockIdx.x, mbx = mb % a.n_mx, mby = mb / a.n_mx;
  const int y0 = 16 * mby, x0 = 16 * mbx, W = a.W, Wc = W / 2;
  const int bvx = a.int_mvx[mb], bvy = a.int_mvy[mb];
  const int iy0 = y0 + bvy + kPad, ix0 = x0 + bvx + kPad;

  orig[tid] = a.cur_y[(size_t)(y0 + (tid >> 4)) * W + x0 + (tid & 15)];
  __syncthreads();

  // 1. the 49 candidates: warp w takes k = w, w + 8, ...
  for (int k = warp; k < kCand; k += kThreads / 32) {
    const int ox = k % 7 - 3, oy = k / 7 - 3;
    const int iy = iy0 + (oy >> 2), ix = ix0 + (ox >> 2);
    int s = 0;
    for (int i = 0; i < 8; ++i) {
      const int t = lane + 32 * i, r = t >> 4, c = t & 15;
      const int e = orig[t] - qsample(a.G, a.B, a.Hh, a.J, iy, ix, ox & 3,
                                      oy & 3, r, c);
      s += e * e;
    }
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0)
      cost[k] = s + lam_cost(a.lam, mv_bits(bvx * 4 + ox) + mv_bits(bvy * 4 + oy));
  }
  __syncthreads();
  if (tid == 0) {
    int best = 0;
    for (int k = 1; k < kCand; ++k)
      if (cost[k] < cost[best]) best = k;
    pick = best;
  }
  __syncthreads();
  const int ox = pick % 7 - 3, oy = pick / 7 - 3;
  const int mvx = bvx * 4 + ox, mvy = bvy * 4 + oy;
  pred[tid] = qsample(a.G, a.B, a.Hh, a.J, iy0 + (oy >> 2), ix0 + (ox >> 2),
                      ox & 3, oy & 3, tid >> 4, tid & 15);
  if (tid == 0) {
    a.mvx[mb] = mvx;
    a.mvy[mb] = mvy;
  }
  __syncthreads();

  if (tid < 16) {
    // 2. luma: one 4x4 block per thread
    const int per = a.qp / 6, rem = a.qp % 6, off = 342 << (4 + per);
    const int by = tid >> 2, bx = tid & 3;
    int c[16], pb[16];
    for (int k = 0; k < 16; ++k) {
      const int t = 16 * (4 * by + (k >> 2)) + 4 * bx + (k & 3);
      pb[k] = pred[t];
      c[k] = orig[t] - pb[k];
    }
    forward4x4(c);
    const size_t blk = (size_t)(4 * mby + by) * (W / 4) + 4 * mbx + bx;
    for (int k = 0; k < 16; ++k) {
      const int l = quant(c[k], kM4[rem][cls4(k)], off, 15 + per);
      a.lev[blk * 16 + k] = l;
      c[k] = dequant(l, k, per, rem);
    }
    inverse4x4(c);
    for (int k = 0; k < 16; ++k)
      a.rec_y[(size_t)(y0 + 4 * by + (k >> 2)) * W + x0 + 4 * bx + (k & 3)] =
          clip255((c[k] + shl(pb[k], 6) + 32) >> 6);
  } else if (tid >= 64 && tid < 192) {
    // 3. chroma prediction: one sample of U or V per thread
    const int pl = (tid - 64) >> 6, s = (tid - 64) & 63, r = s >> 3, c = s & 7;
    const Plane& P = pl == 0 ? a.U : a.V;
    const int yi = slice_start(8 * mby + (mvy >> 3) + kPad, P.rows, 9) + r;
    const int xi = slice_start(8 * mbx + (mvx >> 3) + kPad, P.cols, 9) + c;
    const int fx = mvx & 7, fy = mvy & 7;
    const int* r0 = P.p + (size_t)yi * P.stride + xi;
    const int* r1 = r0 + P.stride;
    cpred[pl][s] = ((8 - fx) * (8 - fy) * r0[0] + fx * (8 - fy) * r0[1] +
                    (8 - fx) * fy * r1[0] + fx * fy * r1[1] + 32) >> 6;
  }
  __syncthreads();

  const int per = a.qp_c / 6, rem = a.qp_c % 6, off = 342 << (4 + per);
  const int pl = tid >> 2, cb = tid & 3, cby = cb >> 1, cbx = cb & 1;
  const int* cur_c = pl == 0 ? a.cur_u : a.cur_v;
  if (tid < 8) {
    int c[16];
    for (int k = 0; k < 16; ++k) {
      const int y = 4 * cby + (k >> 2), x = 4 * cbx + (k & 3);
      c[k] = cur_c[(size_t)(8 * mby + y) * Wc + 8 * mbx + x] - cpred[pl][8 * y + x];
    }
    forward4x4(c);
    for (int k = 0; k < 16; ++k) cco[pl][cb][k] = c[k];
    cdc[pl][cb] = c[0];
  }
  __syncthreads();
  if (tid < 2) {
    // the 2x2 DC Hadamard, its quantization, and its truncating dequant
    const int* d = cdc[tid];
    const int h[4] = {d[0] + d[1] + d[2] + d[3], d[0] - d[1] + d[2] - d[3],
                      d[0] + d[1] - d[2] - d[3], d[0] - d[1] - d[2] + d[3]};
    int l[4];
    for (int k = 0; k < 4; ++k) {
      l[k] = quant(h[k], kM4[rem][0], 2 * off, 16 + per);
      a.dc_c[tid][(size_t)mb * 4 + k] = l[k];
    }
    const int g[4] = {l[0] + l[1] + l[2] + l[3], l[0] - l[1] + l[2] - l[3],
                      l[0] + l[1] - l[2] - l[3], l[0] - l[1] - l[2] + l[3]};
    for (int k = 0; k < 4; ++k) {
      const int v = mul(g[k], kV4[rem][0] * 16);
      cdeq[tid][k] = per < 5 ? v >> (5 - per) : shl(v, per - 5);
    }
  }
  __syncthreads();
  if (tid < 8) {
    int c[16];
    const size_t blk = (size_t)(2 * mby + cby) * (Wc / 4) + 2 * mbx + cbx;
    for (int k = 0; k < 16; ++k) {
      const int l = k == 0 ? 0 : quant(cco[pl][cb][k], kM4[rem][cls4(k)], off, 15 + per);
      a.lev_c[pl][blk * 16 + k] = l;
      c[k] = k == 0 ? cdeq[pl][cb] : dequant(l, k, per, rem);
    }
    inverse4x4(c);
    for (int k = 0; k < 16; ++k) {
      const int y = 4 * cby + (k >> 2), x = 4 * cbx + (k & 3);
      a.rec_c[pl][(size_t)(8 * mby + y) * Wc + 8 * mbx + x] =
          clip255((c[k] + shl(cpred[pl][8 * y + x], 6) + 32) >> 6);
    }
  }
}

}  // namespace

// planes: cur_y (H, W), cur_u / cur_v (H/2, W/2) contiguous; G, b, h, j,
// U pad, V pad given as (pointer, rows, cols, row stride) each; int_mvx /
// int_mvy (H/16 * W/16).  Outputs (contiguous int32): mvx, mvy (n_mb), lev
// (H/4, W/4, 4, 4), rec_y (H, W), lev_u / lev_v (H/8, W/8, 4, 4), dc_u /
// dc_v (n_mb, 4), rec_u / rec_v (H/2, W/2).  Returns the CUDA error of the
// launch.
extern "C" int p16_refine(const int* cur_y, const int* cur_u,
                          const int* cur_v, int H, int W, const int* const* pl,
                          const int* dims, const int* int_mvx,
                          const int* int_mvy, int qp, int qp_c, int lam,
                          int* mvx, int* mvy, int* lev, int* rec_y,
                          int* lev_u, int* dc_u, int* rec_u, int* lev_v,
                          int* dc_v, int* rec_v, void* stream) {
  const int n_mx = W / 16, n_mb = (H / 16) * n_mx;
  if (n_mb == 0) return 0;
  Args a;
  a.cur_y = cur_y;
  a.cur_u = cur_u;
  a.cur_v = cur_v;
  a.int_mvx = int_mvx;
  a.int_mvy = int_mvy;
  Plane* ps[6] = {&a.G, &a.B, &a.Hh, &a.J, &a.U, &a.V};
  for (int i = 0; i < 6; ++i)
    *ps[i] = Plane{pl[i], dims[3 * i], dims[3 * i + 1], dims[3 * i + 2]};
  a.W = W;
  a.n_mx = n_mx;
  a.qp = qp;
  a.qp_c = qp_c;
  a.lam = lam;
  a.mvx = mvx;
  a.mvy = mvy;
  a.lev = lev;
  a.rec_y = rec_y;
  a.lev_c[0] = lev_u;
  a.lev_c[1] = lev_v;
  a.dc_c[0] = dc_u;
  a.dc_c[1] = dc_v;
  a.rec_c[0] = rec_u;
  a.rec_c[1] = rec_v;
  p16_refine_kernel<<<n_mb, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
