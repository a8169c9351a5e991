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
// qpel_refine, one template per shape, gives each block of 256 threads
// up to five units of one shape:
//   1. stages each unit's (4, h+2, w+2) window of the bank (every
//      coordinate clamped, as the sampler clamps each sample; no candidate
//      reads outside it: rows and columns imv - 1 .. imv + h (w)) and its
//      h x w source block in shared memory as bytes, with coalesced loads;
//   2. computes every distinct quarter-pel sample of the unit once, as 16
//      fraction planes of (h+1) x (w+1) (the (4h+3) x (4w+3) positions the
//      49 candidates reach, and a few more), four samples a thread: the
//      rounded byte means of the two tap rows `_QTAB` picks (__vavgu4),
//      then WP, which rounds and so stays after the mean;
//   3. runs the (unit, candidate, 4x4 block) tasks candidate-major, in
//      passes of 256 (nb = the shape's 4x4 blocks): 16 residuals from
//      the fraction plane and the source, the Hadamard and its rounded
//      half-sum; a candidate's nb blocks are nb aligned lanes of a warp,
//      summed with shuffles; its first lane adds the rate;
//   4. takes each unit's first minimum over its 49 costs in one warp, a
//      (cost, index) shuffle reduction in which the lower index wins ties;
//   5. writes the winners' predictions from the fraction planes.
// Lanes: u units x 49 x nb tasks over whole passes of 256 threads.  Five
// units keep 245 of 256 lanes busy (95.7 %) at every shape; the C entry
// takes five at 8x8 and smaller, and at 16x16, 16x8 and 8x16 as many as
// leave 4 blocks an SM (one at CIF, five at 1280x720), where any count
// keeps at least 196 of 256 (76.6 %) busy.
// mc_luma, mc_chroma, mc_luma_win and mc_chroma_b give each output sample
// a thread.
//
// Bound.  qpel_refine: operations (each distinct quarter-pel sample's mean
// once, a quarter each as __vavgu4 takes four, and WP once; per candidate
// sample its residual, Hadamard share and absolute sum, which fit 16 bits,
// two an instruction); mc_* move bytes.
//
// ptxas (sm_90a, nvcc -O3): refine_kernel 32-40 registers and 6,088
// (4x4) to 38,488 (16x16) B shared memory, so 5 (16x16) to 6 blocks of
// 256 fit on an SM; mc_* kernels 20-28 registers; no spills.

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
constexpr int kUnits = 5;  // the most units a block takes: 5 x 49 = 245

// What a block holds for its units of one H x W shape, as bytes (every
// bank and source sample is 0..255).  win: each unit's (4, H+2, W+2)
// window of the planes G, b, h, j from (y0 + imvy - 1, x0 + imvx - 1),
// rows WS bytes apart; q: its 16 fraction planes (fy * 4 + fx) of
// quarter-pel samples, sample (iy, ix) at integer offset (iy - 1, ix - 1),
// weighted when WP is on, rows QW bytes apart (W + 4: a candidate's 4x4
// blocks fall in distinct banks).  Both are words, filled and read as
// 4-byte chunks; aoff / boff: the byte offsets in a window of the two
// samples whose rounded mean is a fraction's sample (kQtab).
template <int H, int W>
struct RefineSmem {
  static constexpr int WS = W + 8, QW = W + 4;
  unsigned int win[kUnits][4][H + 2][WS / 4];
  unsigned int q[kUnits][16][H + 1][QW / 4];
  unsigned char orig[kUnits][H][W];
  int cost[kUnits][49];
  int aoff[16], boff[16];
  int wy[kUnits], wx[kUnits], imvx[kUnits], imvy[kUnits], y0[kUnits];
  int x0[kUnits], px[kUnits], py[kUnits], ww[kUnits], wo[kUnits];
  int best[kUnits];
  size_t base[kUnits];
};

// candidate c (dx = c % 7 - 3, dy = c / 7 - 3, `_REFINE` order): its
// fraction plane and the offset of its samples in it
__device__ __forceinline__ void cand_plane(int c, int& f, int& oy, int& ox) {
  const int dx = c % 7 - 3, dy = c / 7 - 3;
  f = (dy & 3) * 4 + (dx & 3);
  oy = (dy >> 2) + 1;
  ox = (dx >> 2) + 1;
}

// the 4 bytes at byte offset `off` of word-aligned shared memory `p`
__device__ __forceinline__ unsigned int bytes4(const unsigned int* p,
                                               int off) {
  const unsigned int* w = p + (off >> 2);
  return __funnelshift_r(w[0], w[1], (off & 3) * 8);
}

// WP on each of 4 packed samples
__device__ __forceinline__ unsigned int wp4(unsigned int m, int w, int o) {
  unsigned int r = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    r |= (unsigned int)wp_affine((m >> (8 * i)) & 255, w, o) << (8 * i);
  return r;
}

template <int H, int W>
__global__ void __launch_bounds__(kRefineThreads, 4)
refine_kernel(const int* __restrict__ banks, const int* __restrict__ cur_y,
              const int* __restrict__ ref, const int* __restrict__ imvx,
              const int* __restrict__ imvy, const int* __restrict__ y0s,
              const int* __restrict__ x0s, const int* __restrict__ pxs,
              const int* __restrict__ pys, const int* __restrict__ wp_w,
              const int* __restrict__ wp_o, int use_wp, int n, int units,
              int Hp, int Wp, int Wc, int lam_satd, int* out_mvx,
              int* out_mvy, int* out_pred, int* out_cost) {
  using Smem = RefineSmem<H, W>;
  constexpr int WS = Smem::WS, QW = Smem::QW;
  constexpr int BX = W / 4, NB = (H / 4) * BX;  // 4x4 blocks of a unit
  constexpr int WH = H + 2, WW = W + 2;         // a window plane
  constexpr int NCH = W / 4 + 1;  // 4-sample chunks of a fraction row
  constexpr int QCH = 16 * (H + 1) * NCH;  // chunks of a unit's planes
  __shared__ Smem s;
  const int tid = threadIdx.x, u0 = blockIdx.x * units;
  const int nu = min(units, n - u0);

  // the units' parameters (a partial block repeats its last unit) and
  // the taps' offsets in a window
  if (tid < units) {
    const int u = u0 + min(tid, nu - 1), r = ref[u];
    s.imvx[tid] = imvx[u];
    s.imvy[tid] = imvy[u];
    s.y0[tid] = y0s[u];
    s.x0[tid] = x0s[u];
    s.wy[tid] = y0s[u] + imvy[u] - 1 + kPad;
    s.wx[tid] = x0s[u] + imvx[u] - 1 + kPad;
    s.px[tid] = pxs[u];
    s.py[tid] = pys[u];
    s.ww[tid] = use_wp ? wp_w[r] : 32;
    s.wo[tid] = use_wp ? wp_o[r] : 0;
    s.base[tid] = (size_t)r * 4 * Hp * Wp;
  } else if (tid >= 32 && tid < 48) {
    const int* t = kQtab[tid - 32];
    s.aoff[tid - 32] = (t[0] * WH + t[1]) * WS + t[2];
    s.boff[tid - 32] = (t[3] * WH + t[4]) * WS + t[5];
  }
  __syncthreads();
  // stage every window (coordinates clamped to the bank, as each sample
  // of the plain version is) and every source block, once
  unsigned char* winb = reinterpret_cast<unsigned char*>(s.win);
  for (int k = tid; k < units * 4 * WH * WW; k += kRefineThreads) {
    const int row = k / WW, xx = k - row * WW;
    const int u = row / (4 * WH), pl = row % (4 * WH) / WH, yy = row % WH;
    const int gy = clampi(s.wy[u] + yy, Hp - 1), gx = clampi(s.wx[u] + xx, Wp - 1);
    winb[row * WS + xx] = banks[s.base[u] + ((size_t)pl * Hp + gy) * Wp + gx];
  }
  for (int k = tid; k < units * H * W; k += kRefineThreads) {
    const int u = k / (H * W), y = k % (H * W) / W, x = k % W;
    s.orig[u][y][x] = cur_y[(size_t)(s.y0[u] + y) * Wc + s.x0[u] + x];
  }
  __syncthreads();
  // every distinct quarter-pel sample once, four at a time: the rounded
  // byte means of the two tap rows (__vavgu4), then WP
  for (int k = tid; k < units * QCH; k += kRefineThreads) {
    const int u = k / QCH, e = k % QCH;
    const int f = e / ((H + 1) * NCH), iy = e / NCH % (H + 1), j = e % NCH;
    const unsigned int* w = &s.win[u][0][0][0];
    const int at = iy * WS + 4 * j;
    unsigned int m = __vavgu4(bytes4(w, s.aoff[f] + at), bytes4(w, s.boff[f] + at));
    if (use_wp) m = wp4(m, s.ww[u], s.wo[u]);
    s.q[u][f][iy][j] = m;
  }
  __syncthreads();
  // (unit, candidate, 4x4 block) tasks, candidate-major: a candidate's NB
  // blocks are NB aligned lanes of one warp, and a thread keeps its block
  // (256 is a multiple of NB) over the passes of 256 tasks
  const int blk = tid % NB, by = 4 * (blk / BX), bx = 4 * (blk % BX);
#pragma unroll 1
  for (int t0 = 0; t0 < units * 49 * NB; t0 += kRefineThreads) {
    const int uc = (t0 + tid) / NB;  // unit * 49 + candidate
    const bool live = uc < units * 49;
    const int u = live ? uc / 49 : 0, c = uc % 49;
    int sat = 0;
    if (live) {
      int f, oy, ox;
      cand_plane(c, f, oy, ox);
      const unsigned char* qb =
          reinterpret_cast<const unsigned char*>(&s.q[u][f][0][0]) +
          (by + oy) * QW + bx + ox;
      int d[16];
#pragma unroll
      for (int k = 0; k < 16; ++k)
        d[k] = s.orig[u][by + (k >> 2)][bx + (k & 3)] - qb[(k >> 2) * QW + (k & 3)];
      hadamard4x4(d);
#pragma unroll
      for (int k = 0; k < 16; ++k) sat += abs(d[k]);
      sat = (sat + 1) >> 1;
    }
#pragma unroll
    for (int off = NB / 2; off > 0; off >>= 1)
      sat += __shfl_xor_sync(0xffffffffu, sat, off);
    if (live && blk == 0) {
      const int mvx = 4 * s.imvx[u] + c % 7 - 3;
      const int mvy = 4 * s.imvy[u] + c / 7 - 3;
      s.cost[u][c] = sat + lam_cost(lam_satd, mv_bits(mvx - s.px[u]) +
                                                  mv_bits(mvy - s.py[u]));
    }
  }
  __syncthreads();
  // the first minimum of each unit: warp u reduces (cost, index) pairs,
  // the lower index winning ties (strict < in `_REFINE` order)
  const int warp = tid >> 5, lane = tid & 31;
  if (warp < units) {
    int bc = s.cost[warp][lane], bi = lane;
    if (lane + 32 < 49 && s.cost[warp][lane + 32] < bc) {
      bc = s.cost[warp][lane + 32];
      bi = lane + 32;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const int oc = __shfl_xor_sync(0xffffffffu, bc, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (oc < bc || (oc == bc && oi < bi)) {
        bc = oc;
        bi = oi;
      }
    }
    if (lane == 0) {
      s.best[warp] = bi;
      if (warp < nu) {
        out_mvx[u0 + warp] = 4 * s.imvx[warp] + bi % 7 - 3;
        out_mvy[u0 + warp] = 4 * s.imvy[warp] + bi / 7 - 3;
        out_cost[u0 + warp] = bc;
      }
    }
  }
  __syncthreads();
  // the winners' predictions, from the fraction planes
  for (int k = tid; k < nu * H * W; k += kRefineThreads) {
    const int u = k / (H * W), y = k % (H * W) / W, x = k % W;
    int f, oy, ox;
    cand_plane(s.best[u], f, oy, ox);
    out_pred[(size_t)u0 * H * W + k] =
        reinterpret_cast<const unsigned char*>(&s.q[u][f][0][0])[(y + oy) * QW + x + ox];
  }
}

// the first call's card's SM count, read once (it sets only how many
// units a block takes, never a result)
int sm_count() {
  static const int sms = [] {
    int dev = 0, n = 132;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n;
  }();
  return sms;
}

template <int H, int W>
int refine_launch(const int* banks, const int* cur_y, const int* ref,
                  const int* imvx, const int* imvy, const int* y0,
                  const int* x0, const int* px, const int* py,
                  const int* wp_w, const int* wp_o, int use_wp, int n, int Hp,
                  int Wp, int Wc, int lam_satd, int* mvx, int* mvy, int* pred,
                  int* cost, cudaStream_t stream) {
  // units per block: five (245 of 256 lanes busy) where that leaves four
  // blocks an SM or the shape is small (every unit count keeps 196 of
  // 256 lanes busy at 4 or more 4x4 blocks a unit); fewer at the large
  // shapes of small pictures, so that every SM gets blocks
  constexpr int NB = (H / 4) * (W / 4);
  const int units =
      NB <= 4 ? kUnits : max(1, min(kUnits, n / (4 * sm_count())));
  refine_kernel<H, W><<<(n + units - 1) / units, kRefineThreads, 0,
                        stream>>>(banks, cur_y, ref, imvx, imvy, y0, x0, px,
                                  py, wp_w, wp_o, use_wp, n, units, Hp, Wp,
                                  Wc, lam_satd, mvx, mvy, pred, cost);
  return (int)cudaGetLastError();
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
#define K4_SHAPE(HH, WW)                                                     \
  if (h == HH && w == WW)                                                    \
    return refine_launch<HH, WW>(banks, cur_y, ref, imvx, imvy, y0, x0, px,  \
                                 py, wp_w, wp_o, use_wp, n, Hp, Wp, W,       \
                                 lam_satd, mvx, mvy, pred, cost,             \
                                 (cudaStream_t)stream);
  K4_SHAPE(16, 16)
  K4_SHAPE(8, 16)
  K4_SHAPE(16, 8)
  K4_SHAPE(8, 8)
  K4_SHAPE(4, 8)
  K4_SHAPE(8, 4)
  K4_SHAPE(4, 4)
#undef K4_SHAPE
  return (int)cudaErrorInvalidValue;
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
