// K13: the quarter-pel refinement and the residual coding of the legacy P
// picture, for Hopper (sm_90a).
//
// Replaces h264_tpu/encoder/fast.py:160-296 (inside `_p_frame_core`, the
// jitted `p_frame_pipeline` / `p_frame_device`).  Per MB, from its integer
// vector (K12):
//   1. the 49 quarter-pel offsets of `_REFINE` (dy outer, dx inner, -3..3)
//      around it: the 16x16 prediction of each from the padded plane G and
//      the half-pel planes b, h, j (fast.py:166-192, the reference's 15
//      static window cases: one window, or the rounded mean of two), its
//      SSD plus lam_cost(lambda_me, bits(mvx) + bits(mvy)); the first
//      minimum by strict < in k order;
//   2. luma: the residual, the 4x4 forward transform, inter quantization
//      (offset 342 << (4 + qp/6)), dequantization, the inverse transform and
//      the recon clipped to 0..255 (fast.py:231-240);
//   3. chroma, U and V: the 8x8 1/8-pel bilinear prediction from the 9x9
//      window at (mv >> 3) with fraction mv & 7 (arithmetic shift and mask,
//      as the reference on negative vectors), 4x4 forward transforms, the
//      2x2 Hadamard of the DC and its quantization, the AC quantization, the
//      dequantization (the DC one truncating) and the recon
//      (fast.py:246-293).
// Plain version: h264_tpu_torch/encoder/fast.py `refine_tq_plain`; wrapper
// kernels/p16.py `p16_refine`.
//
// Windows.  b, h and j are 5 samples smaller than G and indexed 2 samples
// up and left of it (the reference's `iy - 2 + oy`); each plane comes with
// its own row stride, so they may be views of a K2 bank.  Every window
// starts where the reference's dynamic_slice puts it: a negative start
// plus the axis length, clamped to L - 16 (the chroma window to L - 9).
// The 49 candidates ask for windows at three consecutive starts an axis
// (the integer part -1 or 0, and the second window of a mean one further),
// so an MB whose middle starts lie in 1 .. L - 17 on both axes of every
// plane (`regular`) has no window that moves, and the windows of each
// plane lie in the 18 x 18 samples from one sample up and left of the
// middle one.  At R <= 28 every MB is regular; past that, and for any
// vector beyond the pad (the wrapper takes every int32 vector), a window
// can move at the picture's edges, wrap to the far side, or several
// starts can clamp to one.  Such an MB reads each of its window words
// from the plane at its window's own placed start instead; the pricing
// and the coding after that are the same code.
//
// Exactness: int32 with wrapping sums and products (the reference's
// "int64" casts run as int32 under JAX's default), arithmetic shifts.
// The samples are u8 (0..255, as the reference's planes): four a 32-bit
// word, byte b sample 4 w + b.  __vavgu4 is the rounded mean (p + q + 1)
// >> 1 of each byte; __vabsdiffu4 then __dp4a of the difference with
// itself is the squared error of four samples, exact since a candidate's
// SSD is at most 256 * 255^2 < 2^24.  The rate is bounded for every input
// the wrapper takes: mv_bits is 2 bitlen - 1 with bitlen in 0..32, so a
// candidate's bits lie in -2..126, and |lam >> 16| <= 2^15 keeps
// lam_cost in -2^22 - 2 .. 2^22 + 126; so a cost lies in (-2^25, 2^25),
// and the key cost * 64 + k (k < 64) fits int32 and orders the candidates
// as the reference's first minimum does.
//
// Design.  A warp an MB, as many MBs a block (2 to 4) as leave a block for
// each of an H100's 132 SMs.  Lane 2 blk + h holds rows 2h and 2h + 1 of
// the MB's 4x4 block blk = 4 br + bc: the word of columns 4 bc .. 4 bc + 3
// of each of its two rows, for every candidate, and then the lane form of
// the coding (tq_lanes.cuh).
//   A. A regular MB stages its four planes' 18 x 18 windows in shared
//      memory as packed u8 words (5 a row, 6 apart, so that the lanes'
//      loads of a row touch 32 banks), 32-bit indexing with each plane's
//      stride; each lane then takes the words of the 24 windows the
//      candidates use, two rows each, into registers by funnel shifts of
//      its staged words (another MB reads them at their placed starts).
//      Its two source words come in by 16-byte loads.  The branch holds
//      no warp collective, so the pricing after it is one copy.
//   B. Every candidate is static (template recursion over k): its word is
//      a window word, or __vavgu4 of two; the squared error is
//      __vabsdiffu4 and two __dp4a, the candidate's SSD one redux.sync.
//      Lane l keeps the SSDs of k = l and k = l + 32 and adds their rates
//      itself, making the keys cost * 64 + k; the warp's least key, one
//      redux.sync, is the first minimum.  The winner's two words a lane
//      are taken from its window words again by a branch tree on that
//      warp-uniform k (six uniform branches, then at most a __vavgu4 a
//      word): nothing is read from memory for them.
//   C. Luma in the lane form: residual, forward, quant, dequant, inverse,
//      recon; the levels and the recon leave as 16-byte stores.  Chroma on
//      16 lanes (bit 3 the plane, bits 1-2 the block, bit 0 h; lanes 16-31
//      repeat them unstored), each lane's 3 x 5 window samples read once
//      the vector is known, the DC's 2x2 Hadamard by xor shuffles
//      (hadamard_blocks), its quant, Hadamard and truncating dequant.
// One __syncwarp after the staging; no block barrier, no serial thread.
//
// What held the first kernel back.  It ran one block of 256 threads an
// MB: every sample of the 49 candidates went through a function that
// placed up to two windows with their clamps and read G, b, h and j from
// global memory as int32 (49 x 256 x 1-2 loads an MB); one warp took every
// eighth candidate, thread 0 picked the winner serially and the winner's
// prediction was formed again from global memory; then 16 of the 256
// threads coded the luma 4x4 blocks in int[16] arrays, 8 the chroma
// blocks, 2 the DC, behind six __syncthreads.  At CIF its 396 blocks were
// one wave, and the time the chain of those phases (0.0301 ms on the
// device, 0.1997 at 1280x720; NVIDIA H100 80GB HBM3, 700.00 W; PERF.md).
//
// Bound.  Bytes: the current planes and the vectors read, the windows the
// candidates read (at most 18 x 18 of G, b, h and j and 9 x 9 of U and V
// an MB), the outputs once.  Operations (chip_smoke.py p16_refine_work):
// the 49 x 256 squared errors of u8 samples a quarter each, the 40 x 256
// byte means of the candidates that average two windows a quarter each,
// each candidate's rate and first-minimum step, then the luma and chroma
// coding per sample: 4.15 MB and 7.0 M operations at CIF, so the bytes
// lead (0.00124 ms at 3.35 TB/s); 35.8 MB at 1280x720 (0.0107 ms).
//
// ptxas (sm_90a, nvcc -O3): 128 registers, no stack frame, no spills,
// 6,912 B of shared memory; SASS (tools/time_kernels.py sass_report) 2,984
// instructions, both window paths and one pricing.  0.0089 ms at CIF, 1.9x
// an empty launch of its grid, and 0.0212 at 1280x720 on an NVIDIA H100
// 80GB HBM3 at 700.00 W (the first kernel's 0.0301 / 0.1997 in the same
// call; PERF.md).

#include <algorithm>
#include <climits>

#include "common.cuh"
#include "packed_u8.cuh"
#include "tq_lanes.cuh"

namespace {

constexpr int kMaxWarps = 4;  // MBs a block, at most
constexpr int kSMs = 132;     // an H100's SMs
constexpr int kCand = 49;
constexpr int kSr = 18;  // staged rows (and samples a row) of each plane
constexpr int kSw = 6;   // words a staged row apart (5 used)
constexpr int kWarpWords = 4 * kSr * kSw;

struct Plane {
  const int* p;
  int rows, cols, stride;
};

struct Args {
  const int *cur_y, *cur_u, *cur_v, *int_mvx, *int_mvy;
  Plane pl[4];  // G, b, h, j
  Plane U, V;
  int W, n_mx, n_mb, qp, qp_c, lam;
  int *mvx, *mvy, *lev, *rec_y, *lev_c[2], *dc_c[2], *rec_c[2];
};

__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

// where dynamic_slice starts a window of `size` on an axis of length L
// asked to start at s
__device__ __forceinline__ int slice_start(int s, int L, int size) {
  return clampi(s < 0 ? s + L : s, L - size);
}

// A window of the candidates: its plane (0 G, 1 b, 2 h, 3 j) and its
// offset (rows r, columns c, each 0..2) from one sample up and left of the
// plane's middle start.  Candidate k's prediction is the rounded mean of
// windows a and b, or window a alone when they are equal: the reference's
// `qpel_window_static` case by case, at the integer position (oy >> 2,
// ox >> 2) from the MB's vector.
struct Win {
  int p, r, c;
};
struct Cand {
  Win a, b;
};

__host__ __device__ constexpr Cand cand_of(int k) {
  const int ox = k % 7 - 3, oy = k / 7 - 3;
  const int dx = (ox + 4) & 3, dy = (oy + 4) & 3;
  const int r = oy < 0 ? 0 : 1, c = ox < 0 ? 0 : 1;
  const Win G00{0, r, c}, G01{0, r, c + 1}, G10{0, r + 1, c};
  const Win B00{1, r, c}, B10{1, r + 1, c}, H00{2, r, c}, H01{2, r, c + 1};
  const Win J00{3, r, c};
  if (dx == 0 && dy == 0) return {G00, G00};
  if (dy == 0)
    return dx == 1 ? Cand{G00, B00} : dx == 2 ? Cand{B00, B00} : Cand{B00, G01};
  if (dx == 0)
    return dy == 1 ? Cand{G00, H00} : dy == 2 ? Cand{H00, H00} : Cand{H00, G10};
  if (dx == 2 && dy == 2) return {J00, J00};
  if (dx == 2) return dy == 1 ? Cand{B00, J00} : Cand{J00, B10};
  if (dy == 2) return dx == 1 ? Cand{H00, J00} : Cand{J00, H01};
  return {dy == 1 ? B00 : B10, dx == 1 ? H00 : H01};
}

// The lane's window words: T[p][r][c][j] is its word of row j of the
// window of plane p at offset (r, c).  Only the 24 windows the candidates
// take are ever read; the compiler drops the rest.
using Words = unsigned[4][3][3][2];

// the lane's word of row J of candidate K's prediction
template <int K, int J>
__device__ __forceinline__ unsigned cand_word(const Words& T) {
  constexpr Cand c = cand_of(K);
  const unsigned w = T[c.a.p][c.a.r][c.a.c][J];
  if constexpr (c.a.p == c.b.p && c.a.r == c.b.r && c.a.c == c.b.c) {
    return w;
  } else {
    return __vavgu4(w, T[c.b.p][c.b.r][c.b.c][J]);
  }
}

// candidates K.. : each one's SSD over the warp; lane l keeps those of
// k = l (lo) and k = l + 32 (hi)
template <int K>
__device__ __forceinline__ void price(const Words& T, const unsigned (&src)[2],
                                      int lane, int& lo, int& hi) {
  if constexpr (K < kCand) {
    const unsigned d0 = __vabsdiffu4(cand_word<K, 0>(T), src[0]);
    const unsigned d1 = __vabsdiffu4(cand_word<K, 1>(T), src[1]);
    const int s =
        (int)__reduce_add_sync(kFull, __dp4a(d1, d1, __dp4a(d0, d0, 0u)));
    if constexpr (K < 32) {
      if (lane == K) lo = s;
    } else {
      if (lane == K - 32) hi = s;
    }
    price<K + 1>(T, src, lane, lo, hi);
  }
}

// the rate of candidate k (k % 7 - 3, k / 7 - 3 around the vector)
__device__ __forceinline__ int rate_of(int k, int bvx, int bvy, int lam) {
  const int ky = k / 7, kx = k - 7 * ky;
  return lam_cost(lam, mv_bits(wadd(mul(bvx, 4), kx - 3)) +
                           mv_bits(wadd(mul(bvy, 4), ky - 3)));
}

// the lane's two words of candidate k's prediction (k warp-uniform), by a
// branch tree over [LO, HI)
template <int LO, int HI>
__device__ __forceinline__ void pick(const Words& T, int k, unsigned (&pw)[2]) {
  if constexpr (HI - LO == 1) {
    pw[0] = cand_word<LO, 0>(T);
    pw[1] = cand_word<LO, 1>(T);
  } else {
    constexpr int kMid = (LO + HI) / 2;
    if (k < kMid)
      pick<LO, kMid>(T, k, pw);
    else
      pick<kMid, HI>(T, k, pw);
  }
}

__global__ void __launch_bounds__(32 * kMaxWarps)
p16_refine_kernel(const Args a) {
  __shared__ __align__(16) unsigned stage[kMaxWarps][kWarpWords];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int mb = blockIdx.x * (blockDim.x >> 5) + warp;
  if (mb >= a.n_mb) return;  // the whole warp
  const int h = lane & 1, bc = (lane >> 1) & 3, br = lane >> 3;
  const int mby = mb / a.n_mx, mbx = mb - mby * a.n_mx;
  const int y0 = 16 * mby, x0 = 16 * mbx, W = a.W;
  // the lane's rows Y0, Y0 + 1 and columns X0 .. X0 + 3 of the MB
  const int Y0 = 4 * br + 2 * h, X0 = 4 * bc;
  const int bvx = a.int_mvx[mb], bvy = a.int_mvy[mb];
  // the middle starts: G at the integer vector, b / h / j 2 up and left
  const int iy0 = wadd(y0 + kPad, bvy), ix0 = wadd(x0 + kPad, bvx);
  const int qy0 = wadd(iy0, -2), qx0 = wadd(ix0, -2);

  int o[2][4];
  unsigned src[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(
        a.cur_y + (y0 + Y0 + j) * W + x0 + X0));
    o[j][0] = v.x;
    o[j][1] = v.y;
    o[j][2] = v.z;
    o[j][3] = v.w;
    src[j] = pack4(v.x, v.y, v.z, v.w);
  }

  bool regular = iy0 >= 1 && iy0 <= a.pl[0].rows - 17 && ix0 >= 1 &&
                 ix0 <= a.pl[0].cols - 17;
#pragma unroll
  for (int p = 1; p < 4; ++p)
    regular = regular && qy0 >= 1 && qy0 <= a.pl[p].rows - 17 && qx0 >= 1 &&
              qx0 <= a.pl[p].cols - 17;
  // A. a regular MB: each plane's 18 x 18 window as packed words, zero
  // past 18
  unsigned* st = stage[warp];
  if (regular) {
    // words i = lane + 32 j of each plane's 90, every load issued before
    // the first store
    int v[4][3][4];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const Plane& q = a.pl[p];
      const int* base = q.p + ((p ? qy0 : iy0) - 1) * q.stride +
                        (p ? qx0 : ix0) - 1;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const int i = lane + 32 * j, t = i / 5, w = i - 5 * t;
        const int* s = base + t * q.stride + 4 * w;
#pragma unroll
        for (int b = 0; b < 4; ++b)
          v[p][j][b] = i < kSr * 5 && 4 * w + b < kSr ? __ldg(s + b) : 0;
      }
    }
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const int i = lane + 32 * j, t = i / 5, w = i - 5 * t;
        if (i < kSr * 5)
          st[(p * kSr + t) * kSw + w] =
              pack4(v[p][j][0], v[p][j][1], v[p][j][2], v[p][j][3]);
      }
  }
  __syncwarp();
  // the lane's window words: funnel shifts of its staged words, or (an MB
  // whose windows move) each read at its window's placed start
  Words T;
  if (regular) {
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int r = 0; r < 3; ++r)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const unsigned* row = st + (p * kSr + Y0 + j + r) * kSw + bc;
          const unsigned lo = row[0], hi = row[1];
#pragma unroll
          for (int c = 0; c < 3; ++c)
            T[p][r][c][j] = __funnelshift_r(lo, hi, 8 * c);
        }
  } else {
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const Plane& q = a.pl[p];
      const int r0 = wadd(p ? qy0 : iy0, -1), c0 = wadd(p ? qx0 : ix0, -1);
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        const int y = slice_start(wadd(r0, r), q.rows, 16) + Y0;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const int x = slice_start(wadd(c0, c), q.cols, 16) + X0;
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int* s = q.p + (y + j) * q.stride + x;
            T[p][r][c][j] =
                pack4(__ldg(s), __ldg(s + 1), __ldg(s + 2), __ldg(s + 3));
          }
        }
      }
    }
  }

  // B. the 49 candidates' SSDs, each lane's two keys cost * 64 + k, the
  // warp's least key, the winner's words
  int lo = 0, hi = 0;
  price<0>(T, src, lane, lo, hi);
  lo = (lo + rate_of(lane, bvx, bvy, a.lam)) * 64 + lane;
  hi = lane + 32 < kCand
           ? (hi + rate_of(lane + 32, bvx, bvy, a.lam)) * 64 + lane + 32
           : INT_MAX;
  const int k = __reduce_min_sync(kFull, min(lo, hi)) & 63;
  unsigned pw[2];
  pick<0, kCand>(T, k, pw);
  const int mvx = wadd(mul(bvx, 4), k % 7 - 3);
  const int mvy = wadd(mul(bvy, 4), k / 7 - 3);
  if (lane == 0) {
    a.mvx[mb] = mvx;
    a.mvy[mb] = mvy;
  }

  // C. luma: residual, forward, quant, dequant, inverse, recon
  {
    const int per = a.qp / 6, rem = a.qp - 6 * per, off = 342 << (4 + per),
              qbits = 15 + per;
    int mf[3], vs[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      mf[c] = kM4[rem][c];
      vs[c] = kV4[rem][c] * 16;
    }
    int pb[2][4], c[2][4], lev[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        pb[j][x] = (pw[j] >> (8 * x)) & 255;
        c[j][x] = o[j][x] - pb[j][x];
      }
      fwd_row(c[j]);
    }
    fwd_cols(c[0], c[1], h);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        lev[j][x] = quant(c[j][x], mf[cls_of(j, x)], off, qbits);
        c[j][x] = (shl(mul(lev[j][x], vs[cls_of(j, x)]), per) + 8) >> 4;
      }
      inv_row(c[j]);
    }
    inv_cols(c[0], c[1], h);
    int4* lp = reinterpret_cast<int4*>(
        a.lev + ((4 * mby + br) * (W / 4) + 4 * mbx + bc) * 16 + 8 * h);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      int rec[4];
#pragma unroll
      for (int x = 0; x < 4; ++x)
        rec[x] = clip255((c[j][x] + shl(pb[j][x], 6) + 32) >> 6);
      *reinterpret_cast<int4*>(a.rec_y + (y0 + Y0 + j) * W + x0 + X0) =
          make_int4(rec[0], rec[1], rec[2], rec[3]);
      lp[j] = make_int4(lev[j][0], lev[j][1], lev[j][2], lev[j][3]);
    }
  }

  // C. chroma: lane bits 0 h, 1-2 the block cb = 2 cby + cbx, 3 the plane
  {
    const int cb = (lane >> 1) & 3, pl = (lane >> 3) & 1;
    const int cby = cb >> 1, cbx = cb & 1, Wc = W / 2;
    const Plane P = pl ? a.V : a.U;
    // the lane's rows 4 cby + 2 h + j, columns 4 cbx + x of the MB's 8x8
    const int yi =
        slice_start(8 * mby + (mvy >> 3) + kPad, P.rows, 9) + 4 * cby + 2 * h;
    const int xi = slice_start(8 * mbx + (mvx >> 3) + kPad, P.cols, 9) +
                   4 * cbx;
    const int fx = mvx & 7, fy = mvy & 7;
    const int w00 = (8 - fx) * (8 - fy), w01 = fx * (8 - fy),
              w10 = (8 - fx) * fy, w11 = fx * fy;
    int A[3][5];
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int x = 0; x < 5; ++x)
        A[r][x] = __ldg(P.p + (yi + r) * P.stride + xi + x);
    const int* cur_c = pl ? a.cur_v : a.cur_u;
    const int cy = 8 * mby + 4 * cby + 2 * h, cx = 8 * mbx + 4 * cbx;
    const int per = a.qp_c / 6, rem = a.qp_c - 6 * per,
              off = 342 << (4 + per), qbits = 15 + per;
    int mf[3], vs[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      mf[c] = kM4[rem][c];
      vs[c] = kV4[rem][c] * 16;
    }
    int pc[2][4], c[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int4 v =
          __ldg(reinterpret_cast<const int4*>(cur_c + (cy + j) * Wc + cx));
      const int oc[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        pc[j][x] = (w00 * A[j][x] + w01 * A[j][x + 1] + w10 * A[j + 1][x] +
                    w11 * A[j + 1][x + 1] + 32) >> 6;
        c[j][x] = oc[x] - pc[j][x];
      }
      fwd_row(c[j]);
    }
    fwd_cols(c[0], c[1], h);
    // the DC: 2x2 Hadamard of the plane's four DCs, quant (twice the
    // offset, shift 16 + per), its own Hadamard and the truncating dequant
    const int dl =
        quant(hadamard_blocks(c[0][0], cb), mf[0], 2 * off, 16 + per);
    const int dg = mul(hadamard_blocks(dl, cb), vs[0]);
    const int dc_deq = per < 5 ? dg >> (5 - per) : shl(dg, per - 5);
    int lev[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const bool is_dc = h == 0 && j == 0 && x == 0;
        lev[j][x] = is_dc ? 0 : quant(c[j][x], mf[cls_of(j, x)], off, qbits);
        c[j][x] = is_dc ? dc_deq
                        : (shl(mul(lev[j][x], vs[cls_of(j, x)]), per) + 8) >> 4;
      }
      inv_row(c[j]);
    }
    inv_cols(c[0], c[1], h);
    if (lane < 16) {
      if (h == 0) a.dc_c[pl][mb * 4 + cb] = dl;
      int4* lp = reinterpret_cast<int4*>(
          a.lev_c[pl] + ((2 * mby + cby) * (Wc / 4) + 2 * mbx + cbx) * 16 +
          8 * h);
      int* rc = a.rec_c[pl] + cy * Wc + cx;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        int rec[4];
#pragma unroll
        for (int x = 0; x < 4; ++x)
          rec[x] = clip255((c[j][x] + shl(pc[j][x], 6) + 32) >> 6);
        *reinterpret_cast<int4*>(rc + j * Wc) =
            make_int4(rec[0], rec[1], rec[2], rec[3]);
        lp[j] = make_int4(lev[j][0], lev[j][1], lev[j][2], lev[j][3]);
      }
    }
  }
}

}  // namespace

// planes: cur_y (H, W), cur_u / cur_v (H/2, W/2) contiguous and 16-byte
// aligned; G, b, h, j, U pad, V pad given as (pointer, rows, cols, row
// stride) each; int_mvx / int_mvy (H/16 * W/16).  Outputs (contiguous
// int32, 16-byte aligned): mvx, mvy (n_mb), lev (H/4, W/4, 4, 4), rec_y
// (H, W), lev_u / lev_v (H/8, W/8, 4, 4), dc_u / dc_v (n_mb, 4), rec_u /
// rec_v (H/2, W/2).  Returns the CUDA error of the launch.
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
  Plane* ps[6] = {&a.pl[0], &a.pl[1], &a.pl[2], &a.pl[3], &a.U, &a.V};
  for (int i = 0; i < 6; ++i)
    *ps[i] = Plane{pl[i], dims[3 * i], dims[3 * i + 1], dims[3 * i + 2]};
  a.W = W;
  a.n_mx = n_mx;
  a.n_mb = n_mb;
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
  // as many MBs a block as leave a block for every SM, from 2 up to
  // kMaxWarps
  const int warps = std::max(2, std::min(kMaxWarps, n_mb / kSMs));
  p16_refine_kernel<<<(n_mb + warps - 1) / warps, 32 * warps, 0,
                      (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
