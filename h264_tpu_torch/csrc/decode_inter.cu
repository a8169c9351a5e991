// K8: whole-picture inter reconstruction of the decoder, for Hopper
// (sm_90a).
//
// Replaces h264_tpu/decoder/device.py:99 `_decode_inter` (with its
// `_deq4_batched` :42, `_deq8_batched` :55 and `_deq_chroma_dc_batched`
// :65).  Plain version: h264_tpu_torch/decoder/device.py
// `decode_inter_plain`; wrapper kernels/decode_inter.py.
//
// Per 4x4 luma block: the quarter-pel prediction of each valid list from
// its reference's [G, b, h, j] bank (kQtab picks the two samples whose
// rounded mean is the sample), the 1/8-pel chroma prediction of its 2x2
// chroma block, explicit (mode 1) or implicit (mode 2) weighted
// prediction and bi-prediction.  Per MB: dequant with the MB's qp and the
// inverse level scales (scaling lists included), inverse 4x4 or 8x8,
// chroma DC Hadamard, recon and clip; zero for an MB that is not inter.
//
// The decoder places windows by its own rule (device.py:121-146), neither
// K4's per-coordinate clamp nor K7's dynamic_slice placement: the window's
// integer start is clipped to [-(PAD-8), W+PAD-12] (luma) and
// [-(PAD-4), Wc+PAD-8] (chroma), so every read lies inside the padded
// planes.  ref_idx is clipped to MAXREF-1 = 7 before the refmap lookup.
// Products and left shifts of the dequant wrap as int32 does under XLA:
// they are formed unsigned and reinterpreted before the arithmetic right
// shift.  The chroma DC shift truncates (device.py:65-76).
//
// Design.  One block of 256 threads per MB.  Each thread predicts one
// luma sample and (the first 128) one chroma sample into shared memory;
// the MB's residual is dequantised into shared memory, transformed in two
// passes (a thread per block row, then per block column) and added; the
// prediction planes never reach device memory.
//
// Bound.  Bytes: the window samples of the valid lists (one or two bank
// planes per luma sample, four chroma taps), the MB's levels and fields,
// the recon out; a few tens of int32 operations per sample.  It is
// bound by bytes.

#include "qpel.cuh"

namespace {

constexpr int kMaxRef = 8;

__device__ __forceinline__ int clipr(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// rshift_rnd_sf((lev * ils) << per, sh) in wrapping int32
__device__ __forceinline__ int deq_sf(int lev, int ils, int per, int sh) {
  const unsigned u = ((unsigned)lev * (unsigned)ils) << per;
  return (int)(u + (1u << (sh - 1))) >> sh;
}

// one quarter-pel luma sample (yy, xx) of the 4x4 block at (y0, x0)
__device__ __forceinline__ int luma_pred(const int* bank, int H, int W,
                                         int y0, int x0, int mvx, int mvy,
                                         int yy, int xx) {
  const int Hp = H + 2 * kPad, Wp = W + 2 * kPad;
  const int xi = clipr(x0 + (mvx >> 2), -(kPad - 8), W + kPad - 12) + kPad;
  const int yi = clipr(y0 + (mvy >> 2), -(kPad - 8), H + kPad - 12) + kPad;
  const int* t = kQtab[(mvy & 3) * 4 + (mvx & 3)];
  const size_t plane = (size_t)Hp * Wp;
  const int a = bank[t[0] * plane + (size_t)(yi + t[1] + yy) * Wp + xi + t[2] + xx];
  const int b = bank[t[3] * plane + (size_t)(yi + t[4] + yy) * Wp + xi + t[5] + xx];
  return (a + b + 1) >> 1;
}

// one 1/8-pel chroma sample (yy, xx) of the 2x2 block at (yc, xc), from
// one padded chroma plane
__device__ __forceinline__ int chroma_pred(const int* P, int Hc, int Wc,
                                           int yc, int xc, int mvx, int mvy,
                                           int yy, int xx) {
  const int Wcp = Wc + 2 * kPad;
  const int xi = clipr(xc + (mvx >> 3), -(kPad - 4), Wc + kPad - 8) + kPad;
  const int yi = clipr(yc + (mvy >> 3), -(kPad - 4), Hc + kPad - 8) + kPad;
  const int fx = mvx & 7, fy = mvy & 7;
  const int* r0 = P + (size_t)(yi + yy) * Wcp + xi + xx;
  const int* r1 = r0 + Wcp;
  return ((8 - fx) * (8 - fy) * r0[0] + fx * (8 - fy) * r0[1] +
          (8 - fx) * fy * r1[0] + fx * fy * r1[1] + 32) >> 6;
}

// weighted / bi-prediction of one sample (device.py:166-214)
__device__ __forceinline__ int weigh(int p0, int p1, bool v0, bool v1,
                                     int mode, int lg, int w0, int o0, int w1,
                                     int o1, int iw0, int iw1) {
  if (v0 && v1) {
    if (mode == 0) return (p0 + p1 + 1) >> 1;
    const bool imp = mode == 2;
    const int a0 = imp ? iw0 : w0, a1 = imp ? iw1 : w1;
    const int c0 = imp ? 0 : o0, c1 = imp ? 0 : o1;
    const int lb = imp ? 5 : lg;
    return clip255(((mul(p0, a0) + mul(p1, a1) + (1 << lb)) >> (lb + 1)) +
                   ((c0 + c1 + 1) >> 1));
  }
  const int p = v0 ? p0 : p1;
  if (mode != 1) return p;
  const int w = v0 ? w0 : w1, o = v0 ? o0 : o1;
  return clip255(lg >= 1 ? ((mul(p, w) + (1 << (lg - 1))) >> lg) + o
                         : mul(p, w) + o);
}

// inverse 4-point butterfly over v[0], v[s], v[2s], v[3s]
__device__ __forceinline__ void inv4(int* v, int s) {
  const int w0 = v[0], w1 = v[s], w2 = v[2 * s], w3 = v[3 * s];
  const int e0 = w0 + w2, e1 = w0 - w2;
  const int e2 = (w1 >> 1) - w3, e3 = w1 + (w3 >> 1);
  v[0] = e0 + e3;
  v[s] = e1 + e2;
  v[2 * s] = e1 - e2;
  v[3 * s] = e0 - e3;
}

// inverse 8-point butterfly over v[0], v[s], ..., v[7s]
__device__ __forceinline__ void inv8(int* v, int s) {
  int p[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) p[i] = v[i * s];
  const int a0 = p[0] + p[4], a4 = p[0] - p[4];
  const int a2 = (p[2] >> 1) - p[6], a6 = p[2] + (p[6] >> 1);
  const int b0 = a0 + a6, b2 = a4 + a2, b4 = a4 - a2, b6 = a0 - a6;
  const int a1 = -p[3] + p[5] - p[7] - (p[7] >> 1);
  const int a3 = p[1] + p[7] - p[3] - (p[3] >> 1);
  const int a5 = -p[1] + p[7] + p[5] + (p[5] >> 1);
  const int a7 = p[3] + p[5] + p[1] + (p[1] >> 1);
  const int b1 = a1 + (a7 >> 2), b7 = a7 - (a1 >> 2);
  const int b3 = a3 + (a5 >> 2), b5 = (a3 >> 2) - a5;
  v[0] = b0 + b7;
  v[s] = b2 + b5;
  v[2 * s] = b4 + b3;
  v[3 * s] = b6 + b1;
  v[4 * s] = b6 - b1;
  v[5 * s] = b4 - b3;
  v[6 * s] = b2 - b5;
  v[7 * s] = b0 - b7;
}

// (res + (pred << 6) + 32) >> 6, clipped, in wrapping int32
__device__ __forceinline__ int recon(int res, int pred) {
  return clip255((int)((unsigned)res + ((unsigned)pred << 6) + 32u) >> 6);
}

struct Params {
  const int *banks, *cpads, *refmap, *mv, *ref_idx, *sid4;
  const int *wp_mode, *wp_ly, *wp_lc, *wy, *oy, *wc, *oc, *wimp;
  const int *qp, *qpc, *t8, *lev4, *lev8, *levc, *dcc, *inter;
  const int *ils4y, *ils8y, *ils4c;
  int H, W, NS;
  int* out;
};

// the motion of one 4x4 block and the weights that apply to it
struct Motion {
  int sid, b0, b1, m0x, m0y, m1x, m1y, i0, i1;
  bool v0, v1;
};

__device__ __forceinline__ Motion motion_of(const Params& P, int by, int bx) {
  const int H4 = P.H / 4, W4 = P.W / 4;
  Motion m;
  const int k = by * W4 + bx;
  m.sid = clipr(P.sid4[k], 0, P.NS - 1);
  const int r0 = P.ref_idx[k], r1 = P.ref_idx[H4 * W4 + k];
  m.v0 = r0 >= 0;
  m.v1 = r1 >= 0;
  m.i0 = clipr(r0, 0, kMaxRef - 1);
  m.i1 = clipr(r1, 0, kMaxRef - 1);
  m.b0 = P.refmap[(m.sid * 2 + 0) * kMaxRef + m.i0];
  m.b1 = P.refmap[(m.sid * 2 + 1) * kMaxRef + m.i1];
  m.m0x = P.mv[2 * k];
  m.m0y = P.mv[2 * k + 1];
  m.m1x = P.mv[2 * (H4 * W4 + k)];
  m.m1y = P.mv[2 * (H4 * W4 + k) + 1];
  return m;
}

__global__ void __launch_bounds__(256) decode_inter_kernel(const Params P) {
  __shared__ int py[256], pc[128], ry[256], rc[128];
  const int mb = blockIdx.x, t = threadIdx.x;
  const int H = P.H, W = P.W, Hc = H / 2, Wc = W / 2;
  const int n_mx = W / 16, mby = mb / n_mx, mbx = mb % n_mx;
  const int y = t >> 4, x = t & 15;
  int* outY = P.out + (size_t)(16 * mby + y) * W + 16 * mbx + x;
  // chroma sample of this thread (t < 128): plane, row, column
  const int cpl = t >> 6, cy = (t >> 3) & 7, cx = t & 7;
  int* outC = P.out + (size_t)H * W + (size_t)cpl * Hc * Wc +
              (size_t)(8 * mby + cy) * Wc + 8 * mbx + cx;
  if (P.inter[mb] == 0) {
    *outY = 0;
    if (t < 128) *outC = 0;
    return;
  }
  const size_t bank_sz = (size_t)4 * (H + 2 * kPad) * (W + 2 * kPad);
  const size_t cplane = (size_t)(Hc + 2 * kPad) * (Wc + 2 * kPad);

  // --- prediction ---------------------------------------------------------
  {
    const Motion m = motion_of(P, 4 * mby + (y >> 2), 4 * mbx + (x >> 2));
    const int y0 = 16 * mby + (y & ~3), x0 = 16 * mbx + (x & ~3);
    const int p0 = m.v0 ? luma_pred(P.banks + m.b0 * bank_sz, H, W, y0, x0,
                                     m.m0x, m.m0y, y & 3, x & 3) : 0;
    const int p1 = m.v1 ? luma_pred(P.banks + m.b1 * bank_sz, H, W, y0, x0,
                                     m.m1x, m.m1y, y & 3, x & 3) : 0;
    const int s = m.sid;
    const int* iw = P.wimp + ((s * kMaxRef + m.i0) * kMaxRef + m.i1) * 2;
    py[t] = (m.v0 || m.v1)
        ? weigh(p0, p1, m.v0, m.v1, P.wp_mode[s], P.wp_ly[s],
                P.wy[(s * 2 + 0) * kMaxRef + m.i0],
                P.oy[(s * 2 + 0) * kMaxRef + m.i0],
                P.wy[(s * 2 + 1) * kMaxRef + m.i1],
                P.oy[(s * 2 + 1) * kMaxRef + m.i1], iw[0], iw[1])
        : 0;
  }
  if (t < 128) {
    const Motion m = motion_of(P, 4 * mby + (cy >> 1), 4 * mbx + (cx >> 1));
    const int yc = 8 * mby + (cy & ~1), xc = 8 * mbx + (cx & ~1);
    const int p0 = m.v0 ? chroma_pred(P.cpads + (m.b0 * 2 + cpl) * cplane,
                                      Hc, Wc, yc, xc, m.m0x, m.m0y, cy & 1,
                                      cx & 1) : 0;
    const int p1 = m.v1 ? chroma_pred(P.cpads + (m.b1 * 2 + cpl) * cplane,
                                      Hc, Wc, yc, xc, m.m1x, m.m1y, cy & 1,
                                      cx & 1) : 0;
    const int s = m.sid;
    const int* iw = P.wimp + ((s * kMaxRef + m.i0) * kMaxRef + m.i1) * 2;
    const int e0 = ((s * 2 + 0) * kMaxRef + m.i0) * 2 + cpl;
    const int e1 = ((s * 2 + 1) * kMaxRef + m.i1) * 2 + cpl;
    pc[t] = (m.v0 || m.v1)
        ? weigh(p0, p1, m.v0, m.v1, P.wp_mode[s], P.wp_lc[s], P.wc[e0],
                P.oc[e0], P.wc[e1], P.oc[e1], iw[0], iw[1])
        : 0;
  }

  // --- dequant --------------------------------------------------------------
  const int qp = P.qp[mb], per = qp / 6, rem = qp % 6;
  const bool t8 = P.t8[mb] != 0;
  if (t8) {
    const int b8 = (y >> 3) * 2 + (x >> 3), yy = y & 7, xx = x & 7;
    ry[t] = deq_sf(P.lev8[(((size_t)mb * 4 + b8) * 8 + yy) * 8 + xx],
                   P.ils8y[(rem * 8 + yy) * 8 + xx], per, 6);
  } else {
    const int by = y >> 2, bx = x >> 2, yy = y & 3, xx = x & 3;
    const int jb = (by >> 1) * 8 + (bx >> 1) * 4 + (by & 1) * 2 + (bx & 1);
    ry[t] = deq_sf(P.lev4[(((size_t)mb * 16 + jb) * 4 + yy) * 4 + xx],
                   P.ils4y[(rem * 4 + yy) * 4 + xx], per, 4);
  }
  if (t < 128) {
    const int qc = P.qpc[mb * 2 + cpl], pc6 = qc / 6, rc6 = qc % 6;
    const int blk = (cy >> 2) * 2 + (cx >> 2), yy = cy & 3, xx = cx & 3;
    const int* ils = P.ils4c + (cpl * 6 + rc6) * 16;
    int v;
    if (yy == 0 && xx == 0) {  // the DC, from the 2x2 Hadamard
      const int* d = P.dcc + ((size_t)mb * 2 + cpl) * 4;
      const int a = d[0], b = d[1], c = d[2], e = d[3];
      const int h[4] = {a + b + c + e, a - b + c - e, a + b - c - e,
                        a - b - c + e};
      const int tdc = mul(h[blk], ils[0]);
      v = pc6 < 5 ? tdc >> (5 - pc6) : shl(tdc, pc6 - 5);
    } else {
      v = deq_sf(P.levc[((((size_t)mb * 2 + cpl) * 4 + blk) * 4 + yy) * 4 + xx],
                 ils[yy * 4 + xx], pc6, 4);
    }
    rc[t] = v;
  }
  __syncthreads();

  // --- inverse transforms: rows (horizontal pass), then columns -----------
  if (t8) {
    if (t < 32) {  // 4 blocks x 8 rows
      const int b8 = t >> 3, r = t & 7;
      inv8(ry + ((b8 >> 1) * 8 + r) * 16 + (b8 & 1) * 8, 1);
    }
  } else if (t < 64) {  // 16 blocks x 4 rows
    const int b = t >> 2, r = t & 3;
    inv4(ry + ((b >> 2) * 4 + r) * 16 + (b & 3) * 4, 1);
  }
  if (t >= 64 && t < 96) {  // 2 planes x 4 blocks x 4 rows
    const int k = t - 64, p = k >> 4, b = (k >> 2) & 3, r = k & 3;
    inv4(rc + p * 64 + ((b >> 1) * 4 + r) * 8 + (b & 1) * 4, 1);
  }
  __syncthreads();
  if (t8) {
    if (t < 32) {
      const int b8 = t >> 3, c = t & 7;
      inv8(ry + (b8 >> 1) * 8 * 16 + (b8 & 1) * 8 + c, 16);
    }
  } else if (t < 64) {
    const int b = t >> 2, c = t & 3;
    inv4(ry + (b >> 2) * 4 * 16 + (b & 3) * 4 + c, 16);
  }
  if (t >= 64 && t < 96) {
    const int k = t - 64, p = k >> 4, b = (k >> 2) & 3, c = k & 3;
    inv4(rc + p * 64 + (b >> 1) * 4 * 8 + (b & 1) * 4 + c, 8);
  }
  __syncthreads();

  // --- recon ------------------------------------------------------------------
  *outY = recon(ry[t], py[t]);
  if (t < 128) *outC = recon(rc[t], pc[t]);
}

}  // namespace

extern "C" int decode_inter(
    const int* banks, const int* cpads, const int* refmap, const int* mv,
    const int* ref_idx, const int* sid4, const int* wp_mode, const int* wp_ly,
    const int* wp_lc, const int* wy, const int* oy, const int* wc,
    const int* oc, const int* wimp, const int* qp, const int* qpc,
    const int* t8, const int* lev4, const int* lev8, const int* levc,
    const int* dcc, const int* inter, const int* ils4y, const int* ils8y,
    const int* ils4c, int H, int W, int NS, int* out, void* stream) {
  const Params P{banks, cpads, refmap, mv,   ref_idx, sid4,  wp_mode,
                 wp_ly, wp_lc, wy,     oy,   wc,      oc,    wimp,
                 qp,    qpc,   t8,     lev4, lev8,    levc,  dcc,
                 inter, ils4y, ils8y,  ils4c, H,      W,     NS,
                 out};
  const int n_mb = (H / 16) * (W / 16);
  decode_inter_kernel<<<n_mb, 256, 0, (cudaStream_t)stream>>>(P);
  return (int)cudaGetLastError();
}
