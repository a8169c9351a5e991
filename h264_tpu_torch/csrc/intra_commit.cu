// K1: one wavefront step of the intra commit scan, for Hopper (sm_90a).
//
// Replaces h264_tpu/encoder/rd.py:1415 `_intra_commit_scan` (the device
// program of rd.py:1645 `rd_i_pipeline`, also called by the P and B
// pipelines): exactly its `mb_compute` (rd.py:1443-1580) followed by the
// scatter of `step` (rd.py:1599-1635), for every macroblock of one
// anti-diagonal t = 2r + c.  The plain PyTorch version is
// h264_tpu_torch/encoder/rd.py `_intra_step`; the wrapper is
// h264_tpu_torch/kernels/intra_commit.py.
//
// Design.  One launch per anti-diagonal, one CUDA block (64 threads) per
// MB on it.  The block loads the MB's 17x21 luma workspace (rows
// 16r..16r+16, cols 16c..16c+20 of the bordered plane) and the 5x5 mode
// window into shared memory, then
//   1. I16: 64 threads = 4 modes x 16 4x4 blocks price the Hadamard cost,
//      16 threads transform/quantize/reconstruct the chosen mode (the
//      `i16_code` of common.cuh, which the P picture's I16 candidate in
//      inter_tq.cu shares);
//   2. I4x4: the 16 blocks in z-order, one after the other; for each, 9
//      threads (one per mode) run predict -> forward -> quant -> dequant ->
//      inverse -> recon -> SSD + rate with the block's 16 samples in
//      registers, the first minimum wins, and its recon is written back
//      into the workspace before the next block reads its neighbours;
//   3. chroma: 32 threads = 4 modes x 2 planes x 4 blocks;
//   4. I16 vs I4 by J, then the MB's tiles go into the carry planes.
//
// No races between the blocks of one launch.  MB (r, c) reads padded luma
// rows 16r..16r+16 and cols 16c..16c+20 and writes rows 16r+1..16r+16,
// cols 16c+1..16c+16.  Its diagonal peers are (r+1, c-2) and (r-1, c+2):
// the first writes rows from 16r+17 on, the second cols from 16c+33 on,
// and neither reads what this MB writes (the first reads cols up to
// 16c-12, the second rows up to 16r).  The same holds for the chroma
// planes (8-sample tiles, 1-sample border) and the 4x4 mode plane.
//
// Exactness.  Integer arithmetic only, in the reference's order: int32
// with wrapping products (computed unsigned) and arithmetic right shifts.
// `_bitlen` is 32 - __clz(a), which equals the reference's float32
// floor(log2(a)) + 1 on every level this path produces (|level| <= 6528;
// tests/test_torch_ops.py checks the range exhaustively).  Every argmin
// keeps the first index on ties (strict < in mode order), unavailable
// modes cost 1 << 29.  (cb * 3) / 4 only sees non-negative bit counts, so
// C's truncating division equals the reference's floor division.
//
// Bound.  The dependency chain: the reference's T = 2*n_my + n_mx - 1
// steps, of which the last is empty, so T - 1 launches per picture (56 at
// CIF, 168 at 1280x720), each with 16 dependent 4x4
// decisions per MB, and at most LMAX = min(n_my, n_mx/2 + 1) MBs in flight
// (12 at CIF, 41 at 720p) on 132 SMs.  Bytes and operations per picture
// are small by comparison (PERF.md).  A persistent wavefront kernel or a
// CUDA graph over the T launches is later work.
//
// ptxas (sm_90a, nvcc -O3): 85 registers, a 96-byte stack frame (the
// shared I16 code is a call), 13,260 B shared memory, no spills.

#include "common.cuh"

namespace {

constexpr int kThreads = 64;

// 4x4 z-order -> (bx, by), and the up-right availability of blocks
// inside the MB (rd.py `_I4_AUR_INT`)
__constant__ int kBlkX[16] = {0, 1, 0, 1, 2, 3, 2, 3, 0, 1, 0, 1, 2, 3, 2, 3};
__constant__ int kBlkY[16] = {0, 0, 1, 1, 0, 0, 1, 1, 2, 2, 3, 3, 2, 2, 3, 3};
__constant__ int kAurInt[16] = {0, 0, 1, 0, 0, 0, 1, 0, 1, 1, 1, 0, 1, 0, 1, 0};
// intra_chroma_pred_mode bins for DC, HOR, VERT, PLANE
__constant__ int kChromaModeBits[4] = {1, 2, 3, 3};

// the nine 4x4 intra predictions (rd.py `_i4_pred9`): p[0..3] up (A..D),
// p[4..7] up-right (E..H), p[8..11] left (I..L), p[12] corner X, all
// already substituted by their availability rules; au/al select the DC
__device__ void pred4(int m, const int* p, int au, int al, int* out) {
  const int A = p[0], B = p[1], C = p[2], D = p[3];
  const int E = p[4], F = p[5], G = p[6], H = p[7];
  const int I = p[8], J = p[9], K = p[10], L = p[11], X = p[12];
  int v[10];
  switch (m) {
    case 0:
      for (int k = 0; k < 16; ++k) out[k] = p[k & 3];
      return;
    case 1:
      for (int k = 0; k < 16; ++k) out[k] = p[8 + (k >> 2)];
      return;
    case 3: {
      v[0] = (A + C + 2 * B + 2) >> 2;
      v[1] = (B + D + 2 * C + 2) >> 2;
      v[2] = (C + E + 2 * D + 2) >> 2;
      v[3] = (D + F + 2 * E + 2) >> 2;
      v[4] = (E + G + 2 * F + 2) >> 2;
      v[5] = (F + H + 2 * G + 2) >> 2;
      v[6] = (G + 3 * H + 2) >> 2;
      for (int k = 0; k < 16; ++k) out[k] = v[(k >> 2) + (k & 3)];
      return;
    }
    case 4: {
      v[0] = (L + 2 * K + J + 2) >> 2;
      v[1] = (K + 2 * J + I + 2) >> 2;
      v[2] = (J + 2 * I + X + 2) >> 2;
      v[3] = (I + 2 * X + A + 2) >> 2;
      v[4] = (X + 2 * A + B + 2) >> 2;
      v[5] = (A + 2 * B + C + 2) >> 2;
      v[6] = (B + 2 * C + D + 2) >> 2;
      for (int k = 0; k < 16; ++k) out[k] = v[3 + (k & 3) - (k >> 2)];
      return;
    }
    case 5: {
      const int idx[16] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 0, 1, 2, 9, 4, 5, 6};
      v[0] = (X + A + 1) >> 1;
      v[1] = (A + B + 1) >> 1;
      v[2] = (B + C + 1) >> 1;
      v[3] = (C + D + 1) >> 1;
      v[4] = (I + 2 * X + A + 2) >> 2;
      v[5] = (X + 2 * A + B + 2) >> 2;
      v[6] = (A + 2 * B + C + 2) >> 2;
      v[7] = (B + 2 * C + D + 2) >> 2;
      v[8] = (X + 2 * I + J + 2) >> 2;
      v[9] = (I + 2 * J + K + 2) >> 2;
      for (int k = 0; k < 16; ++k) out[k] = v[idx[k]];
      return;
    }
    case 6: {
      const int idx[16] = {0, 1, 2, 3, 4, 5, 0, 1, 6, 7, 4, 5, 8, 9, 6, 7};
      v[0] = (X + I + 1) >> 1;
      v[1] = (I + 2 * X + A + 2) >> 2;
      v[2] = (X + 2 * A + B + 2) >> 2;
      v[3] = (A + 2 * B + C + 2) >> 2;
      v[4] = (I + J + 1) >> 1;
      v[5] = (X + 2 * I + J + 2) >> 2;
      v[6] = (J + K + 1) >> 1;
      v[7] = (I + 2 * J + K + 2) >> 2;
      v[8] = (K + L + 1) >> 1;
      v[9] = (J + 2 * K + L + 2) >> 2;
      for (int k = 0; k < 16; ++k) out[k] = v[idx[k]];
      return;
    }
    case 7: {
      const int idx[16] = {0, 1, 2, 3, 5, 6, 7, 8, 1, 2, 3, 4, 6, 7, 8, 9};
      v[0] = (A + B + 1) >> 1;
      v[1] = (B + C + 1) >> 1;
      v[2] = (C + D + 1) >> 1;
      v[3] = (D + E + 1) >> 1;
      v[4] = (E + F + 1) >> 1;
      v[5] = (A + 2 * B + C + 2) >> 2;
      v[6] = (B + 2 * C + D + 2) >> 2;
      v[7] = (C + 2 * D + E + 2) >> 2;
      v[8] = (D + 2 * E + F + 2) >> 2;
      v[9] = (E + 2 * F + G + 2) >> 2;
      for (int k = 0; k < 16; ++k) out[k] = v[idx[k]];
      return;
    }
    case 8: {
      const int idx[16] = {0, 1, 2, 3, 2, 3, 4, 5, 4, 5, 6, 6, 6, 6, 6, 6};
      v[0] = (I + J + 1) >> 1;
      v[1] = (I + 2 * J + K + 2) >> 2;
      v[2] = (J + K + 1) >> 1;
      v[3] = (J + 2 * K + L + 2) >> 2;
      v[4] = (K + L + 1) >> 1;
      v[5] = (K + 3 * L + 2) >> 2;
      v[6] = L;
      for (int k = 0; k < 16; ++k) out[k] = v[idx[k]];
      return;
    }
    default: {  // 2: DC
      int dc = au && al ? (A + B + C + D + I + J + K + L + 4) >> 3
               : al     ? (I + J + K + L + 2) >> 2
               : au     ? (A + B + C + D + 2) >> 2
                        : 128;
      for (int k = 0; k < 16; ++k) out[k] = dc;
      return;
    }
  }
}

struct Shared {
  int orig[256];       // luma source of the MB, raster
  int work[17][21];    // bordered luma workspace (I4 recon goes here)
  int mw[5][5];        // 4x4 mode window (1-block border)
  int corig[2][64];    // chroma source
  int cup[2][8], cleft[2][8], cul[2];
  I16Smem i16;         // I16 neighbours, costs and recon (common.cuh)
  // I4
  int cost[9], ssd[9], rate[9], lev9[9][16], rec9[9][16];
  int lev4[256], d4, bits4;
  // chroma
  int cdc[4][2][4], cdclev[4][2][4], cdcdeq[4][2][4];
  int crec[4][2][64], clev[4][2][4][16], cssd[4][2][4], ccb[4][2][4];
};

// chroma DC quadrants [TL, TR, BL, BR] and plane parameters of one plane
// (rd.py `_chroma_pred4`)
struct ChromaPar {
  int dc[4], a, b, c;
};

__device__ ChromaPar chroma_par(const Shared& s, int pl, int au, int al) {
  const int* up = s.cup[pl];
  const int* left = s.cleft[pl];
  int u0 = up[0] + up[1] + up[2] + up[3], u1 = up[4] + up[5] + up[6] + up[7];
  int l0 = left[0] + left[1] + left[2] + left[3];
  int l1 = left[4] + left[5] + left[6] + left[7];
  ChromaPar q;
  q.dc[0] = au && al ? (u0 + l0 + 4) >> 3
            : au     ? (u0 + 2) >> 2
            : al     ? (l0 + 2) >> 2
                     : 128;
  q.dc[1] = au ? (u1 + 2) >> 2 : al ? (l0 + 2) >> 2 : 128;
  q.dc[2] = al ? (l1 + 2) >> 2 : au ? (u0 + 2) >> 2 : 128;
  q.dc[3] = au && al ? (u1 + l1 + 4) >> 3
            : au     ? (u1 + 2) >> 2
            : al     ? (l1 + 2) >> 2
                     : 128;
  int hg = 0, vg = 0;
  for (int i = 0; i < 4; ++i) {
    hg += (i + 1) * (up[4 + i] - (i < 3 ? up[2 - i] : s.cul[pl]));
    vg += (i + 1) * (left[4 + i] - (i < 3 ? left[2 - i] : s.cul[pl]));
  }
  q.a = 16 * (left[7] + up[7]);
  q.b = (34 * hg + 32) >> 6;
  q.c = (34 * vg + 32) >> 6;
  return q;
}

// chroma prediction sample (y, x) of mode m [DC, HOR, VERT, PLANE]
__device__ __forceinline__ int predc(const Shared& s, const ChromaPar& q, int m,
                                     int pl, int y, int x) {
  if (m == 0) return q.dc[2 * (y >= 4) + (x >= 4)];
  if (m == 1) return s.cleft[pl][y];
  if (m == 2) return s.cup[pl][x];
  return clip255((q.a + q.b * (x - 3) + q.c * (y - 3) + 16) >> 5);
}

__global__ void __launch_bounds__(kThreads)
intra_commit_kernel(const int* __restrict__ cur_y, const int* __restrict__ cur_u,
                    const int* __restrict__ cur_v, const int* __restrict__ w_rec,
                    const int* __restrict__ recc,
                    const unsigned char* __restrict__ is_intra, int* Yp,
                    int* Up, int* Vp, int* ipm, int* w_lev, int* levc, int* dcc,
                    int* lum_dc, int* i16mode, int* cip, int* i4flag, int n_mx,
                    int t, int r0, int qp, int qp_c, int lam) {
  __shared__ Shared s;
  const int tid = threadIdx.x;
  const int r = r0 + blockIdx.x, c = t - 2 * r;
  const int i = r * n_mx + c;
  const int W = 16 * n_mx, Wc = 8 * n_mx;
  const int ys = W + 5, cs = Wc + 1, ms = 4 * n_mx + 1;  // carry strides
  const int au = r > 0, al = c > 0, avc = c < n_mx - 1;

  if (!is_intra[i]) {  // inter MB: copy the candidate results through
    for (int k = tid; k < 256; k += kThreads)
      Yp[(16 * r + 1 + (k >> 4)) * ys + 16 * c + 1 + (k & 15)] =
          w_rec[i * 256 + k];
    for (int k = tid; k < 128; k += kThreads) {
      int* P = k < 64 ? Up : Vp;
      int q = k & 63;
      P[(8 * r + 1 + (q >> 3)) * cs + 8 * c + 1 + (q & 7)] = recc[i * 128 + k];
    }
    if (tid < 16) {
      ipm[(4 * r + 1 + (tid >> 2)) * ms + 4 * c + 1 + (tid & 3)] = 2;
      lum_dc[i * 16 + tid] = 0;
    }
    if (tid == 0) i16mode[i] = cip[i] = i4flag[i] = 0;
    return;
  }

  const int per = qp / 6, rem = qp % 6;
  const int per_c = qp_c / 6, rem_c = qp_c % 6;
  const int off = 682 << (4 + per);     // default_offset4(qp, intra)
  const int off_c = 682 << (4 + per_c);

  // ---- load ---------------------------------------------------------------
  for (int k = tid; k < 17 * 21; k += kThreads)
    s.work[k / 21][k % 21] = Yp[(16 * r + k / 21) * ys + 16 * c + k % 21];
  for (int k = tid; k < 256; k += kThreads)
    s.orig[k] = cur_y[(16 * r + (k >> 4)) * W + 16 * c + (k & 15)];
  for (int k = tid; k < 128; k += kThreads) {
    const int* P = k < 64 ? cur_u : cur_v;
    int q = k & 63;
    s.corig[k >> 6][q] = P[(8 * r + (q >> 3)) * Wc + 8 * c + (q & 7)];
  }
  if (tid < 25) s.mw[tid / 5][tid % 5] = ipm[(4 * r + tid / 5) * ms + 4 * c + tid % 5];
  if (tid < 16) {
    s.i16.up[tid] = Yp[16 * r * ys + 16 * c + 1 + tid];
    s.i16.left[tid] = Yp[(16 * r + 1 + tid) * ys + 16 * c];
  }
  if (tid >= 32 && tid < 48) {
    int q = tid - 32, pl = q >> 3, k = q & 7;
    const int* P = pl ? Vp : Up;
    s.cup[pl][k] = P[8 * r * cs + 8 * c + 1 + k];
    s.cleft[pl][k] = P[(8 * r + 1 + k) * cs + 8 * c];
  }
  if (tid == 48) s.i16.ul = Yp[16 * r * ys + 16 * c];
  if (tid == 49) s.cul[0] = Up[8 * r * cs + 8 * c];
  if (tid == 50) s.cul[1] = Vp[8 * r * cs + 8 * c];
  __syncthreads();

  // ---- I16: Hadamard mode pick, transform / quant / recon (common.cuh) --
  const int mode16 = i16_code(s.i16, s.orig, au, al, per, rem, off, tid);

  // ---- I4x4: 16 dependent blocks, 9 modes each -----------------------------
  int d4 = 0, bits4 = 0;  // kept by thread 0
  for (int blk = 0; blk < 16; ++blk) {
    const int bx = kBlkX[blk], by = kBlkY[blk];
    const int px = 1 + 4 * bx, py = 1 + 4 * by;
    if (tid < 9) {
      const int m = tid;
      int au_b = by == 0 ? au : 1;
      int al_b = bx == 0 ? al : 1;
      int aur_b = by == 0 ? (bx == 3 ? au && avc : au) : kAurInt[blk];
      int aul_b = bx > 0 && by > 0 ? 1 : bx == 0 && by == 0 ? au && al
                  : bx == 0 ? al : au;
      int a3 = au_b && al_b && aul_b;
      const int valid[9] = {au_b, al_b, 1, au_b, a3, a3, a3, au_b, al_b};
      if (valid[m]) {
        int p[13];
        for (int k = 0; k < 4; ++k) {
          p[k] = au_b ? s.work[py - 1][px + k] : 128;
          p[8 + k] = al_b ? s.work[py + k][px - 1] : 128;
        }
        for (int k = 0; k < 4; ++k) p[4 + k] = aur_b ? s.work[py - 1][px + 4 + k] : p[3];
        p[12] = aul_b ? s.work[py - 1][px - 1] : 128;
        int pr4[16], cf[16], lev[16];
        pred4(m, p, au_b, al_b, pr4);
        for (int k = 0; k < 16; ++k)
          cf[k] = s.orig[16 * (4 * by + (k >> 2)) + 4 * bx + (k & 3)] - pr4[k];
        forward4x4(cf);
        for (int k = 0; k < 16; ++k) lev[k] = quant(cf[k], kM4[rem][cls4(k)], off, 15 + per);
        int cb = coef_bits16(lev);
        for (int k = 0; k < 16; ++k) cf[k] = dequant(lev[k], k, per, rem);
        inverse4x4(cf);
        int ssd = 0;
        for (int k = 0; k < 16; ++k) {
          int rec = clip255((cf[k] + shl(pr4[k], 6) + 32) >> 6);
          int dd = s.orig[16 * (4 * by + (k >> 2)) + 4 * bx + (k & 3)] - rec;
          ssd += dd * dd;
          s.rec9[m][k] = rec;
          s.lev9[m][k] = lev[k];
        }
        int lm = s.mw[1 + by][bx], um = s.mw[by][1 + bx];
        int mpm = lm < 0 || um < 0 ? 2 : min(lm, um);
        int mbits = m == mpm ? 1 : m < 3 ? 4 : 9;
        int rate = (cb * 3) / 4 + mbits;
        s.ssd[m] = ssd;
        s.rate[m] = rate;
        s.cost[m] = ssd + lam_cost(lam, rate);
      } else {
        s.cost[m] = kBig;
      }
    }
    __syncthreads();
    if (tid < 16) {
      int mode = 0;
      for (int m = 1; m < 9; ++m)
        if (s.cost[m] < s.cost[mode]) mode = m;
      s.work[py + (tid >> 2)][px + (tid & 3)] = s.rec9[mode][tid];
      s.lev4[16 * (4 * by + bx) + tid] = s.lev9[mode][tid];
      if (tid == 0) {
        d4 += s.ssd[mode];
        bits4 += s.rate[mode];
        s.mw[1 + by][1 + bx] = mode;
        s.d4 = d4;
        s.bits4 = bits4;
      }
    }
    __syncthreads();
  }

  // ---- chroma: 4 modes x 2 planes x 4 blocks -------------------------------
  int co[16], pr[16];
  const int validc[4] = {1, al, au, au && al};
  int cm = tid >> 3, cpl = (tid >> 2) & 1, cb = tid & 3;
  int cby = cb >> 1, cbx = cb & 1;
  if (tid < 32 && validc[cm]) {
    const ChromaPar qc = chroma_par(s, cpl, au, al);
    for (int k = 0; k < 16; ++k) {
      int y = 4 * cby + (k >> 2), x = 4 * cbx + (k & 3);
      pr[k] = predc(s, qc, cm, cpl, y, x);
      co[k] = s.corig[cpl][8 * y + x] - pr[k];
    }
    forward4x4(co);
    s.cdc[cm][cpl][cb] = co[0];
  }
  __syncthreads();
  if (tid < 8 && validc[tid >> 1]) {
    int m = tid >> 1, pl = tid & 1;
    const int* d = s.cdc[m][pl];
    int h[4] = {d[0] + d[1] + d[2] + d[3], d[0] - d[1] + d[2] - d[3],
                d[0] + d[1] - d[2] - d[3], d[0] - d[1] - d[2] + d[3]};
    int l[4];
    for (int k = 0; k < 4; ++k) {
      l[k] = quant(h[k], kM4[rem_c][0], 2 * off_c, 16 + per_c);
      s.cdclev[m][pl][k] = l[k];
    }
    int g[4] = {l[0] + l[1] + l[2] + l[3], l[0] - l[1] + l[2] - l[3],
                l[0] + l[1] - l[2] - l[3], l[0] - l[1] - l[2] + l[3]};
    for (int k = 0; k < 4; ++k) {  // truncating chroma-DC dequant
      int v = mul(g[k], kV4[rem_c][0] * 16);
      s.cdcdeq[m][pl][k] = per_c < 5 ? v >> (5 - per_c) : shl(v, per_c - 5);
    }
  }
  __syncthreads();
  if (tid < 32 && validc[cm]) {
    int lev[16];
    s.ccb[cm][cpl][cb] = tq_ac(co, lev, s.cdcdeq[cm][cpl][cb], per_c, rem_c, off_c);
    int ssd = 0;
    for (int k = 0; k < 16; ++k) {
      int y = 4 * cby + (k >> 2), x = 4 * cbx + (k & 3);
      int rec = clip255((co[k] + shl(pr[k], 6) + 32) >> 6);
      int dd = s.corig[cpl][8 * y + x] - rec;
      ssd += dd * dd;
      s.crec[cm][cpl][8 * y + x] = rec;
      s.clev[cm][cpl][cb][k] = lev[k];
    }
    s.cssd[cm][cpl][cb] = ssd;
  }
  __syncthreads();

  // ---- decisions (every thread, same values) --------------------------------
  int cmode = 0, best = 0;
  for (int m = 0; m < 4; ++m) {
    int cj = kBig;
    if (validc[m]) {
      int dsum = 0, bsum = 0, dcb = 0;
      for (int pl = 0; pl < 2; ++pl)
        for (int k = 0; k < 4; ++k) {
          dsum += s.cssd[m][pl][k];
          bsum += s.ccb[m][pl][k];
          int a = abs(s.cdclev[m][pl][k]);
          if (a > 0) dcb += 2 * bitlen(a) + 1;
        }
      cj = dsum + lam_cost(lam, ((bsum + dcb) * 3) / 4 + kChromaModeBits[m]);
    }
    if (m == 0 || cj < best) {
      best = cj;
      cmode = m;
    }
  }
  int D16 = 0, cb16 = s.i16.cbdc;
  for (int k = 0; k < 16; ++k) {
    D16 += s.i16.d16[k];
    cb16 += s.i16.cb16[k];
  }
  const int J16 = D16 + lam_cost(lam, (cb16 * 3) / 4 + 8);
  const int J4 = s.d4 + lam_cost(lam, s.bits4 + 9);
  const bool use4 = J4 < J16;

  // ---- commit the MB's tiles into the carry ---------------------------------
  for (int k = tid; k < 256; k += kThreads) {
    int y = k >> 4, x = k & 15;
    Yp[(16 * r + 1 + y) * ys + 16 * c + 1 + x] =
        use4 ? s.work[1 + y][1 + x] : s.i16.rec16[k];
    w_lev[i * 256 + k] = use4 ? s.lev4[k] : s.i16.lev16[k];
  }
  for (int k = tid; k < 128; k += kThreads) {
    int pl = k >> 6, q = k & 63;
    int* P = pl ? Vp : Up;
    P[(8 * r + 1 + (q >> 3)) * cs + 8 * c + 1 + (q & 7)] = s.crec[cmode][pl][q];
    levc[i * 128 + k] = s.clev[cmode][pl][(q >> 4)][q & 15];
  }
  if (tid < 16) {
    int y = tid >> 2, x = tid & 3;
    ipm[(4 * r + 1 + y) * ms + 4 * c + 1 + x] = use4 ? s.mw[1 + y][1 + x] : 2;
    lum_dc[i * 16 + tid] = use4 ? 0 : s.i16.dclev[tid];
  }
  if (tid < 8) dcc[i * 8 + tid] = s.cdclev[cmode][tid >> 2][tid & 3];
  if (tid == 0) {
    i16mode[i] = mode16;
    cip[i] = cmode;
    i4flag[i] = use4;
  }
}

}  // namespace

extern "C" int intra_commit_step(
    const int* cur_y, const int* cur_u, const int* cur_v, const int* w_rec,
    const int* recc, const unsigned char* is_intra, int* Yp, int* Up, int* Vp,
    int* ipm, int* w_lev, int* levc, int* dcc, int* lum_dc, int* i16mode,
    int* cip, int* i4flag, int n_mx, int t, int r0, int n_lanes, int qp,
    int qp_c, int lam, void* stream) {
  intra_commit_kernel<<<n_lanes, kThreads, 0, (cudaStream_t)stream>>>(
      cur_y, cur_u, cur_v, w_rec, recc, is_intra, Yp, Up, Vp, ipm, w_lev, levc,
      dcc, lum_dc, i16mode, cip, i4flag, n_mx, t, r0, qp, qp_c, lam);
  return (int)cudaGetLastError();
}
