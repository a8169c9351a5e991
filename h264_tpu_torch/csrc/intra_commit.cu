// K1: the whole intra commit scan of one picture, for Hopper (sm_90a).
//
// Replaces h264_tpu/encoder/rd.py:1415 `_intra_commit_scan` (the device
// program of rd.py:1645 `rd_i_pipeline`, also called by the P and B
// pipelines): its `mb_compute` (rd.py:1443-1580) and the scatter of `step`
// (rd.py:1599-1635) for every macroblock, in one launch.  The plain
// PyTorch version is h264_tpu_torch/encoder/rd.py `_intra_scan` (the
// reference's anti-diagonal steps, `_intra_step`); the wrapper is
// h264_tpu_torch/kernels/intra_commit.py.
//
// Between MBs: a persistent wavefront.  MB (r, c) reads only what (r, c-1),
// (r-1, c-1), (r-1, c) and (r-1, c+1) write, so any order that commits
// those four first gives the reference's result (tests/test_torch_intra.py
// test_commit_order_does_not_matter).  Each block takes MB rows in order
// from an atomic ticket and walks its row left to right.  Before an intra
// MB it waits until the row above has published column c+1 (or its end);
// after each MB it publishes c+1 in that row's progress counter.  Tickets
// are taken in order, so the row a block waits on is held by a block that
// is already running: the kernel cannot deadlock, whatever the residency.
// Publishing, waiting (thread 0) and the ticket are common.cuh's
// wavefront helpers, shared with K6 (deblock.cu).  Every read of the carry
// planes (written by other blocks during the launch) goes through L2
// (__ldcg).  A spin past 2^24 polls traps, so a broken dependency fails
// the launch instead of hanging it.  An inter MB
// (is_intra false) copies its results through and publishes at once,
// without waiting.
//
// Inside an MB (384 threads, three groups that meet only at the end):
//   warps 0-8  (288): I4x4.  The 16 blocks as a wavefront of 10 steps
//              (block (bx, by) at step 2 by + bx, two blocks a step at
//              most), each block's 9 modes x 16 samples one thread each:
//              prediction from a tap table, the transform passes, quant,
//              dequant, inverse and recon as 16-lane shuffles, bits and
//              SSD by shuffle sums, the first minimum over the modes by
//              strict < in mode order, then the chosen mode's lanes write
//              their recon into the workspace (named barrier 1, twice a
//              step).  Up-right samples are used only where the
//              reference's z-order has them (kAurInt), and the most
//              probable mode reads only the left and upper blocks, both
//              earlier steps, so the order gives z-order's result;
//   warps 9-10 (64): I16, the `i16_code` of common.cuh (named barrier 2);
//   warp 11    (32): chroma, 4 modes x 2 planes x 4 blocks (__syncwarp);
// then I16 vs I4 by J and the MB's tiles into the carry planes.
//
// Exactness.  Integer arithmetic only, in the reference's order: int32
// with wrapping products (computed unsigned) and arithmetic right shifts.
// `_bitlen` is 32 - __clz(a), which equals the reference's float32
// floor(log2(a)) + 1 on every level this path produces (|level| <= 6528;
// tests/test_torch_ops.py checks the range exhaustively).  Every argmin
// keeps the first index on ties (strict < in mode order), unavailable
// modes cost 1 << 29.  (cb * 3) / 4 only sees non-negative bit counts, so
// C's truncating division equals the reference's floor division.  Sums
// over lanes are integer sums, equal in any order.
//
// Bound.  The dependency chain: 2 n_my + n_mx - 2 MBs in sequence (56 at
// CIF, 168 at 1280x720), each one MB's latency (its I4 wavefront, the
// loads of its neighbours through L2 and the hand-over between blocks).
// Bytes and operations per picture are small by comparison (PERF.md).
//
// ptxas (sm_90a, nvcc -O3): 147 registers, a 48-byte stack frame (the
// shared I16 code is a call), 12,212 B shared memory, 3 barriers (the
// block's and the I4 and I16 groups'), no spills.

#include "common.cuh"

namespace {

constexpr int kI4 = 288;   // 2 blocks x 9 modes x 16 samples
constexpr int kI16 = 64;
constexpr int kThreads = kI4 + kI16 + 32;
constexpr int kBarI4 = 1, kBarI16 = 2;

// 4x4 z-order -> (bx, by), and the up-right availability of blocks
// inside the MB (rd.py `_I4_AUR_INT`)
__constant__ int kBlkX[16] = {0, 1, 0, 1, 2, 3, 2, 3, 0, 1, 0, 1, 2, 3, 2, 3};
__constant__ int kBlkY[16] = {0, 0, 1, 1, 0, 0, 1, 1, 2, 2, 3, 3, 2, 2, 3, 3};
__constant__ int kAurInt[16] = {0, 0, 1, 0, 0, 0, 1, 0, 1, 1, 1, 0, 1, 0, 1, 0};
// the z-order blocks of wavefront step 2 by + bx (-1: none)
__constant__ int kStep[10][2] = {{0, -1}, {1, -1}, {4, 2},  {5, 3},   {6, 8},
                                 {7, 9},  {12, 10}, {13, 11}, {14, -1}, {15, -1}};
// intra_chroma_pred_mode bins for DC, HOR, VERT, PLANE
__constant__ int kChromaModeBits[4] = {1, 2, 3, 3};

// Sample (y, x) = k of the 4x4 prediction of mode m (rd.py `_i4_pred9`)
// as taps on the 13 neighbours p (0-3 up A-D, 4-7 up-right E-H, 8-11 left
// I-L, 12 corner X): i0 | i1 << 4 | i2 << 8 | kind << 12, kind 0: p[i0];
// 1: (p[i0] + p[i1] + 1) >> 1; 2: (p[i0] + 2 p[i1] + p[i2] + 2) >> 2; 3
// (mode 2, DC): up sample x and left sample x, summed over the lanes of
// the row.  tests/test_torch_intra.py holds the table against
// `_i4_pred9`.
__constant__ int kTap[9][16] = {
    {0x0000, 0x0111, 0x0222, 0x0333, 0x0000, 0x0111, 0x0222, 0x0333, 0x0000,
     0x0111, 0x0222, 0x0333, 0x0000, 0x0111, 0x0222, 0x0333},
    {0x0888, 0x0888, 0x0888, 0x0888, 0x0999, 0x0999, 0x0999, 0x0999, 0x0aaa,
     0x0aaa, 0x0aaa, 0x0aaa, 0x0bbb, 0x0bbb, 0x0bbb, 0x0bbb},
    {0x3080, 0x3091, 0x30a2, 0x30b3, 0x3080, 0x3091, 0x30a2, 0x30b3, 0x3080,
     0x3091, 0x30a2, 0x30b3, 0x3080, 0x3091, 0x30a2, 0x30b3},
    {0x2210, 0x2321, 0x2432, 0x2543, 0x2321, 0x2432, 0x2543, 0x2654, 0x2432,
     0x2543, 0x2654, 0x2765, 0x2543, 0x2654, 0x2765, 0x2776},
    {0x20c8, 0x210c, 0x2210, 0x2321, 0x2c89, 0x20c8, 0x210c, 0x2210, 0x289a,
     0x2c89, 0x20c8, 0x210c, 0x29ab, 0x289a, 0x2c89, 0x20c8},
    {0x100c, 0x1110, 0x1221, 0x1332, 0x20c8, 0x210c, 0x2210, 0x2321, 0x298c,
     0x100c, 0x1110, 0x1221, 0x2a98, 0x20c8, 0x210c, 0x2210},
    {0x188c, 0x20c8, 0x210c, 0x2210, 0x1998, 0x298c, 0x188c, 0x20c8, 0x1aa9,
     0x2a98, 0x1998, 0x298c, 0x1bba, 0x2ba9, 0x1aa9, 0x2a98},
    {0x1110, 0x1221, 0x1332, 0x1443, 0x2210, 0x2321, 0x2432, 0x2543, 0x1221,
     0x1332, 0x1443, 0x1554, 0x2321, 0x2432, 0x2543, 0x2654},
    {0x1998, 0x2a98, 0x1aa9, 0x2ba9, 0x1aa9, 0x2ba9, 0x1bba, 0x2bba, 0x1bba,
     0x2bba, 0x0bbb, 0x0bbb, 0x0bbb, 0x0bbb, 0x0bbb, 0x0bbb}};

struct Shared {
  int orig[256];       // luma source of the MB, raster
  int work[17][21];    // bordered luma workspace (I4 recon goes here)
  int mw[5][5];        // 4x4 mode window (1-block border)
  int corig[2][64];    // chroma source
  int cup[2][8], cleft[2][8], cul[2];
  I16Smem i16;         // I16 neighbours, costs and recon (common.cuh)
  // I4: the modes' costs of each slot of a step, the chosen levels, and
  // the chosen distortion and rate of each block
  int cost[2][9], lev4[256], dblk[16], rblk[16];
  // chroma
  int cdc[4][2][4], cdclev[4][2][4], cdcdeq[4][2][4];
  int crec[4][2][64], clev[4][2][4][16], cssd[4][2][4], ccb[4][2][4];
  // the groups' results: J of I4 and I16, the I16 and chroma modes
  int j4, j16, mode16, cmode;
  int row;             // this block's ticket
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

__device__ __forceinline__ int chroma_valid(int m, int au, int al) {
  return m == 0 ? 1 : m == 1 ? al : m == 2 ? au : au && al;
}

// ---------------------------------------------------------------------------
// I4 on 16-lane groups: lane k = 4 y + x of a group holds sample (y, x)
// ---------------------------------------------------------------------------

// The 4-point transforms as sums over the 4 samples p_j of a line, each
// output position with its own coefficients: int32 sums and products wrap
// alike, so these equal the butterflies of ops/transforms.py exactly.
// forward: out_pos = sum_j kFwd[pos][j] p_j
__constant__ int kFwd[4][4] = {{1, 1, 1, 1}, {2, 1, -1, -2},
                               {1, -1, -1, 1}, {1, -2, 2, -1}};

// the samples p_0..p_3 of a line of the group: lanes base + j * stride
struct Line {
  int p0, p1, p2, p3;
};
__device__ __forceinline__ Line line_of(unsigned mask, int v, int base,
                                        int stride) {
  return {__shfl_sync(mask, v, base, 16),
          __shfl_sync(mask, v, base + stride, 16),
          __shfl_sync(mask, v, base + 2 * stride, 16),
          __shfl_sync(mask, v, base + 3 * stride, 16)};
}

// one forward pass: coefficients f of the lane's output position
__device__ __forceinline__ int fwd_pass(const Line& l, int4 f) {
  return mul(f.x, l.p0) + mul(f.y, l.p1) + mul(f.z, l.p2) + mul(f.w, l.p3);
}

// one inverse pass at output position pos: pos 0: w0 + w2 + w1 + (w3 >> 1);
// 1: w0 - w2 + (w1 >> 1) - w3; 2: w0 - w2 - (w1 >> 1) + w3; 3: w0 + w2 - w1
// - (w3 >> 1) (e0 +- e3, e1 +- e2 of ops/transforms.py); h = pos is 1 or 2
__device__ __forceinline__ int inv_pass(const Line& l, int pos, int h) {
  const int x1 = l.p1 >> h, x3 = l.p3 >> (1 - h);
  const int e = h ? l.p0 - l.p2 : l.p0 + l.p2;  // e1 : e0
  const int o = h ? x1 - x3 : x1 + x3;          // e2 : e3
  return pos < 2 ? e + o : e - o;
}

__device__ __forceinline__ int sum16(unsigned mask, int v) {
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(mask, v, o, 16);
  return v;
}

// One tap of the lane: neighbour i (0..12, as kTap) of the 4x4 block,
// as its workspace offset from the block's origin and the availability
// bit that gates it (0 up and up-right, 1 left, 2 corner); unavailable
// up / left / corner samples are 128, unavailable up-right ones repeat D
// (rd.py `_i4_pred9`).
struct Tap {
  int dy, dx, bit, ur;
};
__device__ __forceinline__ Tap tap_of(int i) {
  if (i < 8) return {-1, i, 0, i >= 4};
  if (i < 12) return {i - 8, -1, 1, 0};
  return {-1, -1, 2, 0};
}
__device__ __forceinline__ int fetch(const Shared& s, const Tap& t, int py,
                                     int px, int avm, int aur) {
  const int dx = t.ur && !aur ? 3 : t.dx;
  return (avm >> t.bit) & 1 ? s.work[py + t.dy][px + dx] : 128;
}

// The I4x4 decision of one MB by the 288 threads of warps 0-8 (`tid` <
// kI4), every one calling.  Leaves the recon in s.work, the levels in
// s.lev4, the modes in s.mw and J4 in s.j4.
__device__ void i4_mb(Shared& s, int tid, int au, int al, int avc, int per,
                      int off, int lam, int mf, int vf16, int tap) {
  const int slot = tid / 144, m = (tid % 144) >> 4, k = tid & 15;
  const int ky = k >> 2, kx = k & 3;
  const unsigned gmask = 0xffffu << (tid & 16);  // the lane's 16-lane group
  const Tap t0 = tap_of(tap & 15), t1 = tap_of((tap >> 4) & 15),
            t2 = tap_of((tap >> 8) & 15);
  const int kind = tap >> 12;
  const int4 fr = make_int4(kFwd[kx][0], kFwd[kx][1], kFwd[kx][2], kFwd[kx][3]);
  const int4 fc = make_int4(kFwd[ky][0], kFwd[ky][1], kFwd[ky][2], kFwd[ky][3]);
  const int hr = kx == 1 || kx == 2, hc = ky == 1 || ky == 2;
#pragma unroll
  for (int st = 0; st < 10; ++st) {
    const int blk = kStep[st][slot];
    // the second slot of a one-block step idles: its groups skip the work
    // and meet the others at the barriers
    const bool act = blk >= 0;
    const int bx = act ? kBlkX[blk] : 0, by = act ? kBlkY[blk] : 0;
    const int px = 1 + 4 * bx, py = 1 + 4 * by;
    int rec = 0, lev = 0, ssd = 0, rate = 0;
    if (act) {
      const int au_b = by == 0 ? au : 1;
      const int al_b = bx == 0 ? al : 1;
      const int aur_b = by == 0 ? (bx == 3 ? au && avc : au) : kAurInt[blk];
      const int aul_b = bx > 0 && by > 0 ? 1 : bx == 0 && by == 0 ? au && al
                        : bx == 0 ? al : au;
      const int a3 = au_b && al_b && aul_b;
      const int valid = m == 2 ? 1 : m == 1 || m == 8 ? al_b
                        : m == 0 || m == 3 || m == 7 ? au_b : a3;
      const int avm = au_b | al_b << 1 | aul_b << 2;
      const int o = s.orig[16 * (4 * by + ky) + 4 * bx + kx];
      const int a = fetch(s, t0, py, px, avm, aur_b);
      const int b = fetch(s, t1, py, px, avm, aur_b);
      const int c = fetch(s, t2, py, px, avm, aur_b);
      // DC (kind 3): its lanes hold up sample kx in a and left sample kx
      // in b; the sums over the row's 4 lanes are the 4-sample sums
      int su = a + __shfl_xor_sync(gmask, a, 1, 16);
      su += __shfl_xor_sync(gmask, su, 2, 16);
      int sl = b + __shfl_xor_sync(gmask, b, 1, 16);
      sl += __shfl_xor_sync(gmask, sl, 2, 16);
      const int dc = au_b && al_b ? (su + sl + 4) >> 3
                     : al_b       ? (sl + 2) >> 2
                     : au_b       ? (su + 2) >> 2
                                  : 128;
      const int pr = kind == 0 ? a : kind == 1 ? (a + b + 1) >> 1
                   : kind == 2 ? (a + 2 * b + c + 2) >> 2 : dc;
      // forward (rows, then columns), quant, bits, dequant, inverse, recon
      int v = fwd_pass(line_of(gmask, o - pr, 4 * ky, 1), fr);
      v = fwd_pass(line_of(gmask, v, kx, 4), fc);
      lev = quant(v, mf, off, 15 + per);
      const int al_ = abs(lev);
      const int bits = sum16(gmask, al_ > 0 ? ((2 * bitlen(al_) + 1) << 5) + 1 : 0);
      int w = (shl(mul(lev, vf16), per) + 8) >> 4;
      w = inv_pass(line_of(gmask, w, 4 * ky, 1), kx, hr);
      w = inv_pass(line_of(gmask, w, kx, 4), ky, hc);
      rec = clip255((w + shl(pr, 6) + 32) >> 6);
      const int dd = o - rec;
      ssd = sum16(gmask, dd * dd);
      const int n = bits & 31;
      const int cb = n > 0 ? (bits >> 5) + n + 2 : 0;
      const int lm = s.mw[1 + by][bx], um = s.mw[by][1 + bx];
      const int mpm = lm < 0 || um < 0 ? 2 : min(lm, um);
      const int mbits = m == mpm ? 1 : m < 3 ? 4 : 9;
      rate = (cb * 3) / 4 + mbits;
      if (k == 0) s.cost[slot][m] = valid ? ssd + lam_cost(lam, rate) : kBig;
    }
    group_sync<kBarI4, kI4>();
    if (act) {
      int best = 0, bc = s.cost[slot][0];
      for (int mm = 1; mm < 9; ++mm) {
        const int cm = s.cost[slot][mm];
        if (cm < bc) {
          bc = cm;
          best = mm;
        }
      }
      if (m == best) {
        s.work[py + ky][px + kx] = rec;
        s.lev4[16 * (4 * by + bx) + k] = lev;
        if (k == 0) {
          s.mw[1 + by][1 + bx] = best;
          s.dblk[blk] = ssd;
          s.rblk[blk] = rate;
        }
      }
    }
    group_sync<kBarI4, kI4>();
  }
  if (tid == 0) {
    int d4 = 0, bits4 = 0;
    for (int b = 0; b < 16; ++b) {
      d4 += s.dblk[b];
      bits4 += s.rblk[b];
    }
    s.j4 = d4 + lam_cost(lam, bits4 + 9);
  }
}

// The chroma decision of one MB by warp 11 (lane `lc`): leaves the
// recon, levels and DC levels of every mode in shared memory and the
// chosen mode in s.cmode.
__device__ void chroma_mb(Shared& s, int lc, int au, int al, int per_c,
                          int rem_c, int off_c, int lam) {
  int co[16], pr[16];
  const int cm = lc >> 3, cpl = (lc >> 2) & 1, cb = lc & 3;
  const int cby = cb >> 1, cbx = cb & 1;
  const int vm = chroma_valid(cm, au, al);
  if (vm) {
    const ChromaPar qc = chroma_par(s, cpl, au, al);
    for (int k = 0; k < 16; ++k) {
      int y = 4 * cby + (k >> 2), x = 4 * cbx + (k & 3);
      pr[k] = predc(s, qc, cm, cpl, y, x);
      co[k] = s.corig[cpl][8 * y + x] - pr[k];
    }
    forward4x4(co);
    s.cdc[cm][cpl][cb] = co[0];
  }
  __syncwarp();
  if (lc < 8 && chroma_valid(lc >> 1, au, al)) {
    int m = lc >> 1, pl = lc & 1;
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
  __syncwarp();
  if (vm) {
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
  __syncwarp();
  if (lc == 0) {
    int cmode = 0, best = 0;
    for (int m = 0; m < 4; ++m) {
      int cj = kBig;
      if (chroma_valid(m, au, al)) {
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
    s.cmode = cmode;
  }
}

__global__ void __launch_bounds__(kThreads, 1)
intra_scan_kernel(const int* __restrict__ cur_y, const int* __restrict__ cur_u,
                  const int* __restrict__ cur_v, const int* __restrict__ w_rec,
                  const int* __restrict__ recc,
                  const unsigned char* __restrict__ is_intra, int* Yp, int* Up,
                  int* Vp, int* ipm, int* w_lev, int* levc, int* dcc,
                  int* lum_dc, int* i16mode, int* cip, int* i4flag, int* sync,
                  int n_my, int n_mx, int qp, int qp_c, int lam) {
  __shared__ Shared s;
  const int tid = threadIdx.x;
  const int W = 16 * n_mx, Wc = 8 * n_mx;
  const int ys = W + 5, cs = Wc + 1, ms = 4 * n_mx + 1;  // carry strides
  const int per = qp / 6, rem = qp % 6;
  const int per_c = qp_c / 6, rem_c = qp_c % 6;
  const int off = 682 << (4 + per);     // default_offset4(qp, intra)
  const int off_c = 682 << (4 + per_c);
  int* ticket = sync;
  int* done = sync + 1;  // done[r]: columns of MB row r committed
  // the I4 lanes' constants: quant / dequant factors of their sample and
  // the prediction taps of their (mode, sample)
  int mf = 0, vf16 = 0, tap = 0;
  if (tid < kI4) {
    const int k = tid & 15, m = (tid % 144) >> 4;
    mf = kM4[rem][cls4(k)];
    vf16 = kV4[rem][cls4(k)] * 16;
    tap = kTap[m][k];
  }
  long long polls = 0;

  for (;;) {
    const int r = take_row(ticket, &s.row);
    if (r >= n_my) return;
    int seen = 0;  // thread 0: the last value read from done[r - 1]
    for (int c = 0; c < n_mx; ++c) {
      const int i = r * n_mx + c;
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
      } else {
        // the sources first: nothing else writes them
        for (int k = tid; k < 256; k += kThreads)
          s.orig[k] = cur_y[(16 * r + (k >> 4)) * W + 16 * c + (k & 15)];
        for (int k = tid; k < 128; k += kThreads) {
          const int* P = k < 64 ? cur_u : cur_v;
          int q = k & 63;
          s.corig[k >> 6][q] = P[(8 * r + (q >> 3)) * Wc + 8 * c + (q & 7)];
        }
        // wait for (r-1, c+1), or the end of row r-1
        if (tid == 0 && r > 0)
          wait_for(done + r - 1, min(c + 2, n_mx), seen, polls);
        __syncthreads();
        for (int k = tid; k < 17 * 21; k += kThreads)
          s.work[k / 21][k % 21] = __ldcg(Yp + (16 * r + k / 21) * ys + 16 * c + k % 21);
        if (tid < 25)
          s.mw[tid / 5][tid % 5] = __ldcg(ipm + (4 * r + tid / 5) * ms + 4 * c + tid % 5);
        if (tid >= 32 && tid < 48) {
          int q = tid - 32;
          s.i16.up[q] = __ldcg(Yp + 16 * r * ys + 16 * c + 1 + q);
          s.i16.left[q] = __ldcg(Yp + (16 * r + 1 + q) * ys + 16 * c);
        }
        if (tid >= 64 && tid < 80) {
          int q = tid - 64, pl = q >> 3, k = q & 7;
          const int* P = pl ? Vp : Up;
          s.cup[pl][k] = __ldcg(P + 8 * r * cs + 8 * c + 1 + k);
          s.cleft[pl][k] = __ldcg(P + (8 * r + 1 + k) * cs + 8 * c);
        }
        if (tid == 96) s.i16.ul = __ldcg(Yp + 16 * r * ys + 16 * c);
        if (tid == 97) s.cul[0] = __ldcg(Up + 8 * r * cs + 8 * c);
        if (tid == 98) s.cul[1] = __ldcg(Vp + 8 * r * cs + 8 * c);
        __syncthreads();

        // ---- the three groups ---------------------------------------------
        if (tid < kI4) {
          i4_mb(s, tid, au, al, avc, per, off, lam, mf, vf16, tap);
        } else if (tid < kI4 + kI16) {
          const int lt = tid - kI4;
          const int mode16 = i16_code<kBarI16, kI16>(s.i16, s.orig, au, al,
                                                     per, rem, off, lt);
          group_sync<kBarI16, kI16>();
          if (lt == 0) {
            int D16 = 0, cb16 = s.i16.cbdc;
            for (int k = 0; k < 16; ++k) {
              D16 += s.i16.d16[k];
              cb16 += s.i16.cb16[k];
            }
            s.j16 = D16 + lam_cost(lam, (cb16 * 3) / 4 + 8);
            s.mode16 = mode16;
          }
        } else {
          chroma_mb(s, tid - kI4 - kI16, au, al, per_c, rem_c, off_c, lam);
        }
        __syncthreads();

        // ---- commit the MB's tiles into the carry -------------------------
        const bool use4 = s.j4 < s.j16;
        const int cmode = s.cmode;
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
        if (tid >= 32 && tid < 40) {
          int q = tid - 32;
          dcc[i * 8 + q] = s.cdclev[cmode][q >> 2][q & 3];
        }
        if (tid == 64) {
          i16mode[i] = s.mode16;
          cip[i] = cmode;
          i4flag[i] = use4;
        }
      }
      // publish (r, c): every write of the MB before the counter moves
      publish(done + r, c + 1);
    }
  }
}

}  // namespace

extern "C" int intra_commit_scan(
    const int* cur_y, const int* cur_u, const int* cur_v, const int* w_rec,
    const int* recc, const unsigned char* is_intra, int* Yp, int* Up, int* Vp,
    int* ipm, int* w_lev, int* levc, int* dcc, int* lum_dc, int* i16mode,
    int* cip, int* i4flag, int* sync, int n_my, int n_mx, int qp, int qp_c,
    int lam, void* stream) {
  intra_scan_kernel<<<n_my, kThreads, 0, (cudaStream_t)stream>>>(
      cur_y, cur_u, cur_v, w_rec, recc, is_intra, Yp, Up, Vp, ipm, w_lev, levc,
      dcc, lum_dc, i16mode, cip, i4flag, sync, n_my, n_mx, qp, qp_c, lam);
  return (int)cudaGetLastError();
}
