// Device helpers shared by the port's kernels (sm_90a): exact JM integer
// arithmetic for transforms, quantization, rates and costs, the quarter-
// pel bank layout, the I16 decision that both the intra commit (K1,
// intra_commit.cu) and the P picture's I16 candidate (K5, inter_tq.cu)
// run, and the persistent MB-row wavefront of K1 and the filter (K6,
// deblock.cu).  Every function computes what the reference package's
// encoder/rd.py computes, in its order: int32 with wrapping products
// (computed unsigned) and arithmetic right shifts.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kBig = 1 << 29;
constexpr int kPad = 32;  // reference-plane padding (rd.py PAD)

// encoder MF (quant) and normAdjust4x4 (dequant) per qp%6 and position
// class (0: both coords even, 1: both odd, 2: mixed)
__constant__ int kM4[6][3] = {
    {13107, 5243, 8066}, {11916, 4660, 7490}, {10082, 4194, 6554},
    {9362, 3647, 5825},  {8192, 3355, 5243},  {7282, 2893, 4559}};
__constant__ int kV4[6][3] = {
    {10, 16, 13}, {11, 18, 14}, {13, 20, 16},
    {14, 23, 18}, {16, 25, 20}, {18, 29, 23}};

__device__ __forceinline__ int mul(int a, int b) {
  return (int)((unsigned)a * (unsigned)b);
}
__device__ __forceinline__ int shl(int a, int n) {
  return (int)((unsigned)a << n);
}
__device__ __forceinline__ int clip255(int v) { return min(max(v, 0), 255); }
__device__ __forceinline__ int clampi(int v, int hi) {
  return min(max(v, 0), hi);
}
// floor(log2(a)) + 1 for a >= 1: equal to the reference's float32 form
// below 8192, which bounds every argument on the I and P paths
__device__ __forceinline__ int bitlen(int a) { return 32 - __clz(a); }
__device__ __forceinline__ int cls4(int k) {
  int y = k >> 2, x = k & 3;
  return ((y | x) & 1) == 0 ? 0 : ((y & x) & 1) ? 1 : 2;
}

// lambda * bits, lambda in <<16 fixed point (rd.py `_lam_cost`)
__device__ __forceinline__ int lam_cost(int lam, int bits) {
  return mul(lam >> 16, bits) + (mul(lam & 0xFFFF, bits) >> 16);
}

// se(v) code length of d (rd.py `_mv_bits`)
__device__ __forceinline__ int mv_bits(int d) {
  int k = 2 * abs(d) - (d > 0);
  return 2 * bitlen(k + 1) - 1;
}

// explicit weighted prediction, logWD = 5 (rd.py `_wp_affine`)
__device__ __forceinline__ int wp_affine(int x, int w, int o) {
  return clip255(((mul(x, w) + 16) >> 5) + o);
}

// approximate CAVLC bits of 16 levels (rd.py `_coef_bits`)
__device__ int coef_bits16(const int* lev) {
  int lb = 0, n = 0;
  for (int k = 0; k < 16; ++k) {
    int a = abs(lev[k]);
    if (a > 0) {
      lb += 2 * bitlen(a) + 1;
      ++n;
    }
  }
  return n > 0 ? lb + n + 2 : 0;
}

// 4x4 transforms on a raster block b[4*y + x]: a pass along x for every
// row, then along y for every column (ops/transforms.py order)
__device__ void forward4x4(int* b) {
  for (int p = 0; p < 2; ++p) {
    for (int u = 0; u < 4; ++u) {
      int s = p == 0 ? 4 * u : u, d = p == 0 ? 1 : 4;
      int p0 = b[s], p1 = b[s + d], p2 = b[s + 2 * d], p3 = b[s + 3 * d];
      int t0 = p0 + p3, t1 = p1 + p2, t2 = p1 - p2, t3 = p0 - p3;
      b[s] = t0 + t1;
      b[s + d] = shl(t3, 1) + t2;
      b[s + 2 * d] = t0 - t1;
      b[s + 3 * d] = t3 - shl(t2, 1);
    }
  }
}

__device__ void inverse4x4(int* b) {
  for (int p = 0; p < 2; ++p) {
    for (int u = 0; u < 4; ++u) {
      int s = p == 0 ? 4 * u : u, d = p == 0 ? 1 : 4;
      int w0 = b[s], w1 = b[s + d], w2 = b[s + 2 * d], w3 = b[s + 3 * d];
      int e0 = w0 + w2, e1 = w0 - w2, e2 = (w1 >> 1) - w3, e3 = w1 + (w3 >> 1);
      b[s] = e0 + e3;
      b[s + d] = e1 + e2;
      b[s + 2 * d] = e1 - e2;
      b[s + 3 * d] = e0 - e3;
    }
  }
}

__device__ void hadamard4x4(int* b) {
  for (int p = 0; p < 2; ++p) {
    for (int u = 0; u < 4; ++u) {
      int s = p == 0 ? 4 * u : u, d = p == 0 ? 1 : 4;
      int w0 = b[s], w1 = b[s + d], w2 = b[s + 2 * d], w3 = b[s + 3 * d];
      int e0 = w0 + w2, e1 = w0 - w2, e2 = w1 - w3, e3 = w1 + w3;
      b[s] = e0 + e3;
      b[s + d] = e1 + e2;
      b[s + 2 * d] = e1 - e2;
      b[s + 3 * d] = e0 - e3;
    }
  }
}

__device__ __forceinline__ int quant(int c, int mf, int off, int qbits) {
  int lev = (mul(abs(c), mf) + off) >> qbits;
  return c < 0 ? -lev : lev;
}

// level -> dequantized coefficient, position k of a 4x4 block
__device__ __forceinline__ int dequant(int lev, int k, int per, int rem) {
  return (shl(mul(lev, kV4[rem][cls4(k)] * 16), per) + 8) >> 4;
}

// quantize the AC of a 4x4 block of coefficients into levels (the DC is
// coded separately: level 0 here), return their bits, and replace c[] by
// the inverse transform of the dequantized block with `dc_deq` as its DC
__device__ int tq_ac(int* c, int* lev, int dc_deq, int per, int rem,
                     int off) {
  for (int k = 0; k < 16; ++k)
    lev[k] = k == 0 ? 0 : quant(c[k], kM4[rem][cls4(k)], off, 15 + per);
  int cb = coef_bits16(lev);
  for (int k = 0; k < 16; ++k)
    c[k] = k == 0 ? dc_deq : dequant(lev[k], k, per, rem);
  inverse4x4(c);
  return cb;
}

// ---------------------------------------------------------------------------
// I16: mode pick by Hadamard cost, then transform / quant / recon
// ---------------------------------------------------------------------------

// what the I16 decision of one MB reads and writes in shared memory
struct I16Smem {
  int up[16], left[16], ul;  // neighbours (the caller loads them)
  int ac[4][16], h00[4][16], sad[4];
  int dc[16], dclev[16], dcdeq[16], cbdc;
  int rec16[256], lev16[256], d16[16], cb16[16];
};

// ---------------------------------------------------------------------------
// A persistent wavefront over MB rows (K1 intra_commit.cu, K6 deblock.cu)
// ---------------------------------------------------------------------------
// Blocks take MB rows in order from an atomic ticket and walk each row left
// to right; a row's progress counter holds the columns it has finished.
// Publishing is __syncthreads, __threadfence and st.release.gpu by one
// thread; waiting is one thread spinning on ld.acquire.gpu, then a barrier; the
// waiting block reads what other blocks wrote during the launch through L2
// (__ldcg).  Tickets are taken in order, so the row a block waits on is
// held by a block that is already running: no residency deadlocks.  A spin
// past kMaxPolls polls traps, so a broken dependency fails the launch
// instead of hanging it.

constexpr long long kMaxPolls = 1LL << 24;

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// The block's next MB row: thread 0 takes a ticket into *slot, every
// thread returns it.  The caller passes a barrier between reading the row
// and the next call.
__device__ __forceinline__ int take_row(int* ticket, int* slot) {
  if (threadIdx.x == 0) *slot = atomicAdd(ticket, 1);
  __syncthreads();
  return *slot;
}

// One thread: spin until the counter *p reaches `need`.  `seen` carries
// the last value read (counters only grow within a launch), `polls` the
// launch's poll count.
__device__ __forceinline__ void wait_for(const int* p, int need, int& seen,
                                         long long& polls) {
  while (seen < need) {
    seen = ld_acquire(p);
    if (++polls > kMaxPolls) __trap();
  }
}

// Publish `v` into the counter *p after every write of the block: a
// barrier, then thread `who` fences and releases.
__device__ __forceinline__ void publish(int* p, int v, int who = 0) {
  __syncthreads();
  if (threadIdx.x == who) {
    __threadfence();
    st_release(p, v);
  }
}

// I16 DC value and plane parameters (rd.py `_i16_pred_all`)
struct I16Par {
  int dc, a, b, c;
};

__device__ I16Par i16_par(const I16Smem& s, int au, int al) {
  int su = 0, sl = 0, hg = 0, vg = 0;
  for (int k = 0; k < 16; ++k) {
    su += s.up[k];
    sl += s.left[k];
  }
  for (int i = 0; i < 8; ++i) {
    hg += (i + 1) * (s.up[8 + i] - (i < 7 ? s.up[6 - i] : s.ul));
    vg += (i + 1) * (s.left[8 + i] - (i < 7 ? s.left[6 - i] : s.ul));
  }
  I16Par q;
  q.dc = au && al ? (su + sl + 16) >> 5
         : au     ? (su + 8) >> 4
         : al     ? (sl + 8) >> 4
                  : 128;
  q.a = 16 * (s.left[15] + s.up[15]);
  q.b = (5 * hg + 32) >> 6;
  q.c = (5 * vg + 32) >> 6;
  return q;
}

// I16 prediction sample (y, x) of mode m [VERT, HOR, DC, PLANE]
__device__ __forceinline__ int pred16(const I16Smem& s, const I16Par& q,
                                      int m, int y, int x) {
  if (m == 0) return s.up[x];
  if (m == 1) return s.left[y];
  if (m == 2) return q.dc;
  return clip255((q.a + q.b * (x - 7) + q.c * (y - 7) + 16) >> 5);
}

// The barrier of a group of threads: the whole block (kBar 0), or named
// barrier kBar of kN threads (a multiple of 32), so that a group of warps
// can synchronize while the block's other warps run other work.  The named
// one is barrier.sync without .aligned: the threads of a warp may reach it
// apart, from divergent code.
template <int kBar, int kN>
__device__ __forceinline__ void group_sync() {
  if constexpr (kBar == 0)
    __syncthreads();
  else
    asm volatile("barrier.sync %0, %1;" ::"n"(kBar), "n"(kN) : "memory");
}

// The I16 decision and coding of one MB by a group of at least 64
// threads (the block, or kN threads meeting at named barrier kBar), every
// thread of the group calling with its index `tid` in the group: the
// Hadamard mode pick (64 threads = 4 modes x 16 4x4 blocks, first minimum
// wins, unavailable modes cost 1 << 29), then the DC Hadamard, quant and
// recon of the chosen mode (16 threads).  `orig` holds the MB's 256
// source samples in shared memory.  Fills s.rec16, s.lev16, s.d16, s.cb16,
// s.dclev and s.cbdc, the last of them written by threads < 16 after the
// final barrier; returns the mode.
template <int kBar = 0, int kN = 0>
__device__ int i16_code(I16Smem& s, const int* orig, int au, int al, int per,
                        int rem, int off, int tid) {
  const int valid16[4] = {au, al, 1, au && al};
  const I16Par q16 = i16_par(s, au, al);
  if (tid < 64) {
    int m = tid >> 4, blk = tid & 15, by = blk >> 2, bx = blk & 3;
    if (valid16[m]) {
      int h[16];
      for (int k = 0; k < 16; ++k) {
        int y = 4 * by + (k >> 2), x = 4 * bx + (k & 3);
        h[k] = orig[16 * y + x] - pred16(s, q16, m, y, x);
      }
      hadamard4x4(h);
      int sa = 0;
      for (int k = 0; k < 16; ++k) sa += abs(h[k]);
      s.ac[m][blk] = sa - abs(h[0]);
      s.h00[m][blk] = h[0];
    }
  }
  group_sync<kBar, kN>();
  if (tid < 4) {
    int m = tid;
    if (valid16[m]) {
      int h[16], sa = 0;
      for (int k = 0; k < 16; ++k) {
        h[k] = s.h00[m][k];
        sa += s.ac[m][k];
      }
      hadamard4x4(h);
      for (int k = 0; k < 16; ++k) sa += abs(h[k]);
      s.sad[m] = sa >> 1;
    } else {
      s.sad[m] = kBig;
    }
  }
  group_sync<kBar, kN>();
  int mode16 = 0;
  for (int m = 1; m < 4; ++m)
    if (s.sad[m] < s.sad[mode16]) mode16 = m;

  int co[16], pr[16];
  if (tid < 16) {
    int by = tid >> 2, bx = tid & 3;
    for (int k = 0; k < 16; ++k) {
      int y = 4 * by + (k >> 2), x = 4 * bx + (k & 3);
      pr[k] = pred16(s, q16, mode16, y, x);
      co[k] = orig[16 * y + x] - pr[k];
    }
    forward4x4(co);
    s.dc[tid] = co[0];
  }
  group_sync<kBar, kN>();
  if (tid == 0) {
    int d[16];
    for (int k = 0; k < 16; ++k) d[k] = s.dc[k];
    hadamard4x4(d);
    for (int k = 0; k < 16; ++k) {
      s.dclev[k] = quant(d[k] >> 1, kM4[rem][0], 2 * off, 16 + per);
      d[k] = s.dclev[k];
    }
    s.cbdc = coef_bits16(s.dclev);
    hadamard4x4(d);  // dequant_luma_dc: rshift_rnd((x * ILS00) << per, 6)
    for (int k = 0; k < 16; ++k)
      s.dcdeq[k] = (shl(mul(d[k], kV4[rem][0] * 16), per) + 32) >> 6;
  }
  group_sync<kBar, kN>();
  if (tid < 16) {
    int by = tid >> 2, bx = tid & 3, lev[16];
    s.cb16[tid] = tq_ac(co, lev, s.dcdeq[tid], per, rem, off);
    int ssd = 0;
    for (int k = 0; k < 16; ++k) {
      int y = 4 * by + (k >> 2), x = 4 * bx + (k & 3);
      int rec = clip255((co[k] + shl(pr[k], 6) + 32) >> 6);
      int dd = orig[16 * y + x] - rec;
      ssd += dd * dd;
      s.rec16[16 * y + x] = rec;
      s.lev16[16 * tid + k] = lev[k];
    }
    s.d16[tid] = ssd;
  }
  return mode16;
}

}  // namespace
