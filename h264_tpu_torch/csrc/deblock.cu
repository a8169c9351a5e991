// K6: boundary strengths and the in-loop deblocking filter of P and B
// pictures, for Hopper (sm_90a).
//
// Replaces h264_tpu/encoder/rd.py:1713 `strengths_full` and :1800
// `deblock_device_full` (with `_edge_luma_full` :1741 and
// `_edge_chroma_full` :1784), as `rd_p_pipeline` calls them (:1124-1160)
// and `rd_b_pipeline` (:2503-2507), and :1928 `strengths_full_b`.
// Plain versions: h264_tpu_torch/encoder/rd_p.py `strengths_plain`,
// `deblock_plain`, rd_b.py `strengths_b_plain`; wrapper kernels/deblock.py.
//
// strengths: one thread per 4x4 block computes the bS 0..4 of its left
// and its top edge (0 on picture edges): 4/3 when either side is intra
// (MB edge / inside), else 2 with coefficients, else 1 on a reference or
// >= 4 quarter-pel mv difference.
//
// strengths_b: the same per-thread layout with the B picture's two-list
// rule (ldecod/src/loopFilter.c): a list's reference id is the POC of its
// picture where the block uses the list, else -10^9; the pairs match
// straight (p0 = q0, p1 = q1) or crossed (p0 = q1, p1 = q0), else bS 1;
// matched blocks compare the mvs of the matching lists (both pairings
// when the two refs of q are one picture).
//
// deblock: the reference filters MBs in raster order, per MB luma
// vertical edges 0-3, luma horizontal edges 0-3, then U and V, vertical
// then horizontal (bS 4 takes the strong filter).  MB (r, c) reads
// picture rows 16r-4..16r+15 and cols 16c-4..16c+15 (half in chroma) and
// writes inside them.  The MBs of one anti-diagonal t = 2r + c touch
// disjoint regions, and an MB whose region meets (r, c)'s precedes it in
// raster order exactly when it lies on an earlier diagonal, so filtering
// diagonal by diagonal gives the raster result (the plain version does
// the same).  The C entry launches one grid per diagonal, one block of
// one warp per MB: lanes 0-15 filter the luma lines of the current edge,
// lanes 16-23 and 24-31 the U and V lines (planes are independent), with
// __syncwarp between edges.  Lines whose bS is 0 are skipped, so no read
// leaves the picture.  The caller's planes are copied first (stream-
// ordered cudaMemcpyAsync), the filter works in place on the copies.
//
// Bound.  The chain of 2 n_my + n_mx - 2 diagonals, 8 dependent edge
// steps each; bytes (each plane read and written once) are small.
//
// ptxas (sm_90a, nvcc -O3): strengths_kernel 23 registers, deblock_kernel
// 54 registers, no shared memory, no spills.

#include "common.cuh"

namespace {

struct Thr {
  int alpha, beta, c0[4];
};

__global__ void strengths_kernel(const unsigned char* __restrict__ nz4,
                                 const int* __restrict__ mvx4,
                                 const int* __restrict__ mvy4,
                                 const int* __restrict__ ref4,
                                 const unsigned char* __restrict__ intra4,
                                 int H4, int W4, int* bsv, int* bsh) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= H4 * W4) return;
  const int y = k / W4, x = k % W4;
  for (int dir = 0; dir < 2; ++dir) {
    int* out = dir == 0 ? bsv : bsh;
    const int pos = dir == 0 ? x : y;
    if (pos == 0) {
      out[k] = 0;
      continue;
    }
    const int p = dir == 0 ? k - 1 : k - W4;
    int bs;
    if (intra4[k] || intra4[p]) {
      bs = pos % 4 == 0 ? 4 : 3;
    } else if (nz4[k] || nz4[p]) {
      bs = 2;
    } else {
      bs = (abs(mvx4[k] - mvx4[p]) >= 4 || abs(mvy4[k] - mvy4[p]) >= 4 ||
            ref4[k] != ref4[p]) ? 1 : 0;
    }
    out[k] = bs;
  }
}

__global__ void strengths_b_kernel(
    const unsigned char* __restrict__ nz4,
    const unsigned char* __restrict__ intra4,
    const unsigned char* __restrict__ v0, const int* __restrict__ r0,
    const int* __restrict__ m0x, const int* __restrict__ m0y,
    const unsigned char* __restrict__ v1, const int* __restrict__ r1,
    const int* __restrict__ m1x, const int* __restrict__ m1y, int H4, int W4,
    int* bsv, int* bsh) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= H4 * W4) return;
  const int kNone = -1000000000;
  const int y = k / W4, x = k % W4;
  for (int dir = 0; dir < 2; ++dir) {
    int* out = dir == 0 ? bsv : bsh;
    const int pos = dir == 0 ? x : y;
    if (pos == 0) {
      out[k] = 0;
      continue;
    }
    const int p = dir == 0 ? k - 1 : k - W4;
    int bs;
    if (intra4[k] || intra4[p]) {
      bs = pos % 4 == 0 ? 4 : 3;
    } else if (nz4[k] || nz4[p]) {
      bs = 2;
    } else {
      const int rq0 = v0[k] ? r0[k] : kNone, rq1 = v1[k] ? r1[k] : kNone;
      const int rp0 = v0[p] ? r0[p] : kNone, rp1 = v1[p] ? r1[p] : kNone;
      if ((rq0 == rp0 && rq1 == rp1) || (rq0 == rp1 && rq1 == rp0)) {
        const bool d00 = abs(m0x[k] - m0x[p]) >= 4 || abs(m0y[k] - m0y[p]) >= 4;
        const bool d11 = abs(m1x[k] - m1x[p]) >= 4 || abs(m1y[k] - m1y[p]) >= 4;
        const bool d01 = abs(m0x[k] - m1x[p]) >= 4 || abs(m0y[k] - m1y[p]) >= 4;
        const bool d10 = abs(m1x[k] - m0x[p]) >= 4 || abs(m1y[k] - m0y[p]) >= 4;
        bool mv_d;
        if (rq0 != rq1)
          mv_d = rq0 == rp0 ? (d00 || d11) : (d01 || d10);
        else
          mv_d = (d00 || d11) && (d01 || d10);
        bs = mv_d ? 1 : 0;
      } else {
        bs = 1;
      }
    }
    out[k] = bs;
  }
}

__device__ __forceinline__ int clip3(int lo, int hi, int v) {
  return min(max(v, lo), hi);
}

// one luma line across an edge: v[0..7] = p3 p2 p1 p0 q0 q1 q2 q3, at
// `stride` apart from `base`; bS > 0
__device__ void luma_line(int* P, long long base, long long stride, int S,
                          const Thr& t) {
  int v[8];
  for (int k = 0; k < 8; ++k) v[k] = P[base + (k - 4) * stride];
  const int L3 = v[0], L2 = v[1], L1 = v[2], L0 = v[3];
  const int R0 = v[4], R1 = v[5], R2 = v[6], R3 = v[7];
  const int delta = R0 - L0;
  if (!(abs(delta) < t.alpha && abs(R0 - R1) < t.beta && abs(L0 - L1) < t.beta))
    return;
  const int ap = abs(L0 - L2) < t.beta, aq = abs(R0 - R2) < t.beta;
  int o[6];
  if (S == 4) {
    const int small = abs(delta) < ((t.alpha >> 2) + 2);
    const int sp = ap && small, sq = aq && small;
    o[0] = sp ? (2 * L3 + 3 * L2 + L1 + L0 + R0 + 4) >> 3 : L2;
    o[1] = sp ? (L2 + L1 + L0 + R0 + 2) >> 2 : L1;
    o[2] = sp ? (L2 + 2 * L1 + 2 * L0 + 2 * R0 + R1 + 4) >> 3
              : (2 * L1 + L0 + R1 + 2) >> 2;
    o[3] = sq ? (R2 + 2 * R1 + 2 * R0 + 2 * L0 + L1 + 4) >> 3
              : (2 * R1 + R0 + L1 + 2) >> 2;
    o[4] = sq ? (R2 + R1 + R0 + L0 + 2) >> 2 : R1;
    o[5] = sq ? (2 * R3 + 3 * R2 + R1 + R0 + L0 + 4) >> 3 : R2;
  } else {
    const int C0 = t.c0[min(S, 3)];
    const int c0 = C0 + ap + aq;
    const int dif = clip3(-c0, c0, ((delta << 2) + (L1 - R1) + 4) >> 3);
    const int RL0 = (L0 + R0 + 1) >> 1;
    o[0] = L2;
    o[1] = L1 + (ap ? clip3(-C0, C0, (L2 + RL0 - (L1 << 1)) >> 1) : 0);
    o[2] = clip255(L0 + dif);
    o[3] = clip255(R0 - dif);
    o[4] = R1 + (aq ? clip3(-C0, C0, (R2 + RL0 - (R1 << 1)) >> 1) : 0);
    o[5] = R2;
  }
  for (int k = 0; k < 6; ++k) P[base + (k - 3) * stride] = o[k];
}

// one chroma line: p1 p0 q0 q1; bS > 0
__device__ void chroma_line(int* P, long long base, long long stride, int S,
                            const Thr& t) {
  const int L1 = P[base - 2 * stride], L0 = P[base - stride];
  const int R0 = P[base], R1 = P[base + stride];
  const int delta = R0 - L0;
  if (!(abs(delta) < t.alpha && abs(R0 - R1) < t.beta && abs(L0 - L1) < t.beta))
    return;
  if (S == 4) {
    P[base - stride] = (2 * L1 + L0 + R1 + 2) >> 2;
    P[base] = (2 * R1 + R0 + L1 + 2) >> 2;
  } else {
    const int c0 = t.c0[min(S, 3)] + 1;
    const int dif = clip3(-c0, c0, ((delta << 2) + (L1 - R1) + 4) >> 3);
    P[base - stride] = clip255(L0 + dif);
    P[base] = clip255(R0 - dif);
  }
}

__global__ void __launch_bounds__(32)
deblock_kernel(int* Y, int* U, int* V, const int* __restrict__ bsv,
               const int* __restrict__ bsh, int n_my, int n_mx, int t_diag,
               int r0, Thr tl, Thr tc) {
  const int lane = threadIdx.x;
  const int r = r0 + blockIdx.x, c = t_diag - 2 * r;
  const int W = 16 * n_mx, Wc = 8 * n_mx, W4 = 4 * n_mx;
  for (int ph = 0; ph < 8; ++ph) {
    if (lane < 16) {
      if (ph < 4) {  // luma vertical edge ph, line = row
        const int y = 16 * r + lane, x = 16 * c + 4 * ph;
        const int S = bsv[(4 * r + (lane >> 2)) * W4 + 4 * c + ph];
        if (S) luma_line(Y, (long long)y * W + x, 1, S, tl);
      } else {  // luma horizontal edge ph - 4, line = column
        const int e = ph - 4, y = 16 * r + 4 * e, x = 16 * c + lane;
        const int S = bsh[(4 * r + e) * W4 + 4 * c + (lane >> 2)];
        if (S) luma_line(Y, (long long)y * W + x, W, S, tl);
      }
    } else if (ph < 4) {  // chroma: vertical edges 0, 1, horizontal 0, 1
      int* P = lane < 24 ? U : V;
      const int k = lane & 7, e = ph & 1;
      if (ph < 2) {
        const int y = 8 * r + k, x = 8 * c + 4 * e;
        const int S = bsv[(4 * r + (k >> 1)) * W4 + 4 * c + 2 * e];
        if (S) chroma_line(P, (long long)y * Wc + x, 1, S, tc);
      } else {
        const int y = 8 * r + 4 * e, x = 8 * c + k;
        const int S = bsh[(4 * r + 2 * e) * W4 + 4 * c + (k >> 1)];
        if (S) chroma_line(P, (long long)y * Wc + x, Wc, S, tc);
      }
    }
    __syncwarp();
  }
}

}  // namespace

extern "C" int strengths(const unsigned char* nz4, const int* mvx4,
                         const int* mvy4, const int* ref4,
                         const unsigned char* intra4, int H4, int W4,
                         int* bsv, int* bsh, void* stream) {
  const int n = H4 * W4;
  strengths_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      nz4, mvx4, mvy4, ref4, intra4, H4, W4, bsv, bsh);
  return (int)cudaGetLastError();
}

extern "C" int strengths_b(const unsigned char* nz4,
                           const unsigned char* intra4,
                           const unsigned char* v0, const int* r0,
                           const int* m0x, const int* m0y,
                           const unsigned char* v1, const int* r1,
                           const int* m1x, const int* m1y, int H4, int W4,
                           int* bsv, int* bsh, void* stream) {
  const int n = H4 * W4;
  strengths_b_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      nz4, intra4, v0, r0, m0x, m0y, v1, r1, m1x, m1y, H4, W4, bsv, bsh);
  return (int)cudaGetLastError();
}

// thr: alpha, beta, C0[bS 0..3] for luma, then the same for chroma
extern "C" int deblock(const int* y_in, const int* u_in, const int* v_in,
                       const int* bsv, const int* bsh, int H, int W,
                       const int* thr, int* Y, int* U, int* V, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const size_t ny = (size_t)H * W * sizeof(int), nc = ny / 4;
  cudaMemcpyAsync(Y, y_in, ny, cudaMemcpyDeviceToDevice, s);
  cudaMemcpyAsync(U, u_in, nc, cudaMemcpyDeviceToDevice, s);
  cudaMemcpyAsync(V, v_in, nc, cudaMemcpyDeviceToDevice, s);
  Thr tl = {thr[0], thr[1], {thr[2], thr[3], thr[4], thr[5]}};
  Thr tc = {thr[6], thr[7], {thr[8], thr[9], thr[10], thr[11]}};
  const int n_my = H / 16, n_mx = W / 16;
  for (int t = 0; t < 2 * n_my + n_mx - 2; ++t) {
    const int r0 = max(0, (t - n_mx + 2) / 2);
    const int r1 = min(n_my - 1, t / 2);
    if (r1 < r0) continue;
    deblock_kernel<<<r1 - r0 + 1, 32, 0, s>>>(Y, U, V, bsv, bsh, n_my, n_mx,
                                             t, r0, tl, tc);
    int err = (int)cudaGetLastError();
    if (err) return err;
  }
  return (int)cudaGetLastError();
}
