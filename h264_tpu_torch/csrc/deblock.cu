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
// then horizontal (bS 4 takes the strong filter).  MB (r, c) reads picture
// rows 16r-4..16r+15 and cols 16c-4..16c+15 (half in chroma) and writes
// inside them, so any order that filters (r, c) after (r, c-1) and
// (r-1, c+1) (or the end of row r-1) gives the raster result
// (tests/test_torch_refine_deblock.py test_deblock_order_does_not_matter).
// One launch: a persistent wavefront over MB rows (common.cuh's ticket,
// row progress counters, release/acquire and trapping spin, as K1).  Per
// MB, one block of 128 threads; warps 0-2 work and meet at a named
// barrier, warp 3 only publishes:
//   1. the MB's own 16x16 luma and 8x8 chroma samples and its 32
//      strengths, loaded from the INPUT planes while the previous MB was
//      filtered (no MB before it writes them: (r-1, *) writes rows above
//      16r, (r, c-1) columns left of 16c), go to shared memory, beside the
//      4 luma / 2 chroma columns on its left carried from the block's
//      previous MB (zero left of the picture); the next MB's loads start;
//   2. the vertical edges (they read only the MB's own rows), each line's
//      20 (10) samples in a lane's registers: luma by warp 0, U and V by
//      warp 1, while warp 2 waits for (r-1, c+1) and then
//   3. loads the 4 (2) rows above from the OUTPUT through L2 (zero above
//      the picture);
//   4. the horizontal edges, a column per lane;
//   5. stores the MB, the 3 rows above and the 3 columns left that its
//      edges changed (1 each in chroma), and carries its right columns;
//   6. after a barrier of all four warps, warp 3 fences and publishes
//      c + 1 in row r's counter while warps 0-2 go on to the next MB.
// So the output needs no copy of the input first, and the C entry makes
// one kernel launch (after a memset of the counters).  Lines whose bS is
// 0 are skipped.  The result equals the plain version for any bS: outside
// the picture the region holds zeros, as its padding does.
//
// Bound.  The chain: every path to the last MB holds n_mx + n_my - 2
// steps along a row (one block, MB after MB) and n_my - 1 hand-overs
// (row r - 1 publishes, row r's waiting warp sees it), 2 n_my + n_mx - 2
// MBs; bytes (each plane read and written once) and operations are
// small.  Along a row a step is a whole MB; at a hand-over only the wait,
// the rows above, the horizontal edges, the stores and the publication
// are serial, as the loads and vertical edges ran during the wait.  On
// built inputs that filter every edge (an NVIDIA H100 80GB HBM3 at 700 W,
// PERF.md) both steps took 2.8-2.9 us, and a trial without the fence
// before each release cut the hand-over by about 0.36 us (the column
// 12 %) but a CIF or 720p picture by 2 %: 17 or 44 of its steps are
// hand-overs.
//
// ptxas (sm_90a, nvcc -O3): strengths_kernel 23 registers, strengths_b
// 40, deblock_kernel 60 registers, 3,076 B shared memory, 3 barriers; no
// spills.

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

// One luma line across an edge, in registers: v[0..7] = p3 p2 p1 p0 q0
// q1 q2 q3; p2..q2 are replaced; bS > 0.
__device__ __forceinline__ void luma_line(int* v, int S, const Thr& t) {
  const int L3 = v[0], L2 = v[1], L1 = v[2], L0 = v[3];
  const int R0 = v[4], R1 = v[5], R2 = v[6], R3 = v[7];
  const int delta = R0 - L0;
  if (!(abs(delta) < t.alpha && abs(R0 - R1) < t.beta && abs(L0 - L1) < t.beta))
    return;
  const int ap = abs(L0 - L2) < t.beta, aq = abs(R0 - R2) < t.beta;
  if (S == 4) {
    const int small = abs(delta) < ((t.alpha >> 2) + 2);
    const int sp = ap && small, sq = aq && small;
    v[1] = sp ? (2 * L3 + 3 * L2 + L1 + L0 + R0 + 4) >> 3 : L2;
    v[2] = sp ? (L2 + L1 + L0 + R0 + 2) >> 2 : L1;
    v[3] = sp ? (L2 + 2 * L1 + 2 * L0 + 2 * R0 + R1 + 4) >> 3
              : (2 * L1 + L0 + R1 + 2) >> 2;
    v[4] = sq ? (R2 + 2 * R1 + 2 * R0 + 2 * L0 + L1 + 4) >> 3
              : (2 * R1 + R0 + L1 + 2) >> 2;
    v[5] = sq ? (R2 + R1 + R0 + L0 + 2) >> 2 : R1;
    v[6] = sq ? (2 * R3 + 3 * R2 + R1 + R0 + L0 + 4) >> 3 : R2;
  } else {
    const int C0 = t.c0[min(S, 3)];
    const int c0 = C0 + ap + aq;
    const int dif = clip3(-c0, c0, ((delta << 2) + (L1 - R1) + 4) >> 3);
    const int RL0 = (L0 + R0 + 1) >> 1;
    v[2] = L1 + (ap ? clip3(-C0, C0, (L2 + RL0 - (L1 << 1)) >> 1) : 0);
    v[3] = clip255(L0 + dif);
    v[4] = clip255(R0 - dif);
    v[5] = R1 + (aq ? clip3(-C0, C0, (R2 + RL0 - (R1 << 1)) >> 1) : 0);
  }
}

// One chroma line, in registers: v[0..3] = p1 p0 q0 q1; p0, q0 are
// replaced; bS > 0.
__device__ __forceinline__ void chroma_line(int* v, int S, const Thr& t) {
  const int L1 = v[0], L0 = v[1], R0 = v[2], R1 = v[3];
  const int delta = R0 - L0;
  if (!(abs(delta) < t.alpha && abs(R0 - R1) < t.beta && abs(L0 - L1) < t.beta))
    return;
  if (S == 4) {
    v[1] = (2 * L1 + L0 + R1 + 2) >> 2;
    v[2] = (2 * R1 + R0 + L1 + 2) >> 2;
  } else {
    const int c0 = t.c0[min(S, 3)] + 1;
    const int dif = clip3(-c0, c0, ((delta << 2) + (L1 - R1) + 4) >> 3);
    v[1] = clip255(L0 + dif);
    v[2] = clip255(R0 - dif);
  }
}

// The four luma edges of one line of the MB's region (a row for the
// vertical edges, a column for the horizontal ones), held in registers:
// v[0..19] from `p` at `stride` apart, edge e at v[4 e + 4], its bS in
// S[e]; the line goes back to shared memory.
__device__ __forceinline__ void luma_edges(int* p, int stride, const int* S,
                                           const Thr& t) {
  int v[20];
#pragma unroll
  for (int k = 0; k < 20; ++k) v[k] = p[k * stride];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (S[e]) luma_line(v + 4 * e, S[e], t);
#pragma unroll
  for (int k = 1; k < 19; ++k) p[k * stride] = v[k];
}

// The two chroma edges of one line: v[0..9], edge e at v[4 e + 2].
__device__ __forceinline__ void chroma_edges(int* p, int stride, const int* S,
                                             const Thr& t) {
  int v[10];
#pragma unroll
  for (int k = 0; k < 10; ++k) v[k] = p[k * stride];
#pragma unroll
  for (int e = 0; e < 2; ++e)
    if (S[e]) chroma_line(v + 4 * e, S[e], t);
#pragma unroll
  for (int k = 1; k < 9; ++k) p[k * stride] = v[k];
}

constexpr int kDeblockThreads = 128;
constexpr int kWork = 96;  // warps 0-2 filter; warp 3 publishes

// What one block holds while it filters MB (r, c): the region the MB's
// edges read, luma rows 16r-4..16r+15 x cols 16c-4..16c+15 and chroma
// rows 8r-2..8r+7 x cols 8c-2..8c+7 (odd strides: a column is conflict-
// free), the MB's strengths, and the right columns of the region carried
// to the next MB of the row.
struct DeblockSmem {
  int A[20][21];
  int C[2][10][11];
  int sv[4][4], sh[4][4];  // bS of the MB's 4x4 blocks' left / top edges
  int carry[16][4], ccarry[2][8][2];
  int row;
};

// The MB's own samples and strengths, as one of threads 0..95 loads them:
// luma samples t, t + 96, t + 192, chroma samples t, t + 96, strength t
struct Own {
  int y[3], c[2], bs;
};

__device__ __forceinline__ void load_own(Own& o, int t, int r, int c,
                                         const int* __restrict__ y_in,
                                         const int* __restrict__ u_in,
                                         const int* __restrict__ v_in,
                                         const int* __restrict__ bsv,
                                         const int* __restrict__ bsh, int W,
                                         int Wc, int W4) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int k = t + i * kWork;
    if (k < 256)
      o.y[i] = __ldg(y_in + (16 * r + (k >> 4)) * W + 16 * c + (k & 15));
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int k = t + i * kWork, q = k & 63;
    if (k < 128)
      o.c[i] = __ldg((k >> 6 ? v_in : u_in) + (8 * r + (q >> 3)) * Wc +
                     8 * c + (q & 7));
  }
  if (t < 32)
    o.bs = __ldg((t < 16 ? bsv : bsh) + (4 * r + ((t & 15) >> 2)) * W4 +
                 4 * c + (t & 3));
}

__global__ void __launch_bounds__(kDeblockThreads)
deblock_kernel(const int* __restrict__ y_in, const int* __restrict__ u_in,
               const int* __restrict__ v_in, const int* __restrict__ bsv,
               const int* __restrict__ bsh, int* Y, int* U, int* V, int* sync,
               int n_my, int n_mx, Thr tl, Thr tc) {
  __shared__ DeblockSmem s;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int W = 16 * n_mx, Wc = 8 * n_mx, W4 = 4 * n_mx;
  int* ticket = sync;
  int* done = sync + 1;  // done[r]: columns of MB row r filtered and stored
  long long polls = 0;
  constexpr int kBarWork = 2;  // the named barrier of warps 0-2
  constexpr int kPublisher = kWork;

  for (;;) {
    const int r = take_row(ticket, &s.row);
    if (r >= n_my) return;
    int seen = 0;  // warp 2's lane 0: the last value read from done[r - 1]
    Own own;
    if (warp < 3) load_own(own, tid, r, 0, y_in, u_in, v_in, bsv, bsh, W, Wc, W4);
    for (int c = 0; c < n_mx; ++c) {
      if (warp < 3) {
        // 1. the MB's own samples (loaded during the previous MB: no MB
        // before it writes them), its strengths, and the columns on its
        // left carried from the previous MB (zero left of the picture)
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          const int k = tid + i * kWork;
          if (k < 256) s.A[4 + (k >> 4)][4 + (k & 15)] = own.y[i];
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int k = tid + i * kWork, q = k & 63;
          if (k < 128) s.C[k >> 6][2 + (q >> 3)][2 + (q & 7)] = own.c[i];
        }
        if (tid < 16)
          s.sv[tid >> 2][tid & 3] = own.bs;
        else if (tid < 32)
          s.sh[(tid - 16) >> 2][tid & 3] = own.bs;
        if (tid < 64) {
          const int y = tid >> 2, x = tid & 3;
          s.A[4 + y][x] = c ? s.carry[y][x] : 0;
        } else {
          const int k = tid - 64, pl = k >> 4, y = (k >> 1) & 7, x = k & 1;
          s.C[pl][2 + y][x] = c ? s.ccarry[pl][y][x] : 0;
        }
        group_sync<kBarWork, kWork>();
        if (c + 1 < n_mx)  // the next MB's, in flight during this one
          load_own(own, tid, r, c + 1, y_in, u_in, v_in, bsv, bsh, W, Wc, W4);
        // 2. the vertical edges (they read only the MB's own rows): luma
        // by warp 0, U and V by warp 1, while warp 2 waits for (r-1, c+1),
        // or the end of row r-1, and 3. loads the rows above from the
        // output, through L2 (zero above the picture)
        if (warp == 0) {
          if (lane < 16) {
            int S[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) S[e] = s.sv[lane >> 2][e];
            luma_edges(&s.A[4 + lane][0], 1, S, tl);
          }
        } else if (warp == 1) {
          if (lane < 16) {
            const int pl = lane >> 3, k = lane & 7;
            int S[2] = {s.sv[k >> 1][0], s.sv[k >> 1][2]};
            chroma_edges(&s.C[pl][2 + k][0], 1, S, tc);
          }
        } else {
          if (lane == 0 && r > 0)
            wait_for(done + r - 1, min(c + 2, n_mx), seen, polls);
          __syncwarp();
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int k = lane + 32 * i, y = k >> 4, x = k & 15;
            s.A[y][4 + x] =
                r ? __ldcg(Y + (16 * r - 4 + y) * W + 16 * c + x) : 0;
          }
          const int pl = lane >> 4, cy = (lane >> 3) & 1, cx = lane & 7;
          s.C[pl][cy][2 + cx] =
              r ? __ldcg((pl ? V : U) + (8 * r - 2 + cy) * Wc + 8 * c + cx)
                : 0;
        }
        group_sync<kBarWork, kWork>();
        // 4. the horizontal edges
        if (warp == 0) {
          if (lane < 16) {
            int S[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) S[e] = s.sh[e][lane >> 2];
            luma_edges(&s.A[0][4 + lane], 21, S, tl);
          }
        } else if (warp == 1) {
          if (lane < 16) {
            const int pl = lane >> 3, k = lane & 7;
            int S[2] = {s.sh[0][k >> 1], s.sh[2][k >> 1]};
            chroma_edges(&s.C[pl][0][2 + k], 11, S, tc);
          }
        }
        group_sync<kBarWork, kWork>();
        // 5. store the MB, the 3 rows above and the 3 columns left that
        // its edges changed (1 each in chroma), and carry the region's
        // right columns
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          const int k = tid + i * kWork;
          if (k < 256)
            Y[(16 * r + (k >> 4)) * W + 16 * c + (k & 15)] =
                s.A[4 + (k >> 4)][4 + (k & 15)];
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int k = tid + i * kWork, q = k & 63;
          if (k < 128)
            (k >> 6 ? V : U)[(8 * r + (q >> 3)) * Wc + 8 * c + (q & 7)] =
                s.C[k >> 6][2 + (q >> 3)][2 + (q & 7)];
        }
        if (tid < 48) {
          const int y = 1 + tid / 16, x = tid & 15;
          if (r) Y[(16 * r - 4 + y) * W + 16 * c + x] = s.A[y][4 + x];
        } else {
          const int k = tid - 48, y = k / 3, x = 1 + k % 3;
          if (c) Y[(16 * r + y) * W + 16 * c - 4 + x] = s.A[4 + y][x];
        }
        if (tid < 16) {
          const int pl = tid >> 3, x = tid & 7;
          if (r) (pl ? V : U)[(8 * r - 1) * Wc + 8 * c + x] = s.C[pl][1][2 + x];
        } else if (tid < 32) {
          const int pl = (tid - 16) >> 3, y = tid & 7;
          if (c) (pl ? V : U)[(8 * r + y) * Wc + 8 * c - 1] = s.C[pl][2 + y][1];
        }
        if (tid < 64) {
          const int y = tid >> 2, x = tid & 3;
          s.carry[y][x] = s.A[4 + y][16 + x];
        } else {
          const int k = tid - 64, pl = k >> 4, y = (k >> 1) & 7, x = k & 1;
          s.ccarry[pl][y][x] = s.C[pl][2 + y][8 + x];
        }
      }
      // 6. publish (r, c): every store of the MB before the counter moves;
      // warp 3 fences and releases while warps 0-2 go on to the next MB
      publish(done + r, c + 1, kPublisher);
    }
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

// thr: alpha, beta, C0[bS 0..3] for luma, then the same for chroma;
// sync: n_my + 1 ints of scratch (the row ticket and each row's progress),
// zeroed here
extern "C" int deblock(const int* y_in, const int* u_in, const int* v_in,
                       const int* bsv, const int* bsh, int H, int W,
                       const int* thr, int* Y, int* U, int* V, int* sync,
                       void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int n_my = H / 16, n_mx = W / 16;
  Thr tl = {thr[0], thr[1], {thr[2], thr[3], thr[4], thr[5]}};
  Thr tc = {thr[6], thr[7], {thr[8], thr[9], thr[10], thr[11]}};
  cudaMemsetAsync(sync, 0, (n_my + 1) * sizeof(int), s);
  deblock_kernel<<<n_my, kDeblockThreads, 0, s>>>(
      y_in, u_in, v_in, bsv, bsh, Y, U, V, sync, n_my, n_mx, tl, tc);
  return (int)cudaGetLastError();
}
