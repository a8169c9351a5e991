// K6: boundary strengths and the in-loop deblocking filter of P and B
// pictures, for Hopper (sm_90a).
//
// Replaces h264_tpu/encoder/rd.py:1713 `strengths_full`, :1928
// `strengths_full_b` (and, through them, encoder/fast.py:327
// `strengths_device_p`) and :1800 `deblock_device_full` (with
// `_edge_luma_full` :1741 and `_edge_chroma_full` :1784), as
// `rd_p_pipeline` calls them (:1124-1160) and `rd_b_pipeline`
// (:2487-2507).  Plain versions: h264_tpu_torch/encoder/strengths.py
// `strengths_plain`, rd_p.py `deblock_plain`; wrapper kernels/deblock.py.
//
// strengths: one kernel for every P, B and legacy picture.  One thread
// per 4x4 block computes the bS 0..4 of its left and its top edge (0 on
// picture edges): 4/3 when either side is intra (MB edge / inside), else
// 2 with coefficients, else the pairing rule: with one list (P) 1 on a
// reference index or >= 4 quarter-pel mv difference; with two lists (B,
// ldecod/src/loopFilter.c) a list's reference id is the POC of its
// picture where the block uses the list, else -10^9, the pairs match
// straight (p0 = q0, p1 = q1) or crossed (p0 = q1, p1 = q0), else bS 1,
// and matched blocks compare the mvs of the matching lists (both
// pairings when the two refs of q are one picture).  The P rule is the
// two-list rule with list 1 absent.  The thread reads every field at the
// glue's own granularity (per MB, per 8x8 unit or per block of a unit;
// the 4x4 levels per MB, or in raster for the legacy picture) through
// six strides, looks list 0's POC up by the clamped index in a table in
// shared memory, and ORs the block's 4x4 (and 8x8) levels itself, so
// the host builds no per-block plane for it.  Both
// edges go to one (2, H4, W4) buffer; 8x8-transform MBs (an optional
// per-MB flag) get 0 on their odd edges.  Design: tiles of 4 rows of 32
// blocks; every load of a thread is unconditional and independent of the
// others (absent fields read a zero word), so they are all in flight in
// one round: short-circuit tests between groups of loads had made them
// dependent rounds and cost 1-2 us (PERF.md); the neighbours come from
// shared memory, the tile's edge threads loading the halo.  Bound: the
// levels, the fields and the outputs once (1280x720 about 4.2 MB, 1.25 us
// at 3.35 TB/s), so the launch binds it at CIF and the levels' bytes add
// to it at 1280x720.
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
// ptxas (sm_90a, nvcc -O3): deblock_kernel 60 registers, 3,076 B shared
// memory, 3 barriers; no spills.

#include "common.cuh"

namespace {


struct Thr {
  int alpha, beta, c0[4];
};

// ---- strengths ------------------------------------------------------------
// A field read at the glue's granularity: the element offset of block
// (y4, x4) is the dot product of (MB row, MB column, unit row, unit
// column, block row, block column) with s; a zero stride broadcasts.
struct Field {
  const void* p;
  int s[6];
};

constexpr int kFields = 11;
enum { kCoef, kCoef8, kIntra, kT8, kRef0, kMv0x, kMv0y, kUse0, kMv1x, kMv1y,
       kUse1 };

struct SParams {
  Field f[kFields];
  const int* pocs;  // list 0's POCs (two lists), else null
  int npocs, poc1, H4, W4;
};

constexpr int kNone = -1000000000;
constexpr int kMaxPocs = 64;  // list-0 POCs the kernel's table holds

// what an absent field reads (its strides are 0): no intra MB, no 8x8
// transform, reference index 0, no list-1 motion
__device__ __align__(16) int kZeros[4];

__device__ __forceinline__ int foff(const Field& F, int y, int x) {
  return F.s[0] * (y >> 2) + F.s[1] * (x >> 2) + F.s[2] * ((y >> 1) & 1) +
         F.s[3] * ((x >> 1) & 1) + F.s[4] * (y & 1) + F.s[5] * (x & 1);
}

template <typename T>
__device__ __forceinline__ const T* at(const Field& F, int y, int x) {
  return (const T*)(F.p ? F.p : (const void*)kZeros) + foff(F, y, x);
}

template <typename T>
__device__ __forceinline__ int ld(const Field& F, int y, int x) {
  return (int)__ldg(at<T>(F, y, x));
}

// the OR of the N int32 levels of block (y, x): N a multiple of 4, at a
// 16-byte aligned offset
template <int N>
__device__ __forceinline__ int or_all(const Field& F, int y, int x) {
  const int* p = at<int>(F, y, x);
  int acc = 0;
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    const int4 v = __ldg((const int4*)(p + i));
    acc |= v.x | v.y | v.z | v.w;
  }
  return acc;
}

// a block's fields as loaded: list 0's reference index (its POC is looked
// up once the block's POC table is in shared memory)
struct Raw {
  int idx0, m0x, m0y, m1x, m1y;
  bool intra, coded, use0, use1;
};

// every load unconditional and independent of the others, so that a
// thread's loads are in flight together
template <bool kC8, bool kTwo>
__device__ __forceinline__ Raw load_raw(const SParams& P, int y, int x) {
  Raw b;
  b.intra = ld<unsigned char>(P.f[kIntra], y, x) != 0;
  b.coded = (or_all<16>(P.f[kCoef], y, x) |
             (kC8 ? or_all<64>(P.f[kCoef8], y, x) : 0)) != 0;
  b.idx0 = ld<int>(P.f[kRef0], y, x);
  b.m0x = ld<int>(P.f[kMv0x], y, x);
  b.m0y = ld<int>(P.f[kMv0y], y, x);
  b.use0 = b.use1 = false;
  b.m1x = b.m1y = 0;
  if (kTwo) {
    b.use0 = ld<unsigned char>(P.f[kUse0], y, x) != 0;
    b.use1 = ld<unsigned char>(P.f[kUse1], y, x) != 0;
    b.m1x = ld<int>(P.f[kMv1x], y, x);
    b.m1y = ld<int>(P.f[kMv1y], y, x);
  }
  return b;
}

struct Blk {
  bool intra, coded;
  int r0, r1, m0x, m0y, m1x, m1y;
};

// the block's reference ids: one list, the index; two lists, the POC
// where the block uses the list, else kNone
template <bool kTwo>
__device__ __forceinline__ Blk ids(const Raw& b, const int* pocs, int npocs,
                                   int poc1) {
  Blk o;
  o.intra = b.intra;
  o.coded = b.coded;
  o.m0x = b.m0x;
  o.m0y = b.m0y;
  o.m1x = b.m1x;
  o.m1y = b.m1y;
  o.r0 = kTwo ? (b.use0 ? pocs[min(max(b.idx0, 0), npocs - 1)] : kNone)
              : b.idx0;
  o.r1 = kTwo && b.use1 ? poc1 : kNone;
  return o;
}

__device__ __forceinline__ bool mv_far(int ax, int ay, int bx, int by) {
  return abs(ax - bx) >= 4 || abs(ay - by) >= 4;
}

// bS of the edge between q and p (p left of or above q); mb_edge: the
// edge is an MB's
template <bool kTwo>
__device__ __forceinline__ int edge_bs(const Blk& q, const Blk& p,
                                       bool mb_edge) {
  if (q.intra || p.intra) return mb_edge ? 4 : 3;
  if (q.coded || p.coded) return 2;
  const bool d00 = mv_far(q.m0x, q.m0y, p.m0x, p.m0y);
  if (!kTwo) return (q.r0 != p.r0 || d00) ? 1 : 0;
  const bool straight = q.r0 == p.r0 && q.r1 == p.r1;
  const bool crossed = q.r0 == p.r1 && q.r1 == p.r0;
  if (!straight && !crossed) return 1;
  const bool d11 = mv_far(q.m1x, q.m1y, p.m1x, p.m1y);
  const bool d01 = mv_far(q.m0x, q.m0y, p.m1x, p.m1y);
  const bool d10 = mv_far(q.m1x, q.m1y, p.m0x, p.m0y);
  bool mv_d;
  if (q.r0 != q.r1)
    mv_d = q.r0 == p.r0 ? (d00 || d11) : (d01 || d10);
  else
    mv_d = (d00 || d11) && (d01 || d10);
  return mv_d ? 1 : 0;
}

// A thread per 4x4 block, a tile of kTileY rows of kTileX blocks a thread
// block (a warp a tile row).  Each thread loads its own block's fields in
// one round; the threads of the tile's first column and row also load
// their left or upper neighbour's (a branch on the thread's place, not on
// loaded data, so those loads are in flight with the rest), and the
// block's threads load list 0's POC table into shared memory.  After one
// barrier each thread reads its neighbours from shared memory and writes
// the bS of its left edge into bs[0] and of its top edge into bs[1] (0 on
// the picture's edges and, in 8x8-transform MBs, on the odd edges).
constexpr int kTileX = 32, kTileY = 4;

template <bool kC8, bool kTwo>
__global__ void __launch_bounds__(kTileX * kTileY)
strengths_kernel(const __grid_constant__ SParams P, int* __restrict__ bs) {
  __shared__ Raw tile[kTileY][kTileX];
  __shared__ int pocs[kMaxPocs];
  const int tx = threadIdx.x % kTileX, ty = threadIdx.x / kTileX;
  const int x = blockIdx.x * kTileX + tx, y = blockIdx.y * kTileY + ty;
  // threads past the picture's edge load a block inside it and store
  // nothing; their neighbours inside never read them
  const int cx = min(x, P.W4 - 1), cy = min(y, P.H4 - 1);
  const Raw q = load_raw<kC8, kTwo>(P, cy, cx);
  const bool t8 = ld<int>(P.f[kT8], cy, cx) > 0;
  Raw l = q, t = q;
  if (tx == 0) l = load_raw<kC8, kTwo>(P, cy, max(cx - 1, 0));
  if (ty == 0) t = load_raw<kC8, kTwo>(P, max(cy - 1, 0), cx);
  if (kTwo && (int)threadIdx.x < P.npocs)
    pocs[threadIdx.x] = __ldg(P.pocs + threadIdx.x);
  tile[ty][tx] = q;
  __syncthreads();
  if (tx) l = tile[ty][tx - 1];
  if (ty) t = tile[ty - 1][tx];
  if (x >= P.W4 || y >= P.H4) return;
  const Blk bq = ids<kTwo>(q, pocs, P.npocs, P.poc1);
  const Blk bl = ids<kTwo>(l, pocs, P.npocs, P.poc1);
  const Blk bt = ids<kTwo>(t, pocs, P.npocs, P.poc1);
  const int k = y * P.W4 + x;
  bs[k] = (x == 0 || (t8 && (x & 1))) ? 0
                                        : edge_bs<kTwo>(bq, bl, (x & 3) == 0);
  bs[P.H4 * P.W4 + k] = (y == 0 || (t8 && (y & 1)))
                            ? 0
                            : edge_bs<kTwo>(bq, bt, (y & 3) == 0);
}

template <bool kC8, bool kTwo>
int launch_strengths(const SParams& P, int* bs, cudaStream_t s) {
  const dim3 grid((P.W4 + kTileX - 1) / kTileX, (P.H4 + kTileY - 1) / kTileY);
  strengths_kernel<kC8, kTwo><<<grid, kTileX * kTileY, 0, s>>>(P, bs);
  return (int)cudaGetLastError();
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

// ptr: the fields' base pointers in Field order, then pocs0 (null where
// absent); lay: their six strides each (0 where absent), then npocs (0
// with one list, else 1 .. kMaxPocs) (kernels/deblock.py checks them);
// bs: (2, 4 n_my, 4 n_mx) int32, BSV then BSH
extern "C" int strengths(const void* const* ptr, const int* lay, int poc1,
                         int n_my, int n_mx, int* bs, void* stream) {
  SParams P;
  for (int i = 0; i < kFields; ++i) {
    P.f[i].p = ptr[i];
    for (int j = 0; j < 6; ++j) P.f[i].s[j] = lay[6 * i + j];
  }
  P.pocs = (const int*)ptr[kFields];
  P.npocs = lay[6 * kFields];
  P.poc1 = poc1;
  P.H4 = 4 * n_my;
  P.W4 = 4 * n_mx;
  if (P.npocs > kMaxPocs || !ptr[kCoef]) return (int)cudaErrorInvalidValue;
  // the levels' int4 reads
  if ((size_t)ptr[kCoef] % 16 || (size_t)ptr[kCoef8] % 16)
    return (int)cudaErrorMisalignedAddress;
  const cudaStream_t s = (cudaStream_t)stream;
  const bool c8 = ptr[kCoef8] != nullptr, two = P.pocs != nullptr;
  return c8 ? (two ? launch_strengths<true, true>(P, bs, s)
                   : launch_strengths<true, false>(P, bs, s))
            : (two ? launch_strengths<false, true>(P, bs, s)
                   : launch_strengths<false, false>(P, bs, s));
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
