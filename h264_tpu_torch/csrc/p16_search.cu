// K12: the integer-pel 16x16 motion search of the legacy P picture, for
// Hopper (sm_90a).
//
// Replaces h264_tpu/encoder/fast.py:117-158 (inside `_p_frame_core`, the
// jitted `p_frame_pipeline` / `p_frame_device`): for every 16x16 MB of the
// current luma plane (H, W) and every integer offset (dy, dx) in [-R, R]^2,
// the SSD against the reference padded by 32 (H + 64, W + 64), plus the
// MV-rate prior lam_cost(lambda_me, bits(4 dx) + bits(4 dy)) around the zero
// vector; the first minimum in (dy, dx) row-major order wins, as jnp.argmin
// takes it.  Outputs per MB: the integer vector (mvx, mvy) and the SSD at
// the zero offset (the reference's grids[R, R]).  No grid is written.
// Plain version: h264_tpu_torch/encoder/fast.py `search_plain`; wrapper
// kernels/p16.py `p16_search`.
//
// Exactness: the reference forms the SSD in float32 as ref2 - 2 cross +
// cur2 from integer terms that stay below 2^24 (at most 256 * 255^2), so
// it is the integer SSD; here the same three terms are summed in int32 (at
// most 16,646,400), and the cost stays below 2^25 at every QP and R <= 32.
//
// Design.  One block per MB, a thread per tile of 4 x 8 cells (four
// consecutive dx, the quad tq, by eight dy, the row ty), as many warps as
// the (2R+1)^2 grid needs (4 at R 28: 15 quads x 8 rows = 120 tiles).
//   A. The window, (16 + 2R)^2 samples at (-R, -R) from the MB, is packed
//      into u8 words in shared memory while it is staged (Ws words a row,
//      zero past the window; 32-bit indexing), the MB's 16 rows into 64
//      words (16-byte rows, read by every lane at once), and sum cur^2
//      by __dp4a of those words with themselves.
//   B. Row sums of 16 squares, rs[r][dx] = sum_x win[r][dx + x]^2, a task
//      per (row, quad): its five window words, three __byte_perm shifts,
//      16 __dp4a, one 16-byte store (the reference's horizontal box of
//      the squares, fast.py:130-134, computed once per window).
//   C. Each thread's cross terms: down the 8 + 15 window rows its tile
//      reads, each row's five words once, shifted by __byte_perm into the
//      four dx of the quad (12 PRMT), fed to every cell of the tile whose
//      16 x 16 block holds that row with the MB's matching row, 16
//      __dp4a (4 MACs each) a cell and row: each window word feeds up to
//      4 x 8 cells.  The rows where all 8 cells take the row run as a loop
//      without tests, the ramps at either end unrolled.
//   D. The vertical 16-row box of rs down the tile's four columns (16
//      16-byte loads, then one add and one subtract a row), SSD = sum cur^2
//      + box - 2 cross, the rate lam_cost(lambda_me, bx + by) with the
//      bits of each column and row computed once, and the thread's first
//      minimum in rising p = dy D + dx by strict <.  The warp's least cost,
//      then the least p among the lanes that hold it, by two redux.sync,
//      and the block's over its warps: no 38-bit key is packed (cost < 2^25
//      and p < 65^2 need 38 bits), the (cost, p) pair is compared in
//      order.  The thread whose tile holds (R, R) writes grid0.
// Cells of a tile past the grid (dx or dy >= 2R + 1) are computed from the
// zero padding of the window and never priced.
//
// What held the first kernel back.  It ran 256 threads per MB over the
// window staged as int32 (20.7 KB at R 28): every SSD term took two
// shared-memory loads, a subtract and a multiply-add, and at 1280x720 the
// 3600 x 57^2 x 256 terms at one warp-wide load a clock per SM came to
// about 0.72 ms, against 0.774 measured (NVIDIA H100 80GB HBM3, 700.00 W;
// PERF.md).  Here a window word is
// loaded once per row of a tile and feeds 4 x 8 cells, and a term costs a
// quarter __dp4a, so the kernel is bound by the FMA pipe's __dp4a.
//
// Bound.  Operations: the cross term in __dp4a, 64 a cell, and the cell's
// three terms combined, its rate and first minimum, 5 (chip_smoke.py
// p16_search_work): 88.8 M at CIF, R 28 (0.0053 ms at the 16.73 T/s of an
// H100's integer pipe), 807 M at 1280x720 (0.048 ms).  The bytes (the two
// planes read once) are below it.
//
// ptxas (sm_90a, nvcc -O3): 96 registers (5 blocks of 128 threads an SM),
// no stack frame, no spills; 48 B static and (ceil(Sr Ws / 4) 4 + 64 +
// 4 Sr nq) words of dynamic shared memory (26,176 B at R 28, 31.6 KB at
// R 32).  SASS (tools/time_kernels.py sass_report): 2,680 instructions,
// the steady row loop 157 for 32 cells (128 IDP); a thread runs about
// 4,800 at R 28, about 190 a cell of the grid against the bound's 69.
// Its time is 2.1x the bound at 1280x720 (NVIDIA H100 80GB HBM3, 700.00
// W; PERF.md).

#include <climits>

#include "common.cuh"

namespace {

constexpr int kMaxR = 32;
constexpr int kTX = 4;  // dx a tile: one quad
constexpr int kTY = 8;  // dy a tile
constexpr int kMaxThreads = 160;  // 17 quads x 9 rows of tiles at R 32

// The window's geometry at search range R: D cells a side, nq quads and
// nty tile rows of cells, Sr staged rows (the tiles' reach), Ws words a
// row (at least nq + 4, and 2 mod 4 so that the rows of two tile rows,
// 8 Ws words apart, fall in opposite halves of the 32 banks).
struct Geometry {
  int D, S, nq, nty, Sr, Ws, tiles, threads;
  __host__ __device__ explicit Geometry(int R) {
    D = 2 * R + 1;
    S = 16 + 2 * R;
    nq = (D + kTX - 1) / kTX;
    nty = (D + kTY - 1) / kTY;
    Sr = nty * kTY + 15;
    Ws = (nq + 4 + 1) / 4 * 4 + 2;
    tiles = nq * nty;
    threads = (tiles + 31) / 32 * 32;
  }
  // shared memory: the window (padded to whole 16-byte words), the MB's
  // 64 words, rs (Sr x 4 nq ints)
  __host__ __device__ int win_words() const { return (Sr * Ws + 3) / 4 * 4; }
  __host__ __device__ int smem_bytes() const {
    return (win_words() + 64 + Sr * kTX * nq) * 4;
  }
};

// feed window row r of the tile (its words wr[0..4]) to every cell a of
// the tile whose block holds it (MB row y = r - a), cw the MB's rows
template <bool kAll>
__device__ __forceinline__ void feed_row(const unsigned* wr, const uint4* cw,
                                         int r, unsigned (&acc)[kTY][kTX]) {
  unsigned w[5];
#pragma unroll
  for (int i = 0; i < 5; ++i) w[i] = wr[i];
  // s[k][i]: samples 4 i + k .. 4 i + k + 3 of the quad's dx = 4 tq + k
  unsigned s[kTX][4];
#pragma unroll
  for (int k = 0; k < kTX; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      s[k][i] = k ? __byte_perm(w[i], w[i + 1], 0x3210u + 0x1111u * k) : w[i];
#pragma unroll
  for (int a = 0; a < kTY; ++a) {
    const int y = r - a;
    if (!kAll && (y < 0 || y > 15)) continue;
    const uint4 c = cw[y];
#pragma unroll
    for (int k = 0; k < kTX; ++k)
      acc[a][k] = __dp4a(s[k][0], c.x, __dp4a(s[k][1], c.y,
                  __dp4a(s[k][2], c.z, __dp4a(s[k][3], c.w, acc[a][k]))));
  }
}

__global__ void __launch_bounds__(kMaxThreads)
p16_search_kernel(const int* __restrict__ cur, const int* __restrict__ ref_pad,
                  int W, int R, int lam, int n_mx, int* __restrict__ mvx,
                  int* __restrict__ mvy, int* __restrict__ grid0) {
  extern __shared__ __align__(16) unsigned sm[];
  __shared__ int csq_s;
  __shared__ int red_c[kMaxThreads / 32], red_p[kMaxThreads / 32];
  const Geometry g(R);
  unsigned* win = sm;                                   // Sr x Ws words
  uint4* cw = reinterpret_cast<uint4*>(sm + g.win_words());  // 16 rows
  int4* rs = reinterpret_cast<int4*>(sm + g.win_words() + 64);  // Sr x nq
  const int tid = threadIdx.x, nt = blockDim.x;
  const int mb = blockIdx.x, mby = mb / n_mx, mbx = mb - mby * n_mx;
  const int Wp = W + 2 * kPad;

  // A. the window as packed u8 words, zero past its S x S samples; the
  // thread steps (row, xw) by nt words
  {
    const int* base = ref_pad + (kPad + 16 * mby - R) * Wp + kPad + 16 * mbx - R;
    const int drow = nt / g.Ws, dxw = nt - drow * g.Ws;
    for (int row = tid / g.Ws, xw = tid - row * g.Ws; row < g.Sr;) {
      unsigned v = 0;
      const int x0 = 4 * xw;
      if (row < g.S && x0 < g.S) {
        const int* p = base + row * Wp + x0;
        int t[4];
#pragma unroll
        for (int b = 0; b < 4; ++b) t[b] = x0 + b < g.S ? __ldg(p + b) : 0;
        v = __byte_perm(__byte_perm(t[0], t[1], 0x0040),
                        __byte_perm(t[2], t[3], 0x0040), 0x5410);
      }
      win[row * g.Ws + xw] = v;
      row += drow;
      xw += dxw;
      if (xw >= g.Ws) {
        xw -= g.Ws;
        ++row;
      }
    }
  }
  if (tid < 32) {
    // the MB's rows, word i of row y at cw[y] component i: lane l packs
    // words l and l + 32
    const int* p = cur + (16 * mby) * W + 16 * mbx;
    unsigned q = 0;
    unsigned* cws = reinterpret_cast<unsigned*>(cw);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int wi = tid + 32 * h, y = wi >> 2, xw = wi & 3;
      const int4 t = __ldg(reinterpret_cast<const int4*>(p + y * W + 4 * xw));
      const unsigned v = __byte_perm(__byte_perm(t.x, t.y, 0x0040),
                                     __byte_perm(t.z, t.w, 0x0040), 0x5410);
      cws[wi] = v;
      q = __dp4a(v, v, q);
    }
    q = __reduce_add_sync(0xffffffffu, q);
    if (tid == 0) csq_s = (int)q;
  }
  __syncthreads();

  // B. rs[r][4 q + k] = sum of the squares of samples 4 q + k .. + 15
  {
    const int drow = nt / g.nq, dq = nt - drow * g.nq;
    for (int r = tid / g.nq, q = tid - r * g.nq; r < g.Sr;) {
      int4 v = make_int4(0, 0, 0, 0);
      if (r < g.S) {
        const unsigned* wr = win + r * g.Ws + q;
        unsigned w[5];
#pragma unroll
        for (int i = 0; i < 5; ++i) w[i] = wr[i];
        unsigned e[kTX];
#pragma unroll
        for (int k = 0; k < kTX; ++k) {
          e[k] = 0u;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const unsigned t =
                k ? __byte_perm(w[i], w[i + 1], 0x3210u + 0x1111u * k) : w[i];
            e[k] = __dp4a(t, t, e[k]);
          }
        }
        v = make_int4((int)e[0], (int)e[1], (int)e[2], (int)e[3]);
      }
      rs[r * g.nq + q] = v;
      r += drow;
      q += dq;
      if (q >= g.nq) {
        q -= g.nq;
        ++r;
      }
    }
  }
  __syncthreads();

  int bc = INT_MAX, bp = INT_MAX;  // the thread's first minimum
  if (tid < g.tiles) {
    const int ty = tid / g.nq, tq = tid - ty * g.nq;
    const int dy0 = kTY * ty, dx0 = kTX * tq;
    // C. the cross terms of the tile's 4 x 8 cells
    unsigned acc[kTY][kTX];
#pragma unroll
    for (int a = 0; a < kTY; ++a)
#pragma unroll
      for (int k = 0; k < kTX; ++k) acc[a][k] = 0u;
    const unsigned* wt = win + dy0 * g.Ws + tq;
#pragma unroll
    for (int r = 0; r < kTY - 1; ++r) feed_row<false>(wt + r * g.Ws, cw, r, acc);
#pragma unroll 1
    for (int r = kTY - 1; r < 16; ++r) feed_row<true>(wt + r * g.Ws, cw, r, acc);
#pragma unroll
    for (int r = 16; r < 15 + kTY; ++r)
      feed_row<false>(wt + r * g.Ws, cw, r, acc);

    // D. energies, SSD, rate and the first minimum, in rising p
    const int csq = csq_s;
    int bx[kTX];
#pragma unroll
    for (int k = 0; k < kTX; ++k) bx[k] = mv_bits(4 * (dx0 + k - R));
    const int4* rq = rs + dy0 * g.nq + tq;
    int4 box = make_int4(0, 0, 0, 0);
#pragma unroll
    for (int y = 0; y < 16; ++y) {
      const int4 t = rq[y * g.nq];
      box.x += t.x;
      box.y += t.y;
      box.z += t.z;
      box.w += t.w;
    }
#pragma unroll
    for (int a = 0; a < kTY; ++a) {
      if (a > 0) {
        const int4 in = rq[(a + 15) * g.nq], out = rq[(a - 1) * g.nq];
        box.x += in.x - out.x;
        box.y += in.y - out.y;
        box.z += in.z - out.z;
        box.w += in.w - out.w;
      }
      const int dy = dy0 + a;
      if (dy >= g.D) break;
      const int by = mv_bits(4 * (dy - R));
      const int e[kTX] = {box.x, box.y, box.z, box.w};
#pragma unroll
      for (int k = 0; k < kTX; ++k) {
        const int dx = dx0 + k;
        if (dx >= g.D) break;
        const int ssd = csq + e[k] - 2 * (int)acc[a][k];
        const int cost = ssd + lam_cost(lam, bx[k] + by);
        if (cost < bc) {
          bc = cost;
          bp = dy * g.D + dx;
        }
        if (dy == R && dx == R) grid0[mb] = ssd;
      }
    }
  }
  // the block's first minimum: the least cost, then the least p holding it
  const int wc = __reduce_min_sync(0xffffffffu, bc);
  const int wp = __reduce_min_sync(0xffffffffu, bc == wc ? bp : INT_MAX);
  if ((tid & 31) == 0) {
    red_c[tid >> 5] = wc;
    red_p[tid >> 5] = wp;
  }
  __syncthreads();
  if (tid == 0) {
    int c = red_c[0], p = red_p[0];
    for (int i = 1; i < nt / 32; ++i)
      if (red_c[i] < c || (red_c[i] == c && red_p[i] < p)) {
        c = red_c[i];
        p = red_p[i];
      }
    const int dy = p / g.D;
    mvx[mb] = p - dy * g.D - R;
    mvy[mb] = dy - R;
  }
}

}  // namespace

// cur (H, W), ref_pad (H + 64, W + 64) int32; H and W multiples of 16,
// 0 <= R <= 32; out mvx, mvy, grid0 (H/16 * W/16) int32.  Returns the CUDA
// error of the launch.
extern "C" int p16_search(const int* cur, const int* ref_pad, int H, int W,
                          int R, int lam, int* mvx, int* mvy, int* grid0,
                          void* stream) {
  const int n_mx = W / 16, n_mb = (H / 16) * n_mx;
  if (n_mb == 0) return 0;
  if (R < 0 || R > kMaxR) return (int)cudaErrorInvalidValue;
  const Geometry g(R);
  p16_search_kernel<<<n_mb, g.threads, g.smem_bytes(), (cudaStream_t)stream>>>(
      cur, ref_pad, W, R, lam, n_mx, mvx, mvy, grid0);
  return (int)cudaGetLastError();
}
