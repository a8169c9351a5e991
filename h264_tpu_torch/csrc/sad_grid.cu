// K10: the dense 16x16 SAD grids of the host-path encoder, for Hopper
// (sm_90a).
//
// Replaces h264_tpu/encoder/me.py:25 `sad_grid_16x16` (the jitted `lax.map`
// over dy of stacked dx windows): for every 16x16 macroblock of `cur` (H, W)
// and every integer displacement (dy, dx) in [-R, R]^2, the sum of absolute
// differences against the reference `ref` (H + 2R, W + 2R), edge-padded by R
// on the host.  Output (2R+1, 2R+1, H/16, W/16) int32, indexed
// [dy + R][dx + R][mby][mbx].  Plain version:
// h264_tpu_torch/encoder/me.py `sad_grid_16x16_plain`; wrapper
// kernels/sad_grid.py.  Every R >= 0.
//
// Exactness: the samples are u8 (0..255); 256 terms of at most 255 each,
// so every sum (at most 65,280) is exact in any order.
//
// Design.  A block of 4 warps takes a run of up to 8 neighbouring MBs of
// one MB row and 16 tiles of its grid.  A tile is 4 consecutive dx (a
// quad) by 3 dy; the grid's quads are cut into strips of at most 16
// whose widths differ by at most one (R 16: one strip of 9 quads by 11
// tile rows, 99 tiles, 7 blocks a run; R 120: 15, 15, 15 and 16 quads),
// and in a strip the tiles run row-major, so a block's 16 tiles lie in at
// most 15 / w + 2 tile rows of its strip of w quads; a strip is narrower
// than 8 quads only where it is the only one (R < 14), so the shared
// memory stays under 12 KB at every R (larger R adds strips and blocks
// over blockIdx.y and .z).
//   A. The run's 8 MBs (16 rows of four words each, by 16-byte loads, 17
//      uint4 an MB apart so that the 8 MBs' rows fall in distinct banks)
//      and the window its tiles read are packed into u8 words in shared
//      memory while they are staged (zero past the reference and past the
//      run); a thread steps its window words' rows and columns by adds,
//      and its MB words' and eight window words' loads are in flight at
//      once (R 16: the whole window, one memory round).
//   B. Lane l takes MB l % 8 of the run and the tile l / 8 of its warp's
//      four: down the 3 + 15 window rows its tile reads, each row's five
//      words once, shifted by __byte_perm into the quad's four dx (12
//      PRMT), fed to every cell of the tile whose 16 x 16 block holds that
//      row with the MB's matching row: one vabsdiff4 with accumulate (the
//      sum of four absolute differences added to the cell) a word, 16 a
//      cell and row.  The rows where all the tile's cells take the row run
//      as a loop without tests, the ramps at either end unrolled (K12
//      p16_search's feed).  VABSDIFF4 issues about once in 4 cycles a
//      scheduler, half the INT32 lane rate (PERF.md §6), so a thread's 768
//      of them take about 3,000 cycles; the small tiles spread a CIF
//      picture's work over about 1,350 warps of 378 blocks, and 3 dy a tile
//      cover R 16's 33 dy exactly (tiles of 2 dy took 0.0123 ms at CIF
//      against 0.0119; PERF.md §6).
//   C. The writes: the 8 lanes that share a tile hold one cell of 8
//      neighbouring MBs, which are 8 consecutive words of the grid (one or
//      two 32-byte sectors).  Cells past the grid and MBs past the row's
//      end are computed from the zero padding and not written, so any
//      width and any R are exact.
//
// What held the first kernel back.  It staged the window as int32 and
// gave each thread one cell of one MB: every SAD term took two shared-
// memory loads, a subtract, an absolute value and an add, so the shared-
// memory rate bounded it (1089 x 396 x 256 terms at CIF, R 16, about 26
// us at one warp-wide load a clock per SM, against 0.0373 ms measured on
// an NVIDIA H100 80GB HBM3 at 700.00 W; PERF.md); and neighbouring threads
// wrote neighbouring dx of one MB, n_mb words apart in the grid, so each
// 4-byte store was a sector of its own (431 k sectors at CIF, 3.9 M at
// 1280x720).
//
// Bound.  Operations: 256 SAD terms of u8 samples per position and MB, 4
// an instruction (chip_smoke.py sad_work): 27.6 M at CIF, R 16 (0.00165
// ms at the 16.73 T/s of an H100's INT32 lanes), against 2.6 MB of bytes
// (each plane read once, the grid written once), so the operations bound
// leads; VABSDIFF4's own rate, half the INT32 lanes', makes it 0.0033 ms.
//
// ptxas (sm_90a, nvcc -O3): 95 registers, no stack frame, no spills; one
// specialisation for every R (the geometry is computed at run time).  SASS
// (tools/time_kernels.py sass_report): 1,368 instructions, the steady row
// loop 73 for 12 cells (48 VABSDIFF4.U8.ACC).  At CIF, R 16, 0.0116-0.0117
// ms on an NVIDIA H100 80GB HBM3 at 700.00 W (the first kernel's
// 0.0411-0.0412 in the same call; PERF.md).

#include <cuda_runtime.h>

#include "packed_u8.cuh"

namespace {

constexpr int kRun = 8;     // MBs of one row a block
constexpr int kTX = 4;      // dx a tile: one quad
constexpr int kTY = 3;      // dy a tile
constexpr int kWarps = 4;   // warps a block
constexpr int kTiles = 4 * kWarps;  // tiles a block: 4 a warp (lanes >> 3)
constexpr int kMaxQ = 16;   // quads a strip, at most
constexpr int kMbWords = 68;  // words an MB's 16 rows take (17 uint4)
constexpr int kBatch = 8;  // window words a thread loads at once

// The grid's tiles at search range R: nq quads of dx by nty rows of kTY
// dy, cut into ns strips of nq / ns or sw quads (strip s starts at quad
// s nq / ns); in a strip the tiles run row-major, kTiles a block.  kTiles
// consecutive tiles of a strip w quads wide span at most (kTiles - 1) / w
// + 2 tile rows, most in the narrowest strip, so a block's window is at
// most rows x Ws words (the run's 8 MBs, the widest strip's quads and 15
// samples more).
struct Geometry {
  int D, nq, nty, ns, sw, groups, rows, Ws;
  __host__ __device__ explicit Geometry(int R) {
    D = 2 * R + 1;
    nq = (D + kTX - 1) / kTX;
    nty = (D + kTY - 1) / kTY;
    ns = (nq + kMaxQ - 1) / kMaxQ;
    sw = (nq + ns - 1) / ns;
    groups = (sw * nty + kTiles - 1) / kTiles;
    rows = ((kTiles - 1) / (nq / ns) + 2) * kTY + 15;
    Ws = 4 * kRun + sw + 4;
  }
  // the first quad of strip s (s = ns: one past the last)
  __host__ __device__ int strip_q0(int s) const { return s * nq / ns; }
  __host__ __device__ int smem_bytes() const {
    return (kRun * kMbWords + rows * Ws) * 4;
  }
};

// c + the sum of the four bytes' absolute differences of a and b
__device__ __forceinline__ unsigned sad4(unsigned a, unsigned b, unsigned c) {
  unsigned d;
  asm("vabsdiff4.u32.u32.u32.add %0, %1, %2, %3;"
      : "=r"(d)
      : "r"(a), "r"(b), "r"(c));
  return d;
}

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
      acc[a][k] = sad4(s[k][0], c.x, sad4(s[k][1], c.y,
                  sad4(s[k][2], c.z, sad4(s[k][3], c.w, acc[a][k]))));
  }
}

__global__ void __launch_bounds__(32 * kWarps)
    sad_grid_kernel(const int* __restrict__ cur, const int* __restrict__ ref,
                    int W, int R, int n_my, int n_mx,
                    int* __restrict__ out) {
  extern __shared__ __align__(16) unsigned sm[];
  const Geometry g(R);
  const int tid = threadIdx.x;
  const int runs = (n_mx + kRun - 1) / kRun;
  const int mby = blockIdx.x / runs, mx0 = (blockIdx.x - mby * runs) * kRun;
  const int nm = min(kRun, n_mx - mx0);  // MBs of the run
  // the strip: quads q0 .. q0 + sw - 1
  const int q0 = g.strip_q0(blockIdx.y);
  const int sw = g.strip_q0(blockIdx.y + 1) - q0;
  const int n_tiles = sw * g.nty, u0 = blockIdx.z * kTiles;
  if (u0 >= n_tiles) return;  // the whole block
  const int ty0 = u0 / sw, ty1 = (min(u0 + kTiles, n_tiles) - 1) / sw;
  const int rows = (ty1 - ty0 + 1) * kTY + 15, Ws = g.Ws;
  const int Wp = W + 2 * R, Hp = 16 * n_my + 2 * R;

  // A. the run's MB rows (word xw of row y of MB m at cw[17 m + y]
  // component xw, zero past the row's end; 16-byte loads) and the window
  // from (16 mby + kTY ty0, 16 mx0 + 4 q0), rows x Ws words, zero past the
  // reference, kBatch words' loads issued before their stores; a thread
  // steps (row t, word w) by 128 words
  constexpr int kCurWords = 64 * kRun / (32 * kWarps);  // a thread's
  int4 ct[kCurWords];
#pragma unroll
  for (int j = 0; j < kCurWords; ++j) {
    const int i = tid + 32 * kWarps * j;
    const int m = i >> 6, y = (i >> 2) & 15, xw = i & 3;
    ct[j] = m < nm ? __ldg(reinterpret_cast<const int4*>(
                         cur + (16 * mby + y) * W + 16 * (mx0 + m) + 4 * xw))
                   : make_int4(0, 0, 0, 0);
  }
  unsigned* win = sm + kRun * kMbWords;
  const int r0 = 16 * mby + kTY * ty0, c0 = 16 * mx0 + 4 * q0;
  const int n_win = rows * Ws, nt = 32 * kWarps;
  const int drow = nt / Ws, dw = nt - drow * Ws;
  int t = tid / Ws, w = tid - t * Ws;
  for (int i0 = tid; i0 < n_win; i0 += nt * kBatch) {
    int v[kBatch][4];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int y = r0 + t, x = c0 + 4 * w;
      const int* p = ref + y * Wp + x;
      const bool in = i0 + nt * j < n_win && y < Hp;
#pragma unroll
      for (int b = 0; b < 4; ++b) v[j][b] = in && x + b < Wp ? __ldg(p + b) : 0;
      t += drow;
      w += dw;
      if (w >= Ws) {
        w -= Ws;
        ++t;
      }
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      if (i0 + nt * j < n_win)
        win[i0 + nt * j] = pack4(v[j][0], v[j][1], v[j][2], v[j][3]);
  }
#pragma unroll
  for (int j = 0; j < kCurWords; ++j) {
    const int i = tid + 32 * kWarps * j;
    sm[kMbWords * (i >> 6) + (i & 63)] =
        pack4(ct[j].x, ct[j].y, ct[j].z, ct[j].w);
  }
  __syncthreads();

  // B. the thread's tile: MB m (lane & 7), tile u of the strip (lane >> 3
  // and the warp), quad tq, tile row ty
  const int m = tid & (kRun - 1), u = u0 + (tid >> 3);
  if (u >= n_tiles) return;
  const int ty = u / sw, tq = u - ty * sw;
  unsigned acc[kTY][kTX];
#pragma unroll
  for (int a = 0; a < kTY; ++a)
#pragma unroll
    for (int k = 0; k < kTX; ++k) acc[a][k] = 0u;
  const unsigned* wt =
      sm + kRun * kMbWords + kTY * (ty - ty0) * Ws + 4 * m + tq;
  const uint4* cm = reinterpret_cast<const uint4*>(sm) + (kMbWords / 4) * m;
#pragma unroll
  for (int r = 0; r < kTY - 1; ++r) feed_row<false>(wt + r * Ws, cm, r, acc);
#pragma unroll 1
  for (int r = kTY - 1; r < 16; ++r) feed_row<true>(wt + r * Ws, cm, r, acc);
#pragma unroll
  for (int r = 16; r < 15 + kTY; ++r) feed_row<false>(wt + r * Ws, cm, r, acc);

  // C. cell (dy, dx) of MB (mby, mx0 + m): the 8 lanes of a tile are 8
  // consecutive words of the grid
  if (m >= nm) return;
  const size_t n_mb = (size_t)n_my * n_mx, at = (size_t)mby * n_mx + mx0 + m;
#pragma unroll
  for (int a = 0; a < kTY; ++a) {
    const int dy = kTY * ty + a;
#pragma unroll
    for (int k = 0; k < kTX; ++k) {
      const int dx = 4 * (q0 + tq) + k;
      if (dy < g.D && dx < g.D)
        out[((size_t)dy * g.D + dx) * n_mb + at] = (int)acc[a][k];
    }
  }
}

}  // namespace

// cur (H, W), ref (H + 2R, W + 2R), out (2R+1, 2R+1, H/16, W/16), int32;
// H and W multiples of 16, R >= 0.  Returns the CUDA error of the launch.
extern "C" int sad_grid_16x16(const int* cur, const int* ref, int H, int W,
                              int R, int* out, void* stream) {
  const int n_my = H / 16, n_mx = W / 16;
  if (n_my * n_mx == 0) return 0;
  if (R < 0) return (int)cudaErrorInvalidValue;
  const Geometry g(R);
  const dim3 grid(n_my * ((n_mx + kRun - 1) / kRun), g.ns, g.groups);
  sad_grid_kernel<<<grid, 32 * kWarps, g.smem_bytes(),
                    (cudaStream_t)stream>>>(cur, ref, W, R, n_my, n_mx, out);
  return (int)cudaGetLastError();
}
