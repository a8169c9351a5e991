// K3: the dense block-matching grids of a P picture, for Hopper (sm_90a).
//
// Replaces h264_tpu/encoder/rd.py:329 `rd_p_pipeline`'s search stages:
//   coarse_search  stage 0, `coarse_block` (rd.py:361-418): per (ref, MB)
//                  the +-48-pel SAD search on 4x-decimated planes of the
//                  (weighted) G plane, priced with lambda_me * mv bits;
//   ssd_grid8      stage 1, `block_ssd` (rd.py:420-459): per (ref, 8x8
//                  block) the (2R+1)^2 SSD grid around its MB's centre;
//   sub8_search    the sub-8x8 integer search, `block_ssd4` (rd.py:640-662)
//                  and its pricing and argmins (`sub_argmin`, :666-677):
//                  per 8x8 unit on its reference the (2RS+1)^2 grids of
//                  its 4x4 quadrants, summed into the 8x4, 4x8 and 4x4
//                  partitions, priced against the unit's PMV, and each
//                  partition's first minimum: 8 integer mvs a unit.
// Plain versions: h264_tpu_torch/encoder/rd_p.py `coarse_search_plain`,
// `ssd_grid8_plain`, `sub8_search_plain`; wrapper kernels/search_grid.py.
//
// Design.  coarse_search: two kernels launched by its one C entry on the
// caller's stream.  decimate_kernel writes every reference's weighted,
// 4x4-decimated widened G plane once per call into a u16 scratch plane
// the wrapper allocates (NR x (Hp+128)/4 x (Wp+128)/4 cells, each at most
// 16 x 255); coarse_kernel then searches each MB's 28 x 28 window of it
// (below).  Two launches, not one: every MB of a reference reads cells
// that other blocks decimate, so one kernel would need a grid-wide wait
// between the phases (a cooperative launch, or counters as K1 and K6
// keep).  Nor is the second a programmatic dependent launch (its blocks
// starting during the decimation, reading their source sums, waiting at
// griddepcontrol.wait): tried, it was slower at CIF (PERF.md).
// sub8_search: one kernel, two warps a unit, that prices its grids and
// reduces them in registers (sub8_kernel below).  ssd_grid8: one block
// per (ref, MB) over the union of its four blocks' windows, the cross
// term by __dp4a on packed u8 (ssd8_kernel below).  The reference widens the
// banks by 64 samples of edge replication first; a read clamped to the
// unwidened bank is the same sample.  No window of this path starts
// outside the widened bank, so the reference's dynamic_slice never clamps
// its start (tests/test_torch_p_ops.py).
//
// What held coarse_search back, and what this design does about it.  Its
// first version ran a 640-thread block per (ref, MB) that decimated its
// own 28 x 28 window again: 16 clamped 4-byte loads and WP evaluations a
// cell, 12,544 a block, so each bank sample was read and weighted about
// 34 times at 1280x720 (19 at CIF); its first minimum was a shared-memory
// tree with ten barriers, and 13.4 KB of shared memory and 48 registers
// allowed two blocks an SM.  Here each sample is read once, by a 16-byte
// load, and weighted once, as the reference weights before it decimates
// (rd.py:389); the search reads the small plane through a strip window
// that 4 MBs share; a lane keeps its column's running minimum in
// registers and the warp's first minimum is five (cost, index) shuffles.
// The SAD terms are 32-bit __usad on unpacked samples, one VABSDIFF with
// its accumulation each (1,000 SASS instructions a warp): packed 16-bit
// pairs (__vsadu2) compile to about 12 instructions a pair on sm_90a.
// What is left at CIF is the two launches' fixed cost: the decimation
// alone takes about half the call there (PERF.md).
//
// Bound.  coarse_search: the G plane of every reference read once (the
// bytes), WP and the decimation once per sample, and per grid cell 16 SAD
// terms of 12-bit sums in 16-bit pairs, the rate and the first minimum
// (chip_smoke.py p_work): 18.9 M operations at CIF, 0.0011 ms (ops); about
// 0.0095 ms at 1280x720.  ssd_grid8: NR * n_b8 * (2R+1)^2 * 64 MACs (1.65 G
// at CIF, NR 5, R 28) and an output of (NR, n_b8, 57, 57) int32 (103 MB at
// CIF, 0.94 GB at 1280x720).  Its first version took each MAC as two
// shared-memory loads, a subtract and a multiply-add, and was bound by the
// loads (one warp-wide load a clock per SM: 0.41 ms at CIF against 0.44
// measured).  Here a window sample read from shared memory feeds 32 MACs
// in 8 __dp4a, the route taken because a MAC costs a quarter instruction
// on the integer pipe with no conversion of the u8 samples, where float32
// FMAs on CUDA cores (also exact below 2^24) cost one on a pipe twice as
// wide and need the window as float; the union window, cut in units of 8
// rows, computes 44 % more cells than the blocks need (72 x 65 x 4 against
// 57 x 57 x 4 at R 28) for one staged window instead of four.  A
// tensor-core form (mma.m16n8k32 u8, a pair of union rows against the four
// blocks' two rows) was also bit-exact, faster at 1280x720 and slower at
// CIF, where its window staging and box sums set the time; this simpler
// one stays until the fused partition reduction (ROADMAP), which removes
// the output's stores that both forms pay, chooses again.  The output's
// bytes are the bound.
//
// What held the sub-8x8 search back, and what this design does about it.
// Its first kernel, ssd_grid4, ran a 256-thread block per unit over a
// window staged as 32-bit samples, each grid cell a thread's 16 terms of
// two shared-memory loads, a subtract and a multiply-add, and wrote every
// unit's four quadrant grids, 4 x 21 x 21 int32 (7,056 B a unit: 11.2 MB
// a CIF P picture, 101.6 MB at 1280x720); the glue then summed them into
// the eight partition grids, priced each cell and took eight argmins in
// 45 more device kernels (torch.profiler, PERF.md).  sub8_search keeps the
// grids in registers and writes 64 B a unit: a window row read from
// shared memory feeds 16 MACs of each of up to 8 cells by __dp4a, the
// rate is computed once per cell, and the first minima are packed keys,
// one IMNMX a partition and cell, reduced by redux.sync.  Its time is its
// instruction count (PERF.md): about 1,000 SASS instructions a
// thread at RS 10, the 7 cells' 500 split between the FMA pipe (__dp4a,
// IMAD) and the ALU pipe, so a warp issues about one a clock.  What moved
// it was occupancy: 111 registers (two blocks of 4 units an SM) took
// 0.059 ms at 1280x720, 64 (8 blocks of 2 units) 0.039 (NVIDIA H100 80GB
// HBM3, 700.00 W); neither blocks of 1, 2 or 4 units nor 16-byte staging
// loads changed it.  At CIF the grid is one wave, 1.8-1.9x an empty
// launch of it.
// Bound.  sub8_search: per grid cell 64 MACs in __dp4a, the four SSDs'
// terms combined, the four pair sums, one rate and eight first-minimum
// updates (chip_smoke.py p_work: 41 operations a cell; the energies'
// running boxes are this design's cost, not the function's), WP once per
// window sample, the G planes read once: operations bound it, 32.3 M at
// CIF (0.0019 ms at the 16.73 T/s of an NVIDIA H100 80GB HBM3 at 700 W)
// and 287 M at 1280x720 (0.017 ms; NR 5, RS 10, WP).
//
// ptxas (sm_90a, nvcc -O3): decimate_kernel 32 registers; coarse_kernel
// 32 registers, 4,928 B static shared memory; ssd8_kernel 147 registers (3 blocks of 128 threads an SM),
// dynamic shared memory (8 ceil((2R+9)/8) + 7) rows x ceil((2R+20)/16) x
// 16 B of window + 256 B (6.6 KB at R = 28); sub8_kernel<RS> 64
// registers at RS 10 (the cap of 8 blocks an SM), 80 / 78 at RS 9 / 8,
// 56-67 below, 816-2,256 B static shared memory; no stack frames, no
// spills.

#include <climits>

#include "common.cuh"

namespace {

constexpr int kRC = 12;    // coarse range, 4-pel units
constexpr int kDCo = 25;   // 2 * kRC + 1
constexpr int kE = 64;     // the reference's widening of the bank
constexpr int kDecThreads = 256;
constexpr int kStrip = 4;  // MBs of a row that one search block takes
constexpr int kWinCols = 4 * kStrip + 28;  // staged window row, samples

__device__ __forceinline__ int wp_or(int v, int use_wp, int w, int o) {
  return use_wp ? wp_affine(v, w, o) : v;
}

// Phase A: cell (Y, X) of reference r's decimated plane (Hl x Wl, u16)
// sums the (weighted) widened G samples 4Y + a, 4X + b, i.e. bank samples
// (4Y + a - kE, 4X + b - kE) clamped.  Hp and Wp are multiples of 4, so a
// cell's four columns are all inside the bank (one 16-byte load a row) or
// all clamped to one edge column.
__global__ void __launch_bounds__(kDecThreads)
decimate_kernel(const int* __restrict__ banks, const int* __restrict__ wp_w,
                const int* __restrict__ wp_o, int use_wp, int Hp, int Wp,
                int Hl, int Wl, unsigned short* __restrict__ plane) {
  const int cell = blockIdx.x * kDecThreads + threadIdx.x, r = blockIdx.y;
  if (cell >= Hl * Wl) return;
  const int Y = cell / Wl, X = cell - Y * Wl;
  const int* G = banks + (size_t)r * 4 * Hp * Wp;
  const int w = use_wp ? wp_w[r] : 32, o = use_wp ? wp_o[r] : 0;
  const int y0 = 4 * Y - kE, x0 = 4 * X - kE;
  int s = 0;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int* g = G + (size_t)clampi(y0 + a, Hp - 1) * Wp;
    if (x0 >= 0 && x0 < Wp) {
      const int4 v = __ldg(reinterpret_cast<const int4*>(g + x0));
      s += wp_or(v.x, use_wp, w, o) + wp_or(v.y, use_wp, w, o) +
           wp_or(v.z, use_wp, w, o) + wp_or(v.w, use_wp, w, o);
    } else {
      s += 4 * wp_or(g[clampi(x0, Wp - 1)], use_wp, w, o);
    }
  }
  plane[((size_t)r * Hl + Y) * Wl + X] = (unsigned short)s;
}

// Phase B: one block per (ref, MB row, strip of kStrip MBs), one warp per
// MB.  The strip's 28 x (4 kStrip + 24) window of the decimated plane is
// staged as 32-bit samples; window cell (wy, wx) of MB (my, mx) is plane
// cell (4 my + wy + 12, 4 mx + wx + 12) (rd.py:399-401).  Lane kx < 25
// takes the grid column kx: down the 28 window rows it reads each row's
// four samples once and adds their absolute differences from the MB's
// 4x4 source sums (__usad: |a - b| + c) into the four cells (ky = row - a)
// they belong to; a cell complete after its fourth row gets its rate and
// enters the lane's first minimum (ky ascending).  The warp then takes the
// first minimum over its lanes by a (cost, index) shuffle: strict <, the
// lower raster index on a tie.
__global__ void __launch_bounds__(32 * kStrip)
coarse_kernel(const unsigned short* __restrict__ plane,
              const int* __restrict__ cur_y, int Hl, int Wl, int W,
              int n_mx, int n_strips, int lam_me, int* cen_x, int* cen_y) {
  __shared__ unsigned win[kDCo + 3][kWinCols];
  const int tid = threadIdx.x, lane = tid & 31, m = tid >> 5;
  const int my = blockIdx.x / n_strips;
  const int mx0 = (blockIdx.x - my * n_strips) * kStrip;
  const int r = blockIdx.y, n_my = gridDim.x / n_strips;
  // the window's rows as u16 pairs (Wl and the start column are even)
  const unsigned* src = reinterpret_cast<const unsigned*>(
      plane + ((size_t)r * Hl + 4 * my + 12) * Wl + 4 * mx0 + 12);
  const int words = (Wl - 4 * mx0 - 12) >> 1;
  for (int k = tid; k < (kDCo + 3) * (kWinCols / 2); k += 32 * kStrip) {
    const int wy = k / (kWinCols / 2), wj = k - wy * (kWinCols / 2);
    const unsigned v = wj < words ? src[(size_t)wy * (Wl >> 1) + wj] : 0u;
    win[wy][2 * wj] = v & 0xffffu;
    win[wy][2 * wj + 1] = v >> 16;
  }
  __syncthreads();
  const int mx = mx0 + m;
  if (mx >= n_mx) return;
  // the MB's 4x4 source sums, cb[a][b] from lane 4a + b
  unsigned cs = 0;
  if (lane < 16) {
    const int* c = cur_y + (size_t)(16 * my + 4 * (lane >> 2)) * W + 16 * mx +
                   4 * (lane & 3);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int4 v = __ldg(reinterpret_cast<const int4*>(c + (size_t)i * W));
      cs += v.x + v.y + v.z + v.w;
    }
  }
  unsigned cb[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
      cb[a][b] = __shfl_sync(0xffffffffu, cs, 4 * a + b);
  const int kx = min(lane, kDCo - 1);
  const unsigned* col = &win[0][4 * m + kx];
  const int bx = mv_bits((kx - kRC) * 16);
  unsigned acc[4] = {0u, 0u, 0u, 0u};
  int best = INT_MAX, bidx = 0;
#pragma unroll
  for (int t = 0; t < kDCo + 3; ++t) {
    unsigned w[4];
#pragma unroll
    for (int b = 0; b < 4; ++b) w[b] = col[t * kWinCols + b];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int ky = t - a;
      if (ky < 0 || ky >= kDCo) continue;
#pragma unroll
      for (int b = 0; b < 4; ++b)
        acc[ky & 3] = __usad(w[b], cb[a][b], acc[ky & 3]);
    }
    if (t >= 3) {
      const int ky = t - 3;
      const int cost = (int)acc[ky & 3] +
                       lam_cost(lam_me, bx + mv_bits((ky - kRC) * 16));
      acc[ky & 3] = 0u;
      if (cost < best) {
        best = cost;
        bidx = ky * kDCo + kx;
      }
    }
  }
  if (lane >= kDCo) best = INT_MAX;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int oc = __shfl_xor_sync(0xffffffffu, best, off);
    const int oi = __shfl_xor_sync(0xffffffffu, bidx, off);
    if (oc < best || (oc == best && oi < bidx)) {
      best = oc;
      bidx = oi;
    }
  }
  if (lane == 0) {
    const int n = (r * n_my + my) * n_mx + mx;
    cen_x[n] = (bidx % kDCo - kRC) * 4;
    cen_y[n] = (bidx / kDCo - kRC) * 4;
  }
}

// Per (ref, MB): the four 8x8 blocks of an MB share its centre, so their
// windows (2R+8)^2 at (8 qy, 8 qx) inside one (2R+16)^2 window at bank
// coordinates (16 my + cy - R + PAD, 16 mx + cx - R + PAD).  Union cell
// (I, J), I, J < U = 2R+9, is cell (I - 8 qy, J - 8 qx) of block q where
// that lies in its D x D grid.  SSD = sum cur^2 + sum ref^2 - 2 sum
// cur * ref, every term exact in int32 (64 * 255^2 < 2^22).  The window is
// staged as u8 (a WP sample is clipped to 0..255), the four blocks' cur
// as packed u8 rows in registers; a thread takes a unit of 8 union cells
// down one column J, reads the 15 window rows they need once each (three
// aligned words, two __byte_perm for the unaligned 8 samples) and feeds
// each to the 8 cells x 4 blocks it touches with __dp4a (4 MACs an
// instruction), and takes sum ref^2 of each row by __dp4a of the row with
// itself, boxed down the column in registers.  Lanes hold consecutive J,
// so every output store is coalesced.
constexpr int kS8Threads = 128;

__global__ void __launch_bounds__(kS8Threads, 3)
ssd8_kernel(const int* __restrict__ banks, const int* __restrict__ cur_y,
            const int* __restrict__ cen_x, const int* __restrict__ cen_y,
            const int* __restrict__ wp_w, const int* __restrict__ wp_o,
            int use_wp, int Hp, int Wp, int W, int R, int* out) {
  extern __shared__ unsigned sw[];
  const int D = 2 * R + 1, U = D + 8, Wn = 2 * R + 16;
  const int n_strips = (U + 7) / 8;
  const int Wr = 8 * n_strips + 7;           // rows a strip may read
  const int Ws = (Wn + 4 + 15) / 16 * 4;     // row stride, words
  unsigned* cw = sw + Wr * Ws;               // [q][y][2] packed cur
  const int tid = threadIdx.x;
  const int mb = blockIdx.x, r = blockIdx.y, n_mb = gridDim.x;
  const int n_mx = W / 16, my = mb / n_mx, mx = mb % n_mx, nbx = W / 8;
  const int cy = cen_y[r * n_mb + mb], cx = cen_x[r * n_mb + mb];
  const int* G = banks + (size_t)r * 4 * Hp * Wp;
  const int w = use_wp ? wp_w[r] : 32, o = use_wp ? wp_o[r] : 0;
  const int y0 = 16 * my + cy - R + kPad, x0 = 16 * mx + cx - R + kPad;
  // word (row, xw) of the window packs samples 4 xw .. 4 xw + 3 of the row
  // (zero past the window); the thread steps (row, xw) by kS8Threads words
  const int drow = kS8Threads / Ws, dxw = kS8Threads % Ws;
  for (int row = tid / Ws, xw = tid % Ws; row < Wr;) {
    unsigned v = 0;
    if (row < Wn) {
      const int* g = G + (size_t)clampi(y0 + row, Hp - 1) * Wp;
      for (int b = 0; b < 4; ++b) {
        const int x = 4 * xw + b;
        if (x < Wn) {
          const int t = g[clampi(x0 + x, Wp - 1)];
          v |= (unsigned)(use_wp ? wp_affine(t, w, o) : t) << (8 * b);
        }
      }
    }
    sw[row * Ws + xw] = v;
    row += drow;
    xw += dxw;
    if (xw >= Ws) {
      xw -= Ws;
      ++row;
    }
  }
  if (tid < 64) {
    const int q = tid >> 4, y = (tid >> 1) & 7, h = tid & 1;
    const int* src = cur_y + (size_t)(16 * my + 8 * (q >> 1) + y) * W +
                     16 * mx + 8 * (q & 1) + 4 * h;
    cw[tid] = (unsigned)src[0] | (unsigned)src[1] << 8 |
              (unsigned)src[2] << 16 | (unsigned)src[3] << 24;
  }
  __syncthreads();
  unsigned c[4][8][2];
  int csq[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    unsigned t = 0;
#pragma unroll
    for (int y = 0; y < 8; ++y) {
      c[q][y][0] = cw[16 * q + 2 * y];
      c[q][y][1] = cw[16 * q + 2 * y + 1];
      t = __dp4a(c[q][y][0], c[q][y][0], __dp4a(c[q][y][1], c[q][y][1], t));
    }
    csq[q] = (int)t;
  }
  // each block's grid: out[r][b8 of block q]
  int* outq[4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
    outq[q] = out + ((size_t)r * 4 * n_mb + (2 * my + (q >> 1)) * nbx + 2 * mx +
                     (q & 1)) * D * D;
  for (int u = tid; u < n_strips * U; u += kS8Threads) {
    const int strip = u / U, J = u - strip * U, I0 = 8 * strip;
    const unsigned* wr = sw + I0 * Ws + (J >> 2);
    const unsigned sel = 0x3210u + 0x1111u * (unsigned)(J & 3);
    unsigned acc[8][4], sq[15];
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[a][q] = 0;
#pragma unroll
    for (int t = 0; t < 15; ++t) {
      const unsigned a0 = wr[t * Ws], a1 = wr[t * Ws + 1], a2 = wr[t * Ws + 2];
      const unsigned w0 = __byte_perm(a0, a1, sel), w1 = __byte_perm(a1, a2, sel);
      sq[t] = __dp4a(w0, w0, __dp4a(w1, w1, 0u));
#pragma unroll
      for (int a = 0; a < 8; ++a) {
        const int y = t - a;
        if (y < 0 || y > 7) continue;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          acc[a][q] = __dp4a(w0, c[q][y][0], __dp4a(w1, c[q][y][1], acc[a][q]));
      }
    }
    // cell (I0 + a, J) of block q is its cell (i, j) = (I0 + a - 8 qy,
    // J - 8 qx), inside its grid for lo_q <= a < lo_q + D
    int* dst[4];
    int lo[4];
    bool col[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = J - 8 * (q & 1);
      lo[q] = 8 * (q >> 1) - I0;
      col[q] = j >= 0 && j < D;
      dst[q] = outq[q] - lo[q] * D + j;
    }
    unsigned box = 0;
#pragma unroll
    for (int y = 0; y < 8; ++y) box += sq[y];
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      if (a > 0) box += sq[a + 7] - sq[a - 1];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (col[q] && a >= lo[q] && a < lo[q] + D)
          dst[q][a * D] = csq[q] + (int)box - 2 * (int)acc[a][q];
    }
  }
}

// Per 8x8 unit u (MB-major, u = 4 mb + b8): the unit's (2RS+8)^2 window
// at bank coordinates (y0 + cy - RS + PAD, x0 + cx - RS + PAD) holds every
// quadrant's window, quadrant q = (qy, qx) reading it from (4 qy, 4 qx) on.
// So grid cell (i, j) of all four quadrants is one 8x8 block of the window
// at (i, j), its quadrant q the source's quadrant q.  Two warps take a
// unit, two units (an MB's top or bottom half) a block; the kernel is a
// template on RS, so the strips' shape and every division are constants.
// The window is staged as packed u8 words (WP clipped to 0..255 by one
// VIMNMX.RELU), the source block as packed rows in registers.  Thread (s, j) takes grid column j and the strip of SH
// rows from i0 = s SH on: it reads each of the SH + 7 window rows it needs
// once (three aligned words, two __byte_perm give its 8 samples from j
// on) and feeds the left word to quadrant column 0 and the right one to
// column 1 of every cell whose 8x8 block holds that row, source rows 0-3
// to quadrant row 0 and 4-7 to row 1 (__dp4a, 4 MACs an instruction).
// __dp4a of each half row with itself, summed over 4 rows as a running
// box down the column, gives each quadrant's sum ref^2, and SSD = sum
// cur^2 + box - 2 cross, exact in int32 (16 * 255^2 < 2^20).  A cell is
// priced as soon as its 8th row is in: the rate of cell (i, j) is
// lam_cost(lam_me, by[i] + bx[j]), one per cell for all eight
// partitions (lam_cost is not additive: its fraction is shifted after the
// product), and each partition's cost joins its running first minimum as
// the key cost * 512 + (i * DS + j): the smaller key is the smaller cost
// and, on a tie, the lower raster index, as the reference's argmin takes
// it.  The keys stay below 2^31: a partition's SSD is below 32 * 255^2 <
// 2^21 and its rate below lam_me / 2^16 * 58 < 2^21 for every lam_me in
// 0 .. 2^31 - 1 and every mv difference below 2^13 quarter-pels (mv_bits
// is exact below 2^12, common.cuh).  A pair's key is the sum of its two
// quadrants' keys less the cell's rate-and-index part, one IADD3.  Then
// the minimum over each warp (redux.sync), over the unit's two warps in
// shared memory, and 16 ints a unit written: no grid reaches global
// memory.
constexpr int kSubUnits = 2;     // units a block: an MB's top or bottom
constexpr int kSubThreads = 64;  // threads a unit: two warps
constexpr int kSubWs = 8;        // words a staged row
constexpr int kParts = 8;        // 8x4 top, bottom; 4x8 left, right; 4x4

// a unit's 64 threads hold floor(64 / DS) strips of sub8_sh(RS) rows
__host__ __device__ constexpr int sub8_sh(int RS) {
  return (2 * RS + 1 + kSubThreads / (2 * RS + 1) - 1) /
         (kSubThreads / (2 * RS + 1));
}

// 8 blocks an SM (64 registers) for RS 10, the main path's, whose code
// fits them without spills; 6 (80 registers) for the others, which spill
// at 64
template <int RS>
__global__ void __launch_bounds__(kSubUnits * kSubThreads, RS == 10 ? 8 : 6)
sub8_kernel(const int* __restrict__ banks, const int* __restrict__ cur_y,
            const int* __restrict__ u_ref, const int* __restrict__ u_cy,
            const int* __restrict__ u_cx, const int* __restrict__ u_px,
            const int* __restrict__ u_py, const int* __restrict__ wp_w,
            const int* __restrict__ wp_o, int use_wp, int Hp, int Wp, int W,
            int n_units, int lam_me, int* __restrict__ out) {
  constexpr int DS = 2 * RS + 1, SH = sub8_sh(RS);
  constexpr int NS = (DS + SH - 1) / SH;  // strips with cells in the grid
  constexpr int kRows = NS * SH + 7;      // window rows the strips read
  __shared__ unsigned win[kSubUnits][kRows * kSubWs];
  __shared__ unsigned cw[kSubUnits][16];
  __shared__ unsigned csq[kSubUnits][4];
  __shared__ int by[kSubUnits][DS];
  __shared__ int red[kSubUnits][2][kParts];
  // grid (4 / kSubUnits x n_mx, n_my): block (x, y) holds MB (y, x /
  // (4 / kSubUnits)) and its units b8 = (x % (4 / kSubUnits)) kSubUnits + su
  constexpr int kPer = 4 / kSubUnits;
  const int tid = threadIdx.x, su = tid / kSubThreads;
  const int t = tid - su * kSubThreads;
  const int mx = blockIdx.x / kPer, my = blockIdx.y;
  const int b8 = (blockIdx.x % kPer) * kSubUnits + su;
  const int u = 4 * (my * (W / 16) + mx) + b8;
  const int y0 = 16 * my + 8 * (b8 >> 1), x0 = 16 * mx + 8 * (b8 & 1);
  const int r = u_ref[u], cy = u_cy[u], cx = u_cx[u];
  const int* G = banks + (size_t)r * 4 * Hp * Wp;
  // without WP, w 32 and o 0 leave every sample of 0..255 as it is
  const int w = use_wp ? wp_w[r] : 32, o = use_wp ? wp_o[r] : 0;
  const int wy0 = y0 + cy - RS + kPad, wx0 = x0 + cx - RS + kPad;
  // word (row, xw) packs samples 4 xw .. 4 xw + 3 of the window's row.
  // Thread t stages word xw = t % 8 of rows t / 8, + 8, ...: the same four
  // clamped columns each time.  Samples past the (2RS+8)^2 window are
  // staged too (clamped reads of the bank): no cell of the grid reads
  // them.
  unsigned* wu = win[su];
  {
    const int xw = t % kSubWs;
    const int* gc[4];
#pragma unroll
    for (int b = 0; b < 4; ++b) gc[b] = G + clampi(wx0 + 4 * xw + b, Wp - 1);
#pragma unroll
    for (int m = 0; m * (kSubThreads / kSubWs) < kRows; ++m) {
      const int row = t / kSubWs + m * (kSubThreads / kSubWs);
      if (row >= kRows) break;
      const int off = clampi(wy0 + row, Hp - 1) * Wp;
      int v[4];
#pragma unroll
      for (int b = 0; b < 4; ++b)  // wp_affine, clipped by one VIMNMX
        v[b] = __vimin_s32_relu(((__ldg(gc[b] + off) * w + 16) >> 5) + o, 255);
      wu[row * kSubWs + xw] = __byte_perm(__byte_perm(v[0], v[1], 0x0040),
                                          __byte_perm(v[2], v[3], 0x0040),
                                          0x5410);
    }
  }
  if (t < 32) {
    // the source's half rows (lane 2 y + h), and each quadrant's sum of
    // squares over its 4 half rows (lanes 2 y + h, y = 4 qy .. 4 qy + 3)
    unsigned c = 0;
    if (t < 16) {
      const int* src = cur_y + (size_t)(y0 + (t >> 1)) * W + x0 + 4 * (t & 1);
      c = (unsigned)src[0] | (unsigned)src[1] << 8 |
          (unsigned)src[2] << 16 | (unsigned)src[3] << 24;
      cw[su][t] = c;
    }
    unsigned q = __dp4a(c, c, 0u);
    q += __shfl_xor_sync(0xffffffffu, q, 2);
    q += __shfl_xor_sync(0xffffffffu, q, 4);
    if (t < 16 && (t & 6) == 0) csq[su][(t >> 3 << 1) | (t & 1)] = q;
  }
  if (t < DS) by[su][t] = mv_bits(4 * (cy + t - RS) - u_py[u]);
  __syncthreads();
  int best[kParts];
#pragma unroll
  for (int p = 0; p < kParts; ++p) best[p] = INT_MAX;
  const int s = t / DS, j = t - s * DS;
  if (s < NS) {
    unsigned c[8][2];
#pragma unroll
    for (int y = 0; y < 8; ++y) {
      c[y][0] = cw[su][2 * y];
      c[y][1] = cw[su][2 * y + 1];
    }
    const unsigned cs[4] = {csq[su][0], csq[su][1], csq[su][2], csq[su][3]};
    const int i0 = s * SH;
    const int bx = mv_bits(4 * (cx + j - RS) - u_px[u]);
    const unsigned* wr = wu + i0 * kSubWs + (j >> 2);
    const unsigned sel = 0x3210u + 0x1111u * (unsigned)(j & 3);
    // acc[a][q]: cell i0 + a, quadrant q = 2 qy + qx; sq[h][row]: a half
    // row's sum of squares; box[h][row]: its sum over rows row - 3 .. row
    unsigned acc[SH][4], sq[2][SH + 7], box[2][SH + 7];
#pragma unroll
    for (int a = 0; a < SH; ++a)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[a][q] = 0u;
#pragma unroll
    for (int tr = 0; tr < SH + 7; ++tr) {
      const unsigned* wt = wr + tr * kSubWs;
      const unsigned a0 = wt[0], a1 = wt[1], a2 = wt[2];
      const unsigned w0 = __byte_perm(a0, a1, sel);
      const unsigned w1 = __byte_perm(a1, a2, sel);
      sq[0][tr] = __dp4a(w0, w0, 0u);
      sq[1][tr] = __dp4a(w1, w1, 0u);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (tr == 3)
          box[h][3] = sq[h][0] + sq[h][1] + sq[h][2] + sq[h][3];
        else if (tr > 3)
          box[h][tr] = box[h][tr - 1] + sq[h][tr] - sq[h][tr - 4];
      }
#pragma unroll
      for (int a = 0; a < SH; ++a) {
        const int y = tr - a;
        if (y < 0 || y > 7) continue;
        const int q = 2 * (y >> 2);
        acc[a][q] = __dp4a(w0, c[y][0], acc[a][q]);
        acc[a][q + 1] = __dp4a(w1, c[y][1], acc[a][q + 1]);
      }
      if (tr < 7) continue;
      // cell i = i0 + a, a = tr - 7, is complete
      const int a = tr - 7, i = i0 + a;
      if (NS * SH > DS && i >= DS) continue;
      const unsigned base =
          (unsigned)lam_cost(lam_me, by[su][i] + bx) * 512u +
          (unsigned)(i * DS + j);
      unsigned kq[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const unsigned e = cs[q] + box[q & 1][a + 3 + 4 * (q >> 1)] -
                           2u * acc[a][q];
        kq[q] = e * 512u + base;
      }
      const unsigned key[kParts] = {
          kq[0] + kq[1] - base, kq[2] + kq[3] - base, kq[0] + kq[2] - base,
          kq[1] + kq[3] - base, kq[0], kq[1], kq[2], kq[3]};
#pragma unroll
      for (int p = 0; p < kParts; ++p) best[p] = min(best[p], (int)key[p]);
    }
  }
  // the unit's first minima: each warp's, then its two warps'
  int* rw = red[su][t >> 5];
#pragma unroll
  for (int p = 0; p < kParts; ++p) {
    const int m = __reduce_min_sync(0xffffffffu, best[p]);
    if ((tid & 31) == 0) rw[p] = m;
  }
  __syncthreads();
  if (t < kParts) {
    const int k = min(red[su][0][t], red[su][1][t]) & 511;
    const int i = k / DS;
    out[t * n_units + u] = k - i * DS - RS + cx;
    out[(kParts + t) * n_units + u] = i - RS + cy;
  }
}

}  // namespace

extern "C" int coarse_search(const int* banks, const int* cur_y,
                             const int* wp_w, const int* wp_o, int use_wp,
                             int NR, int Hp, int Wp, int H, int W, int lam_me,
                             unsigned short* plane, int* cen_x, int* cen_y,
                             void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int Hl = (Hp + 2 * kE) / 4, Wl = (Wp + 2 * kE) / 4;
  dim3 dgrid((Hl * Wl + kDecThreads - 1) / kDecThreads, NR);
  decimate_kernel<<<dgrid, kDecThreads, 0, st>>>(banks, wp_w, wp_o, use_wp,
                                                 Hp, Wp, Hl, Wl, plane);
  const int rc = (int)cudaGetLastError();
  if (rc) return rc;
  const int n_mx = W / 16, n_strips = (n_mx + kStrip - 1) / kStrip;
  dim3 grid((H / 16) * n_strips, NR);
  coarse_kernel<<<grid, 32 * kStrip, 0, st>>>(plane, cur_y, Hl, Wl, W, n_mx,
                                              n_strips, lam_me, cen_x, cen_y);
  return (int)cudaGetLastError();
}

extern "C" int ssd_grid8(const int* banks, const int* cur_y, const int* cen_x,
                         const int* cen_y, const int* wp_w, const int* wp_o,
                         int use_wp, int NR, int Hp, int Wp, int H, int W,
                         int R, int* out, void* stream) {
  dim3 grid((H / 16) * (W / 16), NR);
  const int n_strips = (2 * R + 9 + 7) / 8, Wn = 2 * R + 16;
  size_t smem = (size_t)((8 * n_strips + 7) * ((Wn + 4 + 15) / 16 * 4) + 64) *
                sizeof(unsigned);
  ssd8_kernel<<<grid, kS8Threads, smem, (cudaStream_t)stream>>>(
      banks, cur_y, cen_x, cen_y, wp_w, wp_o, use_wp, Hp, Wp, W, R, out);
  return (int)cudaGetLastError();
}

extern "C" int sub8_search(const int* banks, const int* cur_y,
                           const int* u_ref, const int* u_cy, const int* u_cx,
                           const int* u_px, const int* u_py, const int* wp_w,
                           const int* wp_o, int use_wp, int Hp, int Wp, int W,
                           int n_units, int RS, int lam_me, int* out,
                           void* stream) {
  const dim3 grid(4 / kSubUnits * (W / 16), n_units / 4 / (W / 16));
  const dim3 block(kSubUnits * kSubThreads);
  const cudaStream_t st = (cudaStream_t)stream;
#define SUB8_CASE(K)                                                       \
  case K:                                                                  \
    sub8_kernel<K><<<grid, block, 0, st>>>(banks, cur_y, u_ref, u_cy,      \
                                           u_cx, u_px, u_py, wp_w, wp_o,   \
                                           use_wp, Hp, Wp, W, n_units,     \
                                           lam_me, out);                   \
    break;
  switch (RS) {
    SUB8_CASE(0)
    SUB8_CASE(1)
    SUB8_CASE(2)
    SUB8_CASE(3)
    SUB8_CASE(4)
    SUB8_CASE(5)
    SUB8_CASE(6)
    SUB8_CASE(7)
    SUB8_CASE(8)
    SUB8_CASE(9)
    SUB8_CASE(10)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SUB8_CASE
  return (int)cudaGetLastError();
}
