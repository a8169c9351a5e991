// K3: the dense block-matching grids of a P picture, for Hopper (sm_90a).
//
// Replaces h264_tpu/encoder/rd.py:329 `rd_p_pipeline`'s search stages:
//   coarse_search  stage 0, `coarse_block` (rd.py:361-418): per (ref, MB)
//                  the +-48-pel SAD search on 4x-decimated planes of the
//                  (weighted) G plane, priced with lambda_me * mv bits;
//   ssd_grid8      stage 1, `block_ssd` (rd.py:420-459): per (ref, 8x8
//                  block) the (2R+1)^2 SSD grid around its MB's centre;
//   ssd_grid4      `block_ssd4` (rd.py:640-665): per 8x8 unit and 4x4
//                  quadrant the (2RS+1)^2 grid on the unit's reference.
// Plain versions: h264_tpu_torch/encoder/rd_p.py `coarse_search_plain`,
// `ssd_grid8_plain`, `ssd_grid4_plain`; wrapper kernels/search_grid.py.
//
// Design.  coarse_search and ssd_grid4: one block per (ref, MB) / unit;
// the block loads its search window (weighted on the fly: wp_affine of
// the G sample) and its source block into shared memory, then every
// thread computes whole grid cells directly as sum (cur - ref)^2 (or |.|
// for the coarse SAD); coarse_search takes the first minimum (strict <,
// lowest index on ties) by a shared-memory tree.  ssd_grid8: one block per
// (ref, MB) over the union of its four blocks' windows, the cross term by
// __dp4a on packed u8 (ssd8_kernel below).  The reference widens the
// banks by 64 samples of edge replication first; a read clamped to the
// unwidened bank is the same sample.  No window of this path starts
// outside the widened bank, so the reference's dynamic_slice never clamps
// its start (tests/test_torch_p_ops.py).
//
// Bound.  ssd_grid8: NR * n_b8 * (2R+1)^2 * 64 MACs (1.65 G at CIF, NR 5,
// R 28) and an output of (NR, n_b8, 57, 57) int32 (103 MB at CIF, 0.94 GB
// at 1280x720).  Its first version took each MAC as two shared-memory
// loads, a subtract and a multiply-add, and was bound by the loads (one
// warp-wide load a clock per SM: 0.41 ms at CIF against 0.44 measured).
// Here a window sample read from shared memory feeds 32 MACs in 8
// __dp4a, the route taken because a MAC costs a quarter instruction on the
// integer pipe with no conversion of the u8 samples, where float32 FMAs
// on CUDA cores (also exact below 2^24) cost one on a pipe twice as wide
// and need the window as float; the union window, cut in units of 8
// rows, computes 44 % more cells than the blocks need (72 x 65 x 4
// against 57 x 57 x 4 at R 28) for one staged window instead of four.  A
// tensor-core form (mma.m16n8k32 u8, a pair of union rows against the
// four blocks' two rows) was also bit-exact, faster at 1280x720 and
// slower at CIF, where its window staging and box sums set the time; this
// simpler one stays until the fused partition reduction (ROADMAP), which
// removes the output's stores that both forms pay, chooses again.  The
// output's bytes are the bound.  coarse_search and ssd_grid4 keep their
// first versions.
//
// ptxas (sm_90a, nvcc -O3): coarse_kernel 48 registers, 8,320 B static
// shared memory; ssd8_kernel 147 registers (3 blocks of 128 threads an
// SM), dynamic shared memory (8 ceil((2R+9)/8) + 7) rows x ceil((2R+20)/16)
// x 16 B of window + 256 B (6.6 KB at R = 28); ssd4_kernel 32 registers,
// (2RS+8)^2 + 64 ints (3.4 KB); no spills.

#include <climits>

#include "common.cuh"

namespace {

constexpr int kRC = 12;    // coarse range, 4-pel units
constexpr int kDCo = 25;   // 2 * kRC + 1
constexpr int kCoarseThreads = 640;

// sample (y, x) of the G plane of one reference, bank coordinates clamped,
// weighted when use_wp
__device__ __forceinline__ int g_sample(const int* G, int Hp, int Wp, int y,
                                        int x, int use_wp, int w, int o) {
  int v = G[(size_t)clampi(y, Hp - 1) * Wp + clampi(x, Wp - 1)];
  return use_wp ? wp_affine(v, w, o) : v;
}

__global__ void __launch_bounds__(kCoarseThreads)
coarse_kernel(const int* __restrict__ banks, const int* __restrict__ cur_y,
              const int* __restrict__ wp_w, const int* __restrict__ wp_o,
              int use_wp, int Hp, int Wp, int W, int n_mx, int lam_me,
              int* cen_x, int* cen_y) {
  __shared__ int win[kDCo + 3][kDCo + 3];
  __shared__ int cb[4][4];
  __shared__ int cost[kCoarseThreads];
  __shared__ int idx[kCoarseThreads];
  const int tid = threadIdx.x;
  const int mb = blockIdx.x, r = blockIdx.y;
  const int my = mb / n_mx, mx = mb % n_mx;
  const int* G = banks + (size_t)r * 4 * Hp * Wp;
  const int w = use_wp ? wp_w[r] : 32, o = use_wp ? wp_o[r] : 0;
  // decimated window cell (wy, wx) sums the widened samples 4 (4 my + 12 +
  // wy) + a, i.e. bank rows 16 my + 4 wy + a - 16 (and the same in x)
  for (int k = tid; k < (kDCo + 3) * (kDCo + 3); k += kCoarseThreads) {
    int wy = k / (kDCo + 3), wx = k % (kDCo + 3);
    int y0 = 16 * my + 4 * wy - 16, x0 = 16 * mx + 4 * wx - 16, s = 0;
    for (int a = 0; a < 4; ++a)
      for (int b = 0; b < 4; ++b)
        s += g_sample(G, Hp, Wp, y0 + a, x0 + b, use_wp, w, o);
    win[wy][wx] = s;
  }
  if (tid < 16) {
    int a = tid >> 2, b = tid & 3, s = 0;
    for (int i = 0; i < 4; ++i)
      for (int j = 0; j < 4; ++j)
        s += cur_y[(size_t)(16 * my + 4 * a + i) * W + 16 * mx + 4 * b + j];
    cb[a][b] = s;
  }
  __syncthreads();
  int c = INT_MAX;
  if (tid < kDCo * kDCo) {
    int ky = tid / kDCo, kx = tid % kDCo, acc = 0;
    for (int a = 0; a < 4; ++a)
      for (int b = 0; b < 4; ++b) acc += abs(win[ky + a][kx + b] - cb[a][b]);
    c = acc + lam_cost(lam_me, mv_bits((kx - kRC) * 16) +
                                   mv_bits((ky - kRC) * 16));
  }
  cost[tid] = c;
  idx[tid] = tid;
  __syncthreads();
  // first minimum: 640 = 512 + 128, fold the tail first
  if (tid < kCoarseThreads - 512) {
    int j = tid + 512;
    if (cost[j] < cost[tid]) {
      cost[tid] = cost[j];
      idx[tid] = idx[j];
    }
  }
  __syncthreads();
  for (int s = 256; s > 0; s >>= 1) {
    if (tid < s) {
      int j = tid + s;
      if (cost[j] < cost[tid] || (cost[j] == cost[tid] && idx[j] < idx[tid])) {
        cost[tid] = cost[j];
        idx[tid] = idx[j];
      }
    }
    __syncthreads();
  }
  if (tid == 0) {
    int k = idx[0], n = r * gridDim.x + mb;
    cen_x[n] = (k % kDCo - kRC) * 4;
    cen_y[n] = (k / kDCo - kRC) * 4;
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

// Per 8x8 unit u (MB-major: u = 4 mb + b8): one window of (2RS+8)^2 at
// bank coordinates (y0 + cy - RS + PAD, ...) covers the four quadrants'
// windows, quadrant q's starting at (4 (q >> 1), 4 (q & 1)) inside it.
__global__ void __launch_bounds__(256)
ssd4_kernel(const int* __restrict__ banks, const int* __restrict__ cur_y,
            const int* __restrict__ u_ref, const int* __restrict__ u_cy,
            const int* __restrict__ u_cx, const int* __restrict__ wp_w,
            const int* __restrict__ wp_o, int use_wp, int Hp, int Wp, int W,
            int RS, int* out) {
  extern __shared__ int sm[];
  const int Wu = 2 * RS + 8, DS = 2 * RS + 1;
  int* win = sm;
  int* cur = sm + Wu * Wu;
  const int tid = threadIdx.x, u = blockIdx.x;
  const int n_mx = W / 16, mb = u >> 2, b8 = u & 3;
  const int y0 = 16 * (mb / n_mx) + 8 * (b8 >> 1);
  const int x0 = 16 * (mb % n_mx) + 8 * (b8 & 1);
  const int r = u_ref[u];
  const int* G = banks + (size_t)r * 4 * Hp * Wp;
  const int w = use_wp ? wp_w[r] : 32, o = use_wp ? wp_o[r] : 0;
  const int wy0 = y0 + u_cy[u] - RS + kPad, wx0 = x0 + u_cx[u] - RS + kPad;
  for (int k = tid; k < Wu * Wu; k += blockDim.x)
    win[k] = g_sample(G, Hp, Wp, wy0 + k / Wu, wx0 + k % Wu, use_wp, w, o);
  if (tid < 64) cur[tid] = cur_y[(size_t)(y0 + (tid >> 3)) * W + x0 + (tid & 7)];
  __syncthreads();
  int* dst = out + (size_t)u * 4 * DS * DS;
  for (int k = tid; k < 4 * DS * DS; k += blockDim.x) {
    int q = k / (DS * DS), cell = k % (DS * DS);
    int oy = 4 * (q >> 1), ox = 4 * (q & 1);
    int i = cell / DS, j = cell % DS, acc = 0;
    for (int y = 0; y < 4; ++y)
      for (int x = 0; x < 4; ++x) {
        int d = cur[8 * (oy + y) + ox + x] - win[(oy + i + y) * Wu + ox + j + x];
        acc += d * d;
      }
    dst[k] = acc;
  }
}

}  // namespace

extern "C" int coarse_search(const int* banks, const int* cur_y,
                             const int* wp_w, const int* wp_o, int use_wp,
                             int NR, int Hp, int Wp, int H, int W, int lam_me,
                             int* cen_x, int* cen_y, void* stream) {
  dim3 grid((H / 16) * (W / 16), NR);
  coarse_kernel<<<grid, kCoarseThreads, 0, (cudaStream_t)stream>>>(
      banks, cur_y, wp_w, wp_o, use_wp, Hp, Wp, W, W / 16, lam_me, cen_x,
      cen_y);
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

extern "C" int ssd_grid4(const int* banks, const int* cur_y, const int* u_ref,
                         const int* u_cy, const int* u_cx, const int* wp_w,
                         const int* wp_o, int use_wp, int n_units, int Hp,
                         int Wp, int W, int RS, int* out, void* stream) {
  int Wu = 2 * RS + 8;
  size_t smem = (size_t)(Wu * Wu + 64) * sizeof(int);
  ssd4_kernel<<<n_units, 256, smem, (cudaStream_t)stream>>>(
      banks, cur_y, u_ref, u_cy, u_cx, wp_w, wp_o, use_wp, Hp, Wp, W, RS, out);
  return (int)cudaGetLastError();
}
