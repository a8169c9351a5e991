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
// Design.  One block per (ref, MB) / (ref, 8x8) / unit; the block loads
// its search window (weighted on the fly: wp_affine of the G sample) and
// its source block into shared memory, then every thread computes whole
// grid cells directly as sum (cur - ref)^2 (or |.| for the coarse SAD).
// The reference computes SSD as box sums of ref^2 - 2 cross + cur^2; in
// int32 the two are equal (every term is below 64 * 255^2 < 2^22).  The
// reference widens the banks by 64 samples of edge replication first; a
// read clamped to the unwidened bank is the same sample.  No window of
// this path starts outside the widened bank, so the reference's
// dynamic_slice never clamps its start (tests/test_torch_p_ops.py).
// coarse_search takes the first minimum (strict <, lowest index on ties)
// by a shared-memory tree.
//
// Bound.  Operations: ssd_grid8 is 3 int32 operations per MAC,
// NR * n_b8 * (2R+1)^2 * 64 MACs (1.65 G at CIF, NR 5, R 28); its output
// (NR, n_b8, 57, 57) int32 is 103 MB at CIF, so bytes are close behind.
//
// ptxas (sm_90a, nvcc -O3): coarse_kernel 48 registers, 8,320 B static
// shared memory; ssd8_kernel / ssd4_kernel 31-32 registers each, dynamic
// shared memory (2R+8)^2 + 64 ints (16.6 KB at R = 28) and (2RS+8)^2 + 64
// ints (3.4 KB); no spills.

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

// Per (ref, 8x8 block): window Wn x Wn (Wn = 2R + 8) at bank coordinates
// (by + cy - R + PAD, bx + cx - R + PAD); cell (i, j) = sum over the 8x8
// of (cur - win[i + y][j + x])^2.
__global__ void __launch_bounds__(256)
ssd8_kernel(const int* __restrict__ banks, const int* __restrict__ cur_y,
            const int* __restrict__ cen_x, const int* __restrict__ cen_y,
            const int* __restrict__ wp_w, const int* __restrict__ wp_o,
            int use_wp, int Hp, int Wp, int W, int R, int* out) {
  extern __shared__ int sm[];
  const int Wn = 2 * R + 8, D = 2 * R + 1;
  int* win = sm;
  int* cur = sm + Wn * Wn;
  const int tid = threadIdx.x;
  const int b = blockIdx.x, r = blockIdx.y, n_b8 = gridDim.x;
  const int nbx = W / 8, n_mx = W / 16;
  const int by = (b / nbx) * 8, bx = (b % nbx) * 8;
  const int mb = (b / nbx) / 2 * n_mx + (b % nbx) / 2;
  const int n_mb = n_b8 / 4;
  const int cy = cen_y[r * n_mb + mb], cx = cen_x[r * n_mb + mb];
  const int* G = banks + (size_t)r * 4 * Hp * Wp;
  const int w = use_wp ? wp_w[r] : 32, o = use_wp ? wp_o[r] : 0;
  const int y0 = by + cy - R + kPad, x0 = bx + cx - R + kPad;
  for (int k = tid; k < Wn * Wn; k += blockDim.x)
    win[k] = g_sample(G, Hp, Wp, y0 + k / Wn, x0 + k % Wn, use_wp, w, o);
  if (tid < 64) cur[tid] = cur_y[(size_t)(by + (tid >> 3)) * W + bx + (tid & 7)];
  __syncthreads();
  int* dst = out + ((size_t)r * n_b8 + b) * D * D;
  for (int k = tid; k < D * D; k += blockDim.x) {
    int i = k / D, j = k % D, acc = 0;
    for (int y = 0; y < 8; ++y) {
      const int* row = win + (i + y) * Wn + j;
      for (int x = 0; x < 8; ++x) {
        int d = cur[8 * y + x] - row[x];
        acc += d * d;
      }
    }
    dst[k] = acc;
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
  dim3 grid((H / 8) * (W / 8), NR);
  int Wn = 2 * R + 8;
  size_t smem = (size_t)(Wn * Wn + 64) * sizeof(int);
  ssd8_kernel<<<grid, 256, smem, (cudaStream_t)stream>>>(
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
