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
// kernels/sad_grid.py.
//
// Exactness: 256 terms of at most 255 each, so every sum is exact in int32
// in any order.
//
// Design.  One block of 256 threads per (MB, tile of dy values, tile of dx
// values): a dx tile holds up to 256 displacements and a dy tile as many
// rows as keep the tile at or under 256 positions (R 16: 7 dy x 33 dx).  The
// block stages the MB's 256 source samples and the reference window its
// tile reads, (dy tile + 15) x (dx tile + 15) samples, in shared memory;
// then each thread sums the 256 absolute differences of one position,
// neighbouring threads on neighbouring dx (consecutive shared-memory words,
// the source sample a broadcast).  Tiling dx as well as dy bounds the
// shared memory (17.3 KB at most) for any R.
//
// Bound.  Operations: 256 SAD terms of u8 samples per position and MB, 4
// an instruction at best (VABSDIFF4 sums 4 absolute differences): 27.6 M
// at CIF, R 16, against 2.6 MB of bytes (each plane read once, the grid
// written once), so the operations bound leads.  This kernel takes 3
// instructions a term (subtract, absolute value, add) and reads 2 shared-
// memory words per term; the shared-memory rate, not the integer lanes,
// is what this simple design runs into.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxPos = 256;  // positions (threads) per block
constexpr int kStripMax = (1 + 15) * (kMaxPos + 15);  // dy tile 1, dx 256

__global__ void __launch_bounds__(kMaxPos)
    sad_grid_kernel(const int* __restrict__ cur, const int* __restrict__ ref,
                    int W, int R, int n_mx, int n_mb, int dyt, int dxt,
                    int* __restrict__ out) {
  __shared__ int src[256];
  __shared__ int strip[kStripMax];
  const int D = 2 * R + 1;
  const int mb = blockIdx.x, mbx = mb % n_mx, mby = mb / n_mx;
  const int dy0 = blockIdx.y * dyt, dx0 = blockIdx.z * dxt;
  const int ny = min(dyt, D - dy0), nx = min(dxt, D - dx0);
  const int rows = ny + 15, cols = nx + 15;
  const int Wp = W + 2 * R;
  const int tid = threadIdx.x;

  src[tid] = cur[(mby * 16 + (tid >> 4)) * W + mbx * 16 + (tid & 15)];
  // the window of padded-reference rows mby*16 + dy0 ..., columns
  // mbx*16 + dx0 ... (always inside the (H + 2R, W + 2R) plane)
  const int* base = ref + (size_t)(mby * 16 + dy0) * Wp + mbx * 16 + dx0;
  for (int i = tid; i < rows * cols; i += blockDim.x) {
    const int r = i / cols, c = i - r * cols;
    strip[i] = base[(size_t)r * Wp + c];
  }
  __syncthreads();

  for (int p = tid; p < ny * nx; p += blockDim.x) {
    const int ty = p / nx, tx = p - ty * nx;
    int s = 0;
#pragma unroll 4
    for (int y = 0; y < 16; ++y) {
      const int* row = strip + (ty + y) * cols + tx;
      const int* sr = src + 16 * y;
#pragma unroll
      for (int x = 0; x < 16; ++x) s += abs(sr[x] - row[x]);
    }
    out[((size_t)(dy0 + ty) * D + dx0 + tx) * n_mb + mb] = s;
  }
}

}  // namespace

// cur (H, W), ref (H + 2R, W + 2R), out (2R+1, 2R+1, H/16, W/16), int32;
// H and W multiples of 16, R >= 0.  Returns the CUDA error of the launch.
extern "C" int sad_grid_16x16(const int* cur, const int* ref, int H, int W,
                              int R, int* out, void* stream) {
  const int D = 2 * R + 1;
  const int n_mx = W / 16, n_mb = (H / 16) * n_mx;
  if (n_mb == 0) return 0;
  const int dxt = D < kMaxPos ? D : kMaxPos;
  int dyt = kMaxPos / dxt;
  if (dyt > D) dyt = D;
  dim3 grid(n_mb, (D + dyt - 1) / dyt, (D + dxt - 1) / dxt);
  sad_grid_kernel<<<grid, kMaxPos, 0, (cudaStream_t)stream>>>(
      cur, ref, W, R, n_mx, n_mb, dyt, dxt, out);
  return (int)cudaGetLastError();
}
