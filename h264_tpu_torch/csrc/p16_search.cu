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
// it is the integer SSD; here the SSD is summed in int32 (at most
// 16,646,400) and the cost stays below 2^25 at every QP and R <= 32.
//
// Design.  One block of 256 threads per MB.  The block stages the MB's 256
// samples and its (16 + 2R)^2 search window (at most 80 x 80 samples, 25.6
// KB, at R 32) in shared memory; each thread takes the offsets p = tid,
// tid + 256, ... in increasing order, sums the 256 squared differences of
// each (neighbouring threads on neighbouring dx: consecutive shared words,
// the MB sample a broadcast), adds the rate and keeps its first minimum by
// strict <; a shared-memory tree then takes the least (cost, p) pair, the
// smaller p on equal costs.
//
// Bound.  Operations: the SSD's cross term in __dp4a, a quarter
// instruction per term, 256 terms per offset and MB, the squares shared by
// the offsets: (2R+1)^2 * H * W / 4 and a few per offset and MB, 89 M at
// CIF, R 28.  Bytes: the two planes read once, 3 int32 per MB written.
// The operations bound leads.  This kernel takes two instructions a term
// (subtract, multiply-add) and reads two shared words per term; the
// shared-memory rate is what this simple design runs into.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxR = 32;
constexpr int kMaxS = 16 + 2 * kMaxR;  // window side at the largest R

__global__ void __launch_bounds__(kThreads)
    p16_search_kernel(const int* __restrict__ cur,
                      const int* __restrict__ ref_pad, int W, int R, int lam,
                      int n_mx, int* __restrict__ mvx, int* __restrict__ mvy,
                      int* __restrict__ grid0) {
  __shared__ int src[256];
  __shared__ int win[kMaxS * kMaxS];
  __shared__ int best_c[kThreads], best_p[kThreads];
  const int mb = blockIdx.x, mbx = mb % n_mx, mby = mb / n_mx;
  const int tid = threadIdx.x;
  const int D = 2 * R + 1, S = 16 + 2 * R, Wp = W + 2 * kPad;

  src[tid] = cur[(size_t)(mby * 16 + (tid >> 4)) * W + mbx * 16 + (tid & 15)];
  // the window's top-left is the offset (-R, -R) of the MB, always inside
  // the padded plane for R <= 32
  const int* base =
      ref_pad + (size_t)(kPad + mby * 16 - R) * Wp + kPad + mbx * 16 - R;
  for (int i = tid; i < S * S; i += kThreads) {
    const int r = i / S, c = i - r * S;
    win[i] = base[(size_t)r * Wp + c];
  }
  __syncthreads();

  int bc = 0x7fffffff, bp = 0x7fffffff;
  for (int p = tid; p < D * D; p += kThreads) {
    const int dy = p / D, dx = p - dy * D;
    int s = 0;
#pragma unroll 4
    for (int y = 0; y < 16; ++y) {
      const int* row = win + (dy + y) * S + dx;
      const int* sr = src + 16 * y;
#pragma unroll
      for (int x = 0; x < 16; ++x) {
        const int e = sr[x] - row[x];
        s += e * e;
      }
    }
    if (dy == R && dx == R) grid0[mb] = s;
    const int c = s + lam_cost(lam, mv_bits(4 * (dx - R)) + mv_bits(4 * (dy - R)));
    if (c < bc) {  // p rises: the first minimum of this thread's offsets
      bc = c;
      bp = p;
    }
  }
  best_c[tid] = bc;
  best_p[tid] = bp;
  __syncthreads();
  for (int h = kThreads / 2; h > 0; h >>= 1) {
    if (tid < h) {
      const int oc = best_c[tid + h], op = best_p[tid + h];
      if (oc < best_c[tid] || (oc == best_c[tid] && op < best_p[tid])) {
        best_c[tid] = oc;
        best_p[tid] = op;
      }
    }
    __syncthreads();
  }
  if (tid == 0) {
    mvx[mb] = best_p[0] % D - R;
    mvy[mb] = best_p[0] / D - R;
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
  p16_search_kernel<<<n_mb, kThreads, 0, (cudaStream_t)stream>>>(
      cur, ref_pad, W, R, lam, n_mx, mvx, mvy, grid0);
  return (int)cudaGetLastError();
}
