// K11: one picture's step of the loss-aware RDO's simulated decoders, for
// Hopper (sm_90a).
//
// Replaces h264_tpu/encoder/lossaware.py:35 `propagate_drift` (the jitted
// vmap over the K decoders).  For decoder k and sample (y, x) of an H x W
// picture the new drift is
//   lost[k]            : drift[k][y][x] + frame_delta[y][x]  (int32, wraps)
//   intra 4x4 block    : 0
//   otherwise          : drift[k][gy][gx], gy = clip(y + ((mvy + 2) >> 2),
//                        0, H - 1), gx likewise (nearest-pel gather of the
//                        block's quarter-pel list-0 MV, arithmetic shift)
// and the next picture's penalty of MB m is
//   pen[m] = (int)min(total_m * float32(1 / K), 2^30)  (truncated,
//            saturating), total_m a float32 sum of float32(new * new)
//            (the square wraps as int32) over the K decoders and the MB's
//            256 samples.
// Plain version: h264_tpu_torch/encoder/lossaware.py
// `propagate_drift_plain`; wrapper kernels/propagate_drift.py.
//
// Exactness.  A float32 sum above 2^24 rounds, so total_m depends on the
// order of its additions; the kernel adds in the order of the reference's
// program as XLA compiles it for the CPU (one fused reduction, vectorized
// over 8 rows; lossaware.py `drift_energy`): per MB one total runs through
// the decoders in order; for decoder k, lane l (0..7) adds, column by
// column, row l's samples and then row l + 8's, lane 0 starting from the
// total and the others from -0.0; the lanes fold in halves ((l, l+4),
// (l, l+2), (0, 1)) into the new total.  Every addition is __fadd_rn and
// the scale __fmul_rn: no FMA contraction, no fast math.  Squares and the
// lost-picture add are formed unsigned, so they wrap as int32 does.
//
// Design.  One block of 256 threads per MB, a thread per sample.  For each
// chunk of up to 8 decoders: every thread computes its sample's new drift
// for the chunk's decoders, writes it and puts its float32 square in shared
// memory; threads (k, l), l = 1..7, sum lane l of decoder k of the chunk
// (32 additions each); thread 0 then runs lane 0 and the fold of each
// decoder in turn, carrying the total.  Bound: bytes (K + 1 planes read,
// K planes written: 24.8 MB per CIF picture at K 30); the serial part is
// thread 0's 35 dependent additions per decoder.

#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 8;  // decoders per shared-memory pass

__global__ void __launch_bounds__(256)
    propagate_drift_kernel(const int* __restrict__ drift,
                           const int* __restrict__ delta,
                           const int* __restrict__ mv4,
                           const unsigned char* __restrict__ intra4,
                           const unsigned char* __restrict__ lost, int K,
                           int H, int W, float inv_k,
                           int* __restrict__ new_drift,
                           int* __restrict__ pen) {
  __shared__ float sq[kChunk][256];
  __shared__ float lanes[kChunk][8];
  const int n_mx = W >> 4;
  const int mb = blockIdx.x, mbx = mb % n_mx, mby = mb / n_mx;
  const int t = threadIdx.x;
  const int y = mby * 16 + (t >> 4), x = mbx * 16 + (t & 15);
  const int b4 = (y >> 2) * (W >> 2) + (x >> 2);
  const int gy = min(max(y + ((mv4[2 * b4 + 1] + 2) >> 2), 0), H - 1);
  const int gx = min(max(x + ((mv4[2 * b4] + 2) >> 2), 0), W - 1);
  const bool intra = intra4[b4] != 0;
  const size_t plane = (size_t)H * W;
  const int at = y * W + x, from = gy * W + gx;
  const unsigned dval = (unsigned)delta[at];
  float total = 0.0f;  // thread 0's running total

  for (int k0 = 0; k0 < K; k0 += kChunk) {
    const int kn = min(kChunk, K - k0);
    for (int kk = 0; kk < kn; ++kk) {
      const int* d = drift + (size_t)(k0 + kk) * plane;
      const int v = lost[k0 + kk] ? (int)((unsigned)d[at] + dval)
                                  : (intra ? 0 : d[from]);
      new_drift[(size_t)(k0 + kk) * plane + at] = v;
      sq[kk][t] = __int2float_rn((int)((unsigned)v * (unsigned)v));
    }
    __syncthreads();
    if (t < kn * 8 && (t & 7)) {  // lanes 1..7
      const float* s = sq[t >> 3];
      const int l = t & 7;
      float acc = -0.0f;
      for (int c = 0; c < 16; ++c) acc = __fadd_rn(acc, s[l * 16 + c]);
      for (int c = 0; c < 16; ++c) acc = __fadd_rn(acc, s[(l + 8) * 16 + c]);
      lanes[t >> 3][l] = acc;
    }
    __syncthreads();
    if (t == 0) {
      for (int kk = 0; kk < kn; ++kk) {
        const float* s = sq[kk];
        const float* v = lanes[kk];
        float v0 = total;
        for (int c = 0; c < 16; ++c) v0 = __fadd_rn(v0, s[c]);
        for (int c = 0; c < 16; ++c) v0 = __fadd_rn(v0, s[128 + c]);
        const float a0 = __fadd_rn(v0, v[4]), a1 = __fadd_rn(v[1], v[5]);
        const float a2 = __fadd_rn(v[2], v[6]), a3 = __fadd_rn(v[3], v[7]);
        total = __fadd_rn(__fadd_rn(a0, a2), __fadd_rn(a1, a3));
      }
    }
    __syncthreads();  // the chunk's squares are read before the next one
  }
  if (t == 0)
    pen[mb] = __float2int_rz(fminf(__fmul_rn(total, inv_k), 1073741824.0f));
}

}  // namespace

// drift (K, H, W), delta (H, W), mv4 (H/4, W/4, 2) int32; intra4 (H/4, W/4)
// and lost (K,) one byte each (0 or 1); new_drift (K, H, W), pen (n_mb,)
// int32; H and W multiples of 16, K >= 1.  Returns the CUDA error of the
// launch.
extern "C" int propagate_drift(const int* drift, const int* delta,
                               const int* mv4, const unsigned char* intra4,
                               const unsigned char* lost, int K, int H,
                               int W, int* new_drift, int* pen,
                               void* stream) {
  const int n_mb = (H / 16) * (W / 16);
  if (n_mb == 0 || K <= 0) return 0;
  const float inv_k = 1.0f / (float)K;  // IEEE single division, as XLA folds
  propagate_drift_kernel<<<n_mb, 256, 0, (cudaStream_t)stream>>>(
      drift, delta, mv4, intra4, lost, K, H, W, inv_k, new_drift, pen);
  return (int)cudaGetLastError();
}
