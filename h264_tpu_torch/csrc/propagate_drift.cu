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
// Order-free route.  When every term is a non-negative integer and the
// MB's exact total is at most 2^24, every partial sum of any order is an
// integer at most 2^24, which float32 holds exactly: the ordered sum is
// the exact total, and the penalty is float32(total) * float32(1 / K)
// (no clip: it stays below 2^24).  Each thread adds its terms exactly
// (unsigned, saturating at 2^25), the warps sum them with
// __reduce_add_sync, and one barrier ORs the negative-term flags.
//
// Ordered route, otherwise (the MB's total may round, or a square wrapped
// negative): the reference's order as above, a chunk of kKeep decoders at
// a time.  The streaming pass keeps the float32 squares of the first
// kKeep decoders in shared memory; a later chunk (K > kKeep) is restaged
// from the new drift the block has just written (its own global writes
// are visible to it after a barrier; read through L2, not the read-only
// path).  Warp l = 1..7 sums lane l of the chunk's decoders, a decoder a
// thread (32 additions each); thread 0 then runs lane 0 and the fold of
// each decoder in turn, carrying the total.
//
// Design.  One block of 256 threads per MB.  Thread t takes the 4-sample
// row segment t % 64 of the MB (row (t % 64) / 4, columns 4 ((t % 64) % 4)
// .. + 3), which lies in one 4x4 block: its MV and intra flag are read once,
// its gather offsets computed once; and the decoders t / 64, t / 64 + 4, ...
// (a warp's lanes share their decoder, so `lost` does not diverge), kUnroll
// of them with their loads in flight together, with no barrier between
// them.  A decoder's segment is stored as one 16-byte store, the lost
// picture's read as one 16-byte load with the delta's; the gather is 4
// loads (its window moves by whole samples).  Bound: bytes (K + 1 planes
// read, K planes written: 24.8 MB per CIF picture at K 30).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGroups = kThreads / 64;  // decoders taken at once
constexpr int kUnroll = 4;  // decoders a thread has in flight
constexpr int kKeep = 32;   // decoders whose squares the block keeps
constexpr int kRow = 260;   // floats a kept decoder (16-byte rows, padded)
constexpr unsigned kExact = 1u << 24;  // the order-free route's largest total
constexpr unsigned kCap = 1u << 25;  // partial exact totals saturate here
constexpr unsigned kFull = 0xffffffffu;

// the int32 square of v (it wraps) and its exact running total
__device__ __forceinline__ int square(int v) {
  return (int)((unsigned)v * (unsigned)v);
}
__device__ __forceinline__ void add_exact(int v, unsigned& acc, bool& neg) {
  const int e = square(v);
  if (e < 0)
    neg = true;
  else
    acc = min(acc + (unsigned)e, kCap);  // below 2^25 + 2^31: no wrap
}

__device__ __forceinline__ int add_wrap(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

// the 4 squares of segment v as float32 into a kept decoder's row (one
// 16-byte store: a warp's 32 segments fill 512 contiguous bytes)
__device__ __forceinline__ void keep4(float* row, int at, int4 v) {
  *reinterpret_cast<float4*>(row + at) = make_float4(
      __int2float_rn(square(v.x)), __int2float_rn(square(v.y)),
      __int2float_rn(square(v.z)), __int2float_rn(square(v.w)));
}

__global__ void __launch_bounds__(kThreads)
    propagate_drift_kernel(const int* __restrict__ drift,
                           const int* __restrict__ delta,
                           const int2* __restrict__ mv4,
                           const unsigned char* __restrict__ intra4,
                           const unsigned char* __restrict__ lost, int K,
                           int H, int W, float inv_k, int* new_drift,
                           int* __restrict__ pen) {
  __shared__ unsigned s_sum[kThreads / 32];
  __shared__ __align__(16) float sq[kKeep * kRow];  // [decoder][16 y + x]
  __shared__ float lanes[kKeep][8];
  const int n_mx = W >> 4;
  const int mb = blockIdx.x, mbx = mb % n_mx, mby = mb / n_mx;
  const int t = threadIdx.x, seg = t & 63;
  const int y = 16 * mby + (seg >> 2), x = 16 * mbx + 4 * (seg & 3);
  const int b4 = (y >> 2) * (W >> 2) + (x >> 2);
  const int2 mv = __ldg(mv4 + b4);
  const bool intra = __ldg(intra4 + b4) != 0;
  const int gy = min(max(y + ((mv.y + 2) >> 2), 0), H - 1);
  const int gx = x + ((mv.x + 2) >> 2);
  int from[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) from[i] = gy * W + min(max(gx + i, 0), W - 1);
  const size_t plane = (size_t)H * W;
  const int at = y * W + x;
  const int4 dv = __ldg(reinterpret_cast<const int4*>(delta + at));

  unsigned acc = 0;
  bool neg = false;
  for (int k0 = t / 64; k0 < K; k0 += kUnroll * kGroups) {
    int4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {  // every load first
      const int k = k0 + u * kGroups;
      if (k >= K) break;
      const int* d = drift + (size_t)k * plane;
      if (__ldg(lost + k)) {
        const int4 a = __ldg(reinterpret_cast<const int4*>(d + at));
        v[u] = make_int4(add_wrap(a.x, dv.x), add_wrap(a.y, dv.y),
                         add_wrap(a.z, dv.z), add_wrap(a.w, dv.w));
      } else if (intra) {
        v[u] = make_int4(0, 0, 0, 0);
      } else {
        v[u] = make_int4(__ldg(d + from[0]), __ldg(d + from[1]),
                         __ldg(d + from[2]), __ldg(d + from[3]));
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int k = k0 + u * kGroups;
      if (k >= K) break;
      *reinterpret_cast<int4*>(new_drift + (size_t)k * plane + at) = v[u];
      if (k < kKeep) keep4(sq + k * kRow, 4 * seg, v[u]);
      add_exact(v[u].x, acc, neg);
      add_exact(v[u].y, acc, neg);
      add_exact(v[u].z, acc, neg);
      add_exact(v[u].w, acc, neg);
    }
  }
  acc = __reduce_add_sync(kFull, acc);  // at most 32 x 2^25
  if ((t & 31) == 0) s_sum[t >> 5] = min(acc, kCap);
  neg = __syncthreads_or(neg);
  unsigned total = 0;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) total += s_sum[w];
  if (!neg && total <= kExact) {  // the order-free route
    if (t == 0)
      pen[mb] = __float2int_rz(__fmul_rn(__uint2float_rn(total), inv_k));
    return;
  }

  // the ordered route: the reference's additions, kKeep decoders a pass
  float total_f = 0.0f;  // thread 0's running total
  for (int k0 = 0; k0 < K; k0 += kKeep) {
    const int kn = min(kKeep, K - k0);
    if (k0 > 0) {  // restage: the squares from the drift written
      for (int j = t; j < 64 * kn; j += kThreads) {
        const int kk = j >> 6, sg = j & 63;
        const int4 v = __ldcg(reinterpret_cast<const int4*>(
            new_drift + (size_t)(k0 + kk) * plane +
            (16 * mby + (sg >> 2)) * W + 16 * mbx + 4 * (sg & 3)));
        keep4(sq + kk * kRow, 4 * sg, v);
      }
      __syncthreads();
    }
    {  // warp l sums lane l of decoder kk = its lane index
      const int l = t >> 5, kk = t & 31;
      if (l > 0 && kk < kn) {
        const float* s = sq + kk * kRow;
        float a = -0.0f;
        for (int c = 0; c < 16; ++c) a = __fadd_rn(a, s[l * 16 + c]);
        for (int c = 0; c < 16; ++c) a = __fadd_rn(a, s[(l + 8) * 16 + c]);
        lanes[kk][l] = a;
      }
    }
    __syncthreads();
    if (t == 0) {
      for (int kk = 0; kk < kn; ++kk) {
        const float* s = sq + kk * kRow;
        const float* v = lanes[kk];
        float v0 = total_f;
        for (int c = 0; c < 16; ++c) v0 = __fadd_rn(v0, s[c]);
        for (int c = 0; c < 16; ++c) v0 = __fadd_rn(v0, s[128 + c]);
        const float a0 = __fadd_rn(v0, v[4]), a1 = __fadd_rn(v[1], v[5]);
        const float a2 = __fadd_rn(v[2], v[6]), a3 = __fadd_rn(v[3], v[7]);
        total_f = __fadd_rn(__fadd_rn(a0, a2), __fadd_rn(a1, a3));
      }
    }
    __syncthreads();  // the squares and lanes are read before reuse
  }
  if (t == 0)
    pen[mb] = __float2int_rz(fminf(__fmul_rn(total_f, inv_k), 1073741824.0f));
}

}  // namespace

// drift (K, H, W), delta (H, W), mv4 (H/4, W/4, 2) int32, 16-byte aligned;
// intra4 (H/4, W/4) and lost (K,) one byte each (0 or 1); new_drift (K, H,
// W), pen (n_mb,) int32; H and W multiples of 16, K >= 1.  Returns the CUDA
// error of the launch.
extern "C" int propagate_drift(const int* drift, const int* delta,
                               const int* mv4, const unsigned char* intra4,
                               const unsigned char* lost, int K, int H,
                               int W, int* new_drift, int* pen,
                               void* stream) {
  const int n_mb = (H / 16) * (W / 16);
  if (n_mb == 0 || K <= 0) return 0;
  const float inv_k = 1.0f / (float)K;  // IEEE single division, as XLA folds
  propagate_drift_kernel<<<n_mb, kThreads, 0, (cudaStream_t)stream>>>(
      drift, delta, reinterpret_cast<const int2*>(mv4), intra4, lost, K, H,
      W, inv_k, new_drift, pen);
  return (int)cudaGetLastError();
}
