// The lane form of the 4x4 residual coding, shared by K5's inter_luma_tq,
// inter_chroma_tq and i16_candidate (inter_tq.cu) and K13's p16_refine
// (p16_refine.cu), for Hopper (sm_90a).
//
// Two lanes hold one 4x4 block: lane h of the pair holds rows 2h and
// 2h + 1 in registers, r0 and r1 below.  Row passes run in the lane; a
// column pass needs the partner's two rows only as two partial sums a
// column (lane ^ 1), because every output of a 4-point pass is a sum of a
// term from rows 0-1 and one from rows 2-3, the >> 1 of the inverse
// applying to single inputs.  Within a lane a row's parity is static, so
// the quant and dequant constants of a position are too (cls_of).
#pragma once

#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;

// the position class of row j (parity), column x of a lane's two rows
__device__ __forceinline__ constexpr int cls_of(int j, int x) {
  return ((j | x) & 1) == 0 ? 0 : ((j & x) & 1) ? 1 : 2;
}

__device__ __forceinline__ void fwd_row(int (&v)[4]) {
  const int t0 = v[0] + v[3], t1 = v[1] + v[2], t2 = v[1] - v[2],
            t3 = v[0] - v[3];
  v[0] = t0 + t1;
  v[1] = shl(t3, 1) + t2;
  v[2] = t0 - t1;
  v[3] = t3 - shl(t2, 1);
}

__device__ __forceinline__ void inv_row(int (&v)[4]) {
  const int e0 = v[0] + v[2], e1 = v[0] - v[2], e2 = (v[1] >> 1) - v[3],
            e3 = v[1] + (v[3] >> 1);
  v[0] = e0 + e3;
  v[1] = e1 + e2;
  v[2] = e1 - e2;
  v[3] = e0 - e3;
}

// column pass of forward4x4: with rows p0..p3, lane h = 0 keeps b0 = (p0 +
// p1) + (p2 + p3), b1 = (2 p0 + p1) + (-p2 - 2 p3); lane h = 1 keeps b2 =
// (p0 - p1) + (p3 - p2), b3 = (p0 - 2 p1) + (2 p2 - p3)
__device__ __forceinline__ void fwd_cols(int (&r0)[4], int (&r1)[4], int h) {
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const int a = r0[x], b = r1[x];
    const int k0 = h ? b - a : a + b, k1 = h ? shl(a, 1) - b : shl(a, 1) + b;
    const int s0 = h ? a + b : a - b, s1 = h ? -a - shl(b, 1) : a - shl(b, 1);
    r0[x] = k0 + __shfl_xor_sync(kFull, s0, 1);
    r1[x] = k1 + __shfl_xor_sync(kFull, s1, 1);
  }
}

// column pass of inverse4x4: with rows w0..w3, h = 0 keeps (w0 + w1) + (w2
// + (w3 >> 1)), (w0 + (w1 >> 1)) + (-w2 - w3); h = 1 keeps (w0 - (w1 >>
// 1)) + (w3 - w2), (w0 - w1) + (w2 - (w3 >> 1))
__device__ __forceinline__ void inv_cols(int (&r0)[4], int (&r1)[4], int h) {
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const int a = r0[x], b = r1[x], hb = b >> 1;
    const int k0 = h ? b - a : a + b, k1 = h ? a - hb : a + hb;
    const int s0 = h ? a + hb : a - hb, s1 = h ? -a - b : a - b;
    r0[x] = k0 + __shfl_xor_sync(kFull, s0, 1);
    r1[x] = k1 + __shfl_xor_sync(kFull, s1, 1);
  }
}

// the 2x2 Hadamard of the values of the lanes that differ in bits 1 and 2
// (blocks cb = 0..3 of a chroma plane, lane bits 1-2), entry cb to block
// cb's lanes
__device__ __forceinline__ int hadamard_blocks(int v, int cb) {
  int p = __shfl_xor_sync(kFull, v, 2);
  v = (cb & 1) ? p - v : v + p;
  p = __shfl_xor_sync(kFull, v, 4);
  return (cb & 2) ? p - v : v + p;
}

}  // namespace
