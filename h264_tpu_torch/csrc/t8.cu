// K9: the FRExt transform-size decision of a P picture, for Hopper (sm_90a).
//
// Replaces h264_tpu/encoder/rd.py:1071-1113, the T8 stage of
// `rd_p_pipeline` (lencod transform8x8.c:1452 Mode_Decision_for_8x8
// Transform): every MB's winning luma prediction is re-coded with the 8x8
// transform and kept when
//   D_8 + lambda (cb8 + 1) < D_4 + lambda (cb4 + 1)
// (strictly: a tie keeps 4x4), for inter, non-skip winners whose units are
// all at least 8x8.  Plain version: h264_tpu_torch/encoder/rd_p.py
// `t8_decide_plain`; wrapper kernels/t8.py.
//
// Per MB: the residual orig - pred, the forward 8x8 butterflies of its four
// 8x8 blocks (along x, then along y, with the reference's >>1 / >>2: the
// two passes do not commute), quant with the inter offset 342 << (5 + qp/6)
// and the sign kept, dequant rshift_rnd_sf((lev * normAdjust8 * 16) <<
// qp/6, 6), the inverse butterflies (along x, then along y) and the recon
// (rr + (pred << 6) + 32) >> 6 clipped to 0..255; then D_8 and D_4 (the SSD
// of the 8x8 recon and of the 4x4 winner's recon), cb8 (2 bitlen(|l|) + 2
// per nonzero level, 4 per nonzero 8x8 block) and cb4 (`_coef_bits` of
// every 4x4 block of the winner's levels), and the decision with
// `_lam_cost`'s split product.  Exactness: int32 arithmetic with arithmetic
// right shifts on negative intermediates (nvcc's `>>` on int), products
// formed unsigned (common.cuh `mul`, `shl`).  Levels stay below 8192
// (|level| <= 3264: the DC of a +-255 residual at QP 0), where `bitlen`
// equals the reference's float32 form.
//
// Design.  A warp an MB, up to kMaxMbs MBs a block (kernels/t8_geometry.py
// holds the same geometry for the tests and the timing tool).  Lane 8b + r
// holds row r of 8x8 block b: 8 samples of orig, pred and the 4x4 recon
// (two 16-byte loads each), and the 8 contiguous words of the 4x4 levels
// that are half of 4x4 block lane >> 1.  Every butterfly runs whole in one
// lane's registers; between the passes the warp transposes each 8x8 block
// through a padded tile of shared memory (rows of 9 words: no bank
// conflicts either way): rows -> columns for the pass along y, the levels
// back to rows for their stores and dequant, and the same for the inverse.
// The sums are lane partials and warp reductions (__reduce_add_sync), the
// nonzero 8x8 blocks one ballot, and each 4x4 block's count and bits one
// xor shuffle joining its two halves.  Every lane then decides, and writes
// its 8 levels, 8 4x4 levels and 8 recon samples as 16-byte stores.  No
// atomics, no block barrier, no serial thread.
//
// Bound.  Bytes: orig, pred, the 4x4 recon and levels read once; the 8x8
// levels, the 4x4 levels and the recon written once (about 2.85 MB per
// CIF picture), which lead.  Operations: about 37 integer operations a
// sample (the butterflies of two forward and two inverse passes, quant,
// dequant, recon, two SSD terms, the bits).

#include "common.cuh"

namespace {

constexpr int kCSkip = 4, kCP8x8 = 3;  // winner codes (rd_p.C_SKIP, C_P8x8)
constexpr int kMaxMbs = 4;             // warps (MBs) a block at most
constexpr int kSms = 132;              // an H100's SMs
constexpr int kTileRow = 9;            // words a row of a transpose tile
constexpr int kTileBlock = 8 * kTileRow;
constexpr unsigned kFull = 0xffffffffu;

// encoder MF8 (quant) and normAdjust8x8 (dequant) per qp%6 and position
// class (ops/quant.py _M8, _V8)
__constant__ int kM8[6][6] = {
    {13107, 11428, 20972, 12222, 16777, 15481},
    {11916, 10826, 19174, 11058, 14980, 14290},
    {10082, 8943, 15978, 9675, 12710, 11985},
    {9362, 8228, 14913, 8931, 11984, 11259},
    {8192, 7346, 13159, 7740, 10486, 9777},
    {7282, 6428, 11570, 6830, 9118, 8640}};
__constant__ int kV8[6][6] = {
    {20, 18, 32, 19, 25, 24}, {22, 19, 35, 21, 28, 26},
    {26, 23, 42, 24, 33, 31}, {28, 25, 45, 26, 35, 33},
    {32, 28, 51, 30, 40, 38}, {36, 32, 58, 34, 46, 43}};

// position class of (row i, column j) of an 8x8 block (ops/quant.py
// _class8); symmetric in i and j
constexpr int cls8(int i, int j) {
  if ((i & 3) == 0 && (j & 3) == 0) return 0;
  if ((i & 1) && (j & 1)) return 1;
  if ((i & 3) == 2 && (j & 3) == 2) return 2;
  if (((i & 3) == 0 && (j & 1)) || ((i & 1) && (j & 3) == 0)) return 3;
  if (((i & 3) == 0 && (j & 3) == 2) || ((i & 3) == 2 && (j & 3) == 0)) return 4;
  return 5;
}

// the classes of row (or column) r, 3 bits a position
constexpr unsigned cls_word(int r) {
  unsigned w = 0;
  for (int q = 0; q < 8; ++q) w |= (unsigned)cls8(q, r) << (3 * q);
  return w;
}
__constant__ unsigned kClsWord[8] = {cls_word(0), cls_word(1), cls_word(2),
                                     cls_word(3), cls_word(4), cls_word(5),
                                     cls_word(6), cls_word(7)};

// the forward 8-point butterfly in place (ops/transforms.py _fwd8_1d)
__device__ __forceinline__ void fwd8(int* p) {
  const int s0 = p[0] + p[7], s1 = p[1] + p[6], s2 = p[2] + p[5],
            s3 = p[3] + p[4];
  const int b0 = s0 + s3, b1 = s1 + s2, b2 = s0 - s3, b3 = s1 - s2;
  const int d0 = p[0] - p[7], d1 = p[1] - p[6], d2 = p[2] - p[5],
            d3 = p[3] - p[4];
  const int b4 = d1 + d2 + ((d0 >> 1) + d0);
  const int b5 = d0 - d3 - ((d2 >> 1) + d2);
  const int b6 = d0 + d3 - ((d1 >> 1) + d1);
  const int b7 = d1 - d2 + ((d3 >> 1) + d3);
  p[0] = b0 + b1;
  p[1] = b4 + (b7 >> 2);
  p[2] = b2 + (b3 >> 1);
  p[3] = b5 + (b6 >> 2);
  p[4] = b0 - b1;
  p[5] = b6 - (b5 >> 2);
  p[6] = (b2 >> 1) - b3;
  p[7] = (b4 >> 2) - b7;
}

// the inverse 8-point butterfly in place (ops/transforms.py _inv8_1d)
__device__ __forceinline__ void inv8(int* p) {
  const int a0 = p[0] + p[4], a4 = p[0] - p[4];
  const int a2 = (p[2] >> 1) - p[6], a6 = p[2] + (p[6] >> 1);
  const int b0 = a0 + a6, b2 = a4 + a2, b4 = a4 - a2, b6 = a0 - a6;
  const int a1 = -p[3] + p[5] - p[7] - (p[7] >> 1);
  const int a3 = p[1] + p[7] - p[3] - (p[3] >> 1);
  const int a5 = -p[1] + p[7] + p[5] + (p[5] >> 1);
  const int a7 = p[3] + p[5] + p[1] + (p[1] >> 1);
  const int b1 = a1 + (a7 >> 2), b7 = a7 - (a1 >> 2);
  const int b3 = a3 + (a5 >> 2), b5 = (a3 >> 2) - a5;
  p[0] = b0 + b7;
  p[1] = b2 + b5;
  p[2] = b4 + b3;
  p[3] = b6 + b1;
  p[4] = b6 - b1;
  p[5] = b4 - b3;
  p[6] = b2 - b5;
  p[7] = b0 - b7;
}

// Transpose each 8x8 block across its 8 lanes: the lane (block b, index r)
// writes v as row r of the block's tile and reads back column r.  A lane
// that held row r of M then holds column r of M, and the reverse.
__device__ __forceinline__ void transpose8(int* tile, int r, int* v) {
  __syncwarp();  // the tile's last reads are done
#pragma unroll
  for (int c = 0; c < 8; ++c) tile[kTileRow * r + c] = v[c];
  __syncwarp();
#pragma unroll
  for (int q = 0; q < 8; ++q) v[q] = tile[kTileRow * q + r];
}

__device__ __forceinline__ void load8(int* v, const int* src) {
  const int4 a = __ldg(reinterpret_cast<const int4*>(src));
  const int4 b = __ldg(reinterpret_cast<const int4*>(src) + 1);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

__device__ __forceinline__ void store8(int* dst, const int* v) {
  reinterpret_cast<int4*>(dst)[0] = make_int4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<int4*>(dst)[1] = make_int4(v[4], v[5], v[6], v[7]);
}

__global__ void __launch_bounds__(32 * kMaxMbs)
t8_kernel(const int* __restrict__ orig, const int* __restrict__ pred,
          const int* __restrict__ rec4, const int* __restrict__ lev4,
          const int* __restrict__ win, const int* __restrict__ sub,
          const unsigned char* __restrict__ intra, int n_mb, int qp, int lam,
          int* __restrict__ t8_out, int* __restrict__ lev8_out,
          int* __restrict__ lev4_out, int* __restrict__ rec_out) {
  __shared__ int tiles[kMaxMbs][4 * kTileBlock];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int mb = blockIdx.x * (blockDim.x >> 5) + warp;
  if (mb >= n_mb) return;  // the whole warp: no block barrier follows
  const int b = lane >> 3, r = lane & 7;
  const size_t base = (size_t)mb * 256;
  const int ras = 16 * (8 * (b >> 1) + r) + 8 * (b & 1);  // the lane's row
  const int lw = 8 * lane;  // its level words
  int* tile = tiles[warp] + kTileBlock * b;

  int o[8], p[8], q4[8], l4[8];
  load8(o, orig + base + ras);
  load8(p, pred + base + ras);
  load8(q4, rec4 + base + ras);
  load8(l4, lev4 + base + lw);
  const int w = __ldg(win + mb);
  const bool eligible = __ldg(intra + mb) == 0 && w != kCSkip;
  const int4 su = __ldg(reinterpret_cast<const int4*>(sub) + mb);

  // lane k < 6 keeps class k's quant and dequant factors; a coefficient
  // takes its class's by a shuffle
  const int per = qp / 6, rem = qp % 6, off = 342 << (5 + per);
  const int mf = kM8[rem][lane < 6 ? lane : 0];
  const int ils = kV8[rem][lane < 6 ? lane : 0] * 16;
  const unsigned cw = kClsWord[r];  // class of (q, r) = class of (r, q)

  int v[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) v[c] = o[c] - p[c];
  fwd8(v);                // along x: row r
  transpose8(tile, r, v);
  fwd8(v);                // along y: v[q] is coefficient (q, r)
  int lev[8];
#pragma unroll
  for (int q = 0; q < 8; ++q)
    lev[q] = quant(v[q], __shfl_sync(kFull, mf, (cw >> (3 * q)) & 7), off,
                   16 + per);
  transpose8(tile, r, lev);  // lev[c] is level (r, c)
#pragma unroll
  for (int c = 0; c < 8; ++c)
    v[c] = (shl(mul(lev[c], __shfl_sync(kFull, ils, (cw >> (3 * c)) & 7)),
                per) + 32) >> 6;
  inv8(v);                // along x: row r
  transpose8(tile, r, v);
  inv8(v);                // along y: v[q] is residual (q, r)
  transpose8(tile, r, v);  // v[c] is residual (r, c)

  int r8[8], d8 = 0, d4 = 0, cb8 = 0, lb = 0, n4 = 0;
  bool nz = false;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    r8[c] = clip255((v[c] + shl(p[c], 6) + 32) >> 6);
    const int e8 = o[c] - r8[c], e4 = o[c] - q4[c];
    d8 += e8 * e8;
    d4 += e4 * e4;
    const int a = abs(lev[c]), a4 = abs(l4[c]);
    if (a) {
      cb8 += 2 * bitlen(a) + 2;
      nz = true;
    }
    if (a4) {
      lb += 2 * bitlen(a4) + 1;
      ++n4;
    }
  }
  // the 4x4 block lane >> 1: its two halves joined, counted by its even lane
  lb += __shfl_xor_sync(kFull, lb, 1);
  n4 += __shfl_xor_sync(kFull, n4, 1);
  const int cb4 = __reduce_add_sync(kFull, (r & 1) == 0 && n4 > 0
                                               ? lb + n4 + 2 : 0);
  const unsigned nzm = __ballot_sync(kFull, nz);
  int nzb = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) nzb += ((nzm >> (8 * k)) & 0xffu) != 0;
  d8 = __reduce_add_sync(kFull, d8);
  d4 = __reduce_add_sync(kFull, d4);
  cb8 = __reduce_add_sync(kFull, cb8) + 4 * nzb;
  const bool ok = eligible && (w != kCP8x8 || (su.x == 0 && su.y == 0 &&
                                               su.z == 0 && su.w == 0));
  const bool use =
      ok && d8 + lam_cost(lam, cb8 + 1) < d4 + lam_cost(lam, cb4 + 1);
  if (lane == 0) t8_out[mb] = use;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    lev[c] = use ? lev[c] : 0;
    l4[c] = use ? 0 : l4[c];
    r8[c] = use ? r8[c] : q4[c];
  }
  store8(lev8_out + base + lw, lev);
  store8(lev4_out + base + lw, l4);
  store8(rec_out + base + ras, r8);
}

}  // namespace

// orig, pred, rec4 (n_mb, 16, 16), lev4 (n_mb, 4, 4, 4, 4), win (n_mb,), sub
// (n_mb, 4) int32, 16-byte aligned; intra (n_mb,) one byte each; t8 (n_mb,),
// lev8 (n_mb, 2, 2, 8, 8), lev4_out, rec_out int32.  Returns the CUDA error
// of the launch.
extern "C" int t8_decide(const int* orig, const int* pred, const int* rec4,
                         const int* lev4, const int* win, const int* sub,
                         const unsigned char* intra, int n_mb, int qp, int lam,
                         int* t8, int* lev8, int* lev4_out, int* rec_out,
                         void* stream) {
  if (n_mb <= 0) return 0;
  // as many MBs a block (1 to kMaxMbs) as leave a block for each SM
  const int per = max(1, min(kMaxMbs, n_mb / kSms));
  t8_kernel<<<(n_mb + per - 1) / per, 32 * per, 0, (cudaStream_t)stream>>>(
      orig, pred, rec4, lev4, win, sub, intra, n_mb, qp, lam, t8, lev8,
      lev4_out, rec_out);
  return (int)cudaGetLastError();
}
