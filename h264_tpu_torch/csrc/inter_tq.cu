// K5: residual coding of a P picture's candidates, for Hopper (sm_90a).
//
// Replaces, in h264_tpu/encoder/rd.py (`rd_p_pipeline`):
//   inter_luma_tq    `tq_recon` (rd.py:879-895) over the six candidate
//                    predictions: forward 4x4, quant with the inter offset,
//                    `_rdoq4` (:228), dequant / inverse / recon, then
//                    `_threshold_inter_luma` (:287: JM coeff_cost over the
//                    zig-zag, 8x8 drop at <= 4, MB drop at <= 5, dropped
//                    blocks reconstructed as the clipped prediction), and
//                    SSD and `_coef_bits` per 8x8 unit;
//   inter_chroma_tq  `_chroma_tq(intra=False, lam)` (:1267, used at :1060):
//                    inter offsets, RDOQ-lite on the AC, the JM chroma AC
//                    drop at coeff_cost < 4, truncating DC dequant;
//   i16_candidate    the I16 candidate from ORIGINAL neighbours
//                    (`_i16_pred_all` + `_i16_tq`, :984-998): the function
//                    of the intra commit's `i16_code` (common.cuh), in
//                    this file's lane form.
// Plain versions: h264_tpu_torch/encoder/rd_p.py `inter_luma_tq_plain`,
// `inter_chroma_tq_plain`, `i16_candidate_plain`; wrapper kernels/inter_tq.py.
//
// Exactness.  `_rdoq4` is float32: dD = ((d * d) * n2) - (((8 * d) * F64)
// * ss), dJ = dD + float(lam) * float(bits_m - bits), one rounding per
// operation.  Every product and sum is written with __fmul_rn / __fadd_rn
// / __fsub_rn, which nvcc never contracts into an FMA.  Integer parts as
// in the intra commit: wrapping products, arithmetic shifts.
//
// Design.  inter_luma_tq: a warp per (candidate, MB) problem, eight a
// block of 256 threads; lane 2 blk + h holds rows 2h and 2h + 1 of 4x4
// block blk (below, before luma_kernel).  inter_chroma_tq: the same lane
// form, 16 lanes per MB (2 planes x 4 blocks x 2 lanes), two MBs a warp,
// as many warps a block (up to 4) as leave a block for each of the 132
// SMs (CIF's 396 MBs: 198 blocks of one warp; 1280x720: 450 of four).
// i16_candidate: the same lane form, a warp an MB, as many MBs a block
// from 2 up to 4 as leave a block for each SM (CIF: 132 blocks of 3;
// 1280x720: 900 of 4; a trial of 2 to 8 found CIF flat and 1280x720
// slower at 6 and 8).
//
// What held inter_luma_tq and inter_chroma_tq back, and what this design
// does about it.  Their first versions gave each thread a whole 4x4 block
// in 16-int arrays (pb, res, c, lev and the RDOQ's deq, levm, e): 128
// registers and a 64-byte stack frame; coeff_cost indexed a level array
// by a table value, so that array lived in local memory; the RDOQ's
// dequant, inverse and forward transform ran serially in one thread;
// every load and store was a 4-byte access at a 16-int (chroma: 8-int)
// stride; and chroma's 2x2 DC transform and AC drop went through shared
// memory between two barriers, eight threads an MB in blocks of 64, so
// that a CIF picture made 50 blocks for 132 SMs.  Here two lanes share a
// block, eight coefficients each in statically indexed registers (luma 48
// registers, no stack frame, 5 blocks of 256 threads an SM: 62.5 %
// occupancy); a column pass costs each lane two shuffles a column;
// coeff_cost is bit arithmetic on the block's zig-zag masks (chroma's
// from position 1; a chroma warp whose levels are all zero skips the
// RDOQ, which only lowers nonzero levels); luma's 8x8 and MB thresholds,
// SSD and bits, and chroma's DC Hadamard pair (quant, then its inverse
// and the truncating dequant) and plane cost sum, are xor shuffles within
// the warp, with no shared memory or barrier; and each lane loads its
// rows of pred and orig and stores its rows of rec and lev as 16-byte
// vectors.  Two lanes a
// block rather than four: a luma problem then fits one warp, and a lane's
// rows keep their parity, so every quant, dequant and RDOQ constant of a
// position is static and only the zig-zag index depends on the lane
// (tests/test_torch_search_tq.py and tests/test_torch_direct_chroma.py
// hold this lane-by-lane form against the plain versions).
//
// What held i16_candidate back, and what this design does about it.
// Its first kernel ran the intra commit's `i16_code` on 64 threads an MB
// (396 two-warp blocks at CIF, about 6 warps an SM) over the source
// staged as int32 in shared memory, through five barriers between serial
// phases: 4 threads summed the mode costs, one thread ran the DC
// Hadamard, its 16 quantizations, their bits, the inverse and the
// dequant, 16 threads each coded a whole 4x4 block in int[16] arrays, and
// thread 0 then summed the 16 SSDs and bit counts (2.0x an empty launch
// of its grid at CIF, 0.0232 ms at 1280x720 on an NVIDIA H100 80GB HBM3
// at 700.00 W; PERF.md).  Here every phase
// runs on all 32 lanes: a lane's two rows come in by 16-byte loads and
// the neighbours by the lanes that hold them; the DC value and PLANE
// parameters are warp sums; each mode's cost is the lane pair's Hadamard
// (one shuffle a column) and the 16 DC terms' Hadamard by four xor
// butterflies (hadamard_dc), summed over the warp by redux.sync, an
// unavailable mode priced from its zero neighbours so that no shuffle
// sits behind a branch; the DC's quant, bits and inverse run on the DC
// lanes by the same butterflies, the AC and recon in the lanes; the recon
// leaves as 16-byte stores, D16 and cb16 as warp sums one lane writes.
// No shared memory, no barrier, no per-thread array in local memory.
//
// Bound.  Bytes: pred and orig read, lev, rec, D8 and cb8 written once
// (7.8 MB for a CIF P picture's six candidates, 0.0023 ms at 3.35 TB/s;
// chroma 0.82 MB, 0.00025 ms).  Operations, by chip_smoke.py's rule
// (OPS_INTER_LUMA, FOPS_INTER_TQ): 58.5 integer operations per
// coefficient for transform, quant, RDOQ (a second inverse and forward
// transform), coeff_cost and recon, the residual and its forward
// transform in 16-bit pairs, and 12 float32 ones for RDOQ's cost on the
// FP32 pipe; below the bytes at every size.  A chroma call is far below a
// launch: its device time is the launch and one pass of dependent
// arithmetic.  i16_candidate: the source read once, the recon and two
// ints an MB written (0.81 MB at CIF); by OPS_SATD_16 and OPS_TQ the four
// Hadamard costs in 16-bit pairs and the coding, 4.36 M operations at CIF
// (0.00026 ms), 0.0024 ms at 1280x720.  That count is a bound, not a
// design: packed 16-bit SIMD is emulated on sm_90a, and a DC Hadamard
// term reaches 16 x 16 x 255 = 65280, past int16, so the sums run in
// 32-bit lanes; the device time is the launch and one pass of dependent
// shuffles (PERF.md).
//
// ptxas (sm_90a, nvcc -O3): luma_kernel 48 registers, i16_kernel 48
// registers, no stack frame, no shared memory; no spills; chroma_kernel:
// see PERF.md §6 (the build's report, printed by chip_smoke.py and
// tools/time_kernels.py).

#include <algorithm>

#include "common.cuh"
#include "tq_lanes.cuh"

namespace {

__device__ __forceinline__ int rdoq_bits(int a) {
  return a > 0 ? 2 * bitlen(a) + 2 : 0;
}

// ---------------------------------------------------------------------------
// inter_luma_tq: a warp per (candidate, MB), two lanes per 4x4 block
// ---------------------------------------------------------------------------
// Lane 2 blk + h of a warp holds rows 2h and 2h + 1 of block blk = 4 br +
// bc in registers, in the lane form of tq_lanes.cuh; the RDOQ constants of
// a position are static too, and only the zig-zag position depends on h.
// Lane bits:
// 0 h, 1-2 bc, 3-4 br, so an 8x8 unit's blocks differ in bits 1 and 3 and
// the MB's units in bits 2 and 4.
constexpr int kLumaWarps = 8;  // problems a block

// zig-zag index of raster position k = 4 y + x (inverse of the 4x4
// zig-zag scan), nibble k
constexpr unsigned long long kZzOf = 0xFEA9DB83C7426510ULL;
__device__ __forceinline__ constexpr int zz_of(int k) {
  return (int)((kZzOf >> (4 * k)) & 15);
}

// JM coeff_cost from the block's nonzero mask M and |level| > 1 mask B in
// zig-zag order (no bit below `first`), scanned from position `first`: a
// nonzero at z after a run of r zeros costs JM's COEFF_COST4x4[r] = [r <
// 1] + [r < 3] + [r < 6] (9 when |level| > 1).  r < k exactly when a
// nonzero, or the scan's start (bit `first` of E, position first - 1),
// lies within k positions before z.
__device__ __forceinline__ int coeff_cost_mask(unsigned M, unsigned B,
                                               int first = 0) {
  const unsigned E = (M << 1) | (1u << first), S = (M & ~B) << 1;
  const unsigned n1 = E << 1, n3 = n1 | (n1 << 1) | (n1 << 2),
                 n6 = n3 | (n3 << 3);
  return 9 * __popc(B) + __popc(S & n1) + __popc(S & n3) + __popc(S & n6);
}

__global__ void __launch_bounds__(32 * kLumaWarps)
luma_kernel(const int* __restrict__ pred, const int* __restrict__ orig,
            int n_prob, int n_mb, int qp, int lam, int* __restrict__ out_lev,
            int* __restrict__ out_rec, int* __restrict__ out_d8,
            int* __restrict__ out_cb8) {
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * kLumaWarps + (threadIdx.x >> 5);
  if (p >= n_prob) return;  // the whole warp
  const int h = lane & 1, blk = lane >> 1, br = blk >> 2, bc = blk & 3;
  const int per = qp / 6, rem = qp % 6, off = 342 << (4 + per),
            qbits = 15 + per;
  const float lam32 = (float)lam;
  int mf[3], vs[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    mf[c] = kM4[rem][c];
    vs[c] = kV4[rem][c] * 16;
  }
  // the lane's two rows: pixel (4 br + 2 h + j, 4 bc + x)
  const size_t px = (size_t)16 * (4 * br + 2 * h) + 4 * bc;
  const int4* pp = reinterpret_cast<const int4*>(pred + (size_t)p * 256 + px);
  const int4* op =
      reinterpret_cast<const int4*>(orig + (size_t)(p % n_mb) * 256 + px);
  int res[2][4], c[2][4], lev[2][4];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int4 P = __ldg(pp + 4 * j), O = __ldg(op + 4 * j);
    res[j][0] = O.x - P.x;
    res[j][1] = O.y - P.y;
    res[j][2] = O.z - P.z;
    res[j][3] = O.w - P.w;
#pragma unroll
    for (int x = 0; x < 4; ++x) c[j][x] = res[j][x];
    fwd_row(c[j]);
  }
  fwd_cols(c[0], c[1], h);
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int x = 0; x < 4; ++x)
      lev[j][x] = quant(c[j][x], mf[cls_of(j, x)], off, qbits);

  // RDOQ-lite (rd.py `_rdoq4`): F = forward4x4((res << 6) - inverse4x4(deq))
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int x = 0; x < 4; ++x)
      c[j][x] = (shl(mul(lev[j][x], vs[cls_of(j, x)]), per) + 8) >> 4;
    inv_row(c[j]);
  }
  inv_cols(c[0], c[1], h);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int x = 0; x < 4; ++x) c[j][x] = shl(res[j][x], 6) - c[j][x];
    fwd_row(c[j]);
  }
  fwd_cols(c[0], c[1], h);
  unsigned nzm = 0, bigm = 0;  // zig-zag masks of the lane's coefficients
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int l = lev[j][x], v = vs[cls_of(j, x)];
      const int lm = l > 0 ? l - 1 : l < 0 ? l + 1 : 0;
      const int deq = (shl(mul(l, v), per) + 8) >> 4;
      const float delta = (float)(((shl(mul(lm, v), per) + 8) >> 4) - deq);
      const float n2 = (j ? 10.f : 16.f) * ((x & 1) ? 10.f : 16.f);
      const float ss = (j ? 1.f : 2.f) * ((x & 1) ? 1.f : 2.f);
      const float dD = __fsub_rn(
          __fmul_rn(__fmul_rn(delta, delta), n2),
          __fmul_rn(__fmul_rn(__fmul_rn(8.0f, delta), (float)c[j][x]), ss));
      const int a = abs(l);
      const float dJ = __fadd_rn(
          dD, __fmul_rn(lam32, (float)(rdoq_bits(abs(lm)) - rdoq_bits(a))));
      const int nl = a > 0 && dJ < 0.0f ? lm : l;
      lev[j][x] = nl;
      const unsigned bit = 1u << (h ? zz_of(8 + 4 * j + x) : zz_of(4 * j + x));
      if (nl != 0) nzm |= bit;
      if (abs(nl) > 1) bigm |= bit;
    }
  nzm |= __shfl_xor_sync(kFull, nzm, 1);
  bigm |= __shfl_xor_sync(kFull, bigm, 1);

  // JM thresholding: an 8x8 drops at coeff_cost <= 4, then the MB when the
  // kept total is <= 5
  const int cost = coeff_cost_mask(nzm, bigm);
  int c8 = cost + __shfl_xor_sync(kFull, cost, 2);
  c8 += __shfl_xor_sync(kFull, c8, 8);
  int tot = c8 <= 4 ? 0 : c8;
  tot += __shfl_xor_sync(kFull, tot, 4);
  tot += __shfl_xor_sync(kFull, tot, 16);
  const bool drop = c8 <= 4 || tot <= 5;

  int lb = 0, nn = 0;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      if (drop) lev[j][x] = 0;
      const int a = abs(lev[j][x]);
      if (a > 0) {
        lb += 2 * bitlen(a) + 1;
        ++nn;
      }
      c[j][x] = (shl(mul(lev[j][x], vs[cls_of(j, x)]), per) + 8) >> 4;
    }
    inv_row(c[j]);
  }
  inv_cols(c[0], c[1], h);
  int4* rp = reinterpret_cast<int4*>(out_rec + (size_t)p * 256 + px);
  int4* lp = reinterpret_cast<int4*>(out_lev +
                                     ((size_t)p * 16 + blk) * 16 + 8 * h);
  int ssd = 0;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int4 P = __ldg(pp + 4 * j);
    const int pb[4] = {P.x, P.y, P.z, P.w};
    int rec[4];
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      rec[x] = drop ? clip255(pb[x])
                    : clip255((c[j][x] + shl(pb[x], 6) + 32) >> 6);
      const int d = pb[x] + res[j][x] - rec[x];
      ssd += d * d;
    }
    rp[4 * j] = make_int4(rec[0], rec[1], rec[2], rec[3]);
    lp[j] = make_int4(lev[j][0], lev[j][1], lev[j][2], lev[j][3]);
  }
  // per 8x8 unit: SSD over its 8 lanes, coefficient bits over its blocks
  lb += __shfl_xor_sync(kFull, lb, 1);
  nn += __shfl_xor_sync(kFull, nn, 1);
  int cb = nn > 0 ? lb + nn + 2 : 0;
  ssd += __shfl_xor_sync(kFull, ssd, 1);
#pragma unroll
  for (int off8 = 2; off8 <= 8; off8 *= 4) {
    ssd += __shfl_xor_sync(kFull, ssd, off8);
    cb += __shfl_xor_sync(kFull, cb, off8);
  }
  if ((lane & 0b01011) == 0) {
    const int b8 = 2 * (lane >> 4) + ((lane >> 2) & 1);
    out_d8[(size_t)p * 4 + b8] = ssd;
    out_cb8[(size_t)p * 4 + b8] = cb;
  }
}

// ---------------------------------------------------------------------------
// inter_chroma_tq: 16 lanes per MB, two lanes per 4x4 block
// ---------------------------------------------------------------------------
// Lane bits: 0 h, 1-2 the block cb = 2 cby + cbx of the plane, 3 the plane,
// 4 the MB of the warp.  As in luma_kernel, lane h holds rows 2h and 2h + 1
// of its block.  The plane's 2x2 DC Hadamard runs on the blocks' DC lanes
// (h = 0) by xor shuffles over bits 1 and 2, which leave each lane with
// its own block's entry; so do the cost sum of JM's AC drop.
constexpr int kChromaWarps = 4;  // warps (two MBs each) a block, at most
constexpr int kSMs = 132;        // an H100's SMs

__global__ void __launch_bounds__(32 * kChromaWarps)
chroma_kernel(const int* __restrict__ pred, const int* __restrict__ orig,
              int n_mb, int qp_c, int lam, int* __restrict__ out_lev,
              int* __restrict__ out_dc, int* __restrict__ out_rec) {
  const int lane = threadIdx.x & 31;
  const int h = lane & 1, cb = (lane >> 1) & 3, pl = (lane >> 3) & 1;
  const int mb_at =
      2 * (blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5)) + (lane >> 4);
  // a half warp past the last MB codes the last MB again, unstored: the
  // shuffles need every lane
  const bool live = mb_at < n_mb;
  const int mb = live ? mb_at : n_mb - 1;
  const int per = qp_c / 6, rem = qp_c % 6, off = 342 << (4 + per),
            qbits = 15 + per;
  const float lam32 = (float)lam;
  int mf[3], vs[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    mf[k] = kM4[rem][k];
    vs[k] = kV4[rem][k] * 16;
  }
  // the lane's two rows: sample (4 cby + 2 h + j, 4 cbx + x) of its plane
  const size_t px = ((size_t)mb * 2 + pl) * 64 + 8 * (4 * (cb >> 1) + 2 * h)
                    + 4 * (cb & 1);
  const int4* pp = reinterpret_cast<const int4*>(pred + px);
  const int4* op = reinterpret_cast<const int4*>(orig + px);
  int res[2][4], c[2][4], lev[2][4];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int4 P = __ldg(pp + 2 * j), O = __ldg(op + 2 * j);
    res[j][0] = O.x - P.x;
    res[j][1] = O.y - P.y;
    res[j][2] = O.z - P.z;
    res[j][3] = O.w - P.w;
#pragma unroll
    for (int x = 0; x < 4; ++x) c[j][x] = res[j][x];
    fwd_row(c[j]);
  }
  fwd_cols(c[0], c[1], h);

  // the DC: 2x2 Hadamard of the plane's four DCs, quant (twice the offset,
  // shift 16 + per), its own Hadamard and the truncating dequant
  const int dl = quant(hadamard_blocks(c[0][0], cb), mf[0], 2 * off,
                       16 + per);
  if (live && h == 0) out_dc[((size_t)mb * 2 + pl) * 4 + cb] = dl;
  const int dg = mul(hadamard_blocks(dl, cb), vs[0]);
  const int dc_deq = per < 5 ? dg >> (5 - per) : shl(dg, per - 5);

  // the AC with the DC slot zero, then RDOQ-lite (rd.py `_rdoq4`) as in
  // luma_kernel; it only lowers nonzero levels, so a warp whose levels are
  // all zero skips it
  bool nonzero = false;
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      lev[j][x] = h == 0 && j == 0 && x == 0
                      ? 0
                      : quant(c[j][x], mf[cls_of(j, x)], off, qbits);
      nonzero |= lev[j][x] != 0;
    }
  if (__any_sync(kFull, nonzero)) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int x = 0; x < 4; ++x)
        c[j][x] = (shl(mul(lev[j][x], vs[cls_of(j, x)]), per) + 8) >> 4;
      inv_row(c[j]);
    }
    inv_cols(c[0], c[1], h);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int x = 0; x < 4; ++x) c[j][x] = shl(res[j][x], 6) - c[j][x];
      fwd_row(c[j]);
    }
    fwd_cols(c[0], c[1], h);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int l = lev[j][x], v = vs[cls_of(j, x)];
        const int lm = l > 0 ? l - 1 : l < 0 ? l + 1 : 0;
        const int deq = (shl(mul(l, v), per) + 8) >> 4;
        const float delta =
            (float)(((shl(mul(lm, v), per) + 8) >> 4) - deq);
        const float n2 = (j ? 10.f : 16.f) * ((x & 1) ? 10.f : 16.f);
        const float ss = (j ? 1.f : 2.f) * ((x & 1) ? 1.f : 2.f);
        const float dD = __fsub_rn(
            __fmul_rn(__fmul_rn(delta, delta), n2),
            __fmul_rn(__fmul_rn(__fmul_rn(8.0f, delta), (float)c[j][x]), ss));
        const int a = abs(l);
        const float dJ = __fadd_rn(
            dD, __fmul_rn(lam32, (float)(rdoq_bits(abs(lm)) - rdoq_bits(a))));
        if (a > 0 && dJ < 0.0f) lev[j][x] = lm;
      }
  }
  unsigned nzm = 0, bigm = 0;  // zig-zag masks of the lane's coefficients
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const unsigned bit = 1u << (h ? zz_of(8 + 4 * j + x) : zz_of(4 * j + x));
      if (lev[j][x] != 0) nzm |= bit;
      if (abs(lev[j][x]) > 1) bigm |= bit;
    }
  nzm |= __shfl_xor_sync(kFull, nzm, 1);
  bigm |= __shfl_xor_sync(kFull, bigm, 1);

  // JM's chroma AC drop: the plane's four AC costs (from zig-zag position
  // 1) summed below 4
  int tot = coeff_cost_mask(nzm, bigm, 1);
  tot += __shfl_xor_sync(kFull, tot, 2);
  tot += __shfl_xor_sync(kFull, tot, 4);
  const bool drop = tot < 4;

#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      if (drop) lev[j][x] = 0;
      c[j][x] = h == 0 && j == 0 && x == 0
                    ? dc_deq
                    : (shl(mul(lev[j][x], vs[cls_of(j, x)]), per) + 8) >> 4;
    }
    inv_row(c[j]);
  }
  inv_cols(c[0], c[1], h);
  if (!live) return;
  int4* rp = reinterpret_cast<int4*>(out_rec + px);
  int4* lp = reinterpret_cast<int4*>(
      out_lev + (((size_t)mb * 2 + pl) * 4 + cb) * 16 + 8 * h);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int4 P = __ldg(pp + 2 * j);
    const int pb[4] = {P.x, P.y, P.z, P.w};
    int rec[4];
#pragma unroll
    for (int x = 0; x < 4; ++x)
      rec[x] = clip255((c[j][x] + shl(pb[x], 6) + 32) >> 6);
    rp[2 * j] = make_int4(rec[0], rec[1], rec[2], rec[3]);
    lp[j] = make_int4(lev[j][0], lev[j][1], lev[j][2], lev[j][3]);
  }
}

// ---------------------------------------------------------------------------
// i16_candidate: a warp per MB, two lanes per 4x4 block
// ---------------------------------------------------------------------------
// Lane bits as in luma_kernel: 0 h, 1-2 bc, 3-4 br; lane 2 blk + h holds
// rows 2h and 2h + 1 of block blk = 4 br + bc.  The 16 blocks' DC terms
// (each on its h = 0 lane) are a 4 x 4 array over lane bits 1-4, whose
// Hadamard is four xor-shuffle butterflies (hadamard_dc).
constexpr int kI16MaxWarps = 4;  // MBs a block, at most

// one row of hadamard4x4 (common.cuh)
__device__ __forceinline__ void had_row(int (&v)[4]) {
  const int e0 = v[0] + v[2], e1 = v[0] - v[2], e2 = v[1] - v[3],
            e3 = v[1] + v[3];
  v[0] = e0 + e3;
  v[1] = e1 + e2;
  v[2] = e1 - e2;
  v[3] = e0 - e3;
}

// column pass of hadamard4x4: with rows w0..w3 and s = (first + second),
// t = (first - second) of a lane's two rows, h = 0 keeps (w0 + w1) +- (w2
// + w3), h = 1 keeps (w0 - w1) -+ (w2 - w3): one shuffle a column
__device__ __forceinline__ void had_cols(int (&r0)[4], int (&r1)[4], int h) {
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const int s = r0[x] + r1[x], t = r0[x] - r1[x];
    const int p = __shfl_xor_sync(kFull, h ? s : t, 1);
    r0[x] = h ? p - t : s + p;
    r1[x] = h ? p + t : s - p;
  }
}

// The 4 x 4 Hadamard of the values of the lanes that differ in bits 1-4,
// in natural (Walsh) order: entry (u, v) to the lanes of block 4 u + v.
// Its outputs are hadamard4x4's permuted in rows and columns alike, so a
// sum of absolute values, an elementwise quant and a bit count over them
// are the same; and the natural transform of the quantized natural
// outputs is hadamard4x4 of the quantized hadamard4x4 outputs entry for
// entry (hadamard4x4's rows are the natural rows 0, 2, 3, 1, and its
// columns, permuted the same way, are the natural rows again).
__device__ __forceinline__ int hadamard_dc(int v, int lane) {
#pragma unroll
  for (int b = 2; b <= 16; b <<= 1) {
    const int p = __shfl_xor_sync(kFull, v, b);
    v = (lane & b) ? p - v : v + p;
  }
  return v;
}

// The I16 candidate of one MB a warp, from original neighbours (zero
// outside the picture): the Hadamard mode pick (first minimum of VERT,
// HOR, DC, PLANE; unavailable modes cost kBig), then the chosen mode's
// transform, DC Hadamard and quant, AC quant, dequant, inverse and recon
// (common.cuh i16_code, which the intra commit keeps).  Writes the recon,
// the MB's SSD and its coefficient bits (the DC levels' and the 16
// blocks').
__global__ void __launch_bounds__(32 * kI16MaxWarps)
i16_kernel(const int* __restrict__ cur_y, int W, int n_mx, int n_mb, int qp,
           int* __restrict__ out_rec, int* __restrict__ out_d,
           int* __restrict__ out_cb) {
  const int lane = threadIdx.x & 31;
  const int mb = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (mb >= n_mb) return;  // the whole warp
  const int h = lane & 1, br = lane >> 3, bc = (lane >> 1) & 3;
  const int r = mb / n_mx, c = mb - r * n_mx;
  const bool au = r > 0, al = c > 0;
  // the lane's rows Y = 4 br + 2 h + j, columns X = 4 bc + x
  const int Y0 = 4 * br + 2 * h, X0 = 4 * bc;
  const int* src = cur_y + (16 * r + Y0) * W + 16 * c + X0;
  int o[2][4], up[4] = {0, 0, 0, 0}, lf[2] = {0, 0};
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(src + j * W));
    o[j][0] = v.x;
    o[j][1] = v.y;
    o[j][2] = v.z;
    o[j][3] = v.w;
    if (al) lf[j] = __ldg(src + j * W - X0 - 1);
  }
  if (au) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(src - (Y0 + 1) * W));
    up[0] = v.x;
    up[1] = v.y;
    up[2] = v.z;
    up[3] = v.w;
  }
  const int ul = au && al && lane == 0 ? __ldg(src - W - 1) : 0;
  // DC and PLANE parameters (rd.py `_i16_pred_all`) by warp sums: the up
  // row from lanes 0, 2, 4, 6 (br = h = 0), the left column from the
  // lanes with bc = 0; H = sum (k - 7) up[k] - 8 ul, V likewise
  int su = 0, sl = 0, hg = -8 * ul, vg = -8 * ul;
  if ((lane & 0b11001) == 0) {
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      su += up[x];
      hg += (X0 + x - 7) * up[x];
    }
  }
  if ((lane & 0b00110) == 0) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      sl += lf[j];
      vg += (Y0 + j - 7) * lf[j];
    }
  }
  // up[15] on lane 6, left[15] on lane 25
  const int corner = lane == 6 ? up[3] : lane == 25 ? lf[1] : 0;
  su = __reduce_add_sync(kFull, su);
  sl = __reduce_add_sync(kFull, sl);
  hg = __reduce_add_sync(kFull, hg);
  vg = __reduce_add_sync(kFull, vg);
  const int pa = 16 * __reduce_add_sync(kFull, corner);
  const int pb = (5 * hg + 32) >> 6, pc = (5 * vg + 32) >> 6;
  const int dc = au && al ? (su + sl + 16) >> 5
                 : au     ? (su + 8) >> 4
                 : al     ? (sl + 8) >> 4
                          : 128;
  // prediction sample (Y0 + j, X0 + x) of mode m [VERT, HOR, DC, PLANE]
  auto pred = [&](int m, int j, int x) {
    return m == 0   ? up[x]
           : m == 1 ? lf[j]
           : m == 2 ? dc
                    : clip255((pa + pb * (X0 + x - 7) + pc * (Y0 + j - 7) +
                               16) >> 5);
  };

  // mode pick: (sum over blocks of the AC absolute sums + the absolute
  // sum of the DC terms' Hadamard) >> 1 (JM find_sad_16x16); an
  // unavailable mode is priced from its zero neighbours and costs kBig,
  // so that the warp never branches around its shuffles
  int cost[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const bool valid = m == 0 ? au : m == 1 ? al : m == 2 ? true : au && al;
    int d[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int x = 0; x < 4; ++x) d[j][x] = o[j][x] - pred(m, j, x);
      had_row(d[j]);
    }
    had_cols(d[0], d[1], h);
    int s = 0;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int x = 0; x < 4; ++x) s += abs(d[j][x]);
    // the DC term d[0][0] of lane h = 0 leaves the AC sum for the DC's own
    const int hd = hadamard_dc(d[0][0], lane);
    s += h ? 0 : abs(hd) - abs(d[0][0]);
    s = __reduce_add_sync(kFull, s) >> 1;
    cost[m] = valid ? s : kBig;
  }
  int mode = 0, best = cost[0];
#pragma unroll
  for (int m = 1; m < 4; ++m)
    if (cost[m] < best) {
      best = cost[m];
      mode = m;
    }

  // coding of the chosen mode (rd.py `_i16_tq`)
  const int per = qp / 6, rem = qp % 6, off = 682 << (4 + per),
            qbits = 15 + per;
  int pr[2][4], co[2][4];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      pr[j][x] = pred(mode, j, x);
      co[j][x] = o[j][x] - pr[j][x];
    }
    fwd_row(co[j]);
  }
  fwd_cols(co[0], co[1], h);
  // the DC: Hadamard >> 1, quant (twice the offset, shift 16 + per), the
  // levels' bits, the Hadamard of the levels and its dequant; valid on
  // the h = 0 lanes
  const int dl = quant(hadamard_dc(co[0][0], lane) >> 1, kM4[rem][0], 2 * off,
                       16 + per);
  const int dla = h ? 0 : abs(dl);
  const int dbits = __reduce_add_sync(
      kFull, dla ? (2 * bitlen(dla) + 1) | 1 << 16 : 0);
  const int cbdc = dbits ? (dbits & 0xffff) + (dbits >> 16) + 2 : 0;
  const int dc_deq =
      (shl(mul(hadamard_dc(dl, lane), kV4[rem][0] * 16), per) + 32) >> 6;

  // the AC (the DC slot level 0): quant, bits, dequant, inverse
  int lb = 0, nn = 0;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int k = cls_of(j, x);
      const bool is_dc = h == 0 && j == 0 && x == 0;
      const int l = is_dc ? 0 : quant(co[j][x], kM4[rem][k], off, qbits);
      const int a = abs(l);
      if (a > 0) {
        lb += 2 * bitlen(a) + 1;
        ++nn;
      }
      co[j][x] = is_dc ? dc_deq
                       : (shl(mul(l, kV4[rem][k] * 16), per) + 8) >> 4;
    }
    inv_row(co[j]);
  }
  inv_cols(co[0], co[1], h);
  lb += __shfl_xor_sync(kFull, lb, 1);
  nn += __shfl_xor_sync(kFull, nn, 1);
  int4* rp = reinterpret_cast<int4*>(out_rec + (size_t)mb * 256 + 16 * Y0 +
                                     X0);
  int ssd = 0;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    int rec[4];
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      rec[x] = clip255((co[j][x] + shl(pr[j][x], 6) + 32) >> 6);
      const int e = o[j][x] - rec[x];
      ssd += e * e;
    }
    rp[4 * j] = make_int4(rec[0], rec[1], rec[2], rec[3]);
  }
  ssd = __reduce_add_sync(kFull, ssd);
  const int cb = __reduce_add_sync(kFull, h == 0 && nn > 0 ? lb + nn + 2 : 0);
  if (lane == 0) {
    out_d[mb] = ssd;
    out_cb[mb] = cb + cbdc;
  }
}

}  // namespace

extern "C" int inter_luma_tq(const int* pred, const int* orig, int n_prob,
                             int n_mb, int qp, int lam, int* lev, int* rec,
                             int* d8, int* cb8, void* stream) {
  luma_kernel<<<(n_prob + kLumaWarps - 1) / kLumaWarps, 32 * kLumaWarps, 0,
                (cudaStream_t)stream>>>(
      pred, orig, n_prob, n_mb, qp, lam, lev, rec, d8, cb8);
  return (int)cudaGetLastError();
}

extern "C" int inter_chroma_tq(const int* pred, const int* orig, int n_mb,
                               int qp_c, int lam, int* lev, int* dc, int* rec,
                               void* stream) {
  // as many warps a block as leave a block for every SM, up to kChromaWarps
  const int n_warps = (n_mb + 1) / 2;
  const int warps = std::max(1, std::min(kChromaWarps, n_warps / kSMs));
  chroma_kernel<<<(n_warps + warps - 1) / warps, 32 * warps, 0,
                  (cudaStream_t)stream>>>(
      pred, orig, n_mb, qp_c, lam, lev, dc, rec);
  return (int)cudaGetLastError();
}

extern "C" int i16_candidate(const int* cur_y, int H, int W, int qp, int* rec,
                             int* d, int* cb, void* stream) {
  // as many MBs a block as leave a block for every SM, from 2 up to
  // kI16MaxWarps
  const int n_mx = W / 16, n_mb = (H / 16) * n_mx;
  if (n_mb == 0) return 0;
  const int warps = std::max(2, std::min(kI16MaxWarps, n_mb / kSMs));
  i16_kernel<<<(n_mb + warps - 1) / warps, 32 * warps, 0,
               (cudaStream_t)stream>>>(cur_y, W, n_mx, n_mb, qp, rec, d, cb);
  return (int)cudaGetLastError();
}
