// K7: temporal direct motion and prediction of a B picture, for Hopper
// (sm_90a).
//
// Replaces h264_tpu/encoder/rd.py:2218-2263 `direct_b8` / `direct_mb` of
// `rd_b_pipeline`, with `_dynfrac_mc` (:1911) for the two predictions.
// Plain version: h264_tpu_torch/encoder/rd_b.py `b_direct_plain`; wrapper
// kernels/b_direct.py.
//
// Per 8x8 unit of every MB (spec §8.4.1.2.3 with direct_8x8_inference):
// the colocated block is the corner 4x4 of the unit in the list-1
// anchor's snapshot; an intra one gives index 0 and zero motion; else its
// list-0 index idx (already translated into this picture's list 0) picks
// DistScaleFactor dsf and the flag eq ("idx is the anchor itself"), and
//   l0 = eq ? mvCol : (dsf * mvCol + 128) >> 8,   l1 = eq ? 0 : l0 - mvCol
// with an arithmetic shift of a negative product, as int32 in the
// reference.  The unit's prediction is the rounded mean of the list-0
// (reference idx) and list-1 (the anchor) `_dynfrac_mc` predictions,
// whose windows are placed in the unwidened banks as dynamic_slice places
// them (qpel.cuh): direct mvs reach about +-77 pel, past the 32-sample
// padding.  Index lookups (dsf, eq, the bank) bring idx into [0, NR0 - 1]
// as the reference's gathers and dynamic_slice do (slice_start); the idx
// output is the value as read.
//
// Design.  A warp per MB, as many MBs a block (up to 4) as leave a block
// for each of the 132 SMs (CIF's 396 MBs: 132 blocks of 3).  Lanes 0-3
// derive the motion of units 0-3 once: the colocated corner read, idx and
// its clamp, dsf, eq, the scaled mvs; then each list's window origin and
// the two bank planes its fraction picks, as one int offset per tap into
// the bank (kTapA / kTapB: the fraction table packed into two 64-bit
// immediates, a nibble a fraction, so no lane reads __constant__ memory).
// Each of these lanes writes its unit's five fields.  Lane 8 b8 + x then
// takes column x of unit b8: the four tap offsets come from lane b8 by
// shuffle, and each of its eight samples is four gathers (two taps of two
// lists), so that a warp's load reads four 32-byte runs, one row of each
// unit; its stores write two 64-byte runs, rows r and 8 + r of the MB.
//
// What held the first version back, and what this design does about it.
// It ran 256 threads a MB, one a sample: every thread re-derived its
// unit's motion (the same four snapshot reads, clamps, gathers and
// multiplies 64 times a unit), called win_qsample twice (four window
// clamps and twelve kQtab loads from __constant__ memory, divergent
// within a warp, which spans two units, so serialised), and stored one
// int.  The host wrapper made eight tensor checks and six allocations.
// Here the derivation runs once per unit and the fraction table is
// immediates; the wrapper makes one combined check and one allocation
// (the prediction and the five fields are views of one buffer), and the
// entry takes 13 arguments instead of 21.  A lane a row of its unit (eight
// samples, two 16-byte stores) was tried first: a warp's load then
// touched 32 rows, 32 sectors or more, and the call took as long on the
// device as the first version's (PERF.md §6, PR 14).
//
// Bound.  Bytes: per unit and list the 8x8 samples of each bank plane its
// fraction reads, the colocated and per-unit fields, the prediction out
// (about 2 MB for a CIF picture, 0.0006 ms at 3.35 TB/s); a few int32
// operations per sample.  Far below a launch: the call's device time is
// its launch and one chain of dependent loads (snapshot, tables, banks).
//
// ptxas (sm_90a, nvcc -O3): see PERF.md §6 (the build's report, printed
// by chip_smoke.py and tools/time_kernels.py).

#include <algorithm>

#include "qpel.cuh"

namespace {

constexpr int kMaxMbs = 4;  // MBs (warps) a block, at most
constexpr int kSMs = 132;   // an H100's SMs
constexpr unsigned kFull = 0xffffffffu;

// kQtab (qpel.cuh) per tap, nibble f = (mvy & 3) * 4 + (mvx & 3): bits 0-1
// the plane, bit 2 the row offset, bit 3 the column offset
constexpr unsigned long long kTapA = 0x5352332211101100ULL;
constexpr unsigned long long kTapB = 0xA524A332A3228110ULL;

// offset into a (4, Hp, Wp) bank of the first sample tap `tap` (kTapA or
// kTapB) reads for fraction f, in the window that starts at (iy, ix)
__device__ __forceinline__ int tap_offset(unsigned long long tap, int Hp,
                                          int Wp, int iy, int ix, int f) {
  const int t = (int)((tap >> (4 * f)) & 15);
  return ((t & 3) * Hp + iy + ((t >> 2) & 1)) * Wp + ix + (t >> 3);
}

__global__ void __launch_bounds__(32 * kMaxMbs)
b_direct_kernel(const int* __restrict__ banks0, const int* __restrict__ banks1,
                const unsigned char* __restrict__ col_intra,
                const int* __restrict__ col_ref,
                const int* __restrict__ col_mvx,
                const int* __restrict__ col_mvy,
                const int* __restrict__ dsf_tab,
                const unsigned char* __restrict__ eq_tab, int NR0, int Hp,
                int Wp, int n_mb, int n_mx, int* __restrict__ out) {
  const int mb = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (mb >= n_mb) return;  // the whole warp
  const int lane = threadIdx.x & 31;
  const int mby = mb / n_mx, mbx = mb - mby * n_mx;
  // lanes 0-3: unit `lane`'s motion, its window taps and its fields
  int o0a = 0, o0b = 0, o1a = 0, o1b = 0;
  if (lane < 4) {
    const int by = lane >> 1, bx = lane & 1;
    const int c = (4 * mby + 3 * by) * (4 * n_mx) + 4 * mbx + 3 * bx;
    const bool ci = col_intra[c] != 0;
    const int ref = __ldg(col_ref + c), mvx = __ldg(col_mvx + c),
              mvy = __ldg(col_mvy + c);
    const int mcx = ci ? 0 : mvx, mcy = ci ? 0 : mvy, idx = ci ? 0 : ref;
    const int ic = slice_start(idx, NR0, 1);
    const int dsf = __ldg(dsf_tab + ic);
    const bool eq = eq_tab[ic] != 0 || ci;
    const int l0x = eq ? mcx : (dsf * mcx + 128) >> 8;
    const int l0y = eq ? mcy : (dsf * mcy + 128) >> 8;
    const int l1x = eq ? 0 : l0x - mcx, l1y = eq ? 0 : l0y - mcy;
    const int uy = 16 * mby + 8 * by + kPad, ux = 16 * mbx + 8 * bx + kPad;
    const int iy0 = slice_start(uy + (l0y >> 2), Hp, 10),
              ix0 = slice_start(ux + (l0x >> 2), Wp, 10);
    const int iy1 = slice_start(uy + (l1y >> 2), Hp, 10),
              ix1 = slice_start(ux + (l1x >> 2), Wp, 10);
    const int f0 = (l0y & 3) * 4 + (l0x & 3), f1 = (l1y & 3) * 4 + (l1x & 3);
    const int bank0 = ic * 4 * Hp * Wp;
    o0a = bank0 + tap_offset(kTapA, Hp, Wp, iy0, ix0, f0);
    o0b = bank0 + tap_offset(kTapB, Hp, Wp, iy0, ix0, f0);
    o1a = tap_offset(kTapA, Hp, Wp, iy1, ix1, f1);
    o1b = tap_offset(kTapB, Hp, Wp, iy1, ix1, f1);
    // the fields follow the prediction: idx, l0x, l0y, l1x, l1y (n_mb, 4)
    const size_t u = (size_t)mb * 4 + lane, plane = (size_t)n_mb * 4;
    int* f = out + (size_t)n_mb * 256 + u;
    f[0] = idx;
    f[plane] = l0x;
    f[2 * plane] = l0y;
    f[3 * plane] = l1x;
    f[4 * plane] = l1y;
  }
  // lane 8 b8 + x: column x of unit b8, its eight rows; each row of the
  // four units is then four 32-byte runs of the banks
  const int b8 = lane >> 3, x = lane & 7;
  const int* p0a = banks0 + __shfl_sync(kFull, o0a, b8) + x;
  const int* p0b = banks0 + __shfl_sync(kFull, o0b, b8) + x;
  const int* p1a = banks1 + __shfl_sync(kFull, o1a, b8) + x;
  const int* p1b = banks1 + __shfl_sync(kFull, o1b, b8) + x;
  int* dst = out + (size_t)mb * 256 + 128 * (b8 >> 1) + 8 * (b8 & 1) + x;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int o = r * Wp;
    const int a = (__ldg(p0a + o) + __ldg(p0b + o) + 1) >> 1;
    const int b = (__ldg(p1a + o) + __ldg(p1b + o) + 1) >> 1;
    dst[16 * r] = (a + b + 1) >> 1;
  }
}

}  // namespace

// out: n_mb * 276 int32, the prediction (n_mb, 16, 16) then idx, l0x,
// l0y, l1x, l1y (n_mb, 4) each; the picture is (Hp - 64) x (Wp - 64)
extern "C" int b_direct(const int* banks0, const int* banks1,
                        const unsigned char* col_intra, const int* col_ref,
                        const int* col_mvx, const int* col_mvy,
                        const int* dsf_tab, const unsigned char* eq_tab,
                        int NR0, int Hp, int Wp, int* out, void* stream) {
  const int n_mx = (Wp - 2 * kPad) / 16, n_mb = (Hp - 2 * kPad) / 16 * n_mx;
  // as many MBs a block as leave a block for every SM, up to kMaxMbs
  const int mbs = std::max(1, std::min(kMaxMbs, n_mb / kSMs));
  b_direct_kernel<<<(n_mb + mbs - 1) / mbs, 32 * mbs, 0,
                    (cudaStream_t)stream>>>(
      banks0, banks1, col_intra, col_ref, col_mvx, col_mvy, dsf_tab, eq_tab,
      NR0, Hp, Wp, n_mb, n_mx, out);
  return (int)cudaGetLastError();
}
