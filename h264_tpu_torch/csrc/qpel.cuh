// Quarter-pel and chroma sampling shared by K4 (qpel.cu) and K7
// (b_direct.cu), for Hopper (sm_90a).
//
// A quarter-pel luma sample is the rounded mean of the two samples of the
// reference bank (planes G, b, h, j) that kQtab picks for the mv's
// fraction (the reference's encoder/rd.py `_QTAB`).
//
// The windowed samplers read what `jax.lax.dynamic_slice` reads: the unit's
// window starts at its integer position; a negative start counts from the
// end of the axis (s + L), then the start is clamped into [0, L - size].
// The whole window moves; no sample is edge-replicated, and a window that
// would start above or left of the bank comes from its far edge.
// win_qsample is rd.py:1911 `_dynfrac_mc` (an (h+2)x(w+2) window),
// win_csample rd.py:159 `_mc_chroma_unit` with pad = PAD on h x w chroma
// units (an (h+1)x(w+1) window).
#pragma once

#include "common.cuh"

namespace {

// (plane0, oy0, ox0, plane1, oy1, ox1) per fraction (mvy & 3) * 4 + (mvx & 3)
__constant__ int kQtab[16][6] = {
    {0, 0, 0, 0, 0, 0}, {0, 0, 0, 1, 0, 0}, {1, 0, 0, 1, 0, 0},
    {1, 0, 0, 0, 0, 1}, {0, 0, 0, 2, 0, 0}, {1, 0, 0, 2, 0, 0},
    {1, 0, 0, 3, 0, 0}, {1, 0, 0, 2, 0, 1}, {2, 0, 0, 2, 0, 0},
    {2, 0, 0, 3, 0, 0}, {3, 0, 0, 3, 0, 0}, {3, 0, 0, 2, 0, 1},
    {2, 0, 0, 0, 1, 0}, {1, 1, 0, 2, 0, 0}, {3, 0, 0, 1, 1, 0},
    {1, 1, 0, 2, 0, 1}};

// where dynamic_slice starts a window of `size` on an axis of length L
// when asked to start at s
__device__ __forceinline__ int slice_start(int s, int L, int size) {
  return clampi(s < 0 ? s + L : s, L - size);
}

// sample (y, x) of the h x w unit at picture position (y0, x0) with mv
// (mvx, mvy), from one reference's (4, Hp, Wp) bank
__device__ __forceinline__ int win_qsample(const int* bank, int Hp, int Wp,
                                           int y0, int x0, int h, int w,
                                           int mvx, int mvy, int y, int x) {
  const int iy = slice_start(y0 + (mvy >> 2) + kPad, Hp, h + 2);
  const int ix = slice_start(x0 + (mvx >> 2) + kPad, Wp, w + 2);
  const int* t = kQtab[(mvy & 3) * 4 + (mvx & 3)];
  const size_t plane = (size_t)Hp * Wp;
  const int a = bank[t[0] * plane + (size_t)(iy + t[1] + y) * Wp + ix + t[2] + x];
  const int b = bank[t[3] * plane + (size_t)(iy + t[4] + y) * Wp + ix + t[5] + x];
  return (a + b + 1) >> 1;
}

// sample (y, x) of the h x w chroma unit at chroma position (yc, xc) with
// mv (mvx, mvy) in 1/8 chroma pel, from one (Hcp, Wcp) padded plane
__device__ __forceinline__ int win_csample(const int* P, int Hcp, int Wcp,
                                           int yc, int xc, int h, int w,
                                           int mvx, int mvy, int y, int x) {
  const int yi = slice_start(yc + (mvy >> 3) + kPad, Hcp, h + 1) + y;
  const int xi = slice_start(xc + (mvx >> 3) + kPad, Wcp, w + 1) + x;
  const int fx = mvx & 7, fy = mvy & 7;
  const int* r0 = P + (size_t)yi * Wcp + xi;
  const int* r1 = r0 + Wcp;
  return ((8 - fx) * (8 - fy) * r0[0] + fx * (8 - fy) * r0[1] +
          (8 - fx) * fy * r1[0] + fx * fy * r1[1] + 32) >> 6;
}

}  // namespace
