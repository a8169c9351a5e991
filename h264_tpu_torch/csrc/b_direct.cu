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
// Design.  One block of 256 threads per MB, one thread per luma sample:
// each thread derives its unit's motion (four reads of the snapshot,
// cached) and computes its sample; the unit's top-left thread writes the
// unit's fields.
//
// Bound.  Bytes: two 10x10 windows of two bank planes per unit and the
// prediction out; a few int32 operations per sample.

#include "qpel.cuh"

namespace {

__global__ void __launch_bounds__(256)
b_direct_kernel(const int* __restrict__ banks0, const int* __restrict__ banks1,
                const unsigned char* __restrict__ col_intra,
                const int* __restrict__ col_ref,
                const int* __restrict__ col_mvx,
                const int* __restrict__ col_mvy, const int* __restrict__ dsf_tab,
                const unsigned char* __restrict__ eq_tab, int NR0, int Hp,
                int Wp, int n_mx, int* pred, int* idx_out, int* l0x_out,
                int* l0y_out, int* l1x_out, int* l1y_out) {
  const int mb = blockIdx.x, t = threadIdx.x;
  const int y = t >> 4, x = t & 15, b8 = 2 * (y >> 3) + (x >> 3);
  const int mby = mb / n_mx, mbx = mb % n_mx;
  const int c = (4 * mby + 3 * (b8 >> 1)) * (4 * n_mx) + 4 * mbx + 3 * (b8 & 1);
  const bool ci = col_intra[c] != 0;
  const int mcx = ci ? 0 : col_mvx[c], mcy = ci ? 0 : col_mvy[c];
  const int idx = ci ? 0 : col_ref[c];
  const int ic = slice_start(idx, NR0, 1);
  const int dsf = dsf_tab[ic];
  const bool eq = eq_tab[ic] != 0 || ci;
  const int l0x = eq ? mcx : (dsf * mcx + 128) >> 8;
  const int l0y = eq ? mcy : (dsf * mcy + 128) >> 8;
  const int l1x = eq ? 0 : l0x - mcx, l1y = eq ? 0 : l0y - mcy;
  const int uy = 16 * mby + 8 * (b8 >> 1), ux = 16 * mbx + 8 * (b8 & 1);
  const int p0 = win_qsample(banks0 + (size_t)ic * 4 * Hp * Wp, Hp, Wp, uy,
                             ux, 8, 8, l0x, l0y, y & 7, x & 7);
  const int p1 = win_qsample(banks1, Hp, Wp, uy, ux, 8, 8, l1x, l1y, y & 7,
                             x & 7);
  pred[(size_t)mb * 256 + t] = (p0 + p1 + 1) >> 1;
  if ((y & 7) == 0 && (x & 7) == 0) {
    const int u = mb * 4 + b8;
    idx_out[u] = idx;
    l0x_out[u] = l0x;
    l0y_out[u] = l0y;
    l1x_out[u] = l1x;
    l1y_out[u] = l1y;
  }
}

}  // namespace

extern "C" int b_direct(const int* banks0, const int* banks1,
                        const unsigned char* col_intra, const int* col_ref,
                        const int* col_mvx, const int* col_mvy,
                        const int* dsf_tab, const unsigned char* eq_tab,
                        int NR0, int Hp, int Wp, int n_mb, int n_mx, int* pred,
                        int* idx, int* l0x, int* l0y, int* l1x, int* l1y,
                        void* stream) {
  b_direct_kernel<<<n_mb, 256, 0, (cudaStream_t)stream>>>(
      banks0, banks1, col_intra, col_ref, col_mvx, col_mvy, dsf_tab, eq_tab,
      NR0, Hp, Wp, n_mx, pred, idx, l0x, l0y, l1x, l1y);
  return (int)cudaGetLastError();
}
