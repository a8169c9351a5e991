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
//                    (`_i16_pred_all` + `_i16_tq`, :984-998), through the
//                    same device code as the intra commit (common.cuh).
// Plain versions: h264_tpu_torch/encoder/rd_p.py `inter_luma_tq_plain`,
// `inter_chroma_tq_plain`, `i16_candidate_plain`; wrapper kernels/inter_tq.py.
//
// Exactness.  `_rdoq4` is float32: dD = ((d * d) * n2) - (((8 * d) * F64)
// * ss), dJ = dD + float(lam) * float(bits_m - bits), one rounding per
// operation.  Every product and sum is written with __fmul_rn / __fadd_rn
// / __fsub_rn, which nvcc never contracts into an FMA.  Integer parts as
// in the intra commit: wrapping products, arithmetic shifts.
//
// Design.  inter_luma_tq: 16 threads per (candidate, MB), one per 4x4
// block, four problems per block of 64 threads; the thresholding needs the
// MB's 16 block costs, shared through shared memory.  inter_chroma_tq: 8
// threads per MB (2 planes x 4 blocks), eight MBs per block.
// i16_candidate: 64 threads per MB, as in the intra commit.
//
// Bound.  Operations: about 61 integer operations per coefficient for
// transform, quant, RDOQ (a second inverse and forward transform) and
// recon, and 12 float32 ones for RDOQ's cost, over the candidates' 256
// samples per MB (chip_smoke.py OPS_INTER_TQ).
//
// ptxas (sm_90a, nvcc -O3): luma_kernel and chroma_kernel 128 and 190
// registers with 64- and 80-byte stack frames (the per-thread 4x4 arrays),
// 768 B shared memory each; i16_kernel 64 registers, 4,056 B shared
// memory; no spills.

#include "common.cuh"

namespace {

__constant__ int kZz4[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
__constant__ int kCostRun[16] = {3, 2, 2, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
__constant__ float kN2[4] = {16.f, 10.f, 16.f, 10.f};
__constant__ float kSS[4] = {2.f, 1.f, 2.f, 1.f};

// JM coeff_cost of a raster 4x4 level block from zig-zag position `first`
__device__ int coeff_cost(const int* lev, int first) {
  int cost = 0, run = 0;
  for (int z = first; z < 16; ++z) {
    int v = lev[kZz4[z]];
    if (v != 0) {
      cost += abs(v) > 1 ? 9 : kCostRun[run];
      run = 0;
    } else {
      ++run;
    }
  }
  return cost;
}

__device__ __forceinline__ int rdoq_bits(int a) {
  return a > 0 ? 2 * bitlen(a) + 2 : 0;
}

// RDOQ-lite (rd.py `_rdoq4`) of one raster block: res pixel residuals,
// lev levels (updated in place)
__device__ void rdoq4(const int* res, int* lev, int per, int rem, float lam32) {
  int deq[16], levm[16], e[16];
  for (int k = 0; k < 16; ++k) {
    deq[k] = dequant(lev[k], k, per, rem);
    levm[k] = lev[k] > 0 ? lev[k] - 1 : lev[k] < 0 ? lev[k] + 1 : 0;
    e[k] = deq[k];
  }
  inverse4x4(e);
  for (int k = 0; k < 16; ++k) e[k] = shl(res[k], 6) - e[k];
  forward4x4(e);
  for (int k = 0; k < 16; ++k) {
    float delta = (float)(dequant(levm[k], k, per, rem) - deq[k]);
    float n2 = kN2[k >> 2] * kN2[k & 3], ss = kSS[k >> 2] * kSS[k & 3];
    float dD = __fsub_rn(__fmul_rn(__fmul_rn(delta, delta), n2),
                         __fmul_rn(__fmul_rn(__fmul_rn(8.0f, delta), (float)e[k]),
                                   ss));
    int a = abs(lev[k]);
    float dJ = __fadd_rn(dD, __fmul_rn(lam32, (float)(rdoq_bits(abs(levm[k]))
                                                      - rdoq_bits(a))));
    if (a > 0 && dJ < 0.0f) lev[k] = levm[k];
  }
}

__global__ void __launch_bounds__(64)
luma_kernel(const int* __restrict__ pred, const int* __restrict__ orig,
            int n_prob, int n_mb, int qp, int lam, int* out_lev, int* out_rec,
            int* out_d8, int* out_cb8) {
  __shared__ int cost4[4][16], d4[4][16], cb4[4][16];
  const int tid = threadIdx.x, sub = tid >> 4, blk = tid & 15;
  const int p = blockIdx.x * 4 + sub;
  const bool live = p < n_prob;
  const int mb = live ? p % n_mb : 0;
  const int br = blk >> 2, bc = blk & 3;
  const int per = qp / 6, rem = qp % 6, off = 342 << (4 + per);
  const float lam32 = (float)lam;
  int pb[16], ob[16], res[16], lev[16], c[16];
  if (live) {
    for (int k = 0; k < 16; ++k) {
      int y = 4 * br + (k >> 2), x = 4 * bc + (k & 3);
      pb[k] = pred[(size_t)p * 256 + 16 * y + x];
      ob[k] = orig[(size_t)mb * 256 + 16 * y + x];
      res[k] = ob[k] - pb[k];
      c[k] = res[k];
    }
    forward4x4(c);
    for (int k = 0; k < 16; ++k) lev[k] = quant(c[k], kM4[rem][cls4(k)], off, 15 + per);
    rdoq4(res, lev, per, rem, lam32);
    cost4[sub][blk] = coeff_cost(lev, 0);
  }
  __syncthreads();
  if (live) {
    // per 8x8: drop when its coeff_cost <= 4; then the MB when the kept
    // total is <= 5
    int c8[4], kept = 0;
    for (int b8 = 0; b8 < 4; ++b8) {
      int y8 = b8 >> 1, x8 = b8 & 1;
      c8[b8] = cost4[sub][8 * y8 + 2 * x8] + cost4[sub][8 * y8 + 2 * x8 + 1] +
               cost4[sub][8 * y8 + 4 + 2 * x8] + cost4[sub][8 * y8 + 5 + 2 * x8];
      kept += c8[b8] <= 4 ? 0 : c8[b8];
    }
    const bool drop = c8[2 * (br >> 1) + (bc >> 1)] <= 4 || kept <= 5;
    int rr[16];
    for (int k = 0; k < 16; ++k) {
      if (drop) lev[k] = 0;
      rr[k] = dequant(lev[k], k, per, rem);
    }
    inverse4x4(rr);
    int ssd = 0;
    for (int k = 0; k < 16; ++k) {
      int y = 4 * br + (k >> 2), x = 4 * bc + (k & 3);
      int rec = drop ? clip255(pb[k]) : clip255((rr[k] + shl(pb[k], 6) + 32) >> 6);
      int dd = ob[k] - rec;
      ssd += dd * dd;
      out_rec[(size_t)p * 256 + 16 * y + x] = rec;
      out_lev[((size_t)p * 16 + blk) * 16 + k] = lev[k];
    }
    d4[sub][blk] = ssd;
    cb4[sub][blk] = coef_bits16(lev);
  }
  __syncthreads();
  if (live && blk < 4) {
    int y8 = blk >> 1, x8 = blk & 1, s = 0, b = 0;
    for (int i = 0; i < 2; ++i)
      for (int j = 0; j < 2; ++j) {
        int q = 4 * (2 * y8 + i) + 2 * x8 + j;
        s += d4[sub][q];
        b += cb4[sub][q];
      }
    out_d8[(size_t)p * 4 + blk] = s;
    out_cb8[(size_t)p * 4 + blk] = b;
  }
}

__global__ void __launch_bounds__(64)
chroma_kernel(const int* __restrict__ pred, const int* __restrict__ orig,
              int n_mb, int qp_c, int lam, int* out_lev, int* out_dc,
              int* out_rec) {
  __shared__ int dc[8][2][4], dcdeq[8][2][4], acc[8][2][4];
  const int tid = threadIdx.x, sub = tid >> 3;
  const int pl = (tid >> 2) & 1, cb = tid & 3, cby = cb >> 1, cbx = cb & 1;
  const int mb = blockIdx.x * 8 + sub;
  const bool live = mb < n_mb;
  const int per = qp_c / 6, rem = qp_c % 6, off = 342 << (4 + per);
  const float lam32 = (float)lam;
  const size_t base = ((size_t)mb * 2 + pl) * 64;
  int pb[16], res[16], c[16], lev[16];
  if (live) {
    for (int k = 0; k < 16; ++k) {
      int y = 4 * cby + (k >> 2), x = 4 * cbx + (k & 3);
      pb[k] = pred[base + 8 * y + x];
      res[k] = orig[base + 8 * y + x] - pb[k];
      c[k] = res[k];
    }
    forward4x4(c);
    dc[sub][pl][cb] = c[0];
  }
  __syncthreads();
  if (live && cb == 0) {
    const int* d = dc[sub][pl];
    int h[4] = {d[0] + d[1] + d[2] + d[3], d[0] - d[1] + d[2] - d[3],
                d[0] + d[1] - d[2] - d[3], d[0] - d[1] - d[2] + d[3]};
    int l[4];
    for (int k = 0; k < 4; ++k) {
      l[k] = quant(h[k], kM4[rem][0], 2 * off, 16 + per);
      out_dc[((size_t)mb * 2 + pl) * 4 + k] = l[k];
    }
    int g[4] = {l[0] + l[1] + l[2] + l[3], l[0] - l[1] + l[2] - l[3],
                l[0] + l[1] - l[2] - l[3], l[0] - l[1] - l[2] + l[3]};
    for (int k = 0; k < 4; ++k) {  // truncating chroma-DC dequant
      int v = mul(g[k], kV4[rem][0] * 16);
      dcdeq[sub][pl][k] = per < 5 ? v >> (5 - per) : shl(v, per - 5);
    }
  }
  if (live) {
    for (int k = 0; k < 16; ++k)
      lev[k] = k == 0 ? 0 : quant(c[k], kM4[rem][cls4(k)], off, 15 + per);
    rdoq4(res, lev, per, rem, lam32);
    lev[0] = 0;
    acc[sub][pl][cb] = coeff_cost(lev, 1);
  }
  __syncthreads();
  if (live) {
    const int* a = acc[sub][pl];
    if (a[0] + a[1] + a[2] + a[3] < 4)
      for (int k = 0; k < 16; ++k) lev[k] = 0;
    int rr[16];
    for (int k = 0; k < 16; ++k)
      rr[k] = k == 0 ? dcdeq[sub][pl][cb] : dequant(lev[k], k, per, rem);
    inverse4x4(rr);
    for (int k = 0; k < 16; ++k) {
      int y = 4 * cby + (k >> 2), x = 4 * cbx + (k & 3);
      out_rec[base + 8 * y + x] = clip255((rr[k] + shl(pb[k], 6) + 32) >> 6);
      out_lev[(((size_t)mb * 2 + pl) * 4 + cb) * 16 + k] = lev[k];
    }
  }
}

__global__ void __launch_bounds__(64)
i16_kernel(const int* __restrict__ cur_y, int W, int n_mx, int qp,
           int* out_rec, int* out_d, int* out_cb) {
  __shared__ I16Smem s;
  __shared__ int orig[256];
  const int tid = threadIdx.x, i = blockIdx.x;
  const int r = i / n_mx, c = i % n_mx;
  const int au = r > 0, al = c > 0;
  for (int k = tid; k < 256; k += 64)
    orig[k] = cur_y[(size_t)(16 * r + (k >> 4)) * W + 16 * c + (k & 15)];
  // original neighbours, zero outside the picture
  if (tid < 16) {
    s.up[tid] = au ? cur_y[(size_t)(16 * r - 1) * W + 16 * c + tid] : 0;
    s.left[tid] = al ? cur_y[(size_t)(16 * r + tid) * W + 16 * c - 1] : 0;
  }
  if (tid == 16) s.ul = au && al ? cur_y[(size_t)(16 * r - 1) * W + 16 * c - 1] : 0;
  __syncthreads();
  const int per = qp / 6, rem = qp % 6, off = 682 << (4 + per);
  i16_code(s, orig, au, al, per, rem, off, tid);
  __syncthreads();
  for (int k = tid; k < 256; k += 64) out_rec[(size_t)i * 256 + k] = s.rec16[k];
  if (tid == 0) {
    int d = 0, cb = s.cbdc;
    for (int k = 0; k < 16; ++k) {
      d += s.d16[k];
      cb += s.cb16[k];
    }
    out_d[i] = d;
    out_cb[i] = cb;
  }
}

}  // namespace

extern "C" int inter_luma_tq(const int* pred, const int* orig, int n_prob,
                             int n_mb, int qp, int lam, int* lev, int* rec,
                             int* d8, int* cb8, void* stream) {
  luma_kernel<<<(n_prob + 3) / 4, 64, 0, (cudaStream_t)stream>>>(
      pred, orig, n_prob, n_mb, qp, lam, lev, rec, d8, cb8);
  return (int)cudaGetLastError();
}

extern "C" int inter_chroma_tq(const int* pred, const int* orig, int n_mb,
                               int qp_c, int lam, int* lev, int* dc, int* rec,
                               void* stream) {
  chroma_kernel<<<(n_mb + 7) / 8, 64, 0, (cudaStream_t)stream>>>(
      pred, orig, n_mb, qp_c, lam, lev, dc, rec);
  return (int)cudaGetLastError();
}

extern "C" int i16_candidate(const int* cur_y, int H, int W, int qp, int* rec,
                             int* d, int* cb, void* stream) {
  i16_kernel<<<(H / 16) * (W / 16), 64, 0, (cudaStream_t)stream>>>(
      cur_y, W, W / 16, qp, rec, d, cb);
  return (int)cudaGetLastError();
}
