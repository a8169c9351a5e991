// K2: the reference-bank entry of one reconstructed picture, for Hopper
// (sm_90a), and of one row slab of a picture (ref_bank_rows).
//
// Replaces h264_tpu/encoder/rd.py:101 `ref_entry_from_planes` and its
// :113 `_bank_from_pad`: edge-pad the recon by PAD = 32, build the
// (4, H+64, W+64) luma bank [G, b, h, j] (6-tap half-pel planes, rounded
// and clipped, shifted into G coordinates, zero on a 2/3-sample border)
// and the (2, H/2+64, W/2+64) edge-padded chroma stack.  The plain PyTorch
// version is h264_tpu_torch/encoder/rd.py `ref_entry_plain`; the wrapper
// is h264_tpu_torch/kernels/ref_bank.py.
//
// `ref_bank_rows` replaces `bank_of` of the sharded GOP encoder
// (rd.py:2662-2672): the same bank over a row slab whose rows are given
// (its own rows, the halo rows its neighbours sent, edge or zero rows
// beyond them), so only the columns are edge-padded.  Its inputs are
// (Hs, W) luma and (Hcs, W/2) chroma slabs, Hs = Hg + 64 and Hcs = Hg/2 +
// 64; its outputs (4, Hs, W+64) and (2, Hcs, W/2+64).  Plain version:
// rd.py `ref_bank_rows_plain`.  Both entries are one kernel: the row
// padding `py` is PAD for a picture and 0 for a slab, where no row is
// ever clamped (the 6-tap rows of every non-border sample lie inside it).
//
// Design.  One launch, one thread per output sample of bank and cpad.
// Each thread reads the unpadded planes with clamped coordinates (the edge
// padding never exists in memory) and computes its own sample: G is a
// copy, b and h a 6-tap sum, j the unrounded 6x6 separable sum
// (sum_k tap[k] * b1[y-2+k][x-2], b1 the unrounded horizontal taps),
// rounded once by (+512) >> 10 as the reference does.  All intermediates
// are int32 and stay below 2^20.
//
// Bound.  Bytes: every output sample is written once, 4 bytes each
// (CIF: about 2.7 MB, 1280x720: about 19 MB; a CIF slab of 144 lines
// about 1.65 MB); the inputs are a sixth of that and are re-read from
// L1/L2 by neighbouring threads.

#include <cuda_runtime.h>

namespace {

constexpr int kPad = 32;
constexpr int kThreads = 256;

__device__ __forceinline__ int clip255(int v) { return min(max(v, 0), 255); }

// sample (y, x) of the edge-padded plane P of H rows (padded coordinates:
// the columns padded by kPad, the rows by py)
__device__ __forceinline__ int padded(const int* __restrict__ P, int H, int W,
                                      int py, int y, int x) {
  y = min(max(y - py, 0), H - 1);
  x = min(max(x - kPad, 0), W - 1);
  return __ldg(P + y * W + x);
}

// unrounded horizontal 6-tap at padded (y, x0..x0+5)
__device__ __forceinline__ int tap_h(const int* __restrict__ P, int H, int W,
                                     int py, int y, int x0) {
  return padded(P, H, W, py, y, x0) - 5 * padded(P, H, W, py, y, x0 + 1) +
         20 * padded(P, H, W, py, y, x0 + 2) +
         20 * padded(P, H, W, py, y, x0 + 3) -
         5 * padded(P, H, W, py, y, x0 + 4) + padded(P, H, W, py, y, x0 + 5);
}

__device__ __forceinline__ int tap_v(const int* __restrict__ P, int H, int W,
                                     int py, int y0, int x) {
  return padded(P, H, W, py, y0, x) - 5 * padded(P, H, W, py, y0 + 1, x) +
         20 * padded(P, H, W, py, y0 + 2, x) +
         20 * padded(P, H, W, py, y0 + 3, x) -
         5 * padded(P, H, W, py, y0 + 4, x) + padded(P, H, W, py, y0 + 5, x);
}

__global__ void __launch_bounds__(kThreads)
ref_bank_kernel(const int* __restrict__ Y, const int* __restrict__ U,
                const int* __restrict__ V, int* __restrict__ bank,
                int* __restrict__ cpad, int H, int W, int Hc, int py) {
  // H, Hc: luma and chroma rows in memory; py: their row padding
  const int Hp = H + 2 * py, Wp = W + 2 * kPad;
  const int Wc = W / 2;
  const int Hcp = Hc + 2 * py, Wcp = Wc + 2 * kPad;
  const long n_bank = 4L * Hp * Wp;
  const long idx = (long)blockIdx.x * kThreads + threadIdx.x;
  if (idx < n_bank) {
    const int k = (int)(idx / ((long)Hp * Wp));
    const int rem = (int)(idx % ((long)Hp * Wp));
    const int y = rem / Wp, x = rem % Wp;
    int v;
    if (k == 0) {
      v = padded(Y, H, W, py, y, x);
    } else if (y < 2 || y >= Hp - 3 || x < 2 || x >= Wp - 3) {
      v = 0;  // the 2/3-sample border of the shifted half-pel planes
    } else if (k == 1) {  // b: horizontal half-pel, x - 2 .. x + 3
      v = clip255((tap_h(Y, H, W, py, y, x - 2) + 16) >> 5);
    } else if (k == 2) {  // h: vertical half-pel, y - 2 .. y + 3
      v = clip255((tap_v(Y, H, W, py, y - 2, x) + 16) >> 5);
    } else {  // j: centre, 6 vertical taps over unrounded horizontal taps
      const int t0 = tap_h(Y, H, W, py, y - 2, x - 2);
      const int t1 = tap_h(Y, H, W, py, y - 1, x - 2);
      const int t2 = tap_h(Y, H, W, py, y, x - 2);
      const int t3 = tap_h(Y, H, W, py, y + 1, x - 2);
      const int t4 = tap_h(Y, H, W, py, y + 2, x - 2);
      const int t5 = tap_h(Y, H, W, py, y + 3, x - 2);
      v = clip255((t0 - 5 * t1 + 20 * t2 + 20 * t3 - 5 * t4 + t5 + 512) >> 10);
    }
    bank[idx] = v;
    return;
  }
  const long cidx = idx - n_bank;
  if (cidx < 2L * Hcp * Wcp) {
    const int pl = (int)(cidx / ((long)Hcp * Wcp));
    const int rem = (int)(cidx % ((long)Hcp * Wcp));
    cpad[cidx] = padded(pl ? V : U, Hc, Wc, py, rem / Wcp, rem % Wcp);
  }
}

int launch(const int* Y, const int* U, const int* V, int* bank, int* cpad,
           int H, int W, int Hc, int py, void* stream) {
  const long n = 4L * (H + 2 * py) * (W + 2 * kPad) +
                 2L * (Hc + 2 * py) * (W / 2 + 2 * kPad);
  const int blocks = (int)((n + kThreads - 1) / kThreads);
  ref_bank_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      Y, U, V, bank, cpad, H, W, Hc, py);
  return (int)cudaGetLastError();
}

}  // namespace

// one picture: (H, W) luma, (H/2, W/2) chroma, edge-padded by PAD all round
extern "C" int ref_bank(const int* Y, const int* U, const int* V, int* bank,
                        int* cpad, int H, int W, void* stream) {
  return launch(Y, U, V, bank, cpad, H, W, H / 2, kPad, stream);
}

// one row slab: (Hs, W) luma, (Hcs, W/2) chroma, whose rows are given;
// only the columns are edge-padded
extern "C" int ref_bank_rows(const int* Y, const int* U, const int* V,
                             int* bank, int* cpad, int Hs, int Hcs, int W,
                             void* stream) {
  return launch(Y, U, V, bank, cpad, Hs, W, Hcs, 0, stream);
}
