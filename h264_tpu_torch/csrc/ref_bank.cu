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
// Design.  One launch over a 2-D grid of output tiles of 16 rows x 64
// columns, a block of 256 threads each; the chroma pad tiles are further
// rows of blocks of the same grid.  A luma block
//   1. stages its input window once in shared memory: padded rows
//      y0-2 .. y0+18 and columns x0-4 .. x0+67, read from the unpadded
//      plane at clamped coordinates (which realises the edge padding
//      without storing it), 16 bytes a thread where the window lies
//      inside the plane and its rows are 16-byte aligned, else a sample a
//      thread (coalesced either way);
//   2. computes the unrounded horizontal 6-tap sums b1 once for every
//      window row and output column, into shared memory;
//   3. writes the tile of each of the four planes, each thread 4 adjacent
//      columns of a row (16-byte stores where the row allows): G a copy,
//      b its b1 rounded, h the vertical 6-tap of the staged samples, j the
//      vertical 6-tap of b1 rounded once by (+512) >> 10; zero on the
//      border the reference's pad(2, 3) leaves.
// So each output reads at most 6 shared-memory values and the plane is
// read from device memory once, apart from the 5-row and 8-column halo
// of each tile.  Tiles of 16 rows ran faster than 32 or 64 (more blocks
// in flight at CIF, the same at 1280x720; time_kernels.trial_ref_bank).  All intermediates are int32 below 2^20, as the
// reference's.  A chroma block copies its tile at clamped coordinates.
// Offsets are int (the wrapper refuses 2^31 samples); the tile indices
// come from the grid, with one 32-bit division per chroma block.
//
// Bound.  Bytes: the planes read once and every output written once, 4
// bytes each (CIF about 3.4 MB, 1280x720 about 24.8 MB: 0.0074 ms at
// 3.35 TB/s); the 6-tap arithmetic is a few operations per output.

#include <cuda_runtime.h>

namespace {

constexpr int kPad = 32;
constexpr int kTH = 16, kTW = 64;  // output tile
constexpr int kThreads = 256;
constexpr int kSH = kTH + 5;       // staged rows: y0-2 .. y0+TH+2
constexpr int kSW = kTW + 8;       // staged columns: x0-4 .. x0+TW+3
constexpr int kGroups = kTW / 4;   // 4-column groups of a tile row
constexpr int kRowsPer = kTH / (kThreads / kGroups);  // rows a thread

__device__ __forceinline__ int clip255(int v) { return min(max(v, 0), 255); }
__device__ __forceinline__ int clampi(int v, int hi) {
  return min(max(v, 0), hi);
}

__device__ __forceinline__ int tap6(int a, int b, int c, int d, int e,
                                    int f) {
  return a - 5 * b + 20 * c + 20 * d - 5 * e + f;
}

__device__ __forceinline__ int lane(const int4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// 4 adjacent outputs of one row of a plane: a 16-byte store where the
// row's layout allows, else the ones inside the row one by one
__device__ __forceinline__ void store4(int* row, int x, int Wp, bool vec,
                                       int4 v) {
  if (vec) {
    if (x < Wp) *(int4*)(row + x) = v;
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (x + j < Wp) row[x + j] = lane(v, j);
}

struct Smem {
  int s[kSH][kSW];   // the padded luma window
  int b1[kSH][kTW];  // its unrounded horizontal 6-tap sums
};

__device__ void luma_tile(const int* __restrict__ Y, int* __restrict__ bank,
                          int H, int W, int py, int y0, int x0, Smem& sm) {
  const int Hp = H + 2 * py, Wp = W + 2 * kPad;
  const int t = threadIdx.x;
  // 1. the window: sm.s[r][c] is padded (y0 - 2 + r, x0 - 4 + c)
  const int sy0 = y0 - 2 - py, sx0 = x0 - 4 - kPad;
  if ((W & 3) == 0 && ((size_t)Y & 15) == 0 && sy0 >= 0 &&
      sy0 + kSH <= H && sx0 >= 0 && sx0 + kSW <= W) {
    for (int i = t; i < kSH * (kSW / 4); i += kThreads) {
      const int r = i / (kSW / 4), c4 = i - r * (kSW / 4);
      *(int4*)&sm.s[r][4 * c4] =
          __ldg((const int4*)(Y + (sy0 + r) * W + sx0) + c4);
    }
  } else {
    for (int i = t; i < kSH * kSW; i += kThreads) {
      const int r = i / kSW, c = i - r * kSW;
      sm.s[r][c] = __ldg(Y + clampi(sy0 + r, H - 1) * W +
                         clampi(sx0 + c, W - 1));
    }
  }
  __syncthreads();
  // 2. b1[r][i] = the horizontal taps of padded columns x0+i-2 .. x0+i+3
  for (int i = t; i < kSH * kGroups; i += kThreads) {
    const int r = i / kGroups, g = i - r * kGroups;
    const int4 a = *(const int4*)&sm.s[r][4 * g];
    const int4 b = *(const int4*)&sm.s[r][4 * g + 4];
    const int4 c = *(const int4*)&sm.s[r][4 * g + 8];
    int4 o;
    o.x = tap6(a.z, a.w, b.x, b.y, b.z, b.w);
    o.y = tap6(a.w, b.x, b.y, b.z, b.w, c.x);
    o.z = tap6(b.x, b.y, b.z, b.w, c.x, c.y);
    o.w = tap6(b.y, b.z, b.w, c.x, c.y, c.z);
    *(int4*)&sm.b1[r][4 * g] = o;
  }
  __syncthreads();
  // 3. thread (ty, g): rows y0 + kRowsPer ty + d, columns x0 + 4 g .. + 3
  const int g = t % kGroups, ly = kRowsPer * (t / kGroups);
  const int x = x0 + 4 * g;
  const bool vec = (Wp & 3) == 0;
  const int plane = Hp * Wp;
  bool col_in[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) col_in[j] = x + j >= 2 && x + j < Wp - 3;
#pragma unroll
  for (int d = 0; d < kRowsPer; ++d) {
    const int y = y0 + ly + d;
    if (y >= Hp) break;
    const int r = ly + d;  // window rows r .. r + 5 hold y - 2 .. y + 3
    const bool row_in = y >= 2 && y < Hp - 3;
    int* row = bank + y * Wp;
    store4(row, x, Wp, vec, *(const int4*)&sm.s[r + 2][4 * g + 4]);
    int v[4];
    const int4 b2 = *(const int4*)&sm.b1[r + 2][4 * g];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[j] = row_in && col_in[j] ? clip255((lane(b2, j) + 16) >> 5) : 0;
    store4(row + plane, x, Wp, vec, make_int4(v[0], v[1], v[2], v[3]));
    int4 T[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) T[k] = *(const int4*)&sm.s[r + k][4 * g + 4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[j] = row_in && col_in[j]
                 ? clip255((tap6(lane(T[0], j), lane(T[1], j), lane(T[2], j),
                                 lane(T[3], j), lane(T[4], j), lane(T[5], j)) +
                            16) >> 5)
                 : 0;
    store4(row + 2 * plane, x, Wp, vec, make_int4(v[0], v[1], v[2], v[3]));
#pragma unroll
    for (int k = 0; k < 6; ++k) T[k] = *(const int4*)&sm.b1[r + k][4 * g];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[j] = row_in && col_in[j]
                 ? clip255((tap6(lane(T[0], j), lane(T[1], j), lane(T[2], j),
                                 lane(T[3], j), lane(T[4], j), lane(T[5], j)) +
                            512) >> 10)
                 : 0;
    store4(row + 3 * plane, x, Wp, vec, make_int4(v[0], v[1], v[2], v[3]));
  }
}

// one tile of an edge-padded chroma plane, at clamped coordinates
__device__ void chroma_tile(const int* __restrict__ P, int* __restrict__ out,
                            int Hc, int Wc, int py, int y0, int x0) {
  const int Hcp = Hc + 2 * py, Wcp = Wc + 2 * kPad;
  const int t = threadIdx.x;
  const int x = x0 + 4 * (t % kGroups), ly = kRowsPer * (t / kGroups);
  const bool vec = (Wcp & 3) == 0;
#pragma unroll
  for (int d = 0; d < kRowsPer; ++d) {
    const int y = y0 + ly + d;
    if (y >= Hcp) break;
    const int* src = P + clampi(y - py, Hc - 1) * Wc;
    int4 v;
    v.x = __ldg(src + clampi(x - kPad, Wc - 1));
    v.y = __ldg(src + clampi(x + 1 - kPad, Wc - 1));
    v.z = __ldg(src + clampi(x + 2 - kPad, Wc - 1));
    v.w = __ldg(src + clampi(x + 3 - kPad, Wc - 1));
    store4(out + y * Wcp, x, Wcp, vec, v);
  }
}

// blockIdx.y < nty: luma tile (blockIdx.y, blockIdx.x); beyond it the
// chroma tiles, counted along the rows of the grid: plane, then tile row
// of ntyc, then tile column of ntxc
__global__ void __launch_bounds__(kThreads)
ref_bank_kernel(const int* __restrict__ Y, const int* __restrict__ U,
                const int* __restrict__ V, int* __restrict__ bank,
                int* __restrict__ cpad, int H, int W, int Hc, int py,
                int nty, int ntxc, int ntyc) {
  __shared__ Smem sm;
  if ((int)blockIdx.y < nty) {
    luma_tile(Y, bank, H, W, py, blockIdx.y * kTH, blockIdx.x * kTW, sm);
    return;
  }
  int c = (blockIdx.y - nty) * gridDim.x + blockIdx.x;
  const int per_plane = ntxc * ntyc;
  if (c >= 2 * per_plane) return;
  const int pl = c >= per_plane;
  c -= pl * per_plane;
  const int ty = c / ntxc, tx = c - ty * ntxc;
  const int Wc = W / 2;
  chroma_tile(pl ? V : U, cpad + pl * (Hc + 2 * py) * (Wc + 2 * kPad), Hc, Wc,
              py, ty * kTH, tx * kTW);
}

int launch(const int* Y, const int* U, const int* V, int* bank, int* cpad,
           int H, int W, int Hc, int py, void* stream) {
  const int Hp = H + 2 * py, Wp = W + 2 * kPad;
  const int Hcp = Hc + 2 * py, Wcp = W / 2 + 2 * kPad;
  const int ntx = (Wp + kTW - 1) / kTW, nty = (Hp + kTH - 1) / kTH;
  const int ntxc = (Wcp + kTW - 1) / kTW, ntyc = (Hcp + kTH - 1) / kTH;
  const int chroma_rows = (2 * ntxc * ntyc + ntx - 1) / ntx;
  ref_bank_kernel<<<dim3(ntx, nty + chroma_rows), kThreads, 0,
                    (cudaStream_t)stream>>>(Y, U, V, bank, cpad, H, W, Hc, py,
                                            nty, ntxc, ntyc);
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
