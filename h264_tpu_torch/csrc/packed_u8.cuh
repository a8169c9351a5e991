// Packing u8 samples into 32-bit words, shared by the kernels that hold
// their windows as packed bytes: K10's sad_grid (sad_grid.cu) and K13's
// p16_refine (p16_refine.cu), for Hopper (sm_90a).
#pragma once

namespace {

// four u8 samples held as int32 -> one word, sample b in byte b
__device__ __forceinline__ unsigned pack4(int a, int b, int c, int d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                     0x5410);
}

}  // namespace
