// Prime-field helpers shared by the mod-p kernels (modmatmul.cu, polyeval.cu).
//
// mod_p is the device twin of repro_torch/kernels/barrett.py::mod_p (itself
// the port of src/repro/kernels/barrett.py:56).  For a pseudo-Mersenne prime
// p = 2^b - c the Barrett quotient collapses to a multiply-shift fold
//
//     x == c * (x >> b) + (x & (2^b - 1))   (mod p)
//
// and NF folds (barrett_params' n_folds, a template argument here so the
// loop unrolls) take any x < 2^63 below 2p; one conditional subtract ends
// the reduction.  No integer division on the device.
#pragma once

#include <cstdint>

struct FoldParams {
  uint64_t p;     // the prime
  uint32_t b;     // bit length of p
  uint64_t c;     // 2^b - p
};

template <int NF>
__device__ __forceinline__ uint64_t mod_p(uint64_t x, const FoldParams& f) {
  const uint64_t mask = (uint64_t{1} << f.b) - 1;
#pragma unroll
  for (int i = 0; i < NF; ++i) x = f.c * (x >> f.b) + (x & mask);
  return x >= f.p ? x - f.p : x;
}

// One 32x32 -> 64-bit product: operands are field elements < p < 2^31.
__device__ __forceinline__ uint64_t mul_wide(uint32_t a, uint32_t b) {
  return static_cast<uint64_t>(a) * static_cast<uint64_t>(b);
}
