// Shared device code of the port's limb kernels: the balanced digit split,
// the int8 lane packing, the f32 recombine and the dequant epilogue.  The
// limb kernels run their int8 passes on the tensor cores (limb_mma.cuh,
// conv_mma.cuh) and share these pieces.
//
// Arithmetic contract (held bit for bit against the JAX reference):
//   * balanced digits: lo = ((x + h) & (beta - 1)) - h, hi = (x - lo) >> b,
//     h = 2^(b-1), beta = 2^b; |x| <= kom_qmax(b) keeps both in [-h, h-1];
//   * three int32 accumulators (hh, mid, ll); Karatsuba forms mid from the
//     digit-sum pass as (Ah+Al)(Bh+Bl) - hh - ll, schoolbook as
//     Ah*Bl + Al*Bh -- the same integer, int32 wrap-around included;
//   * one f32 recombine per output, in the reference's order
//     (hh*beta^2 + mid*beta) + ll, every operation rounded on its own;
//   * epilogue fma(raw, s_row * s_col, bias): the reference's jitted
//     forward contracts raw*t + b into one FMA; without a bias, raw * t.
// The library is compiled with -fmad=false, so nothing else is contracted.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace limb {

__device__ __forceinline__ void balanced_split(int x, int base_bits, int& hi,
                                               int& lo) {
  const int beta = 1 << base_bits;
  const int half = beta >> 1;
  lo = ((x + half) & (beta - 1)) - half;
  hi = (x - lo) >> base_bits;  // exact: x - lo is a multiple of beta
}

__device__ __forceinline__ float recombine(int hh, int mid, int ll,
                                           int base_bits) {
  const float beta = (float)(1 << base_bits);
  const float beta2 = (float)(1 << (2 * base_bits));
  const float top = __fadd_rn(__fmul_rn(__int2float_rn(hh), beta2),
                              __fmul_rn(__int2float_rn(mid), beta));
  return __fadd_rn(top, __int2float_rn(ll));
}

// raw * t, or fma(raw, t, b): t = s_row * s_col rounded first.
__device__ __forceinline__ float dequant(float raw, float s_row, float s_col,
                                         const float* bias, int col) {
  const float t = __fmul_rn(s_row, s_col);
  return bias ? __fmaf_rn(raw, t, bias[col]) : __fmul_rn(raw, t);
}

__device__ __forceinline__ int pack4(int a, int b, int c, int d) {
  const unsigned u = ((unsigned)a & 0xffu) | (((unsigned)b & 0xffu) << 8) |
                     (((unsigned)c & 0xffu) << 16) |
                     (((unsigned)d & 0xffu) << 24);
  return (int)u;
}

// The mid partial from the accumulators (Karatsuba: sum - hh - ll), in
// two's-complement wrap-around like the reference's int32 arithmetic.
template <bool KARATSUBA>
__device__ __forceinline__ int mid_of(int hh, int x, int ll) {
  return KARATSUBA ? (int)((unsigned)x - (unsigned)hh - (unsigned)ll) : x;
}

}  // namespace limb

#define LIMB_EXPORT_ERROR_STRING                                   \
  extern "C" const char* kernel_error_string(int code) {           \
    return cudaGetErrorString(static_cast<cudaError_t>(code));     \
  }
