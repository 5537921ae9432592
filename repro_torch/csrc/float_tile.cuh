// Shared device code of the port's float kernels: the bf16 residual split
// and the limb-pair schedules (the bf16-limb GEMM and the float implicit
// conv both include it).
//
// Arithmetic contract (held to a stated tolerance against the JAX
// reference, which sums in other orders):
//   * the residual split of repro.core.karatsuba.float_split: hi =
//     bf16_rn(x), x -= f32(hi) (exact in f32), ..., last limb bf16_rn(x);
//     __float2bfloat16_rn is round-to-nearest-even, as XLA's convert is;
//   * a bf16 x bf16 product has 16 significant bits, so every pass term
//     __fmaf_rn(a_i, b_j, part) adds an EXACT product into an f32 partial
//     sum; the library is compiled with -fmad=false, so each multiply-add
//     is written as the explicit FMA;
//   * native f32 (schedule F32): no split, one FMA per product;
//   * partial sums nest (a chunk of K entries, then a larger group, then
//     the total), so each f32 add meets a sum of its own size.  At VGG16's
//     shapes (K up to 25088) that keeps the kernels within 1.3e-7..2.7e-7
//     of the largest output from the exact schedule value, while the
//     schedules lie 2.8e-6 or more apart (chip_smoke.py on an H100), so
//     a check against the exact value tells a bf16x3 kernel from a bf16x6
//     or native one.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ftile {

// Limb schedules.  The numbers of BF16X3/X4/X6 are their pass counts; the
// bf16x6 pairs are summed i-major in the GEMM (karatsuba.bf16xn_dot_general)
// and in the implicit kernel's _BF16_PAIRS order (BF16X6_TAP).
enum Schedule { F32 = 0, BF16X3 = 3, BF16X4 = 4, BF16X6 = 6, BF16X6_TAP = 7 };

template <int S>
struct Sched {
  static constexpr int limbs = S == F32 ? 1 : (S == BF16X3 || S == BF16X4) ? 2 : 3;
  static constexpr int pairs = S == F32 ? 1 : S == BF16X3 ? 3 : S == BF16X4 ? 4 : 6;
};

// Limb indices (i of A, j of B) of pair p.
//   BF16X3/X4:  (0,0) (0,1) (1,0) [(1,1)]
//   BF16X6:     (0,0) (0,1) (0,2) (1,0) (1,1) (2,0)
//   BF16X6_TAP: (0,0) (0,1) (1,0) (0,2) (1,1) (2,0)
template <int S>
__host__ __device__ constexpr int pair_a(int p) {
  return S == BF16X6       ? (p < 3 ? 0 : p < 5 ? 1 : 2)
         : S == BF16X6_TAP ? ((p == 2 || p == 4) ? 1 : p == 5 ? 2 : 0)
         : S == F32        ? 0
                           : ((p == 2 || p == 3) ? 1 : 0);
}
template <int S>
__host__ __device__ constexpr int pair_b(int p) {
  return S == BF16X6       ? ((p == 1 || p == 4) ? 1 : p == 2 ? 2 : 0)
         : S == BF16X6_TAP ? ((p == 1 || p == 4) ? 1 : p == 3 ? 2 : 0)
         : S == F32        ? 0
                           : ((p == 1 || p == 3) ? 1 : 0);
}

// x split into Sched<S>::limbs limbs, each held as the f32 value of a bf16.
template <int S>
__device__ __forceinline__ void split(float x, float (&l)[Sched<S>::limbs]) {
  if constexpr (S == F32) {
    l[0] = x;
  } else {
#pragma unroll
    for (int i = 0; i < Sched<S>::limbs - 1; ++i) {
      const float hi = __bfloat162float(__float2bfloat16_rn(x));
      l[i] = hi;
      x = __fsub_rn(x, hi);
    }
    l[Sched<S>::limbs - 1] = __bfloat162float(__float2bfloat16_rn(x));
  }
}

// One K entry's pass terms into a thread's TM x TN accumulators.
template <int S, int TM, int TN>
__device__ __forceinline__ void pass_terms(const float (&a)[Sched<S>::limbs][TM],
                                           const float (&b)[Sched<S>::limbs][TN],
                                           float (&acc)[TM][TN]) {
#pragma unroll
  for (int p = 0; p < Sched<S>::pairs; ++p) {
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j)
        acc[i][j] = __fmaf_rn(a[pair_a<S>(p)][i], b[pair_b<S>(p)][j], acc[i][j]);
  }
}

// acc += part, element by element (one f32 rounding each).
template <int TM, int TN>
__device__ __forceinline__ void add_into(const float (&part)[TM][TN],
                                         float (&acc)[TM][TN]) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j)
      acc[i][j] = __fadd_rn(acc[i][j], part[i][j]);
}

}  // namespace ftile
