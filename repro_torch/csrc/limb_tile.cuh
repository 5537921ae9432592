// Shared device code of the port's limb kernels: the balanced digit split,
// the int8 digit-plane tiles in shared memory, the __dp4a pass schedule over
// them, the f32 recombine and the dequant epilogue.
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

// Quantize one activation: clip(rint(x / s), -qmax, qmax) with IEEE division
// and round-half-to-even (never roundf, which rounds halves away from 0).
__device__ __forceinline__ int quantize(float x, float s, int qmax) {
  float r = rintf(__fdiv_rn(x, s));
  r = fminf(fmaxf(r, -(float)qmax), (float)qmax);
  return (int)r;
}

__device__ __forceinline__ int pack4(int a, int b, int c, int d) {
  const unsigned u = ((unsigned)a & 0xffu) | (((unsigned)b & 0xffu) << 8) |
                     (((unsigned)c & 0xffu) << 16) |
                     (((unsigned)d & 0xffu) << 24);
  return (int)u;
}

// Digit planes of one K-step in shared memory: four consecutive K entries of
// a row (of A) or column (of B) packed as int8 lanes of one int, ready for
// __dp4a.  Plane 0 = hi digits, 1 = lo digits, 2 = hi + lo (Karatsuba).
template <int BM, int BN, int BK4>
struct Tiles {
  int a[3][BK4][BM + 1];  // +1: spread the loader's column writes over banks
  int b[3][BK4][BN];
};

template <int BM, int BN, int BK4>
__device__ __forceinline__ void store_a(Tiles<BM, BN, BK4>& s, int m, int k4,
                                        const int q[4], int base_bits) {
  int h[4], l[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) balanced_split(q[j], base_bits, h[j], l[j]);
  s.a[0][k4][m] = pack4(h[0], h[1], h[2], h[3]);
  s.a[1][k4][m] = pack4(l[0], l[1], l[2], l[3]);
  s.a[2][k4][m] = pack4(h[0] + l[0], h[1] + l[1], h[2] + l[2], h[3] + l[3]);
}

template <int BM, int BN, int BK4>
__device__ __forceinline__ void store_b(Tiles<BM, BN, BK4>& s, int n, int k4,
                                        const int q[4], int base_bits) {
  int h[4], l[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) balanced_split(q[j], base_bits, h[j], l[j]);
  s.b[0][k4][n] = pack4(h[0], h[1], h[2], h[3]);
  s.b[1][k4][n] = pack4(l[0], l[1], l[2], l[3]);
  s.b[2][k4][n] = pack4(h[0] + l[0], h[1] + l[1], h[2] + l[2], h[3] + l[3]);
}

// One thread's TM x TN outputs at rows ty + i*(BM/TM), cols tx + j*(BN/TN):
// the int8 passes of one K-step into the three int32 accumulators.  For
// Karatsuba `x` accumulates the digit-sum pass; for schoolbook, the mid
// cross terms.
template <int BM, int BN, int BK4, int TM, int TN, bool KARATSUBA>
__device__ __forceinline__ void passes(const Tiles<BM, BN, BK4>& s, int ty,
                                       int tx, int (&hh)[TM][TN],
                                       int (&x)[TM][TN], int (&ll)[TM][TN]) {
#pragma unroll
  for (int k4 = 0; k4 < BK4; ++k4) {
    int ah[TM], al[TM], as[TM], bh[TN], bl[TN], bs[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int m = ty + i * (BM / TM);
      ah[i] = s.a[0][k4][m];
      al[i] = s.a[1][k4][m];
      as[i] = KARATSUBA ? s.a[2][k4][m] : 0;
    }
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = tx + j * (BN / TN);
      bh[j] = s.b[0][k4][n];
      bl[j] = s.b[1][k4][n];
      bs[j] = KARATSUBA ? s.b[2][k4][n] : 0;
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        hh[i][j] = __dp4a(ah[i], bh[j], hh[i][j]);
        ll[i][j] = __dp4a(al[i], bl[j], ll[i][j]);
        if (KARATSUBA) {
          x[i][j] = __dp4a(as[i], bs[j], x[i][j]);
        } else {
          x[i][j] = __dp4a(al[i], bh[j], __dp4a(ah[i], bl[j], x[i][j]));
        }
      }
    }
  }
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
