// Three-pass TF32 products on Hopper's tensor cores (mma.sync m16n8k8).
//
// An f32 operand x is split into two tf32 values, big = tf32(x) and small =
// tf32(x - big), where tf32() is cvt.rna.tf32.f32 (round to nearest, ties
// away from zero, the low 13 bits cleared) and x - big is exact in f32.  A
// product is then a_b b_b + a_b b_s + a_s b_b: each tf32 x tf32 product is
// exact in the MMA, and the dropped a_s b_s term and the rounding of small
// leave ~2^-22 of |a b| -- where one tf32 pass (a_b b_b) is ~2^-11 off.
// Three passes at the TF32 peak (494.7 TFLOP/s dense, published) still run
// ~2.5x the f32 rate of the CUDA cores (67 TFLOP/s).
//
// The sum inside one MMA is not round-to-nearest, so an 8-deep step is
// formed from zero (the two small-term passes first) and added to an f32
// partial with __fadd_rn: the kernels nest their f32 sums as the CUDA-core
// versions did, and no chain of MMA accumulations grows with K.
//
// The K index of every product is permuted the same way in A and B: within
// each 8-deep step, fragment column t holds element 2t and column t + 4
// element 2t + 1.  The MMA sums over K in no particular order anyway, and
// with this order
//   * an MMA's C fragment (row g: columns 2t, 2t + 1; row g + 8: the same)
//     IS the A fragment of the next product over those columns -- P moves
//     from S to P V in registers, with no shuffle and no shared memory;
//   * every operand in shared memory is a "pair quad" (uint4): the big
//     and small parts of two neighbours along K, {big(2p), big(2p + 1),
//     small(2p), small(2p + 1)}, one 16-byte load per fragment register
//     pair.  For a K-contiguous matrix (rows x K) quad p of a row holds
//     columns 2p, 2p + 1; for a K-major one (K x cols) quad (p, col) holds
//     rows 2p, 2p + 1 of that column.
// Row strides, in quads, that keep each 8-lane phase of a 16-byte load on
// distinct banks: == 4 (mod 8) where lanes differ by row g and quad t
// (A, and B read N-major), == 2 (mod 8) where they differ by pair t and
// column g (B read K-major).
#pragma once

#include <stdint.h>

namespace tf32x3 {

// cvt.rna.tf32.f32, the low 13 bits cleared.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r & 0xffffe000u;
}

// The pair quad of two neighbours along K.
__device__ __forceinline__ uint4 pair_quad(float x0, float x1) {
  const uint32_t b0 = to_tf32(x0), b1 = to_tf32(x1);
  return make_uint4(b0, b1, to_tf32(__fsub_rn(x0, __uint_as_float(b0))),
                    to_tf32(__fsub_rn(x1, __uint_as_float(b1))));
}

// An A fragment (16 rows x one 8-deep step), big and small parts.
struct FragA {
  uint32_t big[4], small[4];
};

// A from pair quads: `base` points at (the tile's first row, the step's
// first quad); rows g and g + 8, quad t.
__device__ __forceinline__ FragA load_a(const uint4* base, int ld, int g,
                                        int t) {
  const uint4 lo = base[g * ld + t], hi = base[(g + 8) * ld + t];
  return {{lo.x, hi.x, lo.y, hi.y}, {lo.z, hi.z, lo.w, hi.w}};
}

// A from an MMA's C fragment (c0, c1: row g; c2, c3: row g + 8).
__device__ __forceinline__ FragA frag_from_c(const float (&c)[4]) {
  FragA a;
  const int src[4] = {0, 2, 1, 3};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float x = c[src[i]];
    a.big[i] = to_tf32(x);
    a.small[i] = to_tf32(__fsub_rn(x, __uint_as_float(a.big[i])));
  }
  return a;
}

// d += a * b: one m16n8k8 TF32 MMA, f32 accumulators.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One 8-deep step from zero against a pair quad of B (b0, b1 big; b0, b1
// small): d = a_s b_b + a_b b_s + a_b b_b, in that order.
__device__ __forceinline__ void step(float (&d)[4], const FragA& a,
                                     const uint4& b) {
  d[0] = d[1] = d[2] = d[3] = 0.0f;
  mma(d, a.small, b.x, b.y);
  mma(d, a.big, b.z, b.w);
  mma(d, a.big, b.x, b.y);
}

// N steps that share A, each d[n] as step(d[n], a, b[n]) bit for bit, the
// passes interleaved across them: N independent MMA chains in flight, for
// a kernel with the registers to hold them.
template <int N>
__device__ __forceinline__ void steps(float (&d)[N][4], const FragA& a,
                                      const uint4 (&b)[N]) {
#pragma unroll
  for (int n = 0; n < N; ++n) d[n][0] = d[n][1] = d[n][2] = d[n][3] = 0.0f;
#pragma unroll
  for (int n = 0; n < N; ++n) mma(d[n], a.small, b[n].x, b[n].y);
#pragma unroll
  for (int n = 0; n < N; ++n) mma(d[n], a.big, b[n].z, b[n].w);
#pragma unroll
  for (int n = 0; n < N; ++n) mma(d[n], a.big, b[n].x, b[n].y);
}

// acc += d, rounded to nearest.
__device__ __forceinline__ void fold(float (&acc)[4], const float (&d)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] = __fadd_rn(acc[i], d[i]);
}

}  // namespace tf32x3
