// Shared device code of the limb kernels that run their int8 passes on the
// tensor cores (kom_matmul.cu, implicit_conv.cu): the balanced digit split of
// two int16 lanes at once, the byte transposes into the packed K-quads of
// the mma.sync fragments, the m16n8k32 s8 MMA and the pass schedule.
//
// Arithmetic contract: the same as limb_tile.cuh (balanced digits, three
// int32 accumulators, one f32 recombine, the same epilogues).  The MMA sums
// int8 x int8 products exactly into s32 accumulators with two's-complement
// wrap-around (no .satfinite), so the accumulators hold the same integers,
// mod 2^32, in any summation order.
//
// Fragment layouts of mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32, for
// lane = 4 * g + t (g = groupID 0..7, t = threadID_in_group 0..3): A (16 x
// 32, row) a0 = row g, K 4t..4t+3; a1 = row g+8, K 4t..; a2 = row g, K
// 16+4t..; a3 = row g+8, K 16+4t..; B (32 x 8, col) b0 = K 4t..4t+3 of
// column g, b1 = K 16+4t.. of column g; every register holds four K entries
// as int8 lanes, K 4t in byte 0.  D (16 x 8) d0, d1 = row g, columns 2t,
// 2t+1; d2, d3 = row g+8.  That is the packing of limb::Tiles: four
// consecutive K entries of one row or column per 32-bit word.
#pragma once

#include "limb_tile.cuh"

namespace lmma {

// Per-call constants of the balanced split with base b (b <= 8), repeated
// in both 16-bit lanes: h = 2^(b-1), the low-digit mask beta - 1, and
// 256 - h, which biases the low digit into [0, 256) so nothing carries
// from lane 0 into lane 1.
struct Digits {
  uint32_t half2, mask2, bias2;
  int bits;
  __device__ __forceinline__ explicit Digits(int base_bits)
      : bits(base_bits) {
    const uint32_t h = 1u << (base_bits - 1);
    half2 = h * 0x00010001u;
    mask2 = ((1u << base_bits) - 1) * 0x00010001u;
    bias2 = (256u - h) * 0x00010001u;
  }
};

// The digits of the two int16 lanes of w: byte 0 holds lane 0's digit,
// byte 2 lane 1's (bytes 1 and 3 are not defined).
//   lo = ((x & (beta-1)) ^ h) - h, the balanced low digit, whose low byte is
//        that of ((x & (beta-1)) ^ h) + 256 - h;
//   hi = (x + (x & h)) >> b: adding x's bit b-1 rounds the shift to the
//        balanced high digit; a carry out of lane 0 adds 1 to lane 1's bit 0,
//        where the sum's low b bits are below h, so it never reaches bit b;
//   s  = hi + lo (Karatsuba's digit sum), from hi's two clean bytes.
struct Split2 {
  uint32_t h, l, s;
};
template <bool SUM>
__device__ __forceinline__ Split2 split2(uint32_t w, const Digits& d) {
  Split2 r;
  r.l = ((w & d.mask2) ^ d.half2) + d.bias2;
  r.h = (w + (w & d.half2)) >> d.bits;
  r.s = SUM ? (r.h & 0x00ff00ffu) + r.l : 0u;
  return r;
}

// Two int32 values |v| < 2^15 as the two int16 lanes of one word.
__device__ __forceinline__ uint32_t lanes2(int v0, int v1) {
  return __byte_perm((uint32_t)v0, (uint32_t)v1, 0x5410);
}

// One row's K-quad from two split words (K k, k+1) and (k+2, k+3).
__device__ __forceinline__ uint32_t quad_of_row(uint32_t w01, uint32_t w23) {
  return __byte_perm(w01, w23, 0x6420);
}

// Four rows' split words of one column pair (n, n+1), rows K k..k+3: the
// K-quads of column n and of column n+1.
__device__ __forceinline__ void quads_of_cols(uint32_t r0, uint32_t r1,
                                              uint32_t r2, uint32_t r3,
                                              uint32_t& n0, uint32_t& n1) {
  const uint32_t p01 = __byte_perm(r0, r1, 0x6240);
  const uint32_t p23 = __byte_perm(r2, r3, 0x6240);
  n0 = __byte_perm(p01, p23, 0x5410);
  n1 = __byte_perm(p01, p23, 0x7632);
}

// The digit-plane quads (hi, lo, hi+lo) of one row's four K entries.
struct Quad {
  uint32_t h, l, s;
};
template <bool SUM>
__device__ __forceinline__ Quad row_quad(uint32_t w01, uint32_t w23,
                                         const Digits& d) {
  const Split2 a = split2<SUM>(w01, d), b = split2<SUM>(w23, d);
  return {quad_of_row(a.h, b.h), quad_of_row(a.l, b.l),
          SUM ? quad_of_row(a.s, b.s) : 0u};
}

// The digit-plane quads of columns n and n+1 from four rows' words.
template <bool SUM>
__device__ __forceinline__ void col_quads(const uint32_t (&w)[4],
                                          const Digits& d, Quad& q0,
                                          Quad& q1) {
  Split2 s[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) s[j] = split2<SUM>(w[j], d);
  quads_of_cols(s[0].h, s[1].h, s[2].h, s[3].h, q0.h, q1.h);
  quads_of_cols(s[0].l, s[1].l, s[2].l, s[3].l, q0.l, q1.l);
  if (SUM) quads_of_cols(s[0].s, s[1].s, s[2].s, s[3].s, q0.s, q1.s);
}

// d += A(16 x 32, s8) * B(32 x 8, s8), s32 accumulators, wrapping.
__device__ __forceinline__ void mma(int (&d)[4], uint32_t a0, uint32_t a1,
                                    uint32_t a2, uint32_t a3, uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// A fragment (per plane) and B fragment (per plane) of one MMA tile.
struct FragA {
  uint32_t h[4], l[4], s[4];
};
struct FragB {
  uint32_t h[2], l[2], s[2];
};

// The passes of one MMA tile into the accumulators hh, x, ll: Karatsuba
// hh += Ah Bh, ll += Al Bl, x += (Ah+Al)(Bh+Bl); schoolbook x += Ah Bl +
// Al Bh.
template <bool KARATSUBA>
__device__ __forceinline__ void passes(const FragA& a, const FragB& b,
                                       int (&hh)[4], int (&x)[4],
                                       int (&ll)[4]) {
  mma(hh, a.h[0], a.h[1], a.h[2], a.h[3], b.h[0], b.h[1]);
  mma(ll, a.l[0], a.l[1], a.l[2], a.l[3], b.l[0], b.l[1]);
  if (KARATSUBA) {
    mma(x, a.s[0], a.s[1], a.s[2], a.s[3], b.s[0], b.s[1]);
  } else {
    mma(x, a.h[0], a.h[1], a.h[2], a.h[3], b.l[0], b.l[1]);
    mma(x, a.l[0], a.l[1], a.l[2], a.l[3], b.h[0], b.h[1]);
  }
}

// limb::quantize's clip(rint(x / s), +-qmax) with the same IEEE quotient
// at three full-rate float operations, from rc = RN(1/s) (__frcp_rn, once
// per scale): q = RN(x rc) lies within an ulp of x / s, and Markstein's
// correction RN(q + RN(x - q s) rc) is then the correctly rounded quotient
// (Markstein's theorem; no term underflows where the integer can be
// nonzero: |x| >= s/2 with s >= 1e-12 / qmax).  The division it replaces
// expands to a longer sequence with a slow-path branch per element.
__device__ __forceinline__ int quantize_rcp(float x, float s, float rc,
                                            int qmax) {
  const float q = __fmul_rn(x, rc);
  const float e = __fmaf_rn(-s, q, x);
  float r = rintf(__fmaf_rn(e, rc, q));
  r = fminf(fmaxf(r, -(float)qmax), (float)qmax);
  return (int)r;
}

// Two's-complement int32 sum (the accumulators wrap as the reference's).
__device__ __forceinline__ int wrap_add(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// 16-byte asynchronous copy; valid == false fills the 16 bytes with zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace lmma
