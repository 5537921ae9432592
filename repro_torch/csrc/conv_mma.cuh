// Shared device code of the integer convolutions that run their int8
// passes on the tensor cores: implicit_conv.cu, systolic_conv.cu and
// winograd.cu.  On top of limb_mma.cuh (the packed digit split, the byte
// transposes into K-quads, the m16n8k32 s8 MMA, cp.async) it holds
//   * the weight's digit-plane packing, one first kernel per call
//     (pack_weight_kernel, Packing);
//   * the copy of one K step's weight planes into a ring stage (load_b);
//   * the split of one K step's gathered input tile into packed digit
//     planes (split_step: quantizing f32, or int16 taken as it is);
//   * the MMAs of one K step on a warp's 32 x 32 outputs (mma_step);
//   * the multistage cp.async ring that walks the K steps (ring_walk).
// Every piece keeps limb_mma.cuh's arithmetic contract: the three int32
// accumulators hold the same integers, mod 2^32, in any order.
#pragma once

#include "limb_mma.cuh"

namespace cmma {

constexpr int BK = 64;            // input channels per K step: two depths
constexpr int KQ = BK / 4;        // K quads per step
constexpr int A_F32_LD = BK + 4;  // floats per raw input row of a stage
constexpr int A_I16_LD = BK + 8;  // int16 per raw input row of a stage

// The packed weight's geometry (pack_weight_kernel): groups of span_c
// channels, each padded to whole K steps (lp), k4p quads per tap and
// plane, rows of coutp words (cout padded to a multiple of 4, so a row's
// 16-byte copies never run past it).
struct Packing {
  int lp, k4p, coutp;
  Packing(int cin, int cout, int span_c) {
    const int span = span_c < cin ? span_c : cin;
    const int groups = (cin + span - 1) / span;
    const int last = cin - (groups - 1) * span;
    lp = (span + BK - 1) / BK * BK;
    k4p = ((groups - 1) * lp + (last + BK - 1) / BK * BK) / 4;
    coutp = (cout + 3) / 4 * 4;
  }
  long long bytes(int taps, bool karatsuba) const {
    return 4LL * taps * (karatsuba ? 3 : 2) * k4p * coutp;
  }
};

// The weight's digit planes, once per call: Wp[tap][plane][K quad][n], the
// four channels of a quad packed as int8 lanes (the MMA's B fragment
// words).  Each group of span_c channels starts on a BK boundary (its
// quads padded with zeros), so every K step's B tile is KQ whole quad rows.
// A (kh, kw, cin, cout) weight read as taps = 1, cin = kh*kw*cin is the
// flat K of a stem.
template <bool KARATSUBA>
__global__ void pack_weight_kernel(const int16_t* __restrict__ Wt,
                                   uint32_t* __restrict__ Wp, int taps,
                                   int cin, int cout, int span_c, int lp,
                                   int k4p, int coutp, int base_bits) {
  constexpr int P = KARATSUBA ? 3 : 2;
  const long long total = (long long)taps * k4p * coutp;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const int n = (int)(i % coutp);
    const int k4 = (int)((i / coutp) % k4p);
    const int tap = (int)(i / ((long long)coutp * k4p));
    int h[4], l[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kk = 4 * k4 + j, g = kk / lp, off = kk - g * lp;
      const int c = g * span_c + off;
      const bool ok = off < span_c && c < cin && n < cout;
      const int v = ok ? (int)Wt[((size_t)tap * cin + c) * cout + n] : 0;
      limb::balanced_split(v, base_bits, h[j], l[j]);
    }
    uint32_t* row = Wp + (size_t)tap * P * k4p * coutp + (size_t)k4 * coutp + n;
    row[0] = (uint32_t)limb::pack4(h[0], h[1], h[2], h[3]);
    row[(size_t)k4p * coutp] = (uint32_t)limb::pack4(l[0], l[1], l[2], l[3]);
    if (KARATSUBA)
      row[(size_t)2 * k4p * coutp] = (uint32_t)limb::pack4(
          h[0] + l[0], h[1] + l[1], h[2] + l[2], h[3] + l[3]);
  }
}

// Launches pack_weight_kernel over taps x k4p x coutp words.
inline void pack_weight(const int16_t* Wt, uint32_t* Wp, int taps, int cin,
                        int cout, int span_c, const Packing& pk,
                        int base_bits, bool karatsuba, cudaStream_t st) {
  const long long words = (long long)taps * pk.k4p * pk.coutp;
  const int blocks =
      (int)((words + 255) / 256 < 4096 ? (words + 255) / 256 : 4096);
  auto* kp = karatsuba ? pack_weight_kernel<true> : pack_weight_kernel<false>;
  kp<<<blocks, 256, 0, st>>>(Wt, Wp, taps, cin, cout, span_c, pk.lp, pk.k4p,
                             pk.coutp, base_bits);
}

// Copies ROWS quad rows of each of P planes, columns n0 .. n0 + BN - 1,
// into a stage laid out [plane][row][PB_LD words]: plane p's row k is
// rows[(p * plane_rows + k) * coutp + n].  Columns past coutp are
// zero-filled (`any` is a valid address for the skipped copies).
template <int P, int ROWS, int BN, int PB_LD, int THREADS>
__device__ __forceinline__ void load_b(uint32_t* pb, const uint32_t* rows,
                                       const uint32_t* any, int plane_rows,
                                       int coutp, int n0) {
  constexpr int CPR = BN / 4;
  static_assert(THREADS % CPR == 0 && (P * ROWS * CPR) % THREADS == 0,
                "whole copies per thread");
  const int tid = threadIdx.x;
  const int u = tid % CPR, n = n0 + 4 * u;
  const bool ok = n < coutp;
#pragma unroll
  for (int i = 0; i < P * ROWS * CPR / THREADS; ++i) {
    const int q = tid + i * THREADS, p = q / (ROWS * CPR),
              k = (q / CPR) % ROWS;
    lmma::cp_async16(pb + (p * ROWS + k) * PB_LD + 4 * u,
                     ok ? rows + ((size_t)p * plane_rows + k) * coutp + n
                        : any,
                     ok);
  }
}

// Quantizes (f32 input) or takes as it is (I16) and splits one step's raw
// input tile -- BM rows of BK entries, A_F32_LD / A_I16_LD apart -- into
// digit planes pa[plane][K quad][PA_LD words].  Entries past `nvalid` are
// zeros.  Every item of a thread is on its row r = tid % BM, whose scale s
// and reciprocal rc the caller holds (unused for I16).
template <bool KARATSUBA, bool I16, int BM, int THREADS, int PA_LD>
__device__ __forceinline__ void split_step(const char* base, int nvalid,
                                           float s, float rc, int qmax,
                                           uint32_t* pa,
                                           const lmma::Digits& dg) {
  static_assert(THREADS % BM == 0 && (BM * KQ) % THREADS == 0,
                "whole rows per thread");
  const int r = threadIdx.x % BM;
#pragma unroll
  for (int i = 0; i < BM * KQ / THREADS; ++i) {
    const int k4 = threadIdx.x / BM + i * (THREADS / BM);
    const int live = nvalid - 4 * k4;  // entries of this quad in the step
    uint32_t w01, w23;
    if (I16) {
      const uint2 v = *reinterpret_cast<const uint2*>(
          base + (r * A_I16_LD + 4 * k4) * 2);
      w01 = live >= 2 ? v.x : live == 1 ? (v.x & 0xffffu) : 0u;
      w23 = live >= 4 ? v.y : live == 3 ? (v.y & 0xffffu) : 0u;
    } else {
      const float4 v = *reinterpret_cast<const float4*>(
          base + (r * A_F32_LD + 4 * k4) * 4);
      const int q0 = live > 0 ? lmma::quantize_rcp(v.x, s, rc, qmax) : 0;
      const int q1 = live > 1 ? lmma::quantize_rcp(v.y, s, rc, qmax) : 0;
      const int q2 = live > 2 ? lmma::quantize_rcp(v.z, s, rc, qmax) : 0;
      const int q3 = live > 3 ? lmma::quantize_rcp(v.w, s, rc, qmax) : 0;
      w01 = lmma::lanes2(q0, q1);
      w23 = lmma::lanes2(q2, q3);
    }
    const lmma::Quad q = lmma::row_quad<KARATSUBA>(w01, w23, dg);
    pa[(0 * KQ + k4) * PA_LD + r] = q.h;
    pa[(1 * KQ + k4) * PA_LD + r] = q.l;
    if (KARATSUBA) pa[(2 * KQ + k4) * PA_LD + r] = q.s;
  }
}

// The MMAs of one K step (`depths` of 32 entries) on a warp's 32 x 32
// outputs at rows row0.., columns col0..: two m16 x four n8 tiles, the
// digit planes of A (pa) and B (pb) read in place from shared memory.
template <bool KARATSUBA, int PA_LD, int PB_LD>
__device__ __forceinline__ void mma_step(const uint32_t* pa,
                                         const uint32_t* pb, int depths,
                                         int row0, int col0, int g, int t4,
                                         int (&hh)[2][4][4],
                                         int (&xx)[2][4][4],
                                         int (&ll)[2][4][4]) {
  for (int d = 0; d < depths; ++d) {
    lmma::FragA fa[2];
    lmma::FragB fb[4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = row0 + 16 * j + g;
      const uint32_t* p0 = pa + (8 * d + t4) * PA_LD + r;
      const uint32_t* p1 = p0 + 4 * PA_LD;
      fa[j].h[0] = p0[0];
      fa[j].h[1] = p0[8];
      fa[j].h[2] = p1[0];
      fa[j].h[3] = p1[8];
      fa[j].l[0] = p0[KQ * PA_LD];
      fa[j].l[1] = p0[KQ * PA_LD + 8];
      fa[j].l[2] = p1[KQ * PA_LD];
      fa[j].l[3] = p1[KQ * PA_LD + 8];
      if (KARATSUBA) {
        fa[j].s[0] = p0[2 * KQ * PA_LD];
        fa[j].s[1] = p0[2 * KQ * PA_LD + 8];
        fa[j].s[2] = p1[2 * KQ * PA_LD];
        fa[j].s[3] = p1[2 * KQ * PA_LD + 8];
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int n = col0 + 8 * i + g;
      const uint32_t* q0 = pb + (8 * d + t4) * PB_LD + n;
      const uint32_t* q1 = q0 + 4 * PB_LD;
      fb[i].h[0] = q0[0];
      fb[i].h[1] = q1[0];
      fb[i].l[0] = q0[KQ * PB_LD];
      fb[i].l[1] = q1[KQ * PB_LD];
      if (KARATSUBA) {
        fb[i].s[0] = q0[2 * KQ * PB_LD];
        fb[i].s[1] = q1[2 * KQ * PB_LD];
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        lmma::passes<KARATSUBA>(fa[j], fb[i], hh[j][i], xx[j][i], ll[j][i]);
  }
}

// The K walk over a ring of STAGES cp.async stages: load(s, live) issues
// step s's copies into stage s % STAGES, mma(s) runs step s's MMAs,
// retire(s) what follows them (a fold), and split(s, live) turns step s's
// landed input into digit planes (one step ahead of the MMAs, into the
// other of two plane buffers).  load and split are called for every step
// index in order, `live` false past the last step (so a caller's walk
// position advances unconditionally); one barrier per step.  A stage is
// reloaded one step after its MMAs.
template <int STAGES, class Load, class Split, class Mma, class Retire>
__device__ __forceinline__ void ring_walk(int nst, Load&& load,
                                          Split&& split, Mma&& mma,
                                          Retire&& retire) {
  static_assert(STAGES >= 3, "a step splits one ahead of its MMAs");
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    load(st, st < nst);
    lmma::cp_async_commit();
  }
  lmma::cp_async_wait<STAGES - 2>();
  __syncthreads();
  split(0, true);
  for (int s = 0; s < nst; ++s) {
    // Groups committed: STAGES - 1 + s; steps 0..s+1 must have landed.
    lmma::cp_async_wait<STAGES - 3>();
    __syncthreads();  // planes of s ready; step s+1 landed; the MMAs of
                      // s-1 are done, so its stage and planes are free
    load(s + STAGES - 1, s + STAGES - 1 < nst);
    lmma::cp_async_commit();
    mma(s);
    retire(s);
    // Split the next step while the tensor cores run this one's MMAs (the
    // retire touches no stage or plane buffer; of the orders tried, this
    // one ran the implicit conv fastest on an H100).
    split(s + 1, s + 1 < nst);
  }
  lmma::cp_async_wait<0>();
}

}  // namespace cmma
