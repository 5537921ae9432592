// Integer Winograd F(2x2, 3x3) convolution on Hopper's int8 tensor cores,
// limb substrate.
//
// Replaces: src/repro/kernels/conv2d/winograd.py:_winograd_kernel
// (conv2d_winograd_raw).  Per 4x4 input tile: quantize with the tile's
// scale (rint(x / s), clipped), split into balanced limb planes, transform
// each plane with BT.d.B (|V| <= 4h, h = 2^(b-1)); contract the 16 Winograd
// points against the pre-transformed weight planes U = G2.g.G2t (|U| <=
// 9h) over the full Cin into the int32 hh, mid and ll partials (Karatsuba:
// hh, ll and the (Vh+Vl)(Uh+Ul) sum pass; schoolbook: the cross products);
// push the three partials through the integer inverse At.m.A; one f32
// recombine; epilogue fma(raw, s_tile * wscale/4, bias).  The engine
// computes exactly 4x the convolution (two G2 = 2G factors) and the 1/4 is
// folded into the per-channel scale by the caller -- an exact exponent
// shift.  winograd_accum_bound keeps every result in int32.
//
// What bounds it on this card: the pointwise products -- 16 points x tiles
// x Cin x Cout, 3 or 4 int16 x int16 passes each -- against the int8
// tensor cores (1,979 TOP/s).  The transformed planes do not fit int8
// (|V| <= 512, |U| <= 1152, Karatsuba's sums |Vh+Vl| <= 8h, |Uh+Ul| <=
// 18h = 1152 at b = 7), so every plane splits once more into two balanced
// int8 sub-digits of base 2^7, X = 128 X1 + X0 with |X0| <= 64, |X1| <= 9,
// and each int16 pass becomes four int8 MMAs (sub-level schoolbook: X1Y1,
// X1Y0 + X0Y1 into one accumulator, X0Y0), recombined by shifts in int32:
// (s11 << 14) + (s1x << 7) + s00.  That is exact mod 2^32, and the true
// results lie within winograd_accum_bound < 2^31, so the int32 values are
// the plain version's.
// What the design does about it:
//   * a first kernel splits the weight's U planes into packed sub-digit
//     K-quads once per call (pack_u_kernel), so a (chunk, point) step's B
//     tile is whole quad rows that land by 16-byte cp.async through a
//     4-stage ring (conv_mma.cuh load_b);
//   * one block owns 16 tiles (flattened over the batch) x 128 output
//     channels, eight warps of 16 x 16; per 32-channel chunk all threads
//     quantize (lmma::quantize_rcp: the IEEE quotient from the tile's
//     correctly rounded reciprocal), split, transform and sub-split each
//     (tile, channel) ONCE for all 16 points and all 128 channels into
//     shared memory (two buffers: the next chunk's while this one's MMAs
//     run), rows XOR-swizzled so the fragment loads are conflict-free;
//   * each point's contraction over the chunk folds straight into the
//     inverse transform (12 int32 sums per output; a point row's AT signs
//     at run time, a column's at compile time, so four unrolled points and
//     no dynamic register indexing), so nothing but the final f32 output
//     goes back to device memory;
//   * where the grid leaves its waves mostly empty (AlexNet conv3/conv4
//     at batch 16: 147 blocks on 132 SMs) the chunks split over grid.z
//     (winograd_plan in kernels/conv2d/winograd.py) and the splits add
//     their 12 sums per output into a scratch by integer atomics -- exact
//     in any order -- which a second kernel recombines.
#include "conv_mma.cuh"

namespace {

constexpr int BM = 16;       // Winograd tiles per block: one m16 MMA tile
constexpr int BN = 128;      // output channels per block
constexpr int KC = 32;       // input channels per chunk: one MMA depth
constexpr int KQC = KC / 4;  // K quads per chunk
constexpr int WARPS = BN / 16, THREADS = 32 * WARPS;  // 8 warps x 16 cols
constexpr int STAGES = 4;
constexpr int PB_LD = BN + 8;
constexpr int SUB_BITS = 7;  // the sub-digit base 2^7
constexpr int POINTS = 16;

// Sub-digit planes: per outer plane (h, l and, for Karatsuba, h + l) its
// X1 and X0.  A holds one chunk for all 16 points, [point][plane][K
// quad][row]; a ring stage one (chunk, point) step of B, [plane][K
// quad][PB_LD words].
template <bool KARATSUBA>
struct Planes {
  static constexpr int OUTER = KARATSUBA ? 3 : 2;
  static constexpr int P = 2 * OUTER;
  static constexpr int A_WORDS = POINTS * P * KQC * BM;
  static constexpr int STAGE = P * KQC * PB_LD * 4;
  static constexpr int SMEM = 2 * A_WORDS * 4 + STAGES * STAGE + BM * 20;
};

// The row of tile `row` in quad `q` of an A plane: an XOR swizzle that
// keeps the fragment loads (rows g, g + 8 of quads t, t + 4) and the
// chunk's stores on distinct banks.
__device__ __forceinline__ int swz(int q, int row) {
  return row ^ ((q & 2) << 2);
}

struct WArgs {
  const float* X;
  const uint32_t* Up;  // the U planes' packed sub-digits (pack_u_kernel)
  const float* s_tile;
  const float* wscale4;
  const float* bias;
  float* out;
  int H, W, cin, cout, pad_t, pad_l, th, tw, ho, wo, qmax, base_bits;
  int tiles;      // n * th * tw
  int k4p, coutp;
  int* acc;       // split K: the (12, tiles, cout) int32 sums, else NULL
  int per_split;  // chunks per split (blockIdx.z)
};

// AT = [[1, 1, 1, 0], [0, 1, -1, -1]]
__host__ __device__ constexpr int at_coef(int a, int u) {
  return a == 0 ? (u < 3 ? 1 : 0) : (u == 0 ? 0 : (u == 1 ? 1 : -1));
}

// v = BT . d . B for one row-major 4x4 plane, BT = [[1,0,-1,0], [0,1,1,0],
// [0,-1,1,0], [0,1,0,-1]].  Exact: |v| <= 4 |d|.
__device__ __forceinline__ void input_transform(const int d[16], int v[16]) {
  int t[16];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    t[0 * 4 + j] = d[0 * 4 + j] - d[2 * 4 + j];
    t[1 * 4 + j] = d[1 * 4 + j] + d[2 * 4 + j];
    t[2 * 4 + j] = d[2 * 4 + j] - d[1 * 4 + j];
    t[3 * 4 + j] = d[1 * 4 + j] - d[3 * 4 + j];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[i * 4 + 0] = t[i * 4 + 0] - t[i * 4 + 2];
    v[i * 4 + 1] = t[i * 4 + 1] + t[i * 4 + 2];
    v[i * 4 + 2] = t[i * 4 + 2] - t[i * 4 + 1];
    v[i * 4 + 3] = t[i * 4 + 1] - t[i * 4 + 3];
  }
}

// The weight's sub-digit planes, once per call: Up[point][plane][K
// quad][n], the four channels of a quad packed as int8 lanes; channels past
// cin (to a whole chunk) and columns past cout are zeros.
template <bool KARATSUBA>
__global__ void pack_u_kernel(const int16_t* __restrict__ UH,
                              const int16_t* __restrict__ UL,
                              uint32_t* __restrict__ Up, int cin, int cout,
                              int k4p, int coutp) {
  constexpr int P = Planes<KARATSUBA>::P;
  const long long total = (long long)POINTS * k4p * coutp;
  const size_t ps = (size_t)k4p * coutp;  // words per plane
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const int n = (int)(i % coutp);
    const int k4 = (int)((i / coutp) % k4p);
    const int pt = (int)(i / ((long long)coutp * k4p));
    int d[P][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = 4 * k4 + j;
      const bool ok = c < cin && n < cout;
      const size_t at = ((size_t)pt * cin + c) * cout + n;
      const int uh = ok ? (int)UH[at] : 0, ul = ok ? (int)UL[at] : 0;
      limb::balanced_split(uh, SUB_BITS, d[0][j], d[1][j]);
      limb::balanced_split(ul, SUB_BITS, d[2][j], d[3][j]);
      if constexpr (KARATSUBA)
        limb::balanced_split(uh + ul, SUB_BITS, d[4][j], d[5][j]);
    }
    uint32_t* row = Up + (size_t)pt * P * ps + (size_t)k4 * coutp + n;
#pragma unroll
    for (int p = 0; p < P; ++p)
      row[p * ps] = (uint32_t)limb::pack4(d[p][0], d[p][1], d[p][2], d[p][3]);
  }
}

// Row tables in shared memory: each tile's image (-1: past the grid), the
// output origin (2 ty, 2 tx), its scale and the scale's reciprocal.
struct Tables {
  float *sc, *rc;
  int *img, *oy, *ox;
};

// The (tile, channel) items of a chunk per thread.
constexpr int ITEMS = BM * KC / THREADS;

// Quantizes, splits, transforms and sub-splits item j of this thread in
// the chunk of channels c0 .. c0 + KC - 1 into the A planes: item
// (tile m, channel k), a warp's 32 lanes on one tile's 32 channels.
template <bool KARATSUBA>
__device__ __forceinline__ void prep_item(const WArgs& a, const Tables& tb,
                                          int c0, int j, uint8_t* A) {
  constexpr int P = Planes<KARATSUBA>::P;
  constexpr int PLANE = KQC * BM * 4;  // bytes per (point, plane)
  {
    const int item = threadIdx.x + j * THREADS;
    const int m = item / KC, k = item % KC, c = c0 + k;
    const int img = tb.img[m];
    int dh[16], dl[16];
    if (img >= 0 && c < a.cin) {
      const float s = tb.sc[m], rc = tb.rc[m];
      const float* x = a.X + (size_t)img * a.H * a.W * a.cin + c;
      const int y0 = tb.oy[m] - a.pad_t, x0 = tb.ox[m] - a.pad_l;
      float xv[16];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int iy = y0 + u, ix = x0 + v;
          xv[4 * u + v] =
              ((unsigned)iy < (unsigned)a.H && (unsigned)ix < (unsigned)a.W)
                  ? x[((size_t)iy * a.W + ix) * a.cin]
                  : 0.0f;
        }
#pragma unroll
      for (int e = 0; e < 16; ++e)
        limb::balanced_split(lmma::quantize_rcp(xv[e], s, rc, a.qmax),
                             a.base_bits, dh[e], dl[e]);
    } else {
#pragma unroll
      for (int e = 0; e < 16; ++e) dh[e] = dl[e] = 0;
    }
    int vh[16], vl[16];
    input_transform(dh, vh);
    input_transform(dl, vl);
    const int q = k >> 2;
    uint8_t* dst = A + (q * BM + swz(q, m)) * 4 + (k & 3);
#pragma unroll
    for (int pt = 0; pt < POINTS; ++pt) {
      int x1, x0;
      uint8_t* d = dst + pt * P * PLANE;
      limb::balanced_split(vh[pt], SUB_BITS, x1, x0);
      d[0] = (uint8_t)x1;
      d[PLANE] = (uint8_t)x0;
      limb::balanced_split(vl[pt], SUB_BITS, x1, x0);
      d[2 * PLANE] = (uint8_t)x1;
      d[3 * PLANE] = (uint8_t)x0;
      if (KARATSUBA) {
        limb::balanced_split(vh[pt] + vl[pt], SUB_BITS, x1, x0);
        d[4 * PLANE] = (uint8_t)x1;
        d[5 * PLANE] = (uint8_t)x0;
      }
    }
  }
}

// The A fragment of sub-digit plane `pl` of one point: rows g, g + 8 of
// quads t4 and 4 + t4 (both swizzled alike).
__device__ __forceinline__ void frag_a(const uint32_t* plane, int g, int t4,
                                       uint32_t (&f)[4]) {
  const int s = (t4 & 2) << 2;
  f[0] = plane[t4 * BM + (g ^ s)];
  f[1] = plane[t4 * BM + ((g + 8) ^ s)];
  f[2] = plane[(4 + t4) * BM + (g ^ s)];
  f[3] = plane[(4 + t4) * BM + ((g + 8) ^ s)];
}

__device__ __forceinline__ void mma(int (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  lmma::mma(d, a[0], a[1], a[2], a[3], b[0], b[1]);
}

// One int16-level product, A outer plane oa times B outer plane ob, as
// four int8 MMAs into the sub-accumulators of the warp's two n8 tiles.
struct Sub {
  int s11[2][4], s1x[2][4], s00[2][4];
};
__device__ __forceinline__ void sub_pass(const uint32_t* A, const uint32_t* pb,
                                         int oa, int ob, int col0, int g,
                                         int t4, Sub& acc) {
  constexpr int PLANE = KQC * BM;  // words
  uint32_t a1[4], a0[4];
  frag_a(A + (2 * oa) * PLANE, g, t4, a1);
  frag_a(A + (2 * oa + 1) * PLANE, g, t4, a0);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const uint32_t* q = pb + t4 * PB_LD + col0 + 8 * i + g;
    const uint32_t* q1 = q + (2 * ob) * KQC * PB_LD;
    const uint32_t* q0 = q + (2 * ob + 1) * KQC * PB_LD;
    const uint32_t b1[2] = {q1[0], q1[4 * PB_LD]};
    const uint32_t b0[2] = {q0[0], q0[4 * PB_LD]};
    mma(acc.s11[i], a1, b1);
    mma(acc.s1x[i], a1, b0);
    mma(acc.s1x[i], a0, b1);
    mma(acc.s00[i], a0, b0);
  }
}

// The sub-accumulators recombined by shifts: (s11 << 14) + (s1x << 7) +
// s00, mod 2^32; they restart from zero.
__device__ __forceinline__ void recombine_sub(Sub& acc, int (&r)[2][4]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      r[i][e] = (int)(((unsigned)acc.s11[i][e] << (2 * SUB_BITS)) +
                      ((unsigned)acc.s1x[i][e] << SUB_BITS) +
                      (unsigned)acc.s00[i][e]);
      acc.s11[i][e] = acc.s1x[i][e] = acc.s00[i][e] = 0;
    }
}

// y[limb][o] += SIGN * AT(o, point) * r for the outputs o = (a, b) of a
// tile, point (u, V): ca[a] = AT[a][u] of the row (a runtime value), AT[b][V]
// a compile-time one.
template <int V, int SIGN>
__device__ __forceinline__ void fold(int (&y)[4][2][4], const int (&ca)[2],
                                     const int (&r)[2][4]) {
#pragma unroll
  for (int b = 0; b < 2; ++b) {
    constexpr int cb[2] = {at_coef(0, V), at_coef(1, V)};
    if (cb[b] == 0) continue;
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const unsigned c = (unsigned)(SIGN * cb[b] * ca[a]);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          y[2 * a + b][i][e] =
              (int)((unsigned)y[2 * a + b][i][e] + c * (unsigned)r[i][e]);
    }
  }
}

// Point (u, V)'s contraction over one chunk, folded into the inverse
// transform: Karatsuba y_hh += hh, y_ll += ll, y_mid += x - hh - ll;
// schoolbook y_mid += hl + lh.  Ap: the point's A planes.
template <bool KARATSUBA, int V>
__device__ __forceinline__ void point_mma(const uint32_t* Ap,
                                          const uint32_t* pb,
                                          const int (&ca)[2], int col0,
                                          int g, int t4,
                                          int (&y)[3][4][2][4]) {
  Sub acc = {};
  int r[2][4];
  sub_pass(Ap, pb, 0, 0, col0, g, t4, acc);  // hh
  recombine_sub(acc, r);
  fold<V, 1>(y[0], ca, r);
  if (KARATSUBA) fold<V, -1>(y[1], ca, r);
  sub_pass(Ap, pb, 1, 1, col0, g, t4, acc);  // ll
  recombine_sub(acc, r);
  fold<V, 1>(y[2], ca, r);
  if (KARATSUBA) fold<V, -1>(y[1], ca, r);
  if (KARATSUBA) {
    sub_pass(Ap, pb, 2, 2, col0, g, t4, acc);  // (h + l)(h + l)
  } else {
    sub_pass(Ap, pb, 0, 1, col0, g, t4, acc);  // hl + lh
    sub_pass(Ap, pb, 1, 0, col0, g, t4, acc);
  }
  recombine_sub(acc, r);
  fold<V, 1>(y[1], ca, r);
}

// Issues the block's step s's copies: the B tile of (chunk c_first +
// s / 16, point s % 16).
template <bool KARATSUBA>
__device__ __forceinline__ void load_step(const WArgs& a, char* ring, int s,
                                          int c_first, int n0) {
  constexpr int P = Planes<KARATSUBA>::P;
  const int chunk = c_first + s / POINTS, pt = s % POINTS;
  cmma::load_b<P, KQC, BN, PB_LD, THREADS>(
      reinterpret_cast<uint32_t*>(ring + (s % STAGES) *
                                             Planes<KARATSUBA>::STAGE),
      a.Up + ((size_t)pt * P * a.k4p + chunk * KQC) * a.coutp, a.Up, a.k4p,
      a.coutp, n0);
}

// The block's step (chunk c_first + lc, point 4 u + V) of nlc chunks:
// waits for its B tile, issues the copy STAGES - 1 steps ahead and runs
// the point.  The next chunk's A planes are prepared into the other buffer
// (free since the barrier of this chunk's first step), item j at the first
// point of row 2 j, so the CUDA cores' share spreads over two steps.
template <bool KARATSUBA, int V>
__device__ __forceinline__ void point_step(const WArgs& a, const Tables& tb,
                                           uint32_t* A, char* ring,
                                           int c_first, int lc, int nlc,
                                           int u, const int (&ca)[2], int n0,
                                           int col0, int g, int t4,
                                           int (&y)[3][4][2][4]) {
  using PL = Planes<KARATSUBA>;
  const int pt = 4 * u + V, s = lc * POINTS + pt;
  lmma::cp_async_wait<STAGES - 2>();
  __syncthreads();  // step s landed; the MMAs of step s - 1 are done
  if (s + STAGES - 1 < nlc * POINTS)
    load_step<KARATSUBA>(a, ring, s + STAGES - 1, c_first, n0);
  lmma::cp_async_commit();
  point_mma<KARATSUBA, V>(
      A + (lc & 1) * PL::A_WORDS + pt * PL::P * KQC * BM,
      reinterpret_cast<const uint32_t*>(ring + (s % STAGES) * PL::STAGE), ca,
      col0, g, t4, y);
  if (V == 0 && (u & 1) == 0 && lc + 1 < nlc)
    prep_item<KARATSUBA>(
        a, tb, (c_first + lc + 1) * KC, u / 2,
        reinterpret_cast<uint8_t*>(A + ((lc + 1) & 1) * PL::A_WORDS));
}

// One output tile's f32 values: ONE recombine of each output's three
// inverse-transformed sums, then fma(raw, s_tile * wscale/4, bias).
__device__ __forceinline__ void store_tile(const WArgs& a, int img, int oy0,
                                           int ox0, float s, int gn,
                                           const int (&hh)[4],
                                           const int (&mid)[4],
                                           const int (&ll)[4]) {
#pragma unroll
  for (int o = 0; o < 4; ++o) {
    const int oy = oy0 + o / 2, ox = ox0 + o % 2;
    if (oy >= a.ho || ox >= a.wo) continue;
    const float raw = limb::recombine(hh[o], mid[o], ll[o], a.base_bits);
    a.out[(((size_t)img * a.ho + oy) * a.wo + ox) * a.cout + gn] =
        limb::dequant(raw, s, a.wscale4[gn], a.bias, gn);
  }
}

template <bool KARATSUBA>
__global__ void __launch_bounds__(THREADS, 1)
    winograd_kernel(const WArgs a) {
  using PL = Planes<KARATSUBA>;
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  uint32_t* A = reinterpret_cast<uint32_t*>(smem);
  char* ring = smem + 2 * PL::A_WORDS * 4;
  Tables tb;
  tb.sc = reinterpret_cast<float*>(ring + STAGES * PL::STAGE);
  tb.rc = tb.sc + BM;
  tb.img = reinterpret_cast<int*>(tb.rc + BM);
  tb.oy = tb.img + BM;
  tb.ox = tb.oy + BM;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int ntiles = a.th * a.tw;

  if (tid < BM) {
    const int m = m0 + tid;
    if (m < a.tiles) {
      const int img = m / ntiles, r = m - img * ntiles, ty = r / a.tw;
      tb.img[tid] = img;
      tb.oy[tid] = 2 * ty;
      tb.ox[tid] = 2 * (r - ty * a.tw);
      tb.sc[tid] = a.s_tile[m];
      tb.rc[tid] = __frcp_rn(tb.sc[tid]);
    } else {
      tb.img[tid] = -1;
      tb.oy[tid] = tb.ox[tid] = 0;
      tb.sc[tid] = tb.rc[tid] = 1.0f;
    }
  }
  __syncthreads();

  // Inverse-transformed partials: [hh, mid, ll][output (a, b) = 2a + b]
  // [n8 tile][fragment element].
  int y[3][4][2][4];
#pragma unroll
  for (int l = 0; l < 3; ++l)
#pragma unroll
    for (int o = 0; o < 4; ++o)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) y[l][o][i][e] = 0;

  // This split's chunks: [c_first, c_first + nlc).
  const int c_first = blockIdx.z * a.per_split;
  const int nlc = min(a.per_split, (a.cin + KC - 1) / KC - c_first);
  const int col0 = warp * 16;
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nlc * POINTS) load_step<KARATSUBA>(a, ring, st, c_first, n0);
    lmma::cp_async_commit();
  }
#pragma unroll 1
  for (int j = 0; j < ITEMS; ++j)
    prep_item<KARATSUBA>(a, tb, c_first * KC, j,
                         reinterpret_cast<uint8_t*>(A));
  static_assert(ITEMS == 2, "items prepared at rows 0 and 2");
  for (int lc = 0; lc < nlc; ++lc) {
#pragma unroll 1
    for (int u = 0; u < 4; ++u) {
      const int ca[2] = {at_coef(0, u), at_coef(1, u)};
      point_step<KARATSUBA, 0>(a, tb, A, ring, c_first, lc, nlc, u, ca, n0,
                               col0, g, t4, y);
      point_step<KARATSUBA, 1>(a, tb, A, ring, c_first, lc, nlc, u, ca, n0,
                               col0, g, t4, y);
      point_step<KARATSUBA, 2>(a, tb, A, ring, c_first, lc, nlc, u, ca, n0,
                               col0, g, t4, y);
      point_step<KARATSUBA, 3>(a, tb, A, ring, c_first, lc, nlc, u, ca, n0,
                               col0, g, t4, y);
    }
  }
  lmma::cp_async_wait<0>();

  const size_t plane = (size_t)a.tiles * a.cout;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int row = g + 8 * (e >> 1), img = tb.img[row];
    if (img < 0) continue;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int gn = n0 + col0 + 8 * i + 2 * t4 + (e & 1);
      if (gn >= a.cout) continue;
      if (a.acc) {  // integer sums: exact in any order
        int* at = a.acc + (size_t)(m0 + row) * a.cout + gn;
#pragma unroll
        for (int l = 0; l < 3; ++l)
#pragma unroll
          for (int o = 0; o < 4; ++o)
            atomicAdd(at + (4 * l + o) * plane, y[l][o][i][e]);
      } else {
        const int hh[4] = {y[0][0][i][e], y[0][1][i][e], y[0][2][i][e],
                           y[0][3][i][e]};
        const int mid[4] = {y[1][0][i][e], y[1][1][i][e], y[1][2][i][e],
                            y[1][3][i][e]};
        const int ll[4] = {y[2][0][i][e], y[2][1][i][e], y[2][2][i][e],
                           y[2][3][i][e]};
        store_tile(a, img, tb.oy[row], tb.ox[row], tb.sc[row], gn, hh, mid,
                   ll);
      }
    }
  }
}

// Split K: the outputs of the summed (12, tiles, cout) sums.
__global__ void finish_kernel(const WArgs a) {
  const size_t plane = (size_t)a.tiles * a.cout;
  const int ntiles = a.th * a.tw;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < plane;
       i += (size_t)gridDim.x * blockDim.x) {
    const int m = (int)(i / a.cout), gn = (int)(i - (size_t)m * a.cout);
    const int img = m / ntiles, r = m - img * ntiles, ty = r / a.tw;
    int v[3][4];
#pragma unroll
    for (int l = 0; l < 3; ++l)
#pragma unroll
      for (int o = 0; o < 4; ++o) v[l][o] = a.acc[(4 * l + o) * plane + i];
    store_tile(a, img, 2 * ty, 2 * (r - ty * a.tw), a.s_tile[m], gn, v[0],
               v[1], v[2]);
  }
}

template <bool KARATSUBA>
cudaError_t launch(dim3 grid_dim, cudaStream_t st, const WArgs& a) {
  auto* kern = winograd_kernel<KARATSUBA>;
  static_assert(Planes<KARATSUBA>::SMEM <= 227 * 1024,
                "dynamic shared memory past a Hopper block's 227 KB");
  static bool sized = false;  // one attribute call per instantiation
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Planes<KARATSUBA>::SMEM);
    if (e != cudaSuccess) return e;
    sized = true;
  }
  kern<<<grid_dim, THREADS, Planes<KARATSUBA>::SMEM, st>>>(a);
  return cudaGetLastError();
}

int quads_of(int cin) { return (cin + KC - 1) / KC * KQC; }


// Bytes of the U planes' packed sub-digits in the scratch.
long long pack_bytes(int cin, int cout, bool karatsuba) {
  return (4LL * POINTS * (karatsuba ? 6 : 4) * quads_of(cin) *
              ((cout + 3) / 4 * 4) + 15) / 16 * 16;
}

}  // namespace

LIMB_EXPORT_ERROR_STRING

// Bytes of the scratch winograd_launch needs: the U planes' packed
// sub-digits and, when the chunks split (splits > 1), the (12, tiles,
// cout) int32 sums.
extern "C" long long winograd_scratch(int cin, int cout, int karatsuba,
                                      int tiles, int splits) {
  if (cin < 1 || cout < 1 || tiles < 0 || splits < 1) return 0;
  return pack_bytes(cin, cout, karatsuba != 0) +
         (splits > 1 ? 48LL * tiles * cout : 0);
}

// X (n, H, W, cin) f32 unpadded; UH/UL (16, cin, cout) int16 transformed
// weight planes; s_tile (n, th, tw); wscale4 (cout) = wscale / 4; bias
// (cout) or NULL; out (n, ho, wo, cout) f32.  The plan
// (kernels/conv2d/winograd.py winograd_plan): the chunks of 32 channels
// in `splits` runs of `per_split`.  scratch: winograd_scratch() bytes,
// 16-byte aligned, for the U planes' sub-digits (packed by a first kernel;
// the conv kernel follows it) and the split sums.
extern "C" int winograd_launch(const void* X, const void* UH, const void* UL,
                               const void* s_tile, const void* wscale4,
                               const void* bias, void* out, void* scratch,
                               long long scratch_bytes, int n, int H, int W,
                               int cin, int cout, int pad_t, int pad_l,
                               int th, int tw, int ho, int wo, int qmax,
                               int base_bits, int karatsuba, int splits,
                               int per_split, void* stream) {
  const int tiles = n * th * tw, nch = (cin + KC - 1) / KC;
  if (base_bits < 2 || base_bits > 8 || splits < 1 || per_split < 1 ||
      (long long)per_split * splits < nch ||
      (long long)per_split * (splits - 1) >= nch ||
      scratch_bytes < winograd_scratch(cin, cout, karatsuba, tiles, splits) ||
      reinterpret_cast<uintptr_t>(scratch) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  WArgs a;
  a.X = static_cast<const float*>(X);
  a.Up = static_cast<const uint32_t*>(scratch);
  a.s_tile = static_cast<const float*>(s_tile);
  a.wscale4 = static_cast<const float*>(wscale4);
  a.bias = static_cast<const float*>(bias);
  a.out = static_cast<float*>(out);
  a.H = H;
  a.W = W;
  a.cin = cin;
  a.cout = cout;
  a.pad_t = pad_t;
  a.pad_l = pad_l;
  a.th = th;
  a.tw = tw;
  a.ho = ho;
  a.wo = wo;
  a.qmax = qmax;
  a.base_bits = base_bits;
  a.tiles = tiles;
  a.k4p = quads_of(cin);
  a.coutp = (cout + 3) / 4 * 4;
  a.per_split = per_split;
  a.acc = splits > 1 ? reinterpret_cast<int*>(
                           static_cast<char*>(scratch) +
                           pack_bytes(cin, cout, karatsuba != 0))
                     : nullptr;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a.acc) {
    const cudaError_t e =
        cudaMemsetAsync(a.acc, 0, 48LL * tiles * cout, st);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  {
    const long long words = (long long)POINTS * a.k4p * a.coutp;
    const int blocks =
        (int)((words + 255) / 256 < 4096 ? (words + 255) / 256 : 4096);
    auto* kp = karatsuba ? pack_u_kernel<true> : pack_u_kernel<false>;
    kp<<<blocks, 256, 0, st>>>(static_cast<const int16_t*>(UH),
                               static_cast<const int16_t*>(UL),
                               static_cast<uint32_t*>(scratch), cin, cout,
                               a.k4p, a.coutp);
  }
  const dim3 g((tiles + BM - 1) / BM, (cout + BN - 1) / BN, splits);
  const cudaError_t e = karatsuba ? launch<true>(g, st, a)
                                  : launch<false>(g, st, a);
  if (e != cudaSuccess || !a.acc) return static_cast<int>(e);
  const long long outs = (long long)tiles * cout;
  const int blocks = (int)((outs + 255) / 256 < 8192 ? (outs + 255) / 256
                                                     : 8192);
  finish_kernel<<<blocks, 256, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}
