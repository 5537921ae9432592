// Integer Winograd F(2x2, 3x3) convolution on Hopper, limb substrate.
//
// Replaces: src/repro/kernels/conv2d/winograd.py:_winograd_kernel
// (conv2d_winograd_raw).  Per 4x4 input tile: quantize with the tile's
// scale (rint(x / s), clipped), split into balanced limb planes, transform
// each plane with BT.d.B (|V| <= 4h, h = 2^(b-1)); contract the 16 Winograd
// points against the pre-transformed int16 weight planes U = G2.g.G2t
// (|U| <= 9h) over the full Cin into int32 (Karatsuba: hh, ll and the
// (Vh+Vl)(Uh+Ul) sum pass; schoolbook: the 4 cross products); push the
// three int32 partials through the integer inverse At.m.A; one f32
// recombine; epilogue fma(raw, s_tile * wscale/4, bias).  The engine
// computes exactly 4x the convolution (two G2 = 2G factors) and the 1/4 is
// folded into the per-channel scale by the caller -- an exact exponent
// shift.  winograd_accum_bound keeps every int32 value wrap-free.
//
// What bounds it on this card: the pointwise products -- 16 points x tiles
// x Cin x Cout, 3 or 4 int16 x int16 products each (AlexNet conv3-5: ~1.1 G
// products per image) -- run on the CUDA cores, because the tensor cores
// have no int16 mode and |Vh+Vl| <= 512, |Uh+Ul| <= 1152 do not fit int8.
// What the design does about it: one block owns 32 tiles x 64 output
// channels (tiles flattened over the batch, so a weight stage in shared
// memory serves every image); each input tile is quantized and transformed
// ONCE per 8-channel stage and reused by 64 output channels; the inverse
// transform is folded into registers point by point (12 int32 sums per
// output instead of 48 point partials), so nothing but the final f32
// output goes back to device memory.  Splitting the planes into int8
// sub-digits for the tensor cores is later work.
#include "limb_tile.cuh"

namespace {

constexpr int BM = 32;   // Winograd tiles per block (images x tile grid)
constexpr int BN = 64;   // output channels per block
constexpr int BKC = 8;   // input channels per shared-memory stage
constexpr int TM = 2, TN = 4;
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256
static_assert(BM * BKC == THREADS, "one (tile, channel) transform per thread");
constexpr int V_ELEMS = 2 * 16 * BKC * BM;
constexpr int U_ELEMS = 2 * 16 * BKC * BN;
constexpr int SMEM_BYTES = (V_ELEMS + U_ELEMS) * (int)sizeof(int16_t);

// AT = [[1, 1, 1, 0], [0, 1, -1, -1]]
__device__ __forceinline__ int at_coef(int a, int u) {
  return a == 0 ? (u < 3 ? 1 : 0) : (u == 0 ? 0 : (u == 1 ? 1 : -1));
}

__device__ __forceinline__ int wrap_add(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
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

template <bool KARATSUBA>
__global__ void __launch_bounds__(THREADS) winograd_kernel(
    const float* __restrict__ X, const int16_t* __restrict__ UH,
    const int16_t* __restrict__ UL, const float* __restrict__ s_tile,
    const float* __restrict__ wscale4, const float* __restrict__ bias,
    float* __restrict__ out, int n_img, int H, int W, int cin, int cout,
    int pad_t, int pad_l, int th, int tw, int ho, int wo, int qmax,
    int base_bits) {
  extern __shared__ int16_t smem[];
  int16_t* Vs = smem;            // [plane][point][channel][tile]
  int16_t* Us = smem + V_ELEMS;  // [plane][point][channel][cout]
  __shared__ float s_sc[BM];
  __shared__ int s_img[BM], s_ty[BM], s_tx[BM];
  const int tid = threadIdx.x;
  const int ty = tid / (BN / TN), tx = tid % (BN / TN);
  const int ntiles = th * tw;
  const int M = n_img * ntiles;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;

  if (tid < BM) {
    const int m = m0 + tid;
    if (m < M) {
      const int r = m % ntiles;
      s_img[tid] = m / ntiles;
      s_ty[tid] = r / tw;
      s_tx[tid] = r % tw;
      s_sc[tid] = s_tile[m];
    } else {
      s_img[tid] = -1;
      s_ty[tid] = s_tx[tid] = 0;
      s_sc[tid] = 1.0f;
    }
  }
  __syncthreads();

  // Inverse-transformed partials: [hh, mid, ll][output (a, b) = 2a + b].
  int y[3][4][TM][TN];
#pragma unroll
  for (int l = 0; l < 3; ++l)
#pragma unroll
    for (int o = 0; o < 4; ++o)
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) y[l][o][i][j] = 0;

  for (int c0 = 0; c0 < cin; c0 += BKC) {
    {  // quantize + split + BT.d.B: one (tile, channel) per thread
      const int mi = tid / BKC, cl = tid % BKC, c = c0 + cl;
      const int img = s_img[mi];
      int dh[16], dl[16];
      if (img >= 0 && c < cin) {
        const float sc = s_sc[mi];
        const int y0 = 2 * s_ty[mi] - pad_t, x0 = 2 * s_tx[mi] - pad_l;
        const float* ximg = X + (size_t)img * H * W * cin;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            const int iy = y0 + u, ix = x0 + v;
            const float xv = (iy >= 0 && iy < H && ix >= 0 && ix < W)
                                 ? ximg[((size_t)iy * W + ix) * cin + c]
                                 : 0.0f;
            limb::balanced_split(limb::quantize(xv, sc, qmax), base_bits,
                                 dh[4 * u + v], dl[4 * u + v]);
          }
        }
      } else {
#pragma unroll
        for (int p = 0; p < 16; ++p) dh[p] = dl[p] = 0;
      }
      int vh[16], vl[16];
      input_transform(dh, vh);
      input_transform(dl, vl);
#pragma unroll
      for (int p = 0; p < 16; ++p) {
        Vs[((0 * 16 + p) * BKC + cl) * BM + mi] = (int16_t)vh[p];
        Vs[((1 * 16 + p) * BKC + cl) * BM + mi] = (int16_t)vl[p];
      }
    }
    for (int idx = tid; idx < 16 * BKC * BN; idx += THREADS) {
      const int n = idx % BN, cl = (idx / BN) % BKC, p = idx / (BN * BKC);
      const int c = c0 + cl, gn = n0 + n;
      const bool ok = c < cin && gn < cout;
      const size_t g = ((size_t)p * cin + c) * cout + gn;
      Us[((0 * 16 + p) * BKC + cl) * BN + n] = ok ? UH[g] : (int16_t)0;
      Us[((1 * 16 + p) * BKC + cl) * BN + n] = ok ? UL[g] : (int16_t)0;
    }
    __syncthreads();

#pragma unroll
    for (int p = 0; p < 16; ++p) {
      int hh[TM][TN], xx[TM][TN], ll[TM][TN];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) hh[i][j] = xx[i][j] = ll[i][j] = 0;
#pragma unroll
      for (int cl = 0; cl < BKC; ++cl) {
        int vh[TM], vl[TM], uh[TN], ul[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const int mi = ty + i * (BM / TM);
          vh[i] = Vs[((0 * 16 + p) * BKC + cl) * BM + mi];
          vl[i] = Vs[((1 * 16 + p) * BKC + cl) * BM + mi];
        }
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int n = tx + j * (BN / TN);
          uh[j] = Us[((0 * 16 + p) * BKC + cl) * BN + n];
          ul[j] = Us[((1 * 16 + p) * BKC + cl) * BN + n];
        }
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            hh[i][j] += vh[i] * uh[j];
            ll[i][j] += vl[i] * ul[j];
            if (KARATSUBA)
              xx[i][j] += (vh[i] + vl[i]) * (uh[j] + ul[j]);
            else
              xx[i][j] += vh[i] * ul[j] + vl[i] * uh[j];
          }
      }
      // Fold this point through the inverse transform (linear, exact).
      const int u = p / 4, v = p % 4;
#pragma unroll
      for (int o = 0; o < 4; ++o) {
        const int coef = at_coef(o / 2, u) * at_coef(o % 2, v);
        if (coef == 0) continue;
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            const int mid = limb::mid_of<KARATSUBA>(hh[i][j], xx[i][j],
                                                    ll[i][j]);
            y[0][o][i][j] = wrap_add(y[0][o][i][j], coef * hh[i][j]);
            y[1][o][i][j] = wrap_add(y[1][o][i][j], coef * mid);
            y[2][o][i][j] = wrap_add(y[2][o][i][j], coef * ll[i][j]);
          }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int mi = ty + i * (BM / TM);
    const int img = s_img[mi];
    if (img < 0) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx + j * (BN / TN);
      if (gn >= cout) continue;
#pragma unroll
      for (int o = 0; o < 4; ++o) {
        const int oy = 2 * s_ty[mi] + o / 2, ox = 2 * s_tx[mi] + o % 2;
        if (oy >= ho || ox >= wo) continue;
        const float raw = limb::recombine(y[0][o][i][j], y[1][o][i][j],
                                          y[2][o][i][j], base_bits);
        out[(((size_t)img * ho + oy) * wo + ox) * cout + gn] =
            limb::dequant(raw, s_sc[mi], wscale4[gn], bias, gn);
      }
    }
  }
}

template <bool KARATSUBA>
cudaError_t launch(const float* X, const int16_t* UH, const int16_t* UL,
                   const float* s_tile, const float* wscale4,
                   const float* bias, float* out, int n, int H, int W,
                   int cin, int cout, int pad_t, int pad_l, int th, int tw,
                   int ho, int wo, int qmax, int base_bits,
                   cudaStream_t stream) {
  // The 48 KB of stages plus the static tables exceed the 48 KB default:
  // opt in to more dynamic shared memory (a launch over the limit would be
  // refused, never run).
  cudaError_t err = cudaFuncSetAttribute(
      winograd_kernel<KARATSUBA>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const int M = n * th * tw;
  const dim3 grid((M + BM - 1) / BM, (cout + BN - 1) / BN);
  winograd_kernel<KARATSUBA><<<grid, THREADS, SMEM_BYTES, stream>>>(
      X, UH, UL, s_tile, wscale4, bias, out, n, H, W, cin, cout, pad_t,
      pad_l, th, tw, ho, wo, qmax, base_bits);
  return cudaGetLastError();
}

}  // namespace

LIMB_EXPORT_ERROR_STRING

// X (n, H, W, cin) f32 unpadded; UH/UL (16, cin, cout) int16 transformed
// weight planes; s_tile (n, th, tw); wscale4 (cout) = wscale / 4; bias
// (cout) or NULL; out (n, ho, wo, cout) f32.
extern "C" int winograd_launch(const void* X, const void* UH, const void* UL,
                               const void* s_tile, const void* wscale4,
                               const void* bias, void* out, int n, int H,
                               int W, int cin, int cout, int pad_t, int pad_l,
                               int th, int tw, int ho, int wo, int qmax,
                               int base_bits, int karatsuba, void* stream) {
  const auto* x = static_cast<const float*>(X);
  const auto* uh = static_cast<const int16_t*>(UH);
  const auto* ul = static_cast<const int16_t*>(UL);
  const auto* st = static_cast<const float*>(s_tile);
  const auto* ws = static_cast<const float*>(wscale4);
  const auto* bs = static_cast<const float*>(bias);
  auto* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      karatsuba ? launch<true>(x, uh, ul, st, ws, bs, o, n, H, W, cin, cout,
                               pad_t, pad_l, th, tw, ho, wo, qmax, base_bits,
                               s)
                : launch<false>(x, uh, ul, st, ws, bs, o, n, H, W, cin, cout,
                                pad_t, pad_l, th, tw, ho, wo, qmax, base_bits,
                                s);
  return static_cast<int>(err);
}
