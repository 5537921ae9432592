// Implicit-GEMM integer convolution on Hopper, NHWC / HWIO, limb substrate.
//
// Replaces: src/repro/kernels/conv2d/implicit_gemm.py:_implicit_kernel
// (conv2d_implicit_raw), integer variants with the bias_relu epilogue.  The
// GEMM is M = output pixels, K = kh*kw*cin, N = cout; the patch matrix never
// exists in device memory.  One thread block owns (image, 64 consecutive
// output pixels, 64 output channels) and loops over Cin chunks x taps
// itself (the TPU kernel's sequential K grid becomes this loop): for each
// (chunk, tap) it gathers the pixels straight from the unpadded NHWC input
// (zero outside, i.e. the SAME/VALID padding), quantizes them with their
// PATCH's scale as rint(x / s) clipped to +-qmax, splits them into int8 digit
// planes in shared memory and runs the int8 passes.  The three int32
// accumulators fold into an f32 group sum at the recombine-group boundaries
// (every `span_c` input channels, recombine_schedule/group_spans), exactly
// where the reference folds.  Epilogue: fma(group_sum, s_patch * s_ch, bias).
//
// What bounds it on this card: AlexNet conv2 (5x5, 96 -> 256 at 27x27) is
// bound by its int8 passes (~448 M MAC per image x 3 or 4 passes); its
// input and output are a few MB.  What the design does about it: each
// gathered activation is quantized and split once per (tap, chunk) tile and
// then reused by 64 output channels from shared memory, and every __dp4a
// does four digit products.  The passes run on the CUDA cores in this first
// kernel; tensor-core MMA and a multistage pipeline are later work.
#include "limb_tile.cuh"

namespace {

constexpr int BM = 64, BN = 64, BK = 32, BK4 = BK / 4, TM = 4, TN = 4;
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256

template <bool KARATSUBA>
__global__ void __launch_bounds__(THREADS) implicit_conv_kernel(
    const float* __restrict__ X, const int16_t* __restrict__ Wt,
    const float* __restrict__ ascale, const float* __restrict__ wscale,
    const float* __restrict__ bias, float* __restrict__ out, int H, int W,
    int cin, int cout, int kh, int kw, int stride, int pad_t, int pad_l,
    int ho, int wo, int span_c, int qmax, int base_bits) {
  __shared__ limb::Tiles<BM, BN, BK4> s;
  __shared__ float s_scale[BM];
  __shared__ int s_iy[BM], s_ix[BM];
  const int tid = threadIdx.x;
  const int ty = tid / (BN / TN), tx = tid % (BN / TN);
  const int img = blockIdx.z;
  const int p0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int npix = ho * wo;

  // Per-pixel patch origin and scale; pixels past the image gather zeros.
  for (int m = tid; m < BM; m += THREADS) {
    const int p = p0 + m;
    if (p < npix) {
      const int oy = p / wo, ox = p % wo;
      s_scale[m] = ascale[(size_t)img * npix + p];
      s_iy[m] = oy * stride - pad_t;
      s_ix[m] = ox * stride - pad_l;
    } else {
      s_scale[m] = 1.0f;
      s_iy[m] = -(1 << 28);  // never inside the image
      s_ix[m] = 0;
    }
  }
  __syncthreads();

  const float* ximg = X + (size_t)img * H * W * cin;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int g0 = 0; g0 < cin; g0 += span_c) {
    const int g1 = min(g0 + span_c, cin);
    int hh[TM][TN], x[TM][TN], ll[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) hh[i][j] = x[i][j] = ll[i][j] = 0;

    for (int c0 = g0; c0 < g1; c0 += BK) {
      for (int dy = 0; dy < kh; ++dy) {
        for (int dx = 0; dx < kw; ++dx) {
          // A: gathered, per-patch quantized activations.
          for (int idx = tid; idx < BM * BK4; idx += THREADS) {
            const int m = idx / BK4, k4 = idx % BK4;
            const int iy = s_iy[m] + dy, ix = s_ix[m] + dx;
            const bool inside = iy >= 0 && iy < H && ix >= 0 && ix < W;
            const float sc = s_scale[m];
            const float* px =
                inside ? ximg + ((size_t)iy * W + ix) * cin : ximg;
            int q[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int c = c0 + 4 * k4 + j;
              q[j] = (inside && c < g1) ? limb::quantize(px[c], sc, qmax) : 0;
            }
            limb::store_a(s, m, k4, q, base_bits);
          }
          // B: the tap's int16 weights, channels c0.. x outputs n0..
          const int16_t* wtap = Wt + (size_t)(dy * kw + dx) * cin * cout;
          for (int idx = tid; idx < BN * BK4; idx += THREADS) {
            const int n = idx % BN, k4 = idx / BN;
            const int gn = n0 + n;
            int q[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int c = c0 + 4 * k4 + j;
              q[j] = (gn < cout && c < g1)
                         ? (int)wtap[(size_t)c * cout + gn]
                         : 0;
            }
            limb::store_b(s, n, k4, q, base_bits);
          }
          __syncthreads();
          limb::passes<BM, BN, BK4, TM, TN, KARATSUBA>(s, ty, tx, hh, x, ll);
          __syncthreads();
        }
      }
    }
    // Fold the exact int32 group into the f32 sum (one recombine per group).
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int mid = limb::mid_of<KARATSUBA>(hh[i][j], x[i][j], ll[i][j]);
        acc[i][j] = __fadd_rn(
            acc[i][j], limb::recombine(hh[i][j], mid, ll[i][j], base_bits));
      }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = ty + i * (BM / TM);
    const int p = p0 + m;
    if (p >= npix) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx + j * (BN / TN);
      if (gn >= cout) continue;
      out[((size_t)img * npix + p) * cout + gn] =
          limb::dequant(acc[i][j], s_scale[m], wscale[gn], bias, gn);
    }
  }
}

}  // namespace

LIMB_EXPORT_ERROR_STRING

// X (n, H, W, cin) f32 unpadded; Wt (kh, kw, cin, cout) int16; ascale
// (n, ho, wo) per-patch scales; wscale (cout); bias (cout) or NULL; out
// (n, ho, wo, cout) f32.  span_c: input channels per recombine group.
extern "C" int implicit_conv_launch(
    const void* X, const void* Wt, const void* ascale, const void* wscale,
    const void* bias, void* out, int n, int H, int W, int cin, int cout,
    int kh, int kw, int stride, int pad_t, int pad_l, int ho, int wo,
    int span_c, int qmax, int base_bits, int karatsuba, void* stream) {
  const dim3 grid((cout + BN - 1) / BN, (ho * wo + BM - 1) / BM, n);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const float*>(X);
  const auto* w = static_cast<const int16_t*>(Wt);
  const auto* as = static_cast<const float*>(ascale);
  const auto* ws = static_cast<const float*>(wscale);
  const auto* bs = static_cast<const float*>(bias);
  auto* o = static_cast<float*>(out);
  if (karatsuba)
    implicit_conv_kernel<true><<<grid, THREADS, 0, st>>>(
        x, w, as, ws, bs, o, H, W, cin, cout, kh, kw, stride, pad_t, pad_l,
        ho, wo, span_c, qmax, base_bits);
  else
    implicit_conv_kernel<false><<<grid, THREADS, 0, st>>>(
        x, w, as, ws, bs, o, H, W, cin, cout, kh, kw, stride, pad_t, pad_l,
        ho, wo, span_c, qmax, base_bits);
  return static_cast<int>(cudaGetLastError());
}
