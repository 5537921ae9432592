// The systolic direct conv on Hopper: NHWC / HWIO, every tap over the whole
// Cin, one recombine per output.
//
// Replaces: src/repro/kernels/conv2d/conv2d.py:_conv_kernel
// (conv2d_systolic_raw), the paper's systolic conv engine.  On the TPU each
// grid step owned a (bh x WO x bc) output tile, bound two row blocks of the
// input to get its halo, and streamed the kh*kw shifted views through the
// MXU.  Here one thread block owns (image, 64 output pixels, 64 output
// channels) and walks every tap and the whole Cin itself (blocks run in no
// order, so nothing carries across them); the halo is just indexing into
// the unpadded input, zero outside the map.
//
// Integer variants (karatsuba / schoolbook): the input arrives quantized per
// SAMPLE as int16 (the reference quantizes outside its kernel), so there is
// no quantizer here.  Each (tap, 32-channel chunk) is split once into packed
// int8 digit planes in shared memory (limb_tile.cuh) and run through the
// __dp4a passes; the THREE int32 accumulators run over ALL taps and the
// whole Cin (the wrapper keeps int_accum_bound below 2^31, else it reroutes
// to the implicit engine), then ONE f32 recombine and the in-kernel dequant
// fl(raw * scale[n, c]) with scale = fl(s_sample * s_ch) made by the
// wrapper.  The bias, when given, is added after that product as a separate
// f32 add, fl(fl(raw * t) + b): the reference multiplies inside its kernel
// and adds the bias outside it, so nothing is contracted.
//
// The native variant is the implicit engine's float kernel
// (implicit_conv_float.cu): the same function.
//
// What bounds it on this card: VGG16's convs (15.5 G MAC per image) are
// bound by their multiply passes -- int8 digit products, 3 or 4 per MAC
// -- not by bytes (input and output are a few MB per image).
// What the design does about it: each gathered value is split once per
// tile and reused by 64 output channels from shared memory, and every
// __dp4a does four digit products.  The passes run on the CUDA cores in
// this first kernel; tensor-core MMA and a pipeline are later work.
#include "limb_tile.cuh"

namespace {

constexpr int BM = 64, BN = 64, BK = 32, BK4 = BK / 4, TM = 4, TN = 4;
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256
constexpr int OUTSIDE = -(1 << 28);

template <bool KARATSUBA>
__global__ void __launch_bounds__(THREADS) systolic_int_kernel(
    const int16_t* __restrict__ X, const int16_t* __restrict__ Wt,
    const float* __restrict__ scale, const float* __restrict__ bias,
    float* __restrict__ out, int H, int W, int cin, int cout, int kh, int kw,
    int stride, int pad_t, int pad_l, int ho, int wo, int base_bits) {
  __shared__ limb::Tiles<BM, BN, BK4> s;
  __shared__ int s_iy[BM], s_ix[BM];
  const int tid = threadIdx.x;
  const int ty = tid / (BN / TN), tx = tid % (BN / TN);
  const int img = blockIdx.z;
  const int n0 = blockIdx.x * BN;
  const int npix = ho * wo;

  for (int m = tid; m < BM; m += THREADS) {
    const int p = blockIdx.y * BM + m;
    if (p < npix) {
      s_iy[m] = (p / wo) * stride - pad_t;
      s_ix[m] = (p % wo) * stride - pad_l;
    } else {
      s_iy[m] = OUTSIDE;
      s_ix[m] = 0;
    }
  }
  __syncthreads();

  const int16_t* ximg = X + (size_t)img * H * W * cin;
  int hh[TM][TN], x[TM][TN], ll[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) hh[i][j] = x[i][j] = ll[i][j] = 0;

  for (int dy = 0; dy < kh; ++dy) {
    for (int dx = 0; dx < kw; ++dx) {
      const int16_t* wtap = Wt + (size_t)(dy * kw + dx) * cin * cout;
      for (int c0 = 0; c0 < cin; c0 += BK) {
        for (int idx = tid; idx < BM * BK4; idx += THREADS) {
          const int m = idx / BK4, k4 = idx % BK4;
          const int iy = s_iy[m] + dy, ix = s_ix[m] + dx;
          const bool inside = iy >= 0 && iy < H && ix >= 0 && ix < W;
          const size_t off = inside ? ((size_t)iy * W + ix) * cin : 0;
          int q[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int c = c0 + 4 * k4 + j;
            q[j] = (inside && c < cin) ? (int)ximg[off + c] : 0;
          }
          limb::store_a(s, m, k4, q, base_bits);
        }
        for (int idx = tid; idx < BN * BK4; idx += THREADS) {
          const int n = idx % BN, k4 = idx / BN;
          const int gn = n0 + n;
          int q[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int c = c0 + 4 * k4 + j;
            q[j] = (gn < cout && c < cin) ? (int)wtap[(size_t)c * cout + gn]
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

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int p = blockIdx.y * BM + ty + i * (BM / TM);
    if (p >= npix) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx + j * (BN / TN);
      if (gn >= cout) continue;
      const int mid = limb::mid_of<KARATSUBA>(hh[i][j], x[i][j], ll[i][j]);
      float v = limb::recombine(hh[i][j], mid, ll[i][j], base_bits);
      if (scale) v = __fmul_rn(v, scale[(size_t)img * cout + gn]);
      if (bias) v = __fadd_rn(v, bias[gn]);
      out[((size_t)img * npix + p) * cout + gn] = v;
    }
  }
}

}  // namespace

LIMB_EXPORT_ERROR_STRING

// X: (n, H, W, cin) int16 quantized per sample, UNPADDED (pads = top, left;
// bottom/right follow from ho, wo); Wt (kh, kw, cin, cout) int16; scale
// (n, cout) f32 = s_sample * s_ch, or NULL for the raw recombined sums;
// bias (cout) or NULL; out (n, ho, wo, cout) f32.
extern "C" int systolic_conv_launch(const void* X, const void* Wt,
                                    const void* scale, const void* bias,
                                    void* out, int n, int H, int W, int cin,
                                    int cout, int kh, int kw, int stride,
                                    int pad_t, int pad_l, int ho, int wo,
                                    int base_bits, int karatsuba,
                                    void* stream) {
  const dim3 g((cout + BN - 1) / BN, (ho * wo + BM - 1) / BM, n);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const int16_t*>(X);
  const auto* w = static_cast<const int16_t*>(Wt);
  const auto* sc = static_cast<const float*>(scale);
  const auto* bs = static_cast<const float*>(bias);
  auto* o = static_cast<float*>(out);
  if (karatsuba)
    systolic_int_kernel<true><<<g, THREADS, 0, st>>>(
        x, w, sc, bs, o, H, W, cin, cout, kh, kw, stride, pad_t, pad_l, ho,
        wo, base_bits);
  else
    systolic_int_kernel<false><<<g, THREADS, 0, st>>>(
        x, w, sc, bs, o, H, W, cin, cout, kh, kw, stride, pad_t, pad_l, ho,
        wo, base_bits);
  return static_cast<int>(cudaGetLastError());
}
