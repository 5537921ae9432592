// Implicit-GEMM integer convolution on Hopper, NHWC / HWIO, limb substrate.
//
// Replaces: src/repro/kernels/conv2d/implicit_gemm.py:_implicit_kernel
// (conv2d_implicit_raw), integer variants: the bias_relu epilogue, the
// pooled epilogue (pool=(2, 2)) and the pre-quantized handoff input.  The
// GEMM is M = output pixels, K = kh*kw*cin, N = cout; the patch matrix never
// exists in device memory.  One thread block owns (image, 64 output pixels,
// 64 output channels) and loops over Cin chunks x taps itself (the TPU
// kernel's sequential K grid becomes this loop): for each (chunk, tap) it
// gathers the pixels straight from the NHWC input (zero outside, i.e. the
// SAME/VALID padding), quantizes them with their PATCH's scale as
// rint(x / s) clipped to +-qmax, splits them into int8 digit planes in
// shared memory and runs the int8 passes.  The three int32 accumulators fold
// into an f32 group sum at the recombine-group boundaries (every `span_c`
// input channels, recombine_schedule/group_spans), exactly where the
// reference folds.  Epilogue: fma(group_sum, s_patch * s_ch, bias).
//
// POOL: the block's 64 rows are 16 POOLED pixels x their 2x2 window, row
// m = pooled pixel (m % 16), window offset (m / 16), so each thread's TM = 4
// rows are one window and the max stays in registers: out = max over the
// window of fl(sum * t), then + bias (the reference pools inside its core
// and adds the bias after, so nothing spans the max).  Conv rows past the
// map are never formed, so the TPU kernel's -inf row mask has no
// counterpart; VALID drops the odd last row/column by construction.
//
// HANDOFF: the input is the producer's padded int16 pixels (n, h+2, w+2,
// cin) plus its (n, th, tw) power-of-two cell scale grid; nothing is
// quantized.  Loop order: Cin chunk of `span_c` (the plan's bk) outer, tap
// inner; each (chunk, tap) sums its int32 sub-tiles of BK channels, then
// recombines once and adds fl(cell_scale * rec) (exact: a power of two) to
// the f32 sum -- the reference's f32 order, which depends on bk and not on
// this kernel's BK.  The cell scale of pixel (py, px) is grid[min(py/2,
// th-1), min(px/2, tw-1)], read from the small grid per tap.  Epilogue:
// fma(sum, s_ch, bias), or with POOL max(fl(sum * s_ch)) + bias.
//
// What bounds it on this card: VGG16's 3x3 layers (e.g. 256 -> 256 at
// 56x56: 1.85 G MAC per image x 3 or 4 int8 passes) and AlexNet conv2 are
// bound by their int8 passes; input and output are a few MB.  What the
// design does about it: each gathered activation is quantized (or read as
// int16) and split once per (tap, chunk) tile and then reused by 64 output
// channels from shared memory, and every __dp4a does four digit products.
// The passes run on the CUDA cores in this first kernel; tensor-core MMA
// and a multistage pipeline are later work.
#include "limb_tile.cuh"

namespace {

constexpr int BM = 64, BN = 64, BK = 32, BK4 = BK / 4, TM = 4, TN = 4;
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256
constexpr int ROWS = BM / TM;                   // 16 pooled pixels (POOL)
constexpr int OUTSIDE = -(1 << 28);             // never inside the image

// One (chunk, tap) K-step's A and B tiles: channels [c0, c1) of tap
// (dy, dx), rows gathered at (s_iy + dy, s_ix + dx).
template <bool HANDOFF>
__device__ __forceinline__ void load_tiles(
    limb::Tiles<BM, BN, BK4>& s, const void* ximg, const int16_t* wtap,
    const float* s_scale, const int* s_iy, const int* s_ix, int H, int W,
    int cin, int cout, int n0, int c0, int c1, int dy, int dx, int qmax,
    int base_bits, int tid) {
  for (int idx = tid; idx < BM * BK4; idx += THREADS) {
    const int m = idx / BK4, k4 = idx % BK4;
    const int iy = s_iy[m] + dy, ix = s_ix[m] + dx;
    const bool inside = iy >= 0 && iy < H && ix >= 0 && ix < W;
    const size_t off = inside ? ((size_t)iy * W + ix) * cin : 0;
    int q[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + 4 * k4 + j;
      if (!inside || c >= c1) {
        q[j] = 0;
      } else if (HANDOFF) {
        q[j] = (int)static_cast<const int16_t*>(ximg)[off + c];
      } else {
        q[j] = limb::quantize(static_cast<const float*>(ximg)[off + c],
                              s_scale[m], qmax);
      }
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
      q[j] = (gn < cout && c < c1) ? (int)wtap[(size_t)c * cout + gn] : 0;
    }
    limb::store_b(s, n, k4, q, base_bits);
  }
}

template <bool KARATSUBA, bool POOL, bool HANDOFF>
__global__ void __launch_bounds__(THREADS) implicit_conv_kernel(
    const void* __restrict__ X, const int16_t* __restrict__ Wt,
    const float* __restrict__ ascale, const float* __restrict__ grid,
    const float* __restrict__ wscale, const float* __restrict__ bias,
    float* __restrict__ out, int H, int W, int cin, int cout, int kh, int kw,
    int stride, int pad_t, int pad_l, int ho, int wo, int span_c, int qmax,
    int base_bits, int hp, int wp) {
  __shared__ limb::Tiles<BM, BN, BK4> s;
  __shared__ float s_scale[BM];
  __shared__ int s_iy[BM], s_ix[BM];
  const int tid = threadIdx.x;
  const int ty = tid / (BN / TN), tx = tid % (BN / TN);
  const int img = blockIdx.z;
  const int n0 = blockIdx.x * BN;
  const int npix = ho * wo;
  const int nout = POOL ? hp * wp : npix;  // output pixels per image
  const int th = (ho + 1) / 2, tw = (wo + 1) / 2;

  // Per-row conv pixel: its patch origin and (quantized input) scale; rows
  // past the output gather zeros and are never written.
  for (int m = tid; m < BM; m += THREADS) {
    int oy = -1, ox = 0;
    if (POOL) {
      const int pp = blockIdx.y * ROWS + m % ROWS, off = m / ROWS;
      if (pp < nout) {
        oy = 2 * (pp / wp) + off / 2;
        ox = 2 * (pp % wp) + off % 2;
      }
    } else {
      const int p = blockIdx.y * BM + m;
      if (p < npix) {
        oy = p / wo;
        ox = p % wo;
      }
    }
    if (oy >= 0) {
      s_scale[m] = HANDOFF ? 1.0f : ascale[((size_t)img * ho + oy) * wo + ox];
      s_iy[m] = oy * stride - pad_t;
      s_ix[m] = ox * stride - pad_l;
    } else {
      s_scale[m] = 1.0f;
      s_iy[m] = OUTSIDE;
      s_ix[m] = 0;
    }
  }
  __syncthreads();

  const size_t in_elem = HANDOFF ? sizeof(int16_t) : sizeof(float);
  const void* ximg = static_cast<const char*>(X) +
                     (size_t)img * H * W * cin * in_elem;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
  int hh[TM][TN], x[TM][TN], ll[TM][TN];

  for (int g0 = 0; g0 < cin; g0 += span_c) {
    const int g1 = min(g0 + span_c, cin);
    if (HANDOFF) {
      // Chunk outer, tap inner: one recombine per (chunk, tap), scaled by
      // the tap's power-of-two cell scale before the f32 add.
      for (int dy = 0; dy < kh; ++dy) {
        for (int dx = 0; dx < kw; ++dx) {
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j) hh[i][j] = x[i][j] = ll[i][j] = 0;
          const int16_t* wtap = Wt + (size_t)(dy * kw + dx) * cin * cout;
          for (int c0 = g0; c0 < g1; c0 += BK) {
            load_tiles<true>(s, ximg, wtap, s_scale, s_iy, s_ix, H, W, cin,
                             cout, n0, c0, min(c0 + BK, g1), dy, dx, qmax,
                             base_bits, tid);
            __syncthreads();
            limb::passes<BM, BN, BK4, TM, TN, KARATSUBA>(s, ty, tx, hh, x,
                                                         ll);
            __syncthreads();
          }
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            const int m = ty + i * ROWS;
            float cell = 0.0f;
            if (s_iy[m] != OUTSIDE) {
              const int cy = min((s_iy[m] + dy) / 2, th - 1);
              const int cx = min((s_ix[m] + dx) / 2, tw - 1);
              cell = grid[((size_t)img * th + cy) * tw + cx];
            }
#pragma unroll
            for (int j = 0; j < TN; ++j) {
              const int mid =
                  limb::mid_of<KARATSUBA>(hh[i][j], x[i][j], ll[i][j]);
              const float rec =
                  limb::recombine(hh[i][j], mid, ll[i][j], base_bits);
              acc[i][j] = __fadd_rn(acc[i][j], __fmul_rn(cell, rec));
            }
          }
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) hh[i][j] = x[i][j] = ll[i][j] = 0;
      for (int c0 = g0; c0 < g1; c0 += BK) {
        for (int dy = 0; dy < kh; ++dy) {
          for (int dx = 0; dx < kw; ++dx) {
            load_tiles<false>(s, ximg,
                              Wt + (size_t)(dy * kw + dx) * cin * cout,
                              s_scale, s_iy, s_ix, H, W, cin, cout, n0, c0,
                              min(c0 + BK, g1), dy, dx, qmax, base_bits, tid);
            __syncthreads();
            limb::passes<BM, BN, BK4, TM, TN, KARATSUBA>(s, ty, tx, hh, x,
                                                         ll);
            __syncthreads();
          }
        }
      }
      // Fold the exact int32 group into the f32 sum (one recombine each).
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int mid =
              limb::mid_of<KARATSUBA>(hh[i][j], x[i][j], ll[i][j]);
          acc[i][j] = __fadd_rn(
              acc[i][j], limb::recombine(hh[i][j], mid, ll[i][j], base_bits));
        }
    }
  }

  if (POOL) {
    // The thread's four rows are one 2x2 window of pooled pixel ty.
    const int pp = blockIdx.y * ROWS + ty;
    if (pp >= nout) return;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx + j * (BN / TN);
      if (gn >= cout) continue;
      float v = 0.0f;
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float t =
            HANDOFF ? wscale[gn] : __fmul_rn(s_scale[ty + i * ROWS], wscale[gn]);
        const float d = __fmul_rn(acc[i][j], t);
        v = i == 0 ? d : fmaxf(v, d);
      }
      if (bias) v = __fadd_rn(v, bias[gn]);
      out[((size_t)img * nout + pp) * cout + gn] = v;
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = ty + i * ROWS;
    const int p = blockIdx.y * BM + m;
    if (p >= npix) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx + j * (BN / TN);
      if (gn >= cout) continue;
      // HANDOFF: the activation scales were applied per tap (s_scale 1).
      out[((size_t)img * npix + p) * cout + gn] =
          HANDOFF ? (bias ? __fmaf_rn(acc[i][j], wscale[gn], bias[gn])
                          : __fmul_rn(acc[i][j], wscale[gn]))
                  : limb::dequant(acc[i][j], s_scale[m], wscale[gn], bias, gn);
    }
  }
}

template <bool KARATSUBA, bool POOL, bool HANDOFF>
void launch(dim3 grid_dim, cudaStream_t st, const void* x, const int16_t* w,
            const float* as, const float* gr, const float* ws,
            const float* bs, float* o, int H, int W, int cin, int cout,
            int kh, int kw, int stride, int pad_t, int pad_l, int ho, int wo,
            int span_c, int qmax, int base_bits, int hp, int wp) {
  implicit_conv_kernel<KARATSUBA, POOL, HANDOFF><<<grid_dim, THREADS, 0, st>>>(
      x, w, as, gr, ws, bs, o, H, W, cin, cout, kh, kw, stride, pad_t, pad_l,
      ho, wo, span_c, qmax, base_bits, hp, wp);
}

}  // namespace

LIMB_EXPORT_ERROR_STRING

// X: (n, H, W, cin) f32 unpadded, or with `handoff` the (n, h+2, w+2, cin)
// int16 padded handoff values (then kh = kw = 3, stride 1, pads 0); Wt
// (kh, kw, cin, cout) int16; ascale (n, ho, wo) per-patch scales (NULL with
// handoff); grid (n, ceil(ho/2), ceil(wo/2)) cell scales (handoff only);
// wscale (cout); bias (cout) or NULL; out (n, ho, wo, cout) f32, or with
// `pool` (n, hp, wp, cout), hp = ho/2, wp = wo/2.  span_c: input channels
// per recombine group, or with handoff the plan's Cin chunk bk.
extern "C" int implicit_conv_launch(
    const void* X, const void* Wt, const void* ascale, const void* grid,
    const void* wscale, const void* bias, void* out, int n, int H, int W,
    int cin, int cout, int kh, int kw, int stride, int pad_t, int pad_l,
    int ho, int wo, int span_c, int qmax, int base_bits, int karatsuba,
    int pool, int handoff, int hp, int wp, void* stream) {
  const int rows = pool ? (hp * wp + ROWS - 1) / ROWS
                        : (ho * wo + BM - 1) / BM;
  const dim3 g((cout + BN - 1) / BN, rows, n);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* w = static_cast<const int16_t*>(Wt);
  const auto* as = static_cast<const float*>(ascale);
  const auto* gr = static_cast<const float*>(grid);
  const auto* ws = static_cast<const float*>(wscale);
  const auto* bs = static_cast<const float*>(bias);
  auto* o = static_cast<float*>(out);
#define IMPLICIT_LAUNCH(K, P, HO)                                           \
  launch<K, P, HO>(g, st, X, w, as, gr, ws, bs, o, H, W, cin, cout, kh, kw, \
                   stride, pad_t, pad_l, ho, wo, span_c, qmax, base_bits,  \
                   hp, wp)
  const int mode = (karatsuba ? 4 : 0) | (pool ? 2 : 0) | (handoff ? 1 : 0);
  switch (mode) {
    case 0: IMPLICIT_LAUNCH(false, false, false); break;
    case 1: IMPLICIT_LAUNCH(false, false, true); break;
    case 2: IMPLICIT_LAUNCH(false, true, false); break;
    case 3: IMPLICIT_LAUNCH(false, true, true); break;
    case 4: IMPLICIT_LAUNCH(true, false, false); break;
    case 5: IMPLICIT_LAUNCH(true, false, true); break;
    case 6: IMPLICIT_LAUNCH(true, true, false); break;
    default: IMPLICIT_LAUNCH(true, true, true); break;
  }
#undef IMPLICIT_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
