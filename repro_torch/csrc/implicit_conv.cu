// Implicit-GEMM integer convolution on Hopper, NHWC / HWIO, limb substrate,
// int8 passes on the tensor cores (mma.sync m16n8k32 s8 -> s32).
//
// Replaces: src/repro/kernels/conv2d/implicit_gemm.py:_implicit_kernel
// (conv2d_implicit_raw), integer variants: the bias_relu epilogue, the
// pooled epilogue (pool=(2, 2)) and the pre-quantized handoff input.  The
// GEMM is M = output pixels, K = kh*kw*cin, N = cout; the patch matrix never
// exists in device memory.  One thread block owns (image, 64 output pixels,
// 128 output channels) and walks the layer's K steps itself (the TPU
// kernel's sequential K grid becomes this loop): a step is up to BK = 64
// input channels of one tap, cut at the end of its recombine group.  The
// three int32 accumulators fold into an f32 sum exactly where the
// reference folds (implicit_gemm.implicit_k_steps, which the CPU tests
// emulate):
//   * quantizing input: groups of `span_c` channels (recombine_schedule /
//     group_spans), channel steps outer, taps inner; one fold per group;
//     epilogue fma(sum, s_patch * s_ch, bias);
//   * HANDOFF: the producer's padded int16 pixels (n, h+2, w+2, cin) and its
//     (n, th, tw) power-of-two cell scale grid, nothing quantized; chunks of
//     `span_c` (the plan's bk) outer, taps inner, the chunk's steps
//     innermost; one fold per (chunk, tap), sum += fl(cell * rec) (exact: a
//     power of two), the cell of pixel (py, px) being grid[min(py/2, th-1),
//     min(px/2, tw-1)]; epilogue fma(sum, s_ch, bias).
//   * POOL: the block's 64 rows are 16 pooled pixels x their 2x2 window,
//     laid out so that each lane's four MMA rows (g and g+8 of its warp's
//     two m16 tiles) are one window; the max stays in registers: out = max
//     over the window of fl(sum * t), then + bias (the reference pools
//     inside its core and adds the bias after, so nothing spans the max).
//     Conv rows past the map are never formed; VALID drops the odd last row
//     and column by construction.
//
// What bounds it on this card: VGG16's 3x3 layers and AlexNet conv2 are
// bound by their int8 passes (1,979 TOP/s); input and output are a few MB.
// What the design does about it:
//   * the passes run on the tensor cores, eight warps of 32 x 32 outputs,
//     two MMA depths (32 channels each) per step;
//   * a first kernel splits the weight once per call into packed digit
//     planes (conv_mma.cuh pack_weight_kernel), each group padded to whole
//     steps, so a step's B tile is whole quad rows that land by 16-byte
//     cp.async;
//   * a 4-stage cp.async ring carries each step's gathered input pixels
//     (f32, or int16 for the handoff; zero-filled outside the map, so the
//     padding stays indexing) and its weight planes; the MMAs read the
//     weight planes in place, so a slot is reloaded one step after its MMAs;
//   * while the tensor cores run a step, all threads quantize the next
//     step's gathered floats (rint(x / s_patch) clipped to +-qmax, the IEEE
//     quotient the reference's patch quantization needs, computed from the
//     row's correctly rounded reciprocal by Markstein's correction:
//     lmma::quantize_rcp) and split them into packed int8 digit planes in
//     shared memory (limb_mma.cuh), once for 128 output channels; one
//     barrier per step.
// Bring-up probes on an H100 found the loop bound by instruction latency
// at one block (eight warps) per SM: a per-element __fdiv_rn took half the
// time, the load issue (address arithmetic, integer division by the
// kernel width) nearly as much; hence the reciprocal, the 64-channel steps
// and the per-thread copy state kept in registers.
// The weight packing, the ring walk, the input split and the MMA step are
// conv_mma.cuh's, shared with systolic_conv.cu.
#include "conv_mma.cuh"

namespace {

using cmma::A_F32_LD;
using cmma::A_I16_LD;
using cmma::BK;  // input channels per K step: two MMA depths
using cmma::KQ;  // K quads per step
constexpr int BM = 64;    // output pixels (conv rows) per block
constexpr int BN = 128;   // output channels per block
constexpr int WARPS_N = BN / 32, WARPS = 2 * WARPS_N;  // 2 x 4 warps
constexpr int THREADS = 32 * WARPS;                    // 256
// Ring slots: a step's weight planes stay in its slot until its MMAs are
// done, and its input is split one step ahead, so three steps are in
// flight past the one the MMAs read.
constexpr int STAGES = 4;
constexpr int PP = 16;    // pooled pixels per block (POOL)
constexpr int OUTSIDE = -(1 << 28);

// Shared memory: the ring (per stage the raw input tile, then the weight's
// digit planes), two buffers of the input's digit planes, row tables.
constexpr int A_RAW = BM * A_F32_LD * 4;
constexpr int PA_LD = BM + 8;      // words per plane row (K quad) of A
constexpr int PB_LD = BN + 8;
constexpr int PA = 3 * KQ * PA_LD; // words: [plane][K quad][row]
constexpr int PB = 3 * KQ * PB_LD; // words: [plane][K quad][column]
constexpr int STAGE = A_RAW + PB * 4;
constexpr int TABLES = 4 * BM * 4 + 9 * BM * 4;
constexpr int SMEM = STAGES * STAGE + 2 * PA * 4 + TABLES;

struct ConvArgs {
  const void* X;
  const uint32_t* Wp;  // the weight's digit planes (pack_weight_kernel)
  const float* ascale;
  const float* grid;
  const float* wscale;
  const float* bias;
  float* out;
  int H, W, cin, cout, kh, kw, stride, pad_t, pad_l, ho, wo, span_c, qmax,
      base_bits, hp, wp;
  int a_vec;  // 16-byte copies of the input allowed
  int lp;     // channels of a full group, padded to a multiple of BK
  int k4p;    // packed K quads per tap and plane
  int coutp;  // words per packed row: cout padded to a multiple of 4
};

// A position in the block's K walk: group (chunk) gi = [g0, g1), step
// channels [c0, min(c0 + BK, g1)), tap = (dy, dx), all kept incrementally
// (no division in the loop).
template <bool HANDOFF>
struct KStep {
  int g0, g1, c0, tap, dy, dx, gi;
  __device__ __forceinline__ void start(const ConvArgs& a) {
    g0 = c0 = tap = dy = dx = gi = 0;
    g1 = min(a.span_c, a.cin);
  }
  __device__ __forceinline__ int c1() const { return min(c0 + BK, g1); }
  // The step closes a fold: its group (quantizing) or its (chunk, tap).
  __device__ __forceinline__ bool folds(const ConvArgs& a) const {
    return c0 + BK >= g1 && (HANDOFF || tap == a.kh * a.kw - 1);
  }
  // The step's first quad row in each plane of the packed weight.
  __device__ __forceinline__ int quad0(const ConvArgs& a) const {
    return gi * (a.lp / 4) + (c0 - g0) / 4;
  }
  __device__ __forceinline__ bool next_tap(const ConvArgs& a) {
    if (++dx == a.kw) {
      dx = 0;
      ++dy;
    }
    if (++tap < a.kh * a.kw) return true;
    tap = dy = dx = 0;
    return false;
  }
  __device__ __forceinline__ void next(const ConvArgs& a) {
    if (HANDOFF) {  // sub-steps, then taps, then chunks
      c0 += BK;
      if (c0 < g1) return;
      c0 = g0;
      if (next_tap(a)) return;
    } else {        // taps, then sub-steps, then groups
      if (next_tap(a)) return;
      c0 += BK;
      if (c0 < g1) return;
    }
    g0 = g1;
    g1 = min(g0 + a.span_c, a.cin);
    c0 = g0;
    ++gi;
  }
};

// The input copies of one thread (16-byte path): the same column chunk u
// of rows r0 + i * (THREADS / CPR), whose patch origins stay in registers.
template <bool HANDOFF>
struct ACopies {
  static constexpr int PER = HANDOFF ? 8 : 4;  // elements per 16-byte copy
  static constexpr int CPR = BK / PER;         // copies per row
  static constexpr int N = BM * CPR / THREADS;
  int iy[N], ix[N];
};

struct Smem {
  char* raw;         // STAGES x (A raw, B planes)
  uint32_t* planes;  // 2 x A planes
  int* s_iy;
  int* s_ix;
  float* s_scale;
  float* s_rcp;      // RN(1 / s_scale)
  float* s_cell;     // [tap][row], HANDOFF
  __device__ explicit Smem(char* base) {
    raw = base;
    planes = reinterpret_cast<uint32_t*>(base + STAGES * STAGE);
    s_iy = reinterpret_cast<int*>(base + STAGES * STAGE + 2 * PA * 4);
    s_ix = s_iy + BM;
    s_scale = reinterpret_cast<float*>(s_ix + BM);
    s_rcp = s_scale + BM;
    s_cell = s_rcp + BM;
  }
};

// Issues the copies of one K step's tiles into a ring stage: the raw input
// pixels and the weight's digit-plane rows.
template <bool KARATSUBA, bool HANDOFF>
__device__ __forceinline__ void load_raw(const ConvArgs& a, const Smem& sm,
                                         const void* ximg, int n0,
                                         const KStep<HANDOFF>& ks,
                                         const ACopies<HANDOFF>& ac,
                                         char* base) {
  using AC = ACopies<HANDOFF>;
  const int tid = threadIdx.x;
  // A: BK channels from c0 of each row's tap pixel (channels past the
  // step's end are masked when split).
  if (a.a_vec) {
    const int u = tid % AC::CPR, c = ks.c0 + u * AC::PER;
#pragma unroll
    for (int i = 0; i < AC::N; ++i) {
      const int r = (tid + i * THREADS) / AC::CPR;
      const int iy = ac.iy[i] + ks.dy, ix = ac.ix[i] + ks.dx;
      const bool ok = (unsigned)iy < (unsigned)a.H &&
                      (unsigned)ix < (unsigned)a.W && c < a.cin;
      const size_t off = ok ? ((size_t)iy * a.W + ix) * a.cin + c : 0;
      if (HANDOFF)
        lmma::cp_async16(base + (r * A_I16_LD + u * AC::PER) * 2,
                         static_cast<const int16_t*>(ximg) + off, ok);
      else
        lmma::cp_async16(base + (r * A_F32_LD + u * AC::PER) * 4,
                         static_cast<const float*>(ximg) + off, ok);
    }
  } else {
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int r = e / BK, kk = e % BK;
      const int iy = sm.s_iy[r] + ks.dy, ix = sm.s_ix[r] + ks.dx;
      const int c = ks.c0 + kk;
      const bool ok = iy >= 0 && iy < a.H && ix >= 0 && ix < a.W && c < a.cin;
      const size_t off = ok ? ((size_t)iy * a.W + ix) * a.cin + c : 0;
      if (HANDOFF)
        reinterpret_cast<int16_t*>(base)[r * A_I16_LD + kk] =
            ok ? static_cast<const int16_t*>(ximg)[off] : (int16_t)0;
      else
        reinterpret_cast<float*>(base)[r * A_F32_LD + kk] =
            ok ? static_cast<const float*>(ximg)[off] : 0.0f;
    }
  }
  // B: the step's KQ quad rows of each digit plane, columns n0..n0+BN-1.
  constexpr int P = KARATSUBA ? 3 : 2;
  cmma::load_b<P, KQ, BN, PB_LD, THREADS>(
      reinterpret_cast<uint32_t*>(base + A_RAW),
      a.Wp + ((size_t)ks.tap * P * a.k4p + ks.quad0(a)) * a.coutp, a.Wp,
      a.k4p, a.coutp, n0);
}

template <bool KARATSUBA, bool POOL, bool HANDOFF>
__global__ void __launch_bounds__(THREADS)
    implicit_conv_kernel(const ConvArgs a) {
  extern __shared__ float4 smem4[];
  const Smem sm(reinterpret_cast<char*>(smem4));
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int img = blockIdx.z;
  const int n0 = blockIdx.x * BN;
  const int npix = a.ho * a.wo;
  const int nout = POOL ? a.hp * a.wp : npix;
  const int th = (a.ho + 1) / 2, tw = (a.wo + 1) / 2;

  // Row tables: each conv row's patch origin, scale and (HANDOFF) cells.
  // POOL: row m = 32 wm' + 16 j + r holds pooled pixel 8 wm' + (r & 7),
  // window offset 2 j + (r >> 3).
  for (int m = tid; m < BM; m += THREADS) {
    int oy = -1, ox = 0;
    if (POOL) {
      const int r = m & 15, j = (m >> 4) & 1;
      const int pp = blockIdx.y * PP + (m >> 5) * 8 + (r & 7);
      const int off = 2 * j + (r >> 3);
      if (pp < nout) {
        oy = 2 * (pp / a.wp) + (off >> 1);
        ox = 2 * (pp % a.wp) + (off & 1);
      }
    } else {
      const int p = blockIdx.y * BM + m;
      if (p < npix) {
        oy = p / a.wo;
        ox = p % a.wo;
      }
    }
    if (oy >= 0) {
      sm.s_scale[m] =
          HANDOFF ? 1.0f : a.ascale[((size_t)img * a.ho + oy) * a.wo + ox];
      sm.s_iy[m] = oy * a.stride - a.pad_t;
      sm.s_ix[m] = ox * a.stride - a.pad_l;
      sm.s_rcp[m] = __frcp_rn(sm.s_scale[m]);
    } else {
      sm.s_scale[m] = 1.0f;
      sm.s_rcp[m] = 1.0f;
      sm.s_iy[m] = OUTSIDE;
      sm.s_ix[m] = 0;
    }
    if (HANDOFF) {
      for (int tap = 0; tap < 9; ++tap) {
        float cell = 0.0f;
        if (oy >= 0) {
          const int cy = min((sm.s_iy[m] + tap / 3) / 2, th - 1);
          const int cx = min((sm.s_ix[m] + tap % 3) / 2, tw - 1);
          cell = a.grid[((size_t)img * th + cy) * tw + cx];
        }
        sm.s_cell[tap * BM + m] = cell;
      }
    }
  }
  __syncthreads();

  const size_t in_elem = HANDOFF ? sizeof(int16_t) : sizeof(float);
  const void* ximg = static_cast<const char*>(a.X) +
                     (size_t)img * a.H * a.W * a.cin * in_elem;
  const lmma::Digits dg(a.base_bits);
  // Steps of the walk: per group, ceil(len / BK) sub-steps x taps.
  int nst = 0;
  for (int g0 = 0; g0 < a.cin; g0 += a.span_c)
    nst += (min(g0 + a.span_c, a.cin) - g0 + BK - 1) / BK;
  nst *= a.kh * a.kw;
  // Warps whose 32 columns all lie past cout skip the MMAs.
  const bool live_cols = n0 + wn * 32 < a.cout;

  float acc[2][4][4];
  int hh[2][4][4], xx[2][4][4], ll[2][4][4];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        acc[j][i][c] = 0.0f;
        hh[j][i][c] = xx[j][i][c] = ll[j][i][c] = 0;
      }

  // This thread's input copies (16-byte path) and split row.
  ACopies<HANDOFF> ac;
#pragma unroll
  for (int i = 0; i < ACopies<HANDOFF>::N; ++i) {
    const int r = (tid + i * THREADS) / ACopies<HANDOFF>::CPR;
    ac.iy[i] = sm.s_iy[r];
    ac.ix[i] = sm.s_ix[r];
  }
  const float row_s = sm.s_scale[tid % BM], row_rc = sm.s_rcp[tid % BM];
  auto stage = [&](int st) { return sm.raw + (st % STAGES) * STAGE; };

  KStep<HANDOFF> ld, sp, mm;  // loader, splitter, consumer positions
  ld.start(a);
  sp.start(a);
  mm.start(a);
  cmma::ring_walk<STAGES>(
      nst,
      [&](int st, bool live) {
        if (live)
          load_raw<KARATSUBA, HANDOFF>(a, sm, ximg, n0, ld, ac, stage(st));
        ld.next(a);
      },
      [&](int st, bool live) {
        if (live)
          cmma::split_step<KARATSUBA, HANDOFF, BM, THREADS, PA_LD>(
              stage(st), sp.c1() - sp.c0, row_s, row_rc, a.qmax,
              sm.planes + (st & 1) * PA, dg);
        sp.next(a);
      },
      [&](int st) {
        // Two MMA depths per step; the second only where the step has
        // more than 32 channels (a group's last step may be shorter).
        if (live_cols)
          cmma::mma_step<KARATSUBA, PA_LD, PB_LD>(
              sm.planes + (st & 1) * PA,
              reinterpret_cast<const uint32_t*>(stage(st) + A_RAW),
              mm.c1() - mm.c0 > BK / 2 ? 2 : 1, wm * 32, wn * 32, g, t4, hh,
              xx, ll);
      },
      [&](int) {
        if (mm.folds(a)) {
          // Fold the exact int32 sums into the f32 sum (one recombine
          // each); HANDOFF: times the tap's power-of-two cell scale first.
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const int r = wm * 32 + 16 * j + g + 8 * (c >> 1);
              const float cell = HANDOFF ? sm.s_cell[mm.tap * BM + r] : 1.0f;
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const int mid = limb::mid_of<KARATSUBA>(
                    hh[j][i][c], xx[j][i][c], ll[j][i][c]);
                const float rec = limb::recombine(hh[j][i][c], mid,
                                                  ll[j][i][c], a.base_bits);
                acc[j][i][c] = __fadd_rn(
                    acc[j][i][c], HANDOFF ? __fmul_rn(cell, rec) : rec);
                hh[j][i][c] = xx[j][i][c] = ll[j][i][c] = 0;
              }
            }
        }
        mm.next(a);
      });

  if (POOL) {
    // The lane's rows g, g+8 of tiles 0 and 1 are window offsets 0..3 of
    // pooled pixel 8 wm + g.
    const int pp = blockIdx.y * PP + wm * 8 + g;
    if (pp >= nout) return;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int gn = n0 + wn * 32 + 8 * i + 2 * t4 + e;
        if (gn >= a.cout) continue;
        float v = 0.0f;
#pragma unroll
        for (int off = 0; off < 4; ++off) {
          const int j = off >> 1, c = 2 * (off & 1) + e;
          const int r = wm * 32 + 16 * j + g + 8 * (off & 1);
          const float t = HANDOFF ? a.wscale[gn]
                                  : __fmul_rn(sm.s_scale[r], a.wscale[gn]);
          const float d = __fmul_rn(acc[j][i][c], t);
          v = off == 0 ? d : fmaxf(v, d);
        }
        if (a.bias) v = __fadd_rn(v, a.bias[gn]);
        a.out[((size_t)img * nout + pp) * a.cout + gn] = v;
      }
    return;
  }
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int r = wm * 32 + 16 * j + g + 8 * (c >> 1);
      const int p = blockIdx.y * BM + r;
      if (p >= npix) continue;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int gn = n0 + wn * 32 + 8 * i + 2 * t4 + (c & 1);
        if (gn >= a.cout) continue;
        // HANDOFF: the activation scales were applied per tap (s_scale 1).
        a.out[((size_t)img * npix + p) * a.cout + gn] =
            HANDOFF ? (a.bias ? __fmaf_rn(acc[j][i][c], a.wscale[gn],
                                          a.bias[gn])
                              : __fmul_rn(acc[j][i][c], a.wscale[gn]))
                    : limb::dequant(acc[j][i][c], sm.s_scale[r],
                                    a.wscale[gn], a.bias, gn);
      }
    }
}

template <bool KARATSUBA, bool POOL, bool HANDOFF>
cudaError_t launch(dim3 grid_dim, cudaStream_t st, const ConvArgs& a) {
  auto* kern = implicit_conv_kernel<KARATSUBA, POOL, HANDOFF>;
  static bool sized = false;  // one attribute call per instantiation
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (e != cudaSuccess) return e;
    sized = true;
  }
  kern<<<grid_dim, THREADS, SMEM, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

LIMB_EXPORT_ERROR_STRING

// Bytes of the scratch implicit_conv_launch packs the weight's digit
// planes into.
extern "C" long long implicit_conv_scratch(int cin, int cout, int kh, int kw,
                                           int span_c, int karatsuba) {
  if (cin < 1 || cout < 1 || span_c < 1) return 0;
  return cmma::Packing(cin, cout, span_c).bytes(kh * kw, karatsuba != 0);
}

// X: (n, H, W, cin) f32 unpadded, or with `handoff` the (n, h+2, w+2, cin)
// int16 padded handoff values (then kh = kw = 3, stride 1, pads 0); Wt
// (kh, kw, cin, cout) int16; ascale (n, ho, wo) per-patch scales (NULL with
// handoff); grid (n, ceil(ho/2), ceil(wo/2)) cell scales (handoff only);
// wscale (cout); bias (cout) or NULL; out (n, ho, wo, cout) f32, or with
// `pool` (n, hp, wp, cout), hp = ho/2, wp = wo/2.  span_c: input channels
// per recombine group, or with handoff the plan's Cin chunk bk.  scratch:
// implicit_conv_scratch() bytes, 16-byte aligned, for the weight's digit
// planes (packed by a first kernel; the conv kernel follows it).
extern "C" int implicit_conv_launch(
    const void* X, const void* Wt, const void* ascale, const void* grid,
    const void* wscale, const void* bias, void* out, void* scratch,
    long long scratch_bytes, int n, int H, int W, int cin, int cout, int kh,
    int kw, int stride, int pad_t, int pad_l, int ho, int wo, int span_c,
    int qmax, int base_bits, int karatsuba, int pool, int handoff, int hp,
    int wp, void* stream) {
  const cmma::Packing pk(cin, cout, span_c);
  if (span_c < 1 || base_bits < 2 || base_bits > 8 ||
      (handoff && (kh != 3 || kw != 3)) ||
      scratch_bytes < pk.bytes(kh * kw, karatsuba != 0) ||
      reinterpret_cast<uintptr_t>(scratch) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  ConvArgs a;
  a.X = X;
  a.Wp = static_cast<const uint32_t*>(scratch);
  a.ascale = static_cast<const float*>(ascale);
  a.grid = static_cast<const float*>(grid);
  a.wscale = static_cast<const float*>(wscale);
  a.bias = static_cast<const float*>(bias);
  a.out = static_cast<float*>(out);
  a.H = H;
  a.W = W;
  a.cin = cin;
  a.cout = cout;
  a.kh = kh;
  a.kw = kw;
  a.stride = stride;
  a.pad_t = pad_t;
  a.pad_l = pad_l;
  a.ho = ho;
  a.wo = wo;
  a.span_c = span_c;
  a.qmax = qmax;
  a.base_bits = base_bits;
  a.hp = hp;
  a.wp = wp;
  a.lp = pk.lp;
  a.k4p = pk.k4p;
  a.coutp = pk.coutp;
  // 16-byte copies need every pixel row (cin elements) to start on a
  // 16-byte boundary, and so every step (multiples of span_c plus BK).
  const int per = handoff ? 8 : 4;
  a.a_vec = cin % per == 0 && span_c % per == 0 &&
            reinterpret_cast<uintptr_t>(X) % 16 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cmma::pack_weight(static_cast<const int16_t*>(Wt),
                    static_cast<uint32_t*>(scratch), kh * kw, cin, cout,
                    span_c, pk, base_bits, karatsuba != 0, st);
  const int rows = pool ? (hp * wp + PP - 1) / PP : (ho * wo + BM - 1) / BM;
  const dim3 g((cout + BN - 1) / BN, rows, n);
  cudaError_t e;
  const int mode = (karatsuba ? 4 : 0) | (pool ? 2 : 0) | (handoff ? 1 : 0);
  switch (mode) {
    case 0: e = launch<false, false, false>(g, st, a); break;
    case 1: e = launch<false, false, true>(g, st, a); break;
    case 2: e = launch<false, true, false>(g, st, a); break;
    case 3: e = launch<false, true, true>(g, st, a); break;
    case 4: e = launch<true, false, false>(g, st, a); break;
    case 5: e = launch<true, false, true>(g, st, a); break;
    case 6: e = launch<true, true, false>(g, st, a); break;
    default: e = launch<true, true, true>(g, st, a); break;
  }
  return static_cast<int>(e);
}
