// The systolic direct conv on Hopper's int8 tensor cores: NHWC / HWIO,
// every tap over the whole Cin, one recombine per output.
//
// Replaces: src/repro/kernels/conv2d/conv2d.py:_conv_kernel
// (conv2d_systolic_raw), the paper's systolic conv engine.  On the TPU each
// grid step owned a (bh x WO x bc) output tile, bound two row blocks of the
// input to get its halo, and streamed the kh*kw shifted views through the
// MXU.  Here the conv is a GEMM with M = n*ho*wo output pixels (flattened
// over the batch), K = kh*kw*cin, N = cout; the patch matrix never exists
// in device memory and the halo is indexing into the unpadded input, zero
// outside the map.
//
// Arithmetic (held bit for bit against the plain version): the input
// arrives quantized per SAMPLE as int16 (the reference quantizes outside
// its kernel), so nothing is quantized here; the weight is int16.  THREE
// int32 accumulators run over all kh*kw*cin terms -- the wrapper keeps
// int_accum_bound below 2^31, so the true sums are in range and the MMA's
// two's-complement wrap gives the same integers in any order -- then ONE
// f32 recombine and the epilogue fl(fl(raw * scale[n, c]) + b): a
// __fmul_rn, then a separate __fadd_rn, never an FMA (the reference
// multiplies inside its kernel and adds the bias outside it).
//
// The native variant is the implicit engine's float kernel
// (implicit_conv_float.cu): the same function.
//
// What bounds it on this card: VGG16's convs (15.5 G MAC per image) are
// bound by their int8 passes (1,979 TOP/s): 3 digit products per MAC
// under Karatsuba, 4 under schoolbook; input and output are a few MB.
// What the design does about it (conv_mma.cuh, shared with
// implicit_conv.cu):
//   * the passes run as mma.sync m16n8k32 s8 on the tensor cores, eight
//     warps of 32 x 32 outputs: a 64 x 128 block tile, or 128 x 64 where
//     cout <= 64 (VGG16's first two convs), so no warp idles there;
//   * a first kernel splits the weight once per call into packed digit
//     planes (the same weight serves every image and pixel block);
//   * a 4-stage cp.async ring brings each K step's int16 pixels (16-byte
//     copies, zero-filled outside the map) and weight planes; all threads
//     split the step's pixels into digit planes once for all the block's
//     output channels while the tensor cores run the previous step;
//   * a K step is 64 channels of one tap; a layer whose cin is not a
//     multiple of 8 (the RGB stem, cin 3) walks the flat (tap, channel)
//     index instead, 27 -> one 32-deep MMA, with element copies;
//   * rows are flattened over the batch, so the last pixel block of an
//     image no longer runs mostly empty; where the grid still leaves its
//     waves mostly empty (VGG16's 14 x 14 layers: 100 tiles on 132 SMs)
//     the K steps split over grid.z (systolic_plan in
//     kernels/conv2d/conv2d.py) and the splits add their int32 sums into
//     a scratch by integer atomics -- exact in any order -- which a second
//     kernel recombines.
#include "conv_mma.cuh"

namespace {

using cmma::A_I16_LD;
using cmma::BK;
using cmma::KQ;
constexpr int THREADS = 256, WARPS = THREADS / 32;
constexpr int STAGES = 4;
constexpr int OUTSIDE = -(1 << 28);

// The block tile: WM x (8 / WM) warps of 32 x 32 outputs.  Shared memory:
// the ring (per stage the raw int16 input tile, then the weight's digit
// planes), two buffers of the input's digit planes, the row tables.
template <int WM>
struct Tile {
  static constexpr int BM = 32 * WM, WN = WARPS / WM, BN = 32 * WN;
  static constexpr int PA_LD = BM + 8, PB_LD = BN + 8;
  static constexpr int A_RAW = BM * A_I16_LD * 2;
  static constexpr int STAGE = A_RAW + 3 * KQ * PB_LD * 4;
  static constexpr int PA = 3 * KQ * PA_LD;  // words: [plane][K quad][row]
  static constexpr int SMEM = STAGES * STAGE + 2 * PA * 4 + BM * (8 + 12);
  // 16-byte copies: 8 channels each, BK / 8 per row.
  static constexpr int CPR = BK / 8, COPIES = BM * CPR / THREADS;
};

struct SysArgs {
  const int16_t* X;
  const uint32_t* Wp;  // the weight's digit planes (pack_weight_kernel)
  const float* scale;
  const float* bias;
  float* out;
  int* acc;       // split K: the (3, M, cout) int32 sums, else NULL
  int H, W, cin, cout, kw, stride, pad_t, pad_l, ho, wo, base_bits;
  int M;          // output pixels over the batch
  int flat;       // the K walk runs over the flat (tap, channel) index
  int kdim;       // K entries per tap: cin, or kh * kw * cin when flat
  int csteps;     // K steps per tap
  int nsteps;     // K steps in all
  int per_split;  // K steps per split (blockIdx.z)
  int k4p, coutp;
};

// A position in the K walk: step channels [c0, c0 + BK) of tap (dy, dx)
// (flat: entries [c0, c0 + BK) of the flat index, tap 0), kept
// incrementally.
struct KPos {
  int tap, dy, dx, c0;
  __device__ __forceinline__ void start(const SysArgs& a, int s) {
    tap = s / a.csteps;
    c0 = (s - tap * a.csteps) * BK;
    dy = tap / a.kw;
    dx = tap - dy * a.kw;
  }
  __device__ __forceinline__ int live(const SysArgs& a) const {
    return min(BK, a.kdim - c0);
  }
  __device__ __forceinline__ void next(const SysArgs& a) {
    c0 += BK;
    if (c0 < a.kdim) return;
    c0 = 0;
    ++tap;
    if (++dx == a.kw) {
      dx = 0;
      ++dy;
    }
  }
};

// Row tables in shared memory: each row's image offset, patch origin and
// image.
struct Rows {
  long long* base;
  int *iy, *ix, *img;
};

// The 16-byte copies of one thread: the same channel chunk of rows
// (tid + i * THREADS) / CPR, whose image offsets and origins stay in
// registers.
template <int WM>
struct ACopies {
  long long base[Tile<WM>::COPIES];
  int iy[Tile<WM>::COPIES], ix[Tile<WM>::COPIES];
};

// Issues the copies of one K step into a ring stage: the raw int16 pixels
// of every row (zeros outside the map and past the step's entries), then
// the weight's digit-plane rows.
template <int WM, bool KARATSUBA>
__device__ __forceinline__ void load_step(const SysArgs& a, const KPos& kp,
                                          const Rows& rows,
                                          const ACopies<WM>& ac, int n0,
                                          char* base) {
  using T = Tile<WM>;
  const int tid = threadIdx.x;
  int16_t* raw = reinterpret_cast<int16_t*>(base);
  if (!a.flat) {
    const int u = tid % T::CPR, c = kp.c0 + 8 * u;
#pragma unroll
    for (int i = 0; i < T::COPIES; ++i) {
      const int r = (tid + i * THREADS) / T::CPR;
      const int iy = ac.iy[i] + kp.dy, ix = ac.ix[i] + kp.dx;
      const bool ok = (unsigned)iy < (unsigned)a.H &&
                      (unsigned)ix < (unsigned)a.W && c < a.cin;
      const long long off =
          ok ? ac.base[i] + ((long long)iy * a.W + ix) * a.cin + c : 0;
      lmma::cp_async16(raw + r * A_I16_LD + 8 * u, a.X + off, ok);
    }
  } else {
    for (int e = tid; e < T::BM * BK; e += THREADS) {
      const int r = e / BK, kk = e % BK, k = kp.c0 + kk;
      int16_t v = 0;
      if (k < a.kdim) {
        const int tap = k / a.cin, c = k - tap * a.cin;
        const int dy = tap / a.kw, dx = tap - dy * a.kw;
        const int iy = rows.iy[r] + dy, ix = rows.ix[r] + dx;
        if ((unsigned)iy < (unsigned)a.H && (unsigned)ix < (unsigned)a.W)
          v = a.X[rows.base[r] + ((long long)iy * a.W + ix) * a.cin + c];
      }
      raw[r * A_I16_LD + kk] = v;
    }
  }
  constexpr int P = KARATSUBA ? 3 : 2;
  cmma::load_b<P, KQ, T::BN, T::PB_LD, THREADS>(
      reinterpret_cast<uint32_t*>(base + T::A_RAW),
      a.Wp + ((size_t)kp.tap * P * a.k4p + kp.c0 / 4) * a.coutp, a.Wp,
      a.k4p, a.coutp, n0);
}

// One output: ONE f32 recombine, then fl(fl(raw * scale) + bias).
template <bool KARATSUBA>
__device__ __forceinline__ float epilogue(int hh, int x, int ll, int img,
                                          int gn, const SysArgs& a) {
  const int mid = limb::mid_of<KARATSUBA>(hh, x, ll);
  float v = limb::recombine(hh, mid, ll, a.base_bits);
  if (a.scale) v = __fmul_rn(v, a.scale[(size_t)img * a.cout + gn]);
  if (a.bias) v = __fadd_rn(v, a.bias[gn]);
  return v;
}

template <bool KARATSUBA, int WM>
__global__ void __launch_bounds__(THREADS)
    systolic_kernel(const SysArgs a) {
  using T = Tile<WM>;
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  uint32_t* planes = reinterpret_cast<uint32_t*>(smem + STAGES * T::STAGE);
  Rows rows;
  rows.base = reinterpret_cast<long long*>(planes + 2 * T::PA);
  rows.iy = reinterpret_cast<int*>(rows.base + T::BM);
  rows.ix = rows.iy + T::BM;
  rows.img = rows.ix + T::BM;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = warp / T::WN, wn = warp % T::WN;
  const int m0 = blockIdx.x * T::BM, n0 = blockIdx.y * T::BN;
  const int npix = a.ho * a.wo;

  for (int m = tid; m < T::BM; m += THREADS) {
    const int R = m0 + m;
    if (R < a.M) {
      const int img = R / npix, p = R - img * npix, oy = p / a.wo;
      rows.img[m] = img;
      rows.base[m] = (long long)img * a.H * a.W * a.cin;
      rows.iy[m] = oy * a.stride - a.pad_t;
      rows.ix[m] = (p - oy * a.wo) * a.stride - a.pad_l;
    } else {
      rows.img[m] = 0;
      rows.base[m] = 0;
      rows.iy[m] = OUTSIDE;
      rows.ix[m] = 0;
    }
  }
  __syncthreads();

  ACopies<WM> ac;
#pragma unroll
  for (int i = 0; i < T::COPIES; ++i) {
    const int r = (tid + i * THREADS) / T::CPR;
    ac.base[i] = rows.base[r];
    ac.iy[i] = rows.iy[r];
    ac.ix[i] = rows.ix[r];
  }
  const int s0 = blockIdx.z * a.per_split;
  const int nst = min(a.per_split, a.nsteps - s0);
  // Warps whose 32 columns all lie past cout skip the MMAs.
  const bool live_cols = n0 + wn * 32 < a.cout;
  const lmma::Digits dg(a.base_bits);

  int hh[2][4][4], xx[2][4][4], ll[2][4][4];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) hh[j][i][c] = xx[j][i][c] = ll[j][i][c] = 0;

  auto stage = [&](int st) { return smem + (st % STAGES) * T::STAGE; };
  KPos ld, mm;  // loader and consumer positions
  ld.start(a, s0);
  mm = ld;
  cmma::ring_walk<STAGES>(
      nst,
      [&](int st, bool live) {
        if (live) load_step<WM, KARATSUBA>(a, ld, rows, ac, n0, stage(st));
        ld.next(a);
      },
      [&](int st, bool live) {
        // Entries past a step's end are zeros in both operands.
        if (live)
          cmma::split_step<KARATSUBA, true, T::BM, THREADS, T::PA_LD>(
              stage(st), BK, 1.0f, 1.0f, 0, planes + (st & 1) * T::PA, dg);
      },
      [&](int st) {
        // The second MMA depth only where the step has more than 32
        // entries (a tap's last step, the stem's 27).
        if (live_cols)
          cmma::mma_step<KARATSUBA, T::PA_LD, T::PB_LD>(
              planes + (st & 1) * T::PA,
              reinterpret_cast<const uint32_t*>(stage(st) + T::A_RAW),
              mm.live(a) > BK / 2 ? 2 : 1, wm * 32, wn * 32, g, t4, hh, xx,
              ll);
      },
      [&](int) { mm.next(a); });

  if (!live_cols) return;
  const size_t plane = (size_t)a.M * a.cout;
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int r = wm * 32 + 16 * j + g + 8 * (c >> 1);
      const int R = m0 + r;
      if (R >= a.M) continue;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int gn = n0 + wn * 32 + 8 * i + 2 * t4 + (c & 1);
        if (gn >= a.cout) continue;
        const size_t o = (size_t)R * a.cout + gn;
        if (a.acc) {  // integer sums: exact in any order
          atomicAdd(a.acc + o, hh[j][i][c]);
          atomicAdd(a.acc + plane + o, xx[j][i][c]);
          atomicAdd(a.acc + 2 * plane + o, ll[j][i][c]);
        } else {
          a.out[o] = epilogue<KARATSUBA>(hh[j][i][c], xx[j][i][c],
                                         ll[j][i][c], rows.img[r], gn, a);
        }
      }
    }
}

// Split K: the recombine and epilogue of the summed (3, M, cout) sums.
template <bool KARATSUBA>
__global__ void finish_kernel(const SysArgs a) {
  const size_t plane = (size_t)a.M * a.cout;
  const int npix = a.ho * a.wo;
  for (size_t o = blockIdx.x * (size_t)blockDim.x + threadIdx.x; o < plane;
       o += (size_t)gridDim.x * blockDim.x) {
    const int R = (int)(o / a.cout), gn = (int)(o - (size_t)R * a.cout);
    a.out[o] = epilogue<KARATSUBA>(a.acc[o], a.acc[plane + o],
                                   a.acc[2 * plane + o], R / npix, gn, a);
  }
}

template <bool KARATSUBA, int WM>
cudaError_t launch(dim3 grid_dim, cudaStream_t st, const SysArgs& a) {
  auto* kern = systolic_kernel<KARATSUBA, WM>;
  static_assert(Tile<WM>::SMEM <= 227 * 1024,
                "dynamic shared memory past a Hopper block's 227 KB");
  static bool sized = false;  // one attribute call per instantiation
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Tile<WM>::SMEM);
    if (e != cudaSuccess) return e;
    sized = true;
  }
  kern<<<grid_dim, THREADS, Tile<WM>::SMEM, st>>>(a);
  return cudaGetLastError();
}

// The scratch's layout: the packed weight, then (split K) the int32 sums.
struct Scratch {
  cmma::Packing pk;
  long long pack_bytes, acc_bytes;
  Scratch(int cin, int cout, int kh, int kw, int flat, int m, int splits,
          bool karatsuba)
      : pk(flat ? kh * kw * cin : cin, cout, flat ? kh * kw * cin : cin) {
    pack_bytes = (pk.bytes(flat ? 1 : kh * kw, karatsuba) + 15) / 16 * 16;
    acc_bytes = splits > 1 ? 12LL * m * cout : 0;
  }
};

}  // namespace

LIMB_EXPORT_ERROR_STRING

// Bytes of the scratch systolic_conv_launch needs: the weight's digit
// planes and, when the K steps split (splits > 1), the (3, m, cout) int32
// sums.
extern "C" long long systolic_conv_scratch(int cin, int cout, int kh, int kw,
                                           int flat, int m, int splits,
                                           int karatsuba) {
  if (cin < 1 || cout < 1 || kh < 1 || kw < 1 || m < 0 || splits < 1)
    return 0;
  const Scratch sc(cin, cout, kh, kw, flat, m, splits, karatsuba != 0);
  return sc.pack_bytes + sc.acc_bytes;
}

// X: (n, H, W, cin) int16 quantized per sample, UNPADDED (pads = top, left;
// bottom/right follow from ho, wo); Wt (kh, kw, cin, cout) int16; scale
// (n, cout) f32 = s_sample * s_ch, or NULL for the raw recombined sums;
// bias (cout) or NULL; out (n, ho, wo, cout) f32.  The plan
// (kernels/conv2d/conv2d.py systolic_plan): `flat` K walk (required unless
// cin % 8 == 0 and X is 16-byte aligned), block tile wm (2: 64 x 128, 4:
// 128 x 64), `splits` of `per_split` K steps each.  scratch:
// systolic_conv_scratch() bytes, 16-byte aligned.
extern "C" int systolic_conv_launch(
    const void* X, const void* Wt, const void* scale, const void* bias,
    void* out, void* scratch, long long scratch_bytes, int n, int H, int W,
    int cin, int cout, int kh, int kw, int stride, int pad_t, int pad_l,
    int ho, int wo, int base_bits, int karatsuba, int flat, int wm,
    int splits, int per_split, void* stream) {
  SysArgs a;
  a.M = n * ho * wo;
  a.kdim = flat ? kh * kw * cin : cin;
  a.csteps = (a.kdim + BK - 1) / BK;
  a.nsteps = a.csteps * (flat ? 1 : kh * kw);
  const Scratch sc(cin, cout, kh, kw, flat, a.M, splits, karatsuba != 0);
  if (base_bits < 2 || base_bits > 8 || (wm != 2 && wm != 4) ||
      splits < 1 || per_split < 1 || (long long)per_split * splits < a.nsteps ||
      (long long)per_split * (splits - 1) >= a.nsteps ||
      (!flat && (cin % 8 != 0 || reinterpret_cast<uintptr_t>(X) % 16 != 0)) ||
      scratch_bytes < sc.pack_bytes + sc.acc_bytes ||
      reinterpret_cast<uintptr_t>(scratch) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  a.X = static_cast<const int16_t*>(X);
  a.Wp = static_cast<const uint32_t*>(scratch);
  a.scale = static_cast<const float*>(scale);
  a.bias = static_cast<const float*>(bias);
  a.out = static_cast<float*>(out);
  a.acc = splits > 1 ? reinterpret_cast<int*>(static_cast<char*>(scratch) +
                                              sc.pack_bytes)
                     : nullptr;
  a.H = H;
  a.W = W;
  a.cin = cin;
  a.cout = cout;
  a.kw = kw;
  a.stride = stride;
  a.pad_t = pad_t;
  a.pad_l = pad_l;
  a.ho = ho;
  a.wo = wo;
  a.base_bits = base_bits;
  a.flat = flat;
  a.per_split = per_split;
  a.k4p = sc.pk.k4p;
  a.coutp = sc.pk.coutp;
  cmma::pack_weight(static_cast<const int16_t*>(Wt),
                    static_cast<uint32_t*>(scratch), flat ? 1 : kh * kw,
                    a.kdim, cout, a.kdim, sc.pk, base_bits, karatsuba != 0,
                    st);
  if (a.acc) {
    const cudaError_t e = cudaMemsetAsync(a.acc, 0, sc.acc_bytes, st);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int bm = 32 * wm, bn = 32 * (WARPS / wm);
  const dim3 g((a.M + bm - 1) / bm, (cout + bn - 1) / bn, splits);
  cudaError_t e;
  const int mode = (karatsuba ? 2 : 0) | (wm == 4 ? 1 : 0);
  switch (mode) {
    case 0: e = launch<false, 2>(g, st, a); break;
    case 1: e = launch<false, 4>(g, st, a); break;
    case 2: e = launch<true, 2>(g, st, a); break;
    default: e = launch<true, 4>(g, st, a); break;
  }
  if (e != cudaSuccess || !a.acc) return static_cast<int>(e);
  const long long outs = (long long)a.M * cout;
  const int blocks = (int)((outs + 255) / 256 < 8192 ? (outs + 255) / 256
                                                     : 8192);
  if (karatsuba)
    finish_kernel<true><<<blocks, 256, 0, st>>>(a);
  else
    finish_kernel<false><<<blocks, 256, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}
