// Implicit-GEMM float convolution on Hopper: the float variants of the
// implicit conv engine, NHWC / HWIO, bias epilogue.
//
// Replaces: src/repro/kernels/conv2d/implicit_gemm.py:_implicit_kernel
// (conv2d_implicit_raw), variants native, bf16x3 and bf16x6 with the
// bias_relu epilogue.  The TPU kernel accumulated per (Cin block, tap) dot
// into one f32 VMEM scratch over its sequential K grid; here one thread
// block owns BM output pixels (flattened over the batch) x BN output
// channels and walks every tap and the whole Cin itself, tap outer, Cin
// inner.  The systolic engine's native variant is this kernel too.
// Epilogue fl(acc + bias); the ReLU follows in the wrapper.
//
// What bounds it on this card: the multiply-adds.  native is one f32 FMA
// per MAC on the CUDA cores (67 TFLOP/s; VGG16 is 15.5 G MAC per image);
// the bf16 schedules are 3 or 6 exact bf16 x bf16 products per MAC, which
// is what the tensor cores compute (989 TFLOP/s).  What the design does:
//   * a cp.async ring (STAGES tiles of BK K entries, 16-byte copies) feeds
//     every tile: BK channels of one tap of the UNPADDED NHWC input per
//     pixel (a pixel outside the map is zero-filled by a src-size of 0, so
//     the padding stays indexing) and BK rows of the HWIO weight along
//     Cout; one barrier per tile;
//   * native: a register-blocked SIMT tile, 8 x 8 outputs per thread as
//     four 4 x 4 quadrants, so each K entry costs four conflict-free
//     float4 shared loads (amortised) for 64 FMAs;
//   * bf16x3 / bf16x6: a first kernel splits every input and weight
//     element ONCE into bf16 limb planes (__float2bfloat16_rn, residual in
//     f32; a split inside the conv kernel, once per loaded tile, cost it
//     30-40% of its time on an H100); the conv kernel's ring carries the
//     limbs, and each limb pair of the schedule runs as mma.sync m16n8k16
//     bf16 -> f32 (HMMA) from ldmatrix fragments, warp tile 64 x 32;
//   * a layer whose Cin is not a multiple of BK (the stem, cin 3) or whose
//     Cout does not fill a 16-byte copy takes the generic path: the taps
//     fold into K (kh*kw*cin flat entries, 27 at the stem) and the loads
//     are element gathers, so no tile is mostly zeros;
//   * the tile is 256 x 64 where Cout <= 64, else 128 x 128; where those
//     tiles give fewer than two blocks per SM (VGG16's 28 x 28 and 14 x 14
//     layers at batch 8), the taps split into groups (grid z), each block
//     writes its group's f32 sum to scratch, and a second kernel adds the
//     groups in order, then the bias (no atomics: the same from run to
//     run).
//
// Arithmetic contract (float_tile.cuh; -fmad=false):
//   * native: one __fmaf_rn per product into a chunk partial of at most
//     SIMT_CHUNK channels of one tap (generic path: flat K entries), added
//     with __fadd_rn into the tap group's total, the groups' totals added
//     in order;
//   * bf16 schedules: per k16 step and (m16, n8) tile, a zeroed fragment
//     takes the schedule's pairs in order (BF16X6_TAP for bf16x6), each an
//     MMA of exact products that the tensor core sums with its own
//     alignment; the fragment is added with __fadd_rn into a chunk partial
//     of at most TC_CHUNK channels, the chunk into the tap group's total,
//     the groups' totals in order.
// Both orders stay within ~3e-7 of the largest output from the schedule's
// exact value at VGG16's deepest K (3 x 3 x 512) while the schedules lie
// ~4e-6 apart (tests/test_torch_float_order.py emulates both orders, the
// MMA rounding toward zero).  mma_probe_launch runs single MMAs for the
// probe that measures the tensor core's own rounding
// (repro_torch/analysis/mma_probe.py).
#include "float_tile.cuh"

namespace {

using ftile::Sched;

constexpr int STAGES = 3;
constexpr int BK = 32;            // K entries per ring tile
constexpr int SIMT_CHUNK = 128;   // K entries per nested partial, SIMT
constexpr int TC_CHUNK = 512;     // K entries per nested partial, MMA
constexpr int OUTSIDE = -(1 << 28);

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// 16-byte copy; valid == false fills the 16 bytes with zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

struct ConvArgs {
  const float* X;
  const float* Wt;
  const __nv_bfloat16* XL;   // limb planes of X (bf16 schedules)
  const __nv_bfloat16* WL;   // limb planes of Wt
  long long xplane, wplane;  // elements per limb plane
  const float* bias;
  float* out;
  float* part;  // (groups, M, cout) f32 group sums when groups > 1
  int H, W, cin, cout, kh, kw, stride, pad_t, pad_l, ho, wo;
  int M;       // n * ho * wo
  int groups;  // tap groups (grid z); 1 on the generic path
};

// Fills the block's pixel table: image base pixel, first input row and
// column of each of the BM output pixels (OUTSIDE past M).
template <int BM, int THREADS>
__device__ __forceinline__ void pixel_table(const ConvArgs& a, int m0,
                                            int* s_base, int* s_iy,
                                            int* s_ix) {
  const int npix = a.ho * a.wo;
  for (int i = threadIdx.x; i < BM; i += THREADS) {
    const int m = m0 + i;
    if (m < a.M) {
      const int img = m / npix, p = m - img * npix;
      const int oy = p / a.wo, ox = p - oy * a.wo;
      s_base[i] = img * a.H * a.W;
      s_iy[i] = oy * a.stride - a.pad_t;
      s_ix[i] = ox * a.stride - a.pad_l;
    } else {
      s_base[i] = 0;
      s_iy[i] = OUTSIDE;
      s_ix[i] = 0;
    }
  }
}

// Element offset in X of a pixel's input at flat K entry kk (tap-major),
// or -1 outside the map.
__device__ __forceinline__ long long gather_offset(const ConvArgs& a, int kk,
                                                   int base, int iy0,
                                                   int ix0) {
  const int tap = kk / a.cin, c = kk - tap * a.cin;
  const int dy = tap / a.kw, dx = tap - dy * a.kw;
  const int iy = iy0 + dy, ix = ix0 + dx;
  if (iy < 0 || iy >= a.H || ix < 0 || ix >= a.W) return -1;
  return (long long)(base + iy * a.W + ix) * a.cin + c;
}

// Tiles of one tap group's K walk, and whether tile st closes a nested
// partial of `chunk` K entries (FAST: counted within each tap; else over
// flat K).  Tile st of group z is tile z * num_tiles + st of the layer.
template <bool FAST>
__device__ __forceinline__ int num_tiles(const ConvArgs& a) {
  return FAST ? a.kh * a.kw / a.groups * (a.cin / BK)
              : (a.kh * a.kw * a.cin + BK - 1) / BK;
}
template <bool FAST>
__device__ __forceinline__ bool closes_chunk(const ConvArgs& a, int st,
                                             int chunk) {
  if constexpr (FAST) {
    const int c_end = (st % (a.cin / BK) + 1) * BK;
    return c_end % chunk == 0 || c_end == a.cin;
  } else {
    const int k_end = (st + 1) * BK;
    return k_end % chunk == 0 || k_end >= a.kh * a.kw * a.cin;
  }
}

__device__ __forceinline__ float epilogue(float acc, const float* bias,
                                          int col) {
  return bias ? __fadd_rn(acc, bias[col]) : acc;
}

// Where a block's sums go: the output (bias added) with one tap group, the
// group's slice of the scratch (no bias) with several.
struct Sink {
  float* base;
  const float* bias;
  __device__ Sink(const ConvArgs& a)
      : base(a.groups > 1 ? a.part + (size_t)blockIdx.z * a.M * a.cout
                          : a.out),
        bias(a.groups > 1 ? nullptr : a.bias) {}
  __device__ float operator()(float acc, int col) const {
    return epilogue(acc, bias, col);
  }
};

// out = ((group 0 + group 1) + ...) + bias, four elements per thread.
__global__ void combine_groups_kernel(const float4* __restrict__ part,
                                      const float* __restrict__ bias,
                                      float4* __restrict__ out,
                                      long long n4, int cout, int groups) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < n4; i += (long long)gridDim.x * blockDim.x) {
    float4 s = part[i];
    for (int g = 1; g < groups; ++g) {
      const float4 p = part[g * n4 + i];
      s.x = __fadd_rn(s.x, p.x);
      s.y = __fadd_rn(s.y, p.y);
      s.z = __fadd_rn(s.z, p.z);
      s.w = __fadd_rn(s.w, p.w);
    }
    if (bias) {
      const int c = (int)((4 * i) % cout);
      s.x = __fadd_rn(s.x, bias[c]);
      s.y = __fadd_rn(s.y, bias[c + 1]);
      s.z = __fadd_rn(s.z, bias[c + 2]);
      s.w = __fadd_rn(s.w, bias[c + 3]);
    }
    out[i] = s;
  }
}

// ---------------------------------------------------------------------------
// native: the SIMT tile over an f32 ring.  THREADS = BM*BN/64; thread
// (ty, tx) owns rows ty*4 + {0..3} and BM/2 + ty*4 + {0..3}, columns tx*4 +
// {0..3} and BN/2 + tx*4 + {0..3}.  A quarter-warp shares ty, so its A
// reads are one broadcast float4 and its B reads 128 contiguous bytes.
// ---------------------------------------------------------------------------
template <int BM, int BN>
struct Ring {
  static constexpr int A_FLOATS = BM * BK;  // [BM][BK]: K contiguous
  static constexpr int B_FLOATS = BK * BN;  // [BK][BN]: Cout contiguous
  static constexpr int STAGE_FLOATS = A_FLOATS + B_FLOATS;
  static constexpr size_t bytes() {
    return sizeof(int) * 3 * BM + sizeof(float) * STAGES * STAGE_FLOATS;
  }
};

// Issues the copies of ring tile `st` into sA/sB.  FAST: BK channels of
// one tap (cin % BK == 0, cout % 4 == 0, 16-byte aligned operands),
// 16-byte copies; else BK flat K entries, 4-byte copies.
template <int BM, int BN, int THREADS, bool FAST>
__device__ __forceinline__ void load_tile(const ConvArgs& a, int st, int n0,
                                          const int* s_base,
                                          const int* s_iy, const int* s_ix,
                                          float* sA, float* sB) {
  const int tid = threadIdx.x;
  if constexpr (FAST) {
    const int cps = a.cin / BK;
    const int tap = st / cps, c0 = (st - tap * cps) * BK;
    const int dy = tap / a.kw, dx = tap - dy * a.kw;
    for (int q = tid; q < BM * BK / 4; q += THREADS) {
      const int i = q / (BK / 4), k4 = q % (BK / 4);
      const int iy = s_iy[i] + dy, ix = s_ix[i] + dx;
      const bool ok = iy >= 0 && iy < a.H && ix >= 0 && ix < a.W;
      const float* src =
          ok ? a.X + ((size_t)(s_base[i] + iy * a.W + ix) * a.cin + c0 +
                      k4 * 4)
             : a.X;
      cp_async16(sA + i * BK + k4 * 4, src, ok);
    }
    const float* wrow = a.Wt + ((size_t)tap * a.cin + c0) * a.cout;
    for (int q = tid; q < BK * BN / 4; q += THREADS) {
      const int k = q / (BN / 4), n = (q % (BN / 4)) * 4;
      const bool ok = n0 + n < a.cout;
      cp_async16(sB + k * BN + n,
                 ok ? wrow + (size_t)k * a.cout + n0 + n : a.Wt, ok);
    }
  } else {
    const int K = a.kh * a.kw * a.cin;
    const int kk0 = st * BK;
    for (int q = tid; q < BM * BK; q += THREADS) {
      const int i = q / BK, kk = kk0 + q % BK;
      const long long off =
          kk < K ? gather_offset(a, kk, s_base[i], s_iy[i], s_ix[i]) : -1;
      cp_async4(sA + q, off >= 0 ? a.X + off : a.X, off >= 0);
    }
    for (int q = tid; q < BK * BN; q += THREADS) {
      const int k = q / BN, n = q % BN, kk = kk0 + k;
      const bool ok = kk < K && n0 + n < a.cout;
      cp_async4(sB + q, ok ? a.Wt + (size_t)kk * a.cout + n0 + n : a.Wt, ok);
    }
  }
}

template <int BM, int BN, bool FAST>
__global__ void __launch_bounds__(BM * BN / 64)
    conv_simt_kernel(const ConvArgs a) {
  constexpr int THREADS = BM * BN / 64, TX = BN / 8;
  using R = Ring<BM, BN>;
  extern __shared__ float4 smem4[];
  int* s_base = reinterpret_cast<int*>(smem4);
  int* s_iy = s_base + BM;
  int* s_ix = s_iy + BM;
  float* ring = reinterpret_cast<float*>(s_ix + BM);
  const int tid = threadIdx.x, ty = tid / TX, tx = tid % TX;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  pixel_table<BM, THREADS>(a, m0, s_base, s_iy, s_ix);
  __syncthreads();

  float acc[8][8], part[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = part[i][j] = 0.0f;

  const int nst = num_tiles<FAST>(a), st0 = blockIdx.z * nst;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nst)
      load_tile<BM, BN, THREADS, FAST>(a, st0 + s, n0, s_base, s_iy, s_ix,
                                           ring + s * R::STAGE_FLOATS,
                                           ring + s * R::STAGE_FLOATS +
                                               R::A_FLOATS);
    cp_async_commit();
  }
  for (int st = 0; st < nst; ++st) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile st landed; every thread is done with st - 1
    {
      const int ns = st + STAGES - 1;
      if (ns < nst) {
        float* dst = ring + (ns % STAGES) * R::STAGE_FLOATS;
        load_tile<BM, BN, THREADS, FAST>(a, st0 + ns, n0, s_base, s_iy,
                                         s_ix, dst, dst + R::A_FLOATS);
      }
      cp_async_commit();
    }
    const float* sA = ring + (st % STAGES) * R::STAGE_FLOATS;
    const float* sB = sA + R::A_FLOATS;
#pragma unroll
    for (int kq = 0; kq < BK / 4; ++kq) {
      float4 av[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = (i < 4 ? 0 : BM / 2) + ty * 4 + (i & 3);
        av[i] = *reinterpret_cast<const float4*>(sA + r * BK + kq * 4);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float* brow = sB + (kq * 4 + kk) * BN + tx * 4;
        const float4 b0 = *reinterpret_cast<const float4*>(brow);
        const float4 b1 = *reinterpret_cast<const float4*>(brow + BN / 2);
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float ai = kk == 0 ? av[i].x
                           : kk == 1 ? av[i].y
                           : kk == 2 ? av[i].z
                                     : av[i].w;
#pragma unroll
          for (int j = 0; j < 8; ++j)
            part[i][j] = __fmaf_rn(ai, b[j], part[i][j]);
        }
      }
    }
    if (closes_chunk<FAST>(a, st0 + st, SIMT_CHUNK)) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[i][j] = __fadd_rn(acc[i][j], part[i][j]);
          part[i][j] = 0.0f;
        }
    }
  }
  cp_async_wait<0>();

  const Sink sink(a);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? 0 : BM / 2) + ty * 4 + (i & 3);
    if (m >= a.M) continue;
    float* orow = sink.base + (size_t)m * a.cout;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = n0 + h * (BN / 2) + tx * 4;
      if (FAST && c < a.cout) {  // cout % 4 == 0: the quad is whole
        float4 v;
        v.x = sink(acc[i][h * 4 + 0], c + 0);
        v.y = sink(acc[i][h * 4 + 1], c + 1);
        v.z = sink(acc[i][h * 4 + 2], c + 2);
        v.w = sink(acc[i][h * 4 + 3], c + 3);
        *reinterpret_cast<float4*>(orow + c) = v;
      } else if (!FAST) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c + j < a.cout)
            orow[c + j] = sink(acc[i][h * 4 + j], c + j);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 schedules: the limb planes, split once, then mma.sync m16n8k16 over
// a ring of limb tiles.  (BM/64) x (BN/32) warps, warp tile 64 x 32 (four
// m16 x four n8 MMA tiles).
// ---------------------------------------------------------------------------
template <int S>
__global__ void split_limbs_kernel(const float* __restrict__ x,
                                   __nv_bfloat16* __restrict__ out,
                                   long long n, long long plane) {
  constexpr int L = Sched<S>::limbs;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float l[L];
    ftile::split<S>(x[i], l);
#pragma unroll
    for (int t = 0; t < L; ++t) out[t * plane + i] = __float2bfloat16_rn(l[t]);
  }
}

__device__ __forceinline__ void ldsm_x4(unsigned addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(unsigned addr,
                                              uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
// d += A(16x16, row) * B(16x8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One ring stage: L limb tiles of A [BM][A_LD] then L of B [BK][B_LD],
// bf16; the row pads (8 bf16) keep every ldmatrix conflict-free.
template <int S, int BM, int BN>
struct LimbRing {
  static constexpr int L = Sched<S>::limbs;
  static constexpr int A_LD = BK + 8;
  static constexpr int B_LD = BN + 8;
  static constexpr int A_ELEMS = BM * A_LD;
  static constexpr int B_ELEMS = BK * B_LD;
  static constexpr int STAGE_ELEMS = L * (A_ELEMS + B_ELEMS);
  static constexpr size_t bytes() {
    return sizeof(int) * 3 * BM +
           sizeof(__nv_bfloat16) * STAGES * STAGE_ELEMS;
  }
};

// Loads ring tile `st` of the limb planes into one stage.  FAST: BK
// channels of one tap (cin % BK == 0, cout % 8 == 0), 16-byte copies
// of 8 bf16; else BK flat K entries, element loads.
template <int S, int BM, int BN, int THREADS, bool FAST>
__device__ __forceinline__ void load_limbs(const ConvArgs& a, int st, int n0,
                                           const int* s_base,
                                           const int* s_iy, const int* s_ix,
                                           __nv_bfloat16* stage) {
  using LR = LimbRing<S, BM, BN>;
  constexpr int L = LR::L, KB = BK;
  __nv_bfloat16* sA = stage;
  __nv_bfloat16* sB = stage + L * LR::A_ELEMS;
  const int tid = threadIdx.x;
  if constexpr (FAST) {
    const int cps = a.cin / KB;
    const int tap = st / cps, c0 = (st - tap * cps) * KB;
    const int dy = tap / a.kw, dx = tap - dy * a.kw;
    for (int q = tid; q < BM * (KB / 8); q += THREADS) {
      const int i = q / (KB / 8), k8 = q % (KB / 8);
      const int iy = s_iy[i] + dy, ix = s_ix[i] + dx;
      const bool ok = iy >= 0 && iy < a.H && ix >= 0 && ix < a.W;
      const size_t off =
          ok ? (size_t)(s_base[i] + iy * a.W + ix) * a.cin + c0 + k8 * 8 : 0;
#pragma unroll
      for (int t = 0; t < L; ++t)
        cp_async16(sA + t * LR::A_ELEMS + i * LR::A_LD + k8 * 8,
                   a.XL + t * a.xplane + off, ok);
    }
    const size_t wrow = ((size_t)tap * a.cin + c0) * a.cout + n0;
    for (int q = tid; q < KB * (BN / 8); q += THREADS) {
      const int k = q / (BN / 8), n = (q % (BN / 8)) * 8;
      const bool ok = n0 + n < a.cout;
      const size_t off = ok ? wrow + (size_t)k * a.cout + n : 0;
#pragma unroll
      for (int t = 0; t < L; ++t)
        cp_async16(sB + t * LR::B_ELEMS + k * LR::B_LD + n,
                   a.WL + t * a.wplane + off, ok);
    }
  } else {
    const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);
    const int K = a.kh * a.kw * a.cin;
    const int kk0 = st * KB;
    for (int q = tid; q < BM * KB; q += THREADS) {
      const int i = q / KB, e = q % KB, kk = kk0 + e;
      const long long off =
          kk < K ? gather_offset(a, kk, s_base[i], s_iy[i], s_ix[i]) : -1;
#pragma unroll
      for (int t = 0; t < L; ++t)
        sA[t * LR::A_ELEMS + i * LR::A_LD + e] =
            off >= 0 ? a.XL[t * a.xplane + off] : zero;
    }
    for (int q = tid; q < KB * BN; q += THREADS) {
      const int k = q / BN, n = q % BN, kk = kk0 + k;
      const bool ok = kk < K && n0 + n < a.cout;
#pragma unroll
      for (int t = 0; t < L; ++t)
        sB[t * LR::B_ELEMS + k * LR::B_LD + n] =
            ok ? a.WL[t * a.wplane + (size_t)kk * a.cout + n0 + n] : zero;
    }
  }
}

template <int S, int BM, int BN, bool FAST>
__global__ void __launch_bounds__(BM * BN / 64)
    conv_mma_kernel(const ConvArgs a) {
  constexpr int THREADS = BM * BN / 64;
  constexpr int WN = BN / 32;
  constexpr int L = Sched<S>::limbs;
  using LR = LimbRing<S, BM, BN>;
  extern __shared__ float4 smem4[];
  int* s_base = reinterpret_cast<int*>(smem4);
  int* s_iy = s_base + BM;
  int* s_ix = s_iy + BM;
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(s_ix + BM);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / WN, wn = warp % WN;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  pixel_table<BM, THREADS>(a, m0, s_base, s_iy, s_ix);
  __syncthreads();

  float acc[4][4][4], part[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = part[i][j][e] = 0.0f;

  const int nst = num_tiles<FAST>(a), st0 = blockIdx.z * nst;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nst)
      load_limbs<S, BM, BN, THREADS, FAST>(a, st0 + s, n0, s_base, s_iy, s_ix,
                                           ring + s * LR::STAGE_ELEMS);
    cp_async_commit();
  }
  // ldmatrix row addresses within a stage: A rows of the warp's m16 tiles
  // (lanes 0-15 at k 0, 16-31 at k 8); B rows k of the warp's n16 pairs
  // (lanes 0-7 / 8-15 k 0-7 / 8-15 at n, lanes 16-31 the same at n + 8).
  const unsigned ring_u32 = smem_u32(ring);
  const unsigned a_lane =
      2 * ((wm * 64 + (lane % 16)) * LR::A_LD + (lane / 16) * 8);
  const unsigned b_lane =
      2 * (L * LR::A_ELEMS + (lane % 16) * LR::B_LD + wn * 32 +
           (lane / 16) * 8);

  for (int st = 0; st < nst; ++st) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile st landed; every thread is done with st - 1
    {
      const int ns = st + STAGES - 1;
      if (ns < nst)
        load_limbs<S, BM, BN, THREADS, FAST>(
            a, st0 + ns, n0, s_base, s_iy, s_ix,
            ring + (ns % STAGES) * LR::STAGE_ELEMS);
      cp_async_commit();
    }
    const unsigned stage = ring_u32 + 2 * (st % STAGES) * LR::STAGE_ELEMS;
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      uint32_t bf[L][4][2];  // [limb][n8 tile][b0, b1]
#pragma unroll
      for (int t = 0; t < L; ++t)
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t r[4];
          ldsm_x4_trans(stage + b_lane +
                            2 * (t * LR::B_ELEMS + ks * 16 * LR::B_LD +
                                 np * 16),
                        r);
          bf[t][2 * np][0] = r[0];
          bf[t][2 * np][1] = r[1];
          bf[t][2 * np + 1][0] = r[2];
          bf[t][2 * np + 1][1] = r[3];
        }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        uint32_t af[L][4];
#pragma unroll
        for (int t = 0; t < L; ++t)
          ldsm_x4(stage + a_lane +
                      2 * (t * LR::A_ELEMS + mt * 16 * LR::A_LD + ks * 16),
                  af[t]);
        // Four fragments from zero, the pairs interleaved across them.
        float frag[4][4];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) frag[nt][e] = 0.0f;
#pragma unroll
        for (int p = 0; p < Sched<S>::pairs; ++p)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            mma_bf16(frag[nt], af[ftile::pair_a<S>(p)],
                     bf[ftile::pair_b<S>(p)][nt][0],
                     bf[ftile::pair_b<S>(p)][nt][1]);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            part[mt][nt][e] = __fadd_rn(part[mt][nt][e], frag[nt][e]);
      }
    }
    if (closes_chunk<FAST>(a, st0 + st, TC_CHUNK)) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[i][j][e] = __fadd_rn(acc[i][j][e], part[i][j][e]);
            part[i][j][e] = 0.0f;
          }
    }
  }
  cp_async_wait<0>();

  // Fragment element e of tile (mt, nt): row lane/4 + 8*(e/2), column
  // 2*(lane%4) + e%2.
  const Sink sink(a);
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * 64 + mt * 16 + lane / 4 + 8 * h;
      if (m >= a.M) continue;
      float* orow = sink.base + (size_t)m * a.cout;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = n0 + wn * 32 + nt * 8 + 2 * (lane % 4) + e;
          if (c < a.cout) orow[c] = sink(acc[mt][nt][2 * h + e], c);
        }
    }
}

// ---------------------------------------------------------------------------
// Launch: the route by schedule, the path by shape, the tile and the tap
// groups by grid.
// ---------------------------------------------------------------------------
int num_sms() {
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

// What a call needs: its path, tile, tap groups and scratch layout (the
// limb planes, then the group sums, each 256-byte aligned).
struct Plan {
  bool fast;
  int bm, bn, groups;
  long long xplane, wplane, limb_bytes, part_bytes;
};

long long round_up(long long v, long long m) { return (v + m - 1) / m * m; }

Plan plan_of(int n, int H, int W, int cin, int cout, int kh, int kw,
             int ho, int wo, int passes, bool aligned) {
  Plan p{};
  p.fast = aligned && cin % BK == 0 && cout % (passes == 1 ? 4 : 8) == 0;
  p.bm = cout <= 64 ? 256 : 128;
  p.bn = cout <= 64 ? 64 : 128;
  const long long M = (long long)n * ho * wo;
  const long long blocks = ((cout + p.bn - 1) / p.bn) * ((M + p.bm - 1) / p.bm);
  const int taps = kh * kw;
  p.groups = 1;
  if (p.fast && blocks < 2LL * num_sms()) {  // the smallest divisor that
    p.groups = taps;                         // gives three blocks per SM
    for (int d = 2; d < taps; ++d)
      if (taps % d == 0 && blocks * d >= 3LL * num_sms()) {
        p.groups = d;
        break;
      }
  }
  if (passes > 1) {
    const int L = passes == 3 ? 2 : 3;
    p.xplane = round_up((long long)n * H * W * cin, 8);
    p.wplane = round_up((long long)taps * cin * cout, 8);
    p.limb_bytes = round_up(2LL * L * (p.xplane + p.wplane), 256);
  }
  if (p.groups > 1) p.part_bytes = 4LL * p.groups * M * cout;
  return p;
}

template <typename Kernel>
cudaError_t launch_kernel(Kernel k, size_t smem, int threads,
                          const ConvArgs& a, int bm, int bn,
                          cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.cout + bn - 1) / bn, (a.M + bm - 1) / bm, a.groups);
  k<<<grid, threads, smem, st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess || a.groups == 1) return e;
  const long long n4 = (long long)a.M * a.cout / 4;
  combine_groups_kernel<<<8 * num_sms(), 256, 0, st>>>(
      reinterpret_cast<const float4*>(a.part), a.bias,
      reinterpret_cast<float4*>(a.out), n4, a.cout, a.groups);
  return cudaGetLastError();
}

template <int BM, int BN, bool FAST>
cudaError_t launch_simt(const ConvArgs& a, cudaStream_t st) {
  static_assert(Ring<BM, BN>::bytes() <= 227 * 1024,
                "dynamic shared memory past a Hopper block's 227 KB");
  return launch_kernel(conv_simt_kernel<BM, BN, FAST>, Ring<BM, BN>::bytes(),
                       BM * BN / 64, a, BM, BN, st);
}

template <int S, int BM, int BN, bool FAST>
cudaError_t launch_mma(const ConvArgs& a, cudaStream_t st) {
  static_assert(LimbRing<S, BM, BN>::bytes() <= 227 * 1024,
                "dynamic shared memory past a Hopper block's 227 KB");
  return launch_kernel(conv_mma_kernel<S, BM, BN, FAST>,
                       LimbRing<S, BM, BN>::bytes(), BM * BN / 64, a, BM, BN,
                       st);
}

template <int S>
cudaError_t launch_route(const ConvArgs& a, const Plan& p, cudaStream_t st) {
  if constexpr (S == ftile::F32) {
    if (p.bn == 64)
      return p.fast ? launch_simt<256, 64, true>(a, st)
                    : launch_simt<256, 64, false>(a, st);
    return p.fast ? launch_simt<128, 128, true>(a, st)
                  : launch_simt<128, 128, false>(a, st);
  } else {
    const long long nx = (long long)(a.M / (a.ho * a.wo)) * a.H * a.W * a.cin;
    const long long nw = (long long)a.kh * a.kw * a.cin * a.cout;
    split_limbs_kernel<S><<<8 * num_sms(), 256, 0, st>>>(
        a.X, const_cast<__nv_bfloat16*>(a.XL), nx, a.xplane);
    split_limbs_kernel<S><<<8 * num_sms(), 256, 0, st>>>(
        a.Wt, const_cast<__nv_bfloat16*>(a.WL), nw, a.wplane);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    if (p.bn == 64)
      return p.fast ? launch_mma<S, 256, 64, true>(a, st)
                    : launch_mma<S, 256, 64, false>(a, st);
    return p.fast ? launch_mma<S, 128, 128, true>(a, st)
                  : launch_mma<S, 128, 128, false>(a, st);
  }
}

// One m16n8k16 bf16 MMA per 32-lane warp: D[t] = A[t] (16 x 16, row-major)
// x B[t] (16 x 8, K x N row-major) + C[t] (16 x 8), f32.
__global__ void mma_probe_kernel(const __nv_bfloat16* __restrict__ A,
                                 const __nv_bfloat16* __restrict__ B,
                                 const float* __restrict__ C,
                                 float* __restrict__ D, int count) {
  const int t = blockIdx.x, lane = threadIdx.x;
  if (t >= count) return;
  const __nv_bfloat16* a = A + (size_t)t * 256;
  const __nv_bfloat16* b = B + (size_t)t * 128;
  const int g = lane / 4, c2 = (lane % 4) * 2;
  auto pack = [](__nv_bfloat16 lo, __nv_bfloat16 hi) {
    return (uint32_t)__bfloat16_as_ushort(lo) |
           ((uint32_t)__bfloat16_as_ushort(hi) << 16);
  };
  const uint32_t af[4] = {pack(a[g * 16 + c2], a[g * 16 + c2 + 1]),
                          pack(a[(g + 8) * 16 + c2], a[(g + 8) * 16 + c2 + 1]),
                          pack(a[g * 16 + c2 + 8], a[g * 16 + c2 + 9]),
                          pack(a[(g + 8) * 16 + c2 + 8],
                               a[(g + 8) * 16 + c2 + 9])};
  const uint32_t b0 = pack(b[c2 * 8 + g], b[(c2 + 1) * 8 + g]);
  const uint32_t b1 = pack(b[(c2 + 8) * 8 + g], b[(c2 + 9) * 8 + g]);
  const float* c = C + (size_t)t * 128;
  float d[4] = {c[g * 8 + c2], c[g * 8 + c2 + 1], c[(g + 8) * 8 + c2],
                c[(g + 8) * 8 + c2 + 1]};
  mma_bf16(d, af, b0, b1);
  float* o = D + (size_t)t * 128;
  o[g * 8 + c2] = d[0];
  o[g * 8 + c2 + 1] = d[1];
  o[(g + 8) * 8 + c2] = d[2];
  o[(g + 8) * 8 + c2 + 1] = d[3];
}

}  // namespace

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Scratch bytes a call needs (0: none): the bf16 limb planes of the
// bf16 schedules and the tap groups' f32 sums.
extern "C" long long implicit_conv_float_scratch(int n, int H, int W,
                                                 int cin, int cout, int kh,
                                                 int kw, int ho, int wo,
                                                 int passes) {
  const Plan p = plan_of(n, H, W, cin, cout, kh, kw, ho, wo, passes, true);
  return p.limb_bytes + p.part_bytes;
}

// X (n, H, W, cin) f32 unpadded (pads = top, left; bottom/right follow from
// ho, wo); Wt (kh, kw, cin, cout) f32; bias (cout) or NULL; out (n, ho, wo,
// cout) f32; scratch of implicit_conv_float_scratch() bytes, 256-byte
// aligned (NULL when that is 0).  passes: 1 (native f32), 3 (bf16x3) or 6
// (bf16x6).
extern "C" int implicit_conv_float_launch(
    const void* X, const void* Wt, const void* bias, void* out,
    void* scratch, long long scratch_bytes, int n, int H, int W, int cin,
    int cout, int kh, int kw, int stride, int pad_t, int pad_l, int ho,
    int wo, int passes, void* stream) {
  if (passes != 1 && passes != 3 && passes != 6)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool aligned = reinterpret_cast<uintptr_t>(X) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(Wt) % 16 == 0;
  const Plan p = plan_of(n, H, W, cin, cout, kh, kw, ho, wo, passes, aligned);
  if (p.limb_bytes + p.part_bytes > scratch_bytes ||
      reinterpret_cast<uintptr_t>(scratch) % 256)
    return static_cast<int>(cudaErrorInvalidValue);
  char* base = static_cast<char*>(scratch);
  const int L = passes == 3 ? 2 : 3;
  __nv_bfloat16* xl = p.limb_bytes ? reinterpret_cast<__nv_bfloat16*>(base)
                                   : nullptr;
  const ConvArgs a{static_cast<const float*>(X),
                   static_cast<const float*>(Wt),
                   xl,
                   xl ? xl + L * p.xplane : nullptr,
                   p.xplane,
                   p.wplane,
                   static_cast<const float*>(bias),
                   static_cast<float*>(out),
                   p.part_bytes ? reinterpret_cast<float*>(base + p.limb_bytes)
                                : nullptr,
                   H, W, cin, cout, kh, kw, stride, pad_t, pad_l, ho, wo,
                   n * ho * wo,
                   p.groups};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (passes) {
    case 1: err = launch_route<ftile::F32>(a, p, st); break;
    case 3: err = launch_route<ftile::BF16X3>(a, p, st); break;
    default: err = launch_route<ftile::BF16X6_TAP>(a, p, st); break;
  }
  return static_cast<int>(err);
}

// The tensor-core probe: `count` independent single MMAs (one warp each).
// A (count, 16, 16) bf16, B (count, 16, 8) bf16, C and D (count, 16, 8) f32.
extern "C" int mma_probe_launch(const void* A, const void* B, const void* C,
                                void* D, int count, void* stream) {
  mma_probe_kernel<<<count, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(A),
      static_cast<const __nv_bfloat16*>(B), static_cast<const float*>(C),
      static_cast<float*>(D), count);
  return static_cast<int>(cudaGetLastError());
}
