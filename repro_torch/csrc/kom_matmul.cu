// The limb GEMM on Hopper: (m, k) x (k, n) int16 operands in balanced int8
// digits, 3 (Karatsuba) or 4 (schoolbook) int8 passes on the tensor cores
// (mma.sync m16n8k32 s8 -> s32) into three int32 accumulators, one f32
// recombine, fused dequant epilogue.
//
// Replaces: src/repro/kernels/kom_matmul/kom_matmul.py:_int_kernel
// (kom_matmul_int_raw), the TPU kernel whose sequential K grid carried the
// three int32 accumulators in VMEM scratch.  Blocks run in no order on the
// card, so a K split across blocks writes its accumulators to scratch and a
// second kernel adds them (integer sums: exact in any order and any split).
//
// What bounds it on this card: the serving path runs it at m <= 16 rows
// (LM decode at m = slots, the CNN FC layers at m = batch), where it is
// bound by reading the int16 weight once (8 MB for a granite-3-2b q
// projection, 202 MB for its tied head), and on the RGB stems' im2col GEMMs
// (m = 3025 * batch, k = 363, n = 96 for AlexNet), bound by their bytes too
// (k is small).  What the design does about it:
//   * the weight is the MMA's A operand: its n fills the 16-row side, the
//     activation rows the 8-column side, so at most 7 (m <= 8) or 15
//     (m <= 16) columns of a tile are padding;
//   * each warp streams 32 x 64 int16 weight tiles (4 KB) and its
//     activation rows through its own 4-stage cp.async ring (16-byte
//     copies), with no block barrier in the main loop; every lane reads
//     exactly the 64 weight entries of its fragments (an XOR swizzle keeps
//     those 16-byte reads conflict-free), splits them into digits two int16
//     lanes at a time and transposes the bytes into K-quads with byte
//     permutes (limb_mma.cuh), so each weight element is read from device
//     memory once per call and split once;
//   * small grids split K across blocks (the wrapper's plan,
//     kom_matmul.ops.kom_split_k: at least two blocks per SM), the four
//     warps of a block take the block's 32-entry K chunks in turn, and add
//     their accumulators in shared memory;
//   * m > 16 (the stems): the four warps take 16 rows each of a 64-row
//     block (the weight tile, small there, is read by each from L2); the
//     wrapper pads an odd K (the stems' 363 and 27) to a multiple of 8 so
//     the activation rows land by 16-byte copies too.
#include "limb_mma.cuh"

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int TN = 64;                // columns (weight n) per block and warp
constexpr int KC = 32;                // K entries per chunk: one MMA depth
constexpr int W_BYTES = KC * TN * 2;  // one raw weight tile

// CT: 8-row MMA column tiles per warp (rows of the activation); MSPLIT: the
// warps take different rows (else they share the rows and split K).
template <int CT, bool MSPLIT>
struct Geo {
  static constexpr int MT = 8 * CT;              // rows per warp
  static constexpr int BM = MSPLIT ? WARPS * MT : MT;  // rows per block
  static constexpr int STAGES = MSPLIT ? 3 : 4;
  static constexpr int A_BYTES = MT * KC * 2;    // raw activation tile
  static constexpr int STAGE = W_BYTES + A_BYTES;
  static constexpr int RING = WARPS * STAGES * STAGE;
  static constexpr int RED = WARPS * 3 * MT * TN * 4;  // accumulators
  static constexpr int SMEM = RING > RED ? RING : RED;
};

struct Args {
  const int16_t* A;  // (M, lda) row-major, lda % 8 == 0, 16-byte aligned
  const int16_t* B;  // (K, ldb) row-major, ldb % 8 == 0, 16-byte aligned
  float* C;          // (M, N)
  int* part;         // (splits, 3, M, N) int32, or NULL for one split
  const float* rs;
  const float* cs;
  const float* bias;
  int M, N, K, lda, ldb, group_k, base_bits;
};

// Row r's 16-byte chunk u of a raw weight tile (64 int16 = 128 bytes a
// row): chunk u ^ (2 * ((r >> 2) & 3)), so the eight lanes of a quarter
// warp, which read rows 4t + j for t = 0..3 at chunks g, g', hit eight
// different 16-byte bank groups.
__device__ __forceinline__ int w_off(int r, int u) {
  return r * (TN * 2) + ((u ^ (((r >> 2) & 3) << 1)) << 4);
}

__device__ __forceinline__ float finish_one(int hh, int x, int ll,
                                            bool karatsuba, const Args& a,
                                            int m, int n) {
  const int mid = karatsuba ? limb::mid_of<true>(hh, x, ll)
                            : limb::mid_of<false>(hh, x, ll);
  float v = limb::recombine(hh, mid, ll, a.base_bits);
  if (a.rs != nullptr) v = limb::dequant(v, a.rs[m], a.cs[n], a.bias, n);
  return v;
}

// Issues the copies of one warp's chunk (K from kc) into a ring stage.
template <int CT>
__device__ __forceinline__ void load_chunk(const Args& a, char* stage, int kc,
                                           int k_end, int n0, int m0,
                                           int lane) {
  constexpr int MT = 8 * CT;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int q = lane + 32 * i, r = q >> 3, u = q & 7;
    const int gk = kc + r, gn = n0 + 8 * u;
    const bool ok = gk < k_end && gn < a.ldb;
    lmma::cp_async16(stage + w_off(r, u),
                     ok ? a.B + (size_t)gk * a.ldb + gn : a.B, ok);
  }
  // A: rows m0.., K entries kc..kc+31 (entries past K, up to lda, are the
  // wrapper's zero padding; chunks past the split's end are zero-filled).
  int16_t* sa = reinterpret_cast<int16_t*>(stage + W_BYTES);
#pragma unroll
  for (int i = 0; i < CT; ++i) {
    const int q = lane + 32 * i, r = q >> 2, u = q & 3;
    const int gm = m0 + r, gk = kc + 8 * u;
    const bool ok = gm < a.M && gk < k_end;
    lmma::cp_async16(sa + r * KC + 8 * u,
                     ok ? a.A + (size_t)gm * a.lda + gk : a.A, ok);
  }
}

template <int CT, bool MSPLIT, bool KARATSUBA>
__global__ void __launch_bounds__(THREADS)
    kom_matmul_kernel(const Args a) {
  using G = Geo<CT, MSPLIT>;
  constexpr int MT = G::MT, STAGES = G::STAGES;
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int n0 = blockIdx.x * TN;
  const int m0 = blockIdx.y * G::BM + (MSPLIT ? warp * MT : 0);
  const int k_begin = blockIdx.z * a.group_k;
  const int k_end = min(a.K, k_begin + a.group_k);
  const int nch = k_end > k_begin ? (k_end - k_begin + KC - 1) / KC : 0;
  // This warp's chunks: all of them (MSPLIT), else warp, warp + 4, ...
  const int first = MSPLIT ? 0 : warp, step = MSPLIT ? 1 : WARPS;
  const int nj = first < nch ? (nch - first + step - 1) / step : 0;
  char* ring = smem + warp * STAGES * G::STAGE;
  const lmma::Digits dg(a.base_bits);

  int hh[4][CT][4], xx[4][CT][4], ll[4][CT][4];
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int u = 0; u < CT; ++u)
#pragma unroll
      for (int c = 0; c < 4; ++c) hh[t][u][c] = xx[t][u][c] = ll[t][u][c] = 0;

  auto kc_of = [&](int j) { return k_begin + (first + j * step) * KC; };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nj)
      load_chunk<CT>(a, ring + s * G::STAGE, kc_of(s), k_end, n0, m0, lane);
    lmma::cp_async_commit();
  }
  // The lane's weight rows 4*t4 + j and 16 + 4*t4 + j, chunk g (swizzled:
  // both groups share the key 2*t4).
  const int w_lane = ((g ^ (t4 << 1)) << 4);
  for (int j = 0; j < nj; ++j) {
    lmma::cp_async_wait<STAGES - 2>();
    __syncwarp();  // chunk j landed for every lane; chunk j-1 is consumed
    {
      const int jn = j + STAGES - 1;
      if (jn < nj)
        load_chunk<CT>(a, ring + (jn % STAGES) * G::STAGE, kc_of(jn), k_end,
                       n0, m0, lane);
      lmma::cp_async_commit();
    }
    const char* st = ring + (j % STAGES) * G::STAGE;
    const int16_t* sa = reinterpret_cast<const int16_t*>(st + W_BYTES);

    // Activation fragments: rows 8u + g, K quads t4 and t4 + 4.
    lmma::FragB fb[CT];
#pragma unroll
    for (int u = 0; u < CT; ++u) {
      const int16_t* row = sa + (8 * u + g) * KC;
      const uint2 q0 = *reinterpret_cast<const uint2*>(row + 4 * t4);
      const uint2 q1 = *reinterpret_cast<const uint2*>(row + 16 + 4 * t4);
      const lmma::Quad p0 = lmma::row_quad<KARATSUBA>(q0.x, q0.y, dg);
      const lmma::Quad p1 = lmma::row_quad<KARATSUBA>(q1.x, q1.y, dg);
      fb[u] = {{p0.h, p1.h}, {p0.l, p1.l}, {p0.s, p1.s}};
    }
    // Weight rows: group 0 = K 4*t4 + j, group 1 = K 16 + 4*t4 + j, each
    // 8 columns 8g..8g+7 (four int16 pairs).
    uint4 r0[4], r1[4];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      r0[jj] = *reinterpret_cast<const uint4*>(st + (4 * t4 + jj) * TN * 2 +
                                               w_lane);
      r1[jj] = *reinterpret_cast<const uint4*>(
          st + (16 + 4 * t4 + jj) * TN * 2 + w_lane);
    }
    // MMA tile t: row g <-> column 8g + 2t, row g + 8 <-> column 8g + 2t + 1
    // (the lane's pair t); K quads t4 (group 0) and t4 + 4 (group 1).
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      auto pick = [t](const uint4& v) {
        return t == 0 ? v.x : t == 1 ? v.y : t == 2 ? v.z : v.w;
      };
      const uint32_t w0[4] = {pick(r0[0]), pick(r0[1]), pick(r0[2]),
                              pick(r0[3])};
      const uint32_t w1[4] = {pick(r1[0]), pick(r1[1]), pick(r1[2]),
                              pick(r1[3])};
      lmma::Quad e0, o0, e1, o1;  // even / odd column, K group 0 / 1
      lmma::col_quads<KARATSUBA>(w0, dg, e0, o0);
      lmma::col_quads<KARATSUBA>(w1, dg, e1, o1);
      const lmma::FragA fa = {{e0.h, o0.h, e1.h, o1.h},
                              {e0.l, o0.l, e1.l, o1.l},
                              {e0.s, o0.s, e1.s, o1.s}};
#pragma unroll
      for (int u = 0; u < CT; ++u)
        lmma::passes<KARATSUBA>(fa, fb[u], hh[t][u], xx[t][u], ll[t][u]);
    }
  }
  lmma::cp_async_wait<0>();
  __syncthreads();  // every warp is done with its ring: reuse it

  // Accumulators to shared memory, [warp][acc][row][col].
  int* red = reinterpret_cast<int*>(smem);
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int u = 0; u < CT; ++u)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = 8 * g + 2 * t + (c >> 1);
        const int row = 8 * u + 2 * t4 + (c & 1);
        int* p = red + ((warp * 3) * MT + row) * TN + col;
        p[0] = hh[t][u][c];
        p[MT * TN] = xx[t][u][c];
        p[2 * MT * TN] = ll[t][u][c];
      }
  __syncthreads();

  const int mb = blockIdx.y * G::BM;
  const size_t mn = (size_t)a.M * a.N;
  for (int idx = threadIdx.x; idx < G::BM * TN; idx += THREADS) {
    const int rl = idx / TN, cl = idx % TN;
    const int gm = mb + rl, gn = n0 + cl;
    if (gm >= a.M || gn >= a.N) continue;
    int v[3];
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      if (MSPLIT) {
        v[q] = red[(((rl / MT) * 3 + q) * MT + rl % MT) * TN + cl];
      } else {
        int s = 0;
#pragma unroll
        for (int w = 0; w < WARPS; ++w)
          s = lmma::wrap_add(s, red[((w * 3 + q) * MT + rl) * TN + cl]);
        v[q] = s;
      }
    }
    const size_t o = (size_t)gm * a.N + gn;
    if (a.part != nullptr) {
      int* p = a.part + blockIdx.z * 3 * mn + o;
      p[0] = v[0];
      p[mn] = v[1];
      p[2 * mn] = v[2];
    } else {
      a.C[o] = finish_one(v[0], v[1], v[2], KARATSUBA, a, gm, gn);
    }
  }
}

// C = epilogue(sum over the splits' accumulators).  A block owns 32
// outputs; its eight warps take every eighth split each (independent loads
// in flight), then add the eight partial sums in shared memory.
constexpr int COMBINE_OUT = 32, COMBINE_GROUPS = 8;
template <bool KARATSUBA>
__global__ void __launch_bounds__(COMBINE_OUT * COMBINE_GROUPS)
    combine_splits_kernel(const Args a, int splits) {
  __shared__ int red[3][COMBINE_GROUPS][COMBINE_OUT];
  const int lane = threadIdx.x % COMBINE_OUT, grp = threadIdx.x / COMBINE_OUT;
  const size_t mn = (size_t)a.M * a.N;
  const size_t i = (size_t)blockIdx.x * COMBINE_OUT + lane;
  int v[3] = {0, 0, 0};
  if (i < mn)
#pragma unroll 4
    for (int z = grp; z < splits; z += COMBINE_GROUPS)
#pragma unroll
      for (int q = 0; q < 3; ++q)
        v[q] = lmma::wrap_add(v[q], a.part[(z * 3 + q) * mn + i]);
#pragma unroll
  for (int q = 0; q < 3; ++q) red[q][grp][lane] = v[q];
  __syncthreads();
  if (grp != 0 || i >= mn) return;
#pragma unroll
  for (int q = 0; q < 3; ++q)
#pragma unroll
    for (int w = 1; w < COMBINE_GROUPS; ++w)
      v[q] = lmma::wrap_add(v[q], red[q][w][lane]);
  const int m = (int)(i / a.N), n = (int)(i % a.N);
  a.C[i] = finish_one(v[0], v[1], v[2], KARATSUBA, a, m, n);
}

template <int CT, bool MSPLIT, bool KARATSUBA>
cudaError_t launch(const Args& a, int splits, cudaStream_t st) {
  using G = Geo<CT, MSPLIT>;
  auto* kern = kom_matmul_kernel<CT, MSPLIT, KARATSUBA>;
  static bool sized = false;  // one attribute call per instantiation
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
    if (e != cudaSuccess) return e;
    sized = true;
  }
  const dim3 grid((a.N + TN - 1) / TN, (a.M + G::BM - 1) / G::BM, splits);
  kern<<<grid, THREADS, G::SMEM, st>>>(a);
  if (splits > 1) {
    const size_t mn = (size_t)a.M * a.N;
    combine_splits_kernel<KARATSUBA>
        <<<(unsigned)((mn + COMBINE_OUT - 1) / COMBINE_OUT),
           COMBINE_OUT * COMBINE_GROUPS, 0, st>>>(a, splits);
  }
  return cudaGetLastError();
}

template <int CT, bool MSPLIT>
cudaError_t launch_variant(const Args& a, int splits, bool karatsuba,
                           cudaStream_t st) {
  return karatsuba ? launch<CT, MSPLIT, true>(a, splits, st)
                   : launch<CT, MSPLIT, false>(a, splits, st);
}

}  // namespace

LIMB_EXPORT_ERROR_STRING

// Returns cudaGetLastError() after the launches (0 on success).  row_scale,
// col_scale and bias may be NULL: no scales -> the raw recombined product.
// A has row stride lda and B ldb (multiples of 8, >= K and >= N, 16-byte
// aligned bases; A's entries K..lda-1 must be zero, B's columns N..ldb-1
// are ignored).  group_k (a multiple of 32): the K entries of one
// split; part: int32 scratch of (ceil(K / group_k), 3, M, N) when that is
// more than one split, else NULL.  m_tile: 8 or 16 (M <= m_tile: the warps
// split K) or 64 (M > 16: the warps take 16 rows each), from the wrapper's
// plan (kom_matmul.ops.kom_split_k).
extern "C" int kom_matmul_launch(const void* A, const void* B, void* C,
                                 void* part, const void* row_scale,
                                 const void* col_scale, const void* bias,
                                 int M, int N, int K, int lda, int ldb,
                                 int group_k,
                                 int m_tile, int base_bits, int karatsuba,
                                 void* stream) {
  const int splits = K > 0 ? (K + group_k - 1) / group_k : 1;
  if (group_k <= 0 || group_k % KC != 0 || ldb % 8 != 0 || ldb < N ||
      lda % 8 != 0 || lda < K || reinterpret_cast<uintptr_t>(A) % 16 != 0 ||
      (splits > 1) != (part != nullptr) || base_bits < 2 || base_bits > 8 ||
      (m_tile == 64) != (M > 16) || (m_tile == 8 && M > 8) ||
      (m_tile == 16 && M > 16) ||
      reinterpret_cast<uintptr_t>(B) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.A = static_cast<const int16_t*>(A);
  a.B = static_cast<const int16_t*>(B);
  a.C = static_cast<float*>(C);
  a.part = static_cast<int*>(part);
  a.rs = static_cast<const float*>(row_scale);
  a.cs = static_cast<const float*>(col_scale);
  a.bias = static_cast<const float*>(bias);
  a.M = M;
  a.N = N;
  a.K = K;
  a.lda = lda;
  a.ldb = ldb;
  a.group_k = group_k;
  a.base_bits = base_bits;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool kara = karatsuba != 0;
  cudaError_t e;
  if (m_tile == 8)
    e = launch_variant<1, false>(a, splits, kara, st);
  else if (m_tile == 16)
    e = launch_variant<2, false>(a, splits, kara, st);
  else
    e = launch_variant<2, true>(a, splits, kara, st);
  return static_cast<int>(e);
}
