// The bf16-limb GEMM on Hopper: an fp32-accurate (m, k) x (k, n) product
// from bf16 limb passes into f32 sums, split over K.
//
// Replaces: src/repro/kernels/kom_matmul/kom_matmul.py:_bf16_kernel
// (bf16x3_matmul_raw), whose sequential K grid carried the f32 sum of
// dot(ah, bh) + dot(ah, bl) + dot(al, bh) [+ dot(al, bl)] in VMEM scratch.
// Passes 3 and 4 are the TPU kernel's; passes 6 (three limbs, pairs i-major
// (0,0) (0,1) (0,2) (1,0) (1,1) (2,0)) is the function of
// karatsuba.bf16xn_dot_general(passes=6), so bf16x6 FC layers run here too.
// A and B arrive as f32 and are split into bf16 limbs inside the kernel
// (__float2bfloat16_rn, residual in f32: float_tile.cuh); every pass term is
// an exact bf16 x bf16 product added by __fmaf_rn.
//
// What bounds it on this card: the serving path runs the FC layers at
// m <= 16 rows (a batch), where a K entry costs 4 bytes of weight and only
// m * passes multiply-adds per column: ~12 operations per byte at m = 8
// under bf16x3, far below the ~295 at which the tensor cores, or the ~20 at
// which the CUDA cores, would be the limit.  So the bound is one read of the
// f32 weight (411 MB for VGG16's fc6: 0.123 ms at 3.35 TB/s), and the design
// is about keeping enough of it in flight:
//   * split-K: a block owns one group of K (the wrapper's group_k: 1024
//     entries, the nested-sum group, halved down to 256 while the grid has
//     fewer than two blocks per SM), 128 columns and an m tile of up to 16
//     rows (grid z for more): fc6 gets 32 x 25 = 800 blocks for the 132
//     SMs, fc7 32 x 16.  Each block writes its group sum to an f32 scratch
//     (groups, m, n); a second kernel adds the groups in order.  No float
//     atomics: the result is the same from run to run;
//   * B streams through a 4-stage cp.async ring of 32 x 128 f32 tiles (16 KB
//     each, 16-byte copies, neighbouring threads on neighbouring columns), so
//     each block keeps three tiles (48 KB) of weight in flight;
//   * A's group slice (at most 16 rows x 1024) is split once per block into
//     bf16 limbs in shared memory; its reads are broadcasts;
//   * the math stays on the CUDA cores, register-blocked over all m-tile
//     rows: a thread owns 4 columns (one float4 of B) and an eighth of
//     each tile's K entries (8 K lanes per block, summed in a fixed order at
//     the end).
// The f32 sums nest (4 K entries, then 32 tiles, then 8 K lanes, then the
// groups), which keeps the kernel ~3e-7 of the largest output from the
// schedule's exact value at K = 25088; a flat chain drifts ~5e-6, as far as
// bf16x3 lies from bf16x6.
#include "float_tile.cuh"

namespace {

constexpr int BN = 128;             // columns per block
constexpr int TN = 4;               // columns per thread (one float4 of B)
constexpr int CQ = BN / TN;         // 32 column quads: one warp's lanes
constexpr int KL = 8;               // K lanes: the block's warps
constexpr int THREADS = CQ * KL;    // 256
constexpr int BK = 32;              // K entries per ring tile
constexpr int KPL = BK / KL;        // K entries per lane per tile
constexpr int STAGES = 4;
constexpr int TILE_FLOATS = BK * BN;
constexpr int CHUNKS = TILE_FLOATS / 4 / THREADS;  // 16-byte copies a thread

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The MT bf16 values of one (K entry, limb) of A as f32.
template <int MT>
__device__ __forceinline__ void load_a(const __nv_bfloat16* p,
                                       float (&a)[MT]) {
  uint32_t w[MT / 2];
  if constexpr (MT == 2) {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  } else if constexpr (MT == 4) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = v.x;
    w[1] = v.y;
  } else {
#pragma unroll
    for (int q = 0; q < MT / 8; ++q) {
      const uint4 v = reinterpret_cast<const uint4*>(p)[q];
      w[4 * q] = v.x;
      w[4 * q + 1] = v.y;
      w[4 * q + 2] = v.z;
      w[4 * q + 3] = v.w;
    }
  }
#pragma unroll
  for (int i = 0; i < MT / 2; ++i) {
    a[2 * i] = __uint_as_float(w[i] << 16);
    a[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// One block: columns n0..n0+127, the K group blockIdx.y, rows m0..m0+MT-1.
// Dynamic shared memory: the B ring (STAGES tiles of f32), then A's limbs
// as bf16, [K entry][limb][row].  dst is C itself (one group) or the
// scratch slice of this group.
template <int S, int MT>
__global__ void __launch_bounds__(THREADS)
    bf16_matmul_group_kernel(const float* __restrict__ A,
                             const float* __restrict__ B,
                             float* __restrict__ dst, int M, int N, int K,
                             int group_k) {
  constexpr int L = ftile::Sched<S>::limbs;
  extern __shared__ float4 smem4[];
  float* sB = reinterpret_cast<float*>(smem4);
  __nv_bfloat16* sA =
      reinterpret_cast<__nv_bfloat16*>(sB + STAGES * TILE_FLOATS);

  const int tid = threadIdx.x;
  const int cq = tid % CQ, kl = tid / CQ;
  const int n0 = blockIdx.x * BN;
  const int k_begin = blockIdx.y * group_k;
  const int k_len = min(group_k, K - k_begin);
  const int m0 = blockIdx.z * MT;
  const int n_tiles = (k_len + BK - 1) / BK;

  auto load_tile = [&](int t) {
    if (t < n_tiles) {
      float* buf = sB + (t % STAGES) * TILE_FLOATS;
#pragma unroll
      for (int c = 0; c < CHUNKS; ++c) {
        const int idx = tid + c * THREADS;
        const int row = idx / CQ, quad = idx % CQ;
        const int gk = k_begin + t * BK + row, gn = n0 + 4 * quad;
        const bool ok = t * BK + row < k_len && gn < N;
        cp_async16(buf + row * BN + 4 * quad,
                   ok ? B + (size_t)gk * N + gn : B, ok);
      }
    }
    cp_async_commit();  // an empty group past the end keeps the count even
  };

#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) load_tile(t);

  // A's slice, split once into limbs (overlaps the ring's first tiles).
  for (int idx = tid; idx < MT * k_len; idx += THREADS) {
    const int r = idx / k_len, k = idx % k_len;  // consecutive threads: K
    const float v = m0 + r < M ? A[(size_t)(m0 + r) * K + k_begin + k] : 0.0f;
    float l[L];
    ftile::split<S>(v, l);
#pragma unroll
    for (int t = 0; t < L; ++t)
      sA[((size_t)k * L + t) * MT + r] = __float2bfloat16_rn(l[t]);
  }

  float acc[MT][TN];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of tile t are in
    __syncthreads();  // everyone's are; tile t-1's buffer is free again
    load_tile(t + STAGES - 1);
    const float* buf = sB + (t % STAGES) * TILE_FLOATS;
    float part[MT][TN];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) part[i][j] = 0.0f;
#pragma unroll
    for (int e = 0; e < KPL; ++e) {
      const int k = kl + KL * e;  // a warp reads one 512-byte row
      if (t * BK + k >= k_len) break;
      const float4 bv = *reinterpret_cast<const float4*>(buf + k * BN + 4 * cq);
      float b[L][TN];
      {
        float l[L];
        ftile::split<S>(bv.x, l);
#pragma unroll
        for (int u = 0; u < L; ++u) b[u][0] = l[u];
        ftile::split<S>(bv.y, l);
#pragma unroll
        for (int u = 0; u < L; ++u) b[u][1] = l[u];
        ftile::split<S>(bv.z, l);
#pragma unroll
        for (int u = 0; u < L; ++u) b[u][2] = l[u];
        ftile::split<S>(bv.w, l);
#pragma unroll
        for (int u = 0; u < L; ++u) b[u][3] = l[u];
      }
      float a[L][MT];
#pragma unroll
      for (int u = 0; u < L; ++u)
        load_a<MT>(sA + ((size_t)(t * BK + k) * L + u) * MT, a[u]);
      ftile::pass_terms<S, MT, TN>(a, b, part);
    }
    ftile::add_into<MT, TN>(part, acc);
  }

  // The 8 K lanes, added in order through shared memory (the ring's space).
  cp_async_wait<0>();
  __syncthreads();
  float* red = sB;  // [KL][MT][BN]
#pragma unroll
  for (int i = 0; i < MT; ++i)
    *reinterpret_cast<float4*>(red + (kl * MT + i) * BN + 4 * cq) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  __syncthreads();
  for (int idx = tid; idx < MT * BN; idx += THREADS) {
    const int r = idx / BN, c = idx % BN;
    float s = red[r * BN + c];
#pragma unroll
    for (int q = 1; q < KL; ++q) s = __fadd_rn(s, red[(q * MT + r) * BN + c]);
    if (m0 + r < M && n0 + c < N)
      dst[((size_t)blockIdx.y * M + m0 + r) * N + n0 + c] = s;
  }
}

// C = the groups of the scratch (groups, M*N) added in order, 4 at a time.
__global__ void __launch_bounds__(256)
    bf16_matmul_combine_kernel(const float4* __restrict__ scratch,
                               float4* __restrict__ C, int n4, int groups) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += gridDim.x * blockDim.x) {
    float4 s = scratch[i];
    for (int g = 1; g < groups; ++g) {
      const float4 v = scratch[(size_t)g * n4 + i];
      s.x = __fadd_rn(s.x, v.x);
      s.y = __fadd_rn(s.y, v.y);
      s.z = __fadd_rn(s.z, v.z);
      s.w = __fadd_rn(s.w, v.w);
    }
    C[i] = s;
  }
}

template <int S, int MT>
cudaError_t launch_mt(const float* A, const float* B, float* C,
                      float* scratch, int M, int N, int K, int group_k,
                      cudaStream_t st) {
  constexpr int L = ftile::Sched<S>::limbs;
  const int groups = (K + group_k - 1) / group_k;
  const size_t bytes = sizeof(float) * STAGES * TILE_FLOATS +
                       sizeof(__nv_bfloat16) * (size_t)group_k * L * MT;
  auto kern = bf16_matmul_group_kernel<S, MT>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((N + BN - 1) / BN, groups, (M + MT - 1) / MT);
  kern<<<grid, THREADS, bytes, st>>>(A, B, groups == 1 ? C : scratch, M, N,
                                     K, group_k);
  e = cudaGetLastError();
  if (e != cudaSuccess || groups == 1) return e;
  const int n4 = M * N / 4;
  const int blocks = n4 < 256 * 528 ? (n4 + 255) / 256 : 528;
  bf16_matmul_combine_kernel<<<blocks, 256, 0, st>>>(
      reinterpret_cast<const float4*>(scratch), reinterpret_cast<float4*>(C),
      n4, groups);
  return cudaGetLastError();
}

template <int S>
cudaError_t launch(const float* A, const float* B, float* C, float* scratch,
                   int M, int N, int K, int group_k, cudaStream_t st) {
  if (M <= 2) return launch_mt<S, 2>(A, B, C, scratch, M, N, K, group_k, st);
  if (M <= 4) return launch_mt<S, 4>(A, B, C, scratch, M, N, K, group_k, st);
  if (M <= 8) return launch_mt<S, 8>(A, B, C, scratch, M, N, K, group_k, st);
  return launch_mt<S, 16>(A, B, C, scratch, M, N, K, group_k, st);
}

}  // namespace

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// A (M, K) and B (K, N) f32, row-major, 16-byte aligned, N a multiple of 4;
// C (M, N) f32; scratch (ceil(K / group_k), M, N) f32 when K > group_k
// (else unused, may be NULL).  group_k: a positive multiple of 32.
// passes: 3, 4 or 6.
extern "C" int bf16_matmul_launch(const void* A, const void* B, void* C,
                                  void* scratch, int M, int N, int K,
                                  int group_k, int passes, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || N % 4 || group_k <= 0 || group_k % BK ||
      (K > group_k && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(A);
  const float* b = static_cast<const float*>(B);
  float* c = static_cast<float*>(C);
  float* s = static_cast<float*>(scratch);
  cudaError_t err;
  switch (passes) {
    case 3: err = launch<ftile::BF16X3>(a, b, c, s, M, N, K, group_k, st); break;
    case 4: err = launch<ftile::BF16X4>(a, b, c, s, M, N, K, group_k, st); break;
    case 6: err = launch<ftile::BF16X6>(a, b, c, s, M, N, K, group_k, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
