// The bf16-limb GEMM on Hopper: an fp32-accurate (m, k) x (k, n) product
// from bf16 limb passes into one f32 accumulator.
//
// Replaces: src/repro/kernels/kom_matmul/kom_matmul.py:_bf16_kernel
// (bf16x3_matmul_raw), whose sequential K grid carried the f32 sum of
// dot(ah, bh) + dot(ah, bl) + dot(al, bh) [+ dot(al, bl)] in VMEM scratch.
// Here one thread block owns a 16 x 32 output tile and walks all of K
// itself.  A and B arrive as f32 and are split ONCE per tile load into bf16
// limbs (__float2bfloat16_rn, residual in f32: float_tile.cuh); each K entry
// then runs the schedule's pairs as exact bf16 x bf16 products added by
// __fmaf_rn into a per-tile partial sum, folded into a group sum every
// GROUP_TILES tiles and that into the total (float_tile.cuh): passes 3 and
// 4 as in the TPU kernel, and passes 6 (three limbs, pairs i-major (0,0)
// (0,1) (0,2) (1,0) (1,1) (2,0)), the function of
// karatsuba.bf16xn_dot_general(passes=6), so bf16x6 FC layers run here
// too.
//
// What bounds it on this card: the serving path runs the FC layers at
// batch <= 8 (fc6: 8 x 25088 x 4096), where reading the f32 weight once
// (411 MB for VGG16's fc6) is the bound.  What the design does about it:
// the 16-row tile covers a whole serving batch, so every weight element is
// read from device memory once; 128-thread blocks over 32 output columns
// give fc6 128 blocks for the 132 SMs.  The passes run on the CUDA cores;
// split-K for more loads in flight and bf16 MMA are later work.
#include "float_tile.cuh"

namespace {

constexpr int BM = 16, BN = 32, BK = 32, TN = 4;
constexpr int THREADS = BM * (BN / TN);  // 128: one row x 4 columns each
constexpr int GROUP_TILES = 32;          // K tiles per group sum (1024 K)

template <int S>
__global__ void __launch_bounds__(THREADS)
    bf16_matmul_kernel(const float* __restrict__ A,
                       const float* __restrict__ B, float* __restrict__ C,
                       int M, int N, int K) {
  constexpr int L = ftile::Sched<S>::limbs;
  __shared__ float sa[L][BK][BM + 1];
  __shared__ float sb[L][BK][BN];
  const int tid = threadIdx.x;
  const int ty = tid / (BN / TN), tx = tid % (BN / TN);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float acc[1][TN], group[1][TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) acc[0][j] = group[0][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // A tile: row m, consecutive threads on consecutive K entries.
    for (int idx = tid; idx < BM * BK; idx += THREADS) {
      const int m = idx / BK, k = idx % BK;
      const int gm = m0 + m, gk = k0 + k;
      const float v = (gm < M && gk < K) ? A[(size_t)gm * K + gk] : 0.0f;
      float l[L];
      ftile::split<S>(v, l);
#pragma unroll
      for (int t = 0; t < L; ++t) sa[t][k][m] = l[t];
    }
    // B tile: consecutive threads on consecutive columns.
#pragma unroll
    for (int r = 0; r < BK * BN / THREADS; ++r) {
      const int idx = tid + r * THREADS;
      const int n = idx % BN, k = idx / BN;
      const int gn = n0 + n, gk = k0 + k;
      const float v = (gn < N && gk < K) ? B[(size_t)gk * N + gn] : 0.0f;
      float l[L];
      ftile::split<S>(v, l);
#pragma unroll
      for (int t = 0; t < L; ++t) sb[t][k][n] = l[t];
    }
    __syncthreads();
    float part[1][TN];
#pragma unroll
    for (int j = 0; j < TN; ++j) part[0][j] = 0.0f;
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[L][1], b[L][TN];
#pragma unroll
      for (int t = 0; t < L; ++t) {
        a[t][0] = sa[t][k][ty];
#pragma unroll
        for (int j = 0; j < TN; ++j) b[t][j] = sb[t][k][tx + j * (BN / TN)];
      }
      ftile::pass_terms<S, 1, TN>(a, b, part);
    }
    __syncthreads();
    ftile::add_into<1, TN>(part, group);
    if ((k0 / BK) % GROUP_TILES == GROUP_TILES - 1) {
      ftile::add_into<1, TN>(group, acc);
#pragma unroll
      for (int j = 0; j < TN; ++j) group[0][j] = 0.0f;
    }
  }
  ftile::add_into<1, TN>(group, acc);

  const int gm = m0 + ty;
  if (gm >= M) return;
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int gn = n0 + tx + j * (BN / TN);
    if (gn < N) C[(size_t)gm * N + gn] = acc[0][j];
  }
}

template <int S>
cudaError_t launch(const void* A, const void* B, void* C, int M, int N, int K,
                   cudaStream_t st) {
  const dim3 g((N + BN - 1) / BN, (M + BM - 1) / BM);
  bf16_matmul_kernel<S><<<g, THREADS, 0, st>>>(
      static_cast<const float*>(A), static_cast<const float*>(B),
      static_cast<float*>(C), M, N, K);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// A (M, K) and B (K, N) f32, row-major; C (M, N) f32.  passes: 3, 4 or 6.
extern "C" int bf16_matmul_launch(const void* A, const void* B, void* C,
                                  int M, int N, int K, int passes,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (passes) {
    case 3: err = launch<ftile::BF16X3>(A, B, C, M, N, K, st); break;
    case 4: err = launch<ftile::BF16X4>(A, B, C, M, N, K, st); break;
    case 6: err = launch<ftile::BF16X6>(A, B, C, M, N, K, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
