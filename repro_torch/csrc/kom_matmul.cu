// The limb GEMM on Hopper: (m, k) x (k, n) int16 operands in balanced int8
// digits, 3 (Karatsuba) or 4 (schoolbook) __dp4a passes into three int32
// accumulators, one f32 recombine, fused dequant epilogue.
//
// Replaces: src/repro/kernels/kom_matmul/kom_matmul.py:_int_kernel
// (kom_matmul_int_raw), the TPU kernel whose sequential K grid carried the
// three int32 accumulators in VMEM scratch.  Here one thread block owns one
// BM x BN output tile and walks all of K itself (blocks run in no order on
// the card, so nothing may carry across blocks).
//
// What bounds it on this card: on the serving path it runs the RGB stem's
// im2col GEMM (m = 3025 * batch, k = 363, n = 96), which is bound by the
// int8 passes, and the FC layers (m = batch, k = 9216/4096, n = 4096/1000),
// which are bound by reading the int16 weight once (~117 MB for AlexNet).
// What the design does about it: each int16 element is split ONCE per tile
// load into packed int8 digit planes in shared memory, so every __dp4a does
// four digit products; each weight element is read from device memory once
// per BM rows of activations (once in total for a batch of <= 64).  This
// first kernel runs the passes on the CUDA cores (__dp4a) and has no
// software pipeline; the tensor-core (mma/wgmma s8) version is later work.
#include "limb_tile.cuh"

namespace {

constexpr int BM = 64, BN = 64, BK = 32, BK4 = BK / 4, TM = 4, TN = 4;
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256

template <bool KARATSUBA>
__global__ void __launch_bounds__(THREADS)
    kom_matmul_kernel(const int16_t* __restrict__ A,
                      const int16_t* __restrict__ B, float* __restrict__ C,
                      const float* __restrict__ row_scale,
                      const float* __restrict__ col_scale,
                      const float* __restrict__ bias, int M, int N, int K,
                      int base_bits) {
  __shared__ limb::Tiles<BM, BN, BK4> s;
  const int tid = threadIdx.x;
  const int ty = tid / (BN / TN), tx = tid % (BN / TN);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  int hh[TM][TN], x[TM][TN], ll[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) hh[i][j] = x[i][j] = ll[i][j] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // A tile: row m, four consecutive K entries per packed int.
    for (int idx = tid; idx < BM * BK4; idx += THREADS) {
      const int m = idx / BK4, k4 = idx % BK4;
      const int gm = m0 + m, gk = k0 + 4 * k4;
      int q[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        q[j] = (gm < M && gk + j < K) ? (int)A[(size_t)gm * K + gk + j] : 0;
      limb::store_a(s, m, k4, q, base_bits);
    }
    // B tile: column n, consecutive threads on consecutive columns.
    for (int idx = tid; idx < BN * BK4; idx += THREADS) {
      const int n = idx % BN, k4 = idx / BN;
      const int gn = n0 + n, gk = k0 + 4 * k4;
      int q[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        q[j] = (gn < N && gk + j < K) ? (int)B[(size_t)(gk + j) * N + gn] : 0;
      limb::store_b(s, n, k4, q, base_bits);
    }
    __syncthreads();
    limb::passes<BM, BN, BK4, TM, TN, KARATSUBA>(s, ty, tx, hh, x, ll);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty + i * (BM / TM);
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx + j * (BN / TN);
      if (gn >= N) continue;
      const int mid = limb::mid_of<KARATSUBA>(hh[i][j], x[i][j], ll[i][j]);
      float v = limb::recombine(hh[i][j], mid, ll[i][j], base_bits);
      if (row_scale != nullptr)
        v = limb::dequant(v, row_scale[gm], col_scale[gn], bias, gn);
      C[(size_t)gm * N + gn] = v;
    }
  }
}

}  // namespace

LIMB_EXPORT_ERROR_STRING

// Returns cudaGetLastError() after the launch (0 on success).  row_scale,
// col_scale and bias may be NULL: no scales -> the raw recombined product.
extern "C" int kom_matmul_launch(const void* A, const void* B, void* C,
                                 const void* row_scale, const void* col_scale,
                                 const void* bias, int M, int N, int K,
                                 int base_bits, int karatsuba,
                                 void* stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* a = static_cast<const int16_t*>(A);
  const auto* b = static_cast<const int16_t*>(B);
  auto* c = static_cast<float*>(C);
  const auto* rs = static_cast<const float*>(row_scale);
  const auto* cs = static_cast<const float*>(col_scale);
  const auto* bs = static_cast<const float*>(bias);
  if (karatsuba)
    kom_matmul_kernel<true><<<grid, THREADS, 0, st>>>(a, b, c, rs, cs, bs, M,
                                                      N, K, base_bits);
  else
    kom_matmul_kernel<false><<<grid, THREADS, 0, st>>>(a, b, c, rs, cs, bs, M,
                                                       N, K, base_bits);
  return static_cast<int>(cudaGetLastError());
}
