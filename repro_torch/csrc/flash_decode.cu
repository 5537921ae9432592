// Flash decode on Hopper: one query token per (batch, q-head) against a KV
// cache (b, hkv, S, dh), keys at positions <= pos valid; f32 math, the
// output in q's dtype.
//
// Replaces: src/repro/kernels/flash_decode/flash_decode.py:_decode_kernel
// (flash_decode_raw), whose grid (b, hq, S/bk) ran the KV-block axis in
// order and combined the blocks' online-softmax partials in VMEM scratch.
// Blocks on the card run in no order, so the sequential KV axis becomes
// split-K: flash_decode_split_kernel gives each (split of SPLIT keys,
// kv-head, batch) one thread block that runs the online softmax over its
// keys for all `group` q-heads of that kv-head (GQA by index: K/V are read
// once per group), and writes (m, l, acc) partials; flash_decode_combine
// rescales them by exp(m_s - max m) and divides.  Why split-K and not one
// block per (b, head) walking every block: at the serving shapes (b 8,
// hkv 8) that is 64 blocks for 132 SMs, and one block cannot keep enough
// loads in flight to stream its 2 MB of K/V at the card's rate.
//
// What bounds it on this card: reading the cache once (2*b*hkv*S*dh
// elements; 4096 keys at dh 64, b 8, hkv 8: 134 MB in f32), ~1 FLOP per
// byte.  What the design does about it: 16 splits per (b, kv-head) at
// S = 4096 give 1024 blocks, each reading its K/V chunk coalesced into
// shared memory once for all its q-heads; splits wholly past pos read
// nothing.
//
// Arithmetic, kept as the TPU kernel's: s = (q . k) / sqrt(dh), -1e30 for
// keys past pos (not -inf), running max, p = exp(s - m), alpha = exp(m_old -
// m), out = acc / (l == 0 ? 1 : l).  When pos >= 0 key 0 is live, so keys
// past pos add exactly nothing (p = 0, alpha = 1) and a split wholly past
// pos (m = -1e30, l = 0, acc = 0) gets weight exp(-1e30 - M) = 0 in the
// combine: both are skipped.  When pos < 0 every key is masked and the
// reference averages all of them; then every split runs in full.  expf
// (never __expf); -fmad=false is on and every multiply-add is an explicit
// __fmaf_rn.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int CH = 32;      // keys per chunk = one warp's lanes
constexpr int SPLIT = 256;  // keys per split
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

size_t split_smem_bytes(int g, int dh) {
  // sQ[g][dh] sAcc[g][dh] sS[g][CH] sM/sL/sA[g]; sK[CH][dh+1] sV[CH][dh]
  return sizeof(float) *
         ((size_t)g * (2 * dh + CH + 3) + (size_t)CH * (2 * dh + 1));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    flash_decode_split_kernel(const T* __restrict__ Q,
                              const T* __restrict__ K,
                              const T* __restrict__ V, float* __restrict__ Pm,
                              float* __restrict__ Pl,
                              float* __restrict__ Pacc, int hq, int hkv,
                              int S, int dh, int pos, int nsplit,
                              float denom) {
  extern __shared__ float smem[];
  const int g = hq / hkv;
  float* sQ = smem;             // [g][dh]
  float* sAcc = sQ + g * dh;    // [g][dh]
  float* sS = sAcc + g * dh;    // [g][CH]
  float* sM = sS + g * CH;      // [g]
  float* sL = sM + g;           // [g]
  float* sA = sL + g;           // [g]
  float* sK = sA + g;           // [CH][dh + 1]
  float* sV = sK + CH * (dh + 1);  // [CH][dh]

  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int ks0 = split * SPLIT;
  const int ks1 = ks0 + SPLIT < S ? ks0 + SPLIT : S;
  const int kend = pos >= 0 && pos + 1 < ks1 ? pos + 1 : ks1;
  const size_t part0 = (size_t)(b * hq + hk * g) * nsplit + split;

  if (pos >= 0 && ks0 > pos) {  // wholly past pos: weight 0 in the combine
    for (int o = tid; o < g * dh; o += THREADS) {
      const size_t p = part0 + (size_t)(o / dh) * nsplit;
      Pacc[p * dh + o % dh] = 0.0f;
      if (o % dh == 0) {
        Pm[p] = NEG;
        Pl[p] = 0.0f;
      }
    }
    return;
  }
  for (int o = tid; o < g * dh; o += THREADS) {
    sQ[o] = to_f32(Q[(size_t)(b * hq + hk * g) * dh + o]);
    sAcc[o] = 0.0f;
  }
  for (int i = tid; i < g; i += THREADS) {
    sM[i] = NEG;
    sL[i] = 0.0f;
  }
  const T* kb = K + (size_t)(b * hkv + hk) * S * dh;
  const T* vb = V + (size_t)(b * hkv + hk) * S * dh;

  for (int c0 = ks0; c0 < kend; c0 += CH) {
    __syncthreads();  // the previous chunk's reads are done
    for (int idx = tid; idx < CH * dh; idx += THREADS) {
      const int j = idx / dh, d = idx % dh;
      const bool ok = c0 + j < kend;
      const size_t gi = (size_t)c0 * dh + idx;
      sK[j * (dh + 1) + d] = ok ? to_f32(kb[gi]) : 0.0f;
      sV[idx] = ok ? to_f32(vb[gi]) : 0.0f;
    }
    __syncthreads();
    for (int p = tid; p < g * CH; p += THREADS) {
      const int gi = p / CH, j = p % CH, kp = c0 + j;
      float s = -INFINITY;  // keys at or past kend add nothing
      if (kp < kend) {
        float dot = 0.0f;
        for (int d = 0; d < dh; ++d)
          dot = __fmaf_rn(sQ[gi * dh + d], sK[j * (dh + 1) + d], dot);
        s = kp <= pos ? __fdiv_rn(dot, denom) : NEG;
      }
      sS[gi * CH + j] = s;
    }
    __syncthreads();
    for (int gi = warp; gi < g; gi += THREADS / 32) {
      const float s = sS[gi * CH + lane];
      float mx = s;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = sM[gi];
      const float m_new = fmaxf(m_old, mx);
      const float p = expf(__fsub_rn(s, m_new));
      float sum = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, off));
      sS[gi * CH + lane] = p;
      if (lane == 0) {
        const float alpha = expf(__fsub_rn(m_old, m_new));
        sA[gi] = alpha;
        sL[gi] = __fadd_rn(__fmul_rn(sL[gi], alpha), sum);
        sM[gi] = m_new;
      }
    }
    __syncthreads();
    for (int o = tid; o < g * dh; o += THREADS) {
      const int gi = o / dh, d = o % dh;
      float a = __fmul_rn(sAcc[o], sA[gi]);
      for (int j = 0; j < CH; ++j)
        a = __fmaf_rn(sS[gi * CH + j], sV[j * dh + d], a);
      sAcc[o] = a;
    }
  }
  __syncthreads();
  for (int o = tid; o < g * dh; o += THREADS) {
    const size_t p = part0 + (size_t)(o / dh) * nsplit;
    Pacc[p * dh + o % dh] = sAcc[o];
    if (o % dh == 0) {
      Pm[p] = sM[o / dh];
      Pl[p] = sL[o / dh];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    flash_decode_combine(const float* __restrict__ Pm,
                         const float* __restrict__ Pl,
                         const float* __restrict__ Pacc, T* __restrict__ O,
                         int dh, int nsplit) {
  const size_t row = blockIdx.x;  // b * hq + h
  const float* pm = Pm + row * nsplit;
  const float* pl = Pl + row * nsplit;
  float M = NEG;
  for (int s = 0; s < nsplit; ++s) M = fmaxf(M, pm[s]);
  float L = 0.0f;
  for (int s = 0; s < nsplit; ++s)
    L = __fmaf_rn(pl[s], expf(__fsub_rn(pm[s], M)), L);
  const float den = L == 0.0f ? 1.0f : L;
  for (int d = threadIdx.x; d < dh; d += THREADS) {
    float a = 0.0f;
    for (int s = 0; s < nsplit; ++s)
      a = __fmaf_rn(Pacc[(row * nsplit + s) * dh + d],
                    expf(__fsub_rn(pm[s], M)), a);
    O[row * dh + d] = from_f32<T>(__fdiv_rn(a, den));
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, void* pm,
           void* pl, void* pacc, int b, int hq, int hkv, int S, int dh,
           int pos, float denom, cudaStream_t st) {
  const int nsplit = (S + SPLIT - 1) / SPLIT;
  const size_t bytes = split_smem_bytes(hq / hkv, dh);
  auto kern = flash_decode_split_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  kern<<<dim3(nsplit, hkv, b), THREADS, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<float*>(pm),
      static_cast<float*>(pl), static_cast<float*>(pacc), hq, hkv, S, dh,
      pos, nsplit, denom);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  flash_decode_combine<T><<<b * hq, THREADS, 0, st>>>(
      static_cast<const float*>(pm), static_cast<const float*>(pl),
      static_cast<const float*>(pacc), static_cast<T*>(o), dh, nsplit);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Number of key splits for a cache of S keys (the partials' middle axis).
extern "C" int flash_decode_splits(int S) { return (S + SPLIT - 1) / SPLIT; }

// q (b, hq, 1, dh), k/v (b, hkv, S, dh) -- S the padded cache length -- and
// o (b, hq, 1, dh), contiguous, f32 (bf16 = 0) or bf16 (bf16 = 1); pm/pl
// (b*hq*splits) and pacc (b*hq*splits*dh) f32 scratch.  Launches the split
// and combine kernels; returns cudaGetLastError() (0 on success).
extern "C" int flash_decode_launch(const void* q, const void* k,
                                   const void* v, void* o, void* pm, void* pl,
                                   void* pacc, int b, int hq, int hkv, int S,
                                   int dh, int pos, int bf16, float denom,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(q, k, v, o, pm, pl, pacc, b, hq, hkv, S, dh,
                                 pos, denom, st);
  return launch<float>(q, k, v, o, pm, pl, pacc, b, hq, hkv, S, dh, pos,
                       denom, st);
}
