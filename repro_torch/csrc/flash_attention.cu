// Flash attention on Hopper: online-softmax attention with GQA, causal and
// sliding-window masks and a q_offset; f32 math, the output in q's dtype.
//
// Replaces: src/repro/kernels/flash_attention/flash_attention.py:_attn_kernel
// (flash_attention_raw), whose grid (b, hq, sq/bq, skv/bk) ran the KV axis in
// order and carried the running max m, denominator l and the (bq, d)
// accumulator in VMEM scratch.  Blocks on the card run in no order, so here
// one thread block owns (batch, q-head, 128-row q block) and walks the KV
// blocks itself, keeping m, l and the accumulator in registers.  GQA is by
// index: q-head h reads kv-head h / group; no repeated K/V exists.
//
// What bounds it on this card: at the prefill shapes (sq = skv = 2048,
// d = 64) the work is 4*sq*skv*d FLOPs per head, half of it masked, ~96
// FLOPs per byte of q/k/v/o: bound by the f32 multiply-adds.  What the
// design does about it: the q tile stays in shared memory for the whole
// walk, K/V tiles of 32 keys are staged once per block, and each thread
// keeps a 4-row x 4-key score tile and a 4-row x d/8 output tile in
// registers (8-10 multiply-adds per shared-memory load, float4 loads,
// padded K rows for conflict-free reads).  Blocks skip the KV tiles outside
// the live key range of their rows (the causal half), and the heaviest q
// blocks launch first.  Tensor cores (mma/wgmma) are later work.
//
// Arithmetic, kept as the TPU kernel's: s = (q . k) * scale, then -1e30
// where masked (not -inf), m_new = max(m, rowmax(s)), p = exp(s - m_new),
// alpha = exp(m - m_new), l = l*alpha + rowsum(p), acc = acc*alpha + p v,
// out = acc / (l == 0 ? 1 : l).  Keys at or past skv (the wrapper's padded
// length) do not exist and get -inf, which adds exactly nothing.  For a row
// with a live key, a wholly masked tile adds nothing after the first live
// one and is wiped (alpha = 0) before it, so skipping it is exact; a row
// with no live key averages every value in the reference, so a tile with
// such a row walks every KV tile.  expf (never __expf); -fmad=false is on
// and every multiply-add is an explicit __fmaf_rn.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 128;       // q rows per block
constexpr int BKV = 32;       // keys per KV tile
constexpr int THREADS = 256;  // 32 row groups x 8 lanes
constexpr int RPT = 4;        // rows per thread: 4*ty .. 4*ty+3
constexpr int KPT = BKV / 8;  // keys per thread: tx + 8*j
constexpr int PS = BKV + 4;   // padded row of the P tile
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

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

template <int DH>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (size_t)(BQ * DH + BKV * (DH + 4) + BKV * DH + BQ * PS);
}

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
    flash_attention_kernel(const T* __restrict__ Q, const T* __restrict__ K,
                           const T* __restrict__ V, T* __restrict__ O, int hq,
                           int hkv, int sq, int skv, int causal,
                           int has_window, int window, int q_offset,
                           float scale) {
  constexpr int KS = DH + 4;                  // padded K row
  constexpr int VEC = DH >= 32 ? 4 : DH / 8;  // output dims per chunk
  constexpr int NV = DH / (8 * VEC);          // chunks per thread
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);  // [BQ][DH]
  float* sK = sQ + BQ * DH;                     // [BKV][KS]
  float* sV = sK + BKV * KS;                    // [BKV][DH]
  float* sP = sV + BKV * DH;                    // [BQ][PS]

  const int n_qt = (sq + BQ - 1) / BQ;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * BQ;  // latest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int tid = threadIdx.x, ty = tid / 8, tx = tid % 8;
  const T* qb = Q + ((size_t)(b * hq + h) * sq) * DH;
  const T* kb = K + ((size_t)(b * hkv + hk) * skv) * DH;
  const T* vb = V + ((size_t)(b * hkv + hk) * skv) * DH;

  for (int idx = tid; idx < BQ * DH; idx += THREADS) {
    const int r = idx / DH;
    sQ[idx] = q0 + r < sq ? to_f32(qb[(size_t)q0 * DH + idx]) : 0.0f;
  }

  // The KV tiles to walk: the union of the rows' live key ranges, or every
  // tile when one row has no live key (see the note at the top).
  long long lo_all = (long long)skv, hi_all = -1;
  bool any_empty = false;
  for (int r = 0; r < BQ && q0 + r < sq; ++r) {
    const long long p = (long long)q0 + r + q_offset;
    long long hi = causal ? (p < skv - 1 ? p : skv - 1) : skv - 1;
    long long lo = has_window ? p - window + 1 : 0;
    if (lo < 0) lo = 0;
    if (lo > hi) {
      any_empty = true;
    } else {
      lo_all = lo < lo_all ? lo : lo_all;
      hi_all = hi > hi_all ? hi : hi_all;
    }
  }
  const int n_kt = (skv + BKV - 1) / BKV;
  const int kt_begin = any_empty ? 0 : (int)(lo_all / BKV);
  const int kt_end = any_empty ? n_kt : (int)(hi_all / BKV) + 1;

  float m[RPT], l[RPT], acc[RPT][NV * VEC];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = NEG;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < NV * VEC; ++c) acc[i][c] = 0.0f;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BKV;
    __syncthreads();  // the previous tile's K/V/P reads are done
    for (int idx = tid; idx < BKV * DH; idx += THREADS) {
      const int j = idx / DH, d = idx % DH;
      const bool ok = k0 + j < skv;
      const size_t g = (size_t)k0 * DH + idx;
      sK[j * KS + d] = ok ? to_f32(kb[g]) : 0.0f;
      sV[idx] = ok ? to_f32(vb[g]) : 0.0f;
    }
    __syncthreads();

    // Scores for rows 4*ty+i and keys tx+8*j.
    float s[RPT][KPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < KPT; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < DH; d += 4) {
      float4 qv[RPT], kv[KPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&sQ[(RPT * ty + i) * DH + d]);
#pragma unroll
      for (int j = 0; j < KPT; ++j)
        kv[j] = *reinterpret_cast<const float4*>(&sK[(tx + 8 * j) * KS + d]);
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < KPT; ++j) {
          s[i][j] = __fmaf_rn(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = __fmaf_rn(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = __fmaf_rn(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = __fmaf_rn(qv[i].w, kv[j].w, s[i][j]);
        }
    }

    // Mask, online softmax; a row's 8 lanes are adjacent in one warp.
    float alpha[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const long long p = (long long)q0 + RPT * ty + i + q_offset;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const int kp = k0 + tx + 8 * j;
        float v;
        if (kp >= skv) {
          v = -INFINITY;  // no such key
        } else {
          const bool live = (!causal || p >= kp) &&
                            (!has_window || p - kp < (long long)window);
          v = live ? __fmul_rn(s[i][j], scale) : NEG;
        }
        s[i][j] = v;
        mx = fmaxf(mx, v);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const float pj = expf(__fsub_rn(s[i][j], m_new));
        sP[(RPT * ty + i) * PS + tx + 8 * j] = pj;
        sum = __fadd_rn(sum, pj);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, off));
      alpha[i] = expf(__fsub_rn(m[i], m_new));
      l[i] = __fadd_rn(__fmul_rn(l[i], alpha[i]), sum);
      m[i] = m_new;
    }
    __syncwarp();  // a row's P entries come from its own warp

    // acc = acc * alpha + P V for rows 4*ty+i, dims tx*VEC + 8*VEC*u + e.
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int c = 0; c < NV * VEC; ++c)
        acc[i][c] = __fmul_rn(acc[i][c], alpha[i]);
#pragma unroll 2
    for (int j = 0; j < BKV; j += 4) {
      float4 pv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        pv[i] = *reinterpret_cast<const float4*>(&sP[(RPT * ty + i) * PS + j]);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float vv[NV * VEC];
#pragma unroll
        for (int u = 0; u < NV; ++u) {
          const float* src = &sV[(j + jj) * DH + tx * VEC + 8 * VEC * u];
          if constexpr (VEC == 4) {
            const float4 t = *reinterpret_cast<const float4*>(src);
            vv[4 * u] = t.x;
            vv[4 * u + 1] = t.y;
            vv[4 * u + 2] = t.z;
            vv[4 * u + 3] = t.w;
          } else {
#pragma unroll
            for (int e = 0; e < VEC; ++e) vv[VEC * u + e] = src[e];
          }
        }
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const float pij = comp(pv[i], jj);
#pragma unroll
          for (int c = 0; c < NV * VEC; ++c)
            acc[i][c] = __fmaf_rn(pij, vv[c], acc[i][c]);
        }
      }
    }
  }

  T* ob = O + ((size_t)(b * hq + h) * sq) * DH;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = q0 + RPT * ty + i;
    if (r >= sq) continue;
    const float den = l[i] == 0.0f ? 1.0f : l[i];
#pragma unroll
    for (int u = 0; u < NV; ++u)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        ob[(size_t)r * DH + tx * VEC + 8 * VEC * u + e] =
            from_f32<T>(__fdiv_rn(acc[i][VEC * u + e], den));
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int hq, int hkv, int sq, int skv, int causal, int has_window,
           int window, int q_offset, float scale, cudaStream_t st) {
  constexpr size_t bytes = smem_bytes<DH>();
  auto kern = flash_attention_kernel<T, DH>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((sq + BQ - 1) / BQ, hq, b);
  kern<<<grid, THREADS, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), hq, hkv, sq, skv, causal,
      has_window, window, q_offset, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dh(int dh, const void* q, const void* k, const void* v, void* o,
              int b, int hq, int hkv, int sq, int skv, int causal,
              int has_window, int window, int q_offset, float scale,
              cudaStream_t st) {
  switch (dh) {
    case 16:
      return launch<T, 16>(q, k, v, o, b, hq, hkv, sq, skv, causal,
                           has_window, window, q_offset, scale, st);
    case 32:
      return launch<T, 32>(q, k, v, o, b, hq, hkv, sq, skv, causal,
                           has_window, window, q_offset, scale, st);
    case 64:
      return launch<T, 64>(q, k, v, o, b, hq, hkv, sq, skv, causal,
                           has_window, window, q_offset, scale, st);
    case 128:
      return launch<T, 128>(q, k, v, o, b, hq, hkv, sq, skv, causal,
                            has_window, window, q_offset, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q (b, hq, sq, dh), k/v (b, hkv, skv, dh) -- skv is the padded key count --
// and o (b, hq, sq, dh), all contiguous, f32 (bf16 = 0) or bf16 (bf16 = 1).
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int b, int hq,
                                      int hkv, int sq, int skv, int dh,
                                      int causal, int has_window, int window,
                                      int q_offset, int bf16, float scale,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_dh<__nv_bfloat16>(dh, q, k, v, o, b, hq, hkv, sq, skv,
                                    causal, has_window, window, q_offset,
                                    scale, st);
  return launch_dh<float>(dh, q, k, v, o, b, hq, hkv, sq, skv, causal,
                          has_window, window, q_offset, scale, st);
}
