// Flash decode on Hopper: one query token per (batch, q-head) against a KV
// cache (b, hkv, S, dh), keys at positions <= pos valid; f32 math, the
// output in q's dtype.
//
// Replaces: src/repro/kernels/flash_decode/flash_decode.py:_decode_kernel
// (flash_decode_raw), whose grid (b, hq, S/bk) ran the KV-block axis in
// order and combined the blocks' online-softmax partials in VMEM scratch.
// Blocks on the card run in no order, so the sequential KV axis becomes
// split-K: flash_decode_split_kernel gives each (split of `split` keys,
// kv-head and group of GB q-heads, batch) one thread block that runs the
// online softmax over its keys and writes (m, l, acc) partials;
// flash_decode_combine rescales them by exp(m_s - max m) and divides, in a
// fixed order (bitwise the same from run to run).
//
// What bounds it on this card: reading the cache once (2*b*hkv*S*dh
// elements; 4096 keys at dh 64, b 8, hkv 8: 67 MB in bf16), ~1 FLOP per
// byte.  What the design does about it:
//   * the wrapper picks the split (flash_decode.flash_decode_splits, a
//     multiple of the 64-key chunk) so the grid covers every SM at least
//     twice, whatever b, hkv and S are;
//   * K and V stream through a 2-stage cp.async ring of 64-key chunks in
//     16-byte copies (8 bf16 or 4 f32), kept in the cache's own dtype and
//     widened to f32 at use; one chunk is in flight while the block
//     computes on the other, one __syncthreads per chunk (a third stage
//     measured no faster in bf16 and slower in f32 on an H100: fewer
//     blocks fit an SM);
//   * 4 warps own 16 keys each per chunk; a group of dh / (16 B) lanes
//     shares a key (a lane holds one 16-byte slice of q, k, v and the
//     accumulator), so a score is a short FMA chain and a butterfly
//     shuffle reduce, and each group runs its own online softmax over its
//     keys, P V included; the block combines its groups in a fixed order;
//   * splits wholly past pos read nothing;
//   * where sqrt(dh) is a power of two (dh 16, 64) q is prescaled by its
//     inverse, exactly, instead of a division per score (the division was
//     half the bf16 time at the serving shape).
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
constexpr int WARPS = THREADS / 32;
constexpr int CH = 64;            // keys per chunk
constexpr int KPW = CH / WARPS;   // keys per warp per chunk
constexpr int STAGES = 2;         // chunks of the cp.async ring
constexpr float NEG = -1e30f;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// 16 bytes of T widened to f32 (exact).
__device__ __forceinline__ void widen(uint4 v, float (&f)[4], const float*) {
  f[0] = __uint_as_float(v.x);
  f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z);
  f[3] = __uint_as_float(v.w);
}
__device__ __forceinline__ void widen(uint4 v, float (&f)[8],
                                      const __nv_bfloat16*) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T, int DH, int GB>
struct Shape {
  static constexpr int E = 16 / sizeof(T);   // elements per 16-byte slice
  static constexpr int LK = DH / E;          // lanes per key
  static constexpr int KP = 32 / LK;         // keys per warp pass
  static constexpr int NK = KPW / KP;        // keys per lane group per chunk
  static constexpr int NB = NK < 4 ? NK : 4; // keys per softmax update
  static constexpr int NG = WARPS * KP;      // lane groups per block
  static_assert(DH % E == 0 && LK >= 2 && LK <= 32 && NK % NB == 0, "dh");
  static constexpr size_t ring_bytes = STAGES * 2 * CH * DH * sizeof(T);
  static constexpr size_t comb_bytes = sizeof(float) * GB * NG * DH;
  static constexpr size_t bytes() {
    return (ring_bytes > comb_bytes ? ring_bytes : comb_bytes) +
           sizeof(float) * 2 * GB * NG;
  }
};

template <typename T, int DH, int GB>
__global__ void __launch_bounds__(THREADS)
    flash_decode_split_kernel(const T* __restrict__ Q,
                              const T* __restrict__ K,
                              const T* __restrict__ V, float* __restrict__ Pm,
                              float* __restrict__ Pl,
                              float* __restrict__ Pacc, int hq, int hkv,
                              int S, int pos, int split, int nsplit,
                              float denom) {
  using Sh = Shape<T, DH, GB>;
  constexpr int E = Sh::E, LK = Sh::LK, KP = Sh::KP, NK = Sh::NK,
                NB = Sh::NB, NG = Sh::NG;
  extern __shared__ float4 smem4[];
  T* sK = reinterpret_cast<T*>(smem4);   // [STAGES][CH][DH]
  T* sV = sK + STAGES * CH * DH;         // [STAGES][CH][DH]
  float* sAcc = reinterpret_cast<float*>(smem4);  // [GB][NG][DH], after
  float* sM = reinterpret_cast<float*>(
      reinterpret_cast<char*>(smem4) +
      (Sh::ring_bytes > Sh::comb_bytes ? Sh::ring_bytes : Sh::comb_bytes));
  float* sL = sM + GB * NG;

  const int g = hq / hkv, hgroups = g / GB;
  const int sp = blockIdx.x, hk = blockIdx.y / hgroups;
  const int h0 = hk * g + (blockIdx.y % hgroups) * GB, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int grp = lane / LK, r = lane % LK;
  const int ks0 = sp * split;
  const int ks1 = ks0 + split < S ? ks0 + split : S;
  const int kend = pos >= 0 && pos + 1 < ks1 ? pos + 1 : ks1;
  const size_t part0 = (size_t)(b * hq + h0) * nsplit + sp;

  if (pos >= 0 && ks0 > pos) {  // wholly past pos: weight 0 in the combine
    for (int o = tid; o < GB * DH; o += THREADS) {
      const size_t p = part0 + (size_t)(o / DH) * nsplit;
      Pacc[p * DH + o % DH] = 0.0f;
      if (o % DH == 0) {
        Pm[p] = NEG;
        Pl[p] = 0.0f;
      }
    }
    return;
  }
  const T* kb = K + (size_t)(b * hkv + hk) * S * DH;
  const T* vb = V + (size_t)(b * hkv + hk) * S * DH;
  auto load_chunk = [&](int slot, int kc0) {
    for (int q = tid; q < CH * LK; q += THREADS) {
      const int j = q / LK, v = q % LK;
      const bool ok = kc0 + j < kend;
      const size_t gi = (size_t)(kc0 + j) * DH + v * E;
      const int si = (slot * CH + j) * DH + v * E;
      cp_async16(sK + si, ok ? kb + gi : kb, ok);
      cp_async16(sV + si, ok ? vb + gi : vb, ok);
    }
  };
  const int nch = (kend - ks0 + CH - 1) / CH;
#pragma unroll
  for (int c = 0; c < STAGES - 1; ++c) {
    if (c < nch) load_chunk(c, ks0 + c * CH);
    cp_async_commit();
  }

  // sqrt(dh) a power of two (dh 16, 64): q / sqrt(dh) is exact and every
  // rounding of the dot scales with it, so prescaling q gives the
  // reference's (q . k) / sqrt(dh) bit for bit without a division per key.
  const bool pow2 = (__float_as_uint(denom) & 0x007fffffu) == 0;
  const float inv = __fdiv_rn(1.0f, denom);
  float qv[GB][E], acc[GB][E], m[GB], l[GB];
#pragma unroll
  for (int h = 0; h < GB; ++h) {
    widen(*reinterpret_cast<const uint4*>(
              Q + (size_t)(b * hq + h0 + h) * DH + r * E),
          qv[h], static_cast<const T*>(nullptr));
    if (pow2)
#pragma unroll
      for (int e = 0; e < E; ++e) qv[h][e] = __fmul_rn(qv[h][e], inv);
    m[h] = NEG;
    l[h] = 0.0f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[h][e] = 0.0f;
  }

  for (int c = 0; c < nch; ++c) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // chunk c landed; every thread is done with c - 1
    const int kc0 = ks0 + c * CH;
    if (c + STAGES - 1 < nch)
      load_chunk((c + STAGES - 1) % STAGES, kc0 + (STAGES - 1) * CH);
    cp_async_commit();
    const T* ks = sK + (c % STAGES) * CH * DH;
    const T* vs = sV + (c % STAGES) * CH * DH;
#pragma unroll
    for (int i0 = 0; i0 < NK; i0 += NB) {
      float s[GB][NB];
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        const int j = warp * KPW + (i0 + i) * KP + grp;
        float kf[E];
        widen(*reinterpret_cast<const uint4*>(ks + j * DH + r * E), kf, ks);
        const bool live = kc0 + j < kend;
#pragma unroll
        for (int h = 0; h < GB; ++h) {
          float dot = 0.0f;
#pragma unroll
          for (int e = 0; e < E; ++e) dot = __fmaf_rn(qv[h][e], kf[e], dot);
#pragma unroll
          for (int off = LK / 2; off > 0; off >>= 1)
            dot = __fadd_rn(dot, __shfl_xor_sync(0xffffffffu, dot, off));
          // keys at or past kend add nothing; pos < 0 masks every key
          s[h][i] = !live     ? -INFINITY
                    : pos < 0 ? NEG
                    : pow2    ? dot
                              : __fdiv_rn(dot, denom);
        }
      }
#pragma unroll
      for (int h = 0; h < GB; ++h) {
        float mx = s[h][0];
#pragma unroll
        for (int i = 1; i < NB; ++i) mx = fmaxf(mx, s[h][i]);
        const float m_new = fmaxf(m[h], mx);
        const float alpha = expf(__fsub_rn(m[h], m_new));
        float sum = 0.0f;
#pragma unroll
        for (int i = 0; i < NB; ++i) {
          s[h][i] = expf(__fsub_rn(s[h][i], m_new));  // p
          sum = __fadd_rn(sum, s[h][i]);
        }
        l[h] = __fadd_rn(__fmul_rn(l[h], alpha), sum);
        m[h] = m_new;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[h][e] = __fmul_rn(acc[h][e], alpha);
      }
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        const int j = warp * KPW + (i0 + i) * KP + grp;
        float vf[E];
        widen(*reinterpret_cast<const uint4*>(vs + j * DH + r * E), vf, vs);
#pragma unroll
        for (int h = 0; h < GB; ++h)
#pragma unroll
          for (int e = 0; e < E; ++e)
            acc[h][e] = __fmaf_rn(s[h][i], vf[e], acc[h][e]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: sAcc aliases it

  // The block's NG group states -> one partial per head, groups in order.
  const int gg = warp * KP + grp;
#pragma unroll
  for (int h = 0; h < GB; ++h) {
#pragma unroll
    for (int e = 0; e < E; ++e)
      sAcc[(h * NG + gg) * DH + r * E + e] = acc[h][e];
    if (r == 0) {
      sM[h * NG + gg] = m[h];
      sL[h * NG + gg] = l[h];
    }
  }
  __syncthreads();
  if (tid < GB) {
    const int h = tid;
    float M = NEG;
    for (int x = 0; x < NG; ++x) M = fmaxf(M, sM[h * NG + x]);
    float L = 0.0f;
    for (int x = 0; x < NG; ++x) {
      const float w = expf(__fsub_rn(sM[h * NG + x], M));
      sM[h * NG + x] = w;  // the group's weight, for the accumulators
      L = __fmaf_rn(sL[h * NG + x], w, L);
    }
    const size_t p = part0 + (size_t)h * nsplit;
    Pm[p] = M;
    Pl[p] = L;
  }
  __syncthreads();
  for (int o = tid; o < GB * DH; o += THREADS) {
    const int h = o / DH, d = o % DH;
    float a = 0.0f;
    for (int x = 0; x < NG; ++x)
      a = __fmaf_rn(sAcc[(h * NG + x) * DH + d], sM[h * NG + x], a);
    Pacc[(part0 + (size_t)h * nsplit) * DH + d] = a;
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

struct Args {
  const void *q, *k, *v;
  void *o, *pm, *pl, *pacc;
  int b, hq, hkv, S, pos, split, nsplit;
  float denom;
};

template <typename T, int DH, int GB>
int launch_split(const Args& a, cudaStream_t st) {
  const size_t bytes = Shape<T, DH, GB>::bytes();
  auto kern = flash_decode_split_kernel<T, DH, GB>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  const int hgroups = a.hq / a.hkv / GB;
  kern<<<dim3(a.nsplit, a.hkv * hgroups, a.b), THREADS, bytes, st>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<float*>(a.pm),
      static_cast<float*>(a.pl), static_cast<float*>(a.pacc), a.hq, a.hkv,
      a.S, a.pos, a.split, a.nsplit, a.denom);
  return (int)cudaGetLastError();
}

// GB = 4, 2 or 1 q-heads per block: the largest that divides the group.
template <typename T, int DH>
int launch_dh(const Args& a, cudaStream_t st) {
  const int g = a.hq / a.hkv;
  if (g % 4 == 0) return launch_split<T, DH, 4>(a, st);
  if (g % 2 == 0) return launch_split<T, DH, 2>(a, st);
  return launch_split<T, DH, 1>(a, st);
}

template <typename T>
int launch(const Args& a, int dh, cudaStream_t st) {
  int e;
  switch (dh) {
    case 16: e = launch_dh<T, 16>(a, st); break;
    case 32: e = launch_dh<T, 32>(a, st); break;
    case 64: e = launch_dh<T, 64>(a, st); break;
    case 128: e = launch_dh<T, 128>(a, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (e != 0) return e;
  flash_decode_combine<T><<<a.b * a.hq, THREADS, 0, st>>>(
      static_cast<const float*>(a.pm), static_cast<const float*>(a.pl),
      static_cast<const float*>(a.pacc), static_cast<T*>(a.o), dh, a.nsplit);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q (b, hq, 1, dh), k/v (b, hkv, S, dh) -- S the padded cache length -- and
// o (b, hq, 1, dh), contiguous, 16-byte aligned, f32 (bf16 = 0) or bf16
// (bf16 = 1); dh 16, 32, 64 or 128; `split` keys per split (a multiple of
// 64), nsplit = ceil(S / split); pm/pl (b*hq*nsplit) and pacc
// (b*hq*nsplit*dh) f32 scratch.  Launches the split and combine kernels;
// returns cudaGetLastError() (0 on success).
extern "C" int flash_decode_launch(const void* q, const void* k,
                                   const void* v, void* o, void* pm, void* pl,
                                   void* pacc, int b, int hq, int hkv, int S,
                                   int dh, int pos, int split, int nsplit,
                                   int bf16, float denom, void* stream) {
  if (split % CH || nsplit != (S + split - 1) / split)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, o, pm, pl, pacc, b, hq, hkv, S, pos, split, nsplit,
               denom};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(a, dh, st) : launch<float>(a, dh, st);
}
