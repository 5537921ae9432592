// Chunkwise mLSTM on Hopper: gated linear attention over chunks of C <= 64
// tokens with a (dk x dv) matrix state and a (dk) normalizer carried from
// chunk to chunk, starting from zero; y = (y_intra + y_inter) / max(|n|, 1),
// f32 output.
//
// Replaces: src/repro/kernels/mlstm_chunk/mlstm_chunk.py:_mlstm_kernel
// (mlstm_chunk_raw), whose grid (b, h, chunks) ran the chunk axis in order
// with the whole (dh x dh) f32 state in VMEM scratch.  That design does not
// carry over: at xlstm-125m's full width dh = 2*768/4 = 384, so the state
// is 576 KB -- a block has at most 227 KB of shared memory -- and a
// (b, h) grid is 16 blocks for 132 SMs.  Here one block owns (batch, head,
// a tile of TV = 64 dv columns) and walks every chunk in order itself,
// carrying its slice S[:, tile] (dh x 64 f32, 96 KB at dh 384) and its own
// copy of n (dh floats) in shared memory.  Each block recomputes the
// (C x C) score tile and updates n in the same order as every other block
// of its head, so all copies of n are identical; the dv split multiplies
// the blocks by dh/64 (16 -> 96 at b 4, h 4, dh 384) at the cost of the
// recomputed scores.
//
// What bounds it on this card: f32 operations on the CUDA cores (67
// TFLOP/s): per (b, h, chunk) 2*C*C*dh for the scores, 2*C*C*dh for
// y_intra, 2*C*dh*dh for y_inter and 2*C*dh*dh for the state update --
// ~44 MFLOP at C 64, dh 384 -- against 16*C*dh bytes of f32 q/k/v/y.  What
// the design does about it: q and k stream through shared memory in
// (C x 32) sub-tiles, each used for the scores, for y_inter (against the
// OLD state rows of that sub-tile) and then for the update of those state
// rows; every thread holds 4 x 4 tiles of the scores, y_inter and y_intra
// in registers (16 x 16 threads over 64 x 64 outputs).  The long sums
// (over dh for the scores, y_inter and q . n) are nested: each sub-tile's
// partial is summed on its own and added to the total.
//
// Arithmetic, kept as the model's chunk loop (models/ssm._mlstm_chunk_scan):
// lcum is the inclusive cumsum of log_f, in order within the chunk; every
// exponent is expf(clip(x, -60, 0)) (expf, never __expf), the clip applied
// before the causal select, so s > t never meets inf * 0; scores =
// (q.k * decay) * i_s for s <= t, else 0; qdec = q * exp(lcum_t); kw = k *
// exp(ltot - lcum_s) * i_s; S' = S * exp(ltot) + kw^T v, n' = n * exp(ltot)
// + k^T w; IEEE division.  -fmad=false is on and every multiply-add is an
// explicit __fmaf_rn.  bf16 q/k/v are cast to f32 on load.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;   // 16 x 16
constexpr int CMAX = 64;       // largest chunk
constexpr int DHMAX = 512;     // largest head dim (shared memory)
constexpr int TV = 64;         // dv columns per block
constexpr int DK = 32;         // dk columns per streamed q/k sub-tile
constexpr int LD = DK + 1;     // padded row of a q/k sub-tile
constexpr int LDS = CMAX + 1;  // padded row of the score tile

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float clip_exp(float x) {
  return expf(fminf(fmaxf(x, -60.0f), 0.0f));
}

size_t smem_bytes(int dh) {
  // sS[dh][TV] sN[dh] sV[CMAX][TV] sQ/sQd/sK/sKw[CMAX][LD] sP[CMAX][LDS]
  // sLc/sIg/sEq/sW/sNt[CMAX]
  return sizeof(float) * ((size_t)dh * (TV + 1) + CMAX * TV + 4 * CMAX * LD +
                          CMAX * LDS + 5 * CMAX);
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
    mlstm_chunk_kernel(const T* __restrict__ Q, const T* __restrict__ K,
                       const T* __restrict__ V, const float* __restrict__ LF,
                       const float* __restrict__ IG, float* __restrict__ Y,
                       int H, int S, int dh, int C) {
  extern __shared__ float smem[];
  float* sS = smem;             // [dh][TV] the state slice S[:, v0:v0+TV]
  float* sN = sS + dh * TV;     // [dh] the normalizer
  float* sV = sN + dh;          // [CMAX][TV] the chunk's v tile
  float* sQ = sV + CMAX * TV;   // [CMAX][LD] q sub-tile
  float* sQd = sQ + CMAX * LD;  // q * exp(lcum_t)
  float* sK = sQd + CMAX * LD;  // k sub-tile
  float* sKw = sK + CMAX * LD;  // k * w_s
  float* sP = sKw + CMAX * LD;  // [CMAX][LDS] masked scores
  float* sLc = sP + CMAX * LDS;  // [CMAX] lcum
  float* sIg = sLc + CMAX;       // input gates
  float* sEq = sIg + CMAX;       // exp(clip(lcum_t))
  float* sW = sEq + CMAX;        // exp(clip(ltot - lcum_s)) * i_s
  float* sNt = sW + CMAX;        // max(|n_tok|, 1)

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int v0 = blockIdx.x * TV;
  const int tv = dh - v0 < TV ? dh - v0 : TV;
  const size_t bh = (size_t)blockIdx.z * H + blockIdx.y;
  const T* q = Q + bh * S * dh;
  const T* k = K + bh * S * dh;
  const T* v = V + bh * S * dh;
  const float* lf = LF + bh * S;
  const float* ig = IG + bh * S;
  float* y = Y + bh * S * dh;

  for (int i = tid; i < dh * TV; i += THREADS) sS[i] = 0.0f;
  for (int i = tid; i < dh; i += THREADS) sN[i] = 0.0f;

  for (int c0 = 0; c0 < S; c0 += C) {
    __syncthreads();  // the previous chunk's readers are done
    if (tid < C) {
      sLc[tid] = lf[c0 + tid];
      sIg[tid] = ig[c0 + tid];
    }
    for (int i = tid; i < C * TV; i += THREADS) {
      const int t = i / TV, c = i % TV;
      sV[i] = c < tv ? to_f32(v[(size_t)(c0 + t) * dh + v0 + c]) : 0.0f;
    }
    __syncthreads();
    if (tid == 0) {  // the inclusive cumsum, in order
      float acc = sLc[0];
      for (int t = 1; t < C; ++t) {
        acc = __fadd_rn(acc, sLc[t]);
        sLc[t] = acc;
      }
    }
    __syncthreads();
    const float ltot = sLc[C - 1];
    const float ftot = clip_exp(ltot);
    if (tid < C) {
      sEq[tid] = clip_exp(sLc[tid]);
      sW[tid] = __fmul_rn(clip_exp(__fsub_rn(ltot, sLc[tid])), sIg[tid]);
    }
    float p[4][4], yi[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) p[i][j] = yi[i][j] = 0.0f;
    float ninter = 0.0f;

    for (int k0 = 0; k0 < dh; k0 += DK) {
      const int kw = dh - k0 < DK ? dh - k0 : DK;
      __syncthreads();  // sEq/sW are set; the last sub-tile's readers done
      for (int i = tid; i < C * DK; i += THREADS) {
        const int t = i / DK, d = i % DK;
        float qv = 0.0f, kv = 0.0f;
        if (d < kw) {
          const size_t g = (size_t)(c0 + t) * dh + k0 + d;
          qv = to_f32(q[g]);
          kv = to_f32(k[g]);
        }
        sQ[t * LD + d] = qv;
        sQd[t * LD + d] = __fmul_rn(qv, sEq[t]);
        sK[t * LD + d] = kv;
        sKw[t * LD + d] = __fmul_rn(kv, sW[t]);
      }
      __syncthreads();
      // scores and y_inter (qdec S_old) over this sub-tile, each summed on
      // its own and then added to the running total (nested sums: a flat
      // chain over dh = 384 terms drifts further from the exact value)
      float ps[4][4], ys[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) ps[i][j] = ys[i][j] = 0.0f;
      for (int d = 0; d < kw; ++d) {
        float a[4], ad[4], b[4], sv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          a[i] = sQ[(ty + 16 * i) * LD + d];
          ad[i] = sQd[(ty + 16 * i) * LD + d];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          b[j] = sK[(tx + 16 * j) * LD + d];
          sv[j] = sS[(k0 + d) * TV + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            ps[i][j] = __fmaf_rn(a[i], b[j], ps[i][j]);
            ys[i][j] = __fmaf_rn(ad[i], sv[j], ys[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          p[i][j] = __fadd_rn(p[i][j], ps[i][j]);
          yi[i][j] = __fadd_rn(yi[i][j], ys[i][j]);
        }
      if (tid < C) {
        float acc = 0.0f;
        for (int d = 0; d < kw; ++d)
          acc = __fmaf_rn(sQd[tid * LD + d], sN[k0 + d], acc);
        ninter = __fadd_rn(ninter, acc);
      }
      __syncthreads();
      // the state rows of this sub-tile: S = S * exp(ltot) + kw^T v
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int kr = ty + 16 * i;
        if (kr < kw) {
          float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          for (int s = 0; s < C; ++s) {
            const float w = sKw[s * LD + kr];
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[j] = __fmaf_rn(w, sV[s * TV + tx + 16 * j], acc[j]);
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float* e = sS + (k0 + kr) * TV + tx + 16 * j;
            *e = __fadd_rn(__fmul_rn(*e, ftot), acc[j]);
          }
        }
      }
      if (tid < kw) {  // n = n * exp(ltot) + k^T w
        float acc = 0.0f;
        for (int s = 0; s < C; ++s)
          acc = __fmaf_rn(sK[s * LD + tid], sW[s], acc);
        sN[k0 + tid] = __fadd_rn(__fmul_rn(sN[k0 + tid], ftot), acc);
      }
    }

    // masked, decayed, gated scores
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t = ty + 16 * i, s = tx + 16 * j;
        if (t < C && s < C) {
          const float dec = clip_exp(__fsub_rn(sLc[t], sLc[s]));
          sP[t * LDS + s] =
              t >= s ? __fmul_rn(__fmul_rn(p[i][j], dec), sIg[s]) : 0.0f;
        }
      }
    __syncthreads();
    if (tid < C) {  // n_tok = row sum of the scores + q . n_old
      float acc = 0.0f;
      for (int s0 = 0; s0 < C; s0 += 8) {  // nested: groups of 8
        float part = 0.0f;
        for (int s = s0; s < s0 + 8 && s < C; ++s)
          part = __fadd_rn(part, sP[tid * LDS + s]);
        acc = __fadd_rn(acc, part);
      }
      sNt[tid] = fmaxf(fabsf(__fadd_rn(acc, ninter)), 1.0f);
    }
    __syncthreads();
    float ya[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) ya[i][j] = 0.0f;
    for (int s = 0; s < C; ++s) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sP[(ty + 16 * i) * LDS + s];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = sV[s * TV + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) ya[i][j] = __fmaf_rn(a[i], b[j], ya[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t = ty + 16 * i, c = tx + 16 * j;
        if (t < C && c < tv)
          y[(size_t)(c0 + t) * dh + v0 + c] =
              __fdiv_rn(__fadd_rn(ya[i][j], yi[i][j]), sNt[t]);
      }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* lf,
           const void* ig, void* y, int B, int H, int S, int dh, int C,
           cudaStream_t st) {
  if (C < 1 || C > CMAX || dh < 1 || dh > DHMAX || S % C != 0)
    return (int)cudaErrorInvalidValue;
  const size_t bytes = smem_bytes(dh);
  auto kern = mlstm_chunk_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  kern<<<dim3((dh + TV - 1) / TV, H, B), THREADS, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(lf),
      static_cast<const float*>(ig), static_cast<float*>(y), H, S, dh, C);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q/k/v (B, H, S, dh) contiguous, f32 (bf16 = 0) or bf16 (bf16 = 1);
// log_f/i_gate (B, H, S) f32; y (B, H, S, dh) f32.  S % C == 0, C <= 64,
// dh <= 512.  Returns cudaGetLastError() (0 on success).
extern "C" int mlstm_chunk_launch(const void* q, const void* k, const void* v,
                                  const void* lf, const void* ig, void* y,
                                  int B, int H, int S, int dh, int C,
                                  int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(q, k, v, lf, ig, y, B, H, S, dh, C, st);
  return launch<float>(q, k, v, lf, ig, y, B, H, S, dh, C, st);
}
