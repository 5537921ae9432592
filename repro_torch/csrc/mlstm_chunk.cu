// Chunkwise mLSTM on Hopper: gated linear attention over chunks of C <= 64
// tokens with a (dk x dv) matrix state and a (dk) normalizer carried from
// chunk to chunk, starting from zero; y = (y_intra + y_inter) / max(|n|, 1),
// f32 output.
//
// Replaces: src/repro/kernels/mlstm_chunk/mlstm_chunk.py:_mlstm_kernel
// (mlstm_chunk_raw), whose grid (b, h, chunks) ran the chunk axis in order
// with the whole (dh x dh) f32 state in VMEM scratch.  That design does not
// carry over: at xlstm-125m's full width dh = 2*768/4 = 384 the state is
// 576 KB -- a block has at most 227 KB of shared memory -- and one block
// per (b, h) walking every chunk is 16 blocks for 132 SMs.
//
// What bounds it on this card: the f32 products -- per (b, h, chunk)
// 2*C*C*dh for the scores, 2*C*C*dh for y_intra, 2*C*dh*dh for y_inter and
// 2*C*dh*dh for the state update, ~44 MFLOP at C 64, dh 384 -- against
// 16*C*dh bytes of f32 q/k/v/y.  What the design does about it: only the
// state's walk is sequential, so it is the only part that walks; and every
// product runs as three TF32 passes on the tensor cores (csrc/tf32x3.cuh).
// Two kernels, launched back to back on one stream:
//   (a) the state walk: one block per (b, h, 64-row dk tile, 64-column dv
//       tile) -- 36 per (b, h) at dh 384 -- walks chunks 0 .. nc - 2 in
//       order with its 64 x 64 slice of S in registers, writes each chunk's
//       start state S_{c-1} (c >= 1) to the scratch and adds kw^T v for its
//       tile (K = the chunk's tokens); the dv-tile-0 blocks also carry and
//       write the normalizer n_{c-1}.  The next chunk's k/v are loaded into
//       registers while this chunk's MMAs run.
//   (b) the outputs: one block per (b, h, chunk, 64-column dv tile), all
//       chunks at once: the (C x C) scores over dh in 32-column sub-tiles,
//       y_inter = qdec S_{c-1} over the same sub-tiles, the masked scores P
//       through shared memory into P v, then
//       y = (P v + qdec S_{c-1}) / max(|rowsum P + qdec . n_{c-1}|, 1).
//       Chunk 0 starts from zero: it reads no state and adds no y_inter.
// The scratch holds nc - 1 states and normalizers, b*h*(nc-1)*(dh*dh + dh)
// f32 (mlstm_chunk_scratch): written once by (a), read once by (b).
//
// Arithmetic, kept as the model's chunk loop (models/ssm._mlstm_chunk_scan):
// lcum is the inclusive cumsum of log_f, in order within the chunk (each
// block computes its chunks' cumsums itself: lane i of one warp sums tokens
// 0..i in order, so every block has the same bits); every exponent is
// expf(clip(x, -60, 0)) (expf, never __expf), the clip applied before the
// causal select, so s > t never meets inf * 0; scores = (q.k * decay) * i_s
// for s <= t, else 0; qdec = q * exp(lcum_t); kw = k * exp(ltot - lcum_s) *
// i_s; S' = S * exp(ltot) + kw^T v, n' = n * exp(ltot) + k^T w; IEEE
// division.  Each product's 8-deep MMA steps are folded into f32 partials
// with __fadd_rn, nested per 32 columns of dh (scores, y_inter) or per
// chunk (the state update, P v), as the CUDA-core version nested its sums.
// -fmad=false is on and every other multiply-add is an explicit __fmaf_rn.
// bf16 q/k/v are cast to f32 on load.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

constexpr int THREADS = 256;  // 8 warps: 4 row tiles of 16 x 2 column halves
constexpr int CMAX = 64;      // largest chunk
constexpr int DHMAX = 512;    // largest head dim
constexpr int TILE = 64;      // dk rows / dv columns per block
constexpr int DK = 32;        // dh columns per streamed sub-tile of (b)
constexpr int LDA = CMAX / 2 + 4;  // quads per row of a 64-deep A operand
constexpr int LDB = TILE + 2;      // quads per pair row of a K-major B
constexpr int LDS = DK / 2 + 4;    // quads per row of a 32-deep operand
constexpr int LDR = DK + 1;        // floats per row of the raw qdec tile

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float clip_exp(float x) {
  return expf(fminf(fmaxf(x, -60.0f), 0.0f));
}

// The inclusive cumsum of the chunk's log forget gates, in order, by one
// warp: lane i (and i + 32) sums tokens 0..i (0..i + 32) one by one.
// `lf0`/`lf1` are the lane's gates for tokens i and i + 32 (0 past C).
// Returns lcum for both tokens and ltot (lcum of token C - 1) in all lanes.
__device__ __forceinline__ void chunk_cumsum(float lf0, float lf1, int C,
                                             int lane, float& lc0, float& lc1,
                                             float& ltot) {
  float acc = 0.0f;
  lc0 = lc1 = 0.0f;
  for (int i = 0; i < C; ++i) {
    const float x = __shfl_sync(0xffffffffu, i < 32 ? lf0 : lf1, i & 31);
    acc = i == 0 ? x : __fadd_rn(acc, x);
    if (i == lane) lc0 = acc;
    if (i == lane + 32) lc1 = acc;
  }
  ltot = acc;
}

// ---------------------------------------------------------------------------
// (a) The state walk.
// ---------------------------------------------------------------------------

constexpr size_t STATE_SMEM =
    16 * (size_t)(TILE * LDA + CMAX / 2 * LDB) +
    4 * (size_t)(CMAX * (TILE + 1) + CMAX + 1);

// The thread's share of one chunk's k (dk tile) and v (dv tile): 8 pairs of
// tokens (2p, 2p + 1) at column tid % 64, p = tid / 64 + 4u; raw k and v.
template <typename T>
__device__ __forceinline__ void load_kv_regs(const T* k, const T* v,
                                             int c0, int C, int dh, int i0,
                                             int j0, int tid, float (&kr)[16],
                                             float (&vr)[16]) {
  const int col = tid % TILE;
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const int p = tid / TILE + 4 * u;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int s = 2 * p + e;
      const size_t row = (size_t)(c0 + s) * dh;
      kr[2 * u + e] =
          s < C && i0 + col < dh ? to_f32(k[row + i0 + col]) : 0.0f;
      vr[2 * u + e] =
          s < C && j0 + col < dh ? to_f32(v[row + j0 + col]) : 0.0f;
    }
  }
}

// Block (tile, h, b), tile = dk tile * tiles + dv tile; warp w owns dk rows
// 16 (w / 2) .. + 15 and dv columns 32 (w % 2) .. + 31 of the slice.
template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
    mlstm_state_kernel(const T* __restrict__ K, const T* __restrict__ V,
                       const float* __restrict__ LF,
                       const float* __restrict__ IG,
                       float* __restrict__ states, float* __restrict__ norms,
                       int H, int S, int dh, int C) {
  extern __shared__ __align__(16) uint4 smem_s[];
  uint4* sA = smem_s;                 // [TILE dk][LDA] kw, pairs of tokens
  uint4* sB = sA + TILE * LDA;        // [CMAX / 2][LDB] v, pairs of tokens
  float* sKr = reinterpret_cast<float*>(sB + CMAX / 2 * LDB);  // [CMAX][65]
  float* sW = sKr + CMAX * (TILE + 1);  // [CMAX] exp(ltot - lcum_s) * i_s
  float* sF = sW + CMAX;                // exp(ltot)

  const int tiles = (dh + TILE - 1) / TILE;
  const int it = blockIdx.x / tiles, jt = blockIdx.x % tiles;
  const int i0 = it * TILE, j0 = jt * TILE;
  const int h = blockIdx.y, b = blockIdx.z;
  const int nc = S / C;
  const int tid = threadIdx.x, w = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4, mw = w / 2, nh = w % 2;
  const size_t bh = (size_t)b * H + h;
  const T* k = K + bh * S * dh;
  const T* v = V + bh * S * dh;
  const float* lf = LF + bh * S;
  const float* ig = IG + bh * S;
  float* st_out = states + bh * (nc - 1) * dh * dh;
  float* n_out = norms + bh * (nc - 1) * dh;

  // The slice: rows i0 + 16 mw + g (+ 8), columns j0 + 32 nh + 8 j + 2t (+1).
  float st[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) st[j][e] = 0.0f;
  float nn = 0.0f;  // n[i0 + tid] for tid < 64 in the dv-tile-0 blocks
  auto store = [&](int e) {  // the state at the start of chunk e + 1
    float* o = st_out + (size_t)e * dh * dh;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int r = i0 + 16 * mw + g + 8 * (x >> 1);
        const int c = j0 + 32 * nh + 8 * j + 2 * t + (x & 1);
        if (r < dh && c < dh) o[(size_t)r * dh + c] = st[j][x];
      }
    if (jt == 0 && tid < TILE && i0 + tid < dh)
      n_out[(size_t)e * dh + i0 + tid] = nn;
  };

  float kr[16], vr[16], lf0 = 0.0f, lf1 = 0.0f, ig0 = 0.0f, ig1 = 0.0f;
  auto prefetch = [&](int c) {
    load_kv_regs(k, v, c * C, C, dh, i0, j0, tid, kr, vr);
    if (w == 0) {
      lf0 = lane < C ? lf[c * C + lane] : 0.0f;
      lf1 = lane + 32 < C ? lf[c * C + lane + 32] : 0.0f;
      ig0 = lane < C ? ig[c * C + lane] : 0.0f;
      ig1 = lane + 32 < C ? ig[c * C + lane + 32] : 0.0f;
    }
  };
  prefetch(0);

  for (int c = 0; c + 1 < nc; ++c) {
    if (c > 0) store(c - 1);
    __syncthreads();  // the previous chunk's readers are done
    if (w == 0) {
      float lc0, lc1, ltot;
      chunk_cumsum(lf0, lf1, C, lane, lc0, lc1, ltot);
      sW[lane] = lane < C ? __fmul_rn(clip_exp(__fsub_rn(ltot, lc0)), ig0)
                          : 0.0f;
      sW[lane + 32] = lane + 32 < C
          ? __fmul_rn(clip_exp(__fsub_rn(ltot, lc1)), ig1) : 0.0f;
      if (lane == 0) *sF = clip_exp(ltot);
    }
    __syncthreads();
    const int col = tid % TILE;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int p = tid / TILE + 4 * u;
      sA[col * LDA + p] =
          tf32x3::pair_quad(__fmul_rn(kr[2 * u], sW[2 * p]),
                            __fmul_rn(kr[2 * u + 1], sW[2 * p + 1]));
      sB[p * LDB + col] = tf32x3::pair_quad(vr[2 * u], vr[2 * u + 1]);
      if (jt == 0) {
        sKr[2 * p * (TILE + 1) + col] = kr[2 * u];
        sKr[(2 * p + 1) * (TILE + 1) + col] = kr[2 * u + 1];
      }
    }
    if (c + 2 < nc) prefetch(c + 1);  // in flight during the MMAs
    __syncthreads();
    const float ftot = *sF;
    if (jt == 0 && tid < TILE) {  // n = n * exp(ltot) + k^T w
      float acc = 0.0f;
      for (int s = 0; s < C; ++s)
        acc = __fmaf_rn(sKr[s * (TILE + 1) + tid], sW[s], acc);
      nn = __fadd_rn(__fmul_rn(nn, ftot), acc);
    }
    // S = S * exp(ltot) + kw^T v over the chunk's tokens (8 steps, one
    // nested partial).
    float part[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[j][e] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < CMAX / 8; ++ks) {
      const tf32x3::FragA a =
          tf32x3::load_a(sA + 16 * mw * LDA + 4 * ks, LDA, g, t);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float d[4];
        tf32x3::step(d, a, sB[(4 * ks + t) * LDB + 32 * nh + 8 * j + g]);
        tf32x3::fold(part[j], d);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        st[j][e] = __fadd_rn(__fmul_rn(st[j][e], ftot), part[j][e]);
  }
  store(nc - 2);
}

// ---------------------------------------------------------------------------
// (b) The outputs.
// ---------------------------------------------------------------------------

// Shared memory of (b), in 16-byte units: the sub-tile operands, reused
// after the dh walk for P (over sQ, sQd) and the v tile (over sK, sS).
constexpr int OUT_Q = 0;                      // [CMAX][LDS] q
constexpr int OUT_QD = OUT_Q + CMAX * LDS;    // [CMAX][LDS] qdec
constexpr int OUT_K = OUT_QD + CMAX * LDS;    // [CMAX][LDS] k
constexpr int OUT_S = OUT_K + CMAX * LDS;     // [DK / 2][LDB] S_{c-1}
constexpr int OUT_END = OUT_S + DK / 2 * LDB;
constexpr int OUT_P = OUT_Q;                  // [CMAX][LDA] P
constexpr int OUT_V = OUT_K;                  // [CMAX / 2][LDB] v
static_assert(CMAX * LDA <= OUT_K - OUT_Q, "P fits over q and qdec");
static_assert(CMAX / 2 * LDB <= OUT_END - OUT_K, "v fits over k and S");
constexpr size_t OUT_SMEM =
    16 * (size_t)OUT_END +
    4 * (size_t)(CMAX * LDR + DK + 4 * CMAX + 2 * CMAX);

// Block (chunk * tiles + dv tile, h, b); warp w owns rows 16 (w / 2) .. + 15
// of the chunk and columns 32 (w % 2) .. + 31 -- of the (C x C) scores and
// of the y tile alike.
template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
    mlstm_out_kernel(const T* __restrict__ Q, const T* __restrict__ K,
                     const T* __restrict__ V, const float* __restrict__ LF,
                     const float* __restrict__ IG,
                     const float* __restrict__ states,
                     const float* __restrict__ norms, float* __restrict__ Y,
                     int H, int S, int dh, int C) {
  extern __shared__ __align__(16) uint4 smem_o[];
  uint4* sQ = smem_o + OUT_Q;
  uint4* sQd = smem_o + OUT_QD;
  uint4* sK = smem_o + OUT_K;
  uint4* sS = smem_o + OUT_S;
  uint4* sP = smem_o + OUT_P;
  uint4* sV = smem_o + OUT_V;
  float* sQr = reinterpret_cast<float*>(smem_o + OUT_END);  // [CMAX][LDR]
  float* sN = sQr + CMAX * LDR;   // [DK] n_{c-1} sub-tile
  float* sLc = sN + DK;           // [CMAX] lcum
  float* sEq = sLc + CMAX;        // exp(clip(lcum))
  float* sIg = sEq + CMAX;        // input gates (0 past C)
  float* sNi = sIg + CMAX;        // q . n_{c-1}
  float* sR = sNi + CMAX;         // [2][CMAX] row sums of P, per half

  const int tiles = (dh + TILE - 1) / TILE;
  const int c = blockIdx.x / tiles, j0 = blockIdx.x % tiles * TILE;
  const int h = blockIdx.y, b = blockIdx.z;
  const int nc = S / C, c0 = c * C;
  const int tid = threadIdx.x, w = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4, mw = w / 2, nh = w % 2;
  const size_t bh = (size_t)b * H + h;
  const T* q = Q + bh * S * dh;
  const T* k = K + bh * S * dh;
  const T* v = V + bh * S * dh;
  const bool inter = c > 0;  // chunk 0 starts from the zero state
  const size_t e_in = inter ? bh * (nc - 1) + c - 1 : 0;
  const float* st_in = states + e_in * dh * dh;
  const float* n_in = norms + e_in * dh;

  if (w == 0) {
    const float* lf = LF + bh * S + c0;
    const float* ig = IG + bh * S + c0;
    const float lf0 = lane < C ? lf[lane] : 0.0f;
    const float lf1 = lane + 32 < C ? lf[lane + 32] : 0.0f;
    float lc0, lc1, ltot;
    chunk_cumsum(lf0, lf1, C, lane, lc0, lc1, ltot);
    sLc[lane] = lc0;
    sLc[lane + 32] = lc1;
    sEq[lane] = clip_exp(lc0);
    sEq[lane + 32] = clip_exp(lc1);
    sIg[lane] = lane < C ? ig[lane] : 0.0f;
    sIg[lane + 32] = lane + 32 < C ? ig[lane + 32] : 0.0f;
  }

  float sc[4][4], yi[4][4];  // scores; y_inter
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[j][e] = yi[j][e] = 0.0f;
  float ninter = 0.0f;  // rows tid / 4, summed over quarters tid % 4

  for (int d0 = 0; d0 < dh; d0 += DK) {
    __syncthreads();  // the gates are set; the last sub-tile's readers done
#pragma unroll
    for (int u = 0; u < 4; ++u) {  // q, qdec, k: row r, columns 2p, 2p + 1
      const int idx = tid + THREADS * u, r = idx / (DK / 2), p = idx % 16;
      float qv[2] = {0.0f, 0.0f}, kv[2] = {0.0f, 0.0f};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = d0 + 2 * p + e;
        if (r < C && d < dh) {
          const size_t at = (size_t)(c0 + r) * dh + d;
          qv[e] = to_f32(q[at]);
          kv[e] = to_f32(k[at]);
        }
      }
      const float qd0 = __fmul_rn(qv[0], sEq[r]);
      const float qd1 = __fmul_rn(qv[1], sEq[r]);
      sQ[r * LDS + p] = tf32x3::pair_quad(qv[0], qv[1]);
      sQd[r * LDS + p] = tf32x3::pair_quad(qd0, qd1);
      sK[r * LDS + p] = tf32x3::pair_quad(kv[0], kv[1]);
      sQr[r * LDR + 2 * p] = qd0;
      sQr[r * LDR + 2 * p + 1] = qd1;
    }
    if (inter) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {  // S rows d0 + 2p, + 1; column j0 + col
        const int idx = tid + THREADS * u, p = idx / TILE, col = idx % TILE;
        float sv[2] = {0.0f, 0.0f};
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int d = d0 + 2 * p + e;
          if (d < dh && j0 + col < dh)
            sv[e] = st_in[(size_t)d * dh + j0 + col];
        }
        sS[p * LDB + col] = tf32x3::pair_quad(sv[0], sv[1]);
      }
      if (tid < DK) sN[tid] = d0 + tid < dh ? n_in[d0 + tid] : 0.0f;
    }
    __syncthreads();
    if (inter) {  // q . n over the sub-tile: quarters of 8, then the row
      const int r = tid / 4, qu = tid % 4;
      float part = 0.0f;
#pragma unroll
      for (int d = 8 * qu; d < 8 * qu + 8; ++d)
        part = __fmaf_rn(sQr[r * LDR + d], sN[d], part);
      part = __fadd_rn(part, __shfl_xor_sync(0xffffffffu, part, 1));
      part = __fadd_rn(part, __shfl_xor_sync(0xffffffffu, part, 2));
      ninter = __fadd_rn(ninter, part);
    }
    // scores and y_inter over this sub-tile, each nested: the sub-tile's
    // partial on its own, then added to the total.
    float ps[4][4], py[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) ps[j][e] = py[j][e] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < DK / 8; ++ks) {
      const tf32x3::FragA a =
          tf32x3::load_a(sQ + 16 * mw * LDS + 4 * ks, LDS, g, t);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float d[4];
        tf32x3::step(d, a, sK[(32 * nh + 8 * j + g) * LDS + 4 * ks + t]);
        tf32x3::fold(ps[j], d);
      }
      if (inter) {
        const tf32x3::FragA ad =
            tf32x3::load_a(sQd + 16 * mw * LDS + 4 * ks, LDS, g, t);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float d[4];
          tf32x3::step(d, ad, sS[(4 * ks + t) * LDB + 32 * nh + 8 * j + g]);
          tf32x3::fold(py[j], d);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      tf32x3::fold(sc[j], ps[j]);
      tf32x3::fold(yi[j], py[j]);
    }
  }

  // The v tile (tokens c0 .., columns j0 ..) into registers while P forms.
  float vr[16];
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const int p = tid / TILE + 4 * u, col = tid % TILE;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int s = 2 * p + e;
      vr[2 * u + e] = s < C && j0 + col < dh
          ? to_f32(v[(size_t)(c0 + s) * dh + j0 + col]) : 0.0f;
    }
  }
  if (tid % 4 == 0) sNi[tid / 4] = ninter;
  // Masked, decayed, gated scores; their row sums per column half.
  float rs[2] = {0.0f, 0.0f};
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int tr = 16 * mw + g + 8 * (e >> 1);
      const int s = 32 * nh + 8 * j + 2 * t + (e & 1);
      const float dec = clip_exp(__fsub_rn(sLc[tr], sLc[s]));
      sc[j][e] = tr >= s ? __fmul_rn(__fmul_rn(sc[j][e], dec), sIg[s]) : 0.0f;
      rs[e >> 1] = __fadd_rn(rs[e >> 1], sc[j][e]);
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    rs[r] = __fadd_rn(rs[r], __shfl_xor_sync(0xffffffffu, rs[r], 1));
    rs[r] = __fadd_rn(rs[r], __shfl_xor_sync(0xffffffffu, rs[r], 2));
  }
  __syncthreads();  // every warp is done with the sub-tile operands
  if (t == 0) {
    sR[nh * CMAX + 16 * mw + g] = rs[0];
    sR[nh * CMAX + 16 * mw + g + 8] = rs[1];
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int p = 16 * nh + 4 * j + t;
    sP[(16 * mw + g) * LDA + p] = tf32x3::pair_quad(sc[j][0], sc[j][1]);
    sP[(16 * mw + g + 8) * LDA + p] = tf32x3::pair_quad(sc[j][2], sc[j][3]);
  }
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const int p = tid / TILE + 4 * u;
    sV[p * LDB + tid % TILE] = tf32x3::pair_quad(vr[2 * u], vr[2 * u + 1]);
  }
  __syncthreads();
  // y_intra = P v over the chunk's tokens (8 steps, one nested partial).
  float ya[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) ya[j][e] = 0.0f;
#pragma unroll
  for (int ks = 0; ks < CMAX / 8; ++ks) {
    const tf32x3::FragA a =
        tf32x3::load_a(sP + 16 * mw * LDA + 4 * ks, LDA, g, t);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float d[4];
      tf32x3::step(d, a, sV[(4 * ks + t) * LDB + 32 * nh + 8 * j + g]);
      tf32x3::fold(ya[j], d);
    }
  }
  float* y = Y + bh * S * dh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int tr = 16 * mw + g + 8 * r;
    if (tr >= C) continue;
    // n_tok = row sum of the scores + q . n_old
    const float ntok =
        __fadd_rn(__fadd_rn(sR[tr], sR[CMAX + tr]), sNi[tr]);
    const float den = fmaxf(fabsf(ntok), 1.0f);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = j0 + 32 * nh + 8 * j + 2 * t + e;
        if (col < dh)
          y[(size_t)(c0 + tr) * dh + col] =
              __fdiv_rn(__fadd_rn(ya[j][2 * r + e], yi[j][2 * r + e]), den);
      }
  }
}

size_t scratch_floats(int B, int H, int S, int dh, int C) {
  const size_t nc = (size_t)(S / C);
  return nc > 1 ? (size_t)B * H * (nc - 1) * ((size_t)dh * dh + dh) : 0;
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* lf,
           const void* ig, void* y, void* scratch, size_t scratch_bytes,
           int B, int H, int S, int dh, int C, cudaStream_t st) {
  if (C < 1 || C > CMAX || dh < 1 || dh > DHMAX || S % C != 0)
    return (int)cudaErrorInvalidValue;
  const size_t need = scratch_floats(B, H, S, dh, C);
  if (scratch_bytes < 4 * need) return (int)cudaErrorInvalidValue;
  const int nc = S / C, tiles = (dh + TILE - 1) / TILE;
  float* states = static_cast<float*>(scratch);
  float* norms = states + (size_t)B * H * (nc > 1 ? nc - 1 : 0) * dh * dh;
  if (nc > 1) {
    auto kern = mlstm_state_kernel<T>;
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)STATE_SMEM);
    if (e != cudaSuccess) return (int)e;
    kern<<<dim3(tiles * tiles, H, B), THREADS, STATE_SMEM, st>>>(
        static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const float*>(lf), static_cast<const float*>(ig), states,
        norms, H, S, dh, C);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  auto kern = mlstm_out_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)OUT_SMEM);
  if (e != cudaSuccess) return (int)e;
  kern<<<dim3(nc * tiles, H, B), THREADS, OUT_SMEM, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(lf),
      static_cast<const float*>(ig), states, norms, static_cast<float*>(y),
      H, S, dh, C);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Bytes of the scratch the launch needs: nc - 1 chunk-start states (dh x dh
// f32) and normalizers (dh f32) per (b, h), nc = S / C; 0 for one chunk.
extern "C" size_t mlstm_chunk_scratch(int B, int H, int S, int dh, int C) {
  if (C < 1 || S % C != 0) return 0;
  return 4 * scratch_floats(B, H, S, dh, C);
}

// q/k/v (B, H, S, dh) contiguous, f32 (bf16 = 0) or bf16 (bf16 = 1);
// log_f/i_gate (B, H, S) f32; y (B, H, S, dh) f32; scratch of at least
// mlstm_chunk_scratch(...) bytes.  S % C == 0, C <= 64, dh <= 512.  Launches
// the state walk (when S > C), then the outputs; returns cudaGetLastError()
// (0 on success).
extern "C" int mlstm_chunk_launch(const void* q, const void* k, const void* v,
                                  const void* lf, const void* ig, void* y,
                                  void* scratch, size_t scratch_bytes, int B,
                                  int H, int S, int dh, int C, int bf16,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(q, k, v, lf, ig, y, scratch, scratch_bytes,
                                 B, H, S, dh, C, st);
  return launch<float>(q, k, v, lf, ig, y, scratch, scratch_bytes, B, H, S,
                       dh, C, st);
}
