// Flash attention on Hopper: online-softmax attention with GQA, causal and
// sliding-window masks and a q_offset, the output in q's dtype.  Two kernels,
// chosen by dtype alone in flash_attention_launch: f32 inputs run three TF32
// passes on mma.sync, bf16 inputs bf16 wgmma; both on the tensor cores.
//
// Replaces: src/repro/kernels/flash_attention/flash_attention.py:_attn_kernel
// (flash_attention_raw), whose grid (b, hq, sq/bq, skv/bk) ran the KV axis in
// order and carried the running max m, denominator l and the (bq, d)
// accumulator in VMEM scratch.  Blocks on the card run in no order, so here
// one thread block owns (batch, q-head, block of q rows) and walks the KV
// blocks itself, keeping m, l and the accumulator in registers.  GQA is by
// index: q-head h reads kv-head h / group; no repeated K/V exists.
//
// Arithmetic, kept as the TPU kernel's: s = (q . k) * scale, then -1e30
// where masked (not -inf), m_new = max(m, rowmax(s)), p = exp(s - m_new),
// alpha = exp(m - m_new), l = l*alpha + rowsum(p), acc = acc*alpha + p v,
// out = acc / (l == 0 ? 1 : l).  Keys at or past skv (the wrapper's padded
// length) do not exist and get -inf, which adds exactly nothing.  For a row
// with a live key, a wholly masked tile adds nothing after the first live
// one and is wiped (alpha = 0) before it, so skipping it is exact; a row
// with no live key averages every value in the reference, so a tile with
// such a row walks every KV tile.  expf (never __expf); -fmad=false is on,
// so outside the MMAs every product and sum is rounded on its own.
//
// The f32 kernel.  At the prefill shapes (sq = skv = 2048, d = 64) the work
// is 4*sq*skv*d FLOPs per head, half of it masked, ~96 FLOPs per byte of
// q/k/v/o: bound by the multiply-adds.  The 2e-5 limit rules out bf16 and
// one-pass TF32 products, but not three TF32 passes (csrc/tf32x3.cuh:
// each f32 operand split into a big and a small tf32 part, ~2^-22 of a
// product left out), which run on the tensor cores at ~2.5x the CUDA
// cores' f32 rate.  Both products are mma.sync m16n8k8 TF32 steps, each
// 8-deep step formed from zero and added to an f32 partial with __fadd_rn
// (an MMA's own sum is not round-to-nearest).  Eight warps of 16 q rows
// each (four at d = 128); the q tile is split once into shared memory; K/V
// tiles of 64 keys (32 at d = 128) come through a 2-stage cp.async ring and
// are split once per block as they land, while the next tile's copy is in
// flight.  S stays in registers; its C fragment is P's A fragment (the
// permuted K order of tf32x3.cuh), so P never leaves registers.  Blocks
// skip the KV tiles outside the live key range of their rows (the causal
// half), warps the tiles outside theirs, and the heaviest q blocks launch
// first.
//
// The bf16 kernel.  With bf16 inputs the same work is priced at the bf16
// tensor-core rate (989 TFLOP/s, ~15x the f32 CUDA-core rate), so it runs
// both products on wgmma (sm_90a): two consumer warpgroups of 64 q rows
// each per block; the q tile (bf16) lands in shared memory once; K/V tiles
// of 64 keys come through a 3-stage cp.async ring (two tiles' copies in
// flight behind this tile's math), in the no-swizzle core-matrix layout (8
// rows x 16 bytes) that wgmma's shared-memory descriptors read.
//   * S = Q K^T: wgmma m64n64k16, Q and K from shared memory (both
//     K-major), f32 accumulators.  A bf16 x bf16 product is exact in f32,
//     so only the order of the sums differs from the plain version.
//   * Mask and online softmax in registers, in f32, as above.
//   * O += P V: wgmma m64n{d}k16 with P from registers and V from shared
//     memory (MN-major).  The reference keeps p in f32; here p is split
//     into two bf16 limbs, hi = bf16(p) and lo = bf16(p - hi), and both are
//     multiplied (P_hi V + P_lo V): v is bf16 and exact, so the products
//     keep ~16 bits of p, for one extra product per tile.
// Skipping and tile order are the f32 kernel's (tiles of 64 keys).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

constexpr float NEG = -1e30f;

// The KV tiles of bkv keys that q rows q0..q0+bq-1 walk, [begin, end): the
// union of the rows' live key ranges, or every tile when one row has no
// live key (see the note at the top).
__device__ __forceinline__ void kv_tiles(int q0, int bq, int sq, int skv,
                                         int causal, int has_window,
                                         int window, int q_offset, int bkv,
                                         int& begin, int& end) {
  long long lo_all = (long long)skv, hi_all = -1;
  bool any_empty = false;
  for (int r = 0; r < bq && q0 + r < sq; ++r) {
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
  const int n_kt = (skv + bkv - 1) / bkv;
  begin = any_empty ? 0 : (int)(lo_all / bkv);
  end = any_empty ? n_kt : (int)(hi_all / bkv) + 1;
}

// ---------------------------------------------------------------------------
// The bf16 tensor-core kernel (see the note at the top).
// ---------------------------------------------------------------------------

namespace tc {

constexpr int BQ = 128;       // q rows per block: two warpgroups of 64
constexpr int BKV = 64;       // keys per KV tile
constexpr int THREADS = 256;
constexpr int STAGES = 3;     // K/V ring depth: 2 tiles in flight

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));  // 0: zero-fill
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Generic-proxy shared-memory writes (cp.async) made visible to wgmma.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps registers that an in-flight wgmma reads or writes from being
// touched (or reused) by the compiler across the wait.
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// Shared-memory matrix descriptor without swizzle: start address, LBO (the
// byte step between core matrices along K) and SBO (along M or N), each in
// 16-byte units.
__device__ __forceinline__ uint64_t make_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) |
         ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32);
}

// A (rows x DH) bf16 tile in shared memory: groups of 8 rows, DH * 16
// bytes each, as DH / 8 core matrices of 8 rows x 8 columns (128 bytes).
// Byte offset of the 16-byte chunk (row, columns 8c..8c+7).
template <int DH>
__device__ __forceinline__ int tile_offset(int row, int c) {
  return (row >> 3) * (DH * 16) + c * 128 + (row & 7) * 16;
}

// Rows 0..rows-1 of a contiguous (., DH) bf16 matrix at src into a tile;
// rows at or past `valid` are zero-filled (never read from memory).
template <int DH>
__device__ __forceinline__ void load_tile(char* dst, const __nv_bfloat16* src,
                                          int rows, int valid, int tid) {
  constexpr int CPR = DH / 8;  // 16-byte chunks per row
  for (int idx = tid; idx < rows * CPR; idx += THREADS) {
    const int row = idx / CPR, c = idx % CPR;
    const bool ok = row < valid;
    cp_async16(dst + tile_offset<DH>(row, c),
               ok ? src + (size_t)row * DH + 8 * c : src, ok);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo_col, float hi_col) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo_col, hi_col);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// D (64 x 64, f32) [+]= A (64 x 16, shared) * B (16 x 64, shared), both
// K-major; scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 16, f32) += A (64 x 16, registers) * B (16 x 16, shared,
// MN-major).
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 32, f32) += A (64 x 16, registers) * B (16 x 32, shared,
// MN-major).
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 64, f32) += A (64 x 16, registers) * B (16 x 64, shared,
// MN-major).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128, f32) += A (64 x 16, registers) * B (16 x 128, shared,
// MN-major).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


template <int DH>
__device__ __forceinline__ void wgmma_pv(float (&d)[DH / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (DH == 16) wgmma_rs_n16(d, a, db);
  if constexpr (DH == 32) wgmma_rs_n32(d, a, db);
  if constexpr (DH == 64) wgmma_rs_n64(d, a, db);
  if constexpr (DH == 128) wgmma_rs_n128(d, a, db);
}

template <int DH>
constexpr size_t smem_bytes() {
  return 2 * (size_t)(BQ * DH + 2 * STAGES * BKV * DH);
}

// Thread layout: warpgroup wg (rows 64*wg..), warp w of it (16 rows), lane
// = 4*g + t.  An m64nN accumulator gives the thread rows 16w + g and
// 16w + g + 8, and in each 8-column chunk i the columns 8i + 2t, 8i + 2t + 1
// (registers 4i, 4i+1 for the first row, 4i+2, 4i+3 for the second).
template <int DH>
__global__ void __launch_bounds__(THREADS)
    flash_attention_tc_kernel(const __nv_bfloat16* __restrict__ Q,
                              const __nv_bfloat16* __restrict__ K,
                              const __nv_bfloat16* __restrict__ V,
                              __nv_bfloat16* __restrict__ O, int hq, int hkv,
                              int sq, int skv, int causal, int has_window,
                              int window, int q_offset, float scale) {
  constexpr int TILE = BKV * DH * 2;     // bytes of one K or V tile
  constexpr uint32_t ROWS8 = DH * 16;    // bytes of 8 tile rows
  extern __shared__ __align__(128) char smem[];
  char* sQ = smem;
  char* sK = sQ + BQ * DH * 2;
  char* sV = sK + STAGES * TILE;

  const int n_qt = (sq + BQ - 1) / BQ;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * BQ;  // latest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int tid = threadIdx.x, wg = tid / 128, w = (tid % 128) / 32;
  const int g = (tid % 32) / 4, t = tid % 4;
  const __nv_bfloat16* qb = Q + ((size_t)(b * hq + h) * sq) * DH;
  const __nv_bfloat16* kb = K + ((size_t)(b * hkv + hk) * skv) * DH;
  const __nv_bfloat16* vb = V + ((size_t)(b * hkv + hk) * skv) * DH;

  int kt_begin, kt_end;
  kv_tiles(q0, BQ, sq, skv, causal, has_window, window, q_offset, BKV,
           kt_begin, kt_end);
  // Tile kt (the it-th walked) lives in stage it % STAGES; each load is
  // its own cp.async group, the q tile rides with the first.
  auto load_kv = [&](int kt) {
    if (kt < kt_end) {
      const int k0 = kt * BKV, stage = (kt - kt_begin) % STAGES;
      load_tile<DH>(sK + stage * TILE, kb + (size_t)k0 * DH, BKV, skv - k0,
                    tid);
      load_tile<DH>(sV + stage * TILE, vb + (size_t)k0 * DH, BKV, skv - k0,
                    tid);
    }
    cp_async_commit();  // an empty group past the end keeps the count even
  };
  load_tile<DH>(sQ, qb + (size_t)q0 * DH, BQ, sq - q0, tid);
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) load_kv(kt_begin + i);

  const int row0 = 64 * wg + 16 * w + g;  // and row0 + 8
  // Each of the thread's two rows: its live keys lo..hi (hi < lo: none),
  // clamped to [-1, skv] so that the per-key tests are 32-bit.
  int live_lo[2], live_hi[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long p = (long long)q0 + row0 + 8 * r + q_offset;
    const long long hi = causal ? (p < skv - 1 ? p : skv - 1) : skv - 1;
    const long long lo = has_window ? p - window + 1 : 0;
    live_hi[r] = (int)(hi < -1 ? -1 : hi);
    live_lo[r] = (int)(lo < 0 ? 0 : lo > skv ? skv : lo);
  }
  const uint64_t dq = make_desc(sQ + wg * 8 * ROWS8, 128, ROWS8);
  float m[2] = {NEG, NEG}, l[2] = {0.0f, 0.0f};
  float acc[DH / 2], s[BKV / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < BKV / 2; ++i) s[i] = 0.0f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int stage = (kt - kt_begin) % STAGES;
    cp_async_wait<STAGES - 2>();  // this thread's copies of tile kt landed
    fence_proxy_async();
    __syncthreads();  // everyone's have; everyone is done with tile kt - 1
    load_kv(kt + STAGES - 1);     // into tile kt - 1's stage

    // S = Q K^T, both from shared memory.
    const uint64_t dk = make_desc(sK + stage * TILE, 128, ROWS8);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      wgmma_ss_n64(s, dq + 16 * kk, dk + 16 * kk, kk);  // +256 bytes a step
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(s);

    // Mask, online softmax (a row's 4 threads are adjacent lanes).  A tile
    // wholly inside both rows' live keys (most tiles) needs no test.
    const int k0 = kt * BKV;
    float mx[2] = {-INFINITY, -INFINITY};
    if (k0 >= live_lo[0] && k0 >= live_lo[1] && k0 + BKV - 1 <= live_hi[0] &&
        k0 + BKV - 1 <= live_hi[1]) {
#pragma unroll
      for (int i = 0; i < BKV / 2; ++i) {
        s[i] = __fmul_rn(s[i], scale);
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < BKV / 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int kp = k0 + 8 * i + 2 * t + (j & 1), r = j >> 1;
          const float v =
              kp >= skv ? -INFINITY  // no such key
              : kp >= live_lo[r] && kp <= live_hi[r]
                  ? __fmul_rn(s[4 * i + j], scale)
                  : NEG;
          s[4 * i + j] = v;
          mx[r] = fmaxf(mx[r], v);
        }
    }
    float m_new[2], sum[2] = {0.0f, 0.0f}, alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      m_new[r] = fmaxf(m[r], mx[r]);
    }
    uint32_t ph[BKV / 16][4], pl[BKV / 16][4];
#pragma unroll
    for (int i = 0; i < BKV / 8; ++i) {
      float p[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[j] = expf(__fsub_rn(s[4 * i + j], m_new[j >> 1]));
        sum[j >> 1] = __fadd_rn(sum[j >> 1], p[j]);
      }
      // chunk i is k-step i/2, its first (i even) or second 8 keys; each
      // register pair is one row's two neighbouring keys.
      const int kk = i / 2, half = 2 * (i % 2);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const uint32_t hi = pack_bf16(p[2 * r], p[2 * r + 1]);
        ph[kk][half + r] = hi;
        pl[kk][half + r] =  // p - hi is exact in f32
            pack_bf16(__fsub_rn(p[2 * r], __uint_as_float(hi << 16)),
                      __fsub_rn(p[2 * r + 1],
                                __uint_as_float(hi & 0xffff0000u)));
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] = __fadd_rn(sum[r], __shfl_xor_sync(0xffffffffu, sum[r], 1));
      sum[r] = __fadd_rn(sum[r], __shfl_xor_sync(0xffffffffu, sum[r], 2));
      alpha[r] = expf(__fsub_rn(m[r], m_new[r]));
      l[r] = __fadd_rn(__fmul_rn(l[r], alpha[r]), sum[r]);
      m[r] = m_new[r];
    }
#pragma unroll
    for (int i = 0; i < DH / 8; ++i) {
      acc[4 * i] = __fmul_rn(acc[4 * i], alpha[0]);
      acc[4 * i + 1] = __fmul_rn(acc[4 * i + 1], alpha[0]);
      acc[4 * i + 2] = __fmul_rn(acc[4 * i + 2], alpha[1]);
      acc[4 * i + 3] = __fmul_rn(acc[4 * i + 3], alpha[1]);
    }

    // O += P_hi V + P_lo V, P from registers, V (MN-major) from shared
    // memory: a k-step is 16 keys, two 8-key groups of ROWS8 bytes.
    const char* v_s = sV + stage * TILE;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk)
      wgmma_pv<DH>(acc, ph[kk], make_desc(v_s + kk * 2 * ROWS8, ROWS8, 128));
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk)
      wgmma_pv<DH>(acc, pl[kk], make_desc(v_s + kk * 2 * ROWS8, ROWS8, 128));
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(acc);
    reg_fence(ph);
    reg_fence(pl);
  }

  __nv_bfloat16* ob = O + ((size_t)(b * hq + h) * sq) * DH;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + row0 + 8 * r;
    if (row >= sq) continue;
    const float den = l[r] == 0.0f ? 1.0f : l[r];
#pragma unroll
    for (int i = 0; i < DH / 8; ++i)
      *reinterpret_cast<uint32_t*>(ob + (size_t)row * DH + 8 * i + 2 * t) =
          pack_bf16(__fdiv_rn(acc[4 * i + 2 * r], den),
                    __fdiv_rn(acc[4 * i + 2 * r + 1], den));
  }
}

template <int DH>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int hq, int hkv, int sq, int skv, int causal, int has_window,
           int window, int q_offset, float scale, cudaStream_t st) {
  constexpr size_t bytes = smem_bytes<DH>();
  auto kern = flash_attention_tc_kernel<DH>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((sq + BQ - 1) / BQ, hq, b);
  kern<<<grid, THREADS, bytes, st>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      hq, hkv, sq, skv, causal, has_window, window, q_offset, scale);
  return (int)cudaGetLastError();
}

int launch_dh(int dh, const void* q, const void* k, const void* v, void* o,
              int b, int hq, int hkv, int sq, int skv, int causal,
              int has_window, int window, int q_offset, float scale,
              cudaStream_t st) {
  switch (dh) {
    case 16:
      return launch<16>(q, k, v, o, b, hq, hkv, sq, skv, causal, has_window,
                        window, q_offset, scale, st);
    case 32:
      return launch<32>(q, k, v, o, b, hq, hkv, sq, skv, causal, has_window,
                        window, q_offset, scale, st);
    case 64:
      return launch<64>(q, k, v, o, b, hq, hkv, sq, skv, causal, has_window,
                        window, q_offset, scale, st);
    case 128:
      return launch<128>(q, k, v, o, b, hq, hkv, sq, skv, causal, has_window,
                         window, q_offset, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace tc

// ---------------------------------------------------------------------------
// The f32 kernel: three TF32 passes on mma.sync (see the note at the top).
// ---------------------------------------------------------------------------

namespace f32 {

template <int DH>
struct Cfg {
  static constexpr int BQ = DH == 128 ? 64 : 128;   // q rows per block
  static constexpr int BKV = DH == 128 ? 32 : 64;   // keys per KV tile
  static constexpr int WARPS = BQ / 16;             // 16 q rows per warp
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int STAGES = 2;                  // raw K/V ring
  static constexpr int LDQ = DH / 2 + 4;  // quads per Q or K row, == 4 mod 8
  static constexpr int LDV = DH + 2;      // quads per V pair row, == 2 mod 8
  static constexpr int RAW = BKV * DH;    // floats of one raw K or V tile
  static constexpr size_t smem =
      16 * (size_t)(BQ * LDQ + BKV * LDQ + BKV / 2 * LDV) +
      4 * (size_t)(STAGES * 2 * RAW);
};

// Warp w owns q rows 16w .. 16w + 15 of the block; lane = 4g + t holds rows
// 16w + g and 16w + g + 8 of every C fragment (columns 2t, 2t + 1 of each
// 8-column n-tile).
template <int DH>
__global__ void __launch_bounds__(Cfg<DH>::THREADS, 1)
    flash_attention_f32_kernel(const float* __restrict__ Q,
                               const float* __restrict__ K,
                               const float* __restrict__ V,
                               float* __restrict__ O, int hq, int hkv,
                               int sq, int skv, int causal, int has_window,
                               int window, int q_offset, float scale) {
  using C = Cfg<DH>;
  constexpr int BQ = C::BQ, BKV = C::BKV, LDQ = C::LDQ, LDV = C::LDV;
  constexpr int PV_N = DH / 8 < 8 ? DH / 8 : 8;  // P V chains in flight
  extern __shared__ __align__(16) uint4 smem_q[];
  uint4* sQ = smem_q;            // [BQ][LDQ] pair quads along d
  uint4* sK = sQ + BQ * LDQ;     // [BKV][LDQ] pair quads along d
  uint4* sV = sK + BKV * LDQ;    // [BKV / 2][LDV] key-pair quads
  float* raw = reinterpret_cast<float*>(sV + BKV / 2 * LDV);  // the ring

  const int n_qt = (sq + BQ - 1) / BQ;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * BQ;  // latest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int tid = threadIdx.x, w = tid / 32, g = (tid % 32) / 4, t = tid % 4;
  const float* qb = Q + ((size_t)(b * hq + h) * sq) * DH;
  const float* kb = K + ((size_t)(b * hkv + hk) * skv) * DH;
  const float* vb = V + ((size_t)(b * hkv + hk) * skv) * DH;

  int kt_begin, kt_end;
  kv_tiles(q0, BQ, sq, skv, causal, has_window, window, q_offset, BKV,
           kt_begin, kt_end);
  // Tile kt's raw K and V land in stage (kt - kt_begin) % STAGES; each load
  // is one cp.async group.
  auto load_kv = [&](int kt) {
    if (kt < kt_end) {
      const int k0 = kt * BKV;
      float* rk = raw + (kt - kt_begin) % C::STAGES * 2 * C::RAW;
      float* rv = rk + C::RAW;
      for (int idx = tid; idx < BKV * DH / 4; idx += C::THREADS) {
        const int row = idx / (DH / 4), c = idx % (DH / 4);
        const bool ok = k0 + row < skv;
        const size_t src = ok ? (size_t)(k0 + row) * DH + 4 * c : 0;
        tc::cp_async16(rk + row * DH + 4 * c, kb + src, ok);
        tc::cp_async16(rv + row * DH + 4 * c, vb + src, ok);
      }
    }
    tc::cp_async_commit();  // an empty group past the end keeps the count
  };
  load_kv(kt_begin);
  for (int idx = tid; idx < BQ * DH / 2; idx += C::THREADS) {
    const int r = idx / (DH / 2), p = idx % (DH / 2);
    float2 x = make_float2(0.0f, 0.0f);
    if (q0 + r < sq)
      x = *reinterpret_cast<const float2*>(qb + (size_t)(q0 + r) * DH + 2 * p);
    sQ[r * LDQ + p] = tf32x3::pair_quad(x.x, x.y);
  }

  const int row0 = 16 * w + g;  // and row0 + 8
  // Each of the thread's two rows: its live keys lo..hi (hi < lo: none),
  // clamped to [-1, skv] so that the per-key tests are 32-bit.
  int live_lo[2], live_hi[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long p = (long long)q0 + row0 + 8 * r + q_offset;
    const long long hi = causal ? (p < skv - 1 ? p : skv - 1) : skv - 1;
    const long long lo = has_window ? p - window + 1 : 0;
    live_hi[r] = (int)(hi < -1 ? -1 : hi);
    live_lo[r] = (int)(lo < 0 ? 0 : lo > skv ? skv : lo);
  }
  float m[2] = {NEG, NEG}, l[2] = {0.0f, 0.0f};
  float acc[DH / 8][4];
#pragma unroll
  for (int i = 0; i < DH / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BKV;
    const float* rk = raw + (kt - kt_begin) % C::STAGES * 2 * C::RAW;
    const float* rv = rk + C::RAW;
    tc::cp_async_wait<0>();  // this thread's copies of tile kt landed
    __syncthreads();  // everyone's have; everyone is done with tile kt - 1
    load_kv(kt + 1);  // into tile kt - 1's stage, converted already
    for (int idx = tid; idx < BKV * DH / 2; idx += C::THREADS) {
      const int j = idx / (DH / 2), p = idx % (DH / 2);
      const float2 x = *reinterpret_cast<const float2*>(rk + j * DH + 2 * p);
      sK[j * LDQ + p] = tf32x3::pair_quad(x.x, x.y);
    }
    for (int idx = tid; idx < BKV / 2 * DH; idx += C::THREADS) {
      const int r = idx / DH, d = idx % DH;
      sV[r * LDV + d] =
          tf32x3::pair_quad(rv[2 * r * DH + d], rv[(2 * r + 1) * DH + d]);
    }
    __syncthreads();

    // A tile outside the live keys of all 16 rows of the warp, every one of
    // which has a live key, changes nothing (see the note at the top).
    bool dead = true;
#pragma unroll
    for (int r = 0; r < 2; ++r)
      dead = dead && live_lo[r] <= live_hi[r] &&
             (k0 > live_hi[r] || k0 + BKV - 1 < live_lo[r]);
    if (__all_sync(0xffffffffu, dead)) continue;

    // S = Q K^T: per 8-deep step of d, three passes from zero, folded.
    float s[BKV / 8][4];
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll 1
    for (int ks = 0; ks < DH / 8; ++ks) {
      const tf32x3::FragA a = tf32x3::load_a(sQ + 16 * w * LDQ + 4 * ks, LDQ,
                                             g, t);
      uint4 bq[BKV / 8];
#pragma unroll
      for (int j = 0; j < BKV / 8; ++j)
        bq[j] = sK[(8 * j + g) * LDQ + 4 * ks + t];
      float d[BKV / 8][4];
      tf32x3::steps(d, a, bq);
#pragma unroll
      for (int j = 0; j < BKV / 8; ++j) tf32x3::fold(s[j], d[j]);
    }

    // Mask, online softmax (a row's 4 threads are adjacent lanes).  A tile
    // wholly inside both rows' live keys (most tiles) needs no test.
    float mx[2] = {-INFINITY, -INFINITY};
    if (k0 >= live_lo[0] && k0 >= live_lo[1] && k0 + BKV - 1 <= live_hi[0] &&
        k0 + BKV - 1 <= live_hi[1]) {
#pragma unroll
      for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = __fmul_rn(s[j][e], scale);
          mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
        }
    } else {
#pragma unroll
      for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = k0 + 8 * j + 2 * t + (e & 1), r = e >> 1;
          const float v =
              kp >= skv ? -INFINITY  // no such key
              : kp >= live_lo[r] && kp <= live_hi[r]
                  ? __fmul_rn(s[j][e], scale)
                  : NEG;
          s[j][e] = v;
          mx[r] = fmaxf(mx[r], v);
        }
    }
    float m_new[2], sum[2] = {0.0f, 0.0f}, alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      m_new[r] = fmaxf(m[r], mx[r]);
    }
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = expf(__fsub_rn(s[j][e], m_new[e >> 1]));  // p
        sum[e >> 1] = __fadd_rn(sum[e >> 1], s[j][e]);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] = __fadd_rn(sum[r], __shfl_xor_sync(0xffffffffu, sum[r], 1));
      sum[r] = __fadd_rn(sum[r], __shfl_xor_sync(0xffffffffu, sum[r], 2));
      alpha[r] = expf(__fsub_rn(m[r], m_new[r]));
      l[r] = __fadd_rn(__fmul_rn(l[r], alpha[r]), sum[r]);
      m[r] = m_new[r];
    }
#pragma unroll
    for (int i = 0; i < DH / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[i][e] = __fmul_rn(acc[i][e], alpha[e >> 1]);

    // acc += P V: per 8 keys (S's n-tile j, already P's A fragment), three
    // passes from zero, folded.
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j) {
      const tf32x3::FragA a = tf32x3::frag_from_c(s[j]);
#pragma unroll
      for (int i0 = 0; i0 < DH / 8; i0 += PV_N) {
        uint4 bq[PV_N];
#pragma unroll
        for (int i = 0; i < PV_N; ++i)
          bq[i] = sV[(4 * j + t) * LDV + 8 * (i0 + i) + g];
        float d[PV_N][4];
        tf32x3::steps(d, a, bq);
#pragma unroll
        for (int i = 0; i < PV_N; ++i) tf32x3::fold(acc[i0 + i], d[i]);
      }
    }
  }

  float* ob = O + ((size_t)(b * hq + h) * sq) * DH;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + row0 + 8 * r;
    if (row >= sq) continue;
    const float den = l[r] == 0.0f ? 1.0f : l[r];
#pragma unroll
    for (int i = 0; i < DH / 8; ++i)
      *reinterpret_cast<float2*>(ob + (size_t)row * DH + 8 * i + 2 * t) =
          make_float2(__fdiv_rn(acc[i][2 * r], den),
                      __fdiv_rn(acc[i][2 * r + 1], den));
  }
}

template <int DH>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int hq, int hkv, int sq, int skv, int causal, int has_window,
           int window, int q_offset, float scale, cudaStream_t st) {
  using C = Cfg<DH>;
  auto kern = flash_attention_f32_kernel<DH>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((sq + C::BQ - 1) / C::BQ, hq, b);
  kern<<<grid, C::THREADS, C::smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), hq, hkv, sq, skv,
      causal, has_window, window, q_offset, scale);
  return (int)cudaGetLastError();
}

int launch_dh(int dh, const void* q, const void* k, const void* v, void* o,
              int b, int hq, int hkv, int sq, int skv, int causal,
              int has_window, int window, int q_offset, float scale,
              cudaStream_t st) {
  switch (dh) {
    case 16:
      return launch<16>(q, k, v, o, b, hq, hkv, sq, skv, causal, has_window,
                        window, q_offset, scale, st);
    case 32:
      return launch<32>(q, k, v, o, b, hq, hkv, sq, skv, causal, has_window,
                        window, q_offset, scale, st);
    case 64:
      return launch<64>(q, k, v, o, b, hq, hkv, sq, skv, causal, has_window,
                        window, q_offset, scale, st);
    case 128:
      return launch<128>(q, k, v, o, b, hq, hkv, sq, skv, causal, has_window,
                         window, q_offset, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace f32

// Probes of the three-pass arithmetic (repro_torch/analysis/tf32_probe.py):
// the split as the kernels split each value, and the rate of TF32 mma.sync
// with `CH` independent accumulator chains per warp.
__global__ void tf32_split_probe_kernel(const float* __restrict__ x,
                                        uint32_t* __restrict__ big,
                                        uint32_t* __restrict__ small, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    big[i] = tf32x3::to_tf32(x[i]);
    small[i] = tf32x3::to_tf32(__fsub_rn(x[i], __uint_as_float(big[i])));
  }
}

template <int CH>
__global__ void tf32_mma_rate_kernel(float* __restrict__ out, int iters) {
  float d[CH][4];
#pragma unroll
  for (int c = 0; c < CH; ++c) d[c][0] = d[c][1] = d[c][2] = d[c][3] = 0.0f;
  const uint32_t a[4] = {threadIdx.x, 2u, 3u, 4u};
  for (int i = 0; i < iters; ++i)
#pragma unroll
    for (int c = 0; c < CH; ++c) tf32x3::mma(d[c], a, (uint32_t)(i + c), 7u);
  float sum = 0.0f;
#pragma unroll
  for (int c = 0; c < CH; ++c)
    sum = __fadd_rn(sum, __fadd_rn(__fadd_rn(d[c][0], d[c][1]),
                                   __fadd_rn(d[c][2], d[c][3])));
  out[blockIdx.x * blockDim.x + threadIdx.x] = sum;
}

}  // namespace

extern "C" int tf32_split_probe_launch(const void* x, void* big, void* small,
                                       int n, void* stream) {
  if (n > 0)
    tf32_split_probe_kernel<<<(n + 255) / 256, 256, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<uint32_t*>(big),
        static_cast<uint32_t*>(small), n);
  return (int)cudaGetLastError();
}

// `blocks` blocks of `threads` threads, each warp running `iters` rounds of
// `chains` (4 or 8) independent m16n8k8 TF32 MMAs.
extern "C" int tf32_mma_rate_launch(void* out, int blocks, int threads,
                                    int iters, int chains, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (chains == 4)
    tf32_mma_rate_kernel<4><<<blocks, threads, 0, st>>>(o, iters);
  else if (chains == 8)
    tf32_mma_rate_kernel<8><<<blocks, threads, 0, st>>>(o, iters);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q (b, hq, sq, dh), k/v (b, hkv, skv, dh) -- skv is the padded key count --
// and o (b, hq, sq, dh), all contiguous, f32 (bf16 = 0: the f32 kernel) or
// bf16 (bf16 = 1: the wgmma kernel).  Returns cudaGetLastError() after
// the launch (0 on success).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int b, int hq,
                                      int hkv, int sq, int skv, int dh,
                                      int causal, int has_window, int window,
                                      int q_offset, int bf16, float scale,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return tc::launch_dh(dh, q, k, v, o, b, hq, hkv, sq, skv, causal,
                         has_window, window, q_offset, scale, st);
  return f32::launch_dh(dh, q, k, v, o, b, hq, hkv, sq, skv, causal,
                        has_window, window, q_offset, scale, st);
}
