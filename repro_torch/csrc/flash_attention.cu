// Flash attention on Hopper: online-softmax attention with GQA, causal and
// sliding-window masks and a q_offset, the output in q's dtype.  Chosen in
// flash_attention_launch by dtype and head dim: f32 inputs run three TF32
// passes on mma.sync, bf16 inputs bf16 wgmma (a warp-specialized TMA kernel
// at d = 128); all on the tensor cores.
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
// each; the q tile is split once into shared memory; K/V tiles of 64 keys
// (32 at d = 128) are split once per block as they land, while the next
// tile's copy is in flight: through a 2-stage cp.async ring, or at d = 128,
// where the 128-row split q tile leaves no room for the ring, through
// registers (each thread's share of the next tile loaded before this
// tile's math; one block of 8 warps an SM, where the ring held it to 4).
// At d = 256 a thread's accumulator alone is 128 registers and a 128-row
// split q tile 264 KB: blocks of 64 q rows (4 warps) walk 16-key tiles,
// each loaded and split right before its math (no copy in flight: 197 KB
// of shared memory, one block an SM).
// S stays in registers; its C fragment is P's A fragment (the permuted K
// order of tf32x3.cuh), so P never leaves registers.  Blocks skip the KV
// tiles outside the live key range of their rows (the causal half), warps
// the tiles outside theirs, and the heaviest q blocks launch first.
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
// Skipping and tile order are the f32 kernel's (tiles of 64 keys).  At
// d = 256 the (64 x 256) f32 accumulator takes 128 registers a thread, so
// the KV tiles hold 32 keys (S and its two P limbs 32 more registers) and
// three stages of them take 160 KB of shared memory beside the q tile;
// P V is two m64n128k16 products a limb, one for each half of d.
//
// The bf16 kernel at d = 128 (ws::).  The same arithmetic on 128-key tiles:
// S is m64n128k16 over 8 k-steps, P V m64n128k16 over 8 k-steps per limb.
// What bounds it is the bf16 tensor-core work, 1.5x the roofline's count
// (P V twice, for the two limbs) plus the diagonal tiles' masked half, with
// the softmax and limb packing on the CUDA cores (expf, two bf16 packs per
// pair of p) close behind.  At d = 128 the tc kernel's tiles take 128 KB,
// one block an SM, and each block ran its S, softmax and P V in turn, so
// the tensor cores idled through every softmax.  Here the work of an SM is
// split by role:
//   * one producer warp (a whole warpgroup, its registers given up with
//     setmaxnreg) issues TMA copies: the q tile and K/V tiles into a
//     2-stage ring of full/empty mbarriers, each tile two 128-row x
//     64-column boxes in the 128-byte swizzle that wgmma's swizzled
//     descriptors read (Q, K K-major; V MN-major);
//   * two consumer warpgroups of 64 q rows (232 registers each) take turns
//     on the tensor cores, ordered by named barriers: a turn issues P V of
//     the last tile and then S of this one and hands over, so one
//     warpgroup's softmax runs while the other's products do.  A second S
//     in flight inside one warpgroup would need acc + S + P + S' registers,
//     more than 232, so the overlap is between the warpgroups;
//   * one persistent block an SM walks the (q block, batch, head) items,
//     heaviest q blocks first; the ring and the turns run on across items.
#include <cuda.h>  // CUtensorMap; the encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

constexpr float NEG = -1e30f;

// The KV tiles of bkv keys that q rows q0..q0+bq-1 walk, [begin, end): the
// union of the rows' live key ranges, or every tile when one row has no
// live key (see the note at the top).  A row's live keys lo(p)..hi(p), p
// its position, both grow with p, and the rows with none (lo > hi) are a
// prefix (causal, p < 0) and a suffix (p past skv + window - 2), so the
// first and the last row decide: the union is lo(first)..hi(last).
__device__ __forceinline__ void kv_tiles(int q0, int bq, int sq, int skv,
                                         int causal, int has_window,
                                         int window, int q_offset, int bkv,
                                         int& begin, int& end) {
  long long lo[2], hi[2];
  const int last = (sq - q0 < bq ? sq - q0 : bq) - 1;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const long long p = (long long)q0 + (e ? last : 0) + q_offset;
    hi[e] = causal ? (p < skv - 1 ? p : skv - 1) : skv - 1;
    lo[e] = has_window ? p - window + 1 : 0;
    if (lo[e] < 0) lo[e] = 0;
  }
  const bool any_empty = lo[0] > hi[0] || lo[1] > hi[1];
  const int n_kt = (skv + bkv - 1) / bkv;
  begin = any_empty ? 0 : (int)(lo[0] / bkv);
  end = any_empty ? n_kt : (int)(hi[1] / bkv) + 1;
}

// ---------------------------------------------------------------------------
// The bf16 tensor-core kernel (see the note at the top).
// ---------------------------------------------------------------------------

namespace tc {

constexpr int BQ = 128;       // q rows per block: two warpgroups of 64
constexpr int THREADS = 256;
constexpr int STAGES = 3;     // K/V ring depth: 2 tiles in flight

// Keys per KV tile: 64, or 32 at dh 256 (see the note at the top).
template <int DH>
constexpr int BKV_OF = DH == 256 ? 32 : 64;

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

// D (64 x 32, f32) [+]= A (64 x 16, shared) * B (16 x 32, shared), both
// K-major; scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

// S (64 x NK) [+]= Q (64 x 16) K^T (16 x NK), both from shared memory.
template <int NK>
__device__ __forceinline__ void wgmma_qk(float (&d)[NK / 2], uint64_t da,
                                         uint64_t db, int scale_d) {
  if constexpr (NK == 32) wgmma_ss_n32(d, da, db, scale_d);
  if constexpr (NK == 64) wgmma_ss_n64(d, da, db, scale_d);
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
  if constexpr (DH == 256) {
    // columns 0..127 are accumulator registers 0..63, columns 128..255
    // registers 64..127; the second half of V starts 16 core matrices
    // (2048 bytes) on along N
    wgmma_rs_n128(*reinterpret_cast<float(*)[64]>(d), a, db);
    wgmma_rs_n128(*reinterpret_cast<float(*)[64]>(d + 64), a,
                  db + (2048 >> 4));
  }
}

// One KV tile of NK keys (from key k0) for the thread's two q rows, after
// S landed in s (the m64nNK accumulator): mask, online softmax (a row's 4
// threads are adjacent lanes), P split into two bf16 limbs as P V's A
// fragments (chunk i of 8 keys is k-step i / 2, its first or second half;
// each register pair is one row's two neighbouring keys), and acc
// rescaled.  A tile wholly inside both rows' live keys (most tiles) needs
// no test.
template <int NK, int DH>
__device__ __forceinline__ void softmax_tile(
    float (&s)[NK / 2], float (&acc)[DH / 2], float (&m)[2], float (&l)[2],
    uint32_t (&ph)[NK / 16][4], uint32_t (&pl)[NK / 16][4], int k0,
    const int (&live_lo)[2], const int (&live_hi)[2], int skv, float scale,
    int t) {
  float mx[2] = {-INFINITY, -INFINITY};
  if (k0 >= live_lo[0] && k0 >= live_lo[1] && k0 + NK - 1 <= live_hi[0] &&
      k0 + NK - 1 <= live_hi[1]) {
#pragma unroll
    for (int i = 0; i < NK / 2; ++i) {
      s[i] = __fmul_rn(s[i], scale);
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < NK / 8; ++i)
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
#pragma unroll
  for (int i = 0; i < NK / 8; ++i) {
    float p[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      p[j] = expf(__fsub_rn(s[4 * i + j], m_new[j >> 1]));
      sum[j >> 1] = __fadd_rn(sum[j >> 1], p[j]);
    }
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
}

// The thread's two q rows (row0, row0 + 8 of the block at q0) of out = acc
// / (l == 0 ? 1 : l), as bf16, into the head's rows at ob.
template <int DH>
__device__ __forceinline__ void store_rows(__nv_bfloat16* ob,
                                           const float (&acc)[DH / 2],
                                           const float (&l)[2], int q0,
                                           int row0, int sq, int t) {
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
constexpr size_t smem_bytes() {
  return 2 * (size_t)(BQ * DH + 2 * STAGES * BKV_OF<DH> * DH);
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
  constexpr int BKV = BKV_OF<DH>;
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
      wgmma_qk<BKV>(s, dq + 16 * kk, dk + 16 * kk, kk);  // +256 bytes a step
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(s);

    uint32_t ph[BKV / 16][4], pl[BKV / 16][4];
    softmax_tile<BKV, DH>(s, acc, m, l, ph, pl, kt * BKV, live_lo, live_hi,
                          skv, scale, t);

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

  store_rows<DH>(O + ((size_t)(b * hq + h) * sq) * DH, acc, l, q0, row0, sq,
                 t);
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
    case 256:
      return launch<256>(q, k, v, o, b, hq, hkv, sq, skv, causal, has_window,
                         window, q_offset, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace tc

// ---------------------------------------------------------------------------
// The bf16 kernel at dh 128: a TMA producer, two ping-ponging consumer
// warpgroups (see the note at the top).
// ---------------------------------------------------------------------------

namespace ws {

constexpr int DH = 128, BQ = 128, BKV = 128;
constexpr int STAGES = 2;  // K/V ring depth (3 fits, and was no faster)
constexpr int THREADS = 384;    // warpgroup 0 loads, 1 and 2 compute
constexpr int CONSUMERS = 256;
constexpr uint32_t HALF = 128 * 64 * 2;  // one TMA box: 128 rows x 64 cols
constexpr uint32_t TILE = 2 * HALF;      // a 128 x 128 tile, two boxes
constexpr uint32_t ROWS8 = 1024;         // 8 swizzled rows of 128 bytes
// Q, the K ring, the V ring, then the barriers; 1 KB of slack puts the
// tiles on the 1 KB boundary that the 128-byte swizzle repeats on.
constexpr size_t SMEM =
    1024 + (size_t)TILE * (1 + 2 * STAGES) + 8 * (2 + 3 * STAGES);

using tc::smem_addr;

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}
// Waits for the phase of `bar` with this parity; after 2^26 tries (seconds:
// an arrival that never comes) it traps, so a fault ends the launch with
// an error instead of hanging the card.  The loop stays inside the PTX.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .u32 n;\n"
      "mov.u32 n, 0;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "add.u32 n, n, 1;\n"
      "setp.lt.u32 p, n, 67108864;\n"
      "@p bra WAIT;\n"
      "trap;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}
// One box of a 3-d tensor map into shared memory, counted on `bar`.
__device__ __forceinline__ void tma_load(char* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}
// Named barriers between the two consumer warpgroups (0 is __syncthreads).
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(CONSUMERS) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(CONSUMERS) : "memory");
}

// A 128-byte-swizzled shared-memory descriptor (layout type 1): K-major
// tiles (Q, K) take SBO = 8 rows and LBO = 16 (unused); the MN-major V
// tile takes LBO = the step between its two 64-column boxes.
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  return tc::make_desc(p, lbo, sbo) | (1ull << 62);
}

// D (64 x 128, f32) [+]= A (64 x 16, shared) * B (16 x 128, shared), both
// K-major; scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
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
      : "l"(da), "l"(db), "r"(scale_d));
}

// Work item i: q block (latest, i.e. heaviest, first) and (batch, head).
__device__ __forceinline__ void work_item(int i, int n_qt, int per_q,
                                          int& q0, int& bh) {
  q0 = (n_qt - 1 - i / per_q) * BQ;
  bh = i % per_q;
}

// Thread layout of a consumer: warpgroup c (q rows 64c..), warp w of it,
// lane = 4g + t, as the tc kernel's.  Per work item the warpgroup takes
// n + 1 turns on the tensor cores: turn j issues P V of tile j - 1 (j > 0)
// and S = Q K^T of tile j (j < n); between its turns it runs the softmax
// of the S it got, while the other warpgroup's turn runs.  Named barrier 1
// lets warpgroup 0 start a turn, 2 warpgroup 1: each warpgroup hands the
// tensor cores over as soon as it has issued.
__global__ void __launch_bounds__(THREADS, 1)
    flash_attention_ws_kernel(const __grid_constant__ CUtensorMap tm_q,
                              const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v,
                              __nv_bfloat16* __restrict__ O, int b, int hq,
                              int hkv, int sq, int skv, int causal,
                              int has_window, int window, int q_offset,
                              float scale) {
  extern __shared__ char smem_raw[];
  char* sQ = smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  char* sK = sQ + TILE;
  char* sV = sK + STAGES * TILE;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sV + STAGES * TILE);
  uint64_t* q_empty = q_full + 1;
  uint64_t* k_full = q_full + 2;
  uint64_t* v_full = k_full + STAGES;
  uint64_t* kv_empty = v_full + STAGES;

  // The warpgroup, broadcast from lane 0 so that the compiler sees it is
  // uniform: a wgmma on a path it cannot prove uniform is serialized.
  const int tid = threadIdx.x;
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int n_qt = (sq + BQ - 1) / BQ, per_q = b * hq;
  const int n_items = n_qt * per_q;
  if (tid == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, CONSUMERS);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&kv_empty[s], CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // the producer: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == 0) {
      int it = 0, n = 0;  // tiles and items walked so far
      for (int i = blockIdx.x; i < n_items; i += gridDim.x, ++n) {
        int q0, bh, kb, ke;
        work_item(i, n_qt, per_q, q0, bh);
        const int kvh = bh / hq * hkv + bh % hq / (hq / hkv);
        kv_tiles(q0, BQ, sq, skv, causal, has_window, window, q_offset, BKV,
                 kb, ke);
        mbar_wait(q_empty, (n & 1) ^ 1);  // the last item's S are done
        mbar_expect_tx(q_full, TILE);
        tma_load(sQ, &tm_q, q_full, 0, q0, bh);
        tma_load(sQ + HALF, &tm_q, q_full, 64, q0, bh);
        for (int kt = kb; kt < ke; ++kt, ++it) {
          const int s = it % STAGES;
          mbar_wait(&kv_empty[s], ((it / STAGES) & 1) ^ 1);
          mbar_expect_tx(&k_full[s], TILE);
          tma_load(sK + s * TILE, &tm_k, &k_full[s], 0, kt * BKV, kvh);
          tma_load(sK + s * TILE + HALF, &tm_k, &k_full[s], 64, kt * BKV,
                   kvh);
          mbar_expect_tx(&v_full[s], TILE);
          tma_load(sV + s * TILE, &tm_v, &v_full[s], 0, kt * BKV, kvh);
          tma_load(sV + s * TILE + HALF, &tm_v, &v_full[s], 64, kt * BKV,
                   kvh);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int c = wg - 1;
  const int w = (tid % 128) / 32, g = (tid % 32) / 4, t = tid % 4;
  const int row0 = 64 * c + 16 * w + g;  // and row0 + 8
  int it = 0, n = 0;
  bool first_turn = true;
  for (int i = blockIdx.x; i < n_items; i += gridDim.x, ++n) {
    const bool last_item = i + (int)gridDim.x >= n_items;
    int q0, bh, kb, ke;
    work_item(i, n_qt, per_q, q0, bh);
    kv_tiles(q0, BQ, sq, skv, causal, has_window, window, q_offset, BKV, kb,
             ke);
    const int n_t = ke - kb;
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
    float acc[DH / 2];
    uint32_t ph[BKV / 16][4], pl[BKV / 16][4];
#pragma unroll
    for (int e = 0; e < DH / 2; ++e) acc[e] = 0.0f;
    // Q rows 64c.., columns 16kk..: box kk / 4, 32 bytes a step inside it.
    const uint64_t dq = sw128_desc(sQ + c * 64 * 128, 16, ROWS8);
    mbar_wait(q_full, n & 1);

    for (int j = 0; j <= n_t; ++j) {
      const int cur = it + j, s_cur = cur % STAGES;
      const int s_prev = (cur + STAGES - 1) % STAGES;
      if (j < n_t) mbar_wait(&k_full[s_cur], (cur / STAGES) & 1);
      if (j > 0) mbar_wait(&v_full[s_prev], ((cur - 1) / STAGES) & 1);
      if (c == 1)
        bar_sync(2);
      else if (!first_turn)
        bar_sync(1);
      first_turn = false;
      if (j > 0) {
        // O += P_hi V + P_lo V; V (MN-major) a k-step of 16 keys = 2 KB.
        const char* v_s = sV + s_prev * TILE;
        tc::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BKV / 16; ++kk)
          tc::wgmma_rs_n128(acc, ph[kk],
                            sw128_desc(v_s + kk * 2 * ROWS8, HALF, ROWS8));
#pragma unroll
        for (int kk = 0; kk < BKV / 16; ++kk)
          tc::wgmma_rs_n128(acc, pl[kk],
                            sw128_desc(v_s + kk * 2 * ROWS8, HALF, ROWS8));
        tc::wgmma_commit();
        tc::wgmma_wait_all();
        tc::reg_fence(acc);
        tc::reg_fence(ph);
        tc::reg_fence(pl);
        mbar_arrive(&kv_empty[s_prev]);
      }
      float s[BKV / 2];
      if (j < n_t) {
        const uint64_t dk = sw128_desc(sK + s_cur * TILE, 16, ROWS8);
        tc::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DH / 16; ++kk) {
          const uint32_t step = ((kk / 4) * HALF + (kk % 4) * 32) >> 4;
          wgmma_ss_n128(s, dq + step, dk + step, kk);
        }
        tc::wgmma_commit();
      }
      if (c == 0)
        bar_arrive(2);
      else if (!(last_item && j == n_t))
        bar_arrive(1);
      if (j == n_t) break;
      tc::wgmma_wait_all();
      tc::reg_fence(s);
      if (j == n_t - 1) mbar_arrive(q_empty);

      tc::softmax_tile<BKV, DH>(s, acc, m, l, ph, pl, (kb + j) * BKV,
                                live_lo, live_hi, skv, scale, t);
    }
    it += n_t;

    tc::store_rows<DH>(O + ((size_t)bh * sq) * DH, acc, l, q0, row0, sq, t);
  }
}

// cuTensorMapEncodeTiled, reached through the runtime (the libraries link
// no libcuda).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (heads, rows, 128) bf16 tensor in boxes of 128 rows x 64 columns of one
// head, 128-byte swizzled; rows past `rows` arrive as zeros.
bool tile_map(EncodeTiled enc, CUtensorMap* map, const void* base, int rows,
              int heads) {
  const cuuint64_t dims[3] = {DH, (cuuint64_t)rows, (cuuint64_t)heads};
  const cuuint64_t strides[2] = {DH * 2, (cuuint64_t)rows * DH * 2};
  const cuuint32_t box[3] = {64, BQ, 1}, unit[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
             const_cast<void*>(base), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int launch(const void* q, const void* k, const void* v, void* o, int b,
           int hq, int hkv, int sq, int skv, int causal, int has_window,
           int window, int q_offset, float scale, cudaStream_t st) {
  if (skv == 0)  // no key: every row averages nothing, acc / 1 = 0
    return (int)cudaMemsetAsync(o, 0, (size_t)b * hq * sq * DH * 2, st);
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap mq, mk, mv;
  if (!tile_map(enc, &mq, q, sq, b * hq) ||
      !tile_map(enc, &mk, k, skv, b * hkv) ||
      !tile_map(enc, &mv, v, skv, b * hkv))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      flash_attention_ws_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM);
  if (e != cudaSuccess) return (int)e;
  // One persistent block per SM walks the items (about 1% faster on an
  // H100 at olmoe-1b-7b's prefill layer than one block an item).
  const int items = (sq + BQ - 1) / BQ * b * hq;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int blocks = items < sms ? items : sms;
  flash_attention_ws_kernel<<<blocks, THREADS, SMEM, st>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), b, hq, hkv, sq, skv,
      causal, has_window, window, q_offset, scale);
  return (int)cudaGetLastError();
}

}  // namespace ws

// ---------------------------------------------------------------------------
// The f32 kernel: three TF32 passes on mma.sync (see the note at the top).
// ---------------------------------------------------------------------------

namespace f32 {

// At dh 128 a raw cp.async ring beside the split 128-row Q tile would not
// fit in shared memory, so the next tile's raw K/V wait in registers
// instead (RING false): 8 warps stay resident on an SM, as at dh 64.  At
// dh 32 and 64 the ring stays: the register path there spilled more and
// ran 0.7% slower at granite-3-2b's layer on an H100
// (repro_torch/analysis/lm_kernel_times.py across two checkouts), and at
// dh 16 a thread would hold no V row pair.  At dh 256 (64 q rows, 16-key
// tiles) each tile is loaded into registers and split at once (PREFETCH
// false): 64 registers of the next tile beside the 128 of the accumulator
// would spill.
template <int DH>
struct Cfg {
  static constexpr bool RING = DH < 128;            // raw K/V ring, else
                                                    // registers
  static constexpr bool PREFETCH = DH == 128;       // the next tile's, in
                                                    // registers
  static constexpr int BQ = DH == 256 ? 64 : 128;   // q rows per block
  static constexpr int BKV = DH == 256 ? 16 : DH == 128 ? 32 : 64;  // keys
  static constexpr int WARPS = BQ / 16;             // 16 q rows per warp
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int STAGES = 2;                  // raw K/V ring
  static constexpr int LDQ = DH / 2 + 4;  // quads per Q or K row, == 4 mod 8
  static constexpr int LDV = DH + 2;      // quads per V pair row, == 2 mod 8
  static constexpr int RAW = BKV * DH;    // floats of one raw K or V tile
  // Register path: float4s of K, and pairs of V rows' float4s, a thread.
  static constexpr int KF = RING ? 1 : BKV * DH / 4 / THREADS;
  static constexpr int VU = RING ? 1 : BKV / 2 * DH / 4 / THREADS;
  static constexpr size_t smem =
      16 * (size_t)(BQ * LDQ + BKV * LDQ + BKV / 2 * LDV) +
      4 * (size_t)(RING ? STAGES * 2 * RAW : 0);
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
  // P V chains in flight (4 at dh 256, beside its 128-register acc)
  constexpr int PV_N = DH == 256 ? 4 : DH / 8 < 8 ? DH / 8 : 8;
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
  // The register path: tile kt's raw K (rows f / (DH / 4)) and V (row
  // pairs u / (DH / 4)) as float4s, then split into sK/sV.
  float4 rk[C::KF], rv[C::VU][2];
  auto fetch = [&](int kt) {
    const int k0 = kt * BKV;
    const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int i = 0; i < C::KF; ++i) {
      const int f = tid + C::THREADS * i, j = k0 + f / (DH / 4);
      rk[i] = j < skv ? *reinterpret_cast<const float4*>(
                            kb + (size_t)j * DH + 4 * (f % (DH / 4)))
                      : zero;
    }
#pragma unroll
    for (int i = 0; i < C::VU; ++i) {
      const int u = tid + C::THREADS * i, c4 = u % (DH / 4);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = k0 + 2 * (u / (DH / 4)) + e;
        rv[i][e] = j < skv ? *reinterpret_cast<const float4*>(
                                 vb + (size_t)j * DH + 4 * c4)
                           : zero;
      }
    }
  };
  auto stash = [&]() {
#pragma unroll
    for (int i = 0; i < C::KF; ++i) {
      const int f = tid + C::THREADS * i;
      uint4* dst = sK + f / (DH / 4) * LDQ + 2 * (f % (DH / 4));
      dst[0] = tf32x3::pair_quad(rk[i].x, rk[i].y);
      dst[1] = tf32x3::pair_quad(rk[i].z, rk[i].w);
    }
#pragma unroll
    for (int i = 0; i < C::VU; ++i) {
      const int u = tid + C::THREADS * i;
      uint4* dst = sV + u / (DH / 4) * LDV + 4 * (u % (DH / 4));
      dst[0] = tf32x3::pair_quad(rv[i][0].x, rv[i][1].x);
      dst[1] = tf32x3::pair_quad(rv[i][0].y, rv[i][1].y);
      dst[2] = tf32x3::pair_quad(rv[i][0].z, rv[i][1].z);
      dst[3] = tf32x3::pair_quad(rv[i][0].w, rv[i][1].w);
    }
  };
  if constexpr (C::PREFETCH) {
    if (kt_begin < kt_end) fetch(kt_begin);
  } else if constexpr (C::RING) {
    load_kv(kt_begin);
  }
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
    if constexpr (C::RING) {
      const float* rk = raw + (kt - kt_begin) % C::STAGES * 2 * C::RAW;
      const float* rv = rk + C::RAW;
      tc::cp_async_wait<0>();  // this thread's copies of tile kt landed
      __syncthreads();  // everyone's have; everyone is done with tile kt - 1
      load_kv(kt + 1);  // into tile kt - 1's stage, converted already
      for (int idx = tid; idx < BKV * DH / 2; idx += C::THREADS) {
        const int j = idx / (DH / 2), p = idx % (DH / 2);
        const float2 x =
            *reinterpret_cast<const float2*>(rk + j * DH + 2 * p);
        sK[j * LDQ + p] = tf32x3::pair_quad(x.x, x.y);
      }
      for (int idx = tid; idx < BKV / 2 * DH; idx += C::THREADS) {
        const int r = idx / DH, d = idx % DH;
        sV[r * LDV + d] =
            tf32x3::pair_quad(rv[2 * r * DH + d], rv[(2 * r + 1) * DH + d]);
      }
      __syncthreads();
    } else {
      __syncthreads();  // everyone is done with tile kt - 1
      if constexpr (!C::PREFETCH) fetch(kt);
      stash();          // tile kt (with PREFETCH: fetched during kt - 1)
      __syncthreads();
      if (C::PREFETCH && kt + 1 < kt_end) fetch(kt + 1);  // in flight
    }

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
    case 256:
      return launch<256>(q, k, v, o, b, hq, hkv, sq, skv, causal, has_window,
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

// The dynamic shared memory a launch at head dim dh asks for, in bytes (0:
// no such kernel).
extern "C" int flash_attention_smem_bytes(int dh, int bf16) {
  if (bf16 && dh == ws::DH) return (int)ws::SMEM;
  switch (dh) {
    case 16:
      return (int)(bf16 ? tc::smem_bytes<16>() : f32::Cfg<16>::smem);
    case 32:
      return (int)(bf16 ? tc::smem_bytes<32>() : f32::Cfg<32>::smem);
    case 64:
      return (int)(bf16 ? tc::smem_bytes<64>() : f32::Cfg<64>::smem);
    case 128:
      return (int)f32::Cfg<128>::smem;
    case 256:
      return (int)(bf16 ? tc::smem_bytes<256>() : f32::Cfg<256>::smem);
    default:
      return 0;
  }
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
  if (bf16 && dh == ws::DH)
    return ws::launch(q, k, v, o, b, hq, hkv, sq, skv, causal, has_window,
                      window, q_offset, scale, st);
  if (bf16)
    return tc::launch_dh(dh, q, k, v, o, b, hq, hkv, sq, skv, causal,
                         has_window, window, q_offset, scale, st);
  return f32::launch_dh(dh, q, k, v, o, b, hq, hkv, sq, skv, causal,
                        has_window, window, q_offset, scale, st);
}
