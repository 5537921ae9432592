// Implicit-GEMM float convolution on Hopper: the float variants of the
// implicit conv engine, NHWC / HWIO, bias epilogue.
//
// Replaces: src/repro/kernels/conv2d/implicit_gemm.py:_implicit_kernel
// (conv2d_implicit_raw), variants native, bf16x3 and bf16x6 with the
// bias_relu epilogue.  The TPU kernel accumulated per (Cin block, tap) dot
// into one f32 VMEM scratch over its sequential K grid; here one thread
// block owns (image, 64 output pixels, 64 output channels) and walks every
// tap and the whole Cin itself (the port's plans take the whole Cin as the
// block, so the order is tap outer, Cin inner either way).  The loader
// gathers the pixels straight from the unpadded NHWC input (zero outside:
// the SAME/VALID padding) and splits each f32 value ONCE per tile into
// bf16 limbs (__float2bfloat16_rn, residual in f32); each K entry then runs
// the pairs of _BF16_PAIRS -- bf16x3 (0,0) (0,1) (1,0), bf16x6 (0,0) (0,1)
// (1,0) (0,2) (1,1) (2,0) -- as exact bf16 x bf16 products added by
// __fmaf_rn into f32 partial sums that nest per 16-channel chunk, per tap
// and in total (float_tile.cuh).  native: one f32 FMA per product.  The
// systolic engine's native variant is this kernel too.  Epilogue
// fl(acc + bias); the ReLU follows in the wrapper.
//
// What bounds it on this card: the pass FMAs (3 or 6 per MAC under the
// bf16 schedules; VGG16 is 15.5 G MAC per image), run on the CUDA cores
// (67 TFLOP/s f32 peak) where the bf16 tensor cores would give 989: the
// bound the port reports is the bf16 tensor-core time.  What the design
// does about it: the split happens once per loaded element, not once per
// product, and every loaded limb is reused by 64 outputs from shared
// memory.  Tensor-core bf16 MMA (mma.sync / wgmma) is later work.
#include "float_tile.cuh"

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// X (n, H, W, cin) f32 unpadded (pads = top, left; bottom/right follow from
// ho, wo); Wt (kh, kw, cin, cout) f32; bias (cout) or NULL; out (n, ho, wo,
// cout) f32.  passes: 1 (native f32), 3 (bf16x3) or 6 (bf16x6).
extern "C" int implicit_conv_float_launch(const void* X, const void* Wt,
                                          const void* bias, void* out, int n,
                                          int H, int W, int cin, int cout,
                                          int kh, int kw, int stride,
                                          int pad_t, int pad_l, int ho,
                                          int wo, int passes, void* stream) {
  cudaError_t err;
  switch (passes) {
    case 1:
      err = ftile::launch_float_conv<ftile::F32>(X, Wt, bias, out, n, H, W,
                                                 cin, cout, kh, kw, stride,
                                                 pad_t, pad_l, ho, wo, stream);
      break;
    case 3:
      err = ftile::launch_float_conv<ftile::BF16X3>(
          X, Wt, bias, out, n, H, W, cin, cout, kh, kw, stride, pad_t, pad_l,
          ho, wo, stream);
      break;
    case 6:
      err = ftile::launch_float_conv<ftile::BF16X6_TAP>(
          X, Wt, bias, out, n, H, W, cin, cout, kh, kw, stride, pad_t, pad_l,
          ho, wo, stream);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
