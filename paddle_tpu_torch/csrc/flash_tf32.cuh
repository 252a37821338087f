// Device helpers shared by the flash-attention forward and fused backward
// (flash_attention_fwd.cu, flash_attention_bwd.cu): float32 products on
// the tensor cores at float32 accuracy (the 3xTF32 split, as CUTLASS's
// OpMultiplyAddFastF32), and tile copies by cp.async.  Included by both
// sources; ops/kernels/build.py rebuilds both libraries when it changes.
//
// 3xTF32: each operand x becomes big = tf32(x) (rounded to TF32's 10-bit
// mantissa, to nearest as cvt.rna rounds, so the tensor core reads it
// whole) and small = tf32(x - big) (x - big is exact in float32), and
// a.b = a_small.b_big + a_big.b_small + a_big.b_big; the dropped
// a_small.b_small is below 2^-22 relative.  Plain TF32 (three decimal
// digits) is never used.  bfloat16 and float16 inputs are exact in TF32
// (small = 0): both carry at most TF32's 10-bit mantissa, and float16's
// exponent range lies inside TF32's.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash_tf32 {

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(__half x) {
  return __half2float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
__device__ __forceinline__ void store(__half* p, float x) {
  *p = __float2half_rn(x);
}

// x rounded to TF32, to nearest with ties away from zero, as
// cvt.rna.tf32.f32 rounds: half a TF32 ulp added to the bit pattern, the
// 13 dropped bits cleared (two integer operations on the full-rate pipes)
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// 3xTF32 split: x = big + small, big exact in TF32, x - big exact in float32
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

// the A fragment (a0..a3 in the mma's order) split in two
__device__ __forceinline__ void split4(float a0, float a1, float a2, float a3,
                                       uint32_t (&ab)[4], uint32_t (&as)[4]) {
  split(a0, ab[0], as[0]);
  split(a1, ab[1], as[1]);
  split(a2, ab[2], as[2]);
  split(a3, ab[3], as[3]);
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a.b at float32 accuracy: the small cross terms first, then big.big
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4], float b0,
                                     float b1) {
  uint32_t bb0, bs0, bb1, bs1;
  split(b0, bb0, bs0);
  split(b1, bb1, bs1);
  mma_tf32(c, as, bb0, bb1);
  mma_tf32(c, ab, bs0, bs1);
  mma_tf32(c, ab, bb0, bb1);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Rows [row0, row0 + ROWS) of a float32 [rows, d] matrix into
// dst[ROWS][DPAD + 4] by cp.async, 16 bytes a copy, over THREADS threads
// (d % 4 == 0 and src 16-byte aligned); the ragged edge is zero-filled.
template <int DPAD, int ROWS, int THREADS>
__device__ __forceinline__ void copy_rows(float* dst, const float* src,
                                          int row0, int rows, int d) {
  constexpr int kChunks = DPAD / 4;
  for (int idx = threadIdx.x; idx < ROWS * kChunks; idx += THREADS) {
    const int r = idx / kChunks;
    const int c = (idx % kChunks) * 4;
    const int gr = row0 + r;
    const bool ok = gr < rows && c < d;
    cp_async16(dst + r * (DPAD + 4) + c,
               ok ? src + (int64_t)gr * d + c : src, ok);
  }
}

}  // namespace flash_tf32
