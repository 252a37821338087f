// Device helpers of the flash-attention kernels' 16-bit engines
// (flash_attention_fwd.cu, flash_bwd_dkv.cuh): bfloat16 and float16
// products on the tensor cores (mma.sync m16n8k16, float32 accumulate),
// fragments read from shared memory by ldmatrix, tiles staged by cp.async
// as 16-bit rows, and float32 values rounded to the input type and
// packed two to a register.  Float32 inputs never reach this header: they
// take the 3xTF32 engines of flash_tf32.cuh, whose cp.async group
// helpers and conversions to float32 the 16-bit engines share.
// ops/kernels/build.py rebuilds every library whose source includes it
// when it changes.
//
// Tiles sit in shared memory as [rows][DPAD + 8] 16-bit values: the 16
// bytes of padding put the eight 16-byte rows that one 8x8 ldmatrix
// matrix reads on eight distinct groups of four banks (a row stride of
// 80, 144 or 272 bytes at DPAD = 32, 64, 128), so fragment reads are free
// of bank conflicts, and every row stays 16-byte aligned for cp.async.
//
// Fragment layouts (PTX ISA, mma.m16n8k16 with .bf16 / .f16): lane
// (g = lane / 4, t = lane % 4) holds A rows g and g + 8 at k columns 2t,
// 2t + 1 and 2t + 8, 2t + 9 (a0..a3), B columns g at k rows 2t, 2t + 1
// and 2t + 8, 2t + 9 (b0, b1), and the accumulator's rows g and g + 8 at
// columns 2t, 2t + 1 (c0..c3).  Two 16-bit values share a register, the
// lower column in the low half.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace flash_f16 {

template <typename T>
constexpr bool kIsBf16 = std::is_same_v<T, __nv_bfloat16>;

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ __nv_bfloat16 from_float(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half from_float(float x) {
  return __float2half_rn(x);
}

// lo and hi rounded to T (to nearest even) in one register, lo in the low
// half: cvt.rn.{bf16x2,f16x2}.f32 puts its first source in the high half
template <typename T>
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  uint32_t r;
  if constexpr (kIsBf16<T>)
    asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  else
    asm("cvt.rn.f16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// the two values of a packed register as float32
template <typename T>
__device__ __forceinline__ float2 unpack(uint32_t x) {
  if constexpr (kIsBf16<T>) {
    return make_float2(__uint_as_float(x << 16),
                       __uint_as_float(x & 0xffff0000u));
  } else {
    __half2 h;
    memcpy(&h, &x, 4);
    return __half22float2(h);
  }
}

// c += a.b on the tensor cores: m16n8k16, 16-bit operands, float32 sums
template <typename T>
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  if constexpr (kIsBf16<T>)
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  else
    asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// four 8x8 matrices of 16-bit values: lanes 8i .. 8i + 7 give the row
// addresses of matrix i, whose fragment lands in r[i] (lane (g, t) holds
// row g, columns 2t and 2t + 1)
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(row)));
}

// the same matrices transposed: lane (g, t) holds rows 2t and 2t + 1 of
// column g
__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(row)));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

// Row stride, in 16-bit values, of a staged tile
template <int DPAD>
__host__ __device__ constexpr int stride() {
  return DPAD + 8;
}

// Rows [row0, row0 + ROWS) of a [rows, d] matrix of T into
// dst[ROWS][DPAD + 8] over THREADS threads, the ragged edge (rows past
// `rows`, columns past d) zero-filled.  With `async`, by cp.async, 16
// bytes a copy (d % 8 == 0 and src 16-byte aligned; the caller commits
// and waits, flash_tf32.cuh); else by the threads' loads and stores.  The copy or load of
// element (r, c) is issued by thread (r * DPAD + c) / 8 % THREADS, the
// ownership scale_own_rows walks.
template <typename T, int DPAD, int ROWS, int THREADS>
__device__ __forceinline__ void stage_rows(T* dst, const T* src, int row0,
                                           int rows, int d, bool async) {
  constexpr int kChunks = DPAD / 8;
  constexpr int S = stride<DPAD>();
  if (async) {
#pragma unroll
    for (int it = 0; it < (ROWS * kChunks + THREADS - 1) / THREADS; ++it) {
      const int idx = threadIdx.x + it * THREADS;
      if (idx >= ROWS * kChunks) break;
      const int r = idx / kChunks;
      const int c = (idx % kChunks) * 8;
      const int gr = row0 + r;
      const bool ok = gr < rows && c < d;
      cp_async16(dst + r * S + c, ok ? src + (int64_t)gr * d + c : src, ok);
    }
  } else {
#pragma unroll
    for (int it = 0; it < (ROWS * kChunks + THREADS - 1) / THREADS; ++it) {
      const int idx = threadIdx.x + it * THREADS;
      if (idx >= ROWS * kChunks) break;
      const int r = idx / kChunks;
      const int c0 = (idx % kChunks) * 8;
      const int gr = row0 + r;
      T x[8];
#pragma unroll
      for (int c = 0; c < 8; ++c)
        x[c] = gr < rows && c0 + c < d ? src[(int64_t)gr * d + c0 + c]
                                       : from_float<T>(0.f);
#pragma unroll
      for (int c = 0; c < 8; ++c) dst[r * S + c0 + c] = x[c];
    }
  }
}

// q times the softmax scale in T, in place, over the 8-value chunks of a
// staged tile that this thread staged (stage_rows' ownership): x becomes
// T(x * scale_t), scale_t the scale already rounded to T, as the
// reference's launchers compute (q * scale).astype(q.dtype).  The product
// of two 16-bit values is exact in float32, so one rounding gives T's.
template <typename T, int DPAD, int ROWS, int THREADS>
__device__ __forceinline__ void scale_own_rows(T* tile, float scale_t) {
  constexpr int kChunks = DPAD / 8;
  constexpr int S = stride<DPAD>();
#pragma unroll
  for (int it = 0; it < (ROWS * kChunks + THREADS - 1) / THREADS; ++it) {
    const int idx = threadIdx.x + it * THREADS;
    if (idx >= ROWS * kChunks) break;
    uint4* p = reinterpret_cast<uint4*>(tile + (idx / kChunks) * S +
                                        (idx % kChunks) * 8);
    uint4 w = *p;
    uint32_t* u = reinterpret_cast<uint32_t*>(&w);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = unpack<T>(u[i]);
      u[i] = pack<T>(f.x * scale_t, f.y * scale_t);
    }
    *p = w;
  }
}

}  // namespace flash_f16
