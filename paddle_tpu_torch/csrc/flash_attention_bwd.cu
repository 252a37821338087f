// Flash-attention backward for Hopper (sm_90a), behind a plain C interface.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/flash_attention.py
// `_fa_bwd_fused_kernel` (launched by `_fa_backward_pallas`): one pass
// that recomputes each (q tile, k tile) of probabilities from the
// forward's saved logsumexp and accumulates dq, dk and dv, never holding
// the [Tq, Tk] score matrix in device memory.  The caller computes
// di = rowsum(do * o) - dlse (float32 [BH, Tq]), as the TPU launcher does
// outside its kernel.
//
// What bounds it on an H100.  The live (q, k) pairs need 10 * D flops each
// (five D-long products: s, dp, dv, dk, dq).  At the training shape
// (BH = 256, T = 512, D = 64, float32, causal) that is 21.5 GFLOP against
// about 236 MB of inputs and outputs (q, k, v, do, lse, di in; dq, dk, dv
// out): 0.321 ms at the CUDA cores' float32 peak (67 TFLOP/s), 0.130 ms on
// the tensor cores at float32 accuracy (3xTF32: 495 / 3 = 165 TFLOP/s);
// the bytes take 0.07 ms.  On 16-bit q/k/v (the AMP step) the bytes, 118
// MB, bound it at 0.035 ms; the flops take 0.022 ms on the 16-bit tensor
// cores (989 TFLOP/s), where the engine's 16-bit path computes (one
// m16n8k16 mma.sync a product, the reference's roundings of q times the
// scale, p and ds; flash_bwd_dkv.cuh, "16-bit inputs").
//
// Design.  The TPU kernel keeps dq in a VMEM accumulator that persists
// across its sequential k grid; Hopper blocks run in parallel and in no
// order, so one block per (bh, 64-row k tile) walks the q tiles that the
// causal mask leaves alive and computes dk and dv on the tensor cores at
// float32 accuracy (3xTF32), by the engine it shares with the split pair's
// dk/dv kernel (flash_bwd_dkv.cuh, whose header notes the warp layout, the
// cp.async ring, the masking and the float32 adds of per-tile partials).
// dq = ds k needs the q rows as A rows: each q tile's ds^T goes through
// shared memory, and warp w computes q rows 16 (w & 3) .. + 15, half of
// the columns, adding its tile's part with float32 atomics into a zeroed
// [BH, Tq, D] scratch buffer (two floats an atomic), so the summation
// order over k tiles varies from run to run.  A last pass multiplies by
// the softmax scale once and casts, as the TPU flush does.
// What still bounds it (float32; the 16-bit path shares all but the
// splits): mma.sync reaches part of the tensor cores' rate,
// each operand is split by every warp that reads it (five operations a
// value, integer rounding as in the forward), ds^T makes a round
// trip through shared memory between two barriers per q tile, and dq's
// atomics.  The atomic-free dq is the split pair's
// (flash_attention_bwd_split.cu), which the port runs where the reference
// runs its split kernels: past the fused kernel's dq accumulator cap
// (ops/kernels/flash_attention.py `_split_backward`).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_bwd_dkv.cuh"

namespace {

using namespace flash_bwd_dkv;

template <typename T, int DPAD>
__global__ void __launch_bounds__(kThreads)
fa_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ di,
              T* __restrict__ dk, T* __restrict__ dv,
              float* __restrict__ dq_acc, int tq, int tk, int d, int causal,
              float scale, int q_offset, int k_offset, int use_async) {
  extern __shared__ float4 smem4[];
  dkv_block<T, DPAD, true>(q, k, v, dout, lse, di, dk, dv, dq_acc, tq, tk,
                           d, causal, scale, q_offset, k_offset, use_async,
                           blockIdx.y, blockIdx.x,
                           reinterpret_cast<float*>(smem4));
}

// bfloat16 and float16: the engine's 16-bit path, MINB blocks an SM
template <typename T, int DPAD, int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
fa_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ di,
              T* __restrict__ dk, T* __restrict__ dv,
              float* __restrict__ dq_acc, int tq, int tk, int d, int causal,
              float scale, int q_offset, int k_offset, int use_async) {
  extern __shared__ float4 smem4[];
  dkv_block16<T, DPAD, true>(q, k, v, dout, lse, di, dk, dv, dq_acc, tq, tk,
                             d, causal, scale, q_offset, k_offset,
                             use_async != 0, blockIdx.y, blockIdx.x,
                             reinterpret_cast<T*>(smem4));
}

// The kernel of element type T: float32 the 3xTF32 engine; 16-bit the
// 16-bit path, two blocks an SM at D <= 64 (at most 128 registers a
// thread, 65 KB of shared memory each: 9-10% faster at the AMP training
// shape than one block with 214 registers, ops/kernels/flash16_probe.py)
template <typename T, int DPAD>
constexpr auto bwd_kernel() {
  if constexpr (sizeof(T) == 4)
    return &fa_bwd_kernel<T, DPAD>;
  else
    return &fa_bwd_kernel<T, DPAD, (DPAD <= 64 ? 2 : 1)>;
}

// dq = scale * dq_acc, cast to the input type (the TPU kernel's flush)
template <typename T>
__global__ void fa_bwd_dq_finish(const float* __restrict__ dq_acc,
                                 T* __restrict__ dq, int64_t n, float scale) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x)
    store(dq + i, dq_acc[i] * scale);
}

template <typename T, int DPAD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* di,
                   void* dq, void* dk, void* dv, void* dq_acc, int bh,
                   int tq, int tk, int d, int causal, float scale,
                   int q_offset, int k_offset, cudaStream_t stream) {
  constexpr int smem = sizeof(T) == 4 ? smem_bytes<DPAD, true>()
                                      : smem16_bytes<DPAD, true>();
  constexpr auto kernel = bwd_kernel<T, DPAD>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int64_t n = (int64_t)bh * tq * d;
  err = cudaMemsetAsync(dq_acc, 0, n * sizeof(float), stream);
  if (err != cudaSuccess) return err;
  const int use_async = sizeof(T) == 4
                            ? async_tiles<T, DPAD>(q, k, v, dout, d)
                            : async_tiles16(q, k, v, dout, d);
  const dim3 grid((tk + kBlockK - 1) / kBlockK, bh);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(di),
      static_cast<T*>(dk), static_cast<T*>(dv), static_cast<float*>(dq_acc),
      tq, tk, d, causal, scale, q_offset, k_offset, use_async);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t blocks = (n + 255) / 256;
  fa_bwd_dq_finish<T><<<(unsigned)(blocks < 4096 ? blocks : 4096), 256, 0,
                         stream>>>(static_cast<const float*>(dq_acc),
                                   static_cast<T*>(dq), n, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* di,
                     void* dq, void* dk, void* dv, void* dq_acc, int bh,
                     int tq, int tk, int d, int causal, float scale,
                     int q_offset, int k_offset, cudaStream_t stream) {
  if (d <= 32)
    return launch<T, 32>(q, k, v, dout, lse, di, dq, dk, dv, dq_acc, bh, tq,
                         tk, d, causal, scale, q_offset, k_offset, stream);
  if (d <= 64)
    return launch<T, 64>(q, k, v, dout, lse, di, dq, dk, dv, dq_acc, bh, tq,
                         tk, d, causal, scale, q_offset, k_offset, stream);
  return launch<T, 128>(q, k, v, dout, lse, di, dq, dk, dv, dq_acc, bh, tq,
                        tk, d, causal, scale, q_offset, k_offset, stream);
}

}  // namespace

extern "C" {

// q, do: contiguous [bh, tq, d]; k, v: [bh, tk, d]; float32 (dtype = 0),
// bfloat16 (dtype = 1) or float16 (dtype = 2), 1 <= d <= 128,
// bh <= 65535.  lse, di:
// float32 [bh, tq].  Writes dq [bh, tq, d] and dk, dv [bh, tk, d] in the
// input type on `stream`, using dq_acc (float32 [bh, tq, d], any contents)
// as scratch.  Returns the CUDA error of the launches (0 on success); does
// not synchronise.
int paddle_flash_attention_bwd(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* di, void* dq, void* dk, void* dv,
                               void* dq_acc, int bh, int tq, int tk, int d,
                               int dtype, int causal, float scale,
                               int q_offset, int k_offset, void* stream) {
  if (bh < 1 || bh > 65535 || tq < 1 || tk < 1 || d < 1 || d > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return static_cast<int>(dispatch<__nv_bfloat16>(
        q, k, v, dout, lse, di, dq, dk, dv, dq_acc, bh, tq, tk, d, causal,
        scale, q_offset, k_offset, s));
  if (dtype == 2)
    return static_cast<int>(dispatch<__half>(
        q, k, v, dout, lse, di, dq, dk, dv, dq_acc, bh, tq, tk, d, causal,
        scale, q_offset, k_offset, s));
  return static_cast<int>(dispatch<float>(q, k, v, dout, lse, di, dq, dk, dv,
                                          dq_acc, bh, tq, tk, d, causal,
                                          scale, q_offset, k_offset, s));
}

const char* paddle_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
