// Flash-attention forward for Hopper (sm_90a), behind a plain C interface.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/flash_attention.py
// `_fa_kernel` (launched by `_fa_forward`): online-softmax attention over
// [BH, T, D] that returns the output and the per-row logsumexp, skips the
// key tiles a causal mask leaves dead, and places queries and keys on a
// global position axis (q_offset, k_offset) for the causal mask.
//
// What bounds it on an H100.  At the decode engine's prefill shapes (BH =
// heads = 8, T <= 256, D = 64) one call moves about 2 MB and does under
// 70 MFLOP: below a microsecond at 3.35 TB/s or at the 67 TFLOP/s float32
// peak, so launch latency and the serial k-tile loop set its time.  At
// long T the float32 FMAs on the CUDA cores bound it (4 * D flops for each
// live (q, k) pair), and feeding them from shared memory is the limit of
// this simple design: the inner loops execute about one shared-memory load
// per FMA.
//
// The design keeps to what the TPU kernel keeps out of device memory: the
// [Tq, Tk] score matrix never leaves the block.
//   - One block per (bh, 64-row q tile); 256 threads, four per query row.
//   - The q tile (pre-scaled) and each 64-row K and V tile are staged in
//     shared memory in float32 and reused by all 64 rows of the block.
//     Rows are padded by one float so the access patterns below are free
//     of bank conflicts.
//   - Each thread scores 16 of the tile's 64 keys and owns D/4 columns of
//     the output accumulator.  The online-softmax state (m, l, acc) stays
//     in registers in float32; the row max and row sum are reduced across
//     the row's four lanes with warp shuffles.
//   - Masked probabilities are set to zero explicitly, and a row that
//     every key masks ends with l_safe = 1 (o = 0, lse = -1e30), as in
//     the TPU kernel.  The ragged edge (rows past T, columns past D) is
//     masked here, not padded by copies.
//   - The k-tile loop stops at the last tile the causal mask leaves alive
//     (the TPU kernel's `_tile_alive`).
// Tensor cores (wgmma), TMA and a pipelined ring of tiles are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreadsPerRow = 4;
constexpr int kThreads = kBlockQ * kThreadsPerRow;          // 256
constexpr int kKeysPerThread = kBlockK / kThreadsPerRow;    // 16
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <int DPAD>
constexpr int smem_bytes() {
  // q, k, v tiles [64][DPAD + 1] and the probability tile [64][65]
  return (3 * kBlockQ * (DPAD + 1) + kBlockQ * (kBlockK + 1)) *
         static_cast<int>(sizeof(float));
}

// Stage rows [row0, row0 + 64) of a [rows, d] matrix into dst[64][DPAD + 1]
// as float32 times `mul`; rows past `rows` and columns past `d` read zero.
template <typename T, int DPAD>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0,
                                          int rows, int d, float mul) {
  for (int idx = threadIdx.x; idx < kBlockK * DPAD; idx += kThreads) {
    const int r = idx / DPAD;
    const int c = idx % DPAD;
    const int gr = row0 + r;
    float x = 0.f;
    if (gr < rows && c < d) x = to_float(src[(int64_t)gr * d + c]) * mul;
    dst[r * (DPAD + 1) + c] = x;
  }
}

template <typename T, int DPAD>
__global__ void __launch_bounds__(kThreads)
fa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o,
              float* __restrict__ lse, int tq, int tk, int d, int causal,
              float scale, int q_offset, int k_offset) {
  extern __shared__ float smem[];
  constexpr int S = DPAD + 1;
  constexpr int PS = kBlockK + 1;
  constexpr int kAcc = DPAD / kThreadsPerRow;
  float* qs = smem;
  float* ks = qs + kBlockQ * S;
  float* vs = ks + kBlockK * S;
  float* ps = vs + kBlockK * S;

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBlockQ;
  const int row = threadIdx.x / kThreadsPerRow;
  const int sub = threadIdx.x % kThreadsPerRow;
  const T* qb = q + (int64_t)bh * tq * d;
  const T* kb = k + (int64_t)bh * tk * d;
  const T* vb = v + (int64_t)bh * tk * d;

  // the softmax scale is folded into q once, as the TPU launcher does
  load_tile<T, DPAD>(qs, qb, q0, tq, d, scale);

  int nk = (tk + kBlockK - 1) / kBlockK;
  if (causal) {
    // newest query of this tile on the global axis, and the newest key
    // it may see on the local axis: tiles past that one are dead
    const int q_last = q_offset + min(q0 + kBlockQ, tq) - 1;
    const int k_last = q_last - k_offset;
    nk = min(nk, k_last < 0 ? 0 : k_last / kBlockK + 1);
  }

  const int qpos = q_offset + q0 + row;
  float m = kNegInf;
  float l = 0.f;
  float acc[kAcc];
#pragma unroll
  for (int c = 0; c < kAcc; ++c) acc[c] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // every reader of the previous tile is done
    load_tile<T, DPAD>(ks, kb, k0, tk, d, 1.f);
    load_tile<T, DPAD>(vs, vb, k0, tk, d, 1.f);
    __syncthreads();

    // scores for keys sub, sub + 4, ..., sub + 60 of this tile
    float s[kKeysPerThread];
#pragma unroll
    for (int i = 0; i < kKeysPerThread; ++i) s[i] = 0.f;
    const float* qrow = qs + row * S;
#pragma unroll 4
    for (int c = 0; c < DPAD; ++c) {
      const float qc = qrow[c];
#pragma unroll
      for (int i = 0; i < kKeysPerThread; ++i)
        s[i] += qc * ks[(sub + kThreadsPerRow * i) * S + c];
    }

    unsigned valid = 0;
    float m_cur = kNegInf;
#pragma unroll
    for (int i = 0; i < kKeysPerThread; ++i) {
      const int kpos = k0 + sub + kThreadsPerRow * i;
      const bool ok = kpos < tk && (!causal || qpos >= k_offset + kpos);
      valid |= (ok ? 1u : 0u) << i;
      s[i] = ok ? s[i] : kNegInf;
      m_cur = fmaxf(m_cur, s[i]);
    }
    // the row's four threads are adjacent lanes of one warp
    m_cur = fmaxf(m_cur, __shfl_xor_sync(0xffffffffu, m_cur, 1));
    m_cur = fmaxf(m_cur, __shfl_xor_sync(0xffffffffu, m_cur, 2));
    const float m_new = fmaxf(m, m_cur);
    const float alpha = expf(m - m_new);

    float* prow = ps + row * PS;
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < kKeysPerThread; ++i) {
      // explicit zero: on a fully masked row s == m_new and exp(0) is 1
      const float p = ((valid >> i) & 1u) ? expf(s[i] - m_new) : 0.f;
      psum += p;
      prow[sub + kThreadsPerRow * i] = p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * alpha + psum;
    m = m_new;
    __syncwarp();  // the row's probabilities are visible to its four lanes

#pragma unroll
    for (int c = 0; c < kAcc; ++c) acc[c] *= alpha;
#pragma unroll 4
    for (int j = 0; j < kBlockK; ++j) {
      const float p = prow[j];
      const float* vrow = vs + j * S;
#pragma unroll
      for (int c = 0; c < kAcc; ++c)
        acc[c] += p * vrow[sub + kThreadsPerRow * c];
    }
  }

  const int r = q0 + row;
  if (r < tq) {
    const float l_safe = l > 0.f ? l : 1.f;
    T* orow = o + ((int64_t)bh * tq + r) * d;
#pragma unroll
    for (int c = 0; c < kAcc; ++c) {
      const int col = sub + kThreadsPerRow * c;
      if (col < d) store(orow + col, acc[c] / l_safe);
    }
    if (sub == 0) lse[(int64_t)bh * tq + r] = m + logf(l_safe);
  }
}

template <typename T, int DPAD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int bh, int tq, int tk, int d, int causal,
                   float scale, int q_offset, int k_offset,
                   cudaStream_t stream) {
  constexpr int smem = smem_bytes<DPAD>();
  cudaError_t err = cudaFuncSetAttribute(
      fa_fwd_kernel<T, DPAD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((tq + kBlockQ - 1) / kBlockQ, bh);
  fa_fwd_kernel<T, DPAD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o),
      static_cast<float*>(lse), tq, tk, d, causal, scale, q_offset,
      k_offset);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     void* lse, int bh, int tq, int tk, int d, int causal,
                     float scale, int q_offset, int k_offset,
                     cudaStream_t stream) {
  if (d <= 32)
    return launch<T, 32>(q, k, v, o, lse, bh, tq, tk, d, causal, scale,
                         q_offset, k_offset, stream);
  if (d <= 64)
    return launch<T, 64>(q, k, v, o, lse, bh, tq, tk, d, causal, scale,
                         q_offset, k_offset, stream);
  return launch<T, 128>(q, k, v, o, lse, bh, tq, tk, d, causal, scale,
                        q_offset, k_offset, stream);
}

}  // namespace

extern "C" {

// q, k, v: contiguous [bh, tq | tk, d] of float32 (is_bf16 = 0) or
// bfloat16 (is_bf16 = 1), 1 <= d <= 128, bh <= 65535.  Writes o [bh, tq, d]
// in the input type and lse [bh, tq] in float32 on `stream`.  Returns the
// CUDA error of the launch (0 on success); does not synchronise.
int paddle_flash_attention_fwd(const void* q, const void* k, const void* v,
                               void* o, void* lse, int bh, int tq, int tk,
                               int d, int is_bf16, int causal, float scale,
                               int q_offset, int k_offset, void* stream) {
  if (bh < 1 || bh > 65535 || tq < 1 || tk < 1 || d < 1 || d > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return static_cast<int>(dispatch<__nv_bfloat16>(
        q, k, v, o, lse, bh, tq, tk, d, causal, scale, q_offset, k_offset,
        s));
  return static_cast<int>(dispatch<float>(q, k, v, o, lse, bh, tq, tk, d,
                                          causal, scale, q_offset, k_offset,
                                          s));
}

const char* paddle_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
