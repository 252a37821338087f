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
// What bounds it on an H100.  At the training shape (BH = 256, T = 512,
// D = 64, float32, causal) the live (q, k) pairs need 10 * D flops each
// (five D-long products: s, dp, dv, dk, dq), 21.5 GFLOP in all, against
// about 236 MB of inputs and outputs (q, k, v, do, lse, di in; dq, dk, dv
// out): the float32 FMAs on the CUDA cores bound it (0.32 ms at the
// 67 TFLOP/s peak; the bytes take 0.07 ms).
// Feeding the FMAs from shared memory is the limit of this simple
// design: the inner loops execute about one shared-memory load per FMA.
//
// The design follows the card, not the TPU's block walk.  The TPU kernel
// keeps dq in a VMEM accumulator that persists across its sequential k
// grid; Hopper blocks run in parallel and in no order, so:
//   - One block per (bh, 64-row k tile); 256 threads, four per row.  The
//     block loads its K and V tiles once and loops over the q tiles that
//     the causal mask leaves alive (the TPU kernel's `_tile_alive`).
//   - dk and dv accumulate in float32 registers across that loop: each
//     thread owns one k row and D/4 of its columns.
//   - Each q tile's dq contribution (ds @ k) is added with float32
//     atomics into a zeroed [BH, Tq, D] scratch buffer, so the summation
//     order over k tiles varies from run to run.  A last pass multiplies
//     by the softmax scale once and casts, as the TPU flush does.
//   - q is scaled on its way into shared memory (the forward's
//     convention), so ds needs no scale and dk = ds^T (scale * q).
//   - ds = p * (dp - di).  Masked probabilities are zero by select, never
//     by multiply: a row that every key masks has lse = -1e30, where
//     exp(s - lse) is inf and inf * 0 would be NaN.  The q offset and k
//     offset place both tiles on the global axis for the causal mask; the
//     ragged edge (rows past T, columns past D) is masked here, not padded
//     by copies.
// Tensor cores (wgmma) and TMA are later work.  The atomic-free dq is the
// split pair's (flash_attention_bwd_split.cu), which the port runs where the
// reference runs its split kernels: past the fused kernel's dq accumulator
// cap (ops/kernels/flash_attention.py `_split_backward`).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreadsPerRow = 4;
constexpr int kThreads = kBlockK * kThreadsPerRow;          // 256
constexpr int kKeysPerThread = kBlockK / kThreadsPerRow;    // 16

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
  // k, v, q, do tiles [64][DPAD + 1]; p and ds tiles [64][65]; lse, di
  return (4 * kBlockK * (DPAD + 1) + 2 * kBlockQ * (kBlockK + 1) +
          2 * kBlockQ) *
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
fa_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ di,
              T* __restrict__ dk, T* __restrict__ dv,
              float* __restrict__ dq_acc, int tq, int tk, int d, int causal,
              float scale, int q_offset, int k_offset) {
  extern __shared__ float smem[];
  constexpr int S = DPAD + 1;
  constexpr int PS = kBlockK + 1;
  constexpr int kAcc = DPAD / kThreadsPerRow;
  float* ks = smem;
  float* vs = ks + kBlockK * S;
  float* qs = vs + kBlockK * S;
  float* dos = qs + kBlockQ * S;
  float* ps = dos + kBlockQ * S;
  float* dss = ps + kBlockQ * PS;
  float* lse_s = dss + kBlockQ * PS;
  float* di_s = lse_s + kBlockQ;

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * kBlockK;
  const int row = threadIdx.x / kThreadsPerRow;
  const int sub = threadIdx.x % kThreadsPerRow;
  const T* qb = q + (int64_t)bh * tq * d;
  const T* dob = dout + (int64_t)bh * tq * d;
  const T* kb = k + (int64_t)bh * tk * d;
  const T* vb = v + (int64_t)bh * tk * d;

  load_tile<T, DPAD>(ks, kb, k0, tk, d, 1.f);
  load_tile<T, DPAD>(vs, vb, k0, tk, d, 1.f);

  float dk_acc[kAcc];
  float dv_acc[kAcc];
#pragma unroll
  for (int c = 0; c < kAcc; ++c) dk_acc[c] = dv_acc[c] = 0.f;

  const int nq = (tq + kBlockQ - 1) / kBlockQ;
  for (int qt = 0; qt < nq; ++qt) {
    const int q0 = qt * kBlockQ;
    // dead tile: its newest query on the global axis precedes this k
    // tile's oldest key (uniform across the block, so no divergence at
    // the barriers below)
    if (causal && q_offset + min(q0 + kBlockQ, tq) - 1 < k_offset + k0)
      continue;
    __syncthreads();  // readers of the previous q tile are done
    load_tile<T, DPAD>(qs, qb, q0, tq, d, scale);
    load_tile<T, DPAD>(dos, dob, q0, tq, d, 1.f);
    if (threadIdx.x < kBlockQ) {
      const int r = q0 + threadIdx.x;
      lse_s[threadIdx.x] = r < tq ? lse[(int64_t)bh * tq + r] : 0.f;
      di_s[threadIdx.x] = r < tq ? di[(int64_t)bh * tq + r] : 0.f;
    }
    __syncthreads();

    // s = (scale q) k^T and dp = do v^T for query `row`, keys sub + 4 i
    float s[kKeysPerThread];
    float dp[kKeysPerThread];
#pragma unroll
    for (int i = 0; i < kKeysPerThread; ++i) s[i] = dp[i] = 0.f;
    const float* qrow = qs + row * S;
    const float* dorow = dos + row * S;
#pragma unroll 4
    for (int c = 0; c < DPAD; ++c) {
      const float qc = qrow[c];
      const float doc = dorow[c];
#pragma unroll
      for (int i = 0; i < kKeysPerThread; ++i) {
        const int off = (sub + kThreadsPerRow * i) * S + c;
        s[i] += qc * ks[off];
        dp[i] += doc * vs[off];
      }
    }

    const bool row_ok = q0 + row < tq;
    const int qpos = q_offset + q0 + row;
    const float lse_r = lse_s[row];
    const float di_r = di_s[row];
    float* prow = ps + row * PS;
    float* dsrow = dss + row * PS;
#pragma unroll
    for (int i = 0; i < kKeysPerThread; ++i) {
      const int kl = sub + kThreadsPerRow * i;
      const int kpos = k0 + kl;
      const bool ok = row_ok && kpos < tk &&
                      (!causal || qpos >= k_offset + kpos);
      // select, not multiply: exp(s - lse) is inf on a fully masked row
      const float p = ok ? expf(s[i] - lse_r) : 0.f;
      prow[kl] = p;
      dsrow[kl] = p * (dp[i] - di_r);
    }
    __syncthreads();

    // dv[row] += p^T do and dk[row] += ds^T (scale q): key `row`,
    // columns sub + 4 j
#pragma unroll 4
    for (int r = 0; r < kBlockQ; ++r) {
      const float pr = ps[r * PS + row];
      const float dsr = dss[r * PS + row];
      const float* dor = dos + r * S;
      const float* qr = qs + r * S;
#pragma unroll
      for (int j = 0; j < kAcc; ++j) {
        const int col = sub + kThreadsPerRow * j;
        dv_acc[j] += pr * dor[col];
        dk_acc[j] += dsr * qr[col];
      }
    }

    // dq[row] += ds k over this k tile, added into the scratch buffer
    float dq_part[kAcc];
#pragma unroll
    for (int j = 0; j < kAcc; ++j) dq_part[j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < kBlockK; ++c) {
      const float dsv = dsrow[c];
      const float* kr = ks + c * S;
#pragma unroll
      for (int j = 0; j < kAcc; ++j)
        dq_part[j] += dsv * kr[sub + kThreadsPerRow * j];
    }
    if (row_ok) {
      float* dst = dq_acc + ((int64_t)bh * tq + q0 + row) * d;
#pragma unroll
      for (int j = 0; j < kAcc; ++j) {
        const int col = sub + kThreadsPerRow * j;
        if (col < d) atomicAdd(dst + col, dq_part[j]);
      }
    }
  }

  const int kr = k0 + row;
  if (kr < tk) {
    T* dkrow = dk + ((int64_t)bh * tk + kr) * d;
    T* dvrow = dv + ((int64_t)bh * tk + kr) * d;
#pragma unroll
    for (int j = 0; j < kAcc; ++j) {
      const int col = sub + kThreadsPerRow * j;
      if (col < d) {
        store(dkrow + col, dk_acc[j]);
        store(dvrow + col, dv_acc[j]);
      }
    }
  }
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
  constexpr int smem = smem_bytes<DPAD>();
  cudaError_t err = cudaFuncSetAttribute(
      fa_bwd_kernel<T, DPAD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const int64_t n = (int64_t)bh * tq * d;
  err = cudaMemsetAsync(dq_acc, 0, n * sizeof(float), stream);
  if (err != cudaSuccess) return err;
  const dim3 grid((tk + kBlockK - 1) / kBlockK, bh);
  fa_bwd_kernel<T, DPAD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(di),
      static_cast<T*>(dk), static_cast<T*>(dv), static_cast<float*>(dq_acc),
      tq, tk, d, causal, scale, q_offset, k_offset);
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

// q, do: contiguous [bh, tq, d]; k, v: [bh, tk, d]; float32 (is_bf16 = 0)
// or bfloat16 (is_bf16 = 1), 1 <= d <= 128, bh <= 65535.  lse, di:
// float32 [bh, tq].  Writes dq [bh, tq, d] and dk, dv [bh, tk, d] in the
// input type on `stream`, using dq_acc (float32 [bh, tq, d], any contents)
// as scratch.  Returns the CUDA error of the launches (0 on success); does
// not synchronise.
int paddle_flash_attention_bwd(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* di, void* dq, void* dk, void* dv,
                               void* dq_acc, int bh, int tq, int tk, int d,
                               int is_bf16, int causal, float scale,
                               int q_offset, int k_offset, void* stream) {
  if (bh < 1 || bh > 65535 || tq < 1 || tk < 1 || d < 1 || d > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return static_cast<int>(dispatch<__nv_bfloat16>(
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
