// Split flash-attention backward for Hopper (sm_90a), behind a plain C
// interface: one kernel for dk and dv, one for dq.
//
// Replaces the TPU kernels paddle_tpu/ops/pallas/flash_attention.py
// `_fa_bwd_dkv_kernel` and `_fa_bwd_dq_kernel`, the pair
// `_fa_backward_pallas` launches in place of its fused kernel when the fused
// kernel's dq accumulator would not fit (T > 65536 at D = 64).  Both
// recompute each (q tile, k tile) of probabilities from the forward's saved
// logsumexp, never holding the [Tq, Tk] score matrix in device memory.  The
// caller computes di = rowsum(do * o) - dlse (float32 [BH, Tq]), as the TPU
// launcher does outside its kernels.
//
// What bounds them on an H100.  At one 128K-context layer (BH = 8,
// T = 131072, D = 64, float32, causal) there are 6.87e10 live (q, k) pairs.
// The dk/dv kernel does four D-long products per pair (s, dp, dv, dk),
// 8 * D flops, 35 TFLOP; the dq kernel three (s, dp, dq), 6 * D flops,
// 26 TFLOP.  Their bytes (q, k, v, do, lse, di in; dk, dv or dq out) are
// under 2 GB.  So the float32 FMAs on the CUDA cores bound both (0.53 s and
// 0.39 s at the 67 TFLOP/s peak).  Redoing s and dp in both kernels is the
// split's price over the fused kernel (7 products per pair instead of 5),
// as on the TPU.
//
// The design follows the card, not the TPU's block walk.  The TPU kernels
// carry their accumulators in VMEM across a sequential grid axis; Hopper
// blocks run in parallel and in no order, so each block owns one output
// tile and walks the other axis in a loop:
//   - dk/dv: one block per (bh, 64-row k tile).  It loads its K and V tiles
//     once and walks the q tiles the causal mask leaves alive.  dk and dv
//     accumulate in float32 registers and are written once.
//   - dq: one block per (bh, 64-row q tile).  It loads its q, do, lse and
//     di once and walks the alive k tiles.  Each k tile's ds @ k is summed
//     in registers and added to a float32 register accumulator, which is
//     multiplied by the softmax scale once at the end (the TPU flush).
//   No atomics and no scratch buffer: both are deterministic.
//   - 256 threads as a 16 x 16 grid; each thread computes a 4 x 4 tile of
//     s and dp (queries ty + 16 i, keys tx + 16 j) and a 4 x 4 (D = 64) or
//     4 x 8 (D = 128) tile of its output, reading float4s from shared
//     memory: about one 16-byte shared load per eight FMAs, where the fused
//     kernel's one-row-per-four-threads layout reads one float per FMA.
//   - Every sum runs in the fused kernel's order (s and dp over the head
//     columns in order; dk and dv over the queries in order; dq over a
//     tile's keys in order, then tile by tile), so dk and dv come out
//     bitwise equal to the fused kernel's and dq differs from it only in
//     the order its atomics add the tiles.
//   - q is scaled on its way into shared memory (the forward's
//     convention), so ds needs no scale and dk = ds^T (scale * q).
//   - ds = p * (dp - di).  Masked probabilities are zero by select, never
//     by multiply: a row that every key masks has lse = -1e30, where
//     exp(s - lse) is inf and inf * 0 would be NaN.  Offsets place both
//     tiles on the global axis for the mask; rows past T and columns past D
//     are masked or zero-filled here, not padded by copies.  A k tile that
//     no query sees writes zero dk and dv, a q tile that sees no key writes
//     zero dq (ring offsets give both).
//   - Causal walks are triangular: block (bh, y) takes the y-th longest
//     walk, and blocks start in order of y, so the longest walks start
//     first and the short ones fill the tail.
// Tensor cores (wgmma) and TMA are later work: float32 products would need
// 3xTF32 splitting to keep float32 accuracy on them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;       // rows of a q tile and of a k tile
constexpr int kThreads = 256;   // a 16 x 16 grid
constexpr int kPS = kTile + 4;  // row stride of the p and ds tiles

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Row stride of a [64, DPAD] tile in shared memory: a multiple of 4 floats
// (float4 reads) whose rows start 4 banks apart.
template <int DPAD>
__host__ __device__ constexpr int stride() {
  return DPAD + 4;
}

template <int DPAD>
constexpr int smem_bytes(int n_tiles, int n_ptiles) {
  return (n_tiles * kTile * stride<DPAD>() + n_ptiles * kTile * kPS +
          2 * kTile) *
         static_cast<int>(sizeof(float));
}

// Stage rows [row0, row0 + 64) of a [rows, d] matrix into dst[64][stride]
// as float32 times `mul`; rows past `rows` and columns past `d` read zero.
template <typename T, int DPAD>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0,
                                          int rows, int d, float mul) {
  for (int idx = threadIdx.x; idx < kTile * DPAD; idx += kThreads) {
    const int r = idx / DPAD;
    const int c = idx % DPAD;
    const int gr = row0 + r;
    float x = 0.f;
    if (gr < rows && c < d) x = to_float(src[(int64_t)gr * d + c]) * mul;
    dst[r * stride<DPAD>() + c] = x;
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// s[i][j] = (scale q)[ty + 16 i] . k[tx + 16 j] and dp[i][j] =
// do[ty + 16 i] . v[tx + 16 j] over the tiles in shared memory, each summed
// over the columns in order.
template <int DPAD>
__device__ __forceinline__ void scores(const float* qs, const float* dos,
                                       const float* ks, const float* vs,
                                       int ty, int tx, float (&s)[4][4],
                                       float (&dp)[4][4]) {
  constexpr int S = stride<DPAD>();
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
  for (int c = 0; c < DPAD; c += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = ld4(qs + (ty + 16 * i) * S + c);
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = ld4(ks + (tx + 16 * j) * S + c);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] += a[i].x * b[j].x;
        s[i][j] += a[i].y * b[j].y;
        s[i][j] += a[i].z * b[j].z;
        s[i][j] += a[i].w * b[j].w;
      }
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = ld4(dos + (ty + 16 * i) * S + c);
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = ld4(vs + (tx + 16 * j) * S + c);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        dp[i][j] += a[i].x * b[j].x;
        dp[i][j] += a[i].y * b[j].y;
        dp[i][j] += a[i].z * b[j].z;
        dp[i][j] += a[i].w * b[j].w;
      }
  }
}

// p = exp(s - lse) where the mask lets (query, key) through, else 0 (by
// select), and ds = p * (dp - di), for this thread's 4 x 4 pairs of the
// tiles at q0, k0; written to ps (when given) and dss as [query][key].
__device__ __forceinline__ void probs(const float (&s)[4][4],
                                      const float (&dp)[4][4],
                                      const float* lse_s, const float* di_s,
                                      float* ps, float* dss, int ty, int tx,
                                      int q0, int k0, int tq, int tk,
                                      int causal, int q_offset,
                                      int k_offset) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const bool row_ok = q0 + r < tq;
    const int qpos = q_offset + q0 + r;
    const float lse_r = lse_s[r];
    const float di_r = di_s[r];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kl = tx + 16 * j;
      const int kpos = k0 + kl;
      const bool ok = row_ok && kpos < tk &&
                      (!causal || qpos >= k_offset + kpos);
      const float p = ok ? expf(s[i][j] - lse_r) : 0.f;
      if (ps != nullptr) ps[r * kPS + kl] = p;
      dss[r * kPS + kl] = p * (dp[i][j] - di_r);
    }
  }
}

// Stage lse and di of the q tile at q0 (zero past T).
__device__ __forceinline__ void load_rows(float* lse_s, float* di_s,
                                          const float* lse, const float* di,
                                          int64_t base, int q0, int tq) {
  if (threadIdx.x < kTile) {
    const int r = q0 + threadIdx.x;
    lse_s[threadIdx.x] = r < tq ? lse[base + r] : 0.f;
    di_s[threadIdx.x] = r < tq ? di[base + r] : 0.f;
  }
}

// Whether any query of the q tile at q0 sees any key of the k tile at k0:
// its newest query on the global axis does not precede the tile's oldest
// key (uniform across the block, so no divergence at the barriers).
__device__ __forceinline__ bool alive(int causal, int q0, int k0, int tq,
                                      int q_offset, int k_offset) {
  return !causal || q_offset + min(q0 + kTile, tq) - 1 >= k_offset + k0;
}

template <typename T, int DPAD>
__global__ void __launch_bounds__(kThreads, DPAD == 64 ? 2 : 1)
fa_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ di,
                  T* __restrict__ dk, T* __restrict__ dv, int tq, int tk,
                  int d, int causal, float scale, int q_offset,
                  int k_offset) {
  extern __shared__ float4 smem4[];
  constexpr int S = stride<DPAD>();
  constexpr int M = DPAD / 64;  // float4 column groups per thread
  float* ks = reinterpret_cast<float*>(smem4);
  float* vs = ks + kTile * S;
  float* qs = vs + kTile * S;
  float* dos = qs + kTile * S;
  float* ps = dos + kTile * S;
  float* dss = ps + kTile * kPS;
  float* lse_s = dss + kTile * kPS;
  float* di_s = lse_s + kTile;

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kTile;  // y = 0: the longest causal walk
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const T* qb = q + (int64_t)bh * tq * d;
  const T* dob = dout + (int64_t)bh * tq * d;

  load_tile<T, DPAD>(ks, k + (int64_t)bh * tk * d, k0, tk, d, 1.f);
  load_tile<T, DPAD>(vs, v + (int64_t)bh * tk * d, k0, tk, d, 1.f);

  // this thread's outputs: keys ty * 4 + i, columns tx * 4 + 64 m + j
  float dk_acc[4][4 * M];
  float dv_acc[4][4 * M];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4 * M; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  const int nq = (tq + kTile - 1) / kTile;
  for (int qt = 0; qt < nq; ++qt) {
    const int q0 = qt * kTile;
    if (!alive(causal, q0, k0, tq, q_offset, k_offset)) continue;
    __syncthreads();  // readers of the previous q tile are done
    load_tile<T, DPAD>(qs, qb, q0, tq, d, scale);
    load_tile<T, DPAD>(dos, dob, q0, tq, d, 1.f);
    load_rows(lse_s, di_s, lse, di, (int64_t)bh * tq, q0, tq);
    __syncthreads();

    float s[4][4], dp[4][4];
    scores<DPAD>(qs, dos, ks, vs, ty, tx, s, dp);
    probs(s, dp, lse_s, di_s, ps, dss, ty, tx, q0, k0, tq, tk, causal,
          q_offset, k_offset);
    __syncthreads();

    // dv += p^T do and dk += ds^T (scale q), over the tile's queries in
    // order
#pragma unroll 2
    for (int r = 0; r < kTile; ++r) {
      const float4 pr = ld4(ps + r * kPS + ty * 4);
      const float4 dsr = ld4(dss + r * kPS + ty * 4);
      const float pa[4] = {pr.x, pr.y, pr.z, pr.w};
      const float da[4] = {dsr.x, dsr.y, dsr.z, dsr.w};
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const float4 o4 = ld4(dos + r * S + tx * 4 + 64 * m);
        const float4 q4 = ld4(qs + r * S + tx * 4 + 64 * m);
        const float ob[4] = {o4.x, o4.y, o4.z, o4.w};
        const float qb4[4] = {q4.x, q4.y, q4.z, q4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            dv_acc[i][4 * m + j] += pa[i] * ob[j];
            dk_acc[i][4 * m + j] += da[i] * qb4[j];
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kr = k0 + ty * 4 + i;
    if (kr >= tk) continue;
    T* dkrow = dk + ((int64_t)bh * tk + kr) * d;
    T* dvrow = dv + ((int64_t)bh * tk + kr) * d;
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx * 4 + 64 * m + j;
        if (col < d) {
          store(dkrow + col, dk_acc[i][4 * m + j]);
          store(dvrow + col, dv_acc[i][4 * m + j]);
        }
      }
  }
}

template <typename T, int DPAD>
__global__ void __launch_bounds__(kThreads, DPAD == 64 ? 2 : 1)
fa_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ di,
                 T* __restrict__ dq, int tq, int tk, int d, int causal,
                 float scale, int q_offset, int k_offset) {
  extern __shared__ float4 smem4[];
  constexpr int S = stride<DPAD>();
  constexpr int M = DPAD / 64;
  float* qs = reinterpret_cast<float*>(smem4);
  float* dos = qs + kTile * S;
  float* ks = dos + kTile * S;
  float* vs = ks + kTile * S;
  float* dss = vs + kTile * S;
  float* lse_s = dss + kTile * kPS;
  float* di_s = lse_s + kTile;

  const int bh = blockIdx.x;
  const int nq = (tq + kTile - 1) / kTile;
  // y = 0: the last q tile, the longest causal walk
  const int q0 = (nq - 1 - (int)blockIdx.y) * kTile;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const T* kb = k + (int64_t)bh * tk * d;
  const T* vb = v + (int64_t)bh * tk * d;

  load_tile<T, DPAD>(qs, q + (int64_t)bh * tq * d, q0, tq, d, scale);
  load_tile<T, DPAD>(dos, dout + (int64_t)bh * tq * d, q0, tq, d, 1.f);
  load_rows(lse_s, di_s, lse, di, (int64_t)bh * tq, q0, tq);

  // this thread's outputs: queries ty * 4 + i, columns tx * 4 + 64 m + j
  float acc[4][4 * M];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4 * M; ++j) acc[i][j] = 0.f;

  const int nk = (tk + kTile - 1) / kTile;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kTile;
    if (!alive(causal, q0, k0, tq, q_offset, k_offset)) continue;
    __syncthreads();  // readers of the previous k tile are done
    load_tile<T, DPAD>(ks, kb, k0, tk, d, 1.f);
    load_tile<T, DPAD>(vs, vb, k0, tk, d, 1.f);
    __syncthreads();

    float s[4][4], dp[4][4];
    scores<DPAD>(qs, dos, ks, vs, ty, tx, s, dp);
    probs(s, dp, lse_s, di_s, nullptr, dss, ty, tx, q0, k0, tq, tk, causal,
          q_offset, k_offset);
    __syncthreads();

    // this k tile's ds k, over its keys in order, then into the total
    float part[4][4 * M];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4 * M; ++j) part[i][j] = 0.f;
#pragma unroll 1
    for (int c = 0; c < kTile; c += 4) {
      float da[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 d4 = ld4(dss + (ty * 4 + i) * kPS + c);
        da[i][0] = d4.x;
        da[i][1] = d4.y;
        da[i][2] = d4.z;
        da[i][3] = d4.w;
      }
#pragma unroll
      for (int cc = 0; cc < 4; ++cc)
#pragma unroll
        for (int m = 0; m < M; ++m) {
          const float4 k4 = ld4(ks + (c + cc) * S + tx * 4 + 64 * m);
          const float kb4[4] = {k4.x, k4.y, k4.z, k4.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              part[i][4 * m + j] += da[i][cc] * kb4[j];
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4 * M; ++j) acc[i][j] += part[i][j];
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qr = q0 + ty * 4 + i;
    if (qr >= tq) continue;
    T* dqrow = dq + ((int64_t)bh * tq + qr) * d;
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx * 4 + 64 * m + j;
        // ds carried no scale (q was pre-scaled): fold it in once
        if (col < d) store(dqrow + col, acc[i][4 * m + j] * scale);
      }
  }
}

template <typename T, int DPAD>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* di,
                       void* dk, void* dv, int bh, int tq, int tk, int d,
                       int causal, float scale, int q_offset, int k_offset,
                       cudaStream_t stream) {
  constexpr int smem = smem_bytes<DPAD>(4, 2);
  cudaError_t err = cudaFuncSetAttribute(
      fa_bwd_dkv_kernel<T, DPAD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (tk + kTile - 1) / kTile);
  fa_bwd_dkv_kernel<T, DPAD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(di),
      static_cast<T*>(dk), static_cast<T*>(dv), tq, tk, d, causal, scale,
      q_offset, k_offset);
  return cudaGetLastError();
}

template <typename T, int DPAD>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* di,
                      void* dq, int bh, int tq, int tk, int d, int causal,
                      float scale, int q_offset, int k_offset,
                      cudaStream_t stream) {
  constexpr int smem = smem_bytes<DPAD>(4, 1);
  cudaError_t err = cudaFuncSetAttribute(
      fa_bwd_dq_kernel<T, DPAD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (tq + kTile - 1) / kTile);
  fa_bwd_dq_kernel<T, DPAD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(di),
      static_cast<T*>(dq), tq, tk, d, causal, scale, q_offset, k_offset);
  return cudaGetLastError();
}

bool bad_shape(int bh, int tq, int tk, int d) {
  return bh < 1 || tq < 1 || tk < 1 || d < 1 || d > 128 ||
         (tq + kTile - 1) / kTile > 65535 || (tk + kTile - 1) / kTile > 65535;
}

}  // namespace

extern "C" {

// q, do: contiguous [bh, tq, d]; k, v: [bh, tk, d]; float32 (is_bf16 = 0)
// or bfloat16 (is_bf16 = 1), 1 <= d <= 128, at most 65535 64-row tiles on
// each axis.  lse, di: float32 [bh, tq].  Writes dk, dv [bh, tk, d] in the
// input type on `stream`.  Returns the CUDA error of the launch (0 on
// success); does not synchronise.
int paddle_flash_attention_bwd_dkv(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* di, void* dk,
                                   void* dv, int bh, int tq, int tk, int d,
                                   int is_bf16, int causal, float scale,
                                   int q_offset, int k_offset, void* stream) {
  if (bad_shape(bh, tq, tk, d))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (is_bf16)
    err = d <= 64 ? launch_dkv<__nv_bfloat16, 64>(
                        q, k, v, dout, lse, di, dk, dv, bh, tq, tk, d,
                        causal, scale, q_offset, k_offset, s)
                  : launch_dkv<__nv_bfloat16, 128>(
                        q, k, v, dout, lse, di, dk, dv, bh, tq, tk, d,
                        causal, scale, q_offset, k_offset, s);
  else
    err = d <= 64 ? launch_dkv<float, 64>(q, k, v, dout, lse, di, dk, dv,
                                          bh, tq, tk, d, causal, scale,
                                          q_offset, k_offset, s)
                  : launch_dkv<float, 128>(q, k, v, dout, lse, di, dk, dv,
                                           bh, tq, tk, d, causal, scale,
                                           q_offset, k_offset, s);
  return static_cast<int>(err);
}

// As paddle_flash_attention_bwd_dkv; writes dq [bh, tq, d].
int paddle_flash_attention_bwd_dq(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const void* lse, const void* di, void* dq,
                                  int bh, int tq, int tk, int d, int is_bf16,
                                  int causal, float scale, int q_offset,
                                  int k_offset, void* stream) {
  if (bad_shape(bh, tq, tk, d))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (is_bf16)
    err = d <= 64 ? launch_dq<__nv_bfloat16, 64>(q, k, v, dout, lse, di, dq,
                                                 bh, tq, tk, d, causal,
                                                 scale, q_offset, k_offset, s)
                  : launch_dq<__nv_bfloat16, 128>(
                        q, k, v, dout, lse, di, dq, bh, tq, tk, d, causal,
                        scale, q_offset, k_offset, s);
  else
    err = d <= 64 ? launch_dq<float, 64>(q, k, v, dout, lse, di, dq, bh, tq,
                                         tk, d, causal, scale, q_offset,
                                         k_offset, s)
                  : launch_dq<float, 128>(q, k, v, dout, lse, di, dq, bh, tq,
                                          tk, d, causal, scale, q_offset,
                                          k_offset, s);
  return static_cast<int>(err);
}

const char* paddle_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
