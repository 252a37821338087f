// GRU backward through time (BPTT) for Hopper (sm_90a), behind a plain C
// interface.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/lstm_cell.py
// `_gru_bwd_kernel` (launched by `_gru_backward`, the custom VJP `_gru_bwd`).
// It replays the forward's saved post-activation gates (u, r, c) and the
// outputs h, walking t = T-1..0 with the dh chain (h_prev = h_{t-1}, h0 at
// t = 0):
//
//   dh    = ct_h_t + dh_carry
//   du    = dh * (h_prev - c);        dc = dh * (1 - u)
//   dc_pre = dc * (1 - c^2)
//   drh   = dc_pre W_c^T              (the gradient of r * h_prev)
//   du_pre = du * u * (1 - u);        dr_pre = drh * h_prev * r * (1 - r)
//   dx_t  = [du_pre, dr_pre, dc_pre]
//   dh_carry = dh * u + drh * r + [du_pre, dr_pre] W_rz^T
//
// with W_rz = W[:, :2H] and W_c = W[:, 2H:], and the parameter gradients
// dW[:, :2H] = sum_t h_prev^T [du_pre, dr_pre] and dW[:, 2H:] =
// sum_t (r * h_prev)^T dc_pre over all T * B rows; dh0 is the final carry.
//
// Design.  The TPU kernel walks its sequential grid (batch tiles, T) and
// accumulates dW across every tile in VMEM.  On the card blocks run in no
// order, so the work is four grid kernels in one call:
//   1. transpose_kernel: W^T [3H, H] into the workspace, so that the
//      products below stream it coalesced.
//   2. gru_bptt_kernel: one block per tile of R batch rows walks
//      t = T-1..0 with the dh carry in shared memory.  Each step has three
//      phases split by barriers: (a) the elementwise terms that need no
//      product (du_pre, dc_pre), one hidden unit per thread for every row,
//      written to dx and to shared memory; (b) drh = dc_pre W_c^T with
//      W_c^T streamed from L2 through two register buffers and dc_pre read
//      from shared memory as float4 broadcasts, then dr_pre and the
//      carry's elementwise part; (c) the carry's product [du_pre, dr_pre]
//      W_rz^T.  After t = 0 the carry is dh0.
//   3. gru_dw_kernel: dW as a tiled product over the T * B rows, 64 x 64
//      output tiles, the rows split into S contiguous ranges (one partial
//      dW per range in the workspace) so that enough blocks fill the card;
//      h_prev is h0 (or zero) for the first B rows and hs[m - B] after, and
//      the candidate's columns multiply r * h_prev instead.
//   4. gru_dw_finish_kernel: dW as the sum of its partials in a fixed
//      order.  No atomics: the result is the same on every run.
//
// What bounds it on an H100: for the seq2seq translator (T=64, B=512,
// H=512) the dh chain and dW are 2 * 2 * T*B*H*3H = 103 GFLOP of float32
// FMAs, 1.54 ms at 67 TFLOP/s, against about 0.16 ms of device-memory
// traffic.  The chain has the forward's shape (B / R blocks, each
// re-streaming W^T from L2 every step, serial over T), so it is far above
// the bound; the dW product is an ordinary shared-memory tiled GEMM.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kUnroll = 8;
constexpr int kMaxSmem = 232448;
constexpr int kTile = 64;        // dW output tile (both sides)
constexpr int kDepth = 16;       // rows of T * B per shared-memory stage
constexpr int kTargetBlocks = 2 * 132;
constexpr int kMaxSplits = 64;

__global__ void transpose_kernel(const float* __restrict__ w,
                                 float* __restrict__ wt, int H) {
  // wt [3H, H] = w [H, 3H] transposed
  const int G = 3 * H;
  const int64_t n = (int64_t)G * H;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int64_t col = i / H, k = i - col * H;
    wt[i] = w[k * G + col];
  }
}

template <int R>
__device__ __forceinline__ void fma_chunk_t(float (&acc)[R],
                                            const float (&wv)[kUnroll],
                                            const float* a_s, int n,
                                            int lda) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float* ar = a_s + r * lda + n;
#pragma unroll
    for (int u = 0; u < kUnroll; u += 4) {
      const float4 v = *reinterpret_cast<const float4*>(ar + u);
      acc[r] = fmaf(v.x, wv[u], acc[r]);
      acc[r] = fmaf(v.y, wv[u + 1], acc[r]);
      acc[r] = fmaf(v.z, wv[u + 2], acc[r]);
      acc[r] = fmaf(v.w, wv[u + 3], acc[r]);
    }
  }
}

__device__ __forceinline__ void load_wt(float (&wv)[kUnroll],
                                        const float* __restrict__ wt, int n,
                                        int k, int H) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u)
    wv[u] = __ldg(wt + (int64_t)(n + u) * H + k);
}

// acc[r] += sum over n < N of a_s[r][n] * wt[n][k] (a_s row stride lda, a
// multiple of 4; wt row stride H); W^T's next rows load while the current
// ones multiply
template <int R>
__device__ __forceinline__ void col_products(float (&acc)[R],
                                             const float* __restrict__ wt,
                                             const float* a_s, int lda, int N,
                                             int k, int H) {
  const int nmain = N - N % (2 * kUnroll);
  float wa[kUnroll], wb[kUnroll];
  if (nmain > 0) load_wt(wa, wt, 0, k, H);
  for (int n = 0; n < nmain; n += 2 * kUnroll) {
    load_wt(wb, wt, n + kUnroll, k, H);
    fma_chunk_t<R>(acc, wa, a_s, n, lda);
    if (n + 2 * kUnroll < nmain) load_wt(wa, wt, n + 2 * kUnroll, k, H);
    fma_chunk_t<R>(acc, wb, a_s, n + kUnroll, lda);
  }
  for (int n = nmain; n < N; ++n) {
    const float wv = __ldg(wt + (int64_t)n * H + k);
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = fmaf(a_s[r * lda + n], wv, acc[r]);
  }
}

__device__ __forceinline__ float h_prev_at(const float* __restrict__ hs,
                                           const float* __restrict__ h0,
                                           int64_t m, int B, int H, int j) {
  // h_{t-1} of row m = t * B + b: hs[m - B], or h0 (zeros when null) at t = 0
  if (m >= B) return hs[(m - B) * H + j];
  return h0 != nullptr ? h0[m * H + j] : 0.0f;
}

template <int R>
__global__ void __launch_bounds__(kMaxThreads)
gru_bptt_kernel(const float* __restrict__ gates, const float* __restrict__ hs,
                const float* __restrict__ h0, const float* __restrict__ ct_h,
                const float* __restrict__ wt, float* __restrict__ dx,
                float* __restrict__ dh0, int T, int B, int H) {
  extern __shared__ __align__(16) float smem[];
  const int G = 3 * H;
  float* dh_s = smem;             // [R][H] the carry (dh in phase b)
  float* dcp_s = dh_s + R * H;    // [R][H] dc_pre
  float* dg_s = dcp_s + R * H;    // [R][2H] [du_pre, dr_pre]
  const int b0 = blockIdx.x * R;
  const int nrow = min(R, B - b0);
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int i = tid; i < 4 * R * H; i += nt) smem[i] = 0.0f;
  __syncthreads();

  for (int t = T - 1; t >= 0; --t) {
    const int64_t row0 = (int64_t)t * B + b0;
    // (a) du_pre and dc_pre; unit j is this thread's for every row in all
    // three phases, so dh_s[., j] has one writer.  The rows' loads are
    // issued together before any is used.
    for (int j = tid; j < H; j += nt) {
      float u[R], c[R], hp[R], ct[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const bool live = r < nrow;
        const int64_t m = row0 + r;
        u[r] = live ? gates[m * G + j] : 0.0f;
        c[r] = live ? gates[m * G + 2 * H + j] : 0.0f;
        hp[r] = live ? h_prev_at(hs, h0, m, B, H, j) : 0.0f;
        ct[r] = live && ct_h != nullptr ? ct_h[m * H + j] : 0.0f;
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r >= nrow) break;
        const int64_t m = row0 + r;
        const float dh = ct[r] + dh_s[r * H + j];
        const float du = dh * (hp[r] - c[r]);
        const float dc = dh * (1.0f - u[r]);
        const float dcp = dc * (1.0f - c[r] * c[r]);
        const float dup = du * u[r] * (1.0f - u[r]);
        dh_s[r * H + j] = dh;
        dcp_s[r * H + j] = dcp;
        dg_s[r * 2 * H + j] = dup;
        dx[m * G + j] = dup;
        dx[m * G + 2 * H + j] = dcp;
      }
    }
    __syncthreads();
    // (b) drh = dc_pre W_c^T, then dr_pre and dh * u + drh * r
    for (int k = tid; k < H; k += nt) {
      float acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = 0.0f;
      col_products<R>(acc, wt + (int64_t)2 * H * H, dcp_s, H, H, k, H);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r >= nrow) break;
        const int64_t m = row0 + r;
        const float rr = gates[m * G + H + k];
        const float u = gates[m * G + k];
        const float hp = h_prev_at(hs, h0, m, B, H, k);
        const float drh = acc[r];
        const float drp = drh * hp * rr * (1.0f - rr);
        dg_s[r * 2 * H + H + k] = drp;
        dx[m * G + H + k] = drp;
        dh_s[r * H + k] = dh_s[r * H + k] * u + drh * rr;
      }
    }
    __syncthreads();
    // (c) the carry: dh * u + drh * r + [du_pre, dr_pre] W_rz^T
    for (int k = tid; k < H; k += nt) {
      float acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = r < nrow ? dh_s[r * H + k] : 0.0f;
      col_products<R>(acc, wt, dg_s, 2 * H, 2 * H, k, H);
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (r < nrow) dh_s[r * H + k] = acc[r];
    }
    __syncthreads();
  }
  if (dh0 != nullptr)
    for (int i = tid; i < nrow * H; i += nt)
      dh0[(int64_t)b0 * H + i] = dh_s[i];
}

// One 64 x 64 tile of a partial dW = sum over rows m in this block's range
// of a[m]^T dx[m], a[m] = h_prev[m] for the update and reset columns
// (n < 2H) and r[m] * h_prev[m] for the candidate's.  256 threads, 4 x 4
// outputs each.
__global__ void __launch_bounds__(256)
gru_dw_kernel(const float* __restrict__ hs, const float* __restrict__ h0,
              const float* __restrict__ gates, const float* __restrict__ dx,
              float* __restrict__ dw_part, int64_t M, int64_t chunk, int B,
              int H) {
  __shared__ float a_s[kDepth][kTile];    // h_prev rows, columns k
  __shared__ float ar_s[kDepth][kTile];   // r * h_prev rows, columns k
  __shared__ float b_s[kDepth][kTile];    // dx rows, columns n
  const int G = 3 * H;
  const int n0 = blockIdx.x * kTile, k0 = blockIdx.y * kTile;
  const int64_t m_begin = blockIdx.z * chunk;
  const int64_t m_end = min(M, m_begin + chunk);
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  bool cand[4];
#pragma unroll
  for (int b = 0; b < 4; ++b) cand[b] = n0 + tx * 4 + b >= 2 * H;
  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.0f;

  for (int64_t m0 = m_begin; m0 < m_end; m0 += kDepth) {
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      const int e = tid + l * 256;
      const int rr = e / kTile, cc = e % kTile;
      const int64_t m = m0 + rr;
      const bool live = m < m_end;
      const int k = k0 + cc, n = n0 + cc;
      const float hp = (live && k < H) ? h_prev_at(hs, h0, m, B, H, k) : 0.0f;
      a_s[rr][cc] = hp;
      ar_s[rr][cc] = (live && k < H) ? hp * gates[m * G + H + k] : 0.0f;
      b_s[rr][cc] = (live && n < G) ? dx[m * G + n] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int d = 0; d < kDepth; ++d) {
      float av[4], arv[4], bv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        av[a] = a_s[d][ty * 4 + a];
        arv[a] = ar_s[d][ty * 4 + a];
      }
#pragma unroll
      for (int b = 0; b < 4; ++b) bv[b] = b_s[d][tx * 4 + b];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b)
          acc[a][b] = fmaf(cand[b] ? arv[a] : av[a], bv[b], acc[a][b]);
    }
    __syncthreads();
  }
  float* out = dw_part + (int64_t)blockIdx.z * H * G;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int k = k0 + ty * 4 + a;
    if (k >= H) continue;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int n = n0 + tx * 4 + b;
      if (n < G) out[(int64_t)k * G + n] = acc[a][b];
    }
  }
}

// dw = the sum of the S partials, in index order
__global__ void gru_dw_finish_kernel(const float* __restrict__ dw_part,
                                     float* __restrict__ dw, int splits,
                                     int H) {
  const int64_t n = (int64_t)H * 3 * H;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    float s = 0.0f;
    for (int z = 0; z < splits; ++z) s += dw_part[z * n + i];
    dw[i] = s;
  }
}

struct Plan {
  int splits;       // dW row ranges
  int64_t chunk;    // rows per range
  int64_t wt_off, dw_off, floats;
};

Plan plan_for(int T, int B, int H) {
  Plan p;
  const int64_t G = 3 * (int64_t)H, M = (int64_t)T * B;
  const int64_t tiles = ((G + kTile - 1) / kTile) * ((H + kTile - 1) / kTile);
  int64_t s = (kTargetBlocks + tiles - 1) / tiles;
  const int64_t stages = (M + kDepth - 1) / kDepth;
  if (s > stages) s = stages;
  if (s > kMaxSplits) s = kMaxSplits;
  if (s < 1) s = 1;
  p.chunk = ((stages + s - 1) / s) * kDepth;
  p.splits = static_cast<int>((M + p.chunk - 1) / p.chunk);
  p.wt_off = 0;
  p.dw_off = G * H;
  p.floats = p.dw_off + (int64_t)p.splits * G * H;
  return p;
}

int threads_for(int H) {
  const int t = (H + 31) / 32 * 32;
  return t < kMaxThreads ? t : kMaxThreads;
}

size_t smem_bytes(int R, int H) { return (size_t)R * 4 * H * sizeof(float); }

unsigned grid_1d(int64_t n) {
  const int64_t b = (n + 255) / 256;
  return static_cast<unsigned>(b < 4096 ? b : 4096);
}

template <int R>
int launch_bptt(const float* gates, const float* hs, const float* h0,
                const float* ct_h, const float* wt, float* dx, float* dh0,
                int T, int B, int H, cudaStream_t st) {
  const size_t smem = smem_bytes(R, H);
  cudaError_t err = cudaFuncSetAttribute(
      gru_bptt_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  gru_bptt_kernel<R><<<static_cast<unsigned>((B + R - 1) / R),
                       threads_for(H), smem, st>>>(gates, hs, h0, ct_h, wt,
                                                   dx, dh0, T, B, H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Largest hidden width the BPTT kernel takes at `rows` batch rows per block
// (8 or 16): its shared memory holds the carry, dc_pre and [du_pre,
// dr_pre] of one tile, 4 * rows * H floats.  H must also be a multiple of
// 4.
int paddle_gru_bwd_max_hidden(int rows) {
  if (rows != 8 && rows != 16) return 0;
  return static_cast<int>(kMaxSmem / (rows * 4 * sizeof(float)));
}

// Bytes of device workspace paddle_gru_bwd needs for (T, B, H): W^T and
// the partial dW of each row range.
int64_t paddle_gru_bwd_workspace_bytes(int T, int B, int H) {
  if (T < 1 || B < 1 || H < 1) return 0;
  return plan_for(T, B, H).floats * (int64_t)sizeof(float);
}

// gates [T, B, 3H] (u, r, c after activation), hs [T, B, H] (the forward's
// outputs), h0 [B, H] (null for zeros), ct_h [T, B, H] (the cotangent of
// hs; null for zeros), w [H, 3H]: contiguous float32 on the device.  Writes
// dx [T, B, 3H], dw [H, 3H] and, when `dh0` is not null, dh0 [B, H];
// `workspace` holds paddle_gru_bwd_workspace_bytes(T, B, H) bytes; `rows`
// is 8 or 16.  Four launches on `stream` (transpose, BPTT loop, dW tiles,
// finish); returns the first CUDA error (0 on success); does not
// synchronise.
int paddle_gru_bwd(const void* gates, const void* hs, const void* h0,
                   const void* ct_h, const void* w, void* dx, void* dw,
                   void* dh0, void* workspace, int T, int B, int H, int rows,
                   void* stream) {
  if (T < 1 || B < 1 || H < 1 || H % 4 != 0 ||
      H > paddle_gru_bwd_max_hidden(rows))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Plan p = plan_for(T, B, H);
  float* ws = static_cast<float*>(workspace);
  float* wt = ws + p.wt_off;
  float* dw_part = ws + p.dw_off;
  const int64_t G = 3 * (int64_t)H;
  const float* gf = static_cast<const float*>(gates);
  const float* hsf = static_cast<const float*>(hs);
  const float* h0f = static_cast<const float*>(h0);
  float* dxf = static_cast<float*>(dx);

  transpose_kernel<<<grid_1d(G * H), 256, 0, st>>>(
      static_cast<const float*>(w), wt, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int e = rows == 8
      ? launch_bptt<8>(gf, hsf, h0f, static_cast<const float*>(ct_h), wt,
                       dxf, static_cast<float*>(dh0), T, B, H, st)
      : launch_bptt<16>(gf, hsf, h0f, static_cast<const float*>(ct_h), wt,
                        dxf, static_cast<float*>(dh0), T, B, H, st);
  if (e != 0) return e;

  const dim3 grid(static_cast<unsigned>((G + kTile - 1) / kTile),
                  static_cast<unsigned>((H + kTile - 1) / kTile),
                  static_cast<unsigned>(p.splits));
  gru_dw_kernel<<<grid, 256, 0, st>>>(hsf, h0f, gf, dxf, dw_part,
                                      (int64_t)T * B, p.chunk, B, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  gru_dw_finish_kernel<<<grid_1d(G * H), 256, 0, st>>>(
      dw_part, static_cast<float*>(dw), p.splits, H);
  return static_cast<int>(cudaGetLastError());
}

const char* paddle_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
