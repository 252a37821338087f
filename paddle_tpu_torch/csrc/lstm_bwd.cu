// LSTM backward through time (BPTT) for Hopper (sm_90a), behind a plain C
// interface.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/lstm_cell.py
// `_lstm_bwd_kernel` (launched by `_lstm_backward`, the custom VJP `_bwd`).
// It replays the forward's saved post-activation gates (i, f, cand, o) and
// cells c, walking t = T-1..0 with the (dh, dc) chain:
//
//   dh  = ct_h_t + dh_carry
//   do  = dh * tanh(c_t);  dg_o = do * o * (1 - o)
//   dc  = ct_c_t + dc_carry + dh * o * (1 - tanh(c_t)^2) + dg_o * pw_2
//   dg_i = dc * cand * i * (1 - i);  dg_f = dc * c_{t-1} * f * (1 - f)
//   dg_c = dc * i * (1 - cand^2)
//   dx_t = [dg_i, dg_f, dg_c, dg_o]
//   dh_carry = dx_t W^T;  dc_carry = dc * f + dg_i * pw_0 + dg_f * pw_1
//
// and the parameter gradients dW = sum_t h_{t-1}^T dx_t, dpw_0 = sum dg_i *
// c_{t-1}, dpw_1 = sum dg_f * c_{t-1}, dpw_2 = sum dg_o * c_t over all T * B
// rows (h_{-1} = c_{-1} = 0).
//
// Design.  The TPU kernel walks its sequential grid (batch tiles, T) and
// accumulates dW and dpw across every tile in VMEM.  On the card blocks run
// in no order, so the work is three grid kernels in one call:
//   1. lstm_bptt_kernel: one block per tile of kRows batch rows walks
//      t = T-1..0 with dh and dc in shared memory.  Each step (a) computes
//      dx_t elementwise, one hidden unit per thread for every row (the
//      rows' loads issued together), writing it to global memory and to
//      shared memory, and adds the unit's dpw terms to a per-block sum in
//      shared memory; (b) carries dh = dx_t W^T with W^T streamed from
//      global memory (transposed once per call into the workspace, so the
//      loads are coalesced) into two register buffers, and dx_t read from
//      shared memory as float4 broadcasts.  Each block writes its dpw sum
//      to the workspace.
//   2. lstm_dw_kernel: dW as a tiled product over the T * B rows, 64 x 64
//      output tiles, the rows split into S contiguous ranges (one partial
//      dW per range in the workspace) so that enough blocks fill the card.
//   3. lstm_bwd_finish_kernel: dW and dpw as the sums of their partials in a
//      fixed order.  No atomics: the result is the same on every run.
//
// What bounds it on an H100: for the stacked-LSTM LM (T=128, B=256, H=256)
// the dh chain and dW are 2 * 2 * T*B*H*4H = 34.4 GFLOP of float32 FMAs,
// 0.51 ms at 67 TFLOP/s, against about 0.13 ms of device-memory traffic.
// The chain has the forward's shape (32 blocks, each re-streaming W^T from
// L2 every step, serial over T), so it is far above the bound; the dW
// product is an ordinary shared-memory tiled GEMM.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 8;         // batch rows per block of the BPTT loop
constexpr int kMaxThreads = 256;
constexpr int kUnroll = 8;
constexpr int kMaxSmem = 232448;
constexpr int kTile = 64;        // dW output tile (both sides)
constexpr int kDepth = 16;       // rows of T * B per shared-memory stage
constexpr int kTargetBlocks = 2 * 132;
constexpr int kMaxSplits = 64;

__global__ void transpose_kernel(const float* __restrict__ w,
                                 float* __restrict__ wt, int H) {
  // wt [4H, H] = w [H, 4H] transposed
  const int G = 4 * H;
  const int64_t n = (int64_t)G * H;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int64_t col = i / H, k = i - col * H;
    wt[i] = w[k * G + col];
  }
}

// acc[r] += sum over u of dg[r][n + u] * wv[u]; dg read from shared
// memory as float4 broadcasts (4H is a multiple of 4)
__device__ __forceinline__ void fma_chunk_t(float (&acc)[kRows],
                                            const float (&wv)[kUnroll],
                                            const float* dg_s, int n, int G) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const float* dr = dg_s + r * G + n;
#pragma unroll
    for (int u = 0; u < kUnroll; u += 4) {
      const float4 v = *reinterpret_cast<const float4*>(dr + u);
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

__global__ void __launch_bounds__(kMaxThreads)
lstm_bptt_kernel(const float* __restrict__ gates, const float* __restrict__ cs,
                 const float* __restrict__ ct_h,
                 const float* __restrict__ ct_c,
                 const float* __restrict__ wt, const float* __restrict__ pw,
                 float* __restrict__ dx, float* __restrict__ dpw_part, int T,
                 int B, int H) {
  extern __shared__ __align__(16) float smem[];
  const int G = 4 * H;
  float* dh_s = smem;                 // [kRows][H]
  float* dc_s = dh_s + kRows * H;     // [kRows][H]
  float* dg_s = dc_s + kRows * H;     // [kRows][4H]
  float* dpw_s = dg_s + kRows * G;    // [3][H]
  const int b0 = blockIdx.x * kRows;
  const int nrow = min(kRows, B - b0);
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int i = tid; i < kRows * H; i += nt) {
    dh_s[i] = 0.0f;
    dc_s[i] = 0.0f;
  }
  for (int i = tid; i < kRows * G; i += nt) dg_s[i] = 0.0f;
  for (int i = tid; i < 3 * H; i += nt) dpw_s[i] = 0.0f;
  __syncthreads();

  for (int t = T - 1; t >= 0; --t) {
    const int64_t row0 = (int64_t)t * B + b0;
    // (a) dx_t, the dc carry and the dpw terms; unit j is this thread's
    // for every row, so dc_s[., j] and dpw_s[., j] have one writer.  The
    // rows' global loads are issued together before any is used.
    for (int j = tid; j < H; j += nt) {
      const float p0 = pw[j], p1 = pw[H + j], p2 = pw[2 * H + j];
      float gi[kRows], gf[kRows], gc[kRows], go[kRows], c_t[kRows],
          c_p[kRows], cth[kRows], ctc[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const bool live = r < nrow;
        const int64_t m = row0 + r;
        const float* gr = gates + m * G + j;
        gi[r] = live ? gr[0] : 0.0f;
        gf[r] = live ? gr[H] : 0.0f;
        gc[r] = live ? gr[2 * H] : 0.0f;
        go[r] = live ? gr[3 * H] : 0.0f;
        c_t[r] = live ? cs[m * H + j] : 0.0f;
        c_p[r] = live && t > 0 ? cs[(m - B) * H + j] : 0.0f;
        cth[r] = live && ct_h != nullptr ? ct_h[m * H + j] : 0.0f;
        ctc[r] = live && ct_c != nullptr ? ct_c[m * H + j] : 0.0f;
      }
      float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r >= nrow) break;
        const int64_t m = row0 + r;
        const float dh = cth[r] + dh_s[r * H + j];
        const float tc = tanhf(c_t[r]);
        const float dgo = dh * tc * go[r] * (1.0f - go[r]);
        const float dc = ctc[r] + dc_s[r * H + j] +
                         dh * go[r] * (1.0f - tc * tc) + dgo * p2;
        const float dgi = dc * gc[r] * gi[r] * (1.0f - gi[r]);
        const float dgf = dc * c_p[r] * gf[r] * (1.0f - gf[r]);
        const float dgc = dc * gi[r] * (1.0f - gc[r] * gc[r]);
        float* dxr = dx + m * G + j;
        dxr[0] = dgi;
        dxr[H] = dgf;
        dxr[2 * H] = dgc;
        dxr[3 * H] = dgo;
        float* dgr = dg_s + r * G + j;
        dgr[0] = dgi;
        dgr[H] = dgf;
        dgr[2 * H] = dgc;
        dgr[3 * H] = dgo;
        dc_s[r * H + j] = dc * gf[r] + dgi * p0 + dgf * p1;
        a0 += dgi * c_p[r];
        a1 += dgf * c_p[r];
        a2 += dgo * c_t[r];
      }
      dpw_s[j] += a0;
      dpw_s[H + j] += a1;
      dpw_s[2 * H + j] += a2;
    }
    __syncthreads();
    // (b) dh carry = dx_t W^T: output unit k for every row; W^T's next
    // kUnroll rows load while the current ones multiply
    for (int k = tid; k < H; k += nt) {
      float acc[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
      float wa[kUnroll], wb[kUnroll];
      load_wt(wa, wt, 0, k, H);
      for (int n = 0; n < G; n += 2 * kUnroll) {
        // G = 4H is a multiple of 2 * kUnroll when H % 4 == 0, which the
        // launcher checks
        load_wt(wb, wt, n + kUnroll, k, H);
        fma_chunk_t(acc, wa, dg_s, n, G);
        if (n + 2 * kUnroll < G) load_wt(wa, wt, n + 2 * kUnroll, k, H);
        fma_chunk_t(acc, wb, dg_s, n + kUnroll, G);
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) dh_s[r * H + k] = acc[r];
    }
    __syncthreads();
  }
  float* out = dpw_part + (int64_t)blockIdx.x * 3 * H;
  for (int i = tid; i < 3 * H; i += nt) out[i] = dpw_s[i];
}

// One 64 x 64 tile of a partial dW = sum over rows m in this block's range
// of h_prev[m]^T dx[m], h_prev[m] = hs[m - B] (zero for the first B rows).
// 256 threads, 4 x 4 outputs each.
__global__ void __launch_bounds__(256)
lstm_dw_kernel(const float* __restrict__ hs, const float* __restrict__ dx,
               float* __restrict__ dw_part, int64_t M, int64_t chunk, int B,
               int H) {
  __shared__ float a_s[kDepth][kTile];   // h_prev rows, columns k
  __shared__ float b_s[kDepth][kTile];   // dx rows, columns n
  const int G = 4 * H;
  const int n0 = blockIdx.x * kTile, k0 = blockIdx.y * kTile;
  const int64_t m_begin = blockIdx.z * chunk;
  const int64_t m_end = min(M, m_begin + chunk);
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.0f;

  for (int64_t m0 = m_begin; m0 < m_end; m0 += kDepth) {
    // 16 x 64 of each operand, 4 loads per thread, coalesced along columns
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      const int e = tid + l * 256;
      const int rr = e / kTile, cc = e % kTile;
      const int64_t m = m0 + rr;
      const bool live = m < m_end;
      const int k = k0 + cc, n = n0 + cc;
      a_s[rr][cc] = (live && m >= B && k < H) ? hs[(m - B) * H + k] : 0.0f;
      b_s[rr][cc] = (live && n < G) ? dx[m * G + n] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int d = 0; d < kDepth; ++d) {
      float av[4], bv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) av[a] = a_s[d][ty * 4 + a];
#pragma unroll
      for (int b = 0; b < 4; ++b) bv[b] = b_s[d][tx * 4 + b];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(av[a], bv[b], acc[a][b]);
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

// dw = sum of the S partials, dpw = sum of the per-block partials, each in
// index order.
__global__ void lstm_bwd_finish_kernel(const float* __restrict__ dw_part,
                                       const float* __restrict__ dpw_part,
                                       float* __restrict__ dw,
                                       float* __restrict__ dpw, int splits,
                                       int nblocks, int H) {
  const int64_t n_dw = (int64_t)H * 4 * H, n = n_dw + 3 * H;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    float s = 0.0f;
    if (i < n_dw) {
      for (int z = 0; z < splits; ++z) s += dw_part[z * n_dw + i];
      dw[i] = s;
    } else {
      const int64_t j = i - n_dw;
      for (int b = 0; b < nblocks; ++b) s += dpw_part[b * 3 * (int64_t)H + j];
      dpw[j] = s;
    }
  }
}

struct Plan {
  int nblocks;      // BPTT blocks
  int splits;       // dW row ranges
  int64_t chunk;    // rows per range
  int64_t wt_off, dw_off, dpw_off, floats;
};

Plan plan_for(int T, int B, int H) {
  Plan p;
  const int64_t G = 4 * (int64_t)H, M = (int64_t)T * B;
  p.nblocks = (B + kRows - 1) / kRows;
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
  p.dpw_off = p.dw_off + (int64_t)p.splits * G * H;
  p.floats = p.dpw_off + (int64_t)p.nblocks * 3 * H;
  return p;
}

int threads_for(int H) {
  const int t = (H + 31) / 32 * 32;
  return t < kMaxThreads ? t : kMaxThreads;
}

size_t smem_bytes(int H) {
  return (size_t)(kRows * 6 * H + 3 * H) * sizeof(float);
}

}  // namespace

extern "C" {

// Largest hidden width the BPTT kernel takes (its shared memory holds the
// dh and dc carry, one step's dx and the dpw sums); H must also be a
// multiple of 4.
int paddle_lstm_bwd_max_hidden() {
  return static_cast<int>(kMaxSmem / ((kRows * 6 + 3) * sizeof(float)));
}

// Bytes of device workspace paddle_lstm_bwd needs for (T, B, H): W^T, the
// partial dW of each row range and the dpw sum of each BPTT block.
int64_t paddle_lstm_bwd_workspace_bytes(int T, int B, int H) {
  if (T < 1 || B < 1 || H < 1) return 0;
  return plan_for(T, B, H).floats * (int64_t)sizeof(float);
}

// gates [T, B, 4H] (i, f, cand, o after activation), hs, cs [T, B, H] (the
// forward's outputs), ct_h, ct_c [T, B, H] (cotangents of hs and cs; null
// means zeros), w [H, 4H], pw [3, H]: contiguous float32 on the device.
// Writes dx [T, B, 4H], dw [H, 4H], dpw [3, H]; `workspace` holds
// paddle_lstm_bwd_workspace_bytes(T, B, H) bytes.  Four launches on
// `stream` (transpose, BPTT loop, dW tiles, finish); returns the first CUDA
// error (0 on success); does not synchronise.
int paddle_lstm_bwd(const void* gates, const void* hs, const void* cs,
                    const void* ct_h, const void* ct_c, const void* w,
                    const void* pw, void* dx, void* dw, void* dpw,
                    void* workspace, int T, int B, int H, void* stream) {
  if (T < 1 || B < 1 || H < 1 || H % 4 != 0 ||
      H > paddle_lstm_bwd_max_hidden())
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Plan p = plan_for(T, B, H);
  float* ws = static_cast<float*>(workspace);
  float* wt = ws + p.wt_off;
  float* dw_part = ws + p.dw_off;
  float* dpw_part = ws + p.dpw_off;
  const int64_t G = 4 * (int64_t)H;

  transpose_kernel<<<static_cast<unsigned>((G * H + 255) / 256 < 4096
                                               ? (G * H + 255) / 256
                                               : 4096),
                     256, 0, st>>>(static_cast<const float*>(w), wt, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t smem = smem_bytes(H);
  err = cudaFuncSetAttribute(lstm_bptt_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  lstm_bptt_kernel<<<static_cast<unsigned>(p.nblocks), threads_for(H), smem,
                     st>>>(
      static_cast<const float*>(gates), static_cast<const float*>(cs),
      static_cast<const float*>(ct_h), static_cast<const float*>(ct_c), wt,
      static_cast<const float*>(pw), static_cast<float*>(dx), dpw_part, T, B,
      H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const dim3 grid(static_cast<unsigned>((G + kTile - 1) / kTile),
                  static_cast<unsigned>((H + kTile - 1) / kTile),
                  static_cast<unsigned>(p.splits));
  lstm_dw_kernel<<<grid, 256, 0, st>>>(
      static_cast<const float*>(hs), static_cast<const float*>(dx), dw_part,
      (int64_t)T * B, p.chunk, B, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int64_t n = G * H + 3 * H;
  lstm_bwd_finish_kernel<<<static_cast<unsigned>((n + 255) / 256 < 4096
                                                     ? (n + 255) / 256
                                                     : 4096),
                           256, 0, st>>>(dw_part, dpw_part,
                                         static_cast<float*>(dw),
                                         static_cast<float*>(dpw), p.splits,
                                         p.nblocks, H);
  return static_cast<int>(cudaGetLastError());
}

const char* paddle_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
