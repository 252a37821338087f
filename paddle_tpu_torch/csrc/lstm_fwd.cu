// Fused peephole-LSTM time loop (forward) for Hopper (sm_90a), behind a
// plain C interface.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/lstm_cell.py
// `_lstm_kernel` (launched by `_lstm_forward`, reached through
// `lstm_scan`).  Zero initial state; per step t, for a batch tile of rows:
//
//   g = x_t + h_{t-1} W                       x_t [bt, 4H], W [H, 4H]
//   i = sigmoid(g_i + c_{t-1} * pw_0)         gate order (i, f, cand, o)
//   f = sigmoid(g_f + c_{t-1} * pw_1)
//   cand = tanh(g_c)
//   c_t = f * c_{t-1} + i * cand
//   o = sigmoid(g_o + c_t * pw_2)
//   h_t = o * tanh(c_t)
//
// and writes h_t, c_t and, for training, the post-activation gates
// [i, f, cand, o] that the BPTT kernel (lstm_bwd.cu) replays.
//
// Design.  The TPU runs its grid (batch tiles, T) in order and keeps W and
// the (h, c) carry in VMEM.  On the card one block owns a tile of kRows
// batch rows and walks t = 0..T-1 itself, with h and c in shared memory
// (float32).  Each step has two phases split by barriers: (1) every thread
// takes hidden units j and computes the four gate pre-activations of unit
// j for all rows of the tile, streaming the four columns j, H+j, 2H+j, 3H+j
// of W from global memory (coalesced across threads; W stays resident in
// the 50 MB L2, as 1 MB at H = 256 cannot fit one SM's shared memory) into
// two register buffers, so the next rows of W load while the current ones
// multiply, and reading h from shared memory as float4 broadcasts; (2) the
// elementwise update, one (row, unit) pair per thread, writes h, c (and
// the gates) to shared and global memory.
//
// What bounds it on an H100: for the stacked-LSTM LM (T=128, B=256, H=256)
// the work is 2*T*B*H*4H = 17.2 GFLOP of float32 FMAs, 0.26 ms at the card's
// 67 TFLOP/s, against about 0.1 ms of device-memory traffic.  This simple
// design runs only ceil(B / kRows) = 32 blocks, each of which re-streams all
// of W from L2 every step, so it is bound by one SM's FMA rate and L2 read
// rate per step, and by the serial dependence over T; it sits well above
// the bound.  The later design splits W by hidden units across a thread
// block cluster's shared memory and exchanges h through distributed shared
// memory every step.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 8;         // batch rows per block
constexpr int kMaxThreads = 256;
constexpr int kUnroll = 8;       // W rows per register buffer
constexpr int kMaxSmem = 232448;

__device__ __forceinline__ float sigmoid_f(float v) {
  return 1.0f / (1.0f + expf(-v));
}

// rows k..k+kUnroll-1 of W's columns j, H+j, 2H+j, 3H+j
__device__ __forceinline__ void load_w(float (&wv)[kUnroll][4],
                                       const float* __restrict__ w, int k,
                                       int j, int H, int G) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const float* wr = w + (int64_t)(k + u) * G + j;
#pragma unroll
    for (int q = 0; q < 4; ++q) wv[u][q] = __ldg(wr + q * H);
  }
}

// acc[r][q] += sum over u of h[r][k + u] * wv[u][q]; h read from shared
// memory as float4 broadcasts (H % 4 == 0 keeps them aligned)
__device__ __forceinline__ void fma_chunk(float (&acc)[kRows][4],
                                          const float (&wv)[kUnroll][4],
                                          const float* h_s, int k, int H) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const float* hr = h_s + r * H + k;
#pragma unroll
    for (int u = 0; u < kUnroll; u += 4) {
      const float4 v = *reinterpret_cast<const float4*>(hr + u);
      const float hv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          acc[r][q] = fmaf(hv[e], wv[u + e][q], acc[r][q]);
    }
  }
}

__global__ void __launch_bounds__(kMaxThreads)
lstm_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ pw, float* __restrict__ hs,
                float* __restrict__ cs, float* __restrict__ gates, int T,
                int B, int H) {
  extern __shared__ __align__(16) float smem[];
  const int G = 4 * H;
  float* h_s = smem;                  // [kRows][H]
  float* c_s = h_s + kRows * H;       // [kRows][H]
  float* g_s = c_s + kRows * H;       // [kRows][4H]
  const int b0 = blockIdx.x * kRows;
  const int nrow = min(kRows, B - b0);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int kmain = H - H % kUnroll;
  for (int i = tid; i < kRows * H; i += nt) {
    h_s[i] = 0.0f;
    c_s[i] = 0.0f;
  }
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const int64_t row0 = (int64_t)t * B + b0;   // first row of the tile
    // (1) g = x_t + h W for this thread's units, every row of the tile;
    // W's next kUnroll rows load while the current ones multiply
    for (int j = tid; j < H; j += nt) {
      float acc[kRows][4];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float* xr = x + (row0 + r) * G + j;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          acc[r][q] = r < nrow ? xr[q * H] : 0.0f;
      }
      float wa[kUnroll][4], wb[kUnroll][4];
      if (kmain > 0) load_w(wa, w, 0, j, H, G);
      for (int k = 0; k < kmain; k += 2 * kUnroll) {
        if (k + kUnroll < kmain) load_w(wb, w, k + kUnroll, j, H, G);
        fma_chunk(acc, wa, h_s, k, H);
        if (k + kUnroll >= kmain) break;
        if (k + 2 * kUnroll < kmain) load_w(wa, w, k + 2 * kUnroll, j, H, G);
        fma_chunk(acc, wb, h_s, k + kUnroll, H);
      }
      for (int k = kmain; k < H; ++k) {
        const float* wr = w + (int64_t)k * G + j;
        float wv[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) wv[q] = __ldg(wr + q * H);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float hv = h_s[r * H + k];
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(hv, wv[q], acc[r][q]);
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
#pragma unroll
        for (int q = 0; q < 4; ++q) g_s[r * G + q * H + j] = acc[r][q];
      }
    }
    __syncthreads();
    // (2) the gates, the new carry, and the outputs
    for (int idx = tid; idx < nrow * H; idx += nt) {
      const int r = idx / H, j = idx - r * H;
      const float* g = g_s + r * G;
      const float cp = c_s[r * H + j];
      const float gi = sigmoid_f(g[j] + cp * pw[j]);
      const float gf = sigmoid_f(g[H + j] + cp * pw[H + j]);
      const float gc = tanhf(g[2 * H + j]);
      const float c = gf * cp + gi * gc;
      const float go = sigmoid_f(g[3 * H + j] + c * pw[2 * H + j]);
      const float h = go * tanhf(c);
      c_s[r * H + j] = c;
      h_s[r * H + j] = h;
      const int64_t o = (row0 + r) * H + j;
      hs[o] = h;
      cs[o] = c;
      if (gates != nullptr) {
        float* gr = gates + (row0 + r) * G + j;
        gr[0] = gi;
        gr[H] = gf;
        gr[2 * H] = gc;
        gr[3 * H] = go;
      }
    }
    __syncthreads();
  }
}

int threads_for(int H) {
  const int t = (H + 31) / 32 * 32;
  return t < kMaxThreads ? t : kMaxThreads;
}

size_t smem_bytes(int H) { return (size_t)kRows * 6 * H * sizeof(float); }

}  // namespace

extern "C" {

// Largest hidden width the kernel takes: its shared memory holds h, c and
// the gate pre-activations of one tile, 6 * kRows * H floats.  H must also
// be a multiple of 4 (h is read as float4).
int paddle_lstm_fwd_max_hidden() {
  return static_cast<int>(kMaxSmem / (kRows * 6 * sizeof(float)));
}

// x [T, B, 4H] (bias added), w [H, 4H], pw [3, H] (zeros without
// peepholes): contiguous float32 on the device.  Writes hs, cs [T, B, H]
// and, when `gates` is not null, gates [T, B, 4H], on `stream`.  Returns
// the CUDA error of the launch (0 on success); does not synchronise.
int paddle_lstm_fwd(const void* x, const void* w, const void* pw, void* hs,
                    void* cs, void* gates, int T, int B, int H,
                    void* stream) {
  if (T < 1 || B < 1 || H < 1 || H % 4 != 0 ||
      H > paddle_lstm_fwd_max_hidden())
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(H);
  cudaError_t err = cudaFuncSetAttribute(
      lstm_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>((B + kRows - 1) / kRows);
  lstm_fwd_kernel<<<blocks, threads_for(H), smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(pw), static_cast<float*>(hs),
      static_cast<float*>(cs), static_cast<float*>(gates), T, B, H);
  return static_cast<int>(cudaGetLastError());
}

const char* paddle_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
