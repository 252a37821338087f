// Fused GRU time loop (forward) for Hopper (sm_90a), behind a plain C
// interface.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/lstm_cell.py `_gru_kernel`
// (launched by `_gru_forward`, reached through `gru_scan`).  From h_{-1} =
// h0 (zeros when absent), per step t and batch tile of rows:
//
//   rz = x_t[:, :2H] + h_{t-1} W[:, :2H]      x_t [bt, 3H], W [H, 3H]
//   u = sigmoid(rz[:, :H]);  r = sigmoid(rz[:, H:])   (update, reset)
//   c = tanh(x_t[:, 2H:] + (r * h_{t-1}) W[:, 2H:])
//   h_t = u * h_{t-1} + (1 - u) * c
//
// and writes h_t and, for training, the post-activation gates [u, r, c]
// that the BPTT kernel (gru_bwd.cu) replays.  The reset gate multiplies
// h_{t-1} before the candidate's product (not after it, as cuDNN's GRU
// does), so each step holds two dependent products.
//
// Design.  The TPU runs its grid (batch tiles, T) in order and keeps W and
// the h carry in VMEM.  On the card one block owns a tile of R batch rows
// and walks t = 0..T-1 itself with h in shared memory (float32).  Each step
// has two product phases split by barriers: (1) every thread takes hidden
// units j and computes the update and reset pre-activations of unit j for
// all rows of the tile, streaming W's columns j and H+j from global memory
// (coalesced across threads; W stays resident in the 50 MB L2: 3 MB at
// H = 512 cannot fit one SM's shared memory) through two register buffers,
// so the next rows of W load while the current ones multiply, and reading
// h from shared memory as float4 broadcasts; it writes u and r * h to
// shared memory.  (2) the candidate's product over r * h (W's column
// 2H + j), the new h, and the outputs.
//
// What bounds it on an H100: for the seq2seq translator (T=64, B=512,
// H=512) the two products are 2*T*B*H*3H = 51.5 GFLOP of float32 FMAs,
// 0.77 ms at the card's 67 TFLOP/s, against about 0.14 ms of device-memory
// traffic.  This simple design runs only ceil(B / R) blocks, each of which
// re-streams all of W (3 MB) from L2 every step, so it is bound by one SM's
// L2 read rate and FMA rate per step and by the serial dependence over T;
// it sits well above the bound.  R is 8 or 16 (the wrapper's choice): 16
// halves the W traffic per row but leaves half the blocks (32 of 132 SMs at
// B = 512), so the per-step time per block decides, and chip_smoke.py times
// both.  8 is the choice: on an H100 80GB HBM3 at 700 W, at T=64, B=512,
// H=512, 8 rows took 6.38 ms forward and 11.17 ms backward, 16 rows 8.81 and
// 15.50 ms (chip_smoke.py, device time).  Both sit above the plain version's
// 3.98 and 8.50 ms, whose per-step cuBLAS products spread over every SM.
// The later design splits W by hidden units across a thread block
// cluster's shared memory and exchanges h through distributed shared memory
// every step.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kUnroll = 8;       // W rows per register buffer
constexpr int kMaxSmem = 232448;

__device__ __forceinline__ float sigmoid_f(float v) {
  return 1.0f / (1.0f + expf(-v));
}

// rows k..k+kUnroll-1 of NC columns j + q * H (q < NC) of W, row stride G
template <int NC>
__device__ __forceinline__ void load_w(float (&wv)[kUnroll][NC],
                                       const float* __restrict__ w, int k,
                                       int j, int H, int G) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const float* wr = w + (int64_t)(k + u) * G + j;
#pragma unroll
    for (int q = 0; q < NC; ++q) wv[u][q] = __ldg(wr + q * H);
  }
}

// acc[r][q] += sum over u of a[r][k + u] * wv[u][q]; a read from shared
// memory as float4 broadcasts (H % 4 == 0 keeps them aligned)
template <int R, int NC>
__device__ __forceinline__ void fma_chunk(float (&acc)[R][NC],
                                          const float (&wv)[kUnroll][NC],
                                          const float* a_s, int k, int H) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float* ar = a_s + r * H + k;
#pragma unroll
    for (int u = 0; u < kUnroll; u += 4) {
      const float4 v = *reinterpret_cast<const float4*>(ar + u);
      const float av[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int q = 0; q < NC; ++q)
          acc[r][q] = fmaf(av[e], wv[u + e][q], acc[r][q]);
    }
  }
}

// acc[r][q] += sum over k < H of a_s[r][k] * w[k][j + q * H]: one unit's NC
// columns for every row of the tile, W's next rows loading while the
// current ones multiply
template <int R, int NC>
__device__ __forceinline__ void row_products(float (&acc)[R][NC],
                                             const float* __restrict__ w,
                                             const float* a_s, int j, int H,
                                             int G) {
  const int kmain = H - H % kUnroll;
  float wa[kUnroll][NC], wb[kUnroll][NC];
  if (kmain > 0) load_w<NC>(wa, w, 0, j, H, G);
  for (int k = 0; k < kmain; k += 2 * kUnroll) {
    if (k + kUnroll < kmain) load_w<NC>(wb, w, k + kUnroll, j, H, G);
    fma_chunk<R, NC>(acc, wa, a_s, k, H);
    if (k + kUnroll >= kmain) break;
    if (k + 2 * kUnroll < kmain) load_w<NC>(wa, w, k + 2 * kUnroll, j, H, G);
    fma_chunk<R, NC>(acc, wb, a_s, k + kUnroll, H);
  }
  for (int k = kmain; k < H; ++k) {
    const float* wr = w + (int64_t)k * G + j;
    float wv[NC];
#pragma unroll
    for (int q = 0; q < NC; ++q) wv[q] = __ldg(wr + q * H);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float av = a_s[r * H + k];
#pragma unroll
      for (int q = 0; q < NC; ++q) acc[r][q] = fmaf(av, wv[q], acc[r][q]);
    }
  }
}

template <int R>
__global__ void __launch_bounds__(kMaxThreads)
gru_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
               const float* __restrict__ h0, float* __restrict__ hs,
               float* __restrict__ gates, int T, int B, int H) {
  extern __shared__ __align__(16) float smem[];
  const int G = 3 * H;
  float* h_s = smem;              // [R][H] the carry
  float* rh_s = h_s + R * H;      // [R][H] r * h_{t-1}
  float* u_s = rh_s + R * H;      // [R][H] the update gate
  const int b0 = blockIdx.x * R;
  const int nrow = min(R, B - b0);
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int i = tid; i < R * H; i += nt) {
    const int r = i / H;
    h_s[i] = (h0 != nullptr && r < nrow) ? h0[(int64_t)b0 * H + i] : 0.0f;
    rh_s[i] = 0.0f;
    u_s[i] = 0.0f;
  }
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const int64_t row0 = (int64_t)t * B + b0;   // first row of the tile
    // (1) the update and reset gates of this thread's units, every row
    for (int j = tid; j < H; j += nt) {
      float acc[R][2];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float* xr = x + (row0 + r) * G + j;
        acc[r][0] = r < nrow ? xr[0] : 0.0f;
        acc[r][1] = r < nrow ? xr[H] : 0.0f;
      }
      row_products<R, 2>(acc, w, h_s, j, H, G);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float u = sigmoid_f(acc[r][0]);
        const float rr = sigmoid_f(acc[r][1]);
        u_s[r * H + j] = u;
        rh_s[r * H + j] = rr * h_s[r * H + j];
        if (gates != nullptr && r < nrow) {
          float* gr = gates + (row0 + r) * G + j;
          gr[0] = u;
          gr[H] = rr;
        }
      }
    }
    __syncthreads();
    // (2) the candidate over r * h, the new carry, and the outputs; a
    // thread writes h_s only at its own units, which no other thread reads
    // in this phase
    for (int j = tid; j < H; j += nt) {
      float acc[R][1];
#pragma unroll
      for (int r = 0; r < R; ++r)
        acc[r][0] = r < nrow ? x[(row0 + r) * G + 2 * H + j] : 0.0f;
      row_products<R, 1>(acc, w + 2 * H, rh_s, j, H, G);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float c = tanhf(acc[r][0]);
        const float u = u_s[r * H + j];
        const float h = u * h_s[r * H + j] + (1.0f - u) * c;
        h_s[r * H + j] = h;
        if (r < nrow) {
          hs[(row0 + r) * H + j] = h;
          if (gates != nullptr) gates[(row0 + r) * G + 2 * H + j] = c;
        }
      }
    }
    __syncthreads();
  }
}

int threads_for(int H) {
  const int t = (H + 31) / 32 * 32;
  return t < kMaxThreads ? t : kMaxThreads;
}

size_t smem_bytes(int R, int H) { return (size_t)R * 3 * H * sizeof(float); }

template <int R>
int launch(const float* x, const float* w, const float* h0, float* hs,
           float* gates, int T, int B, int H, cudaStream_t st) {
  const size_t smem = smem_bytes(R, H);
  cudaError_t err = cudaFuncSetAttribute(
      gru_fwd_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>((B + R - 1) / R);
  gru_fwd_kernel<R><<<blocks, threads_for(H), smem, st>>>(x, w, h0, hs,
                                                          gates, T, B, H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Largest hidden width the kernel takes at `rows` batch rows per block (8
// or 16): its shared memory holds h, r * h and u of one tile, 3 * rows * H
// floats.  H must also be a multiple of 4 (h is read as float4).
int paddle_gru_fwd_max_hidden(int rows) {
  if (rows != 8 && rows != 16) return 0;
  return static_cast<int>(kMaxSmem / (rows * 3 * sizeof(float)));
}

// x [T, B, 3H] (bias added), w [H, 3H], h0 [B, H] or null for zeros:
// contiguous float32 on the device.  Writes hs [T, B, H] and, when `gates`
// is not null, gates [T, B, 3H] (u, r, c), on `stream`, with `rows` batch
// rows per block (8 or 16).  Returns the CUDA error of the launch (0 on
// success); does not synchronise.
int paddle_gru_fwd(const void* x, const void* w, const void* h0, void* hs,
                   void* gates, int T, int B, int H, int rows,
                   void* stream) {
  if (T < 1 || B < 1 || H < 1 || H % 4 != 0 ||
      H > paddle_gru_fwd_max_hidden(rows))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  const float* hf = static_cast<const float*>(h0);
  float* hsf = static_cast<float*>(hs);
  float* gf = static_cast<float*>(gates);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return rows == 8 ? launch<8>(xf, wf, hf, hsf, gf, T, B, H, st)
                   : launch<16>(xf, wf, hf, hsf, gf, T, B, H, st);
}

const char* paddle_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
