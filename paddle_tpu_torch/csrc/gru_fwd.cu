// Fused GRU time loop (forward) for Hopper (sm_90a), behind a plain C
// interface.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/lstm_cell.py `_gru_kernel`
// (launched by `_gru_forward`, reached through `gru_scan`).  From h_{-1} =
// h0 (zeros when absent), per step t and batch row:
//
//   rz = x_t[:, :2H] + h_{t-1} W[:, :2H]      x_t [B, 3H], W [H, 3H]
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
// the h carry in VMEM.  On the card the time loop runs on one of two
// paths, by a rule on H decided before any launch (no fallback):
//   - H <= 512 (gru_cluster::kMaxHidden): `gru_fwd_chain_kernel`, one
//     persistent thread-block cluster of ceil(H / 32) blocks per tile of
//     16 * mt batch rows, on the engine of gru_cluster.cuh that the BPTT
//     chain uses.  Block `rank` keeps W's columns of its 32 units for all
//     three gates in shared memory for all T steps (transposed: at H = 512,
//     197,120 bytes of its 232,448).  A step has two cluster barriers:
//     (a) the update and reset pre-activations of the own units over every
//     block's h_{t-1} slice (a walk of the slices for each), then x_t
//     (read while the warp pair meets), u and r; r * h_{t-1} into the
//     block's slice; (b) the candidate's product over every block's r * h
//     slice, c, h_t (the register carry) into hs, the gates and the h
//     slice.  Products in 3xTF32 on the tensor cores
//     (kChainOnTensorCores); peers' slices read from their copies in L2
//     (kSlicesThroughL2: DSMEM at cluster size 16 is bound by the SM-to-SM
//     network, PERF.md).  mt is sized from the clusters the card runs at
//     once: on an H100 7 clusters of 16 blocks, so B = 512 takes 7
//     clusters of 80 rows on 112 SMs.
//   - wider H: no cluster holds W, so `gru_fwd_kernel` (the row-tiled
//     loop): one block per R = 8 or 16 batch rows walks T with h in shared
//     memory; each thread takes hidden units j and computes their
//     pre-activations for all R rows, streaming W's columns from L2 every
//     step through two register buffers.  Its shared memory (h, r * h and
//     u of one tile) caps H at paddle_gru_fwd_max_hidden(rows).  8 rows is
//     the wrapper's choice: 16 halves the W traffic per row but leaves half
//     the blocks.
//
// What bounds it on an H100: for the seq2seq translator (T=64, B=512,
// H=512) the two products are 2*T*B*H*3H = 51.5 GFLOP, 0.31 ms at
// 3xTF32's 165 TFLOP/s (0.77 ms on the CUDA cores), against about 0.14 ms
// of device-memory traffic.  The cluster chain is serial over T with two
// cluster barriers a step, and its products run at 16 rows x 32 units a
// warp, where the 3xTF32 splits and the B fragments' loads sit beside each
// product; the row-tiled loop (8 rows: 6.38 ms at this shape, PERF.md)
// runs only ceil(B / R) blocks, each re-streaming all of W every step.

#include <cuda_runtime.h>
#include <stdint.h>

#include "gru_cluster.cuh"

namespace {

namespace cg = cooperative_groups;
namespace gc = gru_cluster;

// the cluster chain's products on the tensor cores (3xTF32) or the CUDA
// cores; its 3xTF32 split (gru_cluster.cuh split_tf32); peers' slices read
// from L2 or through DSMEM (gru_cluster.cuh slice_products); phase (a)'s
// two products on a walk of the slices each or (kSharedA) on one walk that
// loads and splits each A fragment once, which at the 168 registers a
// thread that 10 warps leave spills.  The alternatives are
// ops/kernels/gru_fwd_probe.py's comparisons.
constexpr bool kChainOnTensorCores = true;
constexpr int kChainSplit = 0;
constexpr bool kSlicesThroughL2 = true;
constexpr bool kSharedA = false;
// where a step's x is read: after phase (a)'s products, while the pair
// meets, or (true: the probe's comparison) a step ahead, during phase (b),
// which keeps 24 more floats live over (b)'s products and spills
constexpr bool kPrefetchX = false;
// slice buffers of the cluster chain: h_{t-1}, r * h_{t-1}
constexpr int kChainSlices = 2;
// W's parts (update, reset, candidate)
constexpr int kParts = 3;

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

// Step t's gate inputs of this thread's 8 (row, unit) pairs: pair q = nt2
// * 4 + ri * 2 + e is row b[ri], unit j[nt2] + e (the C fragment's element
// ri * 2 + e of n-tile 2 * half + nt2); zeros for rows past B, units past H
struct StepX {
  float u[8], r[8], c[8];
};

__device__ __forceinline__ float2 ld2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}

__device__ __forceinline__ void load_x(StepX& in, const float* __restrict__ x,
                                       int t, int B, int H,
                                       const int (&b)[2], const int (&j)[2]) {
  const float2 z = make_float2(0.f, 0.f);
#pragma unroll
  for (int nt2 = 0; nt2 < 2; ++nt2)
#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      float2 u = z, r = z, c = z;
      if (b[ri] < B && j[nt2] < H) {
        const float* xm = x + ((int64_t)t * B + b[ri]) * 3 * H + j[nt2];
        u = ld2(xm);
        r = ld2(xm + H);
        c = ld2(xm + 2 * H);
      }
      const int q = nt2 * 4 + ri * 2;
      in.u[q] = u.x; in.u[q + 1] = u.y;
      in.r[q] = r.x; in.r[q + 1] = r.y;
      in.c[q] = c.x; in.c[q + 1] = c.y;
    }
}

// The time loop on one cluster of cs = ceil(H / 32) blocks over batch rows
// b0 .. b0 + 16 mt - 1 (b0 = 16 mt * cluster index), 64 * mt threads a
// block (warp = (m-tile, K half)); gru_cluster.cuh has the layout.  Rows
// past B and units past H hold zeros in the carry and the slices (x and h0
// read as zeros there, and h_t masked), so no NaN of unwritten memory
// reaches a product.
template <bool kTC>
__global__ void __launch_bounds__(gc::kMaxThreads, 1)
gru_fwd_chain_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ h0, float* __restrict__ hs,
                     float* __restrict__ gates, float* __restrict__ slices,
                     int T, int B, int H, int mt) {
  extern __shared__ __align__(16) float smem[];
  const int cs = gc::cluster_blocks(H);
  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  const int hpad = gc::kUnits * cs, ldw = gc::w_stride<kParts>(cs);
  const int sf = gc::slice_floats(mt);
  float* w_s = smem;
  float* h_s = w_s + gc::kUnits * ldw;   // h_{t-1} slice
  float* rh_s = h_s + sf;                // r * h_{t-1} slice
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int mtile = warp >> 1, half = warp & 1;
  const int g = lane >> 2, t4 = lane & 3;
  const int b0 = static_cast<int>(blockIdx.x / cs) * 16 * mt;
  // the cluster's slices in global memory, [rank][h, r * h]
  float* gs = slices + (int64_t)(blockIdx.x / cs) * cs * kChainSlices * sf;
  float* gs_own = gs + rank * kChainSlices * sf;
  int row[2], b[2], unit[2], j[2];
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    row[ri] = mtile * 16 + g + 8 * ri;
    b[ri] = b0 + row[ri];
  }
#pragma unroll
  for (int nt2 = 0; nt2 < 2; ++nt2) {
    unit[nt2] = (2 * half + nt2) * 8 + 2 * t4;
    j[nt2] = rank * gc::kUnits + unit[nt2];
  }
  const int G = 3 * H;
  // the pair's scratch: this m-tile's part of a slice that no peer reads
  // then (r * h's in (a), h's in (b)), overwritten after the pair meets
  float* red_a = rh_s + mtile * gc::slice_floats(1);
  float* red_b = h_s + mtile * gc::slice_floats(1);
  // the slices each K half takes in both products
  const int s0 = half ? cs / 2 : 0, s1 = half ? cs : cs / 2;

  gc::load_w_cols<kParts>(w_s, w, H, rank, cs);
  // h_{-1}: h0 (zeros when null) into the carry and the h slice
  float carry[8];
#pragma unroll
  for (int nt2 = 0; nt2 < 2; ++nt2)
#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      float2 v = make_float2(0.f, 0.f);
      if (h0 != nullptr && b[ri] < B && j[nt2] < H)
        v = ld2(h0 + (int64_t)b[ri] * H + j[nt2]);
      const int q = nt2 * 4 + ri * 2;
      carry[q] = v.x;
      carry[q + 1] = v.y;
    }
#pragma unroll
  for (int q = 0; q < 8; ++q)
    h_s[gc::frag_index(row[(q >> 1) & 1], unit[q >> 2] + (q & 1))] = carry[q];
  StepX in, nx;
  if (kPrefetchX) load_x(in, x, 0, B, H, b, j);
  if (kSlicesThroughL2) gc::slices_to_global(gs_own, h_s, sf);
  gc::cluster_sync();   // W and h_{-1} in place in every block of the cluster

  for (int t = 0; t < T; ++t) {
    // (a) the update and reset pre-activations over every h slice; u and
    // r; r * h_{t-1} into the slice
    float acc[2][gc::kNTiles][4];
#pragma unroll
    for (int gi = 0; gi < 2; ++gi)
#pragma unroll
      for (int nt = 0; nt < gc::kNTiles; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[gi][nt][i] = 0.0f;
    if (kSharedA) {
      gc::slice_products<kTC, kChainSplit, kSlicesThroughL2, 2>(
          acc, h_s, gs, kChainSlices * sf, 1, mt, mtile, w_s, ldw, 0, 0,
          hpad, s0, s1, lane);
    } else {
#pragma unroll
      for (int gi = 0; gi < 2; ++gi)
        gc::slice_products<kTC, kChainSplit, kSlicesThroughL2, 1>(
            reinterpret_cast<float(&)[1][gc::kNTiles][4]>(acc[gi]), h_s, gs,
            kChainSlices * sf, 1, mt, mtile, w_s, ldw, gi * hpad, 0, 0, s0,
            s1, lane);
    }
    if (!kPrefetchX) load_x(in, x, t, B, H, b, j);
    float fin_u[2][4], fin_r[2][4];
    gc::pair_reduce(acc[0], fin_u, red_a, mtile, half, lane);
    gc::pair_reduce(acc[1], fin_r, red_a, mtile, half, lane);
    float u[8], r[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      u[q] = sigmoid_f(in.u[q] + fin_u[q >> 2][q & 3]);
      r[q] = sigmoid_f(in.r[q] + fin_r[q >> 2][q & 3]);
      rh_s[gc::frag_index(row[(q >> 1) & 1], unit[q >> 2] + (q & 1))] =
          r[q] * carry[q];
    }
    if (gates != nullptr)
#pragma unroll
      for (int nt2 = 0; nt2 < 2; ++nt2)
#pragma unroll
        for (int ri = 0; ri < 2; ++ri) {
          if (b[ri] >= B || j[nt2] >= H) continue;
          const int q = nt2 * 4 + ri * 2;
          float* o = gates + ((int64_t)t * B + b[ri]) * G + j[nt2];
          *reinterpret_cast<float2*>(o) = make_float2(u[q], u[q + 1]);
          *reinterpret_cast<float2*>(o + H) = make_float2(r[q], r[q + 1]);
        }
    if (kSlicesThroughL2) gc::slices_to_global(gs_own + sf, rh_s, sf);
    gc::cluster_sync();

    // (b) the candidate over every r * h slice; c, h_t; h_t into the
    // slice
    if (kPrefetchX && t + 1 < T) load_x(nx, x, t + 1, B, H, b, j);
    float accc[1][gc::kNTiles][4], fin[2][4];
#pragma unroll
    for (int nt = 0; nt < gc::kNTiles; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) accc[0][nt][i] = 0.0f;
    gc::slice_products<kTC, kChainSplit, kSlicesThroughL2, 1>(
        accc, rh_s, gs + sf, kChainSlices * sf, 1, mt, mtile, w_s, ldw,
        2 * hpad, 0, 0, s0, s1, lane);
    gc::pair_reduce(accc[0], fin, red_b, mtile, half, lane);
    float c[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      c[q] = tanhf(in.c[q] + fin[q >> 2][q & 3]);
      const bool live = b[(q >> 1) & 1] < B && j[q >> 2] < H;
      carry[q] = live ? u[q] * carry[q] + (1.0f - u[q]) * c[q] : 0.0f;
      h_s[gc::frag_index(row[(q >> 1) & 1], unit[q >> 2] + (q & 1))] =
          carry[q];
    }
#pragma unroll
    for (int nt2 = 0; nt2 < 2; ++nt2)
#pragma unroll
      for (int ri = 0; ri < 2; ++ri) {
        if (b[ri] >= B || j[nt2] >= H) continue;
        const int q = nt2 * 4 + ri * 2;
        const int64_t m = (int64_t)t * B + b[ri];
        *reinterpret_cast<float2*>(hs + m * H + j[nt2]) =
            make_float2(carry[q], carry[q + 1]);
        if (gates != nullptr)
          *reinterpret_cast<float2*>(gates + m * G + 2 * H + j[nt2]) =
              make_float2(c[q], c[q + 1]);
      }
    if (kSlicesThroughL2) gc::slices_to_global(gs_own, h_s, sf);
    // h_t in place for step t+1; after the last step, no block leaves
    // while a peer may still read its slices
    gc::cluster_sync();
    if (kPrefetchX && t + 1 < T) in = nx;
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

// the cluster chain's launch for (B, H): m-tiles per cluster, clusters
struct ChainPlan {
  int cs, mt, active, clusters;
};

cudaError_t chain_plan(int B, int H, ChainPlan* c) {
  c->cs = gc::cluster_blocks(H);
  c->mt = c->active = c->clusters = 0;
  if (c->cs == 0) return cudaSuccess;
  const cudaError_t err = gc::active_clusters<kParts>(
      gru_fwd_chain_kernel<kChainOnTensorCores>, c->cs, kChainSlices,
      gc::kPairThreads, gc::kMaxMTiles, &c->active);
  if (err != cudaSuccess) return err;
  c->mt = gc::mtiles_for<kParts>(B, c->active, c->cs, kChainSlices,
                                 gc::kMaxMTiles);
  c->clusters = (B + 16 * c->mt - 1) / (16 * c->mt);
  return cudaSuccess;
}

// the cluster chain's slices in global memory for every cluster (its
// batch rows round up by at most an m-tile set); none on the wide path
int64_t workspace_floats(int B, int H) {
  return (int64_t)kChainSlices * gc::kUnits * gc::cluster_blocks(H) *
         (B + 16 * gc::kMaxMTiles);
}

}  // namespace

extern "C" {

// Largest hidden width the call takes at `rows` batch rows per block of
// the wide path (8 or 16): its shared memory holds h, r * h and u of one
// tile, 3 * rows * H floats.  H must also be a multiple of 4 (h is read as
// float4).  Widths up to 512 take the cluster chain, which holds any of
// them.
int paddle_gru_fwd_max_hidden(int rows) {
  if (rows != 8 && rows != 16) return 0;
  return static_cast<int>(kMaxSmem / (rows * 3 * sizeof(float)));
}

// Blocks of the cluster whose chain width H takes, ceil(H / 32) for H <=
// 512; 0 for the wide path.  Decided before any launch, by H alone.
int paddle_gru_fwd_cluster_size(int H) { return gc::cluster_blocks(H); }

// The launch paddle_gru_fwd makes for (T, B, H) on the current device:
// out[0] the cluster size (0: the wide path), out[1] batch rows per
// cluster, out[2] clusters of that size the card runs at once, out[3]
// clusters launched.  Returns the first CUDA error (0 on success).
int paddle_gru_fwd_plan(int T, int B, int H, int* out) {
  if (T < 1 || B < 1 || H < 1) return static_cast<int>(cudaErrorInvalidValue);
  ChainPlan c;
  const cudaError_t err = chain_plan(B, H, &c);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = c.cs;
  out[1] = 16 * c.mt;
  out[2] = c.active;
  out[3] = c.clusters;
  return 0;
}

// Bytes of device workspace paddle_gru_fwd needs for (T, B, H): the
// cluster chain's exchange slices (0 on the wide path).
int64_t paddle_gru_fwd_workspace_bytes(int T, int B, int H) {
  if (T < 1 || B < 1 || H < 1) return 0;
  return workspace_floats(B, H) * (int64_t)sizeof(float);
}

// x [T, B, 3H] (bias added), w [H, 3H], h0 [B, H] or null for zeros:
// contiguous float32 on the device, 16-byte aligned.  Writes hs [T, B, H]
// and, when `gates` is not null, gates [T, B, 3H] (u, r, c), on `stream`:
// the cluster chain for H <= 512, else the row-tiled loop with `rows`
// batch rows per block (8 or 16).  `workspace` holds
// paddle_gru_fwd_workspace_bytes(T, B, H) bytes.  Returns the CUDA error
// of the launch (0 on success); does not synchronise.
int paddle_gru_fwd(const void* x, const void* w, const void* h0, void* hs,
                   void* gates, void* workspace, int T, int B, int H,
                   int rows, void* stream) {
  if (T < 1 || B < 1 || H < 1 || H % 4 != 0 ||
      H > paddle_gru_fwd_max_hidden(rows))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  const float* hf = static_cast<const float*>(h0);
  float* hsf = static_cast<float*>(hs);
  float* gf = static_cast<float*>(gates);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (gc::cluster_blocks(H) > 0) {
    ChainPlan c;
    cudaError_t err = chain_plan(B, H, &c);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = gc::launch<kParts>(gru_fwd_chain_kernel<kChainOnTensorCores>,
                             c.cs, c.mt, c.clusters, kChainSlices,
                             gc::kPairThreads, st, xf, wf, hf, hsf, gf,
                             static_cast<float*>(workspace), T, B, H, c.mt);
    return static_cast<int>(err);
  }
  return rows == 8 ? launch<8>(xf, wf, hf, hsf, gf, T, B, H, st)
                   : launch<16>(xf, wf, hf, hsf, gf, T, B, H, st);
}

const char* paddle_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
