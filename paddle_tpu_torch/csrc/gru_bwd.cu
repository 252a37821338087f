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
// keeps W, the carry and the dW accumulator in VMEM.  On the card the call
// is a chain kernel that walks T, then dW as a product over the T * B rows.
//
// The chain, by a rule on H decided before any launch (no fallback):
//   - H <= 512 (gru_cluster::kMaxHidden): `gru_chain_kernel`, one
//     persistent thread-block cluster of ceil(H / 32) blocks per tile of
//     16 * mt batch rows, on the engine of gru_cluster.cuh.  W stays in
//     shared memory for all T steps, split by hidden units (32 a block:
//     at H = 512, 196,608 bytes of its 232,448).  A step is the JAX
//     body's three phases with two cluster barriers: (a) du_pre, dc_pre of
//     the block's own units, dc_pre into its slice; (b) drh = dc_pre W_c^T
//     over every block's dc_pre slice, then dr_pre and the carry's
//     elementwise part, [du_pre, dr_pre] into its slices; (c) the carry's
//     product [du_pre, dr_pre] W_rz^T the same way.  The carry stays in
//     registers.  Products in 3xTF32 on the tensor cores (flash_tf32.cuh's
//     split; kChainOnTensorCores, the CUDA-core form being the probe's
//     comparison).  mt is sized from the clusters the card runs at once
//     (cudaOccupancyMaxActiveClusters): on an H100 7 clusters of 16, so
//     B = 512 takes 7 clusters of 80 rows on 112 SMs.
//   - wider H: no cluster holds W, so `gru_bptt_kernel` (the row-tiled
//     chain): one block per R = 8 or 16 rows with the carry in shared
//     memory, W^T (`transpose_kernel` into the workspace) streamed from L2
//     every step.  Its shared memory caps H at
//     paddle_gru_bwd_max_hidden(rows).
//
// The exchange.  A block reads 80 rows x 3H floats of its peers' slices a
// step (491 KB at H = 512).  Through DSMEM that is bound by the SM-to-SM
// network: the exchange alone takes most of the chain's time.  Each block
// therefore also copies its slices to the workspace (16-byte stores)
// before the barrier, and its peers read them from L2 (`__ldcg`), where
// the exchange hides behind the products (kSlicesThroughL2; the numbers
// are in PERF.md, from ops/kernels/gru_bwd_probe.py).
//
// dW: `gru_dw_kernel`, 64 x 128 output tiles on the tensor cores (3xTF32
// mma.sync m16n8k8), rows of h_prev, r and dx coming through a 3-stage
// cp.async ring; the candidate's tiles multiply r * h_prev, formed as each
// fragment is read.  The rows are split into S contiguous ranges, S chosen
// so that the blocks fill whole waves of the card; with S > 1 each range
// writes a partial dW to the workspace and `gru_dw_finish_kernel` sums
// them in index order.  No atomics: two calls agree bitwise.
//
// What bounds it on an H100: for the seq2seq translator (T=64, B=512,
// H=512) the chain and dW are 2 * 2 * T*B*H*3H = 103 GFLOP, 0.62 ms at
// 3xTF32's 165 TFLOP/s (1.54 ms on the CUDA cores), against about 0.16 ms
// of device-memory traffic.  The chain is serial over T, two cluster
// barriers a step, and its products run at 16 rows x 32 units a warp,
// where the 3xTF32 splits and the B fragments' loads sit beside each
// product; dW's splits and triple products take about 40% of its time
// (PERF.md §6 has the measured split).

#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_tf32.cuh"
#include "gru_cluster.cuh"

namespace {

namespace cg = cooperative_groups;
namespace gc = gru_cluster;

constexpr int kMaxThreads = 256;
constexpr int kUnroll = 8;
constexpr int kMaxSmem = 232448;

// the chain's products on the tensor cores (3xTF32) or the CUDA cores;
// the 3xTF32 splits of the chain and of dW (gru_cluster.cuh split_tf32);
// peers' slices read from L2 or through DSMEM (gru_cluster.cuh
// slice_products).  The alternatives are ops/kernels/gru_bwd_probe.py's
// comparisons.
constexpr bool kChainOnTensorCores = true;
constexpr int kChainSplit = 0;
constexpr int kDwSplit = 0;
constexpr bool kSlicesThroughL2 = true;
// slice buffers of the chain: dc_pre, du_pre, dr_pre
constexpr int kChainSlices = 3;

// W's parts (update, reset, candidate)
constexpr int kParts = 3;

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

// Step t's inputs of this thread's 8 (row, unit) pairs: pair q = nt2 * 4 +
// ri * 2 + e is row b[ri], unit j[nt2] + e (the C fragment's element ri *
// 2 + e of n-tile 2 * half + nt2); zeros for rows past B, units past H
struct StepIn {
  float u[8], r[8], c[8], hp[8], ct[8];
};

__device__ __forceinline__ float2 ld2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}

__device__ __forceinline__ void load_step(
    StepIn& in, const float* __restrict__ gates,
    const float* __restrict__ hs, const float* __restrict__ h0,
    const float* __restrict__ ct_h, int t, int B, int H, const int (&b)[2],
    const int (&j)[2]) {
  const float2 z = make_float2(0.f, 0.f);
#pragma unroll
  for (int nt2 = 0; nt2 < 2; ++nt2)
#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      float2 u = z, r = z, c = z, hp = z, ct = z;
      if (b[ri] < B && j[nt2] < H) {
        const int64_t m = (int64_t)t * B + b[ri];
        const float* gm = gates + m * 3 * H + j[nt2];
        u = ld2(gm);
        r = ld2(gm + H);
        c = ld2(gm + 2 * H);
        if (t > 0)
          hp = ld2(hs + (m - B) * H + j[nt2]);
        else if (h0 != nullptr)
          hp = ld2(h0 + (int64_t)b[ri] * H + j[nt2]);
        if (ct_h != nullptr) ct = ld2(ct_h + m * H + j[nt2]);
      }
      const int q = nt2 * 4 + ri * 2;
      in.u[q] = u.x; in.u[q + 1] = u.y;
      in.r[q] = r.x; in.r[q + 1] = r.y;
      in.c[q] = c.x; in.c[q + 1] = c.y;
      in.hp[q] = hp.x; in.hp[q + 1] = hp.y;
      in.ct[q] = ct.x; in.ct[q + 1] = ct.y;
    }
}

// The dh chain on one cluster of cs = ceil(H / 32) blocks over batch rows
// b0 .. b0 + 16 mt - 1 (b0 = 16 mt * cluster index), 64 * mt threads a
// block (warp = (m-tile, K half)); gru_cluster.cuh has the layout.
template <bool kTC>
__global__ void __launch_bounds__(gc::kMaxThreads, 1)
gru_chain_kernel(const float* __restrict__ gates,
                 const float* __restrict__ hs, const float* __restrict__ h0,
                 const float* __restrict__ ct_h, const float* __restrict__ w,
                 float* __restrict__ dx, float* __restrict__ dh0,
                 float* __restrict__ slices, int T, int B, int H, int mt) {
  extern __shared__ __align__(16) float smem[];
  const int cs = gc::cluster_blocks(H);
  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  const int hpad = gc::kUnits * cs, ldw = gc::w_stride<kParts>(cs);
  const int sf = gc::slice_floats(mt);
  float* w_s = smem;
  float* dcp_s = w_s + gc::kUnits * ldw;   // dc_pre slice
  float* dg_s = dcp_s + sf;                // du_pre slice, dr_pre slice
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int mtile = warp >> 1, half = warp & 1;
  const int g = lane >> 2, t4 = lane & 3;
  const int b0 = static_cast<int>(blockIdx.x / cs) * 16 * mt;
  // the cluster's slices in global memory, [rank][dc_pre, du_pre, dr_pre]
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
  // the pair's scratch in phases (b) and (c): this m-tile's part of a
  // slice that no peer reads then (du_pre's in (b), dc_pre's in (c))
  float* red_b = dg_s + mtile * gc::slice_floats(1);
  float* red_c = dcp_s + mtile * gc::slice_floats(1);
  // slices of the two products each K half takes: dc_pre's cs, then
  // [du_pre, dr_pre]'s 2 cs
  const int sb0 = half ? cs / 2 : 0, sb1 = half ? cs : cs / 2;
  const int sc0 = half ? cs : 0, sc1 = half ? 2 * cs : cs;

  gc::load_w_slice<kParts>(w_s, w, H, rank, cs);
  StepIn in;
  load_step(in, gates, hs, h0, ct_h, T - 1, B, H, b, j);
  float carry[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) carry[q] = 0.0f;
  gc::cluster_sync();   // W in place, every block of the cluster running

  for (int t = T - 1; t >= 0; --t) {
    // (a) du_pre and dc_pre of the own units; dc_pre into the slice
    float dh[8], dup[8], dcp[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      dh[q] = in.ct[q] + carry[q];
      const float u = in.u[q], c = in.c[q];
      const float du = dh[q] * (in.hp[q] - c);
      const float dc = dh[q] * (1.0f - u);
      dcp[q] = dc * (1.0f - c * c);
      dup[q] = du * u * (1.0f - u);
      dcp_s[gc::frag_index(row[(q >> 1) & 1], unit[q >> 2] + (q & 1))] =
          dcp[q];
    }
#pragma unroll
    for (int nt2 = 0; nt2 < 2; ++nt2)
#pragma unroll
      for (int ri = 0; ri < 2; ++ri) {
        if (b[ri] >= B || j[nt2] >= H) continue;
        const int q = nt2 * 4 + ri * 2;
        float* o = dx + ((int64_t)t * B + b[ri]) * G + j[nt2];
        *reinterpret_cast<float2*>(o) = make_float2(dup[q], dup[q + 1]);
        *reinterpret_cast<float2*>(o + 2 * H) =
            make_float2(dcp[q], dcp[q + 1]);
      }
    if (kSlicesThroughL2) gc::slices_to_global(gs_own, dcp_s, sf);
    gc::cluster_sync();

    // (b) drh = dc_pre W_c^T; dr_pre, the carry's elementwise part;
    // [du_pre, dr_pre] into the slices
    float acc[1][gc::kNTiles][4], fin[2][4];
#pragma unroll
    for (int nt = 0; nt < gc::kNTiles; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[0][nt][i] = 0.0f;
    gc::slice_products<kTC, kChainSplit, kSlicesThroughL2, 1>(
        acc, dcp_s, gs, kChainSlices * sf, 1, mt, mtile, w_s, ldw, 2 * hpad,
        0, 0, sb0, sb1, lane);
    gc::pair_reduce(acc[0], fin, red_b, mtile, half, lane);
    float drp[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const float drh = fin[q >> 2][q & 3];
      const float r = in.r[q];
      drp[q] = drh * in.hp[q] * r * (1.0f - r);
      carry[q] = dh[q] * in.u[q] + drh * r;
      const int fi = gc::frag_index(row[(q >> 1) & 1], unit[q >> 2] + (q & 1));
      dg_s[fi] = dup[q];
      dg_s[sf + fi] = drp[q];
    }
#pragma unroll
    for (int nt2 = 0; nt2 < 2; ++nt2)
#pragma unroll
      for (int ri = 0; ri < 2; ++ri) {
        if (b[ri] >= B || j[nt2] >= H) continue;
        const int q = nt2 * 4 + ri * 2;
        *reinterpret_cast<float2*>(dx + ((int64_t)t * B + b[ri]) * G + H +
                                   j[nt2]) = make_float2(drp[q], drp[q + 1]);
      }
    if (kSlicesThroughL2) gc::slices_to_global(gs_own + sf, dg_s, 2 * sf);
    gc::cluster_sync();

    // (c) the carry's product [du_pre, dr_pre] W_rz^T; step t-1's inputs
    // load meanwhile
    if (t > 0) load_step(in, gates, hs, h0, ct_h, t - 1, B, H, b, j);
#pragma unroll
    for (int nt = 0; nt < gc::kNTiles; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[0][nt][i] = 0.0f;
    gc::slice_products<kTC, kChainSplit, kSlicesThroughL2, 1>(
        acc, dg_s, gs + sf, kChainSlices * sf, 2, mt, mtile, w_s, ldw, 0,
        hpad, 0, sc0, sc1, lane);
    gc::pair_reduce(acc[0], fin, red_c, mtile, half, lane);
#pragma unroll
    for (int q = 0; q < 8; ++q) carry[q] += fin[q >> 2][q & 3];
  }
  if (dh0 != nullptr)
#pragma unroll
    for (int nt2 = 0; nt2 < 2; ++nt2)
#pragma unroll
      for (int ri = 0; ri < 2; ++ri) {
        if (b[ri] >= B || j[nt2] >= H) continue;
        const int q = nt2 * 4 + ri * 2;
        *reinterpret_cast<float2*>(dh0 + (int64_t)b[ri] * H + j[nt2]) =
            make_float2(carry[q], carry[q + 1]);
      }
  gc::cluster_sync();   // no block leaves while a peer may read its slices
}

// One 64 x 128 tile of dW (k0.., n0..) summed over rows m of T * B in this
// block's range: a[m]^T dx[m], a[m] = h_prev[m] for the update and reset
// columns (tiles blockIdx.x < rz_tiles) and r[m] * h_prev[m] for the
// candidate's; gru_cluster.cuh dw_tile.  Writes its range's sum to out +
// blockIdx.z * H * 3H.
__global__ void __launch_bounds__(gc::kDwThreads, gc::kDwBlocksPerSm)
gru_dw_kernel(const float* __restrict__ hs, const float* __restrict__ h0,
              const float* __restrict__ gates, const float* __restrict__ dx,
              float* __restrict__ out, int64_t M, int64_t chunk, int B,
              int H, int rz_tiles) {
  gc::dw_tile<kParts, true, kDwSplit>(hs, h0, gates, dx, out, M, chunk, B, H,
                                      rz_tiles);
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
  int rz_tiles, tiles_n, tiles_k;   // dW tiles: columns (rz, then c), rows
  int splits;                       // dW row ranges
  int64_t chunk;                    // rows per range
  int64_t wt_off, dw_off, slices_off, floats;   // workspace (floats)
};

// dW's tiles and row ranges (gru_cluster.cuh dw_splits)
Plan plan_for(int T, int B, int H) {
  Plan p;
  const int64_t G = 3 * (int64_t)H, M = (int64_t)T * B;
  p.rz_tiles = (2 * H + gc::kDwBN - 1) / gc::kDwBN;
  p.tiles_n = p.rz_tiles + (H + gc::kDwBN - 1) / gc::kDwBN;
  p.tiles_k = (H + gc::kDwBM - 1) / gc::kDwBM;
  p.splits = gc::dw_splits((int64_t)p.tiles_n * p.tiles_k, M, G * H,
                           &p.chunk);
  // W^T for the wide chain; the cluster chain's slices in global memory
  // for every cluster (its batch rows round up by at most an m-tile set)
  const int cs = gc::cluster_blocks(H);
  p.wt_off = 0;
  p.dw_off = cs == 0 ? G * H : 0;
  p.slices_off =
      p.dw_off + (p.splits > 1 ? (int64_t)p.splits * G * H : 0);
  p.floats = p.slices_off +
             (int64_t)kChainSlices * gc::kUnits * cs *
                 (B + 16 * gc::kMaxMTiles);
  return p;
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
      gru_chain_kernel<kChainOnTensorCores>, c->cs, kChainSlices,
      gc::kPairThreads, gc::kMaxMTiles, &c->active);
  if (err != cudaSuccess) return err;
  c->mt = gc::mtiles_for<kParts>(B, c->active, c->cs, kChainSlices,
                                 gc::kMaxMTiles);
  c->clusters = (B + 16 * c->mt - 1) / (16 * c->mt);
  return cudaSuccess;
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

// Largest hidden width the call takes at `rows` batch rows per block of
// the wide path's chain (8 or 16): that chain's shared memory holds the
// carry, dc_pre and [du_pre, dr_pre] of one tile, 4 * rows * H floats.  H
// must also be a multiple of 4.  Widths up to 512 take the cluster chain,
// which holds any of them.
int paddle_gru_bwd_max_hidden(int rows) {
  if (rows != 8 && rows != 16) return 0;
  return static_cast<int>(kMaxSmem / (rows * 4 * sizeof(float)));
}

// Blocks of the cluster whose chain width H takes, ceil(H / 32) for H <=
// 512; 0 for the wide path.  Decided before any launch, by H alone.
int paddle_gru_bwd_cluster_size(int H) { return gc::cluster_blocks(H); }

// The launch paddle_gru_bwd makes for (T, B, H) on the current device:
// out[0] the cluster size (0: the wide path), out[1] batch rows per
// cluster, out[2] clusters of that size the card runs at once, out[3]
// clusters launched, out[4] dW row ranges, out[5] dW blocks.  Returns the
// first CUDA error (0 on success).
int paddle_gru_bwd_plan(int T, int B, int H, int* out) {
  if (T < 1 || B < 1 || H < 1) return static_cast<int>(cudaErrorInvalidValue);
  ChainPlan c;
  const cudaError_t err = chain_plan(B, H, &c);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Plan p = plan_for(T, B, H);
  out[0] = c.cs;
  out[1] = 16 * c.mt;
  out[2] = c.active;
  out[3] = c.clusters;
  out[4] = p.splits;
  out[5] = p.tiles_n * p.tiles_k * p.splits;
  return 0;
}

// Bytes of device workspace paddle_gru_bwd needs for (T, B, H): W^T on the
// wide path, the partial dW of each row range when there are several, and
// the cluster chain's exchange slices.
int64_t paddle_gru_bwd_workspace_bytes(int T, int B, int H) {
  if (T < 1 || B < 1 || H < 1) return 0;
  return plan_for(T, B, H).floats * (int64_t)sizeof(float);
}

// gates [T, B, 3H] (u, r, c after activation), hs [T, B, H] (the forward's
// outputs), h0 [B, H] (null for zeros), ct_h [T, B, H] (the cotangent of
// hs; null for zeros), w [H, 3H]: contiguous float32 on the device, 16-byte
// aligned.  Writes dx [T, B, 3H], dw [H, 3H] and, when `dh0` is not null,
// dh0 [B, H]; `workspace` holds paddle_gru_bwd_workspace_bytes(T, B, H)
// bytes; `rows` is 8 or 16 (the wide path's rows per block).  Launches on
// `stream` the chain (the cluster chain for H <= 512; else the transpose
// and the wide chain), the dW tiles and, with several row ranges, their
// finish; returns the first CUDA error (0 on success); does not
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
  const int64_t G = 3 * (int64_t)H;
  const float* gf = static_cast<const float*>(gates);
  const float* hsf = static_cast<const float*>(hs);
  const float* h0f = static_cast<const float*>(h0);
  const float* ctf = static_cast<const float*>(ct_h);
  const float* wf = static_cast<const float*>(w);
  float* dxf = static_cast<float*>(dx);
  float* dh0f = static_cast<float*>(dh0);

  cudaError_t err;
  if (gc::cluster_blocks(H) > 0) {
    ChainPlan c;
    err = chain_plan(B, H, &c);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = gc::launch<kParts>(gru_chain_kernel<kChainOnTensorCores>, c.cs,
                             c.mt, c.clusters, kChainSlices,
                             gc::kPairThreads, st, gf, hsf, h0f, ctf, wf,
                             dxf, dh0f, ws + p.slices_off, T, B, H, c.mt);
    if (err != cudaSuccess) return static_cast<int>(err);
  } else {
    float* wt = ws + p.wt_off;
    transpose_kernel<<<grid_1d(G * H), 256, 0, st>>>(wf, wt, H);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const int e = rows == 8
        ? launch_bptt<8>(gf, hsf, h0f, ctf, wt, dxf, dh0f, T, B, H, st)
        : launch_bptt<16>(gf, hsf, h0f, ctf, wt, dxf, dh0f, T, B, H, st);
    if (e != 0) return e;
  }

  err = cudaFuncSetAttribute(gru_dw_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             gc::dw_smem<true>());
  if (err != cudaSuccess) return static_cast<int>(err);
  float* dw_out = p.splits > 1 ? ws + p.dw_off : static_cast<float*>(dw);
  const dim3 grid(static_cast<unsigned>(p.tiles_n),
                  static_cast<unsigned>(p.tiles_k),
                  static_cast<unsigned>(p.splits));
  gru_dw_kernel<<<grid, gc::kDwThreads, gc::dw_smem<true>(), st>>>(
      hsf, h0f, gf, dxf, dw_out, (int64_t)T * B, p.chunk, B, H, p.rz_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.splits == 1) return static_cast<int>(err);

  gru_dw_finish_kernel<<<grid_1d(G * H), 256, 0, st>>>(
      ws + p.dw_off, static_cast<float*>(dw), p.splits, H);
  return static_cast<int>(cudaGetLastError());
}

const char* paddle_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
