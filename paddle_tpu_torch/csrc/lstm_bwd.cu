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
// in no order, so the call is a chain kernel that walks T, then dW as a
// product over the T * B rows, then a finish that sums the partials of dW
// and dpw in a fixed order.  No atomics: the result is the same on every
// run.
//
// The chain, by a rule on H decided before any launch (no fallback):
//   - H <= 416: `lstm_chain_kernel`, one persistent thread-block cluster of
//     ceil(H / 32) blocks per tile of 16 * mt batch rows, on the engine of
//     gru_cluster.cuh that the GRU kernels use.  Each block keeps W's rows
//     of its 32 units, all four gate parts, in shared memory for all T
//     steps (131,584 bytes at H = 256); 416 units is what W and two slice
//     buffers leave of a block's 232,448 bytes (kChainMaxBlocks).  A step
//     has one cluster barrier: (a) the elementwise body for the thread's
//     (row, unit) pairs, the dh and dc carries in registers, writing dx_t
//     to global memory and dg_i, dg_f, dg_c, dg_o into the block's four
//     slices; (b) the dh carry = dx_t W^T over the cluster's 4 cs slices,
//     in 3xTF32 on the tensor cores, the kShares warps of an m-tile each
//     taking a share of the slices (K) and meeting in a fixed-order sum
//     (gru_cluster.cuh share_reduce).  The slices are double-buffered, so
//     the one barrier a step orders both their writes and their reads.  The
//     step's inputs load after the previous step's products, not a step
//     ahead (the registers that would hold them spill).  dpw's three sums
//     ride in the elementwise part, one partial per (cluster, m-tile, row
//     half) summed by the finish.
//   - wider H: `lstm_bptt_kernel`, one block per tile of kRows batch rows
//     walks t = T-1..0 with dh and dc in shared memory.  Each step (a)
//     computes dx_t elementwise, one hidden unit per thread for every row
//     (the rows' loads issued together), writing it to global memory and
//     to shared memory, and adds the unit's dpw terms to a per-block sum in
//     shared memory; (b) carries dh = dx_t W^T with W^T streamed from
//     global memory (transposed once per call into the workspace, so the
//     loads are coalesced) into two register buffers, and dx_t read from
//     shared memory as float4 broadcasts.  Its shared memory caps H at
//     paddle_lstm_bwd_max_hidden().
//
// dW: on the cluster path `lstm_dw_tc_kernel`, gru_cluster.cuh's dW tiles
// (64 x 128 on the tensor cores in 3xTF32, a 3-stage cp.async ring), as
// the GRU's dW computes them but without a gated part; on the wide path
// `lstm_dw_kernel`, 64 x 64 SIMT tiles.  Both split the rows into S
// contiguous ranges (one partial dW per range in the workspace) so that
// enough blocks fill the card, and `lstm_bwd_finish_kernel` sums them.
//
// What bounds it on an H100: for the stacked-LSTM LM (T=128, B=256, H=256)
// the dh chain and dW are 2 * 2 * T*B*H*4H = 34.4 GFLOP, 0.21 ms at
// 3xTF32's 165 TFLOP/s (0.51 ms on the CUDA cores), against about 0.11 ms
// of device-memory traffic.  The chain is serial over T with one cluster
// barrier a step, and each warp's products (16 rows x 32 units over its
// share of K) sit beside their 3xTF32 splits and B-fragment loads; PERF.md
// has the measured split.

#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_tf32.cuh"
#include "gru_cluster.cuh"

namespace {

namespace cg = cooperative_groups;
namespace gc = gru_cluster;

constexpr int kRows = 8;         // batch rows per block of the BPTT loop
constexpr int kMaxThreads = 256;
constexpr int kUnroll = 8;
constexpr int kMaxSmem = 232448;
constexpr int kTile = 64;        // dW output tile (both sides)
constexpr int kDepth = 16;       // rows of T * B per shared-memory stage
constexpr int kTargetBlocks = 2 * 132;
constexpr int kMaxSplits = 64;

// The cluster path.  W's parts (i, f, cand, o).  The chain's products on
// the tensor cores (3xTF32) or the CUDA cores; the 3xTF32 splits of the
// chain and of dW (gru_cluster.cuh split_tf32); peers' slices read from L2
// or through DSMEM (gru_cluster.cuh slice_products); the warps an m-tile
// takes, each computing the 32 units of its 16 rows over 1 / kShares of
// the slices (2: the GRU kernels' K halves); the m-tiles a cluster takes
// at most (fewer when one wave of the clusters the card runs at once covers
// B with fewer).  The alternatives are ops/kernels/lstm_bwd_probe.py's
// comparisons.
constexpr int kParts = 4;
constexpr bool kChainOnTensorCores = true;
constexpr int kChainSplit = 0;
constexpr int kDwSplit = 0;
constexpr bool kSlicesThroughL2 = true;
constexpr int kShares = 8;
constexpr int kChainMaxMTiles = 2;
// slice buffers of the chain: dg_i, dg_f, dg_c, dg_o, two steps' worth
constexpr int kChainSlices = 2 * kParts;
constexpr int kChainThreads = 32 * kShares * kChainMaxMTiles;
// the widest cluster: W's rows of 32 units and the slices of one m-tile in
// a block's shared memory (13 blocks, 416 units)
constexpr int kChainMaxBlocks = gc::max_blocks<kParts>(kChainSlices);
static_assert(kSlicesThroughL2 || kShares <= 4,
              "share_reduce's regions 4-7 are the step's own slices, which "
              "peers read through DSMEM");

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

// Step t's inputs of one (row, unit) pair group: units j, j + 1 of row b
// (zeros for a row past B or units past H)
struct StepIn {
  float2 i, f, cand, o, c, cp, cth, ctc;
};

__device__ __forceinline__ float2 ld2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}

__device__ __forceinline__ StepIn load_step(
    const float* __restrict__ gates, const float* __restrict__ cell,
    const float* __restrict__ ct_h, const float* __restrict__ ct_c, int t,
    int B, int H, int b, int j) {
  const float2 z = make_float2(0.f, 0.f);
  StepIn in = {z, z, z, z, z, z, z, z};
  if (b < B && j < H) {
    const int64_t m = (int64_t)t * B + b;
    const float* gm = gates + m * 4 * H + j;
    in.i = ld2(gm);
    in.f = ld2(gm + H);
    in.cand = ld2(gm + 2 * H);
    in.o = ld2(gm + 3 * H);
    in.c = ld2(cell + m * H + j);
    if (t > 0) in.cp = ld2(cell + (m - B) * H + j);
    if (ct_h != nullptr) in.cth = ld2(ct_h + m * H + j);
    if (ct_c != nullptr) in.ctc = ld2(ct_c + m * H + j);
  }
  return in;
}

// The (dh, dc) chain on one cluster of cs = ceil(H / 32) blocks over batch
// rows b0 .. b0 + 16 mt - 1 (b0 = 16 mt * cluster index), 32 * kShares *
// mt threads a block (warp = (m-tile, K share)); gru_cluster.cuh has the
// layout.  A thread owns kPairs = 16 / kShares (row, unit) pairs, kGroups
// groups of two neighbouring units of one row: the acc indices share *
// kPairs .. of the C fragment.  Rows past B and units past H read zeros
// and so hold zeros in the carries and the slices.  The slices in global
// memory: [buffer][rank][part][slice_floats(mt)] per cluster.
template <bool kTC>
__global__ void __launch_bounds__(kChainThreads, 1)
lstm_chain_kernel(const float* __restrict__ gates,
                  const float* __restrict__ cell,
                  const float* __restrict__ ct_h,
                  const float* __restrict__ ct_c,
                  const float* __restrict__ w, const float* __restrict__ pw,
                  float* __restrict__ dx, float* __restrict__ dpw_part,
                  float* __restrict__ slices, int T, int B, int H, int mt) {
  constexpr int kPairs = 16 / kShares, kGroups = kPairs / 2;
  extern __shared__ __align__(16) float smem[];
  const int cs = gc::cluster_blocks(H, kChainMaxBlocks);
  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  const int hpad = gc::kUnits * cs, ldw = gc::w_stride<kParts>(cs);
  const int sf = gc::slice_floats(mt), bufs = kParts * sf;
  float* w_s = smem;
  float* buf = w_s + gc::kUnits * ldw;   // [2][kParts][sf]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int mtile = warp / kShares, share = warp % kShares;
  const int g = lane >> 2, t4 = lane & 3;
  const int ci = static_cast<int>(blockIdx.x) / cs;
  const int b0 = ci * 16 * mt;
  float* gs = slices + (int64_t)ci * 2 * cs * bufs;
  int row[kGroups], b[kGroups], unit[kGroups], j[kGroups], rh[kGroups];
#pragma unroll
  for (int gi = 0; gi < kGroups; ++gi) {
    const int idx = share * kPairs + 2 * gi;   // acc index nt * 4 + e
    rh[gi] = (idx >> 1) & 1;   // row g or g + 8
    row[gi] = mtile * 16 + g + 8 * rh[gi];
    b[gi] = b0 + row[gi];
    unit[gi] = (idx >> 2) * 8 + 2 * t4;
    j[gi] = rank * gc::kUnits + unit[gi];
  }
  // this share's slices of the 4 cs: slice s is part s % 4 of peer s / 4
  const int n_slices = kParts * cs;
  const int s_begin = share * n_slices / kShares;
  const int s_end = (share + 1) * n_slices / kShares;
  const int G = kParts * H;

  gc::load_w_slice<kParts>(w_s, w, H, rank, cs);
  float2 p0[kGroups], p1[kGroups], p2[kGroups];
#pragma unroll
  for (int gi = 0; gi < kGroups; ++gi) {
    const bool live = j[gi] < H;
    const float2 z = make_float2(0.f, 0.f);
    p0[gi] = live ? ld2(pw + j[gi]) : z;
    p1[gi] = live ? ld2(pw + H + j[gi]) : z;
    p2[gi] = live ? ld2(pw + 2 * H + j[gi]) : z;
  }
  float dh_c[kPairs], dc_c[kPairs], dpw[3][kPairs];
#pragma unroll
  for (int q = 0; q < kPairs; ++q) {
    dh_c[q] = dc_c[q] = 0.0f;
    dpw[0][q] = dpw[1][q] = dpw[2][q] = 0.0f;
  }
  gc::cluster_sync();   // W in place, every block of the cluster running

  for (int t = T - 1; t >= 0; --t) {
    float* cur = buf + (t & 1) * bufs;
    // (a) dx_t of the own pairs, the dc carry, dpw's terms; dx_t into the
    // slices
    float dg[kParts][kPairs];
#pragma unroll
    for (int gi = 0; gi < kGroups; ++gi) {
      const StepIn in =
          load_step(gates, cell, ct_h, ct_c, t, B, H, b[gi], j[gi]);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int q = 2 * gi + e;
        const float i = e ? in.i.y : in.i.x, f = e ? in.f.y : in.f.x;
        const float cand = e ? in.cand.y : in.cand.x;
        const float o = e ? in.o.y : in.o.x, c = e ? in.c.y : in.c.x;
        const float cp = e ? in.cp.y : in.cp.x;
        const float dh = (e ? in.cth.y : in.cth.x) + dh_c[q];
        const float tc = tanhf(c);
        const float dgo = dh * tc * o * (1.0f - o);
        const float dc = (e ? in.ctc.y : in.ctc.x) + dc_c[q] +
                         dh * o * (1.0f - tc * tc) +
                         dgo * (e ? p2[gi].y : p2[gi].x);
        const float dgi = dc * cand * i * (1.0f - i);
        const float dgf = dc * cp * f * (1.0f - f);
        const float dgc = dc * i * (1.0f - cand * cand);
        dc_c[q] = dc * f + dgi * (e ? p0[gi].y : p0[gi].x) +
                  dgf * (e ? p1[gi].y : p1[gi].x);
        dpw[0][q] += dgi * cp;
        dpw[1][q] += dgf * cp;
        dpw[2][q] += dgo * c;
        dg[0][q] = dgi;
        dg[1][q] = dgf;
        dg[2][q] = dgc;
        dg[3][q] = dgo;
      }
      if (b[gi] < B && j[gi] < H) {
        float* o = dx + ((int64_t)t * B + b[gi]) * G + j[gi];
#pragma unroll
        for (int p = 0; p < kParts; ++p)
          *reinterpret_cast<float2*>(o + p * H) =
              make_float2(dg[p][2 * gi], dg[p][2 * gi + 1]);
      }
    }
    if (t == 0) break;
#pragma unroll
    for (int q = 0; q < kPairs; ++q) {
      const int fi = gc::frag_index(row[q >> 1], unit[q >> 1] + (q & 1));
#pragma unroll
      for (int p = 0; p < kParts; ++p) cur[p * sf + fi] = dg[p][q];
    }
    if (kSlicesThroughL2)
      gc::slices_to_global(gs + ((t & 1) * cs + rank) * bufs, cur, bufs);
    gc::cluster_sync();

    // (b) the dh carry dx_t W^T over this share's slices, the shares summed
    float acc[1][gc::kNTiles][4];
#pragma unroll
    for (int nt = 0; nt < gc::kNTiles; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[0][nt][i] = 0.0f;
    gc::slice_products<kTC, kChainSplit, kSlicesThroughL2, 1>(
        acc, cur, gs + (t & 1) * cs * bufs, bufs, kParts, mt, mtile, w_s,
        ldw, 0, hpad, 0, s_begin, s_end, lane);
    gc::share_reduce<kShares>(
        acc[0], dh_c, buf + ((t & 1) ^ 1) * bufs + mtile * gc::slice_floats(1),
        cur + mtile * gc::slice_floats(1), sf, mtile, share, lane);
  }
  // each group's dpw sums over its row's 8 lanes (g), then one partial per
  // (cluster, m-tile, row half): dpw_part[slot][3][H]
#pragma unroll
  for (int gi = 0; gi < kGroups; ++gi) {
    float v[3][2];
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float x = dpw[k][2 * gi + e];
        x += __shfl_xor_sync(0xffffffffu, x, 4);
        x += __shfl_xor_sync(0xffffffffu, x, 8);
        x += __shfl_xor_sync(0xffffffffu, x, 16);
        v[k][e] = x;
      }
    if (g == 0 && j[gi] < H) {
      float* o = dpw_part +
                 ((int64_t)(ci * mt + mtile) * 2 + rh[gi]) * 3 * H + j[gi];
#pragma unroll
      for (int k = 0; k < 3; ++k)
        *reinterpret_cast<float2*>(o + k * H) = make_float2(v[k][0], v[k][1]);
    }
  }
  gc::cluster_sync();   // no block leaves while a peer may read its slices
}

// One 64 x 128 tile of dW summed over rows m of T * B in this block's
// range: h_prev[m]^T dx[m] (h_prev[m] = hs[m - B], zero for the first B
// rows); gru_cluster.cuh dw_tile.  Writes its range's sum to dw_part +
// blockIdx.z * H * 4H.
__global__ void __launch_bounds__(gc::kDwThreads, gc::kDwBlocksPerSm)
lstm_dw_tc_kernel(const float* __restrict__ hs, const float* __restrict__ dx,
                  float* __restrict__ dw_part, int64_t M, int64_t chunk,
                  int B, int H) {
  gc::dw_tile<kParts, false, kDwSplit>(hs, nullptr, nullptr, dx, dw_part, M,
                                       chunk, B, H, 0);
}

struct Plan {
  int cs;           // cluster size (0: the wide path)
  int nblocks;      // wide path: BPTT blocks (each a dpw partial)
  int tiles_n, tiles_k;   // dW tiles on the cluster path: columns, rows
  int splits;       // dW row ranges
  int64_t chunk;    // rows per range
  int64_t wt_off, dw_off, dpw_off, slices_off, floats;   // workspace
};

// the most batch rows a launch's clusters cover (B rounded up by at most an
// m-tile set)
int64_t chain_rows(int B) { return B + 16 * kChainMaxMTiles; }

Plan plan_for(int T, int B, int H) {
  Plan p;
  const int64_t G = 4 * (int64_t)H, M = (int64_t)T * B;
  p.cs = gc::cluster_blocks(H, kChainMaxBlocks);
  p.nblocks = (B + kRows - 1) / kRows;
  p.wt_off = p.slices_off = 0;
  if (p.cs > 0) {
    // dW's tiles and row ranges (gru_cluster.cuh dw_splits); dpw's
    // partials, one per (cluster, m-tile, row half); the chain's slices in
    // global memory for every cluster
    p.tiles_n = static_cast<int>((G + gc::kDwBN - 1) / gc::kDwBN);
    p.tiles_k = (H + gc::kDwBM - 1) / gc::kDwBM;
    p.splits = gc::dw_splits((int64_t)p.tiles_n * p.tiles_k, M, G * H,
                             &p.chunk);
    const int64_t dpw_parts = chain_rows(B) / 8;
    p.dw_off = 0;
    p.dpw_off = (int64_t)p.splits * G * H;
    p.slices_off = p.dpw_off + dpw_parts * 3 * H;
    p.floats = p.slices_off +
               (int64_t)kChainSlices * gc::kUnits * p.cs * chain_rows(B);
    return p;
  }
  p.tiles_n = p.tiles_k = 0;
  const int64_t tiles = ((G + kTile - 1) / kTile) * ((H + kTile - 1) / kTile);
  int64_t s = (kTargetBlocks + tiles - 1) / tiles;
  const int64_t stages = (M + kDepth - 1) / kDepth;
  if (s > stages) s = stages;
  if (s > kMaxSplits) s = kMaxSplits;
  if (s < 1) s = 1;
  p.chunk = ((stages + s - 1) / s) * kDepth;
  p.splits = static_cast<int>((M + p.chunk - 1) / p.chunk);
  p.dw_off = G * H;
  p.dpw_off = p.dw_off + (int64_t)p.splits * G * H;
  p.floats = p.dpw_off + (int64_t)p.nblocks * 3 * H;
  return p;
}

// the cluster chain's launch for (B, H): m-tiles per cluster, clusters
struct ChainPlan {
  int cs, mt, active, clusters;
};

cudaError_t chain_plan(int B, int H, ChainPlan* c) {
  c->cs = gc::cluster_blocks(H, kChainMaxBlocks);
  c->mt = c->active = c->clusters = 0;
  if (c->cs == 0) return cudaSuccess;
  const cudaError_t err = gc::active_clusters<kParts>(
      lstm_chain_kernel<kChainOnTensorCores>, c->cs, kChainSlices,
      32 * kShares, kChainMaxMTiles, &c->active);
  if (err != cudaSuccess) return err;
  c->mt = gc::mtiles_for<kParts>(B, c->active, c->cs, kChainSlices,
                                 kChainMaxMTiles);
  c->clusters = (B + 16 * c->mt - 1) / (16 * c->mt);
  return cudaSuccess;
}

int threads_for(int H) {
  const int t = (H + 31) / 32 * 32;
  return t < kMaxThreads ? t : kMaxThreads;
}

size_t smem_bytes(int H) {
  return (size_t)(kRows * 6 * H + 3 * H) * sizeof(float);
}

unsigned grid_1d(int64_t n) {
  const int64_t b = (n + 255) / 256;
  return static_cast<unsigned>(b < 4096 ? b : 4096);
}

}  // namespace

extern "C" {

// Largest hidden width the call takes: the wide path's BPTT kernel (its
// shared memory holds the dh and dc carry, one step's dx and the dpw sums);
// H must also be a multiple of 4.  Widths up to 416 take the cluster
// chain, which holds any of them.
int paddle_lstm_bwd_max_hidden() {
  return static_cast<int>(kMaxSmem / ((kRows * 6 + 3) * sizeof(float)));
}

// Blocks of the cluster whose chain width H takes, ceil(H / 32) for H <=
// 416; 0 for the wide path.  Decided before any launch, by H alone.
int paddle_lstm_bwd_cluster_size(int H) {
  return gc::cluster_blocks(H, kChainMaxBlocks);
}

// The launch paddle_lstm_bwd makes for (T, B, H) on the current device:
// out[0] the cluster size (0: the wide path), out[1] batch rows per
// cluster, out[2] clusters of that size the card runs at once, out[3]
// clusters launched, out[4] dW row ranges, out[5] dW blocks.  Returns the
// first CUDA error (0 on success).
int paddle_lstm_bwd_plan(int T, int B, int H, int* out) {
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
  out[5] = p.cs > 0 ? p.tiles_n * p.tiles_k * p.splits
                    : static_cast<int>(((4 * H + kTile - 1) / kTile) *
                                       ((H + kTile - 1) / kTile)) * p.splits;
  return 0;
}

// Bytes of device workspace paddle_lstm_bwd needs for (T, B, H): the
// partial dW of each row range, the dpw partials, and W^T (the wide path)
// or the cluster chain's exchange slices.
int64_t paddle_lstm_bwd_workspace_bytes(int T, int B, int H) {
  if (T < 1 || B < 1 || H < 1) return 0;
  return plan_for(T, B, H).floats * (int64_t)sizeof(float);
}

// gates [T, B, 4H] (i, f, cand, o after activation), hs, cs [T, B, H] (the
// forward's outputs), ct_h, ct_c [T, B, H] (cotangents of hs and cs; null
// means zeros), w [H, 4H], pw [3, H]: contiguous float32 on the device,
// 16-byte aligned.  Writes dx [T, B, 4H], dw [H, 4H], dpw [3, H];
// `workspace` holds paddle_lstm_bwd_workspace_bytes(T, B, H) bytes.
// Launches on `stream` the chain (the cluster chain for H <= 416; else the
// transpose and the wide chain), the dW tiles and the finish; returns the
// first CUDA error (0 on success); does not synchronise.
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
  float* dw_part = ws + p.dw_off;
  float* dpw_part = ws + p.dpw_off;
  const int64_t G = 4 * (int64_t)H, M = (int64_t)T * B;
  const float* gf = static_cast<const float*>(gates);
  const float* hsf = static_cast<const float*>(hs);
  const float* csf = static_cast<const float*>(cs);
  const float* cthf = static_cast<const float*>(ct_h);
  const float* ctcf = static_cast<const float*>(ct_c);
  const float* wf = static_cast<const float*>(w);
  const float* pwf = static_cast<const float*>(pw);
  float* dxf = static_cast<float*>(dx);
  cudaError_t err;
  int dpw_parts = p.nblocks;

  if (p.cs > 0) {
    ChainPlan c;
    err = chain_plan(B, H, &c);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = gc::launch<kParts>(lstm_chain_kernel<kChainOnTensorCores>, c.cs,
                             c.mt, c.clusters, kChainSlices, 32 * kShares,
                             st, gf, csf, cthf, ctcf, wf, pwf, dxf, dpw_part,
                             ws + p.slices_off, T, B, H, c.mt);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(lstm_dw_tc_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               gc::dw_smem<false>());
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(static_cast<unsigned>(p.tiles_n),
                    static_cast<unsigned>(p.tiles_k),
                    static_cast<unsigned>(p.splits));
    lstm_dw_tc_kernel<<<grid, gc::kDwThreads, gc::dw_smem<false>(), st>>>(
        hsf, dxf, dw_part, M, p.chunk, B, H);
    dpw_parts = c.clusters * c.mt * 2;
  } else {
    float* wt = ws + p.wt_off;
    transpose_kernel<<<grid_1d(G * H), 256, 0, st>>>(wf, wt, H);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);

    const size_t smem = smem_bytes(H);
    err = cudaFuncSetAttribute(lstm_bptt_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    lstm_bptt_kernel<<<static_cast<unsigned>(p.nblocks), threads_for(H),
                       smem, st>>>(gf, csf, cthf, ctcf, wt, pwf, dxf,
                                   dpw_part, T, B, H);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);

    const dim3 grid(static_cast<unsigned>((G + kTile - 1) / kTile),
                    static_cast<unsigned>((H + kTile - 1) / kTile),
                    static_cast<unsigned>(p.splits));
    lstm_dw_kernel<<<grid, 256, 0, st>>>(hsf, dxf, dw_part, M, p.chunk, B,
                                         H);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  lstm_bwd_finish_kernel<<<grid_1d(G * H + 3 * H), 256, 0, st>>>(
      dw_part, dpw_part, static_cast<float*>(dw), static_cast<float*>(dpw),
      p.splits, dpw_parts, H);
  return static_cast<int>(cudaGetLastError());
}

const char* paddle_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
