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
// [i, f, cand, o] that the BPTT kernel (lstm_bwd.cu) replays.  The
// peepholes touch only a unit's own c, so a step is one product, h_{t-1}
// W, and an elementwise tail local to each unit.
//
// Design.  The TPU runs its grid (batch tiles, T) in order and keeps W and
// the (h, c) carry in VMEM.  On the card the time loop runs on one of two
// paths, by a rule on H decided before any launch (no fallback), the rule
// of the BPTT kernel's chain:
//   - H <= 416: `lstm_fwd_chain_kernel`, one persistent thread-block
//     cluster of ceil(H / 32) blocks per tile of 16 * mt batch rows, on the
//     engine of gru_cluster.cuh that the GRU kernels and the BPTT chain
//     use.  Block `rank` keeps W's columns of its 32 units for all four
//     gates in shared memory for all T steps (transposed: 131,584 bytes at
//     H = 256); 416 units is what W's columns, two h slices and the four
//     gate regions of one m-tile leave of a block's 232,448 bytes
//     (kChainMaxBlocks).  A step has one cluster barrier: (1) the own
//     units' four pre-activations over every block's h_{t-1} slice, in
//     3xTF32 on the tensor cores, each of an m-tile's eight warps taking
//     one gate's 16 x 32 tile over half of the slices (K); (2) x_t, read
//     after the products; (3) the K halves and then the gates meet in
//     shared memory (`meet`), each warp then taking 2 (row, unit) pairs
//     a lane for the tail, with the c carry in registers; (4) h_t, c_t and
//     the gates to global memory, h_t into the block's slice in the other
//     of two buffers, and its copy in L2 for the peers (kSlicesThroughL2).
//     Rows past B and units past H hold zeros in the carry and the
//     slices.  mt is sized from the clusters the card runs at once: on an
//     H100 15 clusters of 8 blocks, so the LM's B = 256 takes 8 clusters
//     of 32 rows on 64 SMs, one wave.
//   - wider H: `lstm_fwd_kernel`, the row-tiled loop (the kernel's first
//     design).  One block owns a tile of kRows batch rows and walks t =
//     0..T-1 with h and c in shared memory; each thread takes hidden units
//     j and computes their four pre-activations for all rows of the tile,
//     streaming W's columns j, H+j, 2H+j, 3H+j from L2 every step through
//     two register buffers, then the elementwise update, one (row, unit)
//     pair per thread.  Its shared memory (h, c, the pre-activations of
//     one tile) caps H at paddle_lstm_fwd_max_hidden().
//
// What bounds it on an H100: for the stacked-LSTM LM (T=128, B=256, H=256)
// the product is 2*T*B*H*4H = 17.2 GFLOP, 0.104 ms at 3xTF32's 165
// TFLOP/s (0.26 ms on the CUDA cores), against about 0.1 ms of
// device-memory traffic.  The cluster chain is serial over T with one
// cluster barrier a step, and each warp's products (16 rows x 32 units
// over its share of K) sit beside their 3xTF32 splits and B-fragment
// loads; PERF.md has the measured time.  The row-tiled loop runs only
// ceil(B / kRows) blocks, each re-streaming all of W every step.

#include <cuda_runtime.h>
#include <stdint.h>

#include "gru_cluster.cuh"

namespace {

namespace cg = cooperative_groups;
namespace gc = gru_cluster;

constexpr int kRows = 8;         // batch rows per block of the wide path
constexpr int kMaxThreads = 256;
constexpr int kUnroll = 8;       // W rows per register buffer
constexpr int kMaxSmem = 232448;

// The cluster path.  W's parts (i, f, cand, o).  The chain's products on
// the tensor cores (3xTF32) or the CUDA cores; the 3xTF32 split
// (gru_cluster.cuh split_tf32); peers' slices read from L2 or through
// DSMEM; the K shares (1 or 2) of each gate's products, one warp each;
// the m-tiles a cluster takes at most (fewer when one wave of the
// clusters the card runs at once covers B with fewer).  The alternatives,
// and the designs that lost to this one (all four gates a warp, a warp
// walking both m-tiles), are ops/kernels/lstm_fwd_probe.py's comparisons
// and PERF.md's record.
constexpr int kParts = 4;
constexpr bool kChainOnTensorCores = true;
constexpr int kChainSplit = 0;
constexpr bool kSlicesThroughL2 = true;
constexpr int kShares = 2;
constexpr int kChainMaxMTiles = 2;
// slice buffers of the chain: h_{t-1} and h_t; then the gate regions, one
// slice's worth for each gate, where an m-tile's pre-activations meet
constexpr int kChainSlices = 2;
constexpr int kMeetSlices = kParts;
constexpr int kWarpsPerMTile = kParts * kShares;
constexpr int kMTileThreads = 32 * kWarpsPerMTile;
constexpr int kChainThreads = kMTileThreads * kChainMaxMTiles;
// (row, unit) pairs a lane carries through the tail: an m-tile's 16
// C-fragment values a lane over its warps
constexpr int kOwn = 16 / kWarpsPerMTile;
// the widest cluster: W's columns of 32 units, two h slices and the gate
// regions of one m-tile in a block's shared memory (13 blocks, 416 units)
constexpr int kChainMaxBlocks =
    gc::max_blocks<kParts>(kChainSlices + kMeetSlices);
static_assert(kShares == 1 || kShares == 2,
              "the meet sums at most two K shares, in place");

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

__device__ __forceinline__ float2 ld2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}

// The time loop on one cluster of nb = ceil(H / 32) blocks over batch rows
// b0 .. b0 + 16 mt - 1 (b0 = 16 mt * cluster index), kMTileThreads * mt
// threads a block; gru_cluster.cuh has the layout.  Warp w of a block is
// (m-tile mtile, K share ks, gate q): its products are gate q's 16 x 32
// tile of the m-tile over share ks of the slices; in the tail it takes
// the kOwn C-fragment values of n-tile q from index `own` (all four, or
// the row half ks).  A value of index idx is row 16 mtile + g + 8 ((idx &
// 3) >> 1), unit (idx >> 2) * 8 + 2 t4 + (idx & 1); pairs of neighbouring
// units go to and from global memory as float2.  The slices in global
// memory: [buffer][rank][slice_floats(mt)] per cluster.
//
// Shared memory: w_s, the h slices [2][sf] (h_{t-1} of step t in buffer t
// & 1, h_t written into the other), the gate regions meet[kParts][sf].
// Why no step needs more than its one cluster barrier and the m-tile
// barriers of the meet: a step's products read only w_s and the current h
// buffer (and peers' copies); the meet's regions are written only after
// the writer's own products and read after an m-tile barrier; a region
// that K share 0 overwrites with the two shares' sum holds, at each
// position, what the same lane of share 1 wrote and share 0 has just read,
// and share 1 touches it no more this step; the tail writes h_t only into
// the other h buffer, which nobody reads this step.  The next writes of
// both the regions and this step's h buffer come after the step's cluster
// barrier, which every reader of this step has passed.
template <bool kTC>
__global__ void __launch_bounds__(kChainThreads, 1)
lstm_fwd_chain_kernel(const float* __restrict__ x,
                      const float* __restrict__ w,
                      const float* __restrict__ pw, float* __restrict__ hs,
                      float* __restrict__ cs, float* __restrict__ gates,
                      float* __restrict__ slices, int T, int B, int H,
                      int mt) {
  constexpr int kGroups = kOwn / 2;
  extern __shared__ __align__(16) float smem[];
  const int nb = gc::cluster_blocks(H, kChainMaxBlocks);
  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  const int hp = gc::kUnits * nb, ldw = gc::w_stride<kParts>(nb);
  const int sf = gc::slice_floats(mt);
  float* w_s = smem;
  float* hbuf = w_s + gc::kUnits * ldw;
  float* meet = hbuf + kChainSlices * sf;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int mtile = warp / kWarpsPerMTile;
  const int q = (warp % kWarpsPerMTile) % kParts;
  const int ks = (warp % kWarpsPerMTile) / kParts;
  const int own = q * 4 + ks * kOwn;
  // this warp's K share of the cluster's nb h slices
  const int s0 = ks * nb / kShares, s1 = (ks + 1) * nb / kShares;
  const int ci = static_cast<int>(blockIdx.x) / nb;
  const int b0 = ci * 16 * mt;
  float* gs = slices + (int64_t)ci * kChainSlices * nb * sf;
  const int G = kParts * H;
  int row[kGroups], b[kGroups], unit[kGroups], j[kGroups];
#pragma unroll
  for (int k = 0; k < kGroups; ++k) {
    const int idx = own + 2 * k;
    row[k] = mtile * 16 + g + 8 * ((idx & 3) >> 1);
    b[k] = b0 + row[k];
    unit[k] = (idx >> 2) * 8 + 2 * t4;
    j[k] = rank * gc::kUnits + unit[k];
  }
  float2 p0[kGroups], p1[kGroups], p2[kGroups];
#pragma unroll
  for (int k = 0; k < kGroups; ++k) {
    const bool live = j[k] < H;
    const float2 z = make_float2(0.f, 0.f);
    p0[k] = live ? ld2(pw + j[k]) : z;
    p1[k] = live ? ld2(pw + H + j[k]) : z;
    p2[k] = live ? ld2(pw + 2 * H + j[k]) : z;
  }
  float carry[kOwn];
#pragma unroll
  for (int v = 0; v < kOwn; ++v) carry[v] = 0.0f;
  gc::load_w_cols<kParts>(w_s, w, H, rank, nb);
  gc::cluster_sync();   // W in place, every block of the cluster running

  for (int t = 0; t < T; ++t) {
    const int par = t & 1;
    float* cur = hbuf + par * sf;
    float* nxt = hbuf + (par ^ 1) * sf;
    // (1) this warp's products over its share of the h_{t-1} slices (none
    // at t = 0: h_{-1} = 0)
    float acc[1][gc::kNTiles][4];
#pragma unroll
    for (int nt = 0; nt < gc::kNTiles; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[0][nt][e] = 0.0f;
    if (t > 0)
      gc::slice_products<kTC, kChainSplit, kSlicesThroughL2, 1>(
          acc, cur, gs + par * nb * sf, sf, 1, mt, mtile, w_s, ldw, q * hp,
          0, 0, s0, s1, lane);
    // (2) x_t of the own pairs
    float pre[kParts][kOwn];
#pragma unroll
    for (int k = 0; k < kGroups; ++k) {
      const bool live = b[k] < B && j[k] < H;
      const float* xm = x + ((int64_t)t * B + b[k]) * G + j[k];
#pragma unroll
      for (int p = 0; p < kParts; ++p) {
        const float2 v = live ? ld2(xm + p * H) : make_float2(0.f, 0.f);
        pre[p][2 * k] = v.x;
        pre[p][2 * k + 1] = v.y;
      }
    }
    // (3) the K halves meet, share 1 handing its partial over and share 0
    // summing in place, then the gates: region (m-tile m, gate p) at meet
    // + p * sf + 512 m, [n-tile][lane] float4s
    float4* mine = reinterpret_cast<float4*>(meet + q * sf) + mtile * 128;
    if (kShares == 1 || ks == 1)
#pragma unroll
      for (int nt = 0; nt < gc::kNTiles; ++nt)
        mine[nt * 32 + lane] = make_float4(acc[0][nt][0], acc[0][nt][1],
                                           acc[0][nt][2], acc[0][nt][3]);
    if constexpr (kShares == 2) {
      gc::group_sync<kWarpsPerMTile>(mtile);
      if (ks == 0)
#pragma unroll
        for (int nt = 0; nt < gc::kNTiles; ++nt) {
          const float4 o = mine[nt * 32 + lane];
          mine[nt * 32 + lane] =
              make_float4(acc[0][nt][0] + o.x, acc[0][nt][1] + o.y,
                          acc[0][nt][2] + o.z, acc[0][nt][3] + o.w);
        }
    }
    gc::group_sync<kWarpsPerMTile>(mtile);
#pragma unroll
    for (int p = 0; p < kParts; ++p) {
      const float* r = meet + p * sf + mtile * 512;
#pragma unroll
      for (int v = 0; v < kOwn; ++v) {
        const int idx = own + v;
        pre[p][v] += r[((idx >> 2) * 32 + lane) * 4 + (idx & 3)];
      }
    }
    // (4) the tail: the gates, c_t and h_t (the carry), the outputs, h_t
    // into the other h buffer
#pragma unroll
    for (int k = 0; k < kGroups; ++k) {
      const bool live = b[k] < B && j[k] < H;
      float gate[kParts][2], hv[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int v = 2 * k + e;
        const float cp = carry[v];
        const float i = sigmoid_f(pre[0][v] + cp * (e ? p0[k].y : p0[k].x));
        const float f = sigmoid_f(pre[1][v] + cp * (e ? p1[k].y : p1[k].x));
        const float cand = tanhf(pre[2][v]);
        const float c = f * cp + i * cand;
        const float o = sigmoid_f(pre[3][v] + c * (e ? p2[k].y : p2[k].x));
        carry[v] = live ? c : 0.0f;
        hv[e] = live ? o * tanhf(c) : 0.0f;
        gate[0][e] = i;
        gate[1][e] = f;
        gate[2][e] = cand;
        gate[3][e] = o;
        nxt[gc::frag_index(row[k], unit[k] + e)] = hv[e];
      }
      if (live) {
        const int64_t m = (int64_t)t * B + b[k];
        *reinterpret_cast<float2*>(hs + m * H + j[k]) =
            make_float2(hv[0], hv[1]);
        *reinterpret_cast<float2*>(cs + m * H + j[k]) =
            make_float2(carry[2 * k], carry[2 * k + 1]);
        if (gates != nullptr) {
          float* o = gates + m * G + j[k];
#pragma unroll
          for (int p = 0; p < kParts; ++p)
            *reinterpret_cast<float2*>(o + p * H) =
                make_float2(gate[p][0], gate[p][1]);
        }
      }
    }
    if (kSlicesThroughL2)
      gc::slices_to_global(gs + ((par ^ 1) * nb + rank) * sf, nxt, sf);
    // h_t in place for step t+1; after the last step, no block leaves
    // while a peer may still read its slices
    gc::cluster_sync();
  }
}

int threads_for(int H) {
  const int t = (H + 31) / 32 * 32;
  return t < kMaxThreads ? t : kMaxThreads;
}

size_t smem_bytes(int H) { return (size_t)kRows * 6 * H * sizeof(float); }

// the cluster chain's launch for (B, H): m-tiles per cluster, clusters
struct ChainPlan {
  int cs, mt, active, clusters;
};

cudaError_t chain_plan(int B, int H, ChainPlan* c) {
  c->cs = gc::cluster_blocks(H, kChainMaxBlocks);
  c->mt = c->active = c->clusters = 0;
  if (c->cs == 0) return cudaSuccess;
  const cudaError_t err = gc::active_clusters<kParts>(
      lstm_fwd_chain_kernel<kChainOnTensorCores>, c->cs,
      kChainSlices + kMeetSlices, kMTileThreads, kChainMaxMTiles,
      &c->active);
  if (err != cudaSuccess) return err;
  c->mt = gc::mtiles_for<kParts>(B, c->active, c->cs,
                                 kChainSlices + kMeetSlices, kChainMaxMTiles);
  c->clusters = (B + 16 * c->mt - 1) / (16 * c->mt);
  return cudaSuccess;
}

// the cluster chain's slices in global memory for every cluster (its
// batch rows round up by at most an m-tile set); none on the wide path
int64_t workspace_floats(int B, int H) {
  return (int64_t)kChainSlices * gc::kUnits *
         gc::cluster_blocks(H, kChainMaxBlocks) * (B + 16 * kChainMaxMTiles);
}

}  // namespace

extern "C" {

// Largest hidden width the call takes: the wide path's shared memory holds
// h, c and the gate pre-activations of one tile, 6 * kRows * H floats.  H
// must also be a multiple of 4 (h is read as float4).  Widths up to 416
// take the cluster chain, which holds any of them.
int paddle_lstm_fwd_max_hidden() {
  return static_cast<int>(kMaxSmem / (kRows * 6 * sizeof(float)));
}

// Blocks of the cluster whose chain width H takes, ceil(H / 32) for H <=
// 416; 0 for the wide path.  Decided before any launch, by H alone.
int paddle_lstm_fwd_cluster_size(int H) {
  return gc::cluster_blocks(H, kChainMaxBlocks);
}

// The launch paddle_lstm_fwd makes for (T, B, H) on the current device:
// out[0] the cluster size (0: the wide path), out[1] batch rows per
// cluster, out[2] clusters of that size the card runs at once, out[3]
// clusters launched.  Returns the first CUDA error (0 on success).
int paddle_lstm_fwd_plan(int T, int B, int H, int* out) {
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

// Bytes of device workspace paddle_lstm_fwd needs for (T, B, H): the
// cluster chain's exchange slices (0 on the wide path).
int64_t paddle_lstm_fwd_workspace_bytes(int T, int B, int H) {
  if (T < 1 || B < 1 || H < 1) return 0;
  return workspace_floats(B, H) * (int64_t)sizeof(float);
}

// x [T, B, 4H] (bias added), w [H, 4H], pw [3, H] (zeros without
// peepholes): contiguous float32 on the device, 16-byte aligned.  Writes
// hs, cs [T, B, H] and, when `gates` is not null, gates [T, B, 4H], on
// `stream`: the cluster chain for H <= 416, else the row-tiled loop.
// `workspace` holds paddle_lstm_fwd_workspace_bytes(T, B, H) bytes.
// Returns the CUDA error of the launch (0 on success); does not
// synchronise.
int paddle_lstm_fwd(const void* x, const void* w, const void* pw, void* hs,
                    void* cs, void* gates, void* workspace, int T, int B,
                    int H, void* stream) {
  if (T < 1 || B < 1 || H < 1 || H % 4 != 0 ||
      H > paddle_lstm_fwd_max_hidden())
    return static_cast<int>(cudaErrorInvalidValue);
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  const float* pwf = static_cast<const float*>(pw);
  float* hsf = static_cast<float*>(hs);
  float* csf = static_cast<float*>(cs);
  float* gf = static_cast<float*>(gates);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (gc::cluster_blocks(H, kChainMaxBlocks) > 0) {
    ChainPlan c;
    cudaError_t err = chain_plan(B, H, &c);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = gc::launch<kParts>(lstm_fwd_chain_kernel<kChainOnTensorCores>,
                             c.cs, c.mt, c.clusters,
                             kChainSlices + kMeetSlices, kMTileThreads, st,
                             xf, wf, pwf, hsf, csf, gf,
                             static_cast<float*>(workspace), T, B, H, c.mt);
    return static_cast<int>(err);
  }
  const size_t smem = smem_bytes(H);
  cudaError_t err = cudaFuncSetAttribute(
      lstm_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>((B + kRows - 1) / kRows);
  lstm_fwd_kernel<<<blocks, threads_for(H), smem, st>>>(
      xf, wf, pwf, hsf, csf, gf, T, B, H);
  return static_cast<int>(cudaGetLastError());
}

const char* paddle_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
