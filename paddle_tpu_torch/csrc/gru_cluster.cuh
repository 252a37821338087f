// The cluster engine of the recurrent kernels: a persistent thread-block
// cluster that keeps a recurrent weight resident in shared memory, split by
// hidden units across its blocks, and multiplies the cluster's per-step
// row vectors against it; and the tiles of their dW products.  Included by
// gru_fwd.cu, gru_bwd.cu and lstm_bwd.cu; ops/kernels/build.py rebuilds
// every library that includes it when it changes.
//
// Layout.  A cluster of `cs` blocks owns 16 * mt batch rows (mt m-tiles of
// 16 rows) and walks the time loop itself.  Block `rank` owns hidden units
// rank * 32 .. + 31 (kUnits) and keeps 32 rows of the weight for those
// units in shared memory, `w_s[32][ldw]`, the columns grouped in kParts
// parts of H_pad = 32 * cs (one part per gate, 3 for the GRU's weight
// [H, 3H], 4 for the LSTM's [H, 4H]: units past H are zero).  The
// backward computes A W^T and keeps W's rows of its units
// (`load_w_slice`); the forward computes h W and keeps W's columns of its
// units, transposed into the same layout (`load_w_cols`).  Each step a
// block writes its own units' values of a row vector (h, r * h, dc_pre,
// ...) into a "slice", A[16 mt rows][32 units] stored in the order of the
// mma.sync m16n8k8 A fragment (one float4 per lane per k-step of 8 units),
// so that a reader takes a whole fragment in one 16-byte load.  A product
// `acc[g][row][unit] = sum_n A[row][n] w_s[unit][n + g * gcols]` walks the
// cluster's slices: slice (peer p, part) covers n in p * 32 .. + 31 of that
// part; each of kGroups column groups (the forward's update and reset
// columns in gru_fwd.cu's kSharedA form) takes the same A fragments,
// loaded and split once.  A peer's
// slice is read from its shared memory through DSMEM or from its copy in
// global memory (L2; `slice_products`' kL2); the cluster barrier orders
// both.
//
// Warps.  Each m-tile takes kShares warps, share s computing all 32 own
// units of its 16 rows over its share of the slices, each slice's partial
// summed from zero (the tensor cores add toward zero) and then added in
// float32.  The GRU kernels take K halves (warp w is (m-tile w / 2, half
// w % 2)), which meet in `pair_reduce`; the LSTM's chain takes more shares,
// which meet in `share_reduce`.  Each thread then holds the final values of
// 16 / kShares (row, unit) pairs of the C fragment (8 for a K half: those of
// n-tiles 2 * half and 2 * half + 1): the recurrent carry stays in
// registers.  No atomics anywhere: every sum has one fixed order, so two
// runs agree bitwise.
//
// Products on the tensor cores take 3xTF32 (flash_tf32.cuh, float32
// accuracy; never one plain TF32 product), or on the CUDA cores the same
// fragments spread over a quad by shuffles (`kTC = false`, the probes'
// comparison).
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_tf32.cuh"

namespace gru_cluster {

namespace cg = cooperative_groups;

constexpr int kUnits = 32;                 // hidden units a block owns
constexpr int kNTiles = kUnits / 8;        // mma n-tiles over them
constexpr int kSliceSteps = kUnits / 8;    // k-steps of 8 in one slice
constexpr int kMaxBlocks = 16;             // the non-portable cluster size
constexpr int kMaxMTiles = 5;              // 16-row m-tiles per cluster
constexpr int kPairThreads = 64;           // an m-tile's two K halves
constexpr int kMaxThreads = kPairThreads * kMaxMTiles;
constexpr int kMaxHidden = kUnits * kMaxBlocks;
constexpr int kSmemLimit = 232448;

// blocks of the cluster that holds a weight of width H, at most `cap`
// (0: none does)
__host__ __device__ inline int cluster_blocks(int H, int cap = kMaxBlocks) {
  return H >= 1 && H <= kUnits * cap ? (H + kUnits - 1) / kUnits : 0;
}
// row stride of w_s: kParts parts of 32 * cs columns, + 4 so that the
// eight rows of a B fragment fall in distinct banks (32 kParts cs + 4 = 4
// mod 32)
template <int kParts>
__host__ __device__ constexpr int w_stride(int cs) {
  return kParts * kUnits * cs + 4;
}
__host__ __device__ constexpr int slice_floats(int mt) {
  return mt * 16 * kUnits;
}
// shared memory of a block: w_s and `slices` slice buffers
template <int kParts>
__host__ __device__ constexpr size_t smem_bytes(int cs, int mt, int slices) {
  return sizeof(float) * ((size_t)kUnits * w_stride<kParts>(cs) +
                          (size_t)slices * slice_floats(mt));
}
// the most blocks whose W of kParts parts and `slices` slice buffers of one
// m-tile fit a block's shared memory, at most kMaxBlocks
template <int kParts>
__host__ __device__ constexpr int max_blocks(int slices) {
  int cs = kMaxBlocks;
  while (cs > 1 && smem_bytes<kParts>(cs, 1, slices) > (size_t)kSmemLimit)
    --cs;
  return cs;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// the two warps of one m-tile
__device__ __forceinline__ void pair_sync(int mt) {
  asm volatile("bar.sync %0, 64;" ::"r"(1 + mt) : "memory");
}
// the kShares warps of one m-tile
template <int kShares>
__device__ __forceinline__ void group_sync(int mt) {
  asm volatile("bar.sync %0, %1;" ::"r"(1 + mt), "r"(32 * kShares)
               : "memory");
}

// where A[row][unit] (row < 16 mt, unit < 32) sits in a slice: the float
// `slot` of lane `lane`'s float4 of k-step unit / 8 of m-tile row / 16
__device__ __forceinline__ int frag_index(int row, int unit) {
  const int rr = row & 15, cc = unit & 7;
  const int lane = (rr & 7) * 4 + (cc & 3);
  const int slot = (rr >> 3) + 2 * (cc >> 2);
  return (((row >> 4) * kSliceSteps + (unit >> 3)) * 32 + lane) * 4 + slot;
}

// The block's rows of w [H, kParts H] into w_s: row u is unit rank * 32 +
// u, its part q columns n < H are w[unit][q * H + n]; past H all zero.
// Float4 loads (H % 4 == 0).
template <int kParts>
__device__ inline void load_w_slice(float* w_s, const float* __restrict__ w,
                                    int H, int rank, int cs) {
  const int hp = kUnits * cs, ldw = w_stride<kParts>(cs);
  const int per_row = kParts * hp / 4;
  for (int i = threadIdx.x; i < kUnits * per_row; i += blockDim.x) {
    const int u = i / per_row, col = (i - u * per_row) * 4;
    const int q = col / hp, n = col - q * hp;
    const int unit = rank * kUnits + u;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (unit < H && n < H)
      v = __ldg(reinterpret_cast<const float4*>(
          w + (int64_t)unit * kParts * H + q * H + n));
    *reinterpret_cast<float4*>(w_s + u * ldw + col) = v;
  }
}

// The block's columns of w [H, kParts H] into w_s, transposed: row u is
// unit rank * 32 + u, its part q columns k < H are w[k][q * H + unit]; past
// H all zero.  A float4 of w (4 units of row k; H % 4 == 0) goes to 4 rows
// of w_s: a load made once a call.
template <int kParts>
__device__ inline void load_w_cols(float* w_s, const float* __restrict__ w,
                                   int H, int rank, int cs) {
  const int hp = kUnits * cs, ldw = w_stride<kParts>(cs);
  constexpr int kQuads = kUnits / 4;
  for (int i = threadIdx.x; i < kParts * hp * kQuads; i += blockDim.x) {
    const int u4 = i % kQuads, kq = i / kQuads;
    const int q = kq / hp, k = kq - q * hp;
    const int unit = rank * kUnits + 4 * u4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (unit < H && k < H)
      v = __ldg(reinterpret_cast<const float4*>(
          w + (int64_t)k * kParts * H + q * H + unit));
    float* d = w_s + 4 * u4 * ldw + q * hp + k;
    d[0] = v.x;
    d[ldw] = v.y;
    d[2 * ldw] = v.z;
    d[3 * ldw] = v.w;
  }
}

// The 3xTF32 split x = big + small, by kSplit: 0 as flash_tf32::split,
// both parts rounded to nearest (the terms dropped below 2^-22 of |x|);
// 1 (the probe's comparison) small passed whole, which the tensor core
// reads truncated to TF32 (below 2^-21), two operations fewer.
template <int kSplit>
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  if constexpr (kSplit == 0) {
    flash_tf32::split(x, big, small);
  } else {
    big = flash_tf32::to_tf32(x);
    small = __float_as_uint(x - __uint_as_float(big));
  }
}

// c += a.b with both operands split: the small cross terms, then big.big
__device__ __forceinline__ void mma3_split(float (&c)[4],
                                           const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4],
                                           uint32_t bb0, uint32_t bs0,
                                           uint32_t bb1, uint32_t bs1) {
  flash_tf32::mma_tf32(c, as, bb0, bb1);
  flash_tf32::mma_tf32(c, ab, bs0, bs1);
  flash_tf32::mma_tf32(c, ab, bb0, bb1);
}

// part[gi][nt] += A (one k-step fragment a) times w_s columns col + gi *
// gcols .. + 7 of the 32 units, for each of kGroups column groups on the
// same fragment (split or spread once), on the tensor cores (3xTF32, split
// by kSplit) or the CUDA cores
template <bool kTC, int kSplit, int kGroups>
__device__ __forceinline__ void kstep(float (&part)[kGroups][kNTiles][4],
                                      float4 a, const float* w_s, int ldw,
                                      int col, int gcols, int lane) {
  const int g = lane >> 2, t = lane & 3;
  if constexpr (kTC) {
    uint32_t ab[4], as[4];
    split_tf32<kSplit>(a.x, ab[0], as[0]);
    split_tf32<kSplit>(a.y, ab[1], as[1]);
    split_tf32<kSplit>(a.z, ab[2], as[2]);
    split_tf32<kSplit>(a.w, ab[3], as[3]);
#pragma unroll
    for (int gi = 0; gi < kGroups; ++gi)
#pragma unroll
      for (int nt = 0; nt < kNTiles; ++nt) {
        const float* wb = w_s + (nt * 8 + g) * ldw + col + gi * gcols + t;
        uint32_t bb0, bs0, bb1, bs1;
        split_tf32<kSplit>(wb[0], bb0, bs0);
        split_tf32<kSplit>(wb[4], bb1, bs1);
        mma3_split(part[gi][nt], ab, as, bb0, bs0, bb1, bs1);
      }
  } else {
    // rows g and g + 8 of the fragment, all 8 k, from the quad
    float r0[8], r1[8];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int src = (lane & ~3) | q;
      r0[q] = __shfl_sync(0xffffffffu, a.x, src);
      r1[q] = __shfl_sync(0xffffffffu, a.y, src);
      r0[q + 4] = __shfl_sync(0xffffffffu, a.z, src);
      r1[q + 4] = __shfl_sync(0xffffffffu, a.w, src);
    }
#pragma unroll
    for (int gi = 0; gi < kGroups; ++gi)
#pragma unroll
      for (int nt = 0; nt < kNTiles; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float4* wp = reinterpret_cast<const float4*>(
              w_s + (nt * 8 + 2 * t + e) * ldw + col + gi * gcols);
          const float4 w0 = wp[0], w1 = wp[1];
          const float wv[8] = {w0.x, w0.y, w0.z, w0.w,
                               w1.x, w1.y, w1.z, w1.w};
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            part[gi][nt][e] = fmaf(r0[k], wv[k], part[gi][nt][e]);
            part[gi][nt][2 + e] = fmaf(r1[k], wv[k], part[gi][nt][2 + e]);
          }
        }
  }
}

// The block's slices (`floats` of them from `s`) into their copy in
// global memory, `g` (16-byte stores that skip L1; peers read them with
// __ldcg after the next cluster barrier).  A block barrier first: all
// warps wrote the slices.
__device__ __forceinline__ void slices_to_global(float* g, const float* s,
                                                 int floats) {
  __syncthreads();
  for (int i = threadIdx.x; i < floats / 4; i += blockDim.x)
    __stcg(reinterpret_cast<float4*>(g) + i,
           reinterpret_cast<const float4*>(s)[i]);
}

// acc += this warp's share of the product of the cluster's slices with
// w_s: slices s in [s_begin, s_end), slice s being part s % parts of peer
// s / parts, against w_s columns col0 + part * part_cols + 32 * peer (+ gi
// * gcols for group gi of kGroups).  A slice sits at `buf` + part *
// slice_floats(mt) in the peer's shared memory, read through DSMEM, or,
// with kL2, at gbuf + peer * gpeer + part * slice_floats(mt) in global
// memory, read from L2 (the block's own always from its shared memory).
// The next slice's fragments load while this one multiplies; each slice's
// partial is added to acc in slice order.
template <bool kTC, int kSplit, bool kL2, int kGroups>
__device__ inline void slice_products(float (&acc)[kGroups][kNTiles][4],
                                      const float* buf, const float* gbuf,
                                      int gpeer, int parts, int mt,
                                      int mtile, const float* w_s, int ldw,
                                      int col0, int part_cols, int gcols,
                                      int s_begin, int s_end, int lane) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int sf = slice_floats(mt);
  const int idx = mtile * kSliceSteps * 32 + lane;
  float4 cur[kSliceSteps], nxt[kSliceSteps];
  auto load = [&](float4 (&v)[kSliceSteps], int s) {
    const int peer = s / parts, part = s - peer * parts;
    if (kL2 && peer != rank) {
      const float4* src = reinterpret_cast<const float4*>(
          gbuf + peer * gpeer + part * sf) + idx;
#pragma unroll
      for (int ks = 0; ks < kSliceSteps; ++ks) v[ks] = __ldcg(src + ks * 32);
    } else {
      const float4* src = reinterpret_cast<const float4*>(
          cluster.map_shared_rank(const_cast<float*>(buf) + part * sf,
                                  peer)) + idx;
#pragma unroll
      for (int ks = 0; ks < kSliceSteps; ++ks) v[ks] = src[ks * 32];
    }
  };
  if (s_begin < s_end) load(cur, s_begin);
  for (int s = s_begin; s < s_end; ++s) {
    if (s + 1 < s_end) load(nxt, s + 1);
    const int peer = s / parts, part = s - peer * parts;
    const int col = col0 + part * part_cols + peer * kUnits;
    float p[kGroups][kNTiles][4];
#pragma unroll
    for (int gi = 0; gi < kGroups; ++gi)
#pragma unroll
      for (int nt = 0; nt < kNTiles; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) p[gi][nt][e] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < kSliceSteps; ++ks)
      kstep<kTC, kSplit, kGroups>(p, cur[ks], w_s, ldw, col + ks * 8, gcols,
                                  lane);
#pragma unroll
    for (int gi = 0; gi < kGroups; ++gi)
#pragma unroll
      for (int nt = 0; nt < kNTiles; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[gi][nt][e] += p[gi][nt][e];
    if (s + 1 < s_end)
#pragma unroll
      for (int ks = 0; ks < kSliceSteps; ++ks) cur[ks] = nxt[ks];
  }
}

// The two K halves of m-tile `mtile` meet: each warp hands the other its
// partials of the other's n-tiles through `red` (this m-tile's part of a
// slice buffer that no peer reads at this point: slice_floats(1) floats
// at frag_index(16 * mtile, 0)) and keeps fin[i] = the sum for n-tile
// 2 * half + i.  A two-term sum has one value in either order.  The pair
// syncs again before returning, so the caller may overwrite `red`.
__device__ __forceinline__ void pair_reduce(const float (&acc)[kNTiles][4],
                                            float (&fin)[2][4], float* red,
                                            int mtile, int half, int lane) {
  float4* mine = reinterpret_cast<float4*>(red) + half * 64;
  const float4* other = reinterpret_cast<const float4*>(red) +
                        (half ^ 1) * 64;
  if (half == 0) {   // hand over n-tiles 2, 3; keep 0, 1
    mine[lane] = make_float4(acc[2][0], acc[2][1], acc[2][2], acc[2][3]);
    mine[32 + lane] = make_float4(acc[3][0], acc[3][1], acc[3][2], acc[3][3]);
  } else {
    mine[lane] = make_float4(acc[0][0], acc[0][1], acc[0][2], acc[0][3]);
    mine[32 + lane] = make_float4(acc[1][0], acc[1][1], acc[1][2], acc[1][3]);
  }
  pair_sync(mtile);
  const float4 o0 = other[lane], o1 = other[32 + lane];
  if (half == 0) {
    fin[0][0] = acc[0][0] + o0.x; fin[0][1] = acc[0][1] + o0.y;
    fin[0][2] = acc[0][2] + o0.z; fin[0][3] = acc[0][3] + o0.w;
    fin[1][0] = acc[1][0] + o1.x; fin[1][1] = acc[1][1] + o1.y;
    fin[1][2] = acc[1][2] + o1.z; fin[1][3] = acc[1][3] + o1.w;
  } else {
    fin[0][0] = acc[2][0] + o0.x; fin[0][1] = acc[2][1] + o0.y;
    fin[0][2] = acc[2][2] + o0.z; fin[0][3] = acc[2][3] + o0.w;
    fin[1][0] = acc[3][0] + o1.x; fin[1][1] = acc[3][1] + o1.y;
    fin[1][2] = acc[3][2] + o1.z; fin[1][3] = acc[3][3] + o1.w;
  }
  pair_sync(mtile);
}

// The kShares warps of m-tile `mtile` meet: share s writes its partials
// (4 n-tiles x 4 per lane) into scratch region s, an m-tile region of a
// slice (slice_floats(1) floats): regions 0-3 at `free_base` + s * sf (a
// slice buffer nobody reads in this step), 4-7 at `cur_base` + (s - 4) *
// sf (this m-tile's part of the step's own slices, which with the exchange
// through L2 only this m-tile's warps read, from shared memory, in
// slice_products).  With more than 4 shares the group syncs first, so that
// no share overwrites an own slice that another is still to read.  Each
// warp then sums its 16 / kShares owned values, acc indices share *
// (16 / kShares) .. (nt * 4 + e), over the shares in index order into fin.
// The group syncs again before returning, so the caller may overwrite the
// regions.
template <int kShares>
__device__ __forceinline__ void share_reduce(
    const float (&acc)[kNTiles][4], float (&fin)[16 / kShares],
    float* free_base, float* cur_base, int sf, int mtile, int share,
    int lane) {
  constexpr int kOwn = 16 / kShares;
  static_assert(kShares >= 2 && kShares <= 8 && 16 % kShares == 0,
                "2, 4 or 8 shares");
  if constexpr (kShares > 4) group_sync<kShares>(mtile);
  float4* mine = reinterpret_cast<float4*>(
      (share < 4 ? free_base : cur_base) + (share & 3) * sf);
#pragma unroll
  for (int nt = 0; nt < kNTiles; ++nt)
    mine[nt * 32 + lane] =
        make_float4(acc[nt][0], acc[nt][1], acc[nt][2], acc[nt][3]);
  group_sync<kShares>(mtile);
#pragma unroll
  for (int s = 0; s < kShares; ++s) {
    const float* r = (s < 4 ? free_base : cur_base) + (s & 3) * sf;
#pragma unroll
    for (int v = 0; v < kOwn; v += 2) {
      const int idx = share * kOwn + v;
      const float2 x = *reinterpret_cast<const float2*>(
          r + ((idx >> 2) * 32 + lane) * 4 + (idx & 3));
      fin[v] = s == 0 ? x.x : fin[v] + x.x;
      fin[v + 1] = s == 0 ? x.y : fin[v + 1] + x.y;
    }
  }
  group_sync<kShares>(mtile);
}

// m-tiles of a cluster: at most max_mt and what shared memory holds
template <int kParts>
inline int fit_mtiles(int cs, int slices, int max_mt) {
  int mt = max_mt;
  while (mt > 1 && smem_bytes<kParts>(cs, mt, slices) > (size_t)kSmemLimit)
    --mt;
  return mt;
}

// *n = clusters of `cs` blocks (at the most m-tiles a launch takes, up to
// max_mt, of mtile_threads threads each: the most shared memory and
// threads) that the card runs at once, for `kernel` with `slices` slice
// buffers; cached per device and cluster size
template <int kParts, typename Kernel>
cudaError_t active_clusters(Kernel kernel, int cs, int slices,
                            int mtile_threads, int max_mt, int* n) {
  static int cache[16][kMaxBlocks + 1];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 0 && dev < 16 && cache[dev][cs] > 0) {
    *n = cache[dev][cs];
    return cudaSuccess;
  }
  const int mt = fit_mtiles<kParts>(cs, slices, max_mt);
  const size_t smem = smem_bytes<kParts>(cs, mt, slices);
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs);
  cfg.blockDim = dim3(mtile_threads * mt);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaOccupancyMaxActiveClusters(n, kernel, &cfg);
  if (err != cudaSuccess) return err;
  if (*n < 1) return cudaErrorLaunchOutOfResources;
  if (dev >= 0 && dev < 16) cache[dev][cs] = *n;
  return cudaSuccess;
}

// m-tiles per cluster for B rows: enough that one wave of `active`
// clusters covers B, at most max_mt and what shared memory holds
template <int kParts>
inline int mtiles_for(int B, int active, int cs, int slices, int max_mt) {
  const int tiles = (B + 15) / 16;
  int mt = active > 0 ? (tiles + active - 1) / active : max_mt;
  if (mt > max_mt) mt = max_mt;
  if (mt < 1) mt = 1;
  const int fit = fit_mtiles<kParts>(cs, slices, max_mt);
  return mt < fit ? mt : fit;
}

// launch `kernel` over `clusters` clusters of `cs` blocks of mtile_threads
// * mt threads
template <int kParts, typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, int cs, int mt, int clusters, int slices,
                   int mtile_threads, cudaStream_t st, Args... args) {
  const size_t smem = smem_bytes<kParts>(cs, mt, slices);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(clusters * cs));
  cfg.blockDim = dim3(static_cast<unsigned>(mtile_threads * mt));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// dW tiles.  dW = sum over the T * B rows m of a[m]^T dx[m], a[m] =
// h_prev[m] (h0, zeros when null, for the first B rows; hs[m - B] after),
// as 64 x 128 output tiles on the tensor cores (3xTF32 mma.sync m16n8k8,
// split by kSplit), the rows of a and dx coming through a 3-stage cp.async
// ring, 32 rows of T * B a stage.  8 warps, each 32 x 32 of the tile
// (kDwMI m-tiles of 16 by 4 n-tiles of 8); each stage's partial summed from
// zero and then added in float32; fragment reads fall in distinct banks
// (row strides = 8 mod 32).  The rows are split into S contiguous ranges
// (`dw_splits`), each writing its range's sum.  With kGated (the GRU) the
// last part's tiles (blockIdx.x >= rz_tiles) multiply r[m] * h_prev[m]
// instead, r = gates[m][H .. 2H) formed as each fragment is read.
constexpr int kDwBM = 64;
constexpr int kDwBN = 128;
constexpr int kDwBK = 32;
constexpr int kDwStages = 3;
constexpr int kDwThreads = 256;
constexpr int kDwBlocksPerSm = 2;
constexpr int kDwMI = kDwBM / 32;
constexpr int kDwLdA = kDwBM + 8;
constexpr int kDwLdB = kDwBN + 8;
constexpr int kDwMaxSplits = 16;
constexpr int64_t kDwMaxPartialBytes = int64_t(64) << 20;
// a stage: h_prev [kDwBK][kDwLdA], with kGated r [kDwBK][kDwLdA], then dx
// [kDwBK][kDwLdB]
template <bool kGated>
__host__ __device__ constexpr int dw_stage_floats() {
  return kDwBK * ((kGated ? 2 : 1) * kDwLdA + kDwLdB);
}
template <bool kGated>
__host__ __device__ constexpr int dw_smem() {
  return kDwStages * dw_stage_floats<kGated>() * (int)sizeof(float);
}

// One 64 x 128 tile of dW (k0 = blockIdx.y * 64, n0 by blockIdx.x) summed
// over rows m of T * B in range blockIdx.z (chunk rows a range) into out +
// blockIdx.z * H * kParts H.
template <int kParts, bool kGated, int kSplit>
__device__ __forceinline__ void dw_tile(
    const float* __restrict__ hs, const float* __restrict__ h0,
    const float* __restrict__ gates, const float* __restrict__ dx,
    float* __restrict__ out, int64_t M, int64_t chunk, int B, int H,
    int rz_tiles) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kStage = dw_stage_floats<kGated>();
  const int G = kParts * H;
  const bool cand = kGated && static_cast<int>(blockIdx.x) >= rz_tiles;
  const int n0 = cand ? (kParts - 1) * H +
                            (static_cast<int>(blockIdx.x) - rz_tiles) * kDwBN
                      : static_cast<int>(blockIdx.x) * kDwBN;
  const int n_end = cand || !kGated ? G : (kParts - 1) * H;
  const int k0 = blockIdx.y * kDwBM;
  const int64_t m_begin = blockIdx.z * chunk;
  const int64_t m_end = min(M, m_begin + chunk);
  const int steps = static_cast<int>((m_end - m_begin + kDwBK - 1) / kDwBK);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wk = warp >> 2, wn = warp & 3;

  auto load = [&](int s, int64_t m0) {
    float* a_s = smem + s * kStage;
    float* r_s = a_s + kDwBK * kDwLdA;
    float* b_s = a_s + (kGated ? 2 : 1) * kDwBK * kDwLdA;
#pragma unroll
    for (int i = 0; i < kDwBK * kDwBM / 4 / kDwThreads; ++i) {
      const int idx = tid + i * kDwThreads;
      const int rr = idx / (kDwBM / 4), cc = (idx % (kDwBM / 4)) * 4;
      const int64_t m = m0 + rr;
      const int k = k0 + cc;
      const bool live = m < m_end && k < H;
      const float* src = nullptr;
      if (live)
        src = m >= B ? hs + (m - B) * H + k
                     : (h0 != nullptr ? h0 + m * H + k : nullptr);
      flash_tf32::cp_async16(a_s + rr * kDwLdA + cc,
                             src != nullptr ? src : hs, src != nullptr);
      if (cand)
        flash_tf32::cp_async16(r_s + rr * kDwLdA + cc,
                               live ? gates + m * G + H + k : gates, live);
    }
#pragma unroll
    for (int i = 0; i < kDwBK * kDwBN / 4 / kDwThreads; ++i) {
      const int idx = tid + i * kDwThreads;
      const int rr = idx / (kDwBN / 4), cc = (idx % (kDwBN / 4)) * 4;
      const int64_t m = m0 + rr;
      const int n = n0 + cc;
      const bool live = m < m_end && n < n_end;
      flash_tf32::cp_async16(b_s + rr * kDwLdB + cc,
                             live ? dx + m * G + n : dx, live);
    }
  };

  float acc[kDwMI][4][4];
#pragma unroll
  for (int mi = 0; mi < kDwMI; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mi][ni][i] = 0.0f;
#pragma unroll
  for (int s = 0; s < kDwStages - 1; ++s) {
    if (s < steps) load(s, m_begin + (int64_t)s * kDwBK);
    flash_tf32::cp_async_commit();
  }
  for (int it = 0; it < steps; ++it) {
    flash_tf32::cp_async_wait<kDwStages - 2>();
    __syncthreads();
    const int nx = it + kDwStages - 1;
    if (nx < steps) load(nx % kDwStages, m_begin + (int64_t)nx * kDwBK);
    flash_tf32::cp_async_commit();
    const float* a_s = smem + (it % kDwStages) * kStage;
    const float* r_s = a_s + kDwBK * kDwLdA;
    const float* b_s = a_s + (kGated ? 2 : 1) * kDwBK * kDwLdA;
    float part[kDwMI][4][4];
#pragma unroll
    for (int mi = 0; mi < kDwMI; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int i = 0; i < 4; ++i) part[mi][ni][i] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < kDwBK / 8; ++kk) {
      const int r0 = (kk * 8 + t4) * kDwLdA, r1 = r0 + 4 * kDwLdA;
      uint32_t ab[kDwMI][4], as[kDwMI][4];
#pragma unroll
      for (int mi = 0; mi < kDwMI; ++mi) {
        const int col = wk * (kDwBM / 2) + mi * 16 + g;
        float a0 = a_s[r0 + col], a1 = a_s[r0 + col + 8];
        float a2 = a_s[r1 + col], a3 = a_s[r1 + col + 8];
        if (cand) {
          a0 *= r_s[r0 + col];
          a1 *= r_s[r0 + col + 8];
          a2 *= r_s[r1 + col];
          a3 *= r_s[r1 + col + 8];
        }
        split_tf32<kSplit>(a0, ab[mi][0], as[mi][0]);
        split_tf32<kSplit>(a1, ab[mi][1], as[mi][1]);
        split_tf32<kSplit>(a2, ab[mi][2], as[mi][2]);
        split_tf32<kSplit>(a3, ab[mi][3], as[mi][3]);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int ncol = wn * 32 + ni * 8 + g;
        uint32_t bb0, bs0, bb1, bs1;
        split_tf32<kSplit>(b_s[(kk * 8 + t4) * kDwLdB + ncol], bb0, bs0);
        split_tf32<kSplit>(b_s[(kk * 8 + t4 + 4) * kDwLdB + ncol], bb1, bs1);
#pragma unroll
        for (int mi = 0; mi < kDwMI; ++mi)
          mma3_split(part[mi][ni], ab[mi], as[mi], bb0, bs0, bb1, bs1);
      }
    }
#pragma unroll
    for (int mi = 0; mi < kDwMI; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mi][ni][i] += part[mi][ni][i];
  }
  float* o = out + (int64_t)blockIdx.z * H * G;
#pragma unroll
  for (int mi = 0; mi < kDwMI; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int k = k0 + wk * (kDwBM / 2) + mi * 16 + g + 8 * hh;
        const int n = n0 + wn * 32 + ni * 8 + 2 * t4;
        if (k < H && n < n_end)
          *reinterpret_cast<float2*>(o + (int64_t)k * G + n) =
              make_float2(acc[mi][ni][2 * hh], acc[mi][ni][2 * hh + 1]);
      }
}

// SMs of the current device (132 when it cannot be read)
inline int sm_count() {
  static int cache[16];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 16) return 132;
  if (cache[dev] == 0) {
    int n = 0;
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    cache[dev] = n > 0 ? n : 132;
  }
  return cache[dev];
}

// dW's row ranges for `tiles` output tiles over M rows, with partials of
// `gh` floats: the S <= kDwMaxSplits (partials within kDwMaxPartialBytes)
// that gives the least waves of blocks per range, fewest ranges on a tie.
// Returns S; *chunk = rows a range.
inline int dw_splits(int64_t tiles, int64_t M, int64_t gh, int64_t* chunk) {
  const int64_t slots = (int64_t)kDwBlocksPerSm * sm_count();
  const int64_t stages = (M + kDwBK - 1) / kDwBK;
  int64_t best = 1, best_waves = (tiles + slots - 1) / slots;
  for (int64_t s = 2; s <= kDwMaxSplits && s <= stages &&
                      s * gh * (int64_t)sizeof(float) <= kDwMaxPartialBytes;
       ++s) {
    const int64_t waves = (tiles * s + slots - 1) / slots;
    if (waves * best < best_waves * s) {
      best = s;
      best_waves = waves;
    }
  }
  *chunk = ((stages + best - 1) / best) * kDwBK;
  return static_cast<int>((M + *chunk - 1) / *chunk);
}

}  // namespace gru_cluster
