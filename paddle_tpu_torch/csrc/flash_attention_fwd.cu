// Flash-attention forward for Hopper (sm_90a), behind a plain C interface.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/flash_attention.py
// `_fa_kernel` (launched by `_fa_forward`): online-softmax attention over
// [BH, T, D] that returns the output and the per-row logsumexp, skips the
// key tiles a causal mask leaves dead, and places queries and keys on a
// global position axis (q_offset, k_offset) for the causal mask.
//
// What bounds it on an H100.  Per live (q, k) pair it does 4 * D flops
// (s = q.k and o += p v).  At the training shape (BH = 256, T = 512,
// D = 64, float32, causal) that is 8.6 GFLOP against 134 MB moved: on the
// CUDA cores' float32 peak (67 TFLOP/s) the flops bound it at 0.128 ms,
// on the tensor cores at float32 accuracy (3xTF32 below: 495 / 3 =
// 165 TFLOP/s) at 0.052 ms, where the bytes take 0.040 ms.  At 128K
// (BH = 8, T = 131072) the bounds are 262.6 ms and 106.6 ms.  At the decode
// engine's prefill shapes (BH = 8, T <= 256) a call is under a microsecond
// of work either way: launch latency and the serial k-tile walk set its
// time.
//
// Design.  The [Tq, Tk] score matrix never leaves the block, as in the
// TPU kernel.  Float32 inputs take the 3xTF32 engine below; bfloat16 and
// float16 inputs a 16-bit engine of their own (fwd16_block, "16-bit
// inputs" at the end of this note).
//   - One block per (bh, 64-row q tile); 128 threads, four warps of 16
//     query rows.  The q tile is loaded once in float32 and scaled by the
//     softmax scale (the TPU launcher's convention) times log2(e), so the
//     scores are in base 2 and the softmax takes exp2.  At D <= 64 each
//     thread then holds its q fragments in registers and the block keeps
//     only the K/V ring in shared memory (68 KB at D = 64); at D = 128 q
//     stays in shared memory.
//   - Both products run on the tensor cores, mma.sync m16n8k8 in TF32 with
//     float32 accumulation, at float32 accuracy by the 3xTF32 split (as
//     CUTLASS's OpMultiplyAddFastF32): each operand x becomes
//     big = tf32(x) (rounded to the 10-bit mantissa, to nearest as
//     cvt.rna rounds, so the tensor core reads it whole) and small =
//     tf32(x - big) (x - big is exact in float32), and a.b = a_small.b_big
//     + a_big.b_small + a_big.b_big; the dropped a_small.b_small is below
//     2^-22 relative.
//     Plain TF32 (three decimal digits) is not used.
//   - mma.sync, not wgmma: for .tf32 wgmma needs both operands K-major in
//     shared memory, but v in p.v is N-major.  mma.sync fragments are read
//     thread by thread, so any layout serves.  Rows are padded to D + 4
//     floats, so each fragment read below hits 32 distinct banks.
//   - s stays in registers as the accumulator fragments.  For p.v the
//     accumulator fragment of p is reused as the A operand with no shuffle:
//     a thread holds keys 2t and 2t + 1 of each 8-key step, and the two
//     k slots of its A fragment take them, v being read in the same order
//     (any permutation of k inside one mma step leaves the sum unchanged).
//   - The row max and row sum reduce over the quad of lanes that holds a
//     row (shuffles by 1 and 2); each thread carries two rows.
//   - The tensor cores add in round-toward-zero, so a running accumulator
//     would drift by an ulp per mma over a long walk; each k tile's p.v is
//     therefore summed from zero and added to o by a float32 FMA
//     (o = o * alpha + pv).
//   - K and V tiles go through a double-buffered ring in shared memory,
//     loaded by cp.async one tile ahead, so the next copy overlaps the
//     current tile's products; q comes by cp.async too (float32 inputs
//     with D % 4 == 0 and 16-byte aligned pointers; other inputs are
//     loaded by the threads, converted to float32, into the same places).
//   - Only a tile that the ragged edge or the causal diagonal crosses is
//     masked (a test uniform in the block).  Masked probabilities are set
//     to zero explicitly, and a row that every key masks ends with o = 0,
//     lse = -1e30, as in the TPU kernel.  The ragged edge (rows past T,
//     columns past D) is masked here, not padded by copies: cp.async
//     zero-fills it.
//   - The k-tile loop stops at the last tile the causal mask leaves alive
//     (the TPU kernel's `_tile_alive`).
// What still bounds it: the CUDA-core work beside the products.  Each
// warp splits every K and V value it reads (five operations a value; four
// warps split the same tile), the softmax's shuffles and exp2 sit between
// the two products of each tile, and mma.sync reaches only part of the
// rate wgmma would.  The split rounds with integer operations: the
// cvt.rna.tf32.f32 conversion it replaces (same bits) runs on a slower
// pipe: with it this kernel took 1.4x its time at T = 512 on an H100.
//
// 16-bit inputs.  The function is the reference's on 16-bit q/k/v: q
// times the scale in the input type T, the scale rounded to T first
// ((q * scale).astype(q.dtype)), and p rounded to T before p.v; l sums the
// float32 p (ops/kernels/flash_attention.py, the plain version).  At the
// AMP training shape (BH = 256, T = 512, D = 64, causal) that is 8.6
// GFLOP on 16-bit tensor cores (989 TFLOP/s: 8.7 us) against 68 MB moved
// (20 us at 3.35 TB/s): the bytes bound it.
//   - Same block, warps, walk, masking, dead-tile stop and float32 online
//     softmax as the float32 engine; one m16n8k16 bf16/f16 mma.sync
//     (float32 sums, flash_f16.cuh) where that engine runs three TF32
//     ones, so no operand is split.
//   - Tiles stay 16-bit: q and a two-stage K/V ring of [64][D + 8] values
//     (46 KB at D = 64), staged by cp.async 16 bytes a copy, the next K/V
//     tile in flight during the current tile's products; the 16 bytes of
//     padding keep ldmatrix's eight rows on distinct banks.  Where rows
//     are not 16-byte copies (D % 8 != 0, or an unaligned pointer) the
//     threads stage the same layout.
//   - q's A fragments come from ldmatrix once, are multiplied by the
//     rounded scale and rounded back to T in registers (a product of two
//     16-bit values is exact in float32, so that is T's product), and stay
//     there for the walk.  K's B fragments come from ldmatrix, V's from
//     ldmatrix.trans.  s is scaled to base 2 inside exp2 (one FFMA a
//     score), and p's accumulator fragments are rounded to T
//     (cvt.rn.bf16x2/f16x2) straight into the A fragments of p.v.
//   - Tiles and warps: 64 q rows and four warps, as the float32 engine, so
//     the causal walk, its dead tiles and the grid are the same; four
//     blocks an SM at D <= 64 (128 registers, 32 bytes of spill at D =
//     64), 4-5% faster than three at 168 registers.  128 q rows and eight
//     warps, which read K and V once for twice the rows, were no faster
//     (0.0889 ms at two blocks an SM, 0.104 at one, against 0.0894-0.0905
//     for three blocks of 64 rows; ops/kernels/flash16_probe.py, an H100
//     80GB HBM3 at 700 W), so K's and V's traffic does not bound it.
// What still bounds it: not the bytes (it runs at about 4.3x their 20
// us), nor K's and V's reuse.  Not measured apart: mma.sync issues a
// 16x8x16 product per warp instruction, where wgmma's 64-row products
// from shared memory would reach the full rate; the softmax (shuffles,
// exp2, rounding) sits between the two products of each tile in the same
// warps, with no second warpgroup to overlap it; and at T = 512 a block
// walks at most 8 k tiles, so its prologue (q's copy and ldmatrix) is a
// large share of it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_f16.cuh"
#include "flash_tf32.cuh"

namespace {

using namespace flash_tf32;

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;                       // 128
constexpr int kNTiles = kBlockK / 8;                        // 8 key tiles
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int DPAD>
__host__ __device__ constexpr int tile_floats() {
  return kBlockK * (DPAD + 4);
}

// a tile of kBlockK rows by cp.async over the block's threads
template <int DPAD>
__device__ __forceinline__ void copy_tile(float* dst, const float* src,
                                          int row0, int rows, int d) {
  copy_rows<DPAD, kBlockK, kThreads>(dst, src, row0, rows, d);
}

// q is held in registers (as raw float32 fragments) where they fit
template <int DPAD>
__host__ __device__ constexpr bool q_in_registers() {
  return DPAD <= 64;
}

template <int DPAD>
__host__ __device__ constexpr int smem_bytes() {
  // two stages each of the K and V tiles, [64][DPAD + 4], and the q tile
  // where q is not held in registers (else q passes through K's second
  // stage before the ring starts)
  return (q_in_registers<DPAD>() ? 4 : 5) * tile_floats<DPAD>() *
         static_cast<int>(sizeof(float));
}

// Stage rows [row0, row0 + 64) of a [rows, d] matrix into dst[64][DPAD + 4]
// as float32 times `mul`; rows past `rows` and columns past `d` read zero.
template <typename T, int DPAD>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0,
                                          int rows, int d, float mul) {
  for (int idx = threadIdx.x; idx < kBlockK * DPAD; idx += kThreads) {
    const int r = idx / DPAD;
    const int c = idx % DPAD;
    const int gr = row0 + r;
    float x = 0.f;
    if (gr < rows && c < d) x = to_float(src[(int64_t)gr * d + c]) * mul;
    dst[r * (DPAD + 4) + c] = x;
  }
}

// The 16-bit engine's block: kWarps16 warps of 16 q rows
constexpr int kWarps16 = 4;
constexpr int kBlockQ16 = 16 * kWarps16;
constexpr int kThreads16 = 32 * kWarps16;

// The 16-bit engine's shared memory: the q tile and two stages each of
// the K and V tiles, [rows][DPAD + 8] 16-bit values (46 KB at D = 64)
template <int DPAD>
__host__ __device__ constexpr int smem16_bytes() {
  return (kBlockQ16 + 4 * kBlockK) * flash_f16::stride<DPAD>() * 2;
}

template <typename T>
__host__ __device__ constexpr int threads() {
  return sizeof(T) == 4 ? kThreads : kThreads16;
}

// Blocks an SM the launch bounds ask for: float32 as before (three where q
// is held in registers, at most 168 registers a thread); 16-bit four at
// D <= 64 (at most 128 registers, a few bytes of spill at D = 64; 4-5%
// faster at the AMP training shape than three at 168 registers without
// spill, ops/kernels/flash16_probe.py), two at D = 128 (87 KB of shared
// memory each)
template <typename T, int DPAD>
__host__ __device__ constexpr int min_blocks() {
  if constexpr (sizeof(T) == 4) return q_in_registers<DPAD>() ? 3 : 1;
  return DPAD <= 64 ? 4 : 2;
}

// The 16-bit engine: one block's walk for head bh and q tile blockIdx.x
// on bfloat16 or float16 q, k, v (the header note's "16-bit inputs").
template <typename T, int DPAD>
__device__ __forceinline__ void fwd16_block(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
    int tq, int tk, int d, int causal, float scale, int q_offset,
    int k_offset, bool use_async, T* smem) {
  using namespace flash_f16;
  constexpr int S = stride<DPAD>();
  constexpr int TILE = kBlockK * S;
  constexpr int kSteps = DPAD / 16;   // k steps of s = q k^T over D
  constexpr int kNd = DPAD / 8;       // n tiles of o over D
  T* qs = smem;
  T* k_ring = qs + kBlockQ16 * S;
  T* v_ring = k_ring + 2 * TILE;

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBlockQ16;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;   // fragment row within 8
  const int t = lane & 3;    // lane within the row's quad
  const T* qb = q + (int64_t)bh * tq * d;
  const T* kb = k + (int64_t)bh * tk * d;
  const T* vb = v + (int64_t)bh * tk * d;

  int nk = (tk + kBlockK - 1) / kBlockK;
  if (causal) {
    const int q_last = q_offset + min(q0 + kBlockQ16, tq) - 1;
    const int k_last = q_last - k_offset;
    nk = min(nk, k_last < 0 ? 0 : k_last / kBlockK + 1);
  }
  // q, then (by cp.async) the first K and V tiles, each its own group
  stage_rows<T, DPAD, kBlockQ16, kThreads16>(qs, qb, q0, tq, d, use_async);
  if (use_async) {
    cp_async_commit();
    if (nk > 0) {
      stage_rows<T, DPAD, kBlockK, kThreads16>(k_ring, kb, 0, tk, d, true);
      stage_rows<T, DPAD, kBlockK, kThreads16>(v_ring, vb, 0, tk, d, true);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
  }
  __syncthreads();   // q is in place

  // ldmatrix row addresses of this lane: matrix mi = lane / 8, its row
  // lane % 8.  A (q; p as registers) takes the four matrices as rows
  // +0/+8 by columns +0/+8; B of q k^T as keys +0/+8 by columns +0/+8
  // (two n tiles, both k halves); B of p v, transposed, as keys +0/+8
  // by columns +0/+8 (both k halves, two n tiles)
  const int mi = lane >> 3, mr = lane & 7;
  const int a_off = (8 * (mi & 1) + mr) * S + 8 * (mi >> 1);
  const int k_off = (8 * (mi >> 1) + mr) * S + 8 * (mi & 1);
  const int v_off = (8 * (mi & 1) + mr) * S + 8 * (mi >> 1);

  // this warp's 16 rows of q as A fragments, times the scale rounded to T
  // and rounded to T (the reference's (q * scale).astype(q.dtype))
  const float scale_t = to_float(from_float<T>(scale));
  uint32_t qa[kSteps][4];
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
    ldsm4(qa[kk], qs + 16 * warp * S + 16 * kk + a_off);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = unpack<T>(qa[kk][i]);
      qa[kk][i] = pack<T>(f.x * scale_t, f.y * scale_t);
    }
  }

  // this thread's rows: r0 = 16 * warp + g and r0 + 8 of the tile; m in
  // the units of s, p = exp2(s log2(e) - m log2(e))
  const int r0 = 16 * warp + g;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};   // this thread's part of the row sums
  float acc[kNd][4];
#pragma unroll
  for (int j = 0; j < kNd; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kBlockK;
    T* ks = k_ring + (kt & 1) * TILE;
    T* vs = v_ring + (kt & 1) * TILE;
    if (use_async) {
      if (kt + 1 < nk) {
        // the stage it fills was last read before the previous barrier
        T* kn = k_ring + ((kt + 1) & 1) * TILE;
        T* vn = v_ring + ((kt + 1) & 1) * TILE;
        stage_rows<T, DPAD, kBlockK, kThreads16>(kn, kb, k0 + kBlockK, tk,
                                                 d, true);
        stage_rows<T, DPAD, kBlockK, kThreads16>(vn, vb, k0 + kBlockK, tk,
                                                 d, true);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
    } else {
      stage_rows<T, DPAD, kBlockK, kThreads16>(ks, kb, k0, tk, d, false);
      stage_rows<T, DPAD, kBlockK, kThreads16>(vs, vb, k0, tk, d, false);
    }
    __syncthreads();   // the tile is in place

    // s = q^ k^T for rows r0, r0 + 8 and the 64 keys, 8 n tiles
    float s[kNTiles][4];
#pragma unroll
    for (int j = 0; j < kNTiles; ++j)
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
#pragma unroll
      for (int jp = 0; jp < kNTiles / 2; ++jp) {
        uint32_t b[4];
        ldsm4(b, ks + 16 * jp * S + 16 * kk + k_off);
        mma<T>(s[2 * jp], qa[kk], b[0], b[1]);
        mma<T>(s[2 * jp + 1], qa[kk], b[2], b[3]);
      }
    }

    // mask, only on a tile that the ragged edge or the causal diagonal
    // crosses; element (j, i) is row r0 + 8 (i >> 1), key 8 j + 2 t +
    // (i & 1)
    unsigned valid = 0xffffffffu;
    float m_cur[2] = {kNegInf, kNegInf};
    const bool edge = k0 + kBlockK > tk ||
                      (causal && q_offset + q0 < k_offset + k0 + kBlockK - 1);
    if (edge) {
      valid = 0;
#pragma unroll
      for (int j = 0; j < kNTiles; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int kpos = k0 + 8 * j + 2 * t + (i & 1);
          const int qpos = q_offset + q0 + r0 + 8 * (i >> 1);
          const bool ok = kpos < tk && (!causal || qpos >= k_offset + kpos);
          valid |= (ok ? 1u : 0u) << (4 * j + i);
          s[j][i] = ok ? s[j][i] : kNegInf;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        m_cur[i >> 1] = fmaxf(m_cur[i >> 1], s[j][i]);
    }
    float alpha[2], mb[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m_cur[h] = fmaxf(m_cur[h], __shfl_xor_sync(0xffffffffu, m_cur[h], 1));
      m_cur[h] = fmaxf(m_cur[h], __shfl_xor_sync(0xffffffffu, m_cur[h], 2));
      const float m_new = fmaxf(m[h], m_cur[h]);
      alpha[h] = exp2f((m[h] - m_new) * kLog2e);
      m[h] = m_new;
      mb[h] = m_new * kLog2e;
      l[h] *= alpha[h];
    }
    // p in float32 (l sums it), then rounded to T two to a register: the
    // accumulator fragments of keys 16 kk .. + 15 are the A fragment of
    // p v's k step kk (keys 2t, 2t + 1 of each 8-key half)
    uint32_t pa[kNTiles / 2][4];
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // explicit zero: on a fully masked row s == m and exp(0) is 1
        const float p = ((valid >> (4 * j + i)) & 1u)
                            ? exp2f(fmaf(s[j][i], kLog2e, -mb[i >> 1]))
                            : 0.f;
        l[i >> 1] += p;
        s[j][i] = p;
      }
      pa[j >> 1][2 * (j & 1)] = pack<T>(s[j][0], s[j][1]);
      pa[j >> 1][2 * (j & 1) + 1] = pack<T>(s[j][2], s[j][3]);
    }

    // pv = p^ v from zero, two n tiles of o at a time, then
    // o = o * alpha + pv in float32
#pragma unroll
    for (int jp = 0; jp < kNd / 2; ++jp) {
      float pv[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < kNTiles / 2; ++kk) {
        uint32_t b[4];
        ldsm4_t(b, vs + 16 * kk * S + 16 * jp + v_off);
        mma<T>(pv[0], pa[kk], b[0], b[1]);
        mma<T>(pv[1], pa[kk], b[2], b[3]);
      }
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        float* a = acc[2 * jp + x];
        a[0] = fmaf(a[0], alpha[0], pv[x][0]);
        a[1] = fmaf(a[1], alpha[0], pv[x][1]);
        a[2] = fmaf(a[2], alpha[1], pv[x][2]);
        a[3] = fmaf(a[3], alpha[1], pv[x][3]);
      }
    }
    __syncthreads();   // every reader of this stage is done
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int r = q0 + r0 + 8 * h;
    if (r < tq) {
      const float l_safe = l[h] > 0.f ? l[h] : 1.f;
      T* orow = o + ((int64_t)bh * tq + r) * d;
#pragma unroll
      for (int j = 0; j < kNd; ++j) {
        const int col = 8 * j + 2 * t;
        if (col < d) orow[col] = from_float<T>(acc[j][2 * h] / l_safe);
        if (col + 1 < d)
          orow[col + 1] = from_float<T>(acc[j][2 * h + 1] / l_safe);
      }
      // lse in base e; a fully masked row keeps -1e30
      if (t == 0)
        lse[(int64_t)bh * tq + r] = l[h] > 0.f ? m[h] + logf(l[h]) : kNegInf;
    }
  }
}

// float32 by the 3xTF32 engine below (where q is held in registers, three
// blocks an SM: 68 KB of shared memory each at D = 64), bfloat16 and
// float16 by fwd16_block
template <typename T, int DPAD>
__global__ void __launch_bounds__(threads<T>(), min_blocks<T, DPAD>())
fa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o,
              float* __restrict__ lse, int tq, int tk, int d, int causal,
              float scale, int q_offset, int k_offset, int use_async) {
  extern __shared__ float4 smem4[];
  if constexpr (sizeof(T) == 2) {
    fwd16_block<T, DPAD>(q, k, v, o, lse, tq, tk, d, causal, scale,
                         q_offset, k_offset, use_async != 0,
                         reinterpret_cast<T*>(smem4));
  } else {
    constexpr int S = DPAD + 4;
    constexpr int TILE = tile_floats<DPAD>();
    constexpr int kSteps = DPAD / 8;   // mma k steps over D; n tiles of o
    constexpr bool kQRegs = q_in_registers<DPAD>();
    float* k_ring = reinterpret_cast<float*>(smem4) + (kQRegs ? 0 : TILE);
    float* v_ring = k_ring + 2 * TILE;
    float* qs = kQRegs ? k_ring + TILE : reinterpret_cast<float*>(smem4);

    const int bh = blockIdx.y;
    const int q0 = blockIdx.x * kBlockQ;
    const int warp = threadIdx.x >> 5;
    const int g = (threadIdx.x & 31) >> 2;   // fragment row within 8
    const int t = threadIdx.x & 3;           // lane within the row's quad
    const T* qb = q + (int64_t)bh * tq * d;
    const T* kb = k + (int64_t)bh * tk * d;
    const T* vb = v + (int64_t)bh * tk * d;

    int nk = (tk + kBlockK - 1) / kBlockK;
    if (causal) {
      // newest query of this tile on the global axis, and the newest key
      // it may see on the local axis: tiles past that one are dead
      const int q_last = q_offset + min(q0 + kBlockQ, tq) - 1;
      const int k_last = q_last - k_offset;
      nk = min(nk, k_last < 0 ? 0 : k_last / kBlockK + 1);
    }
    // q, then the first K and V tiles, each its own copy group
    if (use_async) {
      copy_tile<DPAD>(qs, reinterpret_cast<const float*>(qb), q0, tq, d);
      cp_async_commit();
      if (nk > 0) {
        copy_tile<DPAD>(k_ring, reinterpret_cast<const float*>(kb), 0, tk, d);
        copy_tile<DPAD>(v_ring, reinterpret_cast<const float*>(vb), 0, tk, d);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
    } else {
      load_tile<T, DPAD>(qs, qb, q0, tq, d, 1.f);
    }
    // the softmax scale is folded into q, as the TPU launcher does, with
    // log2(e): the scores are in base 2 and the softmax takes exp2
    const float q_mul = scale * kLog2e;

    // this thread's rows: r0 = 16 * warp + g and r0 + 8 of the tile
    const int r0 = 16 * warp + g;
    float qf[kQRegs ? kSteps : 1][4];   // A fragments of q, where held
    if constexpr (kQRegs) {
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        const float* qa = qs + r0 * S + 8 * kk + t;
        qf[kk][0] = qa[0] * q_mul;
        qf[kk][1] = qa[8 * S] * q_mul;
        qf[kk][2] = qa[4] * q_mul;
        qf[kk][3] = qa[8 * S + 4] * q_mul;
      }
      __syncthreads();   // K's second stage is free for the ring
    }
    float m[2] = {kNegInf, kNegInf};
    float l[2] = {0.f, 0.f};   // this thread's part of the row sums
    float acc[kSteps][4];
#pragma unroll
    for (int j = 0; j < kSteps; ++j)
      acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

    for (int kt = 0; kt < nk; ++kt) {
      const int k0 = kt * kBlockK;
      float* ks = k_ring + (kt & 1) * TILE;
      float* vs = v_ring + (kt & 1) * TILE;
      if (use_async) {
        if (kt + 1 < nk) {
          // the stage it fills was last read before the previous barrier
          float* kn = k_ring + ((kt + 1) & 1) * TILE;
          float* vn = v_ring + ((kt + 1) & 1) * TILE;
          copy_tile<DPAD>(kn, reinterpret_cast<const float*>(kb),
                          k0 + kBlockK, tk, d);
          copy_tile<DPAD>(vn, reinterpret_cast<const float*>(vb),
                          k0 + kBlockK, tk, d);
          cp_async_commit();
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
      } else {
        load_tile<T, DPAD>(ks, kb, k0, tk, d, 1.f);
        load_tile<T, DPAD>(vs, vb, k0, tk, d, 1.f);
      }
      __syncthreads();   // the tile (and on the first pass q) is in place

      // s = (scale q) k^T for rows r0, r0 + 8 and the 64 keys, 8 n tiles
      float s[kNTiles][4];
#pragma unroll
      for (int j = 0; j < kNTiles; ++j)
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        uint32_t ab[4], as[4];
        if constexpr (kQRegs) {
          split4(qf[kk][0], qf[kk][1], qf[kk][2], qf[kk][3], ab, as);
        } else {
          const float* qa = qs + r0 * S + 8 * kk + t;
          split4(qa[0] * q_mul, qa[8 * S] * q_mul, qa[4] * q_mul,
                 qa[8 * S + 4] * q_mul, ab, as);
        }
#pragma unroll
        for (int j = 0; j < kNTiles; ++j) {
          const float* kr = ks + (8 * j + g) * S + 8 * kk + t;
          mma3(s[j], ab, as, kr[0], kr[4]);
        }
      }

      // mask, only on a tile that the ragged edge or the causal diagonal
      // crosses (uniform in the block); element (j, i) is row r0 + 8 (i >>
      // 1), key 8 j + 2 t + (i & 1)
      unsigned valid = 0xffffffffu;
      float m_cur[2] = {kNegInf, kNegInf};
      const bool edge = k0 + kBlockK > tk ||
                        (causal && q_offset + q0 < k_offset + k0 + kBlockK - 1);
      if (edge) {
        valid = 0;
#pragma unroll
        for (int j = 0; j < kNTiles; ++j) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int kpos = k0 + 8 * j + 2 * t + (i & 1);
            const int qpos = q_offset + q0 + r0 + 8 * (i >> 1);
            const bool ok = kpos < tk && (!causal || qpos >= k_offset + kpos);
            valid |= (ok ? 1u : 0u) << (4 * j + i);
            s[j][i] = ok ? s[j][i] : kNegInf;
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kNTiles; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          m_cur[i >> 1] = fmaxf(m_cur[i >> 1], s[j][i]);
      }
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        m_cur[h] = fmaxf(m_cur[h], __shfl_xor_sync(0xffffffffu, m_cur[h], 1));
        m_cur[h] = fmaxf(m_cur[h], __shfl_xor_sync(0xffffffffu, m_cur[h], 2));
        const float m_new = fmaxf(m[h], m_cur[h]);
        alpha[h] = exp2f(m[h] - m_new);
        m[h] = m_new;
        l[h] *= alpha[h];
      }
#pragma unroll
      for (int j = 0; j < kNTiles; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          // explicit zero: on a fully masked row s == m and exp(0) is 1
          const float p = ((valid >> (4 * j + i)) & 1u)
                              ? exp2f(s[j][i] - m[i >> 1]) : 0.f;
          l[i >> 1] += p;
          s[j][i] = p;
        }
      }

      // pv = p v from zero (keys 2t, 2t + 1 in the A fragment's two k
      // slots, v read in that order), then o = o * alpha + pv
      float pv[kSteps][4];
#pragma unroll
      for (int j = 0; j < kSteps; ++j)
        pv[j][0] = pv[j][1] = pv[j][2] = pv[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kNTiles; ++kk) {
        uint32_t ab[4], as[4];
        split(s[kk][0], ab[0], as[0]);
        split(s[kk][2], ab[1], as[1]);
        split(s[kk][1], ab[2], as[2]);
        split(s[kk][3], ab[3], as[3]);
        const float* vr = vs + (8 * kk + 2 * t) * S + g;
#pragma unroll
        for (int j = 0; j < kSteps; ++j)
          mma3(pv[j], ab, as, vr[8 * j], vr[S + 8 * j]);
      }
#pragma unroll
      for (int j = 0; j < kSteps; ++j) {
        acc[j][0] = fmaf(acc[j][0], alpha[0], pv[j][0]);
        acc[j][1] = fmaf(acc[j][1], alpha[0], pv[j][1]);
        acc[j][2] = fmaf(acc[j][2], alpha[1], pv[j][2]);
        acc[j][3] = fmaf(acc[j][3], alpha[1], pv[j][3]);
      }
      __syncthreads();   // every reader of this stage is done
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      const int r = q0 + r0 + 8 * h;
      if (r < tq) {
        const float l_safe = l[h] > 0.f ? l[h] : 1.f;
        T* orow = o + ((int64_t)bh * tq + r) * d;
#pragma unroll
        for (int j = 0; j < kSteps; ++j) {
          const int col = 8 * j + 2 * t;
          if (col < d) store(orow + col, acc[j][2 * h] / l_safe);
          if (col + 1 < d) store(orow + col + 1, acc[j][2 * h + 1] / l_safe);
        }
        // lse in base e; a fully masked row keeps -1e30
        if (t == 0)
          lse[(int64_t)bh * tq + r] =
              l[h] > 0.f ? (m[h] + log2f(l[h])) * kLn2 : kNegInf;
      }
    }
  }
}

template <typename T, int DPAD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int bh, int tq, int tk, int d, int causal,
                   float scale, int q_offset, int k_offset,
                   cudaStream_t stream) {
  constexpr int smem =
      sizeof(T) == 4 ? smem_bytes<DPAD>() : smem16_bytes<DPAD>();
  cudaError_t err = cudaFuncSetAttribute(
      fa_fwd_kernel<T, DPAD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  // cp.async takes 16-byte rows of q, K and V: four float32 values or
  // eight 16-bit ones
  const int use_async =
      d % (16 / sizeof(T)) == 0 &&
      ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v)) & 15) == 0;
  constexpr int rows = sizeof(T) == 4 ? kBlockQ : kBlockQ16;
  const dim3 grid((tq + rows - 1) / rows, bh);
  fa_fwd_kernel<T, DPAD><<<grid, threads<T>(), smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o),
      static_cast<float*>(lse), tq, tk, d, causal, scale, q_offset,
      k_offset, use_async);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     void* lse, int bh, int tq, int tk, int d, int causal,
                     float scale, int q_offset, int k_offset,
                     cudaStream_t stream) {
  if (d <= 32)
    return launch<T, 32>(q, k, v, o, lse, bh, tq, tk, d, causal, scale,
                         q_offset, k_offset, stream);
  if (d <= 64)
    return launch<T, 64>(q, k, v, o, lse, bh, tq, tk, d, causal, scale,
                         q_offset, k_offset, stream);
  return launch<T, 128>(q, k, v, o, lse, bh, tq, tk, d, causal, scale,
                        q_offset, k_offset, stream);
}

}  // namespace

extern "C" {

// q, k, v: contiguous [bh, tq | tk, d] of float32 (dtype = 0), bfloat16
// (dtype = 1) or float16 (dtype = 2), 1 <= d <= 128, bh <= 65535.  Writes o [bh, tq, d]
// in the input type and lse [bh, tq] in float32 on `stream`.  Returns the
// CUDA error of the launch (0 on success); does not synchronise.
int paddle_flash_attention_fwd(const void* q, const void* k, const void* v,
                               void* o, void* lse, int bh, int tq, int tk,
                               int d, int dtype, int causal, float scale,
                               int q_offset, int k_offset, void* stream) {
  if (bh < 1 || bh > 65535 || tq < 1 || tk < 1 || d < 1 || d > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return static_cast<int>(dispatch<__nv_bfloat16>(
        q, k, v, o, lse, bh, tq, tk, d, causal, scale, q_offset, k_offset,
        s));
  if (dtype == 2)
    return static_cast<int>(dispatch<__half>(
        q, k, v, o, lse, bh, tq, tk, d, causal, scale, q_offset, k_offset,
        s));
  return static_cast<int>(dispatch<float>(q, k, v, o, lse, bh, tq, tk, d,
                                          causal, scale, q_offset, k_offset,
                                          s));
}

const char* paddle_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
