// Flash inner-loop ceiling probe for Hopper (sm_90a), behind a plain C
// interface.
//
// Replaces the TPU kernel of benchmarks/exp_flash_ceiling.py: the
// `pl.pallas_call` (:106) over `make_kernel(variant)` (:48-87) for the
// variants mm, mmT, exp and maxexp.  For each (bh, logical q tile of bq
// rows) it computes  sum over the live logical k tiles of f(q k^T) v,
// where a logical k tile ki of bk keys is live for the q tile qi when
// qi * bq + bq - 1 >= ki * bk (the tile-level causal test, :59).  There
// is no element mask, no normalisation, no scale and no lse.  f is the
// identity (mm, mmT), exp(s) (exp), or exp(s - the row max over the
// logical k tile) (maxexp); p is rounded to v's type before p v, the sum
// is float32, and the output [BH, T, D] is in the input type.  mmT reads
// k as [BH, D, T].  The probe exists to split the flash forward's time
// into its stages: two products alone, then adding exp, then the row
// max, against the whole kernel (#1, flash_attention_fwd.cu).
//
// What bounds it on an H100.  4 * D flops per live (q, k) pair, as #1.  At
// the probe's default shape (BH = 128, T = 8192, D = 64, bq = bk = 1024:
// 36 of 64 logical tiles live) that is 1.24 TFLOP: in float32 7.5 ms at
// 3xTF32's rate (495 / 3 TFLOP/s), 18.5 ms on the CUDA cores' float32
// peak; in bfloat16 1.25 ms at the 16-bit tensor-core rate (989
// TFLOP/s).  The bytes (q, k, v read once, o written once: 1.07 GB in
// float32, 537 MB in bfloat16) take 0.32 or 0.16 ms.  The operations
// bound it.
//
// Design: each input type on the engine #1 runs for it, so that a variant
// differs from #1 only in its tail and the gaps between variants are #1's
// stages.  Common to both:
//   - One block per (bh, 64-row q tile); 128 threads, four warps of 16
//     query rows; K and V tiles of 64 keys in a double-buffered ring,
//     loaded by cp.async one tile ahead where rows are 16-byte copies
//     (D a multiple of 16 bytes, aligned pointers), else by the threads.
//   - The 64-row q tiles and 64-key tiles are physical; bq and bk are the
//     probe's logical tiles (multiples of 64).  A block finds its logical
//     q tile, and walks the prefix of 64-key tiles that its live logical
//     k tiles cover.
//   - maxexp's max runs over the whole logical k tile, up to 1024 keys,
//     while the walk sees 64 at a time: inside a logical tile the block
//     keeps its own sum, rescaled when the running max grows
//     (tacc = tacc * exp(m_old - m_new) + p v, #1's online softmax), and
//     adds it to the output's sum at the tile's end.  So p is rounded to
//     bfloat16 at exp(s - running max) and then scaled in float32, where
//     the probe rounds exp(s - final max): the two differ by a bfloat16
//     rounding of each term (the tolerance in ops/kernels/
//     flash_ceiling.py).  At bk = 64 the running max is the final one.
//   - Each 64-key tile's p v is summed from zero and added in float32 (the
//     tensor cores add in round-toward-zero).
// Float32 (#1's 3xTF32 engine, flash_tf32.cuh): q held in registers as
// raw float32 fragments at D <= 64, in shared memory past it; float32
// tiles [64][D + 4]; both products mma.sync m16n8k8 TF32 at float32
// accuracy by the 3xTF32 split; exp and maxexp fold log2(e) into q.
// mmT's K tile is staged transposed, [D][64 + 8] floats: the B fragment
// reads (d = 8 kk + t, key = 8 j + g) hit 32 distinct banks at that
// stride.
// Bfloat16 (#1's 16-bit engine, flash_f16.cuh; ceil16_block restates
// fwd16_block, flash_attention_fwd.cu:210-432, design note :76-115):
//   - q and a two-stage K/V ring of [64][D + 8] bfloat16 values (45 KB at
//     D = 64), staged by cp.async 16 bytes a copy (thread staging of the
//     same layout where D % 8 != 0 or a pointer is unaligned).
//   - q's A fragments come from ldmatrix once and stay in registers; no
//     scale (the probe has none).  K's B fragments come from ldmatrix, V's
//     from ldmatrix.trans; one m16n8k16 bf16 mma.sync (float32 sums) a
//     product, where the float32 engine runs three TF32 ones.
//   - mmT: k arrives [BH, D, T]; its tile is staged [D][64 + 8] (a row of
//     144 bytes, so ldmatrix's eight rows fall on distinct banks) and its
//     B fragments read by ldmatrix.trans.  mm - mmT is the cost of that
//     transposed read, the card's counterpart of the TPU probe's NN
//     against NT question (:66-73).
//   - exp and maxexp take exp2 of s in base 2 inside exp2f (one FFMA a
//     score, as #1), and p's float32 accumulator fragments are rounded to
//     bfloat16 (cvt.rn.bf16x2) straight into the A fragments of p v: the
//     probe's p.astype(v.dtype) (:81).
//   - Launch bounds are #1's 16-bit ones, four blocks an SM at D <= 64
//     (at most 128 registers) and two at D = 128, except maxexp's at
//     D <= 64: its second output-sized sum spilled 208 bytes at 128
//     registers (#1 spills 32, mm, mmT and exp none), and at three blocks
//     (168 registers, no spill) it ran 8-9% faster at the probe's shape
//     and 23% at the AMP training shape (ops/kernels/flash16_probe.py
//     --ceiling; an H100 80GB HBM3 at 700 W).  At D = 128 maxexp spills
//     76 bytes at two blocks, the fewest the shared memory allows beside
//     one.

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
constexpr int kColStride = kBlockK + 8;   // mmT's transposed K rows
constexpr float kLog2e = 1.4426950408889634f;

enum Variant { kMM = 0, kMMT = 1, kExp = 2, kMaxExp = 3 };

template <int DPAD>
__host__ __device__ constexpr int row_tile_floats() {
  return kBlockK * (DPAD + 4);
}

// a K stage holds either layout
template <int DPAD>
__host__ __device__ constexpr int k_stage_floats() {
  return row_tile_floats<DPAD>() > DPAD * kColStride
             ? row_tile_floats<DPAD>() : DPAD * kColStride;
}

template <int DPAD>
__host__ __device__ constexpr bool q_in_registers() {
  return DPAD <= 64;
}

template <int DPAD>
__host__ __device__ constexpr int smem_bytes() {
  // two K and two V stages, and the q tile where q is not held in
  // registers (else q passes through K's second stage first)
  return (2 * k_stage_floats<DPAD>() + 2 * row_tile_floats<DPAD>() +
          (q_in_registers<DPAD>() ? 0 : row_tile_floats<DPAD>())) *
         static_cast<int>(sizeof(float));
}

// rows [row0, row0 + 64) of a [rows, d] matrix into dst[64][DPAD + 4] as
// float32; rows past `rows` and columns past `d` read zero
template <typename T, int DPAD>
__device__ __forceinline__ void load_rows(float* dst, const T* src, int row0,
                                          int rows, int d) {
  for (int idx = threadIdx.x; idx < kBlockK * DPAD; idx += kThreads) {
    const int r = idx / DPAD;
    const int c = idx % DPAD;
    const int gr = row0 + r;
    float x = 0.f;
    if (gr < rows && c < d) x = to_float(src[(int64_t)gr * d + c]);
    dst[r * (DPAD + 4) + c] = x;
  }
}

// columns [k0, k0 + 64) of a [d, t] matrix (mmT's k) into
// dst[DPAD][kColStride] as float32; rows past d read zero
template <typename T, int DPAD>
__device__ __forceinline__ void load_cols(float* dst, const T* src, int k0,
                                          int t, int d) {
  for (int idx = threadIdx.x; idx < DPAD * kBlockK; idx += kThreads) {
    const int r = idx / kBlockK;
    const int c = idx % kBlockK;
    float x = 0.f;
    if (r < d && k0 + c < t) x = to_float(src[(int64_t)r * t + k0 + c]);
    dst[r * kColStride + c] = x;
  }
}

// the same by cp.async, 16 bytes a copy (float32, t % 4 == 0, aligned)
template <int DPAD>
__device__ __forceinline__ void copy_cols(float* dst, const float* src,
                                          int k0, int t, int d) {
  constexpr int kChunks = kBlockK / 4;
  for (int idx = threadIdx.x; idx < DPAD * kChunks; idx += kThreads) {
    const int r = idx / kChunks;
    const int c = (idx % kChunks) * 4;
    const bool ok = r < d && k0 + c < t;
    cp_async16(dst + r * kColStride + c,
               ok ? src + (int64_t)r * t + k0 + c : src, ok);
  }
}

// Blocks an SM the launch bounds ask for.  Float32: three where q is held
// in registers, and two for maxexp, whose second output-sized sum (the
// logical tile's) needs the registers.  Bfloat16: #1's 16-bit engine's,
// four at D <= 64 (at most 128 registers), two at D = 128; maxexp three
// at D <= 64 for the same sum (the header note).
template <typename T, int DPAD, int V>
__host__ __device__ constexpr int min_blocks() {
  if constexpr (sizeof(T) == 4)
    return q_in_registers<DPAD>() ? (V == kMaxExp ? 2 : 3) : 1;
  return DPAD <= 64 ? (V == kMaxExp ? 3 : 4) : 2;
}

// The 16-bit engine's K stage holds either layout: [64][DPAD + 8] rows or
// mmT's [DPAD][kColStride] columns, 16-bit values
template <int DPAD>
__host__ __device__ constexpr int k_stage16() {
  return kBlockK * flash_f16::stride<DPAD>() > DPAD * kColStride
             ? kBlockK * flash_f16::stride<DPAD>() : DPAD * kColStride;
}

// The 16-bit engine's shared memory: the q tile, two K and two V stages
// (45 KB at D = 64, 87 KB at D = 128)
template <int DPAD>
__host__ __device__ constexpr int smem16_bytes() {
  return ((kBlockQ + 2 * kBlockK) * flash_f16::stride<DPAD>() +
          2 * k_stage16<DPAD>()) * 2;
}

// columns [k0, k0 + 64) of a [d, t] matrix of T (mmT's k) into
// dst[DPAD][kColStride], rows past d zero-filled: with `async` by
// cp.async, 16 bytes a copy (t % 64 == 0, so a row's copies stay aligned
// where src is), else by the threads' loads and stores
template <typename T, int DPAD>
__device__ __forceinline__ void stage_cols(T* dst, const T* src, int k0,
                                           int t, int d, bool async) {
  constexpr int kChunks = kBlockK / 8;
#pragma unroll
  for (int it = 0; it < DPAD * kChunks / kThreads; ++it) {
    const int idx = threadIdx.x + it * kThreads;
    const int r = idx / kChunks;
    const int c = (idx % kChunks) * 8;
    const T* row = src + (int64_t)r * t + k0 + c;
    if (async) {
      flash_f16::cp_async16(dst + r * kColStride + c, r < d ? row : src,
                            r < d);
    } else {
      T x[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        x[i] = r < d ? row[i] : flash_f16::from_float<T>(0.f);
#pragma unroll
      for (int i = 0; i < 8; ++i) dst[r * kColStride + c + i] = x[i];
    }
  }
}

// mmT's k tile [DPAD][kColStride], the others' [64][DPAD + 8]
template <typename T, int DPAD, bool kTrans>
__device__ __forceinline__ void stage_k(T* dst, const T* src, int k0, int t,
                                        int d, bool async) {
  if constexpr (kTrans)
    stage_cols<T, DPAD>(dst, src, k0, t, d, async);
  else
    flash_f16::stage_rows<T, DPAD, kBlockK, kThreads>(dst, src, k0, t, d,
                                                      async);
}

// The 16-bit engine: one block's walk for head bh and q tile blockIdx.x
// on bfloat16 q, k, v.  It follows #1's fwd16_block
// (flash_attention_fwd.cu:210-432) line for line up to the tail: the
// staging and ring (:241-254, :290-312), the ldmatrix offsets (:256-264),
// q's fragments without the scale (:266-278), s = q k^T (:314-328), p
// rounded into p v's A fragments (:368-385) and p v by ldmatrix.trans
// (:387-407).  The tail is the variant's: no mask, no l, and a sum from
// zero a tile in place of the rescaled accumulator.
template <typename T, int DPAD, int V>
__device__ __forceinline__ void ceil16_block(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ o, int t, int d, int bq,
    int bk, bool use_async, T* smem) {
  using namespace flash_f16;
  constexpr int S = stride<DPAD>();
  constexpr int TILE = kBlockK * S;
  constexpr int KT = k_stage16<DPAD>();
  constexpr int kSteps = DPAD / 16;   // k steps of s = q k^T over D
  constexpr int kNd = DPAD / 8;       // n tiles of o over D
  constexpr bool kTrans = V == kMMT;
  T* qs = smem;
  T* k_ring = qs + kBlockQ * S;
  T* v_ring = k_ring + 2 * KT;

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBlockQ;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;   // fragment row within 8
  const int tq = lane & 3;   // lane within the row's quad
  const T* qb = q + (int64_t)bh * t * d;
  const T* kb = k + (int64_t)bh * t * d;   // [t, d], or [d, t] for mmT
  const T* vb = v + (int64_t)bh * t * d;

  // the live logical k tiles of this block's logical q tile are a prefix
  // (at least tile 0): ki * bk <= qi * bq + bq - 1 (exp_flash_ceiling.py:59)
  const int qi = q0 / bq;
  const int live = min(t / bk, (qi * bq + bq - 1) / bk + 1);
  const int per_tile = bk / kBlockK;   // 64-key tiles in a logical k tile
  const int nk = live * per_tile;

  // q, then (by cp.async) the first K and V tiles, each its own group
  stage_rows<T, DPAD, kBlockQ, kThreads>(qs, qb, q0, t, d, use_async);
  if (use_async) {
    cp_async_commit();
    stage_k<T, DPAD, kTrans>(k_ring, kb, 0, t, d, true);
    stage_rows<T, DPAD, kBlockK, kThreads>(v_ring, vb, 0, t, d, true);
    cp_async_commit();
    cp_async_wait<1>();
  }
  __syncthreads();   // q is in place

  // ldmatrix row addresses of this lane: matrix mi = lane / 8, its row
  // lane % 8.  A (q; p as registers) takes the four matrices as rows
  // +0/+8 by columns +0/+8; B of q k^T as keys +0/+8 by columns +0/+8
  // (two n tiles, both k halves), or for mmT's [D][keys] tile, transposed,
  // as columns +0/+8 by keys +0/+8 (both k halves, two n tiles); B of p v,
  // transposed, as keys +0/+8 by columns +0/+8 (both k halves, two n
  // tiles)
  const int mi = lane >> 3, mr = lane & 7;
  const int a_off = (8 * (mi & 1) + mr) * S + 8 * (mi >> 1);
  const int k_off = kTrans ? (8 * (mi & 1) + mr) * kColStride + 8 * (mi >> 1)
                           : (8 * (mi >> 1) + mr) * S + 8 * (mi & 1);
  const int v_off = (8 * (mi & 1) + mr) * S + 8 * (mi >> 1);

  // this warp's 16 rows of q as A fragments
  uint32_t qa[kSteps][4];
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk)
    ldsm4(qa[kk], qs + 16 * warp * S + 16 * kk + a_off);

  // this thread's rows: r0 = 16 * warp + g and r0 + 8 of the tile; maxexp's
  // running max of the logical tile in the units of s
  const int r0 = 16 * warp + g;
  float m[2] = {0.f, 0.f};
  float acc[kNd][4];
  float tacc[V == kMaxExp ? kNd : 1][4];   // maxexp: the tile's sum
#pragma unroll
  for (int j = 0; j < kNd; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
  for (int j = 0; j < (V == kMaxExp ? kNd : 1); ++j)
    tacc[j][0] = tacc[j][1] = tacc[j][2] = tacc[j][3] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kBlockK;
    T* ks = k_ring + (kt & 1) * KT;
    T* vs = v_ring + (kt & 1) * TILE;
    if (use_async) {
      if (kt + 1 < nk) {
        // the stage it fills was last read before the previous barrier
        stage_k<T, DPAD, kTrans>(k_ring + ((kt + 1) & 1) * KT, kb,
                                 k0 + kBlockK, t, d, true);
        stage_rows<T, DPAD, kBlockK, kThreads>(
            v_ring + ((kt + 1) & 1) * TILE, vb, k0 + kBlockK, t, d, true);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
    } else {
      stage_k<T, DPAD, kTrans>(ks, kb, k0, t, d, false);
      stage_rows<T, DPAD, kBlockK, kThreads>(vs, vb, k0, t, d, false);
    }
    __syncthreads();   // the tile is in place

    // s = q k^T for rows r0, r0 + 8 and the 64 keys, 8 n tiles
    float s[kNTiles][4];
#pragma unroll
    for (int j = 0; j < kNTiles; ++j)
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
#pragma unroll
      for (int jp = 0; jp < kNTiles / 2; ++jp) {
        uint32_t b[4];
        if constexpr (kTrans)
          ldsm4_t(b, ks + 16 * kk * kColStride + 16 * jp + k_off);
        else
          ldsm4(b, ks + 16 * jp * S + 16 * kk + k_off);
        mma<T>(s[2 * jp], qa[kk], b[0], b[1]);
        mma<T>(s[2 * jp + 1], qa[kk], b[2], b[3]);
      }
    }

    // the tail: element (j, i) is row r0 + 8 (i >> 1), key 8 j + 2 tq +
    // (i & 1) of the tile
    const bool first = kt % per_tile == 0;
    const bool last = kt % per_tile == per_tile - 1;
    float alpha[2] = {0.f, 0.f}, mb[2] = {0.f, 0.f};
    if constexpr (V == kMaxExp) {
      float m_cur[2] = {s[0][0], s[0][2]};
#pragma unroll
      for (int j = 0; j < kNTiles; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          m_cur[i >> 1] = fmaxf(m_cur[i >> 1], s[j][i]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        m_cur[h] = fmaxf(m_cur[h], __shfl_xor_sync(0xffffffffu, m_cur[h], 1));
        m_cur[h] = fmaxf(m_cur[h], __shfl_xor_sync(0xffffffffu, m_cur[h], 2));
        const float m_new = first ? m_cur[h] : fmaxf(m[h], m_cur[h]);
        alpha[h] = first ? 0.f : exp2f((m[h] - m_new) * kLog2e);
        m[h] = m_new;
        mb[h] = m_new * kLog2e;
      }
    }
    // p rounded to T two to a register: the accumulator fragments of keys
    // 16 kk .. + 15 are the A fragment of p v's k step kk (keys 2 tq,
    // 2 tq + 1 of each 8-key half)
    uint32_t pa[kNTiles / 2][4];
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if constexpr (V == kExp) s[j][i] = exp2f(s[j][i] * kLog2e);
        if constexpr (V == kMaxExp)
          s[j][i] = exp2f(fmaf(s[j][i], kLog2e, -mb[i >> 1]));
      }
      pa[j >> 1][2 * (j & 1)] = pack<T>(s[j][0], s[j][1]);
      pa[j >> 1][2 * (j & 1) + 1] = pack<T>(s[j][2], s[j][3]);
    }

    // pv = p v from zero, two n tiles of o at a time, added in float32
    // (maxexp: to the logical tile's sum, rescaled to its running max, and
    // that to the output's at the tile's end)
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
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if constexpr (V == kMaxExp) {
            float* ta = tacc[2 * jp + x];
            ta[i] = first ? pv[x][i] : fmaf(ta[i], alpha[i >> 1], pv[x][i]);
            if (last) a[i] += ta[i];
          } else {
            a[i] += pv[x][i];
          }
        }
      }
    }
    __syncthreads();   // every reader of this stage is done
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = q0 + r0 + 8 * h;
    if (r < t) {
      T* orow = o + ((int64_t)bh * t + r) * d;
#pragma unroll
      for (int j = 0; j < kNd; ++j) {
        const int col = 8 * j + 2 * tq;
        if (col < d) orow[col] = from_float<T>(acc[j][2 * h]);
        if (col + 1 < d) orow[col + 1] = from_float<T>(acc[j][2 * h + 1]);
      }
    }
  }
}

// float32 by the 3xTF32 engine below, bfloat16 by ceil16_block
template <typename T, int DPAD, int V>
__global__ void __launch_bounds__(kThreads, min_blocks<T, DPAD, V>())
flash_ceiling_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int t,
                     int d, int bq, int bk, int use_async) {
  extern __shared__ float4 smem4[];
  if constexpr (sizeof(T) == 2) {
    ceil16_block<T, DPAD, V>(q, k, v, o, t, d, bq, bk, use_async != 0,
                             reinterpret_cast<T*>(smem4));
  } else {
    constexpr int S = DPAD + 4;
    constexpr int RT = row_tile_floats<DPAD>();
    constexpr int KT = k_stage_floats<DPAD>();
    constexpr int kSteps = DPAD / 8;   // mma k steps over D; n tiles of o
    constexpr bool kQRegs = q_in_registers<DPAD>();
    constexpr bool kTrans = V == kMMT;
    float* smem = reinterpret_cast<float*>(smem4);
    float* k_ring = smem + (kQRegs ? 0 : RT);
    float* v_ring = k_ring + 2 * KT;
    float* qs = kQRegs ? k_ring + KT : smem;

    const int bh = blockIdx.y;
    const int q0 = blockIdx.x * kBlockQ;
    const int warp = threadIdx.x >> 5;
    const int g = (threadIdx.x & 31) >> 2;   // fragment row within 8
    const int tq = threadIdx.x & 3;          // lane within the row's quad
    const T* qb = q + (int64_t)bh * t * d;
    const T* kb = k + (int64_t)bh * t * d;   // [t, d], or [d, t] for mmT
    const T* vb = v + (int64_t)bh * t * d;

    // the live logical k tiles of this block's logical q tile are a prefix:
    // ki * bk <= qi * bq + bq - 1 (exp_flash_ceiling.py:59)
    const int qi = q0 / bq;
    const int live = min(t / bk, (qi * bq + bq - 1) / bk + 1);
    const int per_tile = bk / kBlockK;   // 64-key tiles in a logical k tile
    const int nk = live * per_tile;

    if (use_async) {
      copy_rows<DPAD, kBlockQ, kThreads>(qs, reinterpret_cast<const float*>(qb),
                                         q0, t, d);
      cp_async_commit();
      if constexpr (kTrans)
        copy_cols<DPAD>(k_ring, reinterpret_cast<const float*>(kb), 0, t, d);
      else
        copy_rows<DPAD, kBlockK, kThreads>(
            k_ring, reinterpret_cast<const float*>(kb), 0, t, d);
      copy_rows<DPAD, kBlockK, kThreads>(
          v_ring, reinterpret_cast<const float*>(vb), 0, t, d);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      load_rows<T, DPAD>(qs, qb, q0, t, d);
    }
    // exp and maxexp take exp2 of scores in base 2: log2(e) folded into q
    const float q_mul = V >= kExp ? kLog2e : 1.f;

    // this thread's rows: r0 = 16 * warp + g and r0 + 8 of the tile
    const int r0 = 16 * warp + g;
    float qf[kQRegs ? kSteps : 1][4];
    if constexpr (kQRegs) {
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        const float* qa = qs + r0 * S + 8 * kk + tq;
        qf[kk][0] = qa[0] * q_mul;
        qf[kk][1] = qa[8 * S] * q_mul;
        qf[kk][2] = qa[4] * q_mul;
        qf[kk][3] = qa[8 * S + 4] * q_mul;
      }
      __syncthreads();   // K's second stage is free for the ring
    }
    float m[2] = {0.f, 0.f};   // maxexp: running max of the logical tile
    float acc[kSteps][4];
    float tacc[V == kMaxExp ? kSteps : 1][4];   // maxexp: the tile's sum
#pragma unroll
    for (int j = 0; j < kSteps; ++j)
      acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
    for (int j = 0; j < (V == kMaxExp ? kSteps : 1); ++j)
      tacc[j][0] = tacc[j][1] = tacc[j][2] = tacc[j][3] = 0.f;

    for (int kt = 0; kt < nk; ++kt) {
      const int k0 = kt * kBlockK;
      float* ks = k_ring + (kt & 1) * KT;
      float* vs = v_ring + (kt & 1) * RT;
      if (use_async) {
        if (kt + 1 < nk) {
          // the stage it fills was last read before the previous barrier
          float* kn = k_ring + ((kt + 1) & 1) * KT;
          float* vn = v_ring + ((kt + 1) & 1) * RT;
          if constexpr (kTrans)
            copy_cols<DPAD>(kn, reinterpret_cast<const float*>(kb),
                            k0 + kBlockK, t, d);
          else
            copy_rows<DPAD, kBlockK, kThreads>(
                kn, reinterpret_cast<const float*>(kb), k0 + kBlockK, t, d);
          copy_rows<DPAD, kBlockK, kThreads>(
              vn, reinterpret_cast<const float*>(vb), k0 + kBlockK, t, d);
          cp_async_commit();
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
      } else {
        if constexpr (kTrans)
          load_cols<T, DPAD>(ks, kb, k0, t, d);
        else
          load_rows<T, DPAD>(ks, kb, k0, t, d);
        load_rows<T, DPAD>(vs, vb, k0, t, d);
      }
      __syncthreads();   // the tile (and on the first pass q) is in place

      // s = q k^T for rows r0, r0 + 8 and the 64 keys, 8 n tiles
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
          const float* qa = qs + r0 * S + 8 * kk + tq;
          split4(qa[0] * q_mul, qa[8 * S] * q_mul, qa[4] * q_mul,
                 qa[8 * S + 4] * q_mul, ab, as);
        }
#pragma unroll
        for (int j = 0; j < kNTiles; ++j) {
          if constexpr (kTrans) {
            const float* kc = ks + (8 * kk + tq) * kColStride + 8 * j + g;
            mma3(s[j], ab, as, kc[0], kc[4 * kColStride]);
          } else {
            const float* kr = ks + (8 * j + g) * S + 8 * kk + tq;
            mma3(s[j], ab, as, kr[0], kr[4]);
          }
        }
      }

      // the tail: element (j, i) is row r0 + 8 (i >> 1), key 8 j + 2 tq +
      // (i & 1) of the tile
      const bool first = kt % per_tile == 0;
      float alpha[2] = {0.f, 0.f};
      if constexpr (V == kMaxExp) {
        float m_cur[2] = {s[0][0], s[0][2]};
#pragma unroll
        for (int j = 0; j < kNTiles; ++j) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            m_cur[i >> 1] = fmaxf(m_cur[i >> 1], s[j][i]);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          m_cur[h] = fmaxf(m_cur[h], __shfl_xor_sync(0xffffffffu, m_cur[h], 1));
          m_cur[h] = fmaxf(m_cur[h], __shfl_xor_sync(0xffffffffu, m_cur[h], 2));
          const float m_new = first ? m_cur[h] : fmaxf(m[h], m_cur[h]);
          alpha[h] = first ? 0.f : exp2f(m[h] - m_new);
          m[h] = m_new;
        }
      }
#pragma unroll
      for (int j = 0; j < kNTiles; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float p = s[j][i];
          if constexpr (V == kExp) p = exp2f(p);
          if constexpr (V == kMaxExp) p = exp2f(p - m[i >> 1]);
          s[j][i] = p;
        }
      }

      // pv = p v from zero (keys 2 tq, 2 tq + 1 in the A fragment's two k
      // slots, v read in that order)
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
        const float* vr = vs + (8 * kk + 2 * tq) * S + g;
#pragma unroll
        for (int j = 0; j < kSteps; ++j)
          mma3(pv[j], ab, as, vr[8 * j], vr[S + 8 * j]);
      }
      if constexpr (V == kMaxExp) {
        // the logical tile's sum, rescaled to its running max; added to
        // the output's at the tile's end
        const bool last = kt % per_tile == per_tile - 1;
#pragma unroll
        for (int j = 0; j < kSteps; ++j) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            tacc[j][i] = first ? pv[j][i]
                               : fmaf(tacc[j][i], alpha[i >> 1], pv[j][i]);
            if (last) acc[j][i] += tacc[j][i];
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < kSteps; ++j) {
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[j][i] += pv[j][i];
        }
      }
      __syncthreads();   // every reader of this stage is done
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = q0 + r0 + 8 * h;
      if (r < t) {
        T* orow = o + ((int64_t)bh * t + r) * d;
#pragma unroll
        for (int j = 0; j < kSteps; ++j) {
          const int col = 8 * j + 2 * tq;
          if (col < d) store(orow + col, acc[j][2 * h]);
          if (col + 1 < d) store(orow + col + 1, acc[j][2 * h + 1]);
        }
      }
    }
  }
}

template <typename T, int DPAD, int V>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int bh, int t, int d, int bq, int bk,
                   cudaStream_t stream) {
  constexpr int smem =
      sizeof(T) == 4 ? smem_bytes<DPAD>() : smem16_bytes<DPAD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_ceiling_kernel<T, DPAD, V>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  // cp.async takes 16-byte rows of q, K and V: four float32 values or
  // eight bfloat16 ones
  const int use_async =
      d % (16 / sizeof(T)) == 0 &&
      ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v)) & 15) == 0;
  const dim3 grid(t / kBlockQ, bh);
  flash_ceiling_kernel<T, DPAD, V><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), t, d, bq, bk,
      use_async);
  return cudaGetLastError();
}

template <typename T, int DPAD>
cudaError_t by_variant(int variant, const void* q, const void* k,
                       const void* v, void* o, int bh, int t, int d, int bq,
                       int bk, cudaStream_t s) {
  switch (variant) {
    case kMM: return launch<T, DPAD, kMM>(q, k, v, o, bh, t, d, bq, bk, s);
    case kMMT: return launch<T, DPAD, kMMT>(q, k, v, o, bh, t, d, bq, bk, s);
    case kExp: return launch<T, DPAD, kExp>(q, k, v, o, bh, t, d, bq, bk, s);
    default:
      return launch<T, DPAD, kMaxExp>(q, k, v, o, bh, t, d, bq, bk, s);
  }
}

template <typename T>
cudaError_t dispatch(int variant, const void* q, const void* k,
                     const void* v, void* o, int bh, int t, int d, int bq,
                     int bk, cudaStream_t s) {
  if (d <= 64)
    return by_variant<T, 64>(variant, q, k, v, o, bh, t, d, bq, bk, s);
  return by_variant<T, 128>(variant, q, k, v, o, bh, t, d, bq, bk, s);
}

}  // namespace

extern "C" {

// q, v: contiguous [bh, t, d]; k: [bh, t, d], or [bh, d, t] for mmT
// (variant 1); float32 (dtype = 0) or bfloat16 (dtype = 1); variant 0 mm,
// 1 mmT, 2 exp, 3 maxexp; 1 <= d <= 128, bh <= 65535, bq and bk positive
// multiples of 64 that divide t.  Writes o [bh, t, d] in the input type
// on `stream`.  Returns the CUDA error of the launch (0 on success); does
// not synchronise.
int paddle_flash_ceiling(const void* q, const void* k, const void* v,
                         void* o, int bh, int t, int d, int dtype,
                         int variant, int bq, int bk, void* stream) {
  if (bh < 1 || bh > 65535 || d < 1 || d > 128 || variant < 0 ||
      variant > 3 || bq < kBlockQ || bk < kBlockK || bq % kBlockQ != 0 ||
      bk % kBlockK != 0 || t < 1 || t % bq != 0 || t % bk != 0 ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return static_cast<int>(dispatch<__nv_bfloat16>(variant, q, k, v, o, bh,
                                                    t, d, bq, bk, s));
  return static_cast<int>(dispatch<float>(variant, q, k, v, o, bh, t, d, bq,
                                          bk, s));
}

const char* paddle_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
