// The dk/dv engine of the flash-attention backward on the tensor cores, at
// float32 accuracy: one block's walk for one (bh, 64-row k tile), shared by
// the fused backward (flash_attention_bwd.cu, which adds dq to the walk)
// and the split pair's dk/dv kernel (flash_attention_bwd_split.cu, which
// does not).  Both instantiate the same code for dk and dv, so the split
// kernel's dk and dv are bitwise equal to the fused kernel's.
// ops/kernels/build.py rebuilds both libraries when it changes.
//
// The block (256 threads, eight warps) loads its K and V tiles once and
// walks the q tiles that the causal mask leaves alive (the TPU kernels'
// `_tile_alive`), a suffix of the q axis:
//   - Every product runs on the tensor cores, mma.sync m16n8k8 in TF32
//     with float32 accumulation, at float32 accuracy by the 3xTF32 split
//     (flash_tf32.cuh): x = big + small, a.b = a_small.b_big +
//     a_big.b_small + a_big.b_big.  Plain TF32 is not used.  bfloat16
//     and float16 inputs take dkv_block16 ("16-bit inputs" below).
//     mma.sync, not
//     wgmma: .tf32 wgmma needs K-major operands in shared memory, and q
//     and do are N-major there; mma.sync fragments are read thread by
//     thread in any layout.
//   - Warp w takes keys 16 (w & 3) .. + 15 against q rows 32 (w >> 2) ..
//     + 31 of each q tile: s^T = k q^T and dp^T = v do^T come out with the
//     keys as rows, so p^T and ds^T = p^T * (dp^T - di) are already the A
//     operands of dv += p^T do and dk += ds^T q (a thread's accumulator
//     holds q columns 2t and 2t + 1, which fill the A fragment's two k
//     slots; do and q are read in the same order).  dk and dv accumulate
//     in float32 registers across the walk; the two q halves' sums meet
//     through shared memory at the end.
//   - The tensor cores add in round-toward-zero, so a running accumulator
//     would drift by an ulp per mma over a long walk: each q tile's parts
//     are summed from zero, then added by float32 adds.
//   - q and do tiles, with lse and di, go through a double-buffered ring in
//     shared memory, loaded by cp.async one tile ahead, so the next copy
//     overlaps the current tile's products; k and v come by cp.async with
//     the first q tile (float32 inputs with D % 4 == 0 and 16-byte aligned
//     pointers, and D <= 64, where two stages fit; other inputs are loaded
//     by the threads, every load of a tile in flight at once, converted to
//     float32).  q arrives unscaled: s^T is scaled after its product, dk
//     once at the end (dk = ds^T (scale q)).  Rows are padded to D + 4
//     floats, so the fragment reads hit 32 distinct banks.
//   - ds = p * (dp - di).  Masked probabilities are zero by select, never
//     by multiply: a row that every key masks has lse = -1e30, where
//     exp(s - lse) is inf and inf * 0 would be NaN.  The q offset and k
//     offset place both tiles on the global axis for the causal mask; the
//     ragged edge (rows past T, columns past D) is masked here, not padded
//     by copies.  A k tile that no query sees writes zero dk and dv.
//   - With DQ, each q tile's ds^T also goes through shared memory, and
//     warp w computes dq rows 16 (w & 3) .. + 15 of the tile, half of the
//     columns, adding its part with float32 atomics into a zeroed
//     [BH, Tq, D] buffer (the fused kernel's dq; its order over k tiles
//     varies from run to run).  ds^T's rows hold 64 q columns whatever D
//     is (ds_stride; at D = 32 the tiles' 36-float rows were too short for
//     them, and the fused kernel's dq was wrong there).
//
// 16-bit inputs (dkv_block16).  The function is the reference's on 16-bit
// inputs: q times the scale in the input type T, the scale rounded to T
// first, so dk needs no final scale; p and ds rounded to T before dv, dk
// and dq.  The same walk, warp layout, masking by select, float32 adds of
// each q tile's parts and meeting of the two q halves; per (q, k) pair 10
// D flops on 16-bit tensor cores, one m16n8k16 bf16/f16 mma.sync
// (flash_f16.cuh) where the float32 engine runs three TF32 ones.
//   - K and V are staged once, q and do through a two-stage cp.async ring
//     one tile ahead, all as [64][D + 8] 16-bit values (conflict-free
//     ldmatrix rows), lse and di as float32.  Each thread scales the q
//     chunks it copied, in place, once its copies have landed (q^ = T(q *
//     T(scale))), before the barrier that publishes the tile.  Where rows
//     are not 16-byte copies (D % 8 != 0 or an unaligned pointer) the
//     threads stage the same layout.
//   - s^T = k q^T and dp^T = v do^T take k's and v's A fragments and q's
//     and do's B fragments by ldmatrix; p^T = exp2((s^T - lse) log2 e) and
//     ds^T = p^T (dp^T - di) in float32, then rounded to T two to a
//     register straight from the accumulator fragments into the A
//     fragments of dv += p^T do and dk += ds^T q^, whose B fragments come
//     by ldmatrix.trans.
//   - With DQ, ds^T goes through shared memory as 16-bit values ([64 keys]
//     [64 + 8]), half the float32 engine's bytes, and dq = ds k takes its
//     A fragments by ldmatrix.trans from there and k's B fragments by
//     ldmatrix.trans; its float32 atomics as in the float32 engine.
//   - Eight warps.  The fused kernel runs two blocks an SM at D <= 64 (at
//     most 128 registers, 36 bytes of spill at D = 64; 65 KB of shared
//     memory each), about 10% faster than one (flash_attention_bwd.cu);
//     the split pair's dk/dv kernel, off the main paths, one (212
//     registers at D = 64).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_f16.cuh"
#include "flash_tf32.cuh"

namespace flash_bwd_dkv {

using namespace flash_tf32;

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;   // eight warps
constexpr float kLog2e = 1.4426950408889634f;

// q and do ring stages: two where they fit beside the other tiles
template <int DPAD>
__host__ __device__ constexpr int stages() {
  return DPAD <= 64 ? 2 : 1;
}

template <int DPAD>
__host__ __device__ constexpr int tile_floats() {
  return kBlockK * (DPAD + 4);
}

// ds^T's row stride: 64 q columns, padded as the tiles' rows (D + 4 where
// that is wider, so D = 64 and 128 keep the tiles' stride)
template <int DPAD>
__host__ __device__ constexpr int ds_stride() {
  return DPAD + 4 > kBlockQ + 4 ? DPAD + 4 : kBlockQ + 4;
}

template <int DPAD, bool DQ>
__host__ __device__ constexpr int smem_bytes() {
  // k, v, the q and do stages, [64][DPAD + 4]; with DQ ds^T,
  // [64][ds_stride]; lse and di stages
  return ((2 + 2 * stages<DPAD>()) * tile_floats<DPAD>() +
          (DQ ? kBlockK * ds_stride<DPAD>() : 0) +
          2 * stages<DPAD>() * kBlockQ) *
         static_cast<int>(sizeof(float));
}

// Whether the block's tiles come by cp.async: float32 q, do, k, v with
// 16-byte rows and pointers, where two ring stages fit.
template <typename T, int DPAD>
bool async_tiles(const void* q, const void* k, const void* v,
                 const void* dout, int d) {
  const uintptr_t addr_bits =
      reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(dout) |
      reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v);
  return sizeof(T) == 4 && stages<DPAD>() == 2 && d % 4 == 0 &&
         (addr_bits & 15) == 0;
}

// a tile of kBlockK rows by cp.async over the block's threads
template <int DPAD>
__device__ __forceinline__ void copy_tile(float* dst, const float* src,
                                          int row0, int rows, int d) {
  copy_rows<DPAD, kBlockK, kThreads>(dst, src, row0, rows, d);
}

__device__ __forceinline__ void atomic_add2(float* dst, float a, float b) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900
  atomicAdd(reinterpret_cast<float2*>(dst), make_float2(a, b));
#else
  atomicAdd(dst, a);
  atomicAdd(dst + 1, b);
#endif
}

// Stage rows [row0, row0 + 64) of a [rows, d] matrix into dst[64][DPAD + 4]
// as float32; rows past `rows` and columns past `d` read zero.
template <typename T, int DPAD>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0,
                                          int rows, int d) {
  // unrolled, so that every load of the tile is in flight at once
#pragma unroll
  for (int it = 0; it < kBlockK * DPAD / kThreads; ++it) {
    const int idx = threadIdx.x + it * kThreads;
    const int r = idx / DPAD;
    const int c = idx % DPAD;
    const int gr = row0 + r;
    float x = 0.f;
    if (gr < rows && c < d) x = to_float(src[(int64_t)gr * d + c]);
    dst[r * (DPAD + 4) + c] = x;
  }
}

// acc += a b over 32 rows of b: a [16 x 32] as four n tiles of an
// accumulator fragment (rows g, g + 8; columns 8 kk + 2t, + 1), b's rows
// [32][kSteps * 8] in shared memory.  The A fragment's k slots t, t + 4
// take columns 2t, 2t + 1, and b is read in that order.  The product is
// summed from zero and then added (the tensor cores' adds round toward
// zero; a float32 add does not drift over a long walk).
template <int kSteps, int S>
__device__ __forceinline__ void add_tile_product(float (&acc)[kSteps][4],
                                                 const float (&a)[4][4],
                                                 const float* b, int g,
                                                 int t) {
  float part[kSteps][4];
#pragma unroll
  for (int j = 0; j < kSteps; ++j)
    part[j][0] = part[j][1] = part[j][2] = part[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t ab[4], as[4];
    split4(a[kk][0], a[kk][2], a[kk][1], a[kk][3], ab, as);
    const float* br = b + (8 * kk + 2 * t) * S + g;
#pragma unroll
    for (int j = 0; j < kSteps; ++j)
      mma3(part[j], ab, as, br[8 * j], br[S + 8 * j]);
  }
#pragma unroll
  for (int j = 0; j < kSteps; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] += part[j][i];
}

// The block's walk for head bh and k tile kt: dk and dv of keys
// [64 kt, 64 kt + 64) in the input type, and with DQ each q tile's dq part
// added into dq_acc.  `smem` holds smem_bytes<DPAD, DQ>() bytes.  The
// caller's grid places (bh, kt); every thread of the block calls this.
template <typename T, int DPAD, bool DQ>
__device__ __forceinline__ void dkv_block(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ di,
    T* __restrict__ dk, T* __restrict__ dv, float* __restrict__ dq_acc,
    int tq, int tk, int d, int causal, float scale, int q_offset,
    int k_offset, int use_async, int bh, int kt, float* smem) {
  constexpr int S = DPAD + 4;
  constexpr int TILE = tile_floats<DPAD>();
  constexpr int NS = stages<DPAD>();
  constexpr int kSteps = DPAD / 8;    // mma k steps over D; n tiles of dk
  constexpr int kHalf = DPAD / 16;    // n tiles of a warp's dq columns
  float* ks = smem;
  float* vs = ks + TILE;
  float* q_ring = vs + TILE;
  float* do_ring = q_ring + NS * TILE;
  constexpr int SD = ds_stride<DPAD>();
  float* dst_s = do_ring + NS * TILE;   // ds^T [64 keys][64 q], with DQ
  float* lse_ring = dst_s + (DQ ? kBlockK * SD : 0);
  float* di_ring = lse_ring + NS * kBlockQ;

  const int k0 = kt * kBlockK;
  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2;   // fragment row within 8
  const int t = threadIdx.x & 3;           // lane within the row's quad
  const int kr0 = 16 * (warp & 3) + g;     // this thread's keys kr0, kr0 + 8
  const int qc0 = 32 * (warp >> 2);        // this warp's q columns
  const T* qb = q + (int64_t)bh * tq * d;
  const T* dob = dout + (int64_t)bh * tq * d;
  const T* kb = k + (int64_t)bh * tk * d;
  const T* vb = v + (int64_t)bh * tk * d;
  const float* lseb = lse + (int64_t)bh * tq;
  const float* dib = di + (int64_t)bh * tq;

  // the live q tiles are a suffix: a dead tile's newest query on the
  // global axis precedes this k tile's oldest key (uniform in the block)
  const int nq = (tq + kBlockQ - 1) / kBlockQ;
  int qt0 = 0;
  while (causal && qt0 < nq &&
         q_offset + min((qt0 + 1) * kBlockQ, tq) - 1 < k_offset + k0)
    ++qt0;

  auto prefetch = [&](int qt, int stage) {
    const int q0 = qt * kBlockQ;
    copy_tile<DPAD>(q_ring + stage * TILE,
                    reinterpret_cast<const float*>(qb), q0, tq, d);
    copy_tile<DPAD>(do_ring + stage * TILE,
                    reinterpret_cast<const float*>(dob), q0, tq, d);
    if (threadIdx.x < kBlockQ) {
      const int r = q0 + threadIdx.x;
      const bool ok = r < tq;
      cp_async4(lse_ring + stage * kBlockQ + threadIdx.x,
                ok ? lseb + r : lseb, ok);
      cp_async4(di_ring + stage * kBlockQ + threadIdx.x, ok ? dib + r : dib,
                ok);
    }
    cp_async_commit();
  };
  // k and v join the first q tile's copy group
  if (use_async) {
    copy_tile<DPAD>(ks, reinterpret_cast<const float*>(kb), k0, tk, d);
    copy_tile<DPAD>(vs, reinterpret_cast<const float*>(vb), k0, tk, d);
    if (qt0 < nq)
      prefetch(qt0, 0);
    else
      cp_async_commit();
  } else {
    load_tile<T, DPAD>(ks, kb, k0, tk, d);
    load_tile<T, DPAD>(vs, vb, k0, tk, d);
  }

  float dk_acc[kSteps][4], dv_acc[kSteps][4];
#pragma unroll
  for (int j = 0; j < kSteps; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk_acc[j][i] = dv_acc[j][i] = 0.f;

  for (int qt = qt0; qt < nq; ++qt) {
    const int q0 = qt * kBlockQ;
    const int stage = NS == 2 ? (qt - qt0) & 1 : 0;
    float* qs = q_ring + stage * TILE;
    float* dos = do_ring + stage * TILE;
    float* lse_s = lse_ring + stage * kBlockQ;
    float* di_s = di_ring + stage * kBlockQ;
    if (use_async) {
      if (qt + 1 < nq) {
        // the stage it fills was last read before the previous barrier
        prefetch(qt + 1, stage ^ 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
    } else {
      load_tile<T, DPAD>(qs, qb, q0, tq, d);
      load_tile<T, DPAD>(dos, dob, q0, tq, d);
      if (threadIdx.x < kBlockQ) {
        const int r = q0 + threadIdx.x;
        lse_s[threadIdx.x] = r < tq ? lseb[r] : 0.f;
        di_s[threadIdx.x] = r < tq ? dib[r] : 0.f;
      }
    }
    __syncthreads();   // the tiles (and on the first pass k, v) are in place

    // s^T = k q^T and dp^T = v do^T: keys kr0, kr0 + 8 (rows) against
    // q columns qc0 + 8 j + 2 t (+ 1), four n tiles
    float st[4][4], dpt[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) st[j][i] = dpt[j][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      const float* ka = ks + kr0 * S + 8 * kk + t;
      const float* va = vs + kr0 * S + 8 * kk + t;
      uint32_t kab[4], kas[4], vab[4], vas[4];
      split4(ka[0], ka[8 * S], ka[4], ka[8 * S + 4], kab, kas);
      split4(va[0], va[8 * S], va[4], va[8 * S + 4], vab, vas);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int off = (qc0 + 8 * j + g) * S + 8 * kk + t;
        mma3(st[j], kab, kas, qs[off], qs[off + 4]);
        mma3(dpt[j], vab, vas, dos[off], dos[off + 4]);
      }
    }

    // p^T and ds^T; element (j, i) is key kr0 + 8 (i >> 1), q column
    // qc0 + 8 j + 2 t + (i & 1)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qc = qc0 + 8 * j + 2 * t + (i & 1);
        const int kpos = k0 + kr0 + 8 * (i >> 1);
        const bool ok = q0 + qc < tq && kpos < tk &&
                        (!causal || q_offset + q0 + qc >= k_offset + kpos);
        // select, not multiply: exp(s - lse) is inf on a fully masked row
        const float p = ok ? expf(st[j][i] * scale - lse_s[qc]) : 0.f;
        st[j][i] = p;
        dpt[j][i] = p * (dpt[j][i] - di_s[qc]);
      }
    }

    // dv += p^T do and dk += ds^T q over this warp's 32 q columns
    add_tile_product<kSteps, S>(dv_acc, st, dos + qc0 * S, g, t);
    add_tile_product<kSteps, S>(dk_acc, dpt, qs + qc0 * S, g, t);

    if constexpr (DQ) {
      // ds^T into shared memory for dq
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          dst_s[(kr0 + 8 * (i >> 1)) * SD + qc0 + 8 * j + 2 * t + (i & 1)] =
              dpt[j][i];
      __syncthreads();

      // dq rows 16 (w & 3) + g (+ 8) of this tile, columns (w >> 2) * D/2 +
      // 8 j + 2 t (+ 1): ds (from ds^T, keys 2t, 2t + 1 in the k slots) k
      const int qr = 16 * (warp & 3) + g;
      const int c0 = (warp >> 2) * (DPAD / 2);
      float dq[kHalf][4];
#pragma unroll
      for (int j = 0; j < kHalf; ++j)
        dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kBlockK / 8; ++kk) {
        const float* da = dst_s + (8 * kk + 2 * t) * SD + qr;
        uint32_t ab[4], as[4];
        split4(da[0], da[8], da[SD], da[SD + 8], ab, as);
        const float* br = ks + (8 * kk + 2 * t) * S + c0 + g;
#pragma unroll
        for (int j = 0; j < kHalf; ++j)
          mma3(dq[j], ab, as, br[8 * j], br[S + 8 * j]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = q0 + qr + 8 * h;
        if (r >= tq) continue;
        float* dst = dq_acc + ((int64_t)bh * tq + r) * d;
#pragma unroll
        for (int j = 0; j < kHalf; ++j) {
          const int col = c0 + 8 * j + 2 * t;
          if (col + 1 < d && (d & 1) == 0) {
            atomic_add2(dst + col, dq[j][2 * h], dq[j][2 * h + 1]);
          } else {
            if (col < d) atomicAdd(dst + col, dq[j][2 * h]);
            if (col + 1 < d) atomicAdd(dst + col + 1, dq[j][2 * h + 1]);
          }
        }
      }
    }
    __syncthreads();   // every reader of this stage (and of ds^T) is done
  }

  if (use_async) cp_async_wait<0>();   // no walk: k and v still landing

  // the two q halves meet: warps 4-7 leave their sums in shared memory
  // (the q ring, free now), warps 0-3 add them and store
  float* red_dk = q_ring;
  float* red_dv = q_ring + TILE;   // the q ring's second stage or do's
  if (warp >= 4) {
#pragma unroll
    for (int j = 0; j < kSteps; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int off = (kr0 + 8 * (i >> 1)) * S + 8 * j + 2 * t + (i & 1);
        red_dk[off] = dk_acc[j][i];
        red_dv[off] = dv_acc[j][i];
      }
  }
  __syncthreads();
  if (warp < 4) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int kr = k0 + kr0 + 8 * h;
      if (kr >= tk) continue;
      T* dkrow = dk + ((int64_t)bh * tk + kr) * d;
      T* dvrow = dv + ((int64_t)bh * tk + kr) * d;
#pragma unroll
      for (int j = 0; j < kSteps; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = 8 * j + 2 * t + c;
          if (col >= d) continue;
          const int off = (kr0 + 8 * h) * S + col;
          // dk = ds^T (scale q): the scale once, here
          store(dkrow + col, (dk_acc[j][2 * h + c] + red_dk[off]) * scale);
          store(dvrow + col, dv_acc[j][2 * h + c] + red_dv[off]);
        }
    }
  }
}


// The 16-bit engine's shared memory: K, V and two stages each of the q and
// do tiles, [64][DPAD + 8] 16-bit values; with DQ ds^T [64 keys][64 + 8];
// two stages each of lse and di (float32).  The end's float32 meeting of
// dk and dv ([64][DPAD + 4] twice) reuses the q and do ring.
template <int DPAD, bool DQ>
__host__ __device__ constexpr int smem16_bytes() {
  return (6 * kBlockK * flash_f16::stride<DPAD>() +
          (DQ ? kBlockK * flash_f16::stride<kBlockQ>() : 0)) * 2 +
         4 * kBlockQ * 4;
}

// Whether the 16-bit engine's tiles come by cp.async: 16-byte rows (D % 8
// == 0) and 16-byte aligned pointers; else the threads stage the same
// 16-bit layout.
inline bool async_tiles16(const void* q, const void* k, const void* v,
                          const void* dout, int d) {
  const uintptr_t addr_bits =
      reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(dout) |
      reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v);
  return d % 8 == 0 && (addr_bits & 15) == 0;
}

// dkv_block on bfloat16 or float16 inputs (the header note's 16-bit
// engine): the same walk, warp layout, masking and float32 adds, with
// 16-bit products and the reference's roundings.  `smem` holds
// smem16_bytes<DPAD, DQ>() bytes.
template <typename T, int DPAD, bool DQ>
__device__ __forceinline__ void dkv_block16(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ di,
    T* __restrict__ dk, T* __restrict__ dv, float* __restrict__ dq_acc,
    int tq, int tk, int d, int causal, float scale, int q_offset,
    int k_offset, bool use_async, int bh, int kt, T* smem) {
  using namespace flash_f16;
  constexpr int S = stride<DPAD>();
  constexpr int SD = stride<kBlockQ>();   // ds^T's row stride
  constexpr int TILE = kBlockK * S;
  constexpr int kSteps = DPAD / 16;   // k steps of s^T, dp^T over D
  constexpr int kNd = DPAD / 8;       // n tiles of dk, dv
  constexpr int kHalf = DPAD / 16;    // n tiles of a warp's dq columns
  T* ks = smem;
  T* vs = ks + TILE;
  T* q_ring = vs + TILE;
  T* do_ring = q_ring + 2 * TILE;
  T* dst_s = do_ring + 2 * TILE;   // ds^T, with DQ
  float* lse_ring =
      reinterpret_cast<float*>(dst_s + (DQ ? kBlockK * SD : 0));
  float* di_ring = lse_ring + 2 * kBlockQ;

  const int k0 = kt * kBlockK;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;              // fragment row within 8
  const int t = lane & 3;               // lane within the row's quad
  const int kw = 16 * (warp & 3);       // this warp's keys kw .. kw + 15
  const int kr0 = kw + g;               // this thread's keys kr0, kr0 + 8
  const int qc0 = 32 * (warp >> 2);     // this warp's q columns
  const T* qb = q + (int64_t)bh * tq * d;
  const T* dob = dout + (int64_t)bh * tq * d;
  const T* kb = k + (int64_t)bh * tk * d;
  const T* vb = v + (int64_t)bh * tk * d;
  const float* lseb = lse + (int64_t)bh * tq;
  const float* dib = di + (int64_t)bh * tq;
  // the reference's q * scale in T, the scale rounded to T first
  const float scale_t = to_float(from_float<T>(scale));

  // the live q tiles are a suffix (as dkv_block's)
  const int nq = (tq + kBlockQ - 1) / kBlockQ;
  int qt0 = 0;
  while (causal && qt0 < nq &&
         q_offset + min((qt0 + 1) * kBlockQ, tq) - 1 < k_offset + k0)
    ++qt0;

  auto stage_q = [&](int qt, int stage, bool async) {
    const int q0 = qt * kBlockQ;
    stage_rows<T, DPAD, kBlockQ, kThreads>(q_ring + stage * TILE, qb, q0, tq,
                                           d, async);
    stage_rows<T, DPAD, kBlockQ, kThreads>(do_ring + stage * TILE, dob, q0,
                                           tq, d, async);
    if (threadIdx.x < kBlockQ) {
      const int r = q0 + threadIdx.x;
      const bool ok = r < tq;
      float* ls = lse_ring + stage * kBlockQ + threadIdx.x;
      float* ds = di_ring + stage * kBlockQ + threadIdx.x;
      if (async) {
        cp_async4(ls, ok ? lseb + r : lseb, ok);
        cp_async4(ds, ok ? dib + r : dib, ok);
      } else {
        *ls = ok ? lseb[r] : 0.f;
        *ds = ok ? dib[r] : 0.f;
      }
    }
  };
  // k and v, by cp.async with the first q tile's copy group
  stage_rows<T, DPAD, kBlockK, kThreads>(ks, kb, k0, tk, d, use_async);
  stage_rows<T, DPAD, kBlockK, kThreads>(vs, vb, k0, tk, d, use_async);
  if (use_async) {
    if (qt0 < nq) stage_q(qt0, 0, true);
    cp_async_commit();
  }

  // ldmatrix row addresses of this lane (matrix mi = lane / 8, its row
  // lane % 8): A (k, v) as rows +0/+8 by columns +0/+8; B (q^T, do^T) as
  // q rows +0/+8 by columns +0/+8 (two n tiles, both k halves); B of the
  // dv, dk and dq products, transposed, as rows +0/+8 by columns +0/+8
  // (both k halves, two n tiles); dq's A from ds^T, transposed, as keys
  // +0/+8 by q columns +0/+8
  const int mi = lane >> 3, mr = lane & 7;
  const int a_off = (8 * (mi & 1) + mr) * S + 8 * (mi >> 1);
  const int b_off = (8 * (mi >> 1) + mr) * S + 8 * (mi & 1);
  const int bt_off = (8 * (mi & 1) + mr) * S + 8 * (mi >> 1);
  const int dsa_off = (8 * (mi >> 1) + mr) * SD + 8 * (mi & 1);

  float dk_acc[kNd][4], dv_acc[kNd][4];
#pragma unroll
  for (int j = 0; j < kNd; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk_acc[j][i] = dv_acc[j][i] = 0.f;

  for (int qt = qt0; qt < nq; ++qt) {
    const int q0 = qt * kBlockQ;
    const int stage = (qt - qt0) & 1;
    T* qs = q_ring + stage * TILE;
    T* dos = do_ring + stage * TILE;
    const float* lse_s = lse_ring + stage * kBlockQ;
    const float* di_s = di_ring + stage * kBlockQ;
    if (use_async) {
      if (qt + 1 < nq) {
        // the stage it fills was last read before the previous barrier
        stage_q(qt + 1, stage ^ 1, true);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
    } else {
      stage_q(qt, stage, false);
    }
    // q^ = T(q * scale_t) over the chunks this thread staged
    scale_own_rows<T, DPAD, kBlockQ, kThreads>(qs, scale_t);
    __syncthreads();   // the tiles (and on the first pass k, v) are in place

    // s^T = k q^T and dp^T = v do^T: keys kr0, kr0 + 8 (rows) against q
    // columns qc0 + 8 j + 2 t (+ 1), four n tiles
    float st[4][4], dpt[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) st[j][i] = dpt[j][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      uint32_t ka[4], va[4];
      ldsm4(ka, ks + kw * S + 16 * kk + a_off);
      ldsm4(va, vs + kw * S + 16 * kk + a_off);
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        uint32_t bq[4], bd[4];
        ldsm4(bq, qs + (qc0 + 16 * jp) * S + 16 * kk + b_off);
        ldsm4(bd, dos + (qc0 + 16 * jp) * S + 16 * kk + b_off);
        mma<T>(st[2 * jp], ka, bq[0], bq[1]);
        mma<T>(st[2 * jp + 1], ka, bq[2], bq[3]);
        mma<T>(dpt[2 * jp], va, bd[0], bd[1]);
        mma<T>(dpt[2 * jp + 1], va, bd[2], bd[3]);
      }
    }

    // p^T and ds^T in float32, then rounded to T two to a register: the
    // accumulator fragments of q columns qc0 + 16 kk .. + 15 are the A
    // fragment of k step kk of dv += p^T do and dk += ds^T q.  Element
    // (j, i) is key kr0 + 8 (i >> 1), q column qc0 + 8 j + 2 t + (i & 1);
    // the mask only on a tile that a ragged edge or the causal diagonal
    // crosses (uniform in the block)
    const bool edge = q0 + kBlockQ > tq || k0 + kBlockK > tk ||
                      (causal && q_offset + q0 < k_offset + k0 + kBlockK - 1);
    uint32_t pa[2][4], da[2][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qc = qc0 + 8 * j + 2 * t + (i & 1);
        const int kpos = k0 + kr0 + 8 * (i >> 1);
        const bool ok =
            !edge || (q0 + qc < tq && kpos < tk &&
                      (!causal || q_offset + q0 + qc >= k_offset + kpos));
        // select, not multiply: exp(s - lse) is inf on a fully masked row
        const float p =
            ok ? exp2f((st[j][i] - lse_s[qc]) * kLog2e) : 0.f;
        st[j][i] = p;
        dpt[j][i] = p * (dpt[j][i] - di_s[qc]);
      }
      pa[j >> 1][2 * (j & 1)] = pack<T>(st[j][0], st[j][1]);
      pa[j >> 1][2 * (j & 1) + 1] = pack<T>(st[j][2], st[j][3]);
      da[j >> 1][2 * (j & 1)] = pack<T>(dpt[j][0], dpt[j][1]);
      da[j >> 1][2 * (j & 1) + 1] = pack<T>(dpt[j][2], dpt[j][3]);
    }

    // dv += p^ do and dk += ds^ q^ over this warp's 32 q columns, two n
    // tiles at a time, each q tile's part summed from zero and then added
    // in float32
#pragma unroll
    for (int jp = 0; jp < kNd / 2; ++jp) {
      float pv[2][4] = {}, pk[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t bd[4], bq[4];
        ldsm4_t(bd, dos + (qc0 + 16 * kk) * S + 16 * jp + bt_off);
        ldsm4_t(bq, qs + (qc0 + 16 * kk) * S + 16 * jp + bt_off);
        mma<T>(pv[0], pa[kk], bd[0], bd[1]);
        mma<T>(pv[1], pa[kk], bd[2], bd[3]);
        mma<T>(pk[0], da[kk], bq[0], bq[1]);
        mma<T>(pk[1], da[kk], bq[2], bq[3]);
      }
#pragma unroll
      for (int x = 0; x < 2; ++x)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dv_acc[2 * jp + x][i] += pv[x][i];
          dk_acc[2 * jp + x][i] += pk[x][i];
        }
    }

    if constexpr (DQ) {
      // ds^ ^T into shared memory, two q columns a 32-bit store
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<uint32_t*>(dst_s + (kr0 + 8 * h) * SD + qc0 +
                                       8 * j + 2 * t) =
              da[j >> 1][2 * (j & 1) + h];
      __syncthreads();

      // dq rows 16 (w & 3) + g (+ 8) of this tile, columns (w >> 2) * D/2
      // + 8 j + 2 t (+ 1): ds^ k, summed from zero over the tile's keys
      const int qr = kw + g;
      const int c0 = (warp >> 2) * (DPAD / 2);
      float dq[kHalf][4];
#pragma unroll
      for (int j = 0; j < kHalf; ++j)
        dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kBlockK / 16; ++kk) {
        uint32_t a[4];
        ldsm4_t(a, dst_s + 16 * kk * SD + kw + dsa_off);
#pragma unroll
        for (int jp = 0; jp < kHalf / 2; ++jp) {
          uint32_t b[4];
          ldsm4_t(b, ks + 16 * kk * S + c0 + 16 * jp + bt_off);
          mma<T>(dq[2 * jp], a, b[0], b[1]);
          mma<T>(dq[2 * jp + 1], a, b[2], b[3]);
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = q0 + qr + 8 * h;
        if (r >= tq) continue;
        float* dst = dq_acc + ((int64_t)bh * tq + r) * d;
#pragma unroll
        for (int j = 0; j < kHalf; ++j) {
          const int col = c0 + 8 * j + 2 * t;
          if (col + 1 < d && (d & 1) == 0) {
            atomic_add2(dst + col, dq[j][2 * h], dq[j][2 * h + 1]);
          } else {
            if (col < d) atomicAdd(dst + col, dq[j][2 * h]);
            if (col + 1 < d) atomicAdd(dst + col + 1, dq[j][2 * h + 1]);
          }
        }
      }
    }
    __syncthreads();   // every reader of this stage (and of ds^T) is done
  }

  if (use_async) cp_async_wait<0>();   // no walk: k, v landing

  // the two q halves meet: warps 4-7 leave their sums in shared memory
  // (the q and do ring, free now, as float32), warps 0-3 add them and store
  constexpr int SR = DPAD + 4;
  float* red_dk = reinterpret_cast<float*>(q_ring);
  float* red_dv = red_dk + kBlockK * SR;
  if (warp >= 4) {
#pragma unroll
    for (int j = 0; j < kNd; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int off = (kr0 + 8 * (i >> 1)) * SR + 8 * j + 2 * t + (i & 1);
        red_dk[off] = dk_acc[j][i];
        red_dv[off] = dv_acc[j][i];
      }
  }
  __syncthreads();
  if (warp < 4) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int kr = k0 + kr0 + 8 * h;
      if (kr >= tk) continue;
      T* dkrow = dk + ((int64_t)bh * tk + kr) * d;
      T* dvrow = dv + ((int64_t)bh * tk + kr) * d;
#pragma unroll
      for (int j = 0; j < kNd; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = 8 * j + 2 * t + c;
          if (col >= d) continue;
          const int off = (kr0 + 8 * h) * SR + col;
          // dk = ds^T q^: q^ carries the scale
          dkrow[col] = from_float<T>(dk_acc[j][2 * h + c] + red_dk[off]);
          dvrow[col] = from_float<T>(dv_acc[j][2 * h + c] + red_dv[off]);
        }
    }
  }
}

}  // namespace flash_bwd_dkv
