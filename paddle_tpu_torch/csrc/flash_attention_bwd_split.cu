// Split flash-attention backward for Hopper (sm_90a), behind a plain C
// interface: one kernel for dk and dv, one for dq.
//
// Replaces the TPU kernels paddle_tpu/ops/pallas/flash_attention.py
// `_fa_bwd_dkv_kernel` and `_fa_bwd_dq_kernel`, the pair
// `_fa_backward_pallas` launches in place of its fused kernel when the fused
// kernel's dq accumulator would not fit (T > 65536 at D = 64).  Both
// recompute each (q tile, k tile) of probabilities from the forward's saved
// logsumexp, never holding the [Tq, Tk] score matrix in device memory.  The
// caller computes di = rowsum(do * o) - dlse (float32 [BH, Tq]), as the TPU
// launcher does outside its kernels.
//
// What bounds them on an H100.  At one 128K-context layer (BH = 8,
// T = 131072, D = 64, float32, causal) there are 6.87e10 live (q, k) pairs.
// The dk/dv kernel does four D-long products per pair (s, dp, dv, dk),
// 8 * D flops, 35 TFLOP; the dq kernel three (s, dp, dq), 6 * D flops,
// 26 TFLOP.  Their bytes (q, k, v, do, lse, di in; dk, dv or dq out) are
// under 2 GB.  So operations bound both, and both compute on the tensor
// cores at float32 accuracy (3xTF32: three TF32 products a float32
// product, 495 / 3 = 165 TFLOP/s): 0.21 s for dk/dv, 0.16 s for dq (on the
// CUDA cores' 67 TFLOP/s they would be 0.53 s and 0.39 s).  Redoing s and
// dp in both kernels is the split's price over the fused kernel (7
// products per pair instead of 5), as on the TPU.
//
// The design follows the card, not the TPU's block walk.  The TPU kernels
// carry their accumulators in VMEM across a sequential grid axis; Hopper
// blocks run in parallel and in no order, so each block owns one output
// tile and walks the other axis in a loop.  No atomics and no scratch
// buffer: both kernels are deterministic.  Every product runs on the
// tensor cores, mma.sync m16n8k8 in TF32 with float32 accumulation, at
// float32 accuracy by the 3xTF32 split (flash_tf32.cuh); plain TF32 is
// not used.  On bfloat16 and float16 inputs the dk/dv kernel runs the
// engine's 16-bit path (16-bit mma.sync, flash_bwd_dkv.cuh), and the dq
// kernel keeps its 3xTF32 path with the reference's roundings: q times
// the scale rounded to the input type (the scale rounded first), the
// scores in base e, ds rounded to the input type before ds k.  A rounded
// value is exact in TF32, so its split's small part is zero.
//   - dk/dv: one block per (bh, 64-row k tile), the fused backward's dk/dv
//     engine (flash_bwd_dkv.cuh) without its dq: the block loads its K and
//     V tiles once and walks the q tiles the causal mask leaves alive, q,
//     do, lse and di coming by a cp.async ring one tile ahead; s^T, p^T,
//     dp^T and ds^T stay in the warps' registers as mma.sync fragments,
//     and each q tile's dk and dv parts are summed from zero on the tensor
//     cores, then added in float32.  The same code computes the fused
//     kernel's dk and dv, so the two are bitwise equal.  Without dq the
//     block keeps no ds^T tile, so two blocks fit an SM at D <= 64.
//   - dq: one block per (bh, 64-row q tile), the forward kernel's q-tile
//     walk (flash_attention_fwd.cu) without its online softmax, since lse
//     is given.  The block holds its q tile and its do tile in shared
//     memory and walks the k tiles the causal mask leaves alive, K and V
//     coming by a double-buffered cp.async ring one tile ahead.  q is
//     scaled once by the softmax scale (as the TPU launcher does, so ds
//     needs no scale) times log2(e), and lse taken in base 2, so
//     p = exp2(s - lse) as in the forward (3% faster at 128K than
//     exp(s - lse) on an H100).  256 threads, eight warps: warp w takes
//     query rows 16 (w & 3) .. + 15 against keys 32 (w >> 2) .. + 31 of
//     each k tile, so s = q k^T and dp = do v^T come out as accumulator
//     fragments with the queries as rows, 16 registers each.  p and ds = p * (dp - di)
//     are formed in those registers, and the ds fragment is the A operand
//     of dq += ds k with no shuffle (a thread holds keys 2t and 2t + 1 of
//     each 8-key step, which fill the A fragment's two k slots; k is read
//     N-major in that order, as the forward reads v).  The two warps of a
//     row slab meet through shared memory once, at the end.
//   - The tensor cores add in round-toward-zero, so a running accumulator
//     would drift by an ulp per mma over a long walk (2048 k tiles at
//     128K): each k tile's dq part is summed from zero, then added in
//     float32, and the softmax scale is folded in once at the end.
//   - Registers: a warp's dq total and its tile part take D / 2 each, s
//     and dp 16 each; q and do stay in shared memory and their fragments
//     are read per k step (as the forward does for q at D = 128), so the
//     kernel fits 128 registers and two blocks an SM at D <= 64 (104 KB of
//     shared memory each).  Rows are padded to D + 4 floats, so every
//     fragment read hits 32 distinct banks.
//   - ds = p * (dp - di).  Masked probabilities are zero by select, never
//     by multiply: a row that every key masks has lse = -1e30, where
//     exp(s - lse) is inf and inf * 0 would be NaN.  Offsets place both
//     tiles on the global axis for the mask; rows past T and columns past D
//     are masked or zero-filled here, not padded by copies.  A k tile that
//     no query sees writes zero dk and dv, a q tile that sees no key writes
//     zero dq.
//   - The dq kernel's tiles come by cp.async for float32 inputs with
//     D % 4 == 0 and 16-byte aligned pointers; other inputs are loaded by
//     the threads and converted to float32 into the same places.
//   - Causal walks are triangular: block (bh, y) takes the y-th longest
//     walk, and blocks start in order of y, so the longest walks start
//     first and the short ones fill the tail.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_bwd_dkv.cuh"
#include "flash_tf32.cuh"

namespace {

using namespace flash_tf32;
using flash_bwd_dkv::copy_tile;
using flash_bwd_dkv::load_tile;

constexpr int kTile = 64;         // rows of a q tile and of a k tile
// the dq kernel's eight warps: the dk/dv engine's, whose tile copies and
// loads (64 rows over 256 threads) it shares
constexpr int kThreads = flash_bwd_dkv::kThreads;
constexpr int kKeys = kTile / 2;  // keys of a k tile a warp takes
constexpr float kLog2e = 1.4426950408889634f;

// x rounded to T and back: the reference's roundings of q times the
// scale and of ds on 16-bit inputs; the identity on float32
template <typename T>
__device__ __forceinline__ float rounded(float x) {
  if constexpr (sizeof(T) == 4)
    return x;
  else
    return to_float(flash_f16::from_float<T>(x));
}

template <int DPAD>
constexpr int dq_smem_bytes() {
  // two stages each of the K and V tiles, and the q and do tiles, each
  // [64][DPAD + 4]
  return 6 * flash_bwd_dkv::tile_floats<DPAD>() *
         static_cast<int>(sizeof(float));
}

// dk and dv of (bh, k tile y): the fused backward's engine without dq
// (float32 two blocks an SM at D <= 64; 16-bit one, as the fused kernel)
template <typename T, int DPAD>
__global__ void __launch_bounds__(flash_bwd_dkv::kThreads,
                                  sizeof(T) == 4 && DPAD <= 64 ? 2 : 1)
fa_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ di,
                  T* __restrict__ dk, T* __restrict__ dv, int tq, int tk,
                  int d, int causal, float scale, int q_offset, int k_offset,
                  int use_async) {
  extern __shared__ float4 smem4[];
  if constexpr (sizeof(T) == 2)
    flash_bwd_dkv::dkv_block16<T, DPAD, false>(
        q, k, v, dout, lse, di, dk, dv, nullptr, tq, tk, d, causal, scale,
        q_offset, k_offset, use_async != 0, blockIdx.x, blockIdx.y,
        reinterpret_cast<T*>(smem4));
  else
    flash_bwd_dkv::dkv_block<T, DPAD, false>(
        q, k, v, dout, lse, di, dk, dv, nullptr, tq, tk, d, causal, scale,
        q_offset, k_offset, use_async, blockIdx.x, blockIdx.y,
        reinterpret_cast<float*>(smem4));
}

// dq of (bh, q tile nq - 1 - y)
template <typename T, int DPAD>
__global__ void __launch_bounds__(kThreads, DPAD <= 64 ? 2 : 1)
fa_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ di,
                 T* __restrict__ dq, int tq, int tk, int d, int causal,
                 float scale, int q_offset, int k_offset, int use_async) {
  extern __shared__ float4 smem4[];
  constexpr int S = DPAD + 4;
  constexpr int TILE = flash_bwd_dkv::tile_floats<DPAD>();
  constexpr int kSteps = DPAD / 8;   // mma k steps over D; n tiles of dq
  float* k_ring = reinterpret_cast<float*>(smem4);
  float* v_ring = k_ring + 2 * TILE;
  float* qs = v_ring + 2 * TILE;
  float* dos = qs + TILE;

  const int bh = blockIdx.x;
  const int nq = (tq + kTile - 1) / kTile;
  // y = 0: the last q tile, the longest causal walk
  const int q0 = (nq - 1 - (int)blockIdx.y) * kTile;
  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2;   // fragment row within 8
  const int t = threadIdx.x & 3;           // lane within the row's quad
  const int r0 = 16 * (warp & 3) + g;      // this thread's rows r0, r0 + 8
  const int kh = kKeys * (warp >> 2);      // this warp's keys of a k tile
  const T* qb = q + (int64_t)bh * tq * d;
  const T* dob = dout + (int64_t)bh * tq * d;
  const T* kb = k + (int64_t)bh * tk * d;
  const T* vb = v + (int64_t)bh * tk * d;

  // the live k tiles are a prefix: past the newest key the tile's newest
  // query may see (on the local axis), every tile is dead
  int nk = (tk + kTile - 1) / kTile;
  if (causal) {
    const int k_last = q_offset + min(q0 + kTile, tq) - 1 - k_offset;
    nk = min(nk, k_last < 0 ? 0 : k_last / kTile + 1);
  }
  // the softmax scale is folded into q, as the TPU launcher does, with
  // log2(e): the scores are in base 2 and p takes exp2
  const float q_mul = scale * kLog2e;
  // q and do, then the first K and V tiles, each its own copy group
  if (use_async) {
    copy_tile<DPAD>(qs, reinterpret_cast<const float*>(qb), q0, tq, d);
    copy_tile<DPAD>(dos, reinterpret_cast<const float*>(dob), q0, tq, d);
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
    load_tile<T, DPAD>(qs, qb, q0, tq, d);
    load_tile<T, DPAD>(dos, dob, q0, tq, d);
  }
  __syncthreads();
  // q arrived unscaled: its scale goes in once, here.  On 16-bit inputs
  // q^ = T(q * T(scale)), the reference's q times the scale, and the
  // scores stay in base e
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int it = 0; it < kTile * DPAD / kThreads; ++it) {
      const int idx = threadIdx.x + it * kThreads;
      qs[(idx / DPAD) * S + idx % DPAD] *= q_mul;
    }
  } else {
    const float scale_t = rounded<T>(scale);
#pragma unroll
    for (int it = 0; it < kTile * DPAD / kThreads; ++it) {
      const int idx = threadIdx.x + it * kThreads;
      float* x = qs + (idx / DPAD) * S + idx % DPAD;
      *x = rounded<T>(*x * scale_t);
    }
  }
  // lse (in base 2 on float32 inputs) and di of this thread's rows (zero
  // past T)
  float lse_r[2], di_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = q0 + r0 + 8 * h;
    if constexpr (sizeof(T) == 4)
      lse_r[h] = r < tq ? lse[(int64_t)bh * tq + r] * kLog2e : 0.f;
    else
      lse_r[h] = r < tq ? lse[(int64_t)bh * tq + r] : 0.f;
    di_r[h] = r < tq ? di[(int64_t)bh * tq + r] : 0.f;
  }

  float acc[kSteps][4];
#pragma unroll
  for (int j = 0; j < kSteps; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kTile;
    const float* ks = k_ring + (kt & 1) * TILE;
    const float* vs = v_ring + (kt & 1) * TILE;
    if (use_async) {
      if (kt + 1 < nk) {
        // the stage it fills was last read before the previous barrier
        copy_tile<DPAD>(k_ring + ((kt + 1) & 1) * TILE,
                        reinterpret_cast<const float*>(kb), k0 + kTile, tk,
                        d);
        copy_tile<DPAD>(v_ring + ((kt + 1) & 1) * TILE,
                        reinterpret_cast<const float*>(vb), k0 + kTile, tk,
                        d);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
    } else {
      load_tile<T, DPAD>(k_ring + (kt & 1) * TILE, kb, k0, tk, d);
      load_tile<T, DPAD>(v_ring + (kt & 1) * TILE, vb, k0, tk, d);
    }
    __syncthreads();   // the tile (and on the first pass q, do) is in place

    // s = (scale log2(e) q) k^T and dp = do v^T: rows r0, r0 + 8 against keys
    // kh + 8 j + 2 t (+ 1), four n tiles
    float s[4][4], dp[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = dp[j][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      const float* qa = qs + r0 * S + 8 * kk + t;
      const float* da = dos + r0 * S + 8 * kk + t;
      uint32_t qab[4], qas[4], dab[4], das[4];
      split4(qa[0], qa[8 * S], qa[4], qa[8 * S + 4], qab, qas);
      split4(da[0], da[8 * S], da[4], da[8 * S + 4], dab, das);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int off = (kh + 8 * j + g) * S + 8 * kk + t;
        mma3(s[j], qab, qas, ks[off], ks[off + 4]);
        mma3(dp[j], dab, das, vs[off], vs[off + 4]);
      }
    }

    // p and ds in place of s; element (j, i) is row r0 + 8 (i >> 1), key
    // kh + 8 j + 2 t + (i & 1).  The mask only on a tile that a ragged
    // edge or the causal diagonal crosses (uniform in the block)
    const bool edge = q0 + kTile > tq || k0 + kTile > tk ||
                      (causal && q_offset + q0 < k_offset + k0 + kTile - 1);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qr = q0 + r0 + 8 * (i >> 1);
        const int kpos = k0 + kh + 8 * j + 2 * t + (i & 1);
        const bool ok = !edge || (qr < tq && kpos < tk &&
                                  (!causal ||
                                   q_offset + qr >= k_offset + kpos));
        // select, not multiply: exp2(s - lse) is inf on a fully masked
        // row.  On 16-bit inputs ds is rounded to T, as the reference
        // rounds it before ds k
        float p;
        if constexpr (sizeof(T) == 4)
          p = ok ? exp2f(s[j][i] - lse_r[i >> 1]) : 0.f;
        else
          p = ok ? expf(s[j][i] - lse_r[i >> 1]) : 0.f;
        s[j][i] = rounded<T>(p * (dp[j][i] - di_r[i >> 1]));
      }
    }

    // this k tile's ds k over the warp's 32 keys, summed from zero (keys
    // 2t, 2t + 1 in the A fragment's k slots, k read in that order), then
    // added to the total in float32
    float part[kSteps][4];
#pragma unroll
    for (int j = 0; j < kSteps; ++j)
      part[j][0] = part[j][1] = part[j][2] = part[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t ab[4], as[4];
      split4(s[kk][0], s[kk][2], s[kk][1], s[kk][3], ab, as);
      const float* kr = ks + (kh + 8 * kk + 2 * t) * S + g;
#pragma unroll
      for (int j = 0; j < kSteps; ++j)
        mma3(part[j], ab, as, kr[8 * j], kr[S + 8 * j]);
    }
#pragma unroll
    for (int j = 0; j < kSteps; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] += part[j][i];
    __syncthreads();   // every reader of this stage is done
  }

  // the two key halves meet: warps 4-7 leave their sums in shared memory
  // (the K ring, free now), warps 0-3 add them and store
  float* red = k_ring;
  if (warp >= 4) {
#pragma unroll
    for (int j = 0; j < kSteps; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        red[(r0 + 8 * (i >> 1)) * S + 8 * j + 2 * t + (i & 1)] = acc[j][i];
  }
  __syncthreads();
  if (warp < 4) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qr = q0 + r0 + 8 * h;
      if (qr >= tq) continue;
      T* dqrow = dq + ((int64_t)bh * tq + qr) * d;
#pragma unroll
      for (int j = 0; j < kSteps; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = 8 * j + 2 * t + c;
          // ds carried no scale (q carried it into s alone): fold it in
          // once
          if (col < d)
            store(dqrow + col,
                  (acc[j][2 * h + c] + red[(r0 + 8 * h) * S + col]) * scale);
        }
    }
  }
}

template <typename T, int DPAD>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* di,
                       void* dk, void* dv, int bh, int tq, int tk, int d,
                       int causal, float scale, int q_offset, int k_offset,
                       cudaStream_t stream) {
  constexpr int smem = sizeof(T) == 4
                           ? flash_bwd_dkv::smem_bytes<DPAD, false>()
                           : flash_bwd_dkv::smem16_bytes<DPAD, false>();
  cudaError_t err = cudaFuncSetAttribute(
      fa_bwd_dkv_kernel<T, DPAD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const int use_async =
      sizeof(T) == 4 ? flash_bwd_dkv::async_tiles<T, DPAD>(q, k, v, dout, d)
                     : flash_bwd_dkv::async_tiles16(q, k, v, dout, d);
  const dim3 grid(bh, (tk + kTile - 1) / kTile);
  fa_bwd_dkv_kernel<T, DPAD><<<grid, flash_bwd_dkv::kThreads, smem,
                               stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(di),
      static_cast<T*>(dk), static_cast<T*>(dv), tq, tk, d, causal, scale,
      q_offset, k_offset, use_async);
  return cudaGetLastError();
}

template <typename T, int DPAD>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* di,
                      void* dq, int bh, int tq, int tk, int d, int causal,
                      float scale, int q_offset, int k_offset,
                      cudaStream_t stream) {
  constexpr int smem = dq_smem_bytes<DPAD>();
  cudaError_t err = cudaFuncSetAttribute(
      fa_bwd_dq_kernel<T, DPAD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  // cp.async takes 16-byte rows of float32 q, do, K and V
  const int use_async =
      sizeof(T) == 4 && d % 4 == 0 &&
      ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(dout) |
        reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) &
       15) == 0;
  const dim3 grid(bh, (tq + kTile - 1) / kTile);
  fa_bwd_dq_kernel<T, DPAD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(di),
      static_cast<T*>(dq), tq, tk, d, causal, scale, q_offset, k_offset,
      use_async);
  return cudaGetLastError();
}

// the head-dim tiers of the forward and the fused kernel
template <typename T>
cudaError_t dispatch_dkv(const void* q, const void* k, const void* v,
                         const void* dout, const void* lse, const void* di,
                         void* dk, void* dv, int bh, int tq, int tk, int d,
                         int causal, float scale, int q_offset, int k_offset,
                         cudaStream_t s) {
  if (d <= 32)
    return launch_dkv<T, 32>(q, k, v, dout, lse, di, dk, dv, bh, tq, tk, d,
                             causal, scale, q_offset, k_offset, s);
  if (d <= 64)
    return launch_dkv<T, 64>(q, k, v, dout, lse, di, dk, dv, bh, tq, tk, d,
                             causal, scale, q_offset, k_offset, s);
  return launch_dkv<T, 128>(q, k, v, dout, lse, di, dk, dv, bh, tq, tk, d,
                            causal, scale, q_offset, k_offset, s);
}

template <typename T>
cudaError_t dispatch_dq(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* di,
                        void* dq, int bh, int tq, int tk, int d, int causal,
                        float scale, int q_offset, int k_offset,
                        cudaStream_t s) {
  if (d <= 32)
    return launch_dq<T, 32>(q, k, v, dout, lse, di, dq, bh, tq, tk, d,
                            causal, scale, q_offset, k_offset, s);
  if (d <= 64)
    return launch_dq<T, 64>(q, k, v, dout, lse, di, dq, bh, tq, tk, d,
                            causal, scale, q_offset, k_offset, s);
  return launch_dq<T, 128>(q, k, v, dout, lse, di, dq, bh, tq, tk, d, causal,
                           scale, q_offset, k_offset, s);
}

bool bad_shape(int bh, int tq, int tk, int d) {
  return bh < 1 || tq < 1 || tk < 1 || d < 1 || d > 128 ||
         (tq + kTile - 1) / kTile > 65535 || (tk + kTile - 1) / kTile > 65535;
}

}  // namespace

extern "C" {

// q, do: contiguous [bh, tq, d]; k, v: [bh, tk, d]; float32 (dtype = 0),
// bfloat16 (dtype = 1) or float16 (dtype = 2), 1 <= d <= 128, at most
// 65535 64-row tiles on each axis.  lse, di: float32 [bh, tq].  Writes dk, dv [bh, tk, d] in the
// input type on `stream`.  Returns the CUDA error of the launch (0 on
// success); does not synchronise.
int paddle_flash_attention_bwd_dkv(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* di, void* dk,
                                   void* dv, int bh, int tq, int tk, int d,
                                   int dtype, int causal, float scale,
                                   int q_offset, int k_offset, void* stream) {
  if (bad_shape(bh, tq, tk, d))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return static_cast<int>(dispatch_dkv<__nv_bfloat16>(
        q, k, v, dout, lse, di, dk, dv, bh, tq, tk, d, causal, scale,
        q_offset, k_offset, s));
  if (dtype == 2)
    return static_cast<int>(dispatch_dkv<__half>(
        q, k, v, dout, lse, di, dk, dv, bh, tq, tk, d, causal, scale,
        q_offset, k_offset, s));
  return static_cast<int>(dispatch_dkv<float>(q, k, v, dout, lse, di, dk,
                                              dv, bh, tq, tk, d, causal,
                                              scale, q_offset, k_offset, s));
}

// As paddle_flash_attention_bwd_dkv; writes dq [bh, tq, d].
int paddle_flash_attention_bwd_dq(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const void* lse, const void* di, void* dq,
                                  int bh, int tq, int tk, int d, int dtype,
                                  int causal, float scale, int q_offset,
                                  int k_offset, void* stream) {
  if (bad_shape(bh, tq, tk, d))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return static_cast<int>(dispatch_dq<__nv_bfloat16>(
        q, k, v, dout, lse, di, dq, bh, tq, tk, d, causal, scale, q_offset,
        k_offset, s));
  if (dtype == 2)
    return static_cast<int>(dispatch_dq<__half>(
        q, k, v, dout, lse, di, dq, bh, tq, tk, d, causal, scale, q_offset,
        k_offset, s));
  return static_cast<int>(dispatch_dq<float>(q, k, v, dout, lse, di, dq, bh,
                                             tq, tk, d, causal, scale,
                                             q_offset, k_offset, s));
}

const char* paddle_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
