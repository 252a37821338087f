// Flash-attention backward for Hopper (sm_90a), behind a plain C interface.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/flash_attention.py
// `_fa_bwd_fused_kernel` (launched by `_fa_backward_pallas`): one pass
// that recomputes each (q tile, k tile) of probabilities from the
// forward's saved logsumexp and accumulates dq, dk and dv, never holding
// the [Tq, Tk] score matrix in device memory.  The caller computes
// di = rowsum(do * o) - dlse (float32 [BH, Tq]), as the TPU launcher does
// outside its kernel.
//
// What bounds it on an H100.  The live (q, k) pairs need 10 * D flops each
// (five D-long products: s, dp, dv, dk, dq).  At the training shape
// (BH = 256, T = 512, D = 64, float32, causal) that is 21.5 GFLOP against
// about 236 MB of inputs and outputs (q, k, v, do, lse, di in; dq, dk, dv
// out): 0.321 ms at the CUDA cores' float32 peak (67 TFLOP/s), 0.130 ms on
// the tensor cores at float32 accuracy (3xTF32: 495 / 3 = 165 TFLOP/s);
// the bytes take 0.07 ms.
//
// Design.  The TPU kernel keeps dq in a VMEM accumulator that persists
// across its sequential k grid; Hopper blocks run in parallel and in no
// order, so:
//   - One block per (bh, 64-row k tile); 256 threads, eight warps.  The
//     block loads its K and V tiles once and walks the q tiles that the
//     causal mask leaves alive (the TPU kernel's `_tile_alive`), a suffix
//     of the q axis.
//   - Every product runs on the tensor cores, mma.sync m16n8k8 in TF32
//     with float32 accumulation, at float32 accuracy by the 3xTF32 split
//     (as CUTLASS's OpMultiplyAddFastF32): x = big + small with big =
//     tf32(x) (to nearest, as cvt.rna) and small = tf32(x - big), and
//     a.b = a_small.b_big + a_big.b_small + a_big.b_big.  Plain TF32 is
//     not used.  bfloat16 inputs are exact in TF32 and take the same
//     path.  mma.sync, not wgmma: .tf32 wgmma needs K-major operands in
//     shared memory, and q, do (in dk, dv) and k (in dq) are N-major
//     there; mma.sync fragments are read thread by thread in any layout.
//   - Warp w takes keys 16 (w & 3) .. + 15 against q rows 32 (w >> 2) ..
//     + 31 of each q tile: s^T = k q^T and dp^T = v do^T come out with the
//     keys as rows, so p^T and ds^T = p^T * (dp^T - di) are already the A
//     operands of dv += p^T do and dk += ds^T q (a thread's accumulator
//     holds q columns 2t and 2t + 1, which fill the A fragment's two k
//     slots; do and q are read in the same order).  dk and dv accumulate
//     in float32 registers across the walk; the two q halves' sums meet
//     through shared memory at the end.
//   - dq = ds k needs the q rows as A rows: ds^T goes through shared
//     memory, and warp w computes q rows 16 (w & 3) .. + 15, half of the
//     columns, adding its tile's part with float32 atomics into a zeroed
//     [BH, Tq, D] scratch buffer (two floats an atomic), so the summation
//     order over k tiles varies from run to run.  A last pass multiplies
//     by the softmax scale once and casts, as the TPU flush does.
//   - The tensor cores add in round-toward-zero, so a running accumulator
//     would drift by an ulp per mma over a long walk: each q tile's dv,
//     dk and dq parts are summed from zero, then added by float32 adds.
//   - q and do tiles, with lse and di, go through a double-buffered ring in
//     shared memory, loaded by cp.async one tile ahead, so the next copy
//     overlaps the current tile's products; k and v come by cp.async with
//     the first q tile (float32 inputs with D % 4 == 0 and 16-byte aligned
//     pointers, and D <= 64, where two stages fit; other inputs are loaded
//     by the threads, every load of a tile in flight at once, converted to
//     float32).  q arrives
//     unscaled: s^T is scaled after its product, dk once at the end
//     (dk = ds^T (scale q)).  Rows are padded to D + 4 floats, so the
//     fragment reads hit 32 distinct banks.
//   - ds = p * (dp - di).  Masked probabilities are zero by select, never
//     by multiply: a row that every key masks has lse = -1e30, where
//     exp(s - lse) is inf and inf * 0 would be NaN.  The q offset and k
//     offset place both tiles on the global axis for the causal mask; the
//     ragged edge (rows past T, columns past D) is masked here, not padded
//     by copies.
// What still bounds it: mma.sync reaches part of the tensor cores' rate,
// each operand is split by every warp that reads it (five operations a
// value, integer rounding as in the forward), ds^T makes a round
// trip through shared memory between two barriers per q tile, and dq's
// atomics.  The atomic-free dq is the split pair's
// (flash_attention_bwd_split.cu), which the port runs where the reference
// runs its split kernels: past the fused kernel's dq accumulator cap
// (ops/kernels/flash_attention.py `_split_backward`).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_tf32.cuh"

namespace {

using namespace flash_tf32;

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;   // eight warps

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

// q and do ring stages: two where they fit beside the other tiles
template <int DPAD>
__host__ __device__ constexpr int stages() {
  return DPAD <= 64 ? 2 : 1;
}

template <int DPAD>
__host__ __device__ constexpr int tile_floats() {
  return kBlockK * (DPAD + 4);
}

template <int DPAD>
__host__ __device__ constexpr int smem_bytes() {
  // k, v, the q and do stages and ds^T, [64][DPAD + 4]; lse and di stages
  return ((3 + 2 * stages<DPAD>()) * tile_floats<DPAD>() +
          2 * stages<DPAD>() * kBlockQ) *
         static_cast<int>(sizeof(float));
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

template <typename T, int DPAD>
__global__ void __launch_bounds__(kThreads)
fa_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ di,
              T* __restrict__ dk, T* __restrict__ dv,
              float* __restrict__ dq_acc, int tq, int tk, int d, int causal,
              float scale, int q_offset, int k_offset, int use_async) {
  extern __shared__ float4 smem4[];
  constexpr int S = DPAD + 4;
  constexpr int TILE = tile_floats<DPAD>();
  constexpr int NS = stages<DPAD>();
  constexpr int kSteps = DPAD / 8;    // mma k steps over D; n tiles of dk
  constexpr int kHalf = DPAD / 16;    // n tiles of a warp's dq columns
  float* ks = reinterpret_cast<float*>(smem4);
  float* vs = ks + TILE;
  float* q_ring = vs + TILE;
  float* do_ring = q_ring + NS * TILE;
  float* dst_s = do_ring + NS * TILE;   // ds^T [64 keys][64 q]
  float* lse_ring = dst_s + TILE;
  float* di_ring = lse_ring + NS * kBlockQ;

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * kBlockK;
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

    // ds^T into shared memory for dq
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        dst_s[(kr0 + 8 * (i >> 1)) * S + qc0 + 8 * j + 2 * t + (i & 1)] =
            dpt[j][i];
    __syncthreads();

    // dq rows 16 (w & 3) + g (+ 8) of this tile, columns (w >> 2) * D/2 +
    // 8 j + 2 t (+ 1): ds (from ds^T, keys 2t, 2t + 1 in the k slots) k
    {
      const int qr = 16 * (warp & 3) + g;
      const int c0 = (warp >> 2) * (DPAD / 2);
      float dq[kHalf][4];
#pragma unroll
      for (int j = 0; j < kHalf; ++j)
        dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kBlockK / 8; ++kk) {
        const float* da = dst_s + (8 * kk + 2 * t) * S + qr;
        uint32_t ab[4], as[4];
        split4(da[0], da[8], da[S], da[S + 8], ab, as);
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
    __syncthreads();   // every reader of this stage and of ds^T is done
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

// dq = scale * dq_acc, cast to the input type (the TPU kernel's flush)
template <typename T>
__global__ void fa_bwd_dq_finish(const float* __restrict__ dq_acc,
                                 T* __restrict__ dq, int64_t n, float scale) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x)
    store(dq + i, dq_acc[i] * scale);
}

template <typename T, int DPAD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* di,
                   void* dq, void* dk, void* dv, void* dq_acc, int bh,
                   int tq, int tk, int d, int causal, float scale,
                   int q_offset, int k_offset, cudaStream_t stream) {
  constexpr int smem = smem_bytes<DPAD>();
  cudaError_t err = cudaFuncSetAttribute(
      fa_bwd_kernel<T, DPAD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const int64_t n = (int64_t)bh * tq * d;
  err = cudaMemsetAsync(dq_acc, 0, n * sizeof(float), stream);
  if (err != cudaSuccess) return err;
  // cp.async takes 16-byte rows of float32 q and do, where two stages fit
  const uintptr_t addr_bits =
      reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(dout) |
      reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v);
  const int use_async = sizeof(T) == 4 && stages<DPAD>() == 2 &&
                        d % 4 == 0 && (addr_bits & 15) == 0;
  const dim3 grid((tk + kBlockK - 1) / kBlockK, bh);
  fa_bwd_kernel<T, DPAD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(di),
      static_cast<T*>(dk), static_cast<T*>(dv), static_cast<float*>(dq_acc),
      tq, tk, d, causal, scale, q_offset, k_offset, use_async);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t blocks = (n + 255) / 256;
  fa_bwd_dq_finish<T><<<(unsigned)(blocks < 4096 ? blocks : 4096), 256, 0,
                         stream>>>(static_cast<const float*>(dq_acc),
                                   static_cast<T*>(dq), n, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* di,
                     void* dq, void* dk, void* dv, void* dq_acc, int bh,
                     int tq, int tk, int d, int causal, float scale,
                     int q_offset, int k_offset, cudaStream_t stream) {
  if (d <= 32)
    return launch<T, 32>(q, k, v, dout, lse, di, dq, dk, dv, dq_acc, bh, tq,
                         tk, d, causal, scale, q_offset, k_offset, stream);
  if (d <= 64)
    return launch<T, 64>(q, k, v, dout, lse, di, dq, dk, dv, dq_acc, bh, tq,
                         tk, d, causal, scale, q_offset, k_offset, stream);
  return launch<T, 128>(q, k, v, dout, lse, di, dq, dk, dv, dq_acc, bh, tq,
                        tk, d, causal, scale, q_offset, k_offset, stream);
}

}  // namespace

extern "C" {

// q, do: contiguous [bh, tq, d]; k, v: [bh, tk, d]; float32 (is_bf16 = 0)
// or bfloat16 (is_bf16 = 1), 1 <= d <= 128, bh <= 65535.  lse, di:
// float32 [bh, tq].  Writes dq [bh, tq, d] and dk, dv [bh, tk, d] in the
// input type on `stream`, using dq_acc (float32 [bh, tq, d], any contents)
// as scratch.  Returns the CUDA error of the launches (0 on success); does
// not synchronise.
int paddle_flash_attention_bwd(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* di, void* dq, void* dk, void* dv,
                               void* dq_acc, int bh, int tq, int tk, int d,
                               int is_bf16, int causal, float scale,
                               int q_offset, int k_offset, void* stream) {
  if (bh < 1 || bh > 65535 || tq < 1 || tk < 1 || d < 1 || d > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return static_cast<int>(dispatch<__nv_bfloat16>(
        q, k, v, dout, lse, di, dq, dk, dv, dq_acc, bh, tq, tk, d, causal,
        scale, q_offset, k_offset, s));
  return static_cast<int>(dispatch<float>(q, k, v, dout, lse, di, dq, dk, dv,
                                          dq_acc, bh, tq, tk, d, causal,
                                          scale, q_offset, k_offset, s));
}

const char* paddle_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
