// Row-sparse (SelectedRows) optimizer applies for Hopper (sm_90a), behind a
// plain C interface.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/table_update.py
// `_rowwise_kernel` (launched by `_rowwise_call`) with its three rules:
// sparse_apply_sgd, sparse_apply_adagrad and sparse_apply_adam (lazy Adam:
// the moments decay and the parameter moves only on touched rows).  The
// tables [height, D] are updated in place and untouched rows are never read
// or written.
//
// Input contract (the wrapper, ops/kernels/table_update.py, prepares it):
// `srows` [K] are the ids normalised as the TPU wrapper's `_prep` does
// (negatives wrapped, anything else outside [0, height) the sentinel
// `height`) and sorted stably; `order` [K] maps each sorted slot to its
// original slot, so that the value of sorted slot s is vals[order[s]].
// Equal ids form consecutive runs in slot order, and sentinels sort to the
// tail.
//
// Design.  The TPU walks the sorted ids on a sequential grid, one [1, D]
// row per step, and a revisited row stays resident in VMEM, so duplicates
// accumulate in slot order.  On the card one warp takes each sorted slot;
// a warp whose slot does not start a run (or is a sentinel) exits at once.
// The warp of a run finds its end with ballots over 32 slots at a time and
// then, for each chunk of 32 * kVec columns (lane l owns columns l + 32 v):
//   sgd      p = p + (-lr) * v_s for each slot s of the run, in slot order
//            (the TPU kernel's accumulate semantics);
//   adagrad  g = the sum of the run's values in slot order, then
//            moment' = moment + g * g and p' = p + (-lr) * g /
//            (sqrt(moment') + eps);
//   adam     g as above, m_row = b1 * m + (1 - b1) * g, v_row = b2 * v +
//            (1 - b2) * (g * g), m' = m + (m_row - m), v' = v + (v_row - v),
//            p' = p + (-lr_t) * m_row / (sqrt(v_row) + eps).
// The run's loads are issued four slots ahead of the sums that use them.
// Summing each run in slot order in registers makes the merge deterministic
// (a library index_add on the card sums by atomics in no fixed order).
//
// Bitwise contract.  The result equals the plain PyTorch version
// (ops/kernels/table_update.py plain_sparse_apply_*) evaluated eagerly on
// the card: every product, sum, quotient and square root is rounded
// separately with the _rn intrinsics in the plain version's order, so nvcc
// cannot contract a multiply and an add (this file must not be built with
// --use_fast_math).  Where the TPU kernel rounds Adagrad's moment + g^2
// twice (XLA contracts one of them into an FMA), the port's eager rule
// rounds g * g once and adds it once, and this kernel does the same.
//
// What bounds it on an H100: bytes.  Each touched row of every table is
// read and written once and each value row read once: at the seq2seq
// translator's K = 32768 ids of D = 256 over a 30000-row table that is
// about 33.6 MB of values, 0.4 MB of ids and order, and (lazy Adam, three
// tables) 6 KB a unique row.  A Zipf-shaped id set
// puts about a quarter of the slots on one row, whose warp then sums ~8k
// value rows serially; that one warp may decide the kernel's time.  A
// deterministic split of heavy runs is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // 8 warps a block
constexpr int kVec = 8;         // columns per lane per chunk
constexpr int kAhead = 4;       // slots loaded ahead of their sums

enum Rule { kSgd = 0, kAdagrad = 1, kAdam = 2 };

// s[v] += vals[order[slot]][c0 + lane + 32 v] (times nlr for sgd) for the
// slots [first, end) in order; loads run kAhead slots ahead
template <bool SCALE>
__device__ __forceinline__ void fold_run(float (&s)[kVec],
                                         const int64_t* __restrict__ order,
                                         const float* __restrict__ vals,
                                         int64_t first, int64_t end, int D,
                                         int c0, int lane, float nlr) {
  int64_t q = first;
  for (; q + kAhead <= end; q += kAhead) {
    float buf[kAhead][kVec];
#pragma unroll
    for (int a = 0; a < kAhead; ++a) {
      const float* vr = vals + order[q + a] * (int64_t)D;
#pragma unroll
      for (int v = 0; v < kVec; ++v) {
        const int col = c0 + lane + 32 * v;
        buf[a][v] = col < D ? vr[col] : 0.0f;
      }
    }
#pragma unroll
    for (int a = 0; a < kAhead; ++a)
#pragma unroll
      for (int v = 0; v < kVec; ++v)
        s[v] = __fadd_rn(s[v], SCALE ? __fmul_rn(nlr, buf[a][v]) : buf[a][v]);
  }
  for (; q < end; ++q) {
    const float* vr = vals + order[q] * (int64_t)D;
#pragma unroll
    for (int v = 0; v < kVec; ++v) {
      const int col = c0 + lane + 32 * v;
      const float x = col < D ? vr[col] : 0.0f;
      s[v] = __fadd_rn(s[v], SCALE ? __fmul_rn(nlr, x) : x);
    }
  }
}

// a..e by rule:
//   sgd      (none)
//   adagrad  a = epsilon
//   adam     a = beta1, b = beta2, c = epsilon, d = 1 - beta1, e = 1 - beta2
template <int RULE>
__global__ void __launch_bounds__(kThreads)
rowwise_kernel(const int* __restrict__ srows,
               const int64_t* __restrict__ order,
               const float* __restrict__ vals, int64_t K, int D, int height,
               float* __restrict__ p, float* __restrict__ s1,
               float* __restrict__ s2, const float* __restrict__ lr_ptr,
               float a, float b, float c, float d, float e) {
  const int64_t w = (blockIdx.x * (int64_t)blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (w >= K) return;
  const int row = srows[w];
  if (row < 0 || row >= height) return;        // a sentinel
  if (w > 0 && srows[w - 1] == row) return;    // not the start of its run
  // the run is [w, end): ids are sorted, so `same` is a prefix of the lanes
  int64_t end = w + 1;
  for (;;) {
    const int64_t q = end + lane;
    const bool same = q < K && srows[q] == row;
    const unsigned m = __ballot_sync(0xffffffffu, same);
    if (m == 0xffffffffu) {
      end += 32;
      continue;
    }
    end += __ffs(~m) - 1;
    break;
  }
  const float nlr = -(*lr_ptr);
  const int64_t base = (int64_t)row * D;
  for (int c0 = 0; c0 < D; c0 += 32 * kVec) {
    if (RULE == kSgd) {
      float pv[kVec];
#pragma unroll
      for (int v = 0; v < kVec; ++v) {
        const int col = c0 + lane + 32 * v;
        pv[v] = col < D ? p[base + col] : 0.0f;
      }
      fold_run<true>(pv, order, vals, w, end, D, c0, lane, nlr);
#pragma unroll
      for (int v = 0; v < kVec; ++v) {
        const int col = c0 + lane + 32 * v;
        if (col < D) p[base + col] = pv[v];
      }
      continue;
    }
    // g = the run's values summed in slot order
    float g[kVec];
    const float* v0 = vals + order[w] * (int64_t)D;
#pragma unroll
    for (int v = 0; v < kVec; ++v) {
      const int col = c0 + lane + 32 * v;
      g[v] = col < D ? v0[col] : 0.0f;
    }
    fold_run<false>(g, order, vals, w + 1, end, D, c0, lane, nlr);
#pragma unroll
    for (int v = 0; v < kVec; ++v) {
      const int col = c0 + lane + 32 * v;
      if (col >= D) continue;
      const int64_t i = base + col;
      const float gv = g[v];
      if (RULE == kAdagrad) {
        const float mom = __fadd_rn(s1[i], __fmul_rn(gv, gv));
        s1[i] = mom;
        p[i] = __fadd_rn(p[i], __fdiv_rn(__fmul_rn(nlr, gv),
                                         __fadd_rn(__fsqrt_rn(mom), a)));
      } else {
        const float m = s1[i], vv = s2[i];
        const float m_row = __fadd_rn(__fmul_rn(a, m), __fmul_rn(d, gv));
        const float v_row =
            __fadd_rn(__fmul_rn(b, vv), __fmul_rn(e, __fmul_rn(gv, gv)));
        s1[i] = __fadd_rn(m, __fsub_rn(m_row, m));
        s2[i] = __fadd_rn(vv, __fsub_rn(v_row, vv));
        p[i] = __fadd_rn(p[i], __fdiv_rn(__fmul_rn(nlr, m_row),
                                         __fadd_rn(__fsqrt_rn(v_row), c)));
      }
    }
  }
}

}  // namespace

extern "C" {

// rule 0 sgd (p), 1 adagrad (p, s1 = moment), 2 adam (p, s1 = moment1,
// s2 = moment2): tables contiguous float32 [height, D]; srows int32 [K]
// (normalised and sorted), order int64 [K], vals float32 [K, D], lr a
// float32 scalar (Adam's bias-corrected rate): all on the device.  Updates
// the touched rows in place on `stream`; returns the CUDA error of the
// launch (0 on success, and at once for K = 0); does not synchronise.
int paddle_table_update(int rule, const void* srows, const void* order,
                        const void* vals, int64_t K, int D, int height,
                        void* p, void* s1, void* s2, const void* lr, float a,
                        float b, float c, float d, float e, void* stream) {
  if (K < 0 || D < 1 || height < 1 || rule < kSgd || rule > kAdam)
    return static_cast<int>(cudaErrorInvalidValue);
  if (K == 0) return 0;
  if ((rule >= kAdagrad && s1 == nullptr) || (rule == kAdam && s2 == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t warps_per_block = kThreads / 32;
  const unsigned blocks =
      static_cast<unsigned>((K + warps_per_block - 1) / warps_per_block);
  const int* r = static_cast<const int*>(srows);
  const int64_t* o = static_cast<const int64_t*>(order);
  const float* v = static_cast<const float*>(vals);
  float* pp = static_cast<float*>(p);
  float* p1 = static_cast<float*>(s1);
  float* p2 = static_cast<float*>(s2);
  const float* l = static_cast<const float*>(lr);
  if (rule == kSgd)
    rowwise_kernel<kSgd><<<blocks, kThreads, 0, st>>>(
        r, o, v, K, D, height, pp, p1, p2, l, a, b, c, d, e);
  else if (rule == kAdagrad)
    rowwise_kernel<kAdagrad><<<blocks, kThreads, 0, st>>>(
        r, o, v, K, D, height, pp, p1, p2, l, a, b, c, d, e);
  else
    rowwise_kernel<kAdam><<<blocks, kThreads, 0, st>>>(
        r, o, v, K, D, height, pp, p1, p2, l, a, b, c, d, e);
  return static_cast<int>(cudaGetLastError());
}

const char* paddle_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
