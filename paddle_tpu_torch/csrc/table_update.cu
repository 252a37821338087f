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
// What each rule computes, per touched row and column, from the run's
// values v_s in slot order:
//   sgd      p = p + (-lr) * v_s for each slot s, one after another (the
//            TPU kernel's accumulate semantics);
//   adagrad  g = the run's values summed in slot order, then
//            moment' = moment + g * g and p' = p + (-lr) * g /
//            (sqrt(moment') + eps);
//   adam     g as above, m_row = b1 * m + (1 - b1) * g, v_row = b2 * v +
//            (1 - b2) * (g * g), m' = m + (m_row - m), v' = v + (v_row - v),
//            p' = p + (-lr_t) * m_row / (sqrt(v_row) + eps).
// Each column's sum is one chain of additions in slot order on one thread,
// so the result is deterministic (a library index_add on the card sums by
// atomics in no fixed order).
//
// Bitwise contract.  The result equals the plain PyTorch version
// (ops/kernels/table_update.py plain_sparse_apply_*) evaluated eagerly on
// the card: every product, sum, quotient and square root is rounded
// separately with the _rn intrinsics in the plain version's order, so nvcc
// cannot contract a multiply and an add (this file must not be built with
// --use_fast_math).  A sum starts from -0.0, which adds to any value
// exactly, so it equals the plain version's sum that starts from the run's
// first value.  Where the TPU kernel rounds Adagrad's moment + g^2 twice
// (XLA contracts one of them into an FMA), the port's eager rule rounds
// g * g once and adds it once, and this kernel does the same.
//
// What bounds it on an H100.  Bytes, counted once: the values (K * D * 4),
// the sorted ids and their order (K * 12) and each touched row of every
// table read and written once.  At the seq2seq translator's K = 32768 ids
// of D = 256 over a 30000-row table that is ~34 MB, 0.017 ms at 3.35 TB/s
// on its Zipf ids (3.9k touched rows, lazy Adam).  But the ids are
// Zipf(1.3)-skewed: the heaviest id holds ~8.4k of the 32768 slots, and
// its chain of ~8.4k dependent float adds per column (~4 cycles each,
// ~20 us) is a floor of its own.  A design that walks such a run on one
// warp, one value row after another, pays a memory latency per slot
// (~0.75 us: 6.3 ms for the run).  So the loads of a long run are spread
// and run far ahead of its chains; the chains are not reordered:
//   - Short runs (at most kShort = 32 slots) take one launch with a warp
//     per sorted slot (rowwise_short_kernel).  A warp whose slot starts a
//     short run reads the run's next 32 ids and the first 32 entries of
//     `order` in one round, then its rows of the state tables beside the
//     run's value rows (kAhead slots at a time, lane l owning columns
//     l + 32 v), sums and applies.  Other warps exit at once.
//   - Long runs (more than 32 slots) take a second launch over (64-slot
//     group, 32-column slice), a block of kWarps warps each
//     (rowwise_long_kernel).  A group holds at most two starts of long
//     runs (each spans 33 slots or more); for each, the block finds the
//     run's end by a 32-way search over the sorted ids, then walks the
//     run for its slice: kIssueWarps warps copy the slice's value rows by
//     cp.async into a ring of kStages batches of 32 slots, `order` kStages
//     batches further ahead, while warp 0 adds each landed batch, a lane a
//     column, in slot order.  A run's slices are walked by D / 32 blocks,
//     on separate SMs.  The launch's grid depends on K and D only: no run
//     length is read back to the host, and a call can be captured in a
//     CUDA graph.
// What bounds the long runs, measured on an H100 (clock64 counts and
// variants of this file: ops/kernels/table_update_probe.py): not the
// memory latency, which the ring hides (~10 cycles a 32-slot batch at the
// step's barrier; 4 and 16 stages time as 8 do), but the SM's load/store
// pipe, which the chain warp's shared loads and the issuing warps'
// scattered cp.async rows share: ~350 cycles a batch on each side, ~11
// cycles a row.  One issuing warp takes 1.8x as long a call, eight no
// less than four.  The heaviest Zipf run's slice thus takes ~8.4k rows *
// 11 cycles (~50 us).  What would pass this: a first, spread-out gather
// of the long runs' rows into slot order, so that a batch is one
// contiguous bulk copy and the chain reads its column as float4s.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

// short runs
constexpr int kThreads = 256;   // 8 warps a block, a sorted slot each
constexpr int kVec = 8;         // columns per lane per 256-column chunk
constexpr int kAhead = 4;       // value rows loaded ahead of their sums
constexpr int kShort = 32;      // the longest run the short path takes

// long runs
constexpr int kSlice = 32;      // columns a walker sums, one per lane
constexpr int kBatch = 32;      // slots per ring stage
constexpr int kStages = 8;      // ring stages in flight: 256 slots
constexpr int kGroup = 64;      // sorted slots a walker scans for starts
constexpr int kIssueWarps = 4;  // warps that issue a walker's copies
constexpr int kWarps = 1 + kIssueWarps;   // and the warp of its chains
// shared memory: the value ring and the order ring
constexpr int kRingBytes = kStages * kBatch * kSlice * 4;
constexpr int kLongSmem = kRingBytes + 2 * kStages * kBatch * 8;

enum Rule { kSgd = 0, kAdagrad = 1, kAdam = 2 };

// a..e by rule:
//   sgd      (none)
//   adagrad  a = epsilon
//   adam     a = beta1, b = beta2, c = epsilon, d = 1 - beta1, e = 1 - beta2
struct Scalars {
  float nlr, a, b, c, d, e;
};

// the next chain value: sgd adds (-lr) * x, the other rules x
template <int RULE>
__device__ __forceinline__ float add(float acc, float x, float nlr) {
  return __fadd_rn(acc, RULE == kSgd ? __fmul_rn(nlr, x) : x);
}

// Element i of the tables after the rule, from the chain's value `acc`
// (sgd: the new parameter; else g) and the element's old p, s1, s2.
template <int RULE>
__device__ __forceinline__ void finish(float* __restrict__ p,
                                       float* __restrict__ s1,
                                       float* __restrict__ s2, int64_t i,
                                       float acc, float pv, float mv,
                                       float vv, const Scalars& k) {
  if (RULE == kSgd) {
    p[i] = acc;
  } else if (RULE == kAdagrad) {
    const float mom = __fadd_rn(mv, __fmul_rn(acc, acc));
    s1[i] = mom;
    p[i] = __fadd_rn(pv, __fdiv_rn(__fmul_rn(k.nlr, acc),
                                   __fadd_rn(__fsqrt_rn(mom), k.a)));
  } else {
    const float m_row = __fadd_rn(__fmul_rn(k.a, mv), __fmul_rn(k.d, acc));
    const float v_row =
        __fadd_rn(__fmul_rn(k.b, vv), __fmul_rn(k.e, __fmul_rn(acc, acc)));
    s1[i] = __fadd_rn(mv, __fsub_rn(m_row, mv));
    s2[i] = __fadd_rn(vv, __fsub_rn(v_row, vv));
    p[i] = __fadd_rn(pv, __fdiv_rn(__fmul_rn(k.nlr, m_row),
                                   __fadd_rn(__fsqrt_rn(v_row), k.c)));
  }
}

// Element i's old p, s1 (moment or moment1) and s2 (moment2), as the rule
// reads them.
template <int RULE>
__device__ __forceinline__ void load_state(const float* __restrict__ p,
                                           const float* __restrict__ s1,
                                           const float* __restrict__ s2,
                                           int64_t i, float& pv, float& mv,
                                           float& vv) {
  pv = p[i];
  mv = RULE == kSgd ? 0.f : s1[i];
  vv = RULE == kAdam ? s2[i] : 0.f;
}

template <int RULE>
__global__ void __launch_bounds__(kThreads)
rowwise_short_kernel(const int* __restrict__ srows,
                     const int64_t* __restrict__ order,
                     const float* __restrict__ vals, int64_t K, int D,
                     int height, float* __restrict__ p,
                     float* __restrict__ s1, float* __restrict__ s2,
                     const float* __restrict__ lr_ptr, Scalars k) {
  const int64_t w = (blockIdx.x * (int64_t)blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (w >= K) return;
  const int row = srows[w];
  const int prev = w > 0 ? srows[w - 1] : -1;
  if (row < 0 || row >= height || prev == row) return;  // not a run start
  // the run's next 32 ids and its first 32 value rows' places, one round;
  // ids are sorted, so `same` is a prefix of the lanes
  const int64_t q = w + 1 + lane;
  const bool same = q < K && srows[q] == row;
  const int64_t ord = w + lane < K ? order[w + lane] : 0;
  const unsigned m = __ballot_sync(kFull, same);
  if (m == kFull) return;   // more than kShort slots: the long-run kernel's
  const int len = __ffs(~m);
  k.nlr = -(*lr_ptr);
  const int64_t base = (int64_t)row * D;
  for (int c0 = 0; c0 < D; c0 += 32 * kVec) {
    float pv[kVec], mv[kVec], vv[kVec], acc[kVec];
#pragma unroll
    for (int v = 0; v < kVec; ++v) {
      const int col = c0 + lane + 32 * v;
      pv[v] = mv[v] = vv[v] = 0.f;
      if (col < D)
        load_state<RULE>(p, s1, s2, base + col, pv[v], mv[v], vv[v]);
      acc[v] = RULE == kSgd ? pv[v] : -0.0f;
    }
    // slots [0, len) in order, kAhead value rows in flight
    for (int i0 = 0; i0 < len; i0 += kAhead) {
      float buf[kAhead][kVec];
#pragma unroll
      for (int a = 0; a < kAhead; ++a) {
        const int64_t o = __shfl_sync(kFull, ord, (i0 + a) & 31);
        const float* vr = vals + o * (int64_t)D;
#pragma unroll
        for (int v = 0; v < kVec; ++v) {
          const int col = c0 + lane + 32 * v;
          buf[a][v] = i0 + a < len && col < D ? vr[col] : 0.f;
        }
      }
#pragma unroll
      for (int a = 0; a < kAhead; ++a)
        if (i0 + a < len)
#pragma unroll
          for (int v = 0; v < kVec; ++v)
            acc[v] = add<RULE>(acc[v], buf[a][v], k.nlr);
    }
#pragma unroll
    for (int v = 0; v < kVec; ++v) {
      const int col = c0 + lane + 32 * v;
      if (col < D)
        finish<RULE>(p, s1, s2, base + col, acc[v], pv[v], mv[v], vv[v], k);
    }
  }
}

// cp.async of BYTES (4, 8 or 16) from global to shared memory
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s),
                 "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(s),
                 "l"(src), "n"(BYTES));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// The end of the run of `row` whose slot lo - 1 holds it: the first slot in
// [lo, K] that is K or holds another id.  32 sorted ids probed a round, so
// a run of n slots takes about log_33(n) + 1 rounds.
__device__ int64_t run_end(const int* __restrict__ srows, int64_t K, int row,
                           int64_t lo) {
  const int lane = threadIdx.x & 31;
  int64_t hi = K;   // the end lies in [lo, hi]
  while (hi - lo > 32) {
    // probes lo + n (l + 1) / 33 rise strictly and stay below hi
    const int64_t n = hi - lo;
    const unsigned m =
        __ballot_sync(kFull, srows[lo + n * (lane + 1) / 33] == row);
    const int c = __popc(m);   // a prefix of the probes holds the row
    const int64_t old = lo;
    if (c > 0) lo = old + n * c / 33 + 1;
    if (c < 32) hi = old + n * (c + 1) / 33;
  }
  const int64_t at = lo + lane;
  return lo + __popc(__ballot_sync(kFull, at < hi && srows[at] == row));
}

// A block sums the run [s, e) of `row` for columns [c0, c0 + 32) and
// applies the rule.  Warp 0 keeps the chains: lane l owns column c0 + l
// and adds each row of the run in slot order.  Warps 1..kIssueWarps issue
// the copies: batch b of 32 slots lands in ring stage b % kStages (rows of
// 32 floats) from a copy issued at step b - kStages + 1, its `order`
// entries kStages steps before that.  Every thread commits one cp.async
// group a step (of the loop's step g, or of a prologue step g < 0) and, at
// step j, waits for all but its kStages - 2 newest groups, so after the
// step's barrier batch j's rows and batch j + kStages - 1's order entries
// are in place; warp 0 then sums stage j % kStages while the other warps
// fill stage (j - 1) % kStages, which warp 0 finished before the barrier.
// VEC floats a copy: 4 (16 bytes; D % 4 == 0 and vals 16-byte aligned) or
// 1.
template <int RULE, int VEC>
__device__ void walk(const int64_t* __restrict__ order,
                     const float* __restrict__ vals, int64_t s, int64_t e,
                     int D, int c0, int row, float* __restrict__ p,
                     float* __restrict__ s1, float* __restrict__ s2,
                     const Scalars& k, float* ring, int64_t* oring) {
  constexpr int kLanesPerRow = kSlice / VEC;
  constexpr int kRowsPerCopy = 32 / kLanesPerRow;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t n = e - s;
  const int64_t nb = (n + kBatch - 1) / kBatch;
  const int col = c0 + lane;
  const int64_t i = (int64_t)row * D + col;
  float pv = 0.f, mv = 0.f, vv = 0.f;
  if (warp == 0 && col < D) load_state<RULE>(p, s1, s2, i, pv, mv, vv);
  float acc = RULE == kSgd ? pv : -0.0f;

  auto issue_order = [&](int64_t b) {
    const int64_t q = s + b * kBatch + lane;
    if (warp == 1 && b < nb && q < e)
      cp_async<8>(oring + (b % (2 * kStages)) * kBatch + lane, order + q);
  };
  const int cc = (lane % kLanesPerRow) * VEC;
  auto issue_rows = [&](int64_t b) {
    if (warp == 0 || b >= nb || c0 + cc >= D) return;
    const int64_t* ob = oring + (b % (2 * kStages)) * kBatch;
    float* dst = ring + (b % kStages) * (kBatch * kSlice);
#pragma unroll
    for (int r0 = (warp - 1) * kRowsPerCopy; r0 < kBatch;
         r0 += kIssueWarps * kRowsPerCopy) {
      const int r = r0 + lane / kLanesPerRow;
      if (s + b * kBatch + r < e)
        cp_async<4 * VEC>(dst + r * kSlice + cc, vals + ob[r] * D + c0 + cc);
    }
  };

  for (int b = 0; b < kStages; ++b) issue_order(b);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  for (int b = 0; b < kStages - 1; ++b) {
    issue_rows(b);
    issue_order(b + kStages);
    cp_async_commit();
  }
  for (int64_t j = 0; j < nb; ++j) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (warp == 0) {
      const float* src = ring + (j % kStages) * (kBatch * kSlice) + lane;
      const int64_t left = n - j * kBatch;
      if (left >= kBatch) {
#pragma unroll
        for (int r = 0; r < kBatch; ++r)
          acc = add<RULE>(acc, src[r * kSlice], k.nlr);
      } else {
        for (int r = 0; r < left; ++r)
          acc = add<RULE>(acc, src[r * kSlice], k.nlr);
      }
    }
    issue_rows(j + kStages - 1);
    issue_order(j + 2 * kStages - 1);
    cp_async_commit();
  }
  cp_async_wait<0>();
  __syncthreads();   // nothing in flight before the ring is used again
  if (warp == 0 && col < D)
    finish<RULE>(p, s1, s2, i, acc, pv, mv, vv, k);
}

template <int RULE, int VEC>
__global__ void __launch_bounds__(32 * kWarps)
rowwise_long_kernel(const int* __restrict__ srows,
                    const int64_t* __restrict__ order,
                    const float* __restrict__ vals, int64_t K, int D,
                    int height, float* __restrict__ p,
                    float* __restrict__ s1, float* __restrict__ s2,
                    const float* __restrict__ lr_ptr, Scalars k) {
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);
  int64_t* oring =
      reinterpret_cast<int64_t*>(reinterpret_cast<char*>(smem4) + kRingBytes);
  const int lane = threadIdx.x & 31;
  const int64_t g0 = (int64_t)blockIdx.x * kGroup;
  // a slot starts a long run if the previous one holds another id and the
  // slot kShort after it the same (ids are sorted); every load at once
  int row[kGroup / 32];
  bool start[kGroup / 32];
#pragma unroll
  for (int h = 0; h < kGroup / 32; ++h) {
    const int64_t q = g0 + 32 * h + lane;
    row[h] = -1;
    int prev = -1, last = -1;
    if (q + kShort < K) {
      row[h] = srows[q];
      prev = q > 0 ? srows[q - 1] : -1;
      last = srows[q + kShort];
    }
    start[h] = row[h] >= 0 && row[h] < height && prev != row[h] &&
               last == row[h];
  }
  k.nlr = -(*lr_ptr);
#pragma unroll
  for (int h = 0; h < kGroup / 32; ++h) {
    unsigned m = __ballot_sync(kFull, start[h]);
    while (m) {
      const int src = __ffs(m) - 1;
      m &= m - 1;
      const int64_t s = g0 + 32 * h + src;
      const int r = __shfl_sync(kFull, row[h], src);
      const int64_t e = run_end(srows, K, r, s + kShort + 1);
      walk<RULE, VEC>(order, vals, s, e, D, blockIdx.y * kSlice, r, p, s1,
                      s2, k, ring, oring);
    }
  }
}

template <int RULE, int VEC>
cudaError_t launch_long(const dim3& grid, const int* r, const int64_t* o,
                        const float* v, int64_t K, int D, int height,
                        float* p, float* s1, float* s2, const float* lr,
                        const Scalars& k, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      rowwise_long_kernel<RULE, VEC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kLongSmem);
  if (err != cudaSuccess) return err;
  rowwise_long_kernel<RULE, VEC><<<grid, 32 * kWarps, kLongSmem, st>>>(
      r, o, v, K, D, height, p, s1, s2, lr, k);
  return cudaGetLastError();
}

template <int RULE>
cudaError_t launch(const int* r, const int64_t* o, const float* v, int64_t K,
                   int D, int height, float* p, float* s1, float* s2,
                   const float* lr, const Scalars& k, cudaStream_t st) {
  const int64_t warps_per_block = kThreads / 32;
  rowwise_short_kernel<RULE><<<
      static_cast<unsigned>((K + warps_per_block - 1) / warps_per_block),
      kThreads, 0, st>>>(r, o, v, K, D, height, p, s1, s2, lr, k);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || K <= kShort) return err;
  const dim3 grid(static_cast<unsigned>((K + kGroup - 1) / kGroup),
                  static_cast<unsigned>((D + kSlice - 1) / kSlice));
  if (D % 4 == 0 && (reinterpret_cast<uintptr_t>(v) & 15) == 0)
    return launch_long<RULE, 4>(grid, r, o, v, K, D, height, p, s1, s2, lr,
                                k, st);
  return launch_long<RULE, 1>(grid, r, o, v, K, D, height, p, s1, s2, lr, k,
                              st);
}

}  // namespace

extern "C" {

// rule 0 sgd (p), 1 adagrad (p, s1 = moment), 2 adam (p, s1 = moment1,
// s2 = moment2): tables contiguous float32 [height, D]; srows int32 [K]
// (normalised and sorted), order int64 [K], vals float32 [K, D], lr a
// float32 scalar (Adam's bias-corrected rate): all on the device.  Updates
// the touched rows in place on `stream`; returns the CUDA error of the
// launches (0 on success, and at once for K = 0); does not synchronise.
int paddle_table_update(int rule, const void* srows, const void* order,
                        const void* vals, int64_t K, int D, int height,
                        void* p, void* s1, void* s2, const void* lr, float a,
                        float b, float c, float d, float e, void* stream) {
  if (K < 0 || D < 1 || height < 1 || rule < kSgd || rule > kAdam ||
      (D + kSlice - 1) / kSlice > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (K == 0) return 0;
  if ((rule >= kAdagrad && s1 == nullptr) || (rule == kAdam && s2 == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* r = static_cast<const int*>(srows);
  const int64_t* o = static_cast<const int64_t*>(order);
  const float* v = static_cast<const float*>(vals);
  float* pp = static_cast<float*>(p);
  float* p1 = static_cast<float*>(s1);
  float* p2 = static_cast<float*>(s2);
  const float* l = static_cast<const float*>(lr);
  const Scalars k{0.f, a, b, c, d, e};
  cudaError_t err;
  if (rule == kSgd)
    err = launch<kSgd>(r, o, v, K, D, height, pp, p1, p2, l, k, st);
  else if (rule == kAdagrad)
    err = launch<kAdagrad>(r, o, v, K, D, height, pp, p1, p2, l, k, st);
  else
    err = launch<kAdam>(r, o, v, K, D, height, pp, p1, p2, l, k, st);
  return static_cast<int>(err);
}

const char* paddle_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
