// Dense optimizer applies for Hopper (sm_90a), behind a plain C interface.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/dense_update.py
// `_flat_kernel` (launched by `_flat_call`) with its three rules:
// sgd (+ optional fused L2 weight decay), momentum (plain and Nesterov)
// and adam.  One elementwise pass over the flattened float32 parameter
// reads param, grad and each moment once and writes param and moments in
// place.
//
// What bounds it on an H100: bytes.  Adam moves 28 bytes per element
// (read p, m, v, g; write p, m, v) for about ten flops, far below the
// card's ratio of flops to bytes; at the transformer's 49.9 M parameters
// that is 1.40 GB a step, 0.42 ms at 3.35 TB/s.  The design does nothing
// cleverer than keep every access coalesced in a grid-stride loop; a
// multi-tensor launch over all parameters at once is later work.
//
// The grid: ceil(n / 256) blocks, capped at `max_blocks`, which the
// caller passes (the card's SM count times the autotuner's
// dense_apply_blocks_per_sm, 16 by default: 2112 blocks on a 132-SM
// H100).  A smaller cap walks longer strides per block; the rule is per
// element, so every grid gives the same bits.
//
// Bitwise contract.  The result equals the plain PyTorch version
// (ops/kernels/dense_update.py plain_*) evaluated eagerly on the card:
// every product, sum, quotient and square root is rounded separately with
// the _rn intrinsics, in the plain version's term order, so nvcc cannot
// contract a multiply and an add into one FMA (this file must not be
// built with --use_fast_math).  The scalars arrive rounded to float32 as
// torch rounds a Python scalar; lr (or Adam's bias-corrected lr_t) is read
// from device memory, so the caller never syncs to fetch it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

enum Rule { kSgd = 0, kMomentum = 1, kAdam = 2 };

// a, b, c, d, e by rule:
//   sgd       a = weight decay (flag: apply it)
//   momentum  a = mu           (flag: Nesterov)
//   adam      a = beta1, b = beta2, c = epsilon, d = 1 - beta1,
//             e = 1 - beta2
template <int RULE>
__global__ void __launch_bounds__(kThreads)
dense_update_kernel(float* __restrict__ p, float* __restrict__ s1,
                    float* __restrict__ s2, const float* __restrict__ g,
                    const float* __restrict__ lr_ptr, int64_t n, float a,
                    float b, float c, float d, float e, int flag) {
  const float lr = *lr_ptr;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const float gi = g[i];
    const float pi = p[i];
    if (RULE == kSgd) {
      // p - lr * g   or   p - lr * (g + wd * p)
      const float step = flag ? __fadd_rn(gi, __fmul_rn(a, pi)) : gi;
      p[i] = __fsub_rn(pi, __fmul_rn(lr, step));
    } else if (RULE == kMomentum) {
      // v' = mu * v + g;  p - (g + mu * v') * lr   or   p - lr * v'
      const float v_new = __fadd_rn(__fmul_rn(a, s1[i]), gi);
      s1[i] = v_new;
      p[i] = flag ? __fsub_rn(pi, __fmul_rn(__fadd_rn(gi, __fmul_rn(a, v_new)),
                                            lr))
                  : __fsub_rn(pi, __fmul_rn(lr, v_new));
    } else {
      // m' = b1 * m + (1 - b1) * g;  v' = b2 * v + (1 - b2) * (g * g);
      // p - lr_t * m' / (sqrt(v') + eps)
      const float m_new = __fadd_rn(__fmul_rn(a, s1[i]), __fmul_rn(d, gi));
      const float v_new =
          __fadd_rn(__fmul_rn(b, s2[i]), __fmul_rn(e, __fmul_rn(gi, gi)));
      s1[i] = m_new;
      s2[i] = v_new;
      p[i] = __fsub_rn(pi, __fdiv_rn(__fmul_rn(lr, m_new),
                                     __fadd_rn(__fsqrt_rn(v_new), c)));
    }
  }
}

}  // namespace

extern "C" {

// rule 0 sgd (p), 1 momentum (p, s1 = velocity), 2 adam (p, s1 = moment1,
// s2 = moment2); every array is contiguous float32 [n] on the device, lr
// a float32 scalar on the device; at most `max_blocks` (>= 1) blocks of
// 256 threads walk the arrays.  Updates in place on `stream`; returns the
// CUDA error of the launch (0 on success, and at once for n = 0); does
// not synchronise.
int paddle_dense_update(int rule, void* p, void* s1, void* s2, const void* g,
                        const void* lr, int64_t n, float a, float b, float c,
                        float d, float e, int flag, int max_blocks,
                        void* stream) {
  if (n < 0 || rule < kSgd || rule > kAdam || max_blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  if ((rule >= kMomentum && s1 == nullptr) || (rule == kAdam && s2 == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t want = (n + kThreads - 1) / kThreads;
  const unsigned blocks =
      static_cast<unsigned>(want < max_blocks ? want : max_blocks);
  float* pp = static_cast<float*>(p);
  float* p1 = static_cast<float*>(s1);
  float* p2 = static_cast<float*>(s2);
  const float* gg = static_cast<const float*>(g);
  const float* ll = static_cast<const float*>(lr);
  if (rule == kSgd)
    dense_update_kernel<kSgd><<<blocks, kThreads, 0, st>>>(
        pp, p1, p2, gg, ll, n, a, b, c, d, e, flag);
  else if (rule == kMomentum)
    dense_update_kernel<kMomentum><<<blocks, kThreads, 0, st>>>(
        pp, p1, p2, gg, ll, n, a, b, c, d, e, flag);
  else
    dense_update_kernel<kAdam><<<blocks, kThreads, 0, st>>>(
        pp, p1, p2, gg, ll, n, a, b, c, d, e, flag);
  return static_cast<int>(cudaGetLastError());
}

const char* paddle_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
