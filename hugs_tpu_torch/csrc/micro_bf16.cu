// S1: the 16-bit elementwise rate probe, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel` of scripts/micro_bf16.py (launched by
// `make_fn` there): r chained passes over one (1024, 128) block, in
// float32 or bfloat16, of
//   madd  v = v * c + e
//   exp   v = exp(-|v|) + e
// with c read from a float32 scalar on the device and cast to the block's
// type inside the kernel (the SMEM scalar's role: nothing folds), and e =
// 1e-3 in the block's type. One pass of one element counts as one
// operation, as the script counts it.
//
// Design: float32, one thread per element; `madd` is one fused
// multiply-add (__fmaf_rn, one rounding), because that is what jnp's
// `v * cv + ev` is on XLA's CPU backend, the reference the tests hold the
// port to: XLA contracts it (from 0.5, r = 8 and K = 20 give 0.6507964
// fused against 0.6507944 rounded twice). bfloat16, two elements per
// thread as one __nv_bfloat162: `madd` is __hmul2 then __hadd2, two bf16
// roundings as jnp in bf16; `exp` is float32 expf of each half rounded to bf16, then
// __hadd2. That is how XLA's CPU backend and PyTorch compute a bf16 exp
// (widen, float32 exp, round), so the kernel, its plain version and the
// JAX reference agree to within one bf16 ulp by construction. h2exp is no
// packed alternative: on sm_80 and later it too widens each half and runs
// ex2.approx.f32 on it (cuda_bf16.hpp), so it would only swap expf for
// the approximate exponent. Every pass stays in registers.
//
// bfloat16 `madd` keeps one pair a thread in blocks of 256: on the H100
// no trial of 1, 2 or 4 pairs a thread, blocks of 128 or 256, or each
// pass as two HFMA2 ran faster (PERF.md). sm_90a compiles __hmul2 and
// __hadd2 on bf16 as one HMUL2.BF16_V2 and one HADD2.BF16_V2.
//
// Bound on the H100: operations (the block is 512 KB in and out, once).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace hugs_micro {

constexpr int kThreads = 256;
enum Op : int { kMadd = 0, kExp = 1 };

template <int kOp>
__global__ void __launch_bounds__(kThreads)
passes_f32(const float* __restrict__ x, float* __restrict__ out,
           const float* __restrict__ c, float e, int n, int r) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const float cv = c[0];
  float v = x[i];
  for (int k = 0; k < r; ++k) {
    if constexpr (kOp == kMadd) {
      v = __fmaf_rn(v, cv, e);
    } else {
      v = expf(-fabsf(v)) + e;
    }
  }
  out[i] = v;
}

template <int kOp>
__global__ void __launch_bounds__(kThreads)
passes_bf16(const __nv_bfloat162* __restrict__ x,
            __nv_bfloat162* __restrict__ out, const float* __restrict__ c,
            float e, int n2, int r) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n2) return;
  const __nv_bfloat162 cv = __float2bfloat162_rn(c[0]);
  const __nv_bfloat162 ev = __float2bfloat162_rn(e);
  __nv_bfloat162 v = x[i];
  for (int k = 0; k < r; ++k) {
    if constexpr (kOp == kMadd) {
      v = __hadd2(__hmul2(v, cv), ev);
    } else {
      const float2 f = __bfloat1622float2(v);
      v = __hadd2(__floats2bfloat162_rn(expf(-fabsf(f.x)), expf(-fabsf(f.y))),
                  ev);
    }
  }
  out[i] = v;
}

}  // namespace hugs_micro

// One call, r passes, on `stream`: op 0 madd, 1 exp; bf16 0 for float32,
// 1 for bfloat16 (n even); x and out n elements of that type; c one
// float32 on the device; e the offset. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for another op or an odd bf16 count.
extern "C" int hugs_micro_bf16(int op, int bf16, const void* x, void* out,
                               const float* c, float e, int n, int r,
                               void* stream) {
  using namespace hugs_micro;
  const auto s = static_cast<cudaStream_t>(stream);
  if ((op != kMadd && op != kExp) || (bf16 && n % 2 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n <= 0) return 0;
  if (bf16) {
    const int n2 = n / 2;
    const int blocks = (n2 + kThreads - 1) / kThreads;
    const auto* xb = static_cast<const __nv_bfloat162*>(x);
    auto* ob = static_cast<__nv_bfloat162*>(out);
    if (op == kMadd) {
      passes_bf16<kMadd><<<blocks, kThreads, 0, s>>>(xb, ob, c, e, n2, r);
    } else {
      passes_bf16<kExp><<<blocks, kThreads, 0, s>>>(xb, ob, c, e, n2, r);
    }
  } else {
    const int blocks = (n + kThreads - 1) / kThreads;
    const auto* xf = static_cast<const float*>(x);
    auto* of = static_cast<float*>(out);
    if (op == kMadd) {
      passes_f32<kMadd><<<blocks, kThreads, 0, s>>>(xf, of, c, e, n, r);
    } else {
      passes_f32<kExp><<<blocks, kThreads, 0, s>>>(xf, of, c, e, n, r);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
