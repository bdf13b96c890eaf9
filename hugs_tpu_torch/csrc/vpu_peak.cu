// S2: the elementwise rate probe, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel` of scripts/vpu_peak.py (launched by
// `build` there): the rate the card sustains on three instruction mixes
// over one (1024, 128) float32 block, with next to no memory traffic.
// Per element, o = 0, then for each of `grid` steps
//   v = x + o * carry;  o = o + f(v)
// and the call writes o * out_scale (the script's `call(v) * 1e-6`, so
// chained calls feed each other as its fori_loop does). f is
//   fma       four independent chains a = a * k + b, kInner steps each;
//   serial    one dependent chain of 4 kInner such steps;
//   blendmix  the forward blend's per-pair arithmetic, kInner pairs: the
//             conic quadratic, expf, the alpha clamp and tests, log1pf,
//             expf(log T), the colour and log T sums (vpu_peak.py:81-98).
// The TPU's grid is a serial carry into one output block, so here it is
// a loop inside each thread, not parallelism.
//
// Design: one thread per element, 512 blocks of 256 (about 31 warps per
// SM), every step in registers. The chains' multipliers and offsets are
// read from device memory at the start, so nvcc can fold nothing, and
// every a * k + b of `fma` and `serial` is __fmaf_rn, one FFMA: the build
// has -fmad=false (as K1 and K2 have), under which a plain a * k + b
// would be an FMUL and an FADD. `blendmix` is plain C++ under that same
// flag, with K1's expf and log1pf, so its rate is that of K1's mix as K1
// is built. The grid loop is not unrolled, so the kernel's SASS holds
// 4 kInner FFMA for `fma` (the count the chip run checks).
//
// Bound on the H100: operations, by construction; the bytes are one
// block in and one out. What it measures is the rate itself.

#include <cuda_runtime.h>

namespace hugs_micro {

constexpr int kThreads = 256;
enum Mode : int { kFma = 0, kSerial = 1, kBlendmix = 2 };
// c: a0..a3's multipliers (0-3) and offsets (4-7); a1's and a2's start
// multipliers (8, 9) and a3's start offset (10); the serial chain's
// multiplier (11) and offset (12)
constexpr int kConsts = 13;

template <int M, int kInner>
__global__ void __launch_bounds__(kThreads)
vpu_peak_kernel(const float* __restrict__ x, float* __restrict__ out,
                const float* __restrict__ c, int n, int grid, float carry,
                float out_scale) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const float xi = x[i];
  float o = 0.0f;
#pragma unroll 1
  for (int g = 0; g < grid; ++g) {
    const float v = xi + o * carry;
    if constexpr (M == kFma) {
      const float k0 = c[0], k1 = c[1], k2 = c[2], k3 = c[3];
      const float b0 = c[4], b1 = c[5], b2 = c[6], b3 = c[7];
      float a0 = v;
      float a1 = v * c[8];
      float a2 = v * c[9];
      float a3 = v + c[10];
#pragma unroll
      for (int k = 0; k < kInner; ++k) {
        a0 = __fmaf_rn(a0, k0, b0);
        a1 = __fmaf_rn(a1, k1, b1);
        a2 = __fmaf_rn(a2, k2, b2);
        a3 = __fmaf_rn(a3, k3, b3);
      }
      o = o + (((a0 + a1) + a2) + a3);
    } else if constexpr (M == kSerial) {
      const float k0 = c[11], b0 = c[12];
      float a = v;
#pragma unroll
      for (int k = 0; k < 4 * kInner; ++k) a = __fmaf_rn(a, k0, b0);
      o = o + a;
    } else {
      float acc = v * 0.0f;
      float logt = v * 0.0f;
#pragma unroll
      for (int k = 0; k < kInner; ++k) {
        const float dx = v + static_cast<float>(k);
        const float dy = v - static_cast<float>(k);
        const float power =
            -0.5f * (1e-2f * dx * dx + 1e-2f * dy * dy) - 1e-3f * (dx * dy);
        float alpha = fminf(0.99f, 0.7f * expf(fminf(power, 0.0f)));
        const bool keep =
            power <= 0.0f && alpha >= static_cast<float>(1.0 / 255.0);
        alpha = keep ? alpha : 0.0f;
        const float la = log1pf(-alpha);
        const float w = expf(logt) * alpha;
        acc = acc + w;
        logt = logt + la;
      }
      o = o + (acc + logt);
    }
  }
  out[i] = o * out_scale;
}

template <int M, int kInner>
cudaError_t launch(const float* x, float* out, const float* c, int n,
                   int grid, float carry, float out_scale,
                   cudaStream_t stream) {
  vpu_peak_kernel<M, kInner><<<(n + kThreads - 1) / kThreads, kThreads, 0,
                               stream>>>(x, out, c, n, grid, carry,
                                         out_scale);
  return cudaGetLastError();
}

}  // namespace hugs_micro

// One call of the probe on `stream`: mode 0 fma, 1 serial, 2 blendmix;
// inner 64 (the script's full size, kInner); x and out (n,)
// float32; c the kConsts constants on the device. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for another mode or inner.
extern "C" int hugs_vpu_peak(int mode, int inner, const float* x, float* out,
                             const float* c, int n, int grid, float carry,
                             float out_scale, void* stream) {
  using namespace hugs_micro;
  const auto s = static_cast<cudaStream_t>(stream);
  if (n <= 0) return 0;
  cudaError_t err = cudaErrorInvalidValue;
  if (inner == 64) {
    if (mode == kFma) err = launch<kFma, 64>(x, out, c, n, grid, carry, out_scale, s);
    if (mode == kSerial) err = launch<kSerial, 64>(x, out, c, n, grid, carry, out_scale, s);
    if (mode == kBlendmix) err = launch<kBlendmix, 64>(x, out, c, n, grid, carry, out_scale, s);
  }
  return static_cast<int>(err);
}
