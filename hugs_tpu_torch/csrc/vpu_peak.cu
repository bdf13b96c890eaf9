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
// Design: `fma` and `blendmix` run one thread per element, 512 blocks of
// 256 (about 31 warps per SM), every step in registers. The chains'
// multipliers and offsets are read from device memory at the start, so
// nvcc can fold nothing, and every a * k + b of `fma` and `serial` is
// __fmaf_rn, one FFMA: the build has -fmad=false (as K1 and K2 have),
// under which a plain a * k + b would be an FMUL and an FADD. `blendmix`
// is plain C++ under that same flag, with K1's expf and log1pf, so its
// rate is that of K1's mix as K1 is built. The grid loop is not unrolled,
// so the kernel's SASS holds 4 kInner FFMA for `fma` (the count the chip
// run checks).
//
// `serial` (vpu_serial_kernel) carries kSerialChains elements a thread,
// element i0 + j * (threads launched) for chain j, their steps
// interleaved: each of the 4 kInner steps issues kSerialChains
// independent FFMA in a row that all read the same k0 and b0, which
// ptxas marks .reuse. Each element still goes through the same
// operations in the same order, so the output is the one-chain
// kernel's bit for bit. The design is 4 elements a thread in blocks of
// kSerialThreads = 128 (1,024 warps, at most two a scheduler): on the
// H100 it ran fastest of 1, 2, 4 and 8 elements a thread in blocks of
// 128 or 256 (PERF.md). hugs_vpu_serial_chain launches
// vpu_serial_kernel<64, 1, 256>, one element a thread, to read the
// chain's latency (the floor no design of the mode goes below).
//
// Bound on the H100: operations, by construction; the bytes are one
// block in and one out. What it measures is the rate itself.

#include <cuda_runtime.h>

namespace hugs_micro {

constexpr int kThreads = 256;
constexpr int kSerialChains = 4;
constexpr int kSerialThreads = 128;
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
  static_assert(M == kFma || M == kBlendmix,
                "vpu_peak_kernel runs fma and blendmix; serial has its own");
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
    } else if constexpr (M == kBlendmix) {
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

// `serial`: kChains elements a thread, chain j on element i0 + j * stride
// (stride the threads launched), each step of the chains interleaved.
template <int kInner, int kChains, int kBlock>
__global__ void __launch_bounds__(kBlock)
vpu_serial_kernel(const float* __restrict__ x, float* __restrict__ out,
                  const float* __restrict__ c, int n, int grid, float carry,
                  float out_scale) {
  const int stride = gridDim.x * kBlock;
  const int i0 = blockIdx.x * kBlock + threadIdx.x;
  float xi[kChains], o[kChains];
#pragma unroll
  for (int j = 0; j < kChains; ++j) {
    const int i = i0 + j * stride;
    xi[j] = i < n ? x[i] : 0.0f;
    o[j] = 0.0f;
  }
  const float k0 = c[11], b0 = c[12];
#pragma unroll 1
  for (int g = 0; g < grid; ++g) {
    float a[kChains];
#pragma unroll
    for (int j = 0; j < kChains; ++j) a[j] = xi[j] + o[j] * carry;
#pragma unroll
    for (int k = 0; k < 4 * kInner; ++k) {
#pragma unroll
      for (int j = 0; j < kChains; ++j) a[j] = __fmaf_rn(a[j], k0, b0);
    }
#pragma unroll
    for (int j = 0; j < kChains; ++j) o[j] = o[j] + a[j];
  }
#pragma unroll
  for (int j = 0; j < kChains; ++j) {
    const int i = i0 + j * stride;
    if (i < n) out[i] = o[j] * out_scale;
  }
}

template <int kInner, int kChains, int kBlock>
cudaError_t launch_serial(const float* x, float* out, const float* c, int n,
                          int grid, float carry, float out_scale,
                          cudaStream_t stream) {
  const int threads = (n + kChains - 1) / kChains;
  vpu_serial_kernel<kInner, kChains, kBlock>
      <<<(threads + kBlock - 1) / kBlock, kBlock, 0, stream>>>(
          x, out, c, n, grid, carry, out_scale);
  return cudaGetLastError();
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
    if (mode == kSerial) {
      err = launch_serial<64, kSerialChains, kSerialThreads>(
          x, out, c, n, grid, carry, out_scale, s);
    }
    if (mode == kBlendmix) err = launch<kBlendmix, 64>(x, out, c, n, grid, carry, out_scale, s);
  }
  return static_cast<int>(err);
}

// `serial` at one element a thread in blocks of 256, the chain probe:
// the same output as hugs_vpu_peak's serial; arguments as there, less
// the mode.
extern "C" int hugs_vpu_serial_chain(int inner, const float* x, float* out,
                                     const float* c, int n, int grid,
                                     float carry, float out_scale,
                                     void* stream) {
  using namespace hugs_micro;
  if (n <= 0) return 0;
  if (inner != 64) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_serial<64, 1, 256>(
      x, out, c, n, grid, carry, out_scale,
      static_cast<cudaStream_t>(stream)));
}
