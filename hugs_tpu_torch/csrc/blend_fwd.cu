// K1: forward tile blend of the splat renderer, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_fwd_kernel` of hugs_tpu/render/pallas_blend.py
// (launched by `_blend_fwd_call`). It computes what that kernel computes,
// with the semantics of hugs_tpu_torch/render/oracle.py: for each pixel,
// front to back over its tile's depth-sorted instances,
//   alpha  = min(0.99, op * exp(power)), zeroed where power > 0,
//            alpha < 1/255 or dist^2 > radius^2;
//   colour += rgb * alpha * T while log T >= log(1e-4);
//   log T  += log1p(-alpha);
// then colour + bg * T_fin * [log T_fin >= log(1e-4)], clipped to [0, 1].
// Transmittance is kept in log space, as in the TPU kernel, so the T_EPS
// threshold tests the same quantity the reference tests.
//
// Design: one block of 256 threads per 16x16 tile, one thread per pixel.
// The block stages its tile's instances through shared memory in batches
// of 256 (each thread gathers one instance's 10 floats by gauss_id), then
// every thread walks the batch sequentially for its pixel. A pixel stops
// once its transmittance falls below T_EPS; the block stops when all 256
// of its pixels have (__syncthreads_count). The TPU kernel's 8-tiles-per-
// cell grid, double-buffered DMA, bf16 hi/lo split matmuls and
// pre-saturated out-of-image pixels are TPU mechanics and have no
// counterpart here.
//
// Bound on the H100: operations. Each (pixel, instance) pair costs about
// 22 float operations and one expf before the alpha test, while the bytes
// are the (N, 10) table, the instance list and the image, a few MB. The
// simple design stands because it is exact and needs no tuning: what it
// leaves on the table (warp-level culling of instances that miss a whole
// warp, cp.async prefetch of the next batch, fast-math exp) is work for a
// later change, measured against this one.
//
// Built with -fmad=false so that every product and sum rounds as the
// plain PyTorch version's separate elementwise kernels round: the alpha
// of a pair is then bit-identical between the two, and only the order of
// the transmittance and colour sums differs.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;
constexpr int kThreads = kTile * kTile;
constexpr int kFeat = 10;  // r g b op mx my ca cb cc rad
constexpr float kMinAlpha = 1.0f / 255.0f;
constexpr float kMaxAlpha = 0.99f;
constexpr float kLogTEps = -9.21034049987793f;  // float32(log(1e-4))

__global__ void __launch_bounds__(kThreads)
blend_fwd_kernel(const float* __restrict__ feat,
                 const int* __restrict__ gauss_id,
                 const int* __restrict__ starts,
                 const int* __restrict__ ends,
                 const float* __restrict__ bg,
                 int width, int height, int nx,
                 float* __restrict__ out_rgb,
                 float* __restrict__ out_log_t,
                 int* __restrict__ out_walked) {
  __shared__ float s_feat[kFeat][kThreads];

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int px_i = (t % nx) * kTile + tid % kTile;
  const int py_i = (t / nx) * kTile + tid / kTile;
  const bool inside = px_i < width && py_i < height;
  const float px = static_cast<float>(px_i);
  const float py = static_cast<float>(py_i);
  const int start = starts[t];
  const int end = ends[t];

  float log_t = 0.0f;
  float cr = 0.0f, cg = 0.0f, cb = 0.0f;
  bool done = !inside;  // pixels outside the image never hold the block
  int walked = 0;

  for (int base = start; base < end; base += kThreads) {
    // also the barrier that keeps the previous batch's readers ahead of
    // this batch's writers
    if (__syncthreads_count(done) == kThreads) break;
    const int n = min(kThreads, end - base);
    if (tid < n) {
      const float* f = feat + static_cast<size_t>(gauss_id[base + tid]) * kFeat;
#pragma unroll
      for (int k = 0; k < kFeat; ++k) s_feat[k][tid] = f[k];
    }
    __syncthreads();
    walked = base + n - start;

    for (int j = 0; j < n && !done; ++j) {
      const float dx = s_feat[4][j] - px;
      const float dy = s_feat[5][j] - py;
      // the operation order of oracle.gaussian_alpha, product by product
      const float power =
          -0.5f * (s_feat[6][j] * dx * dx + s_feat[8][j] * dy * dy) -
          s_feat[7][j] * dx * dy;
      const float alpha =
          fminf(kMaxAlpha, s_feat[3][j] * expf(fminf(power, 0.0f)));
      const float rad = s_feat[9][j];
      if (!(power <= 0.0f && alpha >= kMinAlpha &&
            dx * dx + dy * dy <= rad * rad)) {
        continue;
      }
      const float w = alpha * expf(log_t);
      cr += s_feat[0][j] * w;
      cg += s_feat[1][j] * w;
      cb += s_feat[2][j] * w;
      log_t += log1pf(-alpha);
      done = log_t < kLogTEps;
    }
  }

  if (tid == 0) out_walked[t] = walked;
  if (!inside) return;
  const float t_fin = log_t >= kLogTEps ? expf(log_t) : 0.0f;
  const size_t p = static_cast<size_t>(py_i) * width + px_i;
  const size_t plane = static_cast<size_t>(width) * height;
  out_rgb[p] = fminf(fmaxf(cr + bg[0] * t_fin, 0.0f), 1.0f);
  out_rgb[plane + p] = fminf(fmaxf(cg + bg[1] * t_fin, 0.0f), 1.0f);
  out_rgb[2 * plane + p] = fminf(fmaxf(cb + bg[2] * t_fin, 0.0f), 1.0f);
  out_log_t[p] = log_t;
}

}  // namespace

// Launches K1 on `stream` over n_tiles = nx * ny tiles of 16x16 pixels.
// feat: (N, 10) float32; gauss_id: instance list; starts/ends: (n_tiles,)
// per-tile segments of gauss_id; bg: (3,). Writes out_rgb (3, H, W),
// out_log_t (H, W) and out_walked (n_tiles,), the instances each tile
// walked before all its pixels saturated. Returns cudaGetLastError().
extern "C" int hugs_blend_fwd(const float* feat, const int* gauss_id,
                              const int* starts, const int* ends,
                              const float* bg, int width, int height, int nx,
                              int n_tiles, float* out_rgb, float* out_log_t,
                              int* out_walked, void* stream) {
  if (n_tiles > 0) {
    blend_fwd_kernel<<<n_tiles, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        feat, gauss_id, starts, ends, bg, width, height, nx, out_rgb,
        out_log_t, out_walked);
  }
  return static_cast<int>(cudaGetLastError());
}
