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
// then colour + bg * T_fin * [log T_fin >= log(1e-4)], written raw: the
// wrapper clips it to [0, 1] (render/cuda_blend.py), since the clip's
// gradient at the bounds cannot be recovered from a clipped value.
// Transmittance is kept in log space, as in the TPU kernel, so the T_EPS
// threshold tests the same quantity the reference tests. Per pixel it
// also writes how many of its tile's instances it walked before it
// saturated (upstream 3DGS's n_contrib), which the backward (K2,
// blend_bwd.cu) needs to rebuild each T_i from the final log T.
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

#include "blend_common.cuh"

namespace {

using namespace hugs_blend;

__global__ void __launch_bounds__(kThreads)
blend_fwd_kernel(const float* __restrict__ feat,
                 const int* __restrict__ gauss_id,
                 const int* __restrict__ starts,
                 const int* __restrict__ ends,
                 const float* __restrict__ bg,
                 int width, int height, int nx,
                 float* __restrict__ out_rgb,
                 float* __restrict__ out_log_t,
                 int* __restrict__ out_n_walked,
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
  int n_walked = 0;  // this pixel's instances, up to its saturating one

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

    int j = 0;
    for (; j < n && !done; ++j) {
      float dx, dy;
      const float alpha =
          pair_alpha(s_feat[3][j], s_feat[4][j], s_feat[5][j], s_feat[6][j],
                     s_feat[7][j], s_feat[8][j], s_feat[9][j], px, py, dx, dy);
      if (alpha == 0.0f) continue;
      const float w = alpha * expf(log_t);
      cr += s_feat[0][j] * w;
      cg += s_feat[1][j] * w;
      cb += s_feat[2][j] * w;
      log_t += log1pf(-alpha);
      done = log_t < kLogTEps;
    }
    if (j > 0) n_walked = base - start + j;
  }

  if (tid == 0) out_walked[t] = walked;
  if (!inside) return;
  const float t_fin = log_t >= kLogTEps ? expf(log_t) : 0.0f;
  const size_t p = static_cast<size_t>(py_i) * width + px_i;
  const size_t plane = static_cast<size_t>(width) * height;
  out_rgb[p] = cr + bg[0] * t_fin;
  out_rgb[plane + p] = cg + bg[1] * t_fin;
  out_rgb[2 * plane + p] = cb + bg[2] * t_fin;
  out_log_t[p] = log_t;
  out_n_walked[p] = n_walked;
}

}  // namespace

// Launches K1 on `stream` over n_tiles = nx * ny tiles of 16x16 pixels.
// feat: (N, 10) float32; gauss_id: instance list; starts/ends: (n_tiles,)
// per-tile segments of gauss_id; bg: (3,). Writes out_rgb (3, H, W) raw
// colour, out_log_t (H, W), out_n_walked (H, W), the instances each pixel
// walked up to and including the one that saturated it, and out_walked
// (n_tiles,), the instances each tile walked before all its pixels
// saturated. Returns cudaGetLastError().
extern "C" int hugs_blend_fwd(const float* feat, const int* gauss_id,
                              const int* starts, const int* ends,
                              const float* bg, int width, int height, int nx,
                              int n_tiles, float* out_rgb, float* out_log_t,
                              int* out_n_walked, int* out_walked,
                              void* stream) {
  if (n_tiles > 0) {
    blend_fwd_kernel<<<n_tiles, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        feat, gauss_id, starts, ends, bg, width, height, nx, out_rgb,
        out_log_t, out_n_walked, out_walked);
  }
  return static_cast<int>(cudaGetLastError());
}
