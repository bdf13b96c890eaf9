// K2: backward tile blend of the splat renderer, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_bwd_kernel` of hugs_tpu/render/pallas_blend.py
// (launched by `_blend_core_bwd`). It computes what that kernel computes:
// given g = dL/d(raw colour) per pixel, the gradient of the forward blend
// (K1, blend_fwd.cu; semantics of hugs_tpu_torch/render/oracle.py) with
// respect to each instance's r g b, opacity, mean x y and conic a b c.
// Each pixel walks its tile's instances back to front, from the last one
// it walked in the forward (K1's per-pixel n_walked) to the first, and
// rebuilds the exclusive transmittance of instance i from K1's final
// log T as T_i = exp(log T_fin - sum_{j >= i} log1p(-alpha_j)), with
//   S      = sum_c g_c bg_c T_fin [log T_fin >= log 1e-4]   (seed)
//   w_i    = alpha_i T_i [log T_i >= log 1e-4]
//   d_rgb  = g w_i
//   d_alpha= (g . rgb_i) T_i - S / (1 - alpha_i);  S += w_i (g . rgb_i)
//   dp     = d_alpha alpha_i where alpha_i < 0.99 (d power), else 0
//   d_op   = dp / op;  d_mean = dp d power/d mean;  d_conic likewise.
// These are pallas_blend.py:591-668 written per pixel. The alpha of a pair
// is recomputed with K1's own code (blend_common.cuh), so the two agree
// on which pairs are kept.
//
// The suffix sum of log1p(-alpha) and S are Kahan-compensated. Where the
// splats behind instance i share its colour, d_alpha is a cancellation:
// g.rgb T_i and S / (1 - alpha) agree up to about g.rgb T_fin, so a
// rounding error in either is amplified by up to T_i / T_fin (1e4), and
// an uncompensated sum's error grows with the length of the walk. K1's own
// rounding of log T_fin scales every rebuilt T_i and S alike, so it scales
// d_alpha and is not amplified.
//
// Design: one block of 256 threads per 16x16 tile, one thread per pixel.
// The block stages its tile's instances through shared memory in batches
// of 128, last batch first, and every thread walks the batch in reverse.
// Each instance's nine gradients are then summed over the block's pixels
// without atomics, in a fixed order: a warp-shuffle tree per warp (skipped,
// with zeros written, where no lane of the warp touched the instance),
// lane 0's partial to shared memory, and after the batch a sum over the 8
// warps in warp order written to the instance's slot. Each slot of the
// instance list belongs to one tile, so the output needs no atomics and
// the kernel is deterministic. Slots past the last instance any pixel of
// the tile walked are not written: the wrapper zeroes the output. The
// wrapper scatters the slots onto the Gaussians (index_add_) and computes
// the background's gradient, as the XLA code around the TPU kernel does.
//
// The TPU kernel's mechanics (8 tiles per grid cell, a 4-deep DMA ring,
// bf16 split matmuls for the suffix sums, the pixel-moment basis on the
// matrix unit) exist for the TPU and have no counterpart here.
//
// Bound on the H100: operations. Each (pixel, instance) pair the forward
// walked costs the alpha recompute (about 22 float operations and an exp)
// and, where alpha > 0, about 48 more (a log1p, an exp, the products
// above, the compensated sums), plus the shuffle tree, 45 shuffles and
// adds per warp and instance; the bytes (the (N, 10) table, the instance list, three
// per-pixel planes in, the (I, 10) gradients out) are tens of MB. The
// simple design stands because it is exact, deterministic and needs no
// tuning: fewer shuffles (a per-thread partial over several instances, or
// the moment trick), and culling of instances that miss a whole warp
// before the recompute, are work for a later change, measured against
// this one.
//
// Built with -fmad=false, as K1 is, so the alpha of a pair is
// bit-identical to K1's and to the plain PyTorch version's.

#include "blend_common.cuh"

namespace {

using namespace hugs_blend;

constexpr int kBatch = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kGrad = 9;  // d r g b op mx my ca cb cc; the radius has none

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

__global__ void __launch_bounds__(kThreads)
blend_bwd_kernel(const float* __restrict__ feat,
                 const int* __restrict__ gauss_id,
                 const int* __restrict__ starts,
                 const float* __restrict__ bg,
                 const float* __restrict__ log_t_fin,
                 const int* __restrict__ n_walked,
                 const float* __restrict__ grad,
                 int width, int height, int nx,
                 float* __restrict__ ginst) {
  __shared__ float s_feat[kFeat][kBatch];
  __shared__ float s_part[kWarps][kBatch][kGrad];
  __shared__ int s_walk;

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int px_i = (t % nx) * kTile + tid % kTile;
  const int py_i = (t / nx) * kTile + tid / kTile;
  const bool inside = px_i < width && py_i < height;
  const float px = static_cast<float>(px_i);
  const float py = static_cast<float>(py_i);
  const int start = starts[t];

  // per-pixel setup: g, K1's final log T and walked count; the suffix
  // sums start from the background's term
  float g0 = 0.0f, g1 = 0.0f, g2 = 0.0f, log_t = 0.0f;
  int n_walk = 0;
  if (inside) {
    const size_t p = static_cast<size_t>(py_i) * width + px_i;
    const size_t plane = static_cast<size_t>(width) * height;
    g0 = grad[p];
    g1 = grad[plane + p];
    g2 = grad[2 * plane + p];
    log_t = log_t_fin[p];
    n_walk = n_walked[p];
  }
  const float t_fin = log_t >= kLogTEps ? expf(log_t) : 0.0f;
  // S = s_acc - s_c and the suffix sum = suf_log - suf_c, Kahan sums
  float s_acc = (g0 * bg[0] + g1 * bg[1] + g2 * bg[2]) * t_fin;
  float s_c = 0.0f;
  float suf_log = 0.0f, suf_c = 0.0f;

  if (tid == 0) s_walk = 0;
  __syncthreads();
  if (n_walk > 0) atomicMax(&s_walk, n_walk);
  __syncthreads();
  const int walk = s_walk;  // the most any pixel of the tile walked

  for (int b0 = ((walk - 1) / kBatch) * kBatch; walk > 0 && b0 >= 0;
       b0 -= kBatch) {
    const int n = min(kBatch, walk - b0);
    if (tid < n) {
      const float* f =
          feat + static_cast<size_t>(gauss_id[start + b0 + tid]) * kFeat;
#pragma unroll
      for (int k = 0; k < kFeat; ++k) s_feat[k][tid] = f[k];
    }
    __syncthreads();

    for (int j = n - 1; j >= 0; --j) {
      float d[kGrad];
#pragma unroll
      for (int k = 0; k < kGrad; ++k) d[k] = 0.0f;
      bool hit = false;
      if (b0 + j < n_walk) {
        float dx, dy;
        const float op = s_feat[3][j];
        const float alpha =
            pair_alpha(op, s_feat[4][j], s_feat[5][j], s_feat[6][j],
                       s_feat[7][j], s_feat[8][j], s_feat[9][j], px, py, dx,
                       dy);
        if (alpha > 0.0f) {
          hit = true;
          // log T_i (exclusive) = log T_fin - (suffix behind i + la)
          const float la_c = log1pf(-alpha) - suf_c;
          const float pre = (log_t - suf_log) - la_c;
          const float ti = pre >= kLogTEps ? expf(pre) : 0.0f;
          const float w = alpha * ti;
          const float gc =
              g0 * s_feat[0][j] + g1 * s_feat[1][j] + g2 * s_feat[2][j];
          const float d_alpha =
              gc * ti - (s_acc - s_c) / fmaxf(1.0f - alpha, 1e-6f);
          const float suf_new = suf_log + la_c;
          suf_c = (suf_new - suf_log) - la_c;
          suf_log = suf_new;
          const float wg_c = w * gc - s_c;
          const float s_new = s_acc + wg_c;
          s_c = (s_new - s_acc) - wg_c;
          s_acc = s_new;
          const float dp = alpha < kMaxAlpha ? d_alpha * alpha : 0.0f;
          const float ca = s_feat[6][j], cb = s_feat[7][j], cc = s_feat[8][j];
          d[0] = g0 * w;
          d[1] = g1 * w;
          d[2] = g2 * w;
          d[3] = dp / op;
          d[4] = -dp * (ca * dx + cb * dy);
          d[5] = -dp * (cc * dy + cb * dx);
          d[6] = -0.5f * dp * dx * dx;
          d[7] = -dp * dx * dy;
          d[8] = -0.5f * dp * dy * dy;
        }
      }
      if (__any_sync(0xffffffffu, hit)) {
#pragma unroll
        for (int k = 0; k < kGrad; ++k) d[k] = warp_sum(d[k]);
      }
      if (lane == 0) {
#pragma unroll
        for (int k = 0; k < kGrad; ++k) s_part[warp][j][k] = d[k];
      }
    }
    __syncthreads();

    for (int e = tid; e < n * kGrad; e += kThreads) {
      const int j = e / kGrad;
      const int k = e - j * kGrad;
      float v = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) v += s_part[w][j][k];
      ginst[static_cast<size_t>(start + b0 + j) * kFeat + k] = v;
    }
    // the next batch overwrites s_feat and s_part
    __syncthreads();
  }
}

}  // namespace

// Launches K2 on `stream` over n_tiles = nx * ny tiles of 16x16 pixels.
// feat: (N, 10) float32 (the forward's); gauss_id, starts: the forward's
// instance list and per-tile segment starts; bg: (3,); log_t_fin and
// n_walked: K1's (H, W) outputs; grad: (3, H, W) dL/d(raw colour).
// Writes columns 0-8 of ginst (I, 10), row s the gradient of the instance
// in slot s, for the slots some pixel walked; the caller zeroes ginst.
// Returns cudaGetLastError().
extern "C" int hugs_blend_bwd(const float* feat, const int* gauss_id,
                              const int* starts, const float* bg,
                              const float* log_t_fin, const int* n_walked,
                              const float* grad, int width, int height,
                              int nx, int n_tiles, float* ginst,
                              void* stream) {
  if (n_tiles > 0) {
    blend_bwd_kernel<<<n_tiles, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        feat, gauss_id, starts, bg, log_t_fin, n_walked, grad, width, height,
        nx, ginst);
  }
  return static_cast<int>(cudaGetLastError());
}
