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
// Design: one block of 256 threads per 16x16 tile, one thread per pixel,
// warp w on pixel rows 2w and 2w + 1. The block stages its tile's
// instances in batches of 256 in shared memory, every thread loading one
// instance's row. In each batch every warp first culls: lane l tests
// instances l, l + 32, ... against the warp's 16x2 rectangle of pixel
// centres (cull_keep, blend_common.cuh), and a ballot gives the warp the
// instances that can have alpha > 0 at one of its pixels. The warp's
// threads walk only those, in order, each for its pixel; a dropped pair
// has alpha 0 at every pixel of the warp, so the image does not change,
// and n_walked still counts the dropped instances (it indexes the tile's
// list). A warp whose pixels have all saturated skips the batch; the
// block stops when all 256 pixels have (__syncthreads_count). The TPU
// kernel's 8-tiles-per-cell grid, DMA ring, bf16 hi/lo split matmuls and
// pre-saturated out-of-image pixels are TPU mechanics and have no
// counterpart here. Copies of the next batch that overlap the walk of
// this one (cp.async into a second buffer) bought at most 3 % on an
// NVIDIA H100 80GB HBM3 at 700 W, not worth their code (PERF.md).
//
// Bound on the H100: operations. Each (pixel, instance) pair costs about
// 22 float operations and one expf before the alpha test, and each
// blended pair three transcendentals (the alpha's expf, expf(log T),
// log1pf) with no fused multiply-add, and each (warp, instance) it culls
// about 90; the bytes are the (N, 10) table, the instance list and the
// image, a few MB. The warp cull removes the pairs whose instance misses
// the warp's rectangle. Times against the bound: PERF.md.
//
// Built with -fmad=false so that every product and sum rounds as the
// plain PyTorch version's separate elementwise kernels round: the alpha
// of a pair, and the cull of an (instance, warp), are then bit-identical
// between the two, and only the order of the transmittance and colour
// sums differs.
//
// The POWER_MXU mode (blend_fwd_mxu_kernel, hugs_blend_fwd_mxu) is the
// TPU kernel's second mode (`basis` at pallas_blend.py:365, its alpha at
// :428). The staging thread also writes each instance's coefficient
// record (mxu_record, blend_common.cuh). Each warp culls the whole batch
// and compacts the slots it keeps into its list; each 8 of them in list
// order are a group. Per group, one product on the tensor cores
// (mxu_product, 12 mma.sync) gives the powers at the warp's 32 pixels;
// while its chain completes, each column's four lanes copy what the walk
// needs of its instance into the group's rows (mxu_group_row: opacity,
// mean, squared radius, colour, slot; past the list's end a row of
// opacity 0); then the powers go to shared memory (mxu_store). The walk
// reads both at fixed offsets, with no index and no end test per pair,
// and its alpha test takes 13 float operations where the exact mode
// takes 22. Measured on an NVIDIA H100 80GB HBM3 at 700 W
// against the alternatives, in one process each (PERF.md, section 6):
// - groups of 8 kept instances, not aligned groups of 8 slots (which ran
//   88 % full on the training frame, 59 % serving): -5 % and -12 %;
// - the group's rows, one 16-byte load a pair in place of an index, an
//   address and four loads: -11 % and -10 %, the largest gain;
// - left out, each slower or within the noise: a warp-uniform vote that
//   skips the k step no instance of a group uses (1 % of the training
//   frame's groups lie in one row of grid points, 13 % serving); the
//   next group's product issued before this group's walk (its
//   accumulators live through the walk: 78 registers, 3 blocks per SM,
//   +3 %); two groups' powers in two buffers with one warp sync a group;
//   the k steps in separate accumulators; the A fragments in a shared
//   table (16 KB a block, +5 %).
// The mode adds 29,760 B of dynamic shared memory (16,448 B of records,
// the zero record past the batch's 256 among them, 9,216 B of powers,
// 2,048 B of rows and 2,048 B of lists) and runs at 4 blocks per SM, set
// by its registers (the exact mode 5). Bound on the H100: its remaining
// float operations; the tensor-core flops bound it less (PERF.md). The
// exact mode's code is unchanged (fwd_tile<false>).

#include "blend_common.cuh"

namespace {

using namespace hugs_blend;

constexpr int kBatch = kThreads;

// One 16x16 tile's forward, in the exact mode (kMxu false: K1) or in the
// POWER_MXU mode (kMxu true, `mx` the mode's shared memory).
template <bool kMxu>
__device__ __forceinline__ void fwd_tile(const float* __restrict__ feat,
                                         const int* __restrict__ gauss_id,
                                         const int* __restrict__ starts,
                                         const int* __restrict__ ends,
                                         const float* __restrict__ bg,
                                         int width, int height, int nx,
                                         float* __restrict__ out_rgb,
                                         float* __restrict__ out_log_t,
                                         int* __restrict__ out_n_walked,
                                         int* __restrict__ out_walked,
                                         MxuShared<kBatch>* mx) {
  __shared__ float s_feat[kBatch][kFeat];

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tx0 = (t % nx) * kTile;
  const int ty0 = (t / nx) * kTile;
  const int px_i = tx0 + tid % kTile;
  const int py_i = ty0 + tid / kTile;
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
  uint4 basis[2][2];  // the mode's A fragments
  if constexpr (kMxu) {
    mxu_basis(warp, lane, basis);
    if (tid < kCofStride) mx->cof[kBatch][tid] = 0u;  // the zero record
  }

  for (int base = start; base < end; base += kBatch) {
    // also the barrier that keeps the previous batch's readers ahead of
    // this batch's writers
    if (__syncthreads_count(done) == kThreads) break;
    const int n = min(kBatch, end - base);
    if (tid < n) {
      const float* f = feat + static_cast<size_t>(gauss_id[base + tid]) * kFeat;
#pragma unroll
      for (int k = 0; k < kFeat; ++k) s_feat[tid][k] = f[k];
      if constexpr (kMxu) {
        mxu_record(s_feat[tid], static_cast<float>(tx0),
                   static_cast<float>(ty0), mx->cof[tid]);
      }
    }
    __syncthreads();
    walked = base + n - start;
    if (__all_sync(0xffffffffu, done)) continue;

    const bool was_done = done;
    int sat = n;  // one past the instance that saturated this pixel
    if constexpr (kMxu) {
      // the warp's kept instances of the batch, in list order
      uint8_t* list = mx->list[warp];
      int cnt = 0;
      for (int w0 = 0; w0 < n; w0 += 32) {
        const int i = w0 + lane;
        const bool keep = i < n && warp_keep(s_feat[i], tx0, ty0, warp);
        const unsigned bits = __ballot_sync(0xffffffffu, keep);
        if (keep) list[cnt + __popc(bits & ((1u << lane) - 1u))] = i;
        cnt += __popc(bits);
      }
      __syncwarp();
      // groups of kGroupN kept instances: a group's product and rows,
      // then its walk
#pragma unroll 1
      for (int c0 = 0; c0 < cnt; c0 += kGroupN) {
        float (*pw)[kPowStride] = mx->power[warp];
        const int c = c0 + (lane >> 2);
        const bool valid = c < cnt;
        const int slot = valid ? list[c] : 0;
        float d[2][4];
        mxu_product(basis, mx->cof, valid ? slot : kBatch, lane, d);
        // the rows' loads run while the product's chain completes
        mxu_group_row(s_feat[slot], slot, valid, lane, mx->rows[warp]);
        mxu_store(d, lane, pw);
        __syncwarp();
#pragma unroll
        for (int jj = 0; jj < kGroupN; ++jj) {
          if (done) continue;
          const float4 (*rows)[2] = mx->rows[warp];
          float dx, dy;
          const float alpha = pair_alpha_mxu(pw[jj][lane], rows[jj][0], px,
                                             py, dx, dy);
          if (alpha == 0.0f) continue;
          const float4 col = rows[jj][1];
          const float w = alpha * expf(log_t);
          cr += col.x * w;
          cg += col.y * w;
          cb += col.z * w;
          log_t += log1pf(-alpha);
          done = log_t < kLogTEps;
          if (done) sat = __float_as_int(col.w) + 1;
        }
        __syncwarp();  // the group's readers before the next one's writers
        if (__all_sync(0xffffffffu, done)) break;
      }
    } else {
      for (int w0 = 0; w0 < n; w0 += 32) {
        const int i = w0 + lane;
        const unsigned bits =
            __ballot_sync(0xffffffffu, i < n && warp_keep(s_feat[i], tx0, ty0,
                                                          warp));
        // a counted loop with a warp-uniform test of the cull's bit costs
        // fewer instructions per instance than extracting set bits
#pragma unroll 4
        for (int jj = 0; jj < 32; ++jj) {
          if (!((bits >> jj) & 1u)) continue;
          const int j = w0 + jj;
          if (done) continue;
          const float* f = s_feat[j];
          float dx, dy;
          const float alpha = pair_alpha(f[3], f[4], f[5], f[6], f[7], f[8],
                                         f[9], px, py, dx, dy);
          if (alpha == 0.0f) continue;
          const float w = alpha * expf(log_t);
          cr += f[0] * w;
          cg += f[1] * w;
          cb += f[2] * w;
          log_t += log1pf(-alpha);
          done = log_t < kLogTEps;
          if (done) sat = j + 1;
        }
        if (__all_sync(0xffffffffu, done)) break;
      }
    }
    if (!was_done) n_walked = base - start + sat;
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
  fwd_tile<false>(feat, gauss_id, starts, ends, bg, width, height, nx,
                  out_rgb, out_log_t, out_n_walked, out_walked, nullptr);
}

// K1 in the POWER_MXU mode: the mode's shared memory is dynamic.
__global__ void __launch_bounds__(kThreads)
blend_fwd_mxu_kernel(const float* __restrict__ feat,
                     const int* __restrict__ gauss_id,
                     const int* __restrict__ starts,
                     const int* __restrict__ ends,
                     const float* __restrict__ bg,
                     int width, int height, int nx,
                     float* __restrict__ out_rgb,
                     float* __restrict__ out_log_t,
                     int* __restrict__ out_n_walked,
                     int* __restrict__ out_walked) {
  extern __shared__ __align__(16) unsigned char s_mxu[];
  fwd_tile<true>(feat, gauss_id, starts, ends, bg, width, height, nx,
                 out_rgb, out_log_t, out_n_walked, out_walked,
                 reinterpret_cast<MxuShared<kBatch>*>(s_mxu));
}

// The warp cull alone, for tests and measurement: keep[i] = cull_keep of
// Gaussian gauss_id[i] against the 16x2 pixel-centre rectangle (tx[i],
// ty[i]) of the grid of 16x2 rectangles, the rectangle of warp ty[i] % 8
// of tile (tx[i], ty[i] / 8).
__global__ void warp_cull_kernel(const float* __restrict__ feat,
                                 const int* __restrict__ gauss_id,
                                 const int* __restrict__ tx,
                                 const int* __restrict__ ty, int n,
                                 unsigned char* __restrict__ keep) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  keep[i] = warp_keep(feat + static_cast<size_t>(gauss_id[i]) * kFeat,
                      tx[i] * kTile, ty[i] * kWarpRows, 0);
}

}  // namespace

// Launches K1 on `stream` over n_tiles = nx * ny tiles of 16x16 pixels.
// feat: (N, 10) float32; gauss_id: instance list;
// starts/ends: (n_tiles,) per-tile segments of gauss_id; bg: (3,). Writes
// out_rgb (3, H, W) raw colour, out_log_t (H, W), out_n_walked (H, W), the
// instances each pixel walked up to and including the one that saturated
// it, and out_walked (n_tiles,), the instances each tile walked before all
// its pixels saturated. Returns cudaGetLastError().
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

// Launches the warp cull alone (warp_cull_kernel) over n instances.
// Returns cudaGetLastError().
extern "C" int hugs_warp_cull(const float* feat, const int* gauss_id,
                              const int* tx, const int* ty, int n,
                              unsigned char* keep, void* stream) {
  if (n > 0) {
    warp_cull_kernel<<<(n + 255) / 256, 256, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        feat, gauss_id, tx, ty, n, keep);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launches K1 in the POWER_MXU mode (blend_fwd_mxu_kernel), with
// hugs_blend_fwd's arguments and outputs. Returns cudaGetLastError().
extern "C" int hugs_blend_fwd_mxu(const float* feat, const int* gauss_id,
                                  const int* starts, const int* ends,
                                  const float* bg, int width, int height,
                                  int nx, int n_tiles, float* out_rgb,
                                  float* out_log_t, int* out_n_walked,
                                  int* out_walked, void* stream) {
  if (n_tiles > 0) {
    blend_fwd_mxu_kernel<<<n_tiles, kThreads, sizeof(MxuShared<kBatch>),
                           static_cast<cudaStream_t>(stream)>>>(
        feat, gauss_id, starts, ends, bg, width, height, nx, out_rgb,
        out_log_t, out_n_walked, out_walked);
  }
  return static_cast<int>(cudaGetLastError());
}

// K1's resident blocks per SM, from the occupancy calculator.
extern "C" int hugs_blend_fwd_blocks_per_sm() {
  return blocks_per_sm(blend_fwd_kernel);
}

// The mode's K1's resident blocks per SM, and in *dynamic the dynamic
// shared memory (bytes) it is launched with.
extern "C" int hugs_blend_fwd_mxu_blocks_per_sm(int* dynamic) {
  *dynamic = static_cast<int>(sizeof(MxuShared<kBatch>));
  return blocks_per_sm(blend_fwd_mxu_kernel, sizeof(MxuShared<kBatch>));
}
