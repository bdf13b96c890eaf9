// K3: brute-force k nearest neighbours, for Hopper (sm_90a).
//
// Replaces no TPU kernel: hugs_tpu/ops/knn.py::knn is plain JAX (a fused
// group-min sweep that XLA compiles), and the port's counterpart,
// ops/knn.py::plain_knn, ran as ~28 PyTorch launches per 4,096 queries: a
// (4,096, N) distance matrix through device memory and k rounds of argmin,
// gather and scatter over it. This kernel keeps every distance in
// registers. It serves every caller of ops/knn.py::knn on a CUDA tensor:
// the LBS skinning targets (524,288 queries against the 6,912 template
// vertices, k = 6, once a joint step) and the scene's initial scales
// (mean_sq_dist_to_knn: a cloud against itself, k = 4).
//
// Contract (the plain version's, bit for bit): for each query, the k
// references of least d = ((rx - qx)^2 + (ry - qy)^2) + (rz - qz)^2, each
// operation rounded to float32 on its own (__fsub_rn, __fmul_rn,
// __fadd_rn: no FMA, whatever the flags), ascending by d, the lower index
// first among equal d. The wrapper centres both clouds on the reference
// cloud's mean first, as the plain version does.
//
// Design. Each thread owns kQueries queries in registers and, for each,
// a sorted list of its K best (distance, index) pairs, K a template
// parameter (1 to 8). The block streams the references through shared
// memory in tiles of kTile points, stored as x, y and z arrays, double
// buffered with cp.async (4-byte copies that also transpose the (N, 3)
// rows into the three arrays); the tail of the last tile holds +inf,
// whose distance is +inf and never enters a list. Every thread reads the
// same point at a time (a broadcast, four points per 16-byte load of
// each array), and each point is loaded once for the thread's queries.
// References are scanned in ascending index, and a candidate enters a
// list only if strictly below its K-th distance, behind every kept entry
// of equal distance: so ties keep the lower index first, as the plain
// version's first-minimum argmin does. Per query and group of 4 points
// the kernel tests the least of the 4 distances against the K-th first;
// the insertion (a compare-and-swap chain from the tail of the list) is
// the rare branch. The kernel writes the indices alone: the wrapper takes
// the neighbours' distances by one gather, as the plain version does. One
// launch serves any N; the grid covers the queries only, so the LBS call
// is one launch a step. 2 queries a thread in blocks
// of 128 (61 registers at K = 6, 8 blocks an SM) ran fastest on the H100
// of 2, 4 and 8 queries in blocks of 64, 128 and 256 and tiles of 1,024
// and 2,048 points, at the LBS shape and at 100,003 points (PERF.md).
//
// Bound on the H100: instruction issue. Per (query, reference) pair 3
// subtracts, 3 multiplies, 2 adds and one compare (9 FP32-pipe lane
// instructions; the group-min test costs 1.25 a pair where the compare
// and branch would cost 2) against 132 SMs x 128 lanes a clock; the bytes
// are the two clouds in and the indices out.

#include <cuda_runtime.h>

namespace hugs_k3 {

constexpr int kThreads = 128;   // a block
constexpr int kQueries = 2;     // queries a thread
constexpr int kTile = 1024;     // reference points a shared-memory tile
constexpr int kMaxK = 8;

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Tile t of the references into buf[0..2][0..kTile): x, y, z arrays.
__device__ __forceinline__ void load_tile(float (*buf)[kTile],
                                          const float* __restrict__ ref,
                                          int n, int t) {
  const int base = t * kTile;
  const float* src = ref + 3 * static_cast<size_t>(base);
  for (int f = threadIdx.x; f < 3 * kTile; f += kThreads) {
    const int p = f / 3;
    const int c = f - 3 * p;
    if (base + p < n) {
      cp_async4(&buf[c][p], src + f);
    } else {
      buf[c][p] = __int_as_float(0x7f800000);   // +inf
    }
  }
  cp_async_commit();
}

// The exact distance of the plain version: ((dx dx + dy dy) + dz dz).
__device__ __forceinline__ float sq_dist(float rx, float ry, float rz,
                                         float qx, float qy, float qz) {
  const float dx = __fsub_rn(rx, qx);
  const float dy = __fsub_rn(ry, qy);
  const float dz = __fsub_rn(rz, qz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// Puts (d, j), d < bd[K-1], into the sorted list: it replaces the K-th
// and moves forward past every entry of greater distance, never past an
// equal one.
template <int K>
__device__ __forceinline__ void insert(float (&bd)[K], int (&bi)[K],
                                       float d, int j) {
  bd[K - 1] = d;
  bi[K - 1] = j;
#pragma unroll
  for (int s = K - 1; s > 0; --s) {
    const bool lt = bd[s] < bd[s - 1];
    const float a = bd[s - 1], b = bd[s];
    const int ia = bi[s - 1], ib = bi[s];
    bd[s - 1] = lt ? b : a;
    bd[s] = lt ? a : b;
    bi[s - 1] = lt ? ib : ia;
    bi[s] = lt ? ia : ib;
  }
}

template <int K>
__global__ void __launch_bounds__(kThreads)
knn_kernel(const float* __restrict__ query, const float* __restrict__ ref,
           int m, int n, long long* __restrict__ out_i) {
  __shared__ __align__(16) float tiles[2][3][kTile];

  // query q of this thread: row0 + q * kThreads
  const int row0 = blockIdx.x * (kThreads * kQueries) + threadIdx.x;
  float qx[kQueries], qy[kQueries], qz[kQueries];
  float bd[kQueries][K];
  int bi[kQueries][K];
#pragma unroll
  for (int q = 0; q < kQueries; ++q) {
    const int r = min(row0 + q * kThreads, m - 1);
    qx[q] = query[3 * static_cast<size_t>(r)];
    qy[q] = query[3 * static_cast<size_t>(r) + 1];
    qz[q] = query[3 * static_cast<size_t>(r) + 2];
#pragma unroll
    for (int s = 0; s < K; ++s) {
      bd[q][s] = __int_as_float(0x7f800000);
      bi[q][s] = 0;
    }
  }

  const int n_tiles = (n + kTile - 1) / kTile;
  load_tile(tiles[0], ref, n, 0);
  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      load_tile(tiles[(t + 1) & 1], ref, n, t + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* sx = tiles[t & 1][0];
    const float* sy = tiles[t & 1][1];
    const float* sz = tiles[t & 1][2];
    const int base = t * kTile;
    const int count = min(kTile, (n - base + 3) & ~3);
    for (int j = 0; j < count; j += 4) {
      const float4 x4 = *reinterpret_cast<const float4*>(sx + j);
      const float4 y4 = *reinterpret_cast<const float4*>(sy + j);
      const float4 z4 = *reinterpret_cast<const float4*>(sz + j);
      const float xs[4] = {x4.x, x4.y, x4.z, x4.w};
      const float ys[4] = {y4.x, y4.y, y4.z, y4.w};
      const float zs[4] = {z4.x, z4.y, z4.z, z4.w};
#pragma unroll
      for (int q = 0; q < kQueries; ++q) {
        float d[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          d[u] = sq_dist(xs[u], ys[u], zs[u], qx[q], qy[q], qz[q]);
        }
        const float least = fminf(fminf(d[0], d[1]), fminf(d[2], d[3]));
        if (__builtin_expect(least < bd[q][K - 1], 0)) {
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            if (d[u] < bd[q][K - 1]) insert<K>(bd[q], bi[q], d[u], base + j + u);
          }
        }
      }
    }
    __syncthreads();   // the buffer is refilled two tiles on
  }

#pragma unroll
  for (int q = 0; q < kQueries; ++q) {
    const int r = row0 + q * kThreads;
    if (r < m) {
#pragma unroll
      for (int s = 0; s < K; ++s) {
        out_i[static_cast<size_t>(r) * K + s] = bi[q][s];
      }
    }
  }
}

template <int K>
cudaError_t launch(const float* query, const float* ref, int m, int n,
                   long long* out_i, cudaStream_t stream) {
  const int per_block = kThreads * kQueries;
  const int blocks = (m + per_block - 1) / per_block;
  knn_kernel<K><<<blocks, kThreads, 0, stream>>>(query, ref, m, n, out_i);
  return cudaGetLastError();
}

}  // namespace hugs_k3

// query (m, 3) and ref (n, 3) float32, contiguous, centred by the
// caller; out_i (m, k) int64. 1 <= k <= 8, k <= n. Launches on
// `stream`; returns the cudaError of the launch.
extern "C" int hugs_knn(const float* query, const float* ref, int m, int n,
                        int k, long long* out_i, void* stream) {
  using namespace hugs_k3;
  const auto s = static_cast<cudaStream_t>(stream);
  if (k < 1 || k > kMaxK || n < k || m < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (m == 0) return 0;
  cudaError_t err = cudaErrorInvalidValue;
  switch (k) {
    case 1: err = launch<1>(query, ref, m, n, out_i, s); break;
    case 2: err = launch<2>(query, ref, m, n, out_i, s); break;
    case 3: err = launch<3>(query, ref, m, n, out_i, s); break;
    case 4: err = launch<4>(query, ref, m, n, out_i, s); break;
    case 5: err = launch<5>(query, ref, m, n, out_i, s); break;
    case 6: err = launch<6>(query, ref, m, n, out_i, s); break;
    case 7: err = launch<7>(query, ref, m, n, out_i, s); break;
    case 8: err = launch<8>(query, ref, m, n, out_i, s); break;
  }
  return static_cast<int>(err);
}
