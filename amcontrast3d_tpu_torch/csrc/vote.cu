// Stage labels by majority vote: for each query point, the most frequent
// class among the support points within its k-th smallest distinct d^2
// (times float32(1 + 1e-6)), ties to the lowest class.
//
// Replaces amcontrast3d_tpu/ops/contrast_pallas.py::_vote_kernel (entry
// label_vote), which selects the same threshold as the contrast kernel and
// counts the classes of the members with one MXU matmul against the
// support's one-hot labels.  The support is the full-resolution cloud and
// the queries a subsampled stage of it; they are not support points, so
// nothing is excluded.  Exact where the TPU tournament may overflow above
// 4096 points (select.cuh).
//
// What bounds it on the card: two scans of the support for every query
// (the selection, then the count), M * N distance tests each of about 9
// float instructions (0.29 G for 4 x 6000 queries over 4 x 24000 points);
// positions and labels stay in L2, the output is one int a query.
// Design: one warp per query, 8 queries per block.  The selection is
// select.cuh's; the count stages positions and labels through shared
// memory in tiles of 1024 and adds each member's class to the warp's own
// histogram of ncls ints in dynamic shared memory (shared-memory atomics);
// then each lane keeps the best of classes lane, lane + 32, ... and a
// shuffle reduction takes the largest count, ties to the lowest class.
// A label outside [0, ncls) is counted nowhere.
#include "select.cuh"

namespace {

using namespace amc3d;

template <int KPL>
__global__ void __launch_bounds__(kSelThreads)
label_vote_kernel(const float* __restrict__ support,
                  const int* __restrict__ labels,
                  const float* __restrict__ query, int n, int m, int k,
                  int ncls, int* __restrict__ out) {
  __shared__ float sx[kSelTile], sy[kSelTile], sz[kSelTile];
  __shared__ int sl[kSelTile];
  extern __shared__ int hist[];  // kSelWarps * ncls
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int qi = blockIdx.x * kSelWarps + warp;
  const bool active = qi < m;
  const float* sup = support + static_cast<size_t>(b) * n * 3;
  const int* lab = labels + static_cast<size_t>(b) * n;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (active) {
    const float* q = query + (static_cast<size_t>(b) * m + qi) * 3;
    qx = q[0];
    qy = q[1];
    qz = q[2];
  }
  const float thr = kth_distinct<KPL>(sup, n, k, qx, qy, qz, active, sx, sy, sz);

  int* h = hist + warp * ncls;
  for (int c = lane; c < ncls; c += 32) h[c] = 0;
  __syncwarp();
  for (int t0 = 0; t0 < n; t0 += kSelTile) {
    const int len = min(kSelTile, n - t0);
    __syncthreads();  // the previous tile is no longer read
    for (int t = threadIdx.x; t < len; t += kSelThreads) {
      const float* s = sup + static_cast<size_t>(t0 + t) * 3;
      sx[t] = s[0];
      sy[t] = s[1];
      sz[t] = s[2];
      sl[t] = lab[t0 + t];
    }
    __syncthreads();
    if (!active) continue;
    for (int u = lane; u < len; u += 32) {
      const int c = sl[u];
      if (sel_d2(qx, qy, qz, sx[u], sy[u], sz[u]) <= thr &&
          static_cast<unsigned>(c) < static_cast<unsigned>(ncls))
        atomicAdd(&h[c], 1);
    }
  }
  __syncwarp();
  if (!active) return;
  int best = -1, best_c = 0;
  for (int c = lane; c < ncls; c += 32) {  // ascending: strict > keeps the lowest
    if (h[c] > best) {
      best = h[c];
      best_c = c;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int ob = __shfl_down_sync(kSelFull, best, off);
    const int oc = __shfl_down_sync(kSelFull, best_c, off);
    if (ob > best || (ob == best && oc < best_c)) {
      best = ob;
      best_c = oc;
    }
  }
  if (lane == 0) out[static_cast<size_t>(b) * m + qi] = best_c;
}

template <int KPL>
int launch_vote(dim3 grid, size_t smem, cudaStream_t st, const float* s,
                const int* l, const float* q, int n, int m, int k, int ncls,
                int* o) {
  // beyond 48 KB of static and dynamic shared memory a block must opt in
  constexpr size_t kStatic = (3 * sizeof(float) + sizeof(int)) * kSelTile;
  if (smem + kStatic > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        label_vote_kernel<KPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  label_vote_kernel<KPL><<<grid, kSelThreads, smem, st>>>(s, l, q, n, m, k,
                                                          ncls, o);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// support (b, n, 3) float32, labels (b, n) int32, query (b, m, 3) float32,
// k >= 1, ncls >= 1 -> out (b, m) int32 classes.
extern "C" int amc3d_label_vote(const void* support, const void* labels,
                                const void* query, void* out, int b, int n,
                                int m, int k, int ncls, void* stream) {
  if (ncls < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((m + kSelWarps - 1) / kSelWarps, b);
  const size_t smem = static_cast<size_t>(kSelWarps) * ncls * sizeof(int);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* s = static_cast<const float*>(support);
  const auto* l = static_cast<const int*>(labels);
  const auto* q = static_cast<const float*>(query);
  auto* o = static_cast<int*>(out);
  switch (sel_per_lane(k)) {
    case 1: return launch_vote<1>(grid, smem, st, s, l, q, n, m, k, ncls, o);
    case 2: return launch_vote<2>(grid, smem, st, s, l, q, n, m, k, ncls, o);
    case 4: return launch_vote<4>(grid, smem, st, s, l, q, n, m, k, ncls, o);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
