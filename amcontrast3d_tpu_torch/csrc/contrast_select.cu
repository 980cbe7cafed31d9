// The contrast threshold of each point: its k-th smallest distinct d^2 over
// its own cloud (self included), times float32(1 + 1e-6).
//
// Replaces the selection pass of amcontrast3d_tpu/ops/contrast_pallas.py::
// _fwd_kernel (has_kth=False, entry contrast_reductions_selfk), which runs a
// best-4-per-group tournament and k value-only extraction rounds per query
// tile, then forms the reductions in the same kernel.  Here the selection
// is its own launch, and contrast.cu's forward kernel then forms the
// reductions with this threshold, as it does with the exact backend's.  The
// TPU tournament keeps 4 values a strided group above 4096 points and may
// overflow there, which only raises its threshold (a superset); this kernel
// is exact at every size (select.cuh).
//
// What bounds it on the card: instruction throughput of the scan, N^2
// distance tests of about 9 float instructions each per cloud (2.3 G at the
// 4 x 24000 stage); positions stay in L2 and the output is one float a
// point.  Keeping the distinct values costs about k * ln(N / k) insertions
// a query, each a few warp instructions.
// Design: one warp per point, 8 points per block, support tiles through
// shared memory (select.cuh); any n >= 1 and k >= 1 (k > 128 in passes).
#include "select.cuh"

namespace {

using namespace amc3d;

template <int KPL>
__global__ void __launch_bounds__(kSelThreads)
contrast_select_kernel(const float* __restrict__ p, int n, int k,
                       float* __restrict__ out) {
  __shared__ float sx[kSelTile], sy[kSelTile], sz[kSelTile];
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kSelWarps + (threadIdx.x >> 5);
  const bool active = i < n;
  const float* cloud = p + static_cast<size_t>(b) * n * 3;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (active) {
    qx = cloud[static_cast<size_t>(i) * 3];
    qy = cloud[static_cast<size_t>(i) * 3 + 1];
    qz = cloud[static_cast<size_t>(i) * 3 + 2];
  }
  const float thr =
      kth_distinct<KPL>(cloud, n, k, qx, qy, qz, active, sx, sy, sz);
  if (active && lane == 0) out[static_cast<size_t>(b) * n + i] = thr;
}

}  // namespace

// p (b, n, 3) float32, k >= 1 -> out (b, n) float32 thresholds.
extern "C" int amc3d_contrast_select(const void* p, void* out, int b, int n,
                                     int k, void* stream) {
  const dim3 grid((n + kSelWarps - 1) / kSelWarps, b);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* pp = static_cast<const float*>(p);
  auto* o = static_cast<float*>(out);
  switch (sel_per_lane(k)) {
    case 1: contrast_select_kernel<1><<<grid, kSelThreads, 0, st>>>(pp, n, k, o); break;
    case 2: contrast_select_kernel<2><<<grid, kSelThreads, 0, st>>>(pp, n, k, o); break;
    case 4: contrast_select_kernel<4><<<grid, kSelThreads, 0, st>>>(pp, n, k, o); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
