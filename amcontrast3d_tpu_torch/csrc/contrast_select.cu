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
// is exact at every size.
//
// What bounds it on the card: a dense scan is N^2 distance tests of about 9
// float instructions per cloud (2.3 G at the 4 x 24000 stage), instruction
// throughput, though only the points near each one decide its k-th.
// Design: the listed scan of listed_select.cuh over the cloud's
// Morton-sorted layout (ops/spatial.py, the one the forward sorted for the
// stage), the points themselves the queries, in the layout's order: a
// block takes 8 points consecutive along the curve, a warp each, with its
// sorted place over 64 as its home chunk.  Each warp seeds its limit from
// its home chunk and the ones beside it, the block lists the chunks within
// the largest limit of its 8 once, and each warp scans only the listed
// chunks within its own running k-th.  Each threshold is written at the
// point's index in the caller's order (the w bits of the layout).  Any
// n >= 1 and k >= 1 (k > 128 in passes).
#include "listed_select.cuh"

namespace {

using namespace amc3d;

template <int KPL>
__global__ void __launch_bounds__(kListThreads)
contrast_select_kernel(const float4* __restrict__ sorted,
                       const float* __restrict__ boxes, int n, int nc, int k,
                       float* __restrict__ out) {
  __shared__ SelectShared sh;
  const int b = blockIdx.y;
  const int rank = blockIdx.x * kListWarps + (threadIdx.x >> 5);
  const float4* sup = sorted + static_cast<size_t>(b) * n;
  SelectQuery q{rank < n, 0.f, 0.f, 0.f, rank / kChunk};
  int qi = 0;
  if (q.active) {
    const float4 p = sup[rank];
    q.x = p.x;
    q.y = p.y;
    q.z = p.z;
    qi = __float_as_int(p.w);
  }
  const float thr = listed_kth_distinct<KPL>(
      sup, boxes + static_cast<size_t>(b) * nc * 6, n, nc, k,
      min(kListWarps, n - static_cast<int>(blockIdx.x) * kListWarps), q, sh);
  if (q.active && (threadIdx.x & 31) == 0)
    out[static_cast<size_t>(b) * n + qi] = thr;
}

}  // namespace

// sorted (b, n) float4: the cloud's sorted points with their index in w;
// boxes (b, nc, 6) float32, nc = ceil(n / 64); k >= 1 -> out (b, n) float32
// thresholds in the caller's order.
extern "C" int amc3d_contrast_select(const void* sorted, const void* boxes,
                                     void* out, int b, int n, int k,
                                     void* stream) {
  const int nc = (n + kChunk - 1) / kChunk;
  const dim3 grid((n + kListWarps - 1) / kListWarps, b);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* s = static_cast<const float4*>(sorted);
  const auto* bx = static_cast<const float*>(boxes);
  auto* o = static_cast<float*>(out);
  if (n < 1 || reinterpret_cast<size_t>(sorted) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (sel_per_lane(k)) {
    case 1: contrast_select_kernel<1><<<grid, kListThreads, 0, st>>>(s, bx, n, nc, k, o); break;
    case 2: contrast_select_kernel<2><<<grid, kListThreads, 0, st>>>(s, bx, n, nc, k, o); break;
    case 4: contrast_select_kernel<4><<<grid, kListThreads, 0, st>>>(s, bx, n, nc, k, o); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
