// Exact k nearest neighbours: indices and d^2 in ascending order.
//
// Replaces amcontrast3d_tpu/ops/knn_pallas.py::_knn_kernel (entry
// knn_pallas).  The TPU kernel keeps the best two points of every 128-wide
// bin of a permuted support and extracts k from that pool, a shape its
// vector lanes force and approximate by design.  This kernel is exact: the
// k nearest in (d^2, index) order, ties to the lowest index, d^2 in the
// direct form (dx*dx + dy*dy) + dz*dz without FMA, bit for bit what the
// plain PyTorch twin (ops/knn.py::knn_plain, a stable top-k over the same
// d^2) returns; for k > n the extra slots index 0 at d^2 = 1e10.
//
// What bounds it on the card: instruction throughput of the scan, M * N
// distance tests of about 9 float instructions each (2.3 G tests for the
// self-kNN of 4 clouds of 24000 points); the positions (12 bytes a point)
// stay in L2 and the outputs are k pairs a query.  Keeping the k best costs
// about k * ln(N / k) insertions a query on unordered clouds, each a few
// warp instructions.
// Design (knn_topk.cuh): one warp per query, 8 queries per block, support
// tiles of 1024 points through shared memory, one candidate per lane, a
// ballot against the running k-th d^2, the k best spread over the warp's
// registers.  Up to 128 slots a launch; a larger k is taken in passes
// (ops/knn.py), each keeping the next slots strictly after the previous
// pass's last (d^2, index) pair, which the kernel reads from the output row
// just before its own first slot.  Any n, m >= 1.
#include "knn_topk.cuh"

namespace {

using namespace amc3d;

// LOWER: a later pass (first > 0), after the pair in slot first - 1
template <int KPL, bool LOWER>
__global__ void __launch_bounds__(kScanThreads)
knn_kernel(const float* __restrict__ support, const float* __restrict__ query,
           int n, int m, int k, int ld, int first, int* __restrict__ idx_out,
           float* __restrict__ d2_out) {
  __shared__ float sx[kScanTile], sy[kScanTile], sz[kScanTile];
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int qi = blockIdx.x * kScanWarps + (threadIdx.x >> 5);
  const bool active = qi < m;
  const size_t row = (static_cast<size_t>(b) * m + qi) * ld;
  float qx = 0.f, qy = 0.f, qz = 0.f, lo_d = 0.f;
  int lo_i = 0;
  if (active) {
    const float* q = query + (static_cast<size_t>(b) * m + qi) * 3;
    qx = q[0];
    qy = q[1];
    qz = q[2];
    if (LOWER) {  // after the previous pass's last pair
      lo_d = d2_out[row - 1];
      lo_i = idx_out[row - 1];
    }
  }
  WarpTopK<KPL> top;
  scan_topk<KPL, LOWER>(support + static_cast<size_t>(b) * n * 3, n, k, qx,
                        qy, qz, active, sx, sy, sz, top, lo_d, lo_i);
  if (!active) return;
#pragma unroll
  for (int r = 0; r < KPL; ++r) {
    const int slot = lane + 32 * r;
    if (slot < k) {
      // slots past the n support points: index 0 at 1e10
      const bool real = first + slot < n;
      idx_out[row + slot] = real ? top.i[r] : 0;
      d2_out[row + slot] = real ? top.d[r] : 1e10f;
    }
  }
}

}  // namespace

// support (b, n, 3), query (b, m, 3) float32, 1 <= k <= 128 -> k slots of
// each (b, m) row of ld entries of idx_out (int32) and d2_out (float32):
// the neighbours first .. first + k - 1; for first > 0 the slot just before
// them holds the previous pass's last pair.
extern "C" int amc3d_knn(const void* support, const void* query, void* idx_out,
                         void* d2_out, int b, int n, int m, int k, int ld,
                         int first, void* stream) {
  const dim3 grid((m + kScanWarps - 1) / kScanWarps, b);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* s = static_cast<const float*>(support);
  const auto* q = static_cast<const float*>(query);
  auto* io = static_cast<int*>(idx_out);
  auto* dout = static_cast<float*>(d2_out);
  if (ld < k || first < 0) return static_cast<int>(cudaErrorInvalidValue);
  using Kernel = void (*)(const float*, const float*, int, int, int, int, int,
                          int*, float*);
  Kernel kernel = nullptr;
  switch (slots_per_lane(k)) {
    case 1: kernel = first > 0 ? knn_kernel<1, true> : knn_kernel<1, false>; break;
    case 2: kernel = first > 0 ? knn_kernel<2, true> : knn_kernel<2, false>; break;
    case 4: kernel = first > 0 ? knn_kernel<4, true> : knn_kernel<4, false>; break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  kernel<<<grid, kScanThreads, 0, st>>>(s, q, n, m, k, ld, first, io, dout);
  return static_cast<int>(cudaGetLastError());
}
