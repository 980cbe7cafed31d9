// Exact k nearest neighbours in a large cloud: only the chunks of the
// support that can still hold a neighbour are scanned.
//
// Replaces amcontrast3d_tpu/ops/knn_pallas.py::_knn_kernel_big (reached
// from knn_pallas for N > 32768), the TPU kernel that streams the support
// in chunks and keeps the best two of every 128-wide bin per chunk, which
// is approximate by design.  This kernel returns exactly what knn.cu and
// the plain PyTorch twin (ops/knn.py::knn_plain) return, bit for bit: the
// k nearest in (d^2, index) order, ties to the lowest index, d^2 in the
// direct form (dx*dx + dy*dy) + dz*dz without FMA; for k > n the extra
// slots index 0 at d^2 = 1e10.
//
// What bounds it on the card: a dense scan is M * N distance tests of 9
// float instructions (2.2e11 for the self-kNN of a 155648-point room),
// instruction throughput; almost all of them are far outside the k-th
// distance.  Design (chunks.cuh, knn_topk.cuh): the support arrives sorted
// along a Morton curve in chunks of 64 points, each with its exact box,
// and the queries in Morton order too, so the 8 warps of a block read the
// same chunks.  One warp per query.  Phase 1 scans the three chunks around
// the query's own place in the sorted order, which leaves a k-th d^2 close
// to the final one.  Phase 2 tests the boxes of all chunks, one per lane,
// and scans a chunk only when its lower bound is not above the running
// k-th d^2.  A chunk is skipped when its bound is strictly greater: at
// equal d^2 it may still hold a lower index.  Candidates arrive out of
// index order, so the warp's k slots are kept in (d^2, index) order by
// WarpTopK::insert_pair and a candidate is taken when its pair is below
// the pair in slot k - 1.  Every k from 1 to 128 and any n, m >= 1.
#include "chunks.cuh"
#include "knn_topk.cuh"

namespace {

using namespace amc3d;

template <int KPL>
struct Search {
  WarpTopK<KPL> top;
  float thr_d;  // the pair in slot k - 1
  int thr_i;
  int k, lane;

  __device__ __forceinline__ bool better(float d, int i) const {
    return d < thr_d || (d == thr_d && i < thr_i);
  }

  // the whole warp scans chunk c of the sorted support
  __device__ __forceinline__ void scan(const float4* __restrict__ sup, int n,
                                       int c, float qx, float qy, float qz) {
    const int base = c * kChunk;
    const int len = min(kChunk, n - base);
    for (int u0 = 0; u0 < len; u0 += 32) {
      const int u = u0 + lane;
      float dd = CUDART_INF_F;
      int oi = 0;
      if (u < len) {
        const float4 p = sup[base + u];
        dd = point_d2(qx, qy, qz, p.x, p.y, p.z);
        oi = __float_as_int(p.w);
      }
      unsigned mask = __ballot_sync(kFullMask, u < len && better(dd, oi));
      while (mask) {
        const int src = __ffs(mask) - 1;
        mask &= mask - 1;
        const float nd = __shfl_sync(kFullMask, dd, src);
        const int ni = __shfl_sync(kFullMask, oi, src);
        if (better(nd, ni)) {  // slot k - 1 may have tightened in this step
          top.insert_pair(nd, ni, lane);
          thr_d = top.dist_at(k - 1);
          thr_i = top.index_at(k - 1);
        }
      }
    }
  }
};

template <int KPL>
__global__ void __launch_bounds__(kScanThreads)
knn_big_kernel(const float4* __restrict__ support,
               const float* __restrict__ boxes, const float* __restrict__ query,
               const int* __restrict__ order, const int* __restrict__ home,
               int n, int m, int k, int nc, int* __restrict__ idx_out,
               float* __restrict__ d2_out) {
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int rank = blockIdx.x * kScanWarps + (threadIdx.x >> 5);
  if (rank >= m) return;  // whole warps leave; no block-wide barrier follows
  const size_t qrow = static_cast<size_t>(b) * m;
  const int qi = order[qrow + rank];
  const float* q = query + (qrow + qi) * 3;
  const float qx = q[0], qy = q[1], qz = q[2];
  const float4* sup = support + static_cast<size_t>(b) * n;
  const float* box = boxes + static_cast<size_t>(b) * nc * 6;

  Search<KPL> s;
  s.top.init();
  s.thr_d = CUDART_INF_F;
  s.thr_i = 0;
  s.k = k;
  s.lane = lane;

  const int h = home[qrow + rank];
  const int near_lo = max(0, h - 1), near_hi = min(nc, h + 2);
  for (int c = near_lo; c < near_hi; ++c) s.scan(sup, n, c, qx, qy, qz);

  for (int c0 = 0; c0 < nc; c0 += 32) {
    const int c = c0 + lane;
    float lb = CUDART_INF_F;
    if (c < nc && (c < near_lo || c >= near_hi))
      lb = box_lower_bound(qx, qy, qz, box + static_cast<size_t>(c) * 6);
    // lb == +inf marks no chunk; thr_d == +inf (fewer than k kept) takes all
    unsigned mask = __ballot_sync(kFullMask,
                                  lb < CUDART_INF_F && !(lb > s.thr_d));
    while (mask) {
      const int src = __ffs(mask) - 1;
      mask &= mask - 1;
      const float clb = __shfl_sync(kFullMask, lb, src);
      if (!(clb > s.thr_d)) s.scan(sup, n, c0 + src, qx, qy, qz);
    }
  }

  const size_t row = (qrow + qi) * k;
#pragma unroll
  for (int r = 0; r < KPL; ++r) {
    const int slot = lane + 32 * r;
    if (slot < k) {
      // slots past the n support points: index 0 at 1e10
      idx_out[row + slot] = slot < n ? s.top.i[r] : 0;
      d2_out[row + slot] = slot < n ? s.top.d[r] : 1e10f;
    }
  }
}

}  // namespace

// support (b, n) float4: the sorted points with their original index in w;
// boxes (b, nc, 6) float32, nc = ceil(n / 64); query (b, m, 3) float32;
// order (b, m) int32: the queries in the order they are worked on; home
// (b, m) int32: per entry of order, the chunk to start from; 1 <= k <= 128
// -> idx_out (b, m, k) int32, d2_out (b, m, k) float32, rows in the
// caller's query order.
extern "C" int amc3d_knn_big(const void* support, const void* boxes,
                             const void* query, const void* order,
                             const void* home, void* idx_out, void* d2_out,
                             int b, int n, int m, int k, void* stream) {
  const int nc = (n + kChunk - 1) / kChunk;
  const dim3 grid((m + kScanWarps - 1) / kScanWarps, b);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* s = static_cast<const float4*>(support);
  const auto* bx = static_cast<const float*>(boxes);
  const auto* q = static_cast<const float*>(query);
  const auto* od = static_cast<const int*>(order);
  const auto* hm = static_cast<const int*>(home);
  auto* io = static_cast<int*>(idx_out);
  auto* dout = static_cast<float*>(d2_out);
  switch (slots_per_lane(k)) {
    case 1: knn_big_kernel<1><<<grid, kScanThreads, 0, st>>>(s, bx, q, od, hm, n, m, k, nc, io, dout); break;
    case 2: knn_big_kernel<2><<<grid, kScanThreads, 0, st>>>(s, bx, q, od, hm, n, m, k, nc, io, dout); break;
    case 4: knn_big_kernel<4><<<grid, kScanThreads, 0, st>>>(s, bx, q, od, hm, n, m, k, nc, io, dout); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
