// Ball query in a large cloud: only the chunks of the support whose box
// reaches into the ball are scanned.
//
// Replaces amcontrast3d_tpu/ops/knn_pallas.py::_ball_kernel_value_big
// (reached from ball_query_pallas for N > 32768), the TPU kernel that
// sorts the support into coordinate slabs and the queries into Morton
// tiles, skips slab-tile pairs by a box-to-box bound and returns a random
// k-subset of an overfull ball.  This kernel returns exactly what
// ball_query.cu and the plain PyTorch twin (ops/knn.py::ball_query_plain)
// return: the first k support points in the caller's index order with
// d^2 < r^2, empty slots padded with the first hit, 0 for an empty ball,
// k > n allowed; d^2 = (dx*dx + dy*dy) + dz*dz rounded op by op.
//
// What bounds it on the card: a dense scan is M * N distance tests
// (6e9 for the 38912 queries of a 155648-point room's first stage),
// instruction throughput, while a ball of radius 0.1 m reaches a few
// chunks of a room.  Design (chunks.cuh, knn_topk.cuh): the support
// arrives sorted along a Morton curve in chunks of 64 points with their
// exact boxes, the queries are worked on in Morton order so the 8 warps of
// a block read the same chunks, one warp per query.  The warp tests the
// boxes of all chunks, one per lane, and scans the chunks whose lower
// bound is below r^2.  Once the support is reordered, "the first k in
// index order" is no longer "the first k met": the warp keeps the k
// smallest original indices among all hits in its registers (the slots of
// WarpTopK in index order: a hit is the pair (0, index)) and refuses a hit
// whose index is not below slot k - 1.  Every k from 1 to 128.
#include <climits>

#include "chunks.cuh"
#include "knn_topk.cuh"

namespace {

using namespace amc3d;

template <int KPL>
__global__ void __launch_bounds__(kScanThreads)
ball_query_big_kernel(const float4* __restrict__ support,
                      const float* __restrict__ boxes,
                      const float* __restrict__ query,
                      const int* __restrict__ order, int n, int m, int k,
                      int nc, float r2, int* __restrict__ out) {
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

  WarpTopK<KPL> top;  // a kept hit is (0, index); a free slot (+inf, 0)
  top.init();
  int thr = INT_MAX;  // the index in slot k - 1 once k hits are kept

  for (int c0 = 0; c0 < nc; c0 += 32) {
    const int c = c0 + lane;
    unsigned mask = __ballot_sync(
        kFullMask,
        c < nc && box_lower_bound(qx, qy, qz,
                                  box + static_cast<size_t>(c) * 6) < r2);
    while (mask) {
      const int base = (c0 + __ffs(mask) - 1) * kChunk;
      mask &= mask - 1;
      const int len = min(kChunk, n - base);
      for (int u0 = 0; u0 < len; u0 += 32) {
        const int u = u0 + lane;
        bool hit = false;
        int oi = 0;
        if (u < len) {
          const float4 p = sup[base + u];
          oi = __float_as_int(p.w);
          hit = point_d2(qx, qy, qz, p.x, p.y, p.z) < r2 && oi < thr;
        }
        unsigned hits = __ballot_sync(kFullMask, hit);
        while (hits) {
          const int src = __ffs(hits) - 1;
          hits &= hits - 1;
          const int ni = __shfl_sync(kFullMask, oi, src);
          if (ni < thr) {  // slot k - 1 may have tightened in this step
            top.insert_pair(0.f, ni, lane);
            if (top.dist_at(k - 1) == 0.f) thr = top.index_at(k - 1);
          }
        }
      }
    }
  }

  const int first = top.index_at(0);  // 0 for an empty ball
  int* o = out + (qrow + qi) * k;
#pragma unroll
  for (int r = 0; r < KPL; ++r) {
    const int slot = lane + 32 * r;
    if (slot < k) o[slot] = top.d[r] == 0.f ? top.i[r] : first;
  }
}

}  // namespace

// support (b, n) float4: the sorted points with their original index in w;
// boxes (b, nc, 6) float32, nc = ceil(n / 64); query (b, m, 3) float32;
// order (b, m) int32: the queries in the order they are worked on;
// 1 <= k <= 128; r2 is r^2 rounded to float32
// -> out (b, m, k) int32, rows in the caller's query order.
extern "C" int amc3d_ball_query_big(const void* support, const void* boxes,
                                    const void* query, const void* order,
                                    void* out, int b, int n, int m, int k,
                                    float r2, void* stream) {
  const int nc = (n + kChunk - 1) / kChunk;
  const dim3 grid((m + kScanWarps - 1) / kScanWarps, b);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* s = static_cast<const float4*>(support);
  const auto* bx = static_cast<const float*>(boxes);
  const auto* q = static_cast<const float*>(query);
  const auto* od = static_cast<const int*>(order);
  int* o = static_cast<int*>(out);
  switch (slots_per_lane(k)) {
    case 1: ball_query_big_kernel<1><<<grid, kScanThreads, 0, st>>>(s, bx, q, od, n, m, k, nc, r2, o); break;
    case 2: ball_query_big_kernel<2><<<grid, kScanThreads, 0, st>>>(s, bx, q, od, n, m, k, nc, r2, o); break;
    case 4: ball_query_big_kernel<4><<<grid, kScanThreads, 0, st>>>(s, bx, q, od, n, m, k, nc, r2, o); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
