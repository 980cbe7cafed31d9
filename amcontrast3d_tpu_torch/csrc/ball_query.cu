// Ball query: the first k support points in index order with d^2 < r^2,
// scanning only the chunks of a Morton-sorted support that reach into a
// ball.
//
// Replaces amcontrast3d_tpu/ops/knn_pallas.py::_ball_kernel_value, the
// value-only TPU ball query, and ::_ball_kernel_value_big, which the JAX
// package takes above _BIG_N = 32768 support points.  Both keep a random
// k-subset of an overfull ball (the best two in-ball points per 128-point
// bin of a fixed support permutation; the large one over coordinate slabs
// and Morton tiles).  This kernel keeps the semantics of the JAX plain path
// (ops/knn.py::_ball_query_jnp) and of the reference CUDA ball_query_gpu.cu
// instead, bit for bit what the plain PyTorch twin (ops/knn.py::
// ball_query_plain) returns: the first k hits in index order, empty slots
// padded with the first hit, an empty ball giving 0, k > n allowed;
// d^2 = (dx*dx + dy*dy) + dz*dz rounded op by op (-fmad=false, __f*_rn), a
// hit strictly below r^2 rounded once to float32.
//
// What bounds it on the card: a dense scan is M * N distance tests of 9
// float instructions wherever a ball holds fewer than k points (most balls
// of a uniform cloud at the encoder's radii), instruction throughput,
// while a ball reaches a few 64-point chunks of its cloud.  Design, that of
// knn.cu (chunk_list.cuh): the support arrives as its stage cloud's layout
// (ops/spatial.py, sorted once a forward), the queries in Morton order: for
// the shared ball query of a stage the support's own order, for a set
// abstraction the query stage's own layout (its points along its own
// curve), else ops/spatial.py::query_order.  A block takes 8 queries that
// are consecutive along the curve, a warp each, and tests every chunk's
// box once against the union box of the 8 and r^2; the chunks that pass
// form a list in shared memory.  Each warp then tests the listed boxes
// against its own query, 32 at a time, and scans only the chunks whose box
// reaches into its ball.  Every bound is a float32 lower bound on the d^2
// of the points it stands for (chunks.cuh), so a chunk is skipped only
// when none of its points can be a hit, with no cushion.  The chunks come
// in Morton order, so "the first k in index order" is no longer "the first
// k met": the warp keeps the k smallest original indices among its hits in
// registers (knn_topk.cuh's slots, a hit is the pair (0, index); many hits
// at once merge in one bitonic step) and refuses a hit whose index is not
// below slot k - 1.  Up to 128 slots a launch; a larger k is taken in
// passes (ops/knn.py), each keeping the next hits strictly after the
// previous pass's last slot, which the kernel reads from the output row
// (a slot equal to the row's first is padding: the ball holds no more).
#include <climits>

#include "chunk_list.cuh"
#include "chunk_search.cuh"

namespace {

using namespace amc3d;

// The k smallest original indices among the hits a warp met, with LOWER
// only those above `lo`: the slots of WarpTopK as pairs (0, index), a free
// slot (+inf, 0).
template <int KPL, bool LOWER>
struct BallHits {
  WarpTopK<KPL> top;
  int thr;  // the index in slot k - 1 once k hits are kept, else INT_MAX
  int lo;
  int k, lane;

  __device__ __forceinline__ void init(int k_, int lane_, int lo_) {
    top.init();
    thr = INT_MAX;
    lo = lo_;
    k = k_;
    lane = lane_;
  }

  __device__ __forceinline__ bool wants(int oi) const {
    return oi < thr && (!LOWER || oi > lo);
  }

  __device__ __forceinline__ void tighten() {
    if (top.dist_at(k - 1) == 0.f) thr = top.index_at(k - 1);
  }

  // the whole warp scans chunk c of the sorted support
  __device__ __forceinline__ void scan(const float4* __restrict__ sup, int n,
                                       int c, float qx, float qy, float qz,
                                       float r2) {
    const int base = c * kChunk;
    const int len = min(kChunk, n - base);
    for (int u0 = 0; u0 < len; u0 += 32) {
      const int u = u0 + lane;
      bool hit = false;
      int oi = 0;
      if (u < len) {
        const float4 p = sup[base + u];
        oi = __float_as_int(p.w);
        hit = point_d2(qx, qy, qz, p.x, p.y, p.z) < r2 && wants(oi);
      }
      unsigned hits = __ballot_sync(kFullMask, hit);
      if constexpr (KPL == 1) {
        if (__popc(hits) > kMergeAbove) {  // many at once: merge them
          top.merge_lanes(0.f, oi, hit, lane);
          tighten();
          continue;
        }
      }
      while (hits) {
        const int src = __ffs(hits) - 1;
        hits &= hits - 1;
        const int ni = __shfl_sync(kFullMask, oi, src);
        if (wants(ni)) {  // slot k - 1 may have tightened in this step
          top.insert_pair(0.f, ni, lane);
          tighten();
        }
      }
    }
  }
};

// LOWER: a later pass (first > 0), after the index in slot first - 1.
// order == nullptr: the queries are qsorted (x, y, z and the bits of the
// query's index in w) in the order they are worked on; else query (b, m, 3)
// taken in the order of order (b, m).
template <int KPL, bool LOWER>
__global__ void __launch_bounds__(kListThreads)
ball_query_kernel(const float4* __restrict__ support,
                  const float* __restrict__ boxes,
                  const float4* __restrict__ qsorted,
                  const float* __restrict__ query,
                  const int* __restrict__ order, int n, int m, int k, int ld,
                  int first, int nc, float r2, int* __restrict__ out) {
  __shared__ int list[kListChunks];
  __shared__ float spts[kListWarps][3];
  __shared__ int counts[kListWarps];
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rank = blockIdx.x * kListWarps + warp;
  const bool active = rank < m;
  const size_t qrow = static_cast<size_t>(b) * m;
  const float4* sup = support + static_cast<size_t>(b) * n;
  const float* bx = boxes + static_cast<size_t>(b) * nc * 6;

  float qx = 0.f, qy = 0.f, qz = 0.f;
  int qi = 0;
  if (active) {
    if (order == nullptr) {
      const float4 p = qsorted[qrow + rank];
      qx = p.x;
      qy = p.y;
      qz = p.z;
      qi = __float_as_int(p.w);
    } else {
      qi = order[qrow + rank];
      const float* q = query + (qrow + qi) * 3;
      qx = q[0];
      qy = q[1];
      qz = q[2];
    }
  }
  int* row = out + (qrow + qi) * ld;  // slot 0 of the query's row
  // a later pass: the row's first hit pads it, and a previous last slot
  // equal to it was padding already, so the ball holds no more
  int pad = 0, lo = 0;
  bool more = active;
  if (LOWER && active) {
    pad = row[0];
    lo = row[first - 1];
    more = lo != pad;
  }
  if (lane == 0) {
    spts[warp][0] = qx;
    spts[warp][1] = qy;
    spts[warp][2] = qz;
  }
  __syncthreads();
  float ub[6];
  union_box(spts, min(kListWarps, m - static_cast<int>(blockIdx.x) * kListWarps),
            ub);
  auto near = [&](int c) {
    return box_box_lower_bound(ub, bx + static_cast<size_t>(c) * 6) < r2;
  };

  BallHits<KPL, LOWER> hits;
  hits.init(k, lane, lo);
  for (int w0 = 0; w0 < nc; w0 += kListChunks) {
    const int total = block_list(w0, nc, near, list, counts);
    if (!more) continue;
    for (int t0 = 0; t0 < total; t0 += 32) {
      const int t = t0 + lane;
      int c = 0;
      bool want = false;
      if (t < total) {
        c = list[t];
        want = box_lower_bound(qx, qy, qz, bx + static_cast<size_t>(c) * 6) < r2;
      }
      unsigned mask = __ballot_sync(kFullMask, want);
      while (mask) {
        const int src = __ffs(mask) - 1;
        mask &= mask - 1;
        hits.scan(sup, n, __shfl_sync(kFullMask, c, src), qx, qy, qz, r2);
      }
    }
  }

  if (!active) return;  // whole warps: a warp's lanes share one query
  if (!LOWER) pad = hits.top.index_at(0);  // 0 for an empty ball
#pragma unroll
  for (int r = 0; r < KPL; ++r) {
    const int slot = lane + 32 * r;
    if (slot < k) row[first + slot] = hits.top.d[r] == 0.f ? hits.top.i[r] : pad;
  }
}

}  // namespace

// support (b, n) float4: the sorted points with their original index in w;
// boxes (b, nc, 6) float32, nc = ceil(n / 64); the queries either as
// qsorted (b, m) float4 in the order they are worked on, with their index
// in w (order null), or as query (b, m, 3) float32 with order (b, m) int32;
// 1 <= k <= 128 slots of each (b, m) row of ld int32 entries of out, rows in
// the caller's query order: the hits first .. first + k - 1 in index order;
// for first > 0 the row's slots 0 .. first - 1 hold the previous passes'.
// r2 is r^2 rounded to float32.
extern "C" int amc3d_ball_query(const void* support, const void* boxes,
                                const void* qsorted, const void* query,
                                const void* order, void* out, int b, int n,
                                int m, int k, int ld, int first, float r2,
                                void* stream) {
  const int nc = (n + kChunk - 1) / kChunk;
  const dim3 grid((m + kListWarps - 1) / kListWarps, b);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* s = static_cast<const float4*>(support);
  const auto* bx = static_cast<const float*>(boxes);
  const auto* qs = static_cast<const float4*>(qsorted);
  const auto* q = static_cast<const float*>(query);
  const auto* od = static_cast<const int*>(order);
  auto* o = static_cast<int*>(out);
  if (ld < first + k || first < 0 || reinterpret_cast<size_t>(support) % 16 ||
      (order == nullptr &&
       (qsorted == nullptr || reinterpret_cast<size_t>(qsorted) % 16)) ||
      (order != nullptr && query == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  using Kernel = void (*)(const float4*, const float*, const float4*,
                          const float*, const int*, int, int, int, int, int,
                          int, float, int*);
  Kernel kernel = nullptr;
  switch (slots_per_lane(k)) {
    case 1: kernel = first > 0 ? ball_query_kernel<1, true> : ball_query_kernel<1, false>; break;
    case 2: kernel = first > 0 ? ball_query_kernel<2, true> : ball_query_kernel<2, false>; break;
    case 4: kernel = first > 0 ? ball_query_kernel<4, true> : ball_query_kernel<4, false>; break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  kernel<<<grid, kListThreads, 0, st>>>(s, bx, qs, q, od, n, m, k, ld, first,
                                        nc, r2, o);
  return static_cast<int>(cudaGetLastError());
}
