// Exact k nearest neighbours in a cloud of any size: indices and d^2 in
// ascending order, scanning only the chunks of a Morton-sorted support that
// can hold a neighbour.
//
// Replaces amcontrast3d_tpu/ops/knn_pallas.py::_knn_kernel (entry
// knn_pallas) and ::_knn_kernel_big, which the JAX package takes above
// _BIG_N support points; on the H100 this kernel is within a few per cent of
// a warp-per-query search over every box (the large-cloud kernel's design)
// below that size and ahead above it, by a third at a room (PERF.md).  The TPU kernel keeps the best two points of every 128-wide
// bin of a permuted support and extracts k from that pool, a shape its
// vector lanes force and approximate by design.  This kernel is exact: the
// k nearest in (d^2, index) order, ties to the lowest index, d^2 in the
// direct form (dx*dx + dy*dy) + dz*dz without FMA, bit for bit what the
// plain PyTorch twin (ops/knn.py::knn_plain, a stable top-k over the same
// d^2) returns; for k > n the extra slots index 0 at d^2 = 1e10.
//
// What bounds it on the card: a dense scan is M * N distance tests of 9
// float instructions (2.3 G tests for the self-kNN of 4 clouds of 24000
// points), instruction throughput, though only the ~k nearest of each query
// matter.  Design: the support arrives sorted along a Morton curve in
// chunks of 64 points with exact boxes (ops/spatial.py: one layout a stage
// cloud, shared with the loss's other kernels), the queries in Morton order
// (for the self-kNN the support's own order, read from the layout itself:
// no second sort, no order array).  A block takes 8 queries that are
// consecutive along the curve, one warp each (chunk_list.cuh).  Before any
// scan the block tests every chunk's box once against the union box of its
// queries and a limit no query's k-th can exceed: the largest upper bound
// (chunks.cuh::box_upper_bound) of each query to the chunks around its home,
// which hold k points; so the block meets at one barrier and the warps then
// run apart.  Each warp scans its home chunk, then the chunks beside it
// (chunk_search.cuh), which leaves a k-th d^2 near the final one, then tests
// the listed boxes against its own k-th, one a lane, and scans what passes.
// Candidates arrive out of index order, so the slots are kept in (d^2,
// index) order (WarpTopK::insert_pair, or merge_lanes for many at once) and
// a candidate is taken when its pair is below slot k - 1.  No tensor cores:
// membership must be exact in the direct form.  Measured on the H100
// (PERF.md), staging the listed chunks in shared memory through a ring of
// bulk asynchronous copies was slower than this: every warp then waits on
// every listed chunk in turn, where here it tests 32 boxes at once and
// reads the few chunks it needs through L1.  Up to 128 slots a launch; a
// larger k is taken in passes (ops/knn.py), each keeping the next slots
// strictly after the previous pass's last pair, which the kernel reads from
// the output row just before its first slot.  Any n, m >= 1.
#include "chunk_list.cuh"
#include "chunk_search.cuh"

namespace {

using namespace amc3d;

static_assert(kScanWarps == kListWarps, "a warp a query");

// LOWER: a later pass (first > 0), after the pair in slot first - 1.
// order == nullptr: the queries are the support, in its sorted order.
template <int KPL, bool LOWER>
__global__ void __launch_bounds__(kListThreads)
knn_kernel(const float4* __restrict__ support, const float* __restrict__ boxes,
           const float* __restrict__ query, const int* __restrict__ order,
           const int* __restrict__ home, int n, int m, int k, int ld,
           int first, int nc, int* __restrict__ idx_out,
           float* __restrict__ d2_out) {
  __shared__ int list[kListChunks];
  __shared__ float spts[kListWarps][3];
  __shared__ float slimit[kListWarps];
  __shared__ int snear[kListWarps][2];
  __shared__ int counts[kListWarps];
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rank = blockIdx.x * kListWarps + warp;
  const bool active = rank < m;
  const size_t qrow = static_cast<size_t>(b) * m;
  const float4* sup = support + static_cast<size_t>(b) * n;
  const float* bx = boxes + static_cast<size_t>(b) * nc * 6;

  float qx = 0.f, qy = 0.f, qz = 0.f;
  size_t row = 0;
  int h = 0, near_lo = 0, near_hi = nc;  // an idle warp excludes nothing
  float limit = -1.f;                   // and admits nothing
  if (active) {
    int qi;
    if (order == nullptr) {
      const float4 p = sup[rank];
      qx = p.x;
      qy = p.y;
      qz = p.z;
      qi = __float_as_int(p.w);
      h = rank / kChunk;
    } else {
      qi = order[qrow + rank];
      const float* q = query + (qrow + qi) * 3;
      qx = q[0];
      qy = q[1];
      qz = q[2];
      h = home[qrow + rank];
    }
    row = (qrow + qi) * ld;
    const int near = 1 + first / kChunk;
    near_lo = max(0, h - near);
    near_hi = min(nc, h + near + 1);
    // the pass's last slot is the (first + k)-th nearest: within the upper
    // bound of chunks that hold that many points
    limit = CUDART_INF_F;
    if (min(n, near_hi * kChunk) - near_lo * kChunk >= first + k) {
      limit = 0.f;
      for (int c = near_lo; c < near_hi; ++c)
        limit = fmaxf(limit, box_upper_bound(qx, qy, qz,
                                             bx + static_cast<size_t>(c) * 6));
    }
  }
  if (lane == 0) {
    spts[warp][0] = qx;
    spts[warp][1] = qy;
    spts[warp][2] = qz;
    slimit[warp] = limit;
    snear[warp][0] = near_lo;
    snear[warp][1] = near_hi;
  }
  __syncthreads();
  // the union box of the block's queries, the largest limit among them, and
  // the chunks every warp scans first
  const int warps = min(kListWarps, m - static_cast<int>(blockIdx.x) * kListWarps);
  float ub[6];
  union_box(spts, warps, ub);
  float block_limit = -1.f;
  int done_lo = 0, done_hi = nc;
  for (int w = 0; w < warps; ++w) {
    block_limit = fmaxf(block_limit, slimit[w]);
    done_lo = max(done_lo, snear[w][0]);
    done_hi = min(done_hi, snear[w][1]);
  }
  auto needed = [&](int c) {
    return (c < done_lo || c >= done_hi) &&
           !(box_box_lower_bound(ub, bx + static_cast<size_t>(c) * 6) > block_limit);
  };

  ChunkSearch<KPL, LOWER> s;
  s.init(k, lane, CUDART_INF_F);
  if (LOWER && active)  // after the previous pass's last pair
    s.init(k, lane, CUDART_INF_F, d2_out[row - 1], idx_out[row - 1]);
  for (int w0 = 0; w0 < nc; w0 += kListChunks) {
    const int total = block_list(w0, nc, needed, list, counts);
    if (!active) continue;
    if (w0 == 0) {  // phase 1: the home chunk, then the ones beside it
      s.scan(sup, n, h, qx, qy, qz);
      for (int d = 1; d <= h - near_lo || h + d < near_hi; ++d) {
        if (h - d >= near_lo) s.scan(sup, n, h - d, qx, qy, qz);
        if (h + d < near_hi) s.scan(sup, n, h + d, qx, qy, qz);
      }
    }
    // phase 2: the listed chunks within this warp's own k-th
    for (int t0 = 0; t0 < total; t0 += 32) {
      const int t = t0 + lane;
      int c = 0;
      float lb = CUDART_INF_F;  // +inf marks no chunk
      if (t < total) {
        c = list[t];
        if (c < near_lo || c >= near_hi)
          lb = box_lower_bound(qx, qy, qz, bx + static_cast<size_t>(c) * 6);
      }
      unsigned mask = __ballot_sync(kFullMask, lb < CUDART_INF_F && !(lb > s.thr_d));
      while (mask) {
        const int src = __ffs(mask) - 1;
        mask &= mask - 1;
        const float clb = __shfl_sync(kFullMask, lb, src);
        const int cc = __shfl_sync(kFullMask, c, src);
        if (!(clb > s.thr_d)) s.scan(sup, n, cc, qx, qy, qz);
      }
    }
  }

  if (!active) return;
#pragma unroll
  for (int r = 0; r < KPL; ++r) {
    const int slot = lane + 32 * r;
    if (slot < k) {
      // slots past the n support points: index 0 at 1e10
      const bool real = first + slot < n;
      idx_out[row + slot] = real ? s.top.i[r] : 0;
      d2_out[row + slot] = real ? s.top.d[r] : 1e10f;
    }
  }
}

}  // namespace

// support (b, n) float4: the sorted points with their original index in w;
// boxes (b, nc, 6) float32, nc = ceil(n / 64); query (b, m, 3) float32;
// order (b, m) int32: the queries in Morton order; home (b, m) int32: per
// entry of order, the chunk to start from (order and home null: the queries
// are the support, m = n, in its sorted order); 1 <= k <= 128 -> k slots of
// each (b, m) row of ld entries of idx_out (int32) and d2_out (float32),
// rows in the caller's query order: the neighbours first .. first + k - 1;
// for first > 0 the slot just before them holds the previous pass's last
// pair.
extern "C" int amc3d_knn(const void* support, const void* boxes,
                         const void* query, const void* order,
                         const void* home, void* idx_out, void* d2_out, int b,
                         int n, int m, int k, int ld, int first, void* stream) {
  const int nc = (n + kChunk - 1) / kChunk;
  const dim3 grid((m + kListWarps - 1) / kListWarps, b);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* s = static_cast<const float4*>(support);
  const auto* bx = static_cast<const float*>(boxes);
  const auto* q = static_cast<const float*>(query);
  const auto* od = static_cast<const int*>(order);
  const auto* hm = static_cast<const int*>(home);
  auto* io = static_cast<int*>(idx_out);
  auto* dout = static_cast<float*>(d2_out);
  if (ld < k || first < 0 || reinterpret_cast<size_t>(support) % 16 ||
      (order == nullptr) != (home == nullptr) || (order == nullptr && m != n))
    return static_cast<int>(cudaErrorInvalidValue);
  using Kernel = void (*)(const float4*, const float*, const float*,
                          const int*, const int*, int, int, int, int, int, int,
                          int*, float*);
  Kernel kernel = nullptr;
  switch (slots_per_lane(k)) {
    case 1: kernel = first > 0 ? knn_kernel<1, true> : knn_kernel<1, false>; break;
    case 2: kernel = first > 0 ? knn_kernel<2, true> : knn_kernel<2, false>; break;
    case 4: kernel = first > 0 ? knn_kernel<4, true> : knn_kernel<4, false>; break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  kernel<<<grid, kListThreads, 0, st>>>(s, bx, q, od, hm, n, m, k, ld, first,
                                        nc, io, dout);
  return static_cast<int>(cudaGetLastError());
}
