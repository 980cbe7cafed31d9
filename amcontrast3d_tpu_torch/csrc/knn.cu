// Exact k nearest neighbours in a cloud of any size: indices and d^2 in
// ascending order, scanning only the chunks of a Morton-sorted support that
// can hold a neighbour.
//
// Replaces amcontrast3d_tpu/ops/knn_pallas.py::_knn_kernel (entry
// knn_pallas) and ::_knn_kernel_big, which the JAX package takes above
// _BIG_N support points; on the H100 this kernel is within a few per cent of
// a warp-per-query search over every box (the large-cloud kernel's design)
// below that size and ahead above it, by a third at a room (PERF.md).  The
// TPU kernel keeps the best two points of every 128-wide bin of a
// permuted support and extracts k from that pool, a shape its vector lanes
// force and approximate by design.  This kernel is exact: the
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
// no second sort, no order array).  The scan is listed_knn.cuh's, which
// refine.cu's CrossMask forward shares.  A block takes 8 queries that are
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
#include "listed_knn.cuh"

namespace {

using namespace amc3d;

// LOWER: a later pass (first > 0), after the pair in slot first - 1.
// order == nullptr: the queries are the support, in its sorted order.
template <int KPL, bool LOWER>
__global__ void __launch_bounds__(kListThreads)
knn_kernel(const float4* __restrict__ support, const float* __restrict__ boxes,
           const float* __restrict__ query, const int* __restrict__ order,
           const int* __restrict__ home, int n, int m, int k, int ld,
           int first, int nc, int* __restrict__ idx_out,
           float* __restrict__ d2_out) {
  __shared__ ListedShared sh;
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const float4* sup = support + static_cast<size_t>(b) * n;
  const ListedQuery q = listed_query(sup, query, order, home, b, m);
  const size_t row = (static_cast<size_t>(b) * m + q.qi) * ld;
  ChunkSearch<KPL, LOWER> s;
  s.init(k, lane, CUDART_INF_F);
  if (LOWER && q.active)  // after the previous pass's last pair
    s.init(k, lane, CUDART_INF_F, d2_out[row - 1], idx_out[row - 1]);
  listed_knn(sup, boxes + static_cast<size_t>(b) * nc * 6, n, nc, k, first,
             min(kListWarps, m - static_cast<int>(blockIdx.x) * kListWarps),
             q, sh, s);

  if (!q.active) return;
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
