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
// distance.  Design (chunks.cuh, chunk_search.cuh, shared with
// interpolate_big.cu): the support arrives sorted along a Morton curve in
// chunks of 64 points, each with its exact box, and the queries in Morton
// order too, so the 8 warps of a block read the same chunks.  One warp per
// query.  Phase 1 scans the chunks around the query's own place in the
// sorted order, which leaves a k-th d^2 close to the final one.  Phase 2
// tests the boxes of all chunks, one per lane, and scans a chunk only when
// its lower bound is not above the running k-th d^2.  Candidates arrive out
// of index order, so the warp's slots are kept in (d^2, index) order and a
// candidate is taken when its pair is below the pair in slot k - 1.  Up to
// 128 slots a launch; a larger k is taken in passes (ops/knn.py), each
// keeping the next slots strictly after the previous pass's last pair,
// which the kernel reads from the output row just before its first slot;
// a later pass starts from more chunks around the query's home.  Any
// n, m >= 1.
#include "chunk_search.cuh"

namespace {

using namespace amc3d;

// LOWER: a later pass (first > 0), after the pair in slot first - 1
template <int KPL, bool LOWER>
__global__ void __launch_bounds__(kScanThreads)
knn_big_kernel(const float4* __restrict__ support,
               const float* __restrict__ boxes, const float* __restrict__ query,
               const int* __restrict__ order, const int* __restrict__ home,
               int n, int m, int k, int ld, int first, int nc,
               int* __restrict__ idx_out, float* __restrict__ d2_out) {
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int rank = blockIdx.x * kScanWarps + (threadIdx.x >> 5);
  if (rank >= m) return;  // whole warps leave; no block-wide barrier follows
  const size_t qrow = static_cast<size_t>(b) * m;
  const int qi = order[qrow + rank];
  const float* q = query + (qrow + qi) * 3;
  const size_t row = (qrow + qi) * ld;

  ChunkSearch<KPL, LOWER> s;
  if (LOWER)  // after the previous pass's last pair
    s.init(k, lane, CUDART_INF_F, d2_out[row - 1], idx_out[row - 1]);
  else
    s.init(k, lane, CUDART_INF_F);
  s.search(support + static_cast<size_t>(b) * n,
           boxes + static_cast<size_t>(b) * nc * 6, n, nc, home[qrow + rank],
           1 + first / kChunk, q[0], q[1], q[2]);
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
// order (b, m) int32: the queries in the order they are worked on; home
// (b, m) int32: per entry of order, the chunk to start from; 1 <= k <= 128
// -> k slots of each (b, m) row of ld entries of idx_out (int32) and d2_out
// (float32), rows in the caller's query order: the neighbours first ..
// first + k - 1; for first > 0 the slot just before them holds the
// previous pass's last pair.
extern "C" int amc3d_knn_big(const void* support, const void* boxes,
                             const void* query, const void* order,
                             const void* home, void* idx_out, void* d2_out,
                             int b, int n, int m, int k, int ld, int first,
                             void* stream) {
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
  if (ld < k || first < 0) return static_cast<int>(cudaErrorInvalidValue);
  using Kernel = void (*)(const float4*, const float*, const float*,
                          const int*, const int*, int, int, int, int, int, int,
                          int*, float*);
  Kernel kernel = nullptr;
  switch (slots_per_lane(k)) {
    case 1: kernel = first > 0 ? knn_big_kernel<1, true> : knn_big_kernel<1, false>; break;
    case 2: kernel = first > 0 ? knn_big_kernel<2, true> : knn_big_kernel<2, false>; break;
    case 4: kernel = first > 0 ? knn_big_kernel<4, true> : knn_big_kernel<4, false>; break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  kernel<<<grid, kScanThreads, 0, st>>>(s, bx, q, od, hm, n, m, k, ld, first,
                                        nc, io, dout);
  return static_cast<int>(cudaGetLastError());
}
