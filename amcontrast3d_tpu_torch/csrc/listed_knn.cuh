// The listed exact kNN scan of a block of queries, one query a warp: the
// device code shared by knn.cu (kernels 6 and 7) and refine.cu's CrossMask
// forward (kernel 18), as for_each_member serves contrast.cu's three kernels.
//
// A block takes kListWarps queries that are consecutive along the support's
// Morton curve (chunk_list.cuh).  Before any scan the block tests every
// chunk's box once against the union box of its queries and a limit no
// query's k-th can exceed: the largest upper bound (chunks.cuh::
// box_upper_bound) of each query to the chunks around its home, which hold
// k points; so the block meets at one barrier a window and the warps then
// run apart.  Each warp scans its home chunk, then the chunks beside it
// (chunk_search.cuh), which leaves a k-th d^2 near the final one, then tests
// the listed boxes against its own running k-th, one a lane, and scans what
// passes.  The slots end in (d^2, index) order whatever the order of the
// chunks, ties to the lowest index: bit for bit what a stable top-k of the
// same d^2 keeps.
#pragma once
#include <math_constants.h>

#include "chunk_list.cuh"
#include "chunk_search.cuh"

namespace amc3d {

static_assert(kScanWarps == kListWarps, "a warp a query");

// The shared memory of one listed scan; the kernel declares it.
struct ListedShared {
  int list[kListChunks];
  float pts[kListWarps][3];
  float limit[kListWarps];
  int near[kListWarps][2];
  int counts[kListWarps];
};

// The warp's query: its index in the caller's order, its position and the
// chunk of the support it starts from.
struct ListedQuery {
  bool active;  // the last block may hold fewer than kListWarps queries
  int qi;
  float x, y, z;
  int home;
};

// The query of this warp, from the block's place among the m queries of
// batch row b: order == nullptr means the queries are the support itself
// (m == n) in its sorted order, so position, index and home chunk come from
// the layout; else order and home (b, m) name them in Morton order.
__device__ __forceinline__ ListedQuery listed_query(
    const float4* __restrict__ sup, const float* __restrict__ query,
    const int* __restrict__ order, const int* __restrict__ home, int b,
    int m) {
  const int rank = blockIdx.x * kListWarps + (threadIdx.x >> 5);
  ListedQuery q{rank < m, 0, 0.f, 0.f, 0.f, 0};
  if (!q.active) return q;
  const size_t qrow = static_cast<size_t>(b) * m;
  if (order == nullptr) {
    const float4 p = sup[rank];
    q.x = p.x;
    q.y = p.y;
    q.z = p.z;
    q.qi = __float_as_int(p.w);
    q.home = rank / kChunk;
  } else {
    q.qi = order[qrow + rank];
    const float* p = query + (qrow + q.qi) * 3;
    q.x = p[0];
    q.y = p[1];
    q.z = p[2];
    q.home = home[qrow + rank];
  }
  return q;
}

// The warp's k nearest (with LOWER the slots first .. first + k - 1, after
// the pair `s` was initialised with) of the n support points `sup` (sorted,
// nc chunks with boxes `bx`) into s.top.  `s` comes initialised by the
// caller.  Every thread of the block calls it (block_list's barriers); a
// warp whose query is not active keeps nothing.  `warps`: the block's
// active queries.
template <int KPL, bool LOWER>
__device__ __forceinline__ void listed_knn(const float4* __restrict__ sup,
                                           const float* __restrict__ bx,
                                           int n, int nc, int k, int first,
                                           int warps, const ListedQuery& q,
                                           ListedShared& sh,
                                           ChunkSearch<KPL, LOWER>& s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int near_lo = 0, near_hi = nc;  // an idle warp excludes nothing
  float limit = -1.f;             // and admits nothing
  if (q.active) {
    const int near = 1 + first / kChunk;
    near_lo = max(0, q.home - near);
    near_hi = min(nc, q.home + near + 1);
    // the pass's last slot is the (first + k)-th nearest: within the upper
    // bound of chunks that hold that many points
    limit = CUDART_INF_F;
    if (min(n, near_hi * kChunk) - near_lo * kChunk >= first + k) {
      limit = 0.f;
      for (int c = near_lo; c < near_hi; ++c)
        limit = fmaxf(limit, box_upper_bound(q.x, q.y, q.z,
                                             bx + static_cast<size_t>(c) * 6));
    }
  }
  if (lane == 0) {
    sh.pts[warp][0] = q.x;
    sh.pts[warp][1] = q.y;
    sh.pts[warp][2] = q.z;
    sh.limit[warp] = limit;
    sh.near[warp][0] = near_lo;
    sh.near[warp][1] = near_hi;
  }
  __syncthreads();
  // the union box of the block's queries, the largest limit among them, and
  // the chunks every warp scans first
  float ub[6];
  union_box(sh.pts, warps, ub);
  float block_limit = -1.f;
  int done_lo = 0, done_hi = nc;
  for (int w = 0; w < warps; ++w) {
    block_limit = fmaxf(block_limit, sh.limit[w]);
    done_lo = max(done_lo, sh.near[w][0]);
    done_hi = min(done_hi, sh.near[w][1]);
  }
  auto needed = [&](int c) {
    return (c < done_lo || c >= done_hi) &&
           !(box_box_lower_bound(ub, bx + static_cast<size_t>(c) * 6) > block_limit);
  };

  for (int w0 = 0; w0 < nc; w0 += kListChunks) {
    const int total = block_list(w0, nc, needed, sh.list, sh.counts);
    if (!q.active) continue;
    const int h = q.home;
    if (w0 == 0) {  // phase 1: the home chunk, then the ones beside it
      s.scan(sup, n, h, q.x, q.y, q.z);
      for (int d = 1; d <= h - near_lo || h + d < near_hi; ++d) {
        if (h - d >= near_lo) s.scan(sup, n, h - d, q.x, q.y, q.z);
        if (h + d < near_hi) s.scan(sup, n, h + d, q.x, q.y, q.z);
      }
    }
    // phase 2: the listed chunks within this warp's own k-th
    for (int t0 = 0; t0 < total; t0 += 32) {
      const int t = t0 + lane;
      int c = 0;
      float lb = CUDART_INF_F;  // +inf marks no chunk
      if (t < total) {
        c = sh.list[t];
        if (c < near_lo || c >= near_hi)
          lb = box_lower_bound(q.x, q.y, q.z, bx + static_cast<size_t>(c) * 6);
      }
      unsigned mask = __ballot_sync(kFullMask, lb < CUDART_INF_F && !(lb > s.thr_d));
      while (mask) {
        const int src = __ffs(mask) - 1;
        mask &= mask - 1;
        const float clb = __shfl_sync(kFullMask, lb, src);
        const int cc = __shfl_sync(kFullMask, c, src);
        if (!(clb > s.thr_d)) s.scan(sup, n, cc, q.x, q.y, q.z);
      }
    }
  }
}

}  // namespace amc3d
