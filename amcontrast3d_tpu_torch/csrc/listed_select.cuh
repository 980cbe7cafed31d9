// The k-th smallest *distinct* d^2 of a block of queries, one query a
// warp, by a listed scan over a Morton-sorted support: the device code
// shared by contrast_select.cu (the contrast threshold) and vote.cu (the
// stage-label vote), as listed_knn.cuh serves knn.cu and refine.cu.
//
// The TPU kernels (contrast_pallas.py::_fwd_kernel with has_kth=False and
// ::_vote_kernel) pick their threshold by value-only extraction rounds that
// remove every copy of each minimum, so their k-th value is the k-th
// distinct d^2, and multiply it by (1 + 1e-6) in float32.  Here a warp keeps
// the smallest distinct d^2 seen so far in registers, spread over its lanes
// in ascending order (slot s in lane s % 32, register s / 32, as
// knn_topk.cuh keeps (d^2, index) pairs); a candidate joins by one ballot
// (its rank) and a shuffle-up, unless a kept value equals it; with one slot
// a lane, all of a step's candidates join by one bitonic merge after the
// warp drops those equal to a kept value or to another candidate (on the
// card no slower than inserting a few one by one, faster for many).
// A pass keeps at most 128 values; a larger k takes more passes, each
// keeping only values strictly above the previous pass's last one.
//
// The scan of a pass (chunk_list.cuh): a block takes kListWarps queries
// that are consecutive along the support's Morton curve.  Each warp first
// scans its home chunk, then the chunks beside it (chunk_search.cuh's
// order), until it holds the pass's kp distinct values: their kp-th is a
// sound limit, since the kp-th distinct d^2 over any subset that holds kp
// distinct values is never below the one over the whole support; the
// chunks on each side that the kNN's seed reads (listed_knn.cuh) are always
// scanned, which leaves a limit near the final one, and the scan goes on
// outward, a little further, only while fewer than kp values are kept.  A
// warp that finds fewer nearby sets the limit to +inf, and then every chunk is
// listed: right, only dense (as a threshold of 3e38 in the contrast
// kernels).  The block lists once, against the union box of its queries
// (chunks.cuh::box_box_lower_bound), the chunks whose bound lies below the
// largest of its warps' limits; each warp then tests the listed boxes
// against its own point and running last slot, 32 at a time, and scans the
// chunks that pass.  The set of distinct values a warp keeps does not depend
// on the order in which it meets them, so the result is the dense scan's,
// bit for bit, whatever the visit order.  d^2 is (dx*dx + dy*dy) + dz*dz
// rounded op by op (no FMA), as the plain twin rounds it.  With fewer than k
// distinct values the k-th is 3e38 (the TPU kernels' fill value), so every
// point lies within the threshold.
#pragma once
#include <math_constants.h>

#include "chunk_list.cuh"

namespace amc3d {

constexpr int kSelPass = 128;                // distinct values a pass keeps
constexpr float kSelNone = 3e38f;            // the k-th of fewer than k values
constexpr float kSelSlack = 1.000001f;       // float32(1 + 1e-6)

// registers per lane for a pass of up to min(k, 128) values
inline int sel_per_lane(int k) {
  if (k < 1) return 0;
  return k <= 32 ? 1 : (k <= 64 ? 2 : 4);
}

template <int KPL>
struct WarpDistinct {
  float d[KPL];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int r = 0; r < KPL; ++r) d[r] = CUDART_INF_F;
  }

  // the value of slot s, on every lane
  __device__ __forceinline__ float value_at(int s) const {
    float v = d[0];
#pragma unroll
    for (int r = 1; r < KPL; ++r) v = (s >> 5) == r ? d[r] : v;
    return __shfl_sync(0xffffffffu, v, s & 31);
  }

  // nd joins behind every smaller kept value unless one equals it; the
  // last slot falls off.  Called by the whole warp with the same nd.
  __device__ __forceinline__ void insert(float nd, int lane) {
    bool dup = false;
#pragma unroll
    for (int r = 0; r < KPL; ++r) dup = dup || d[r] == nd;
    if (__any_sync(0xffffffffu, dup)) return;
    int pos = 0;
#pragma unroll
    for (int r = 0; r < KPL; ++r)
      pos += __popc(__ballot_sync(0xffffffffu, d[r] < nd));
#pragma unroll
    for (int r = KPL - 1; r >= 0; --r) {
      float up = __shfl_up_sync(0xffffffffu, d[r], 1);
      if (r > 0) {  // lane 0 takes the last slot of the register below
        const float carry = __shfl_sync(0xffffffffu, d[r - 1], 31);
        if (lane == 0) up = carry;
      }
      const int slot = lane + 32 * r;
      if (slot == pos) {
        d[r] = nd;
      } else if (slot > pos) {
        d[r] = up;
      }
    }
  }

  // One candidate a lane (+inf: none), all merged at once (KPL == 1): a
  // candidate equal to a kept value (found by a binary search of the kept
  // slots) or to a candidate of a lower lane drops out, the rest are sorted
  // across the warp (bitonic) and merged with the kept slots, which keeps
  // the 32 smallest distinct values in order: what inserting each would
  // leave, at about the cost of five inserts.
  __device__ __forceinline__ void merge_lanes(float c, int lane) {
    static_assert(KPL == 1, "merge_lanes keeps one slot a lane");
    constexpr unsigned kAll = 0xffffffffu;
    int pos = 0;  // kept values below c, at most 31
#pragma unroll
    for (int step = 16; step > 0; step >>= 1)
      if (__shfl_sync(kAll, d[0], pos + step - 1) < c) pos += step;
    const bool kept = __shfl_sync(kAll, d[0], pos) == c;
    const unsigned same = __match_any_sync(kAll, __float_as_uint(c));
    float v = kept || (same & ((1u << lane) - 1u)) ? CUDART_INF_F : c;
#pragma unroll
    for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        const float o = __shfl_xor_sync(kAll, v, stride);
        const bool keep_min = ((lane & stride) == 0) == ((lane & size) == 0);
        v = keep_min ? fminf(v, o) : fmaxf(v, o);
      }
    }
    // descending against ascending: the 32 smallest of both, bitonic
    float m = fminf(__shfl_sync(kAll, v, 31 - lane), d[0]);
#pragma unroll
    for (int stride = 16; stride > 0; stride >>= 1) {
      const float o = __shfl_xor_sync(kAll, m, stride);
      m = (lane & stride) ? fmaxf(o, m) : fminf(o, m);
    }
    d[0] = m;
  }
};

// The shared memory of one listed selection; the kernel declares it.
struct SelectShared {
  int list[kListChunks];
  float pts[kListWarps][3];
  float limit[kListWarps];
  int near[kListWarps][2];
  int counts[kListWarps];
};

// The warp's query: its position and the chunk of the support it starts
// from (any chunk is right; a near one makes the limit tight).
struct SelectQuery {
  bool active;  // the last block may hold fewer than kListWarps queries
  float x, y, z;
  int home;
};

// The kp smallest distinct d^2 above lo of one query, kept by one warp.
template <int KPL>
struct DistinctScan {
  WarpDistinct<KPL> top;
  float last;  // slot kp - 1: +inf until kp values are kept
  float lo;
  int kp, lane;

  __device__ __forceinline__ void init(int kp_, float lo_, int lane_) {
    top.init();
    last = CUDART_INF_F;
    lo = lo_;
    kp = kp_;
    lane = lane_;
  }

  // the whole warp scans chunk c of the sorted support
  __device__ __forceinline__ void scan(const float4* __restrict__ sup, int n,
                                       int c, const SelectQuery& q) {
    const int base = c * kChunk;
    const int len = min(kChunk, n - base);
    for (int u0 = 0; u0 < len; u0 += 32) {
      const int u = u0 + lane;
      float dd = CUDART_INF_F;
      if (u < len) {
        const float4 p = sup[base + u];
        dd = point_d2(q.x, q.y, q.z, p.x, p.y, p.z);
      }
      const bool take = dd < last && dd > lo;
      unsigned mask = __ballot_sync(0xffffffffu, take);
      if constexpr (KPL == 1) {  // one slot a lane: merge the step's at once
        if (mask) {
          top.merge_lanes(take ? dd : CUDART_INF_F, lane);
          last = top.value_at(kp - 1);
        }
        continue;
      }
      while (mask) {
        const int src = __ffs(mask) - 1;
        mask &= mask - 1;
        const float nd = __shfl_sync(0xffffffffu, dd, src);
        if (nd < last) {  // the last slot may have tightened within the step
          top.insert(nd, lane);
          last = top.value_at(kp - 1);
        }
      }
    }
  }
};

// One pass: the kp-th smallest distinct d^2 above lo from the warp's query
// to the n support points `sup` (sorted, nc chunks with boxes `bx`), +inf
// when fewer exist; `done` values lie at or below lo.  Every thread of the
// block calls it (block_list's barriers, one more after the seeds); a warp
// with active == false keeps nothing.  `warps`: the block's queries.
template <int KPL>
__device__ __forceinline__ float listed_distinct_pass(
    const float4* __restrict__ sup, const float* __restrict__ bx, int n,
    int nc, int kp, int done, float lo, int warps, const SelectQuery& q,
    SelectShared& sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  DistinctScan<KPL> s;
  s.init(kp, lo, lane);
  int slo = 0, shi = nc;  // an idle warp excludes nothing
  float limit = -1.f;     // and admits nothing
  if (q.active) {
    // the seed: the home chunk, the `near` ones on each side, then further
    // out, up to `reach`, while fewer than kp distinct values are kept
    const int h = q.home, near = 1 + done / kChunk;
    const int reach = near + 1 + kp / kChunk;
    const int reach_lo = max(0, h - reach), reach_hi = min(nc, h + reach + 1);
    s.scan(sup, n, h, q);
    slo = h;
    shi = h + 1;
    for (int d = 1; (d <= near || s.last == CUDART_INF_F) &&
                    (h - d >= reach_lo || h + d < reach_hi);
         ++d) {
      if (h - d >= reach_lo) {
        s.scan(sup, n, h - d, q);
        slo = h - d;
      }
      if ((d <= near || s.last == CUDART_INF_F) && h + d < reach_hi) {
        s.scan(sup, n, h + d, q);
        shi = h + d + 1;
      }
    }
    limit = s.last;  // +inf: fewer than kp nearby, every chunk is listed
  }
  if (lane == 0) {
    sh.pts[warp][0] = q.x;
    sh.pts[warp][1] = q.y;
    sh.pts[warp][2] = q.z;
    sh.limit[warp] = limit;
    sh.near[warp][0] = slo;
    sh.near[warp][1] = shi;
  }
  __syncthreads();
  // the union box of the block's queries, the largest limit among them, and
  // the chunks every warp has scanned
  float ub[6];
  union_box(sh.pts, warps, ub);
  float block_limit = -1.f;
  int done_lo = 0, done_hi = nc;
  for (int w = 0; w < warps; ++w) {
    block_limit = fmaxf(block_limit, sh.limit[w]);
    done_lo = max(done_lo, sh.near[w][0]);
    done_hi = min(done_hi, sh.near[w][1]);
  }
  // a value at the limit is one a warp keeps already: strict tests suffice
  auto needed = [&](int c) {
    return (c < done_lo || c >= done_hi) &&
           box_box_lower_bound(ub, bx + static_cast<size_t>(c) * 6) < block_limit;
  };
  for (int w0 = 0; w0 < nc; w0 += kListChunks) {
    const int total = block_list(w0, nc, needed, sh.list, sh.counts);
    if (!q.active) continue;
    for (int t0 = 0; t0 < total; t0 += 32) {
      const int t = t0 + lane;
      int c = 0;
      float lb = CUDART_INF_F;  // +inf marks no chunk
      if (t < total) {
        c = sh.list[t];
        if (c < slo || c >= shi)
          lb = box_lower_bound(q.x, q.y, q.z, bx + static_cast<size_t>(c) * 6);
      }
      unsigned mask = __ballot_sync(0xffffffffu, lb < s.last);
      while (mask) {
        const int src = __ffs(mask) - 1;
        mask &= mask - 1;
        const float clb = __shfl_sync(0xffffffffu, lb, src);
        const int cc = __shfl_sync(0xffffffffu, c, src);
        if (clb < s.last) s.scan(sup, n, cc, q);
      }
    }
  }
  return s.last;
}

// The threshold of the TPU kernels: the k-th smallest distinct d^2 from the
// warp's query to the support, times float32(1 + 1e-6); 3e38 times the same
// when fewer than k distinct values exist.  Block-wide, as
// listed_distinct_pass; every warp of the block runs the same passes.
template <int KPL>
__device__ __forceinline__ float listed_kth_distinct(
    const float4* __restrict__ sup, const float* __restrict__ bx, int n,
    int nc, int k, int warps, const SelectQuery& q, SelectShared& sh) {
  float v = -1.f;  // every d^2 is above it
  for (int done = 0; done < k; done += kSelPass) {
    SelectQuery qp = q;
    qp.active = q.active && v != CUDART_INF_F;  // no more values above v
    const float last = listed_distinct_pass<KPL>(
        sup, bx, n, nc, min(kSelPass, k - done), done, v, warps, qp, sh);
    if (qp.active) v = last;
  }
  return __fmul_rn(v == CUDART_INF_F ? kSelNone : v, kSelSlack);
}

}  // namespace amc3d
