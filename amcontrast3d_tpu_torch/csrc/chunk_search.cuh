// Exact nearest-neighbour search of one query by one warp over a support
// sorted into chunks with boxes: the chunk scan of the listed kNN
// (listed_knn.cuh: knn.cu, refine.cu, interpolate.cu).
//
// The warp keeps the query's k best (d^2, index) pairs in registers
// (knn_topk.cuh, WarpTopK::insert_pair: the slots stay in (d^2, index)
// order whatever order the candidates arrive in, since the chunks come in
// Morton order, not in index order; with one slot a lane, a step with many
// candidates merges them at once, WarpTopK::merge_lanes).  A candidate is
// taken when its pair is below the pair in slot k - 1 and, with LOWER,
// above a lower bound pair: a k larger than the registers hold is taken in
// passes, each keeping the next slots after the previous pass's last pair.
//
// The callers scan the chunks around the query's own place in the sorted
// order first (its home chunk), which leaves a k-th d^2 close to the final
// one, then the chunks of a block's list (chunk_list.cuh) whose box lower
// bound is not above the running k-th d^2: at equal d^2 a chunk may still
// hold a lower index.
#pragma once
#include "chunks.cuh"
#include "knn_topk.cuh"

namespace amc3d {

// candidates in one step above which a warp keeping one slot a lane merges
// them at once (WarpTopK::merge_lanes) instead of inserting each
constexpr int kMergeAbove = 4;

template <int KPL, bool LOWER = false>
struct ChunkSearch {
  WarpTopK<KPL> top;
  float thr_d;  // the pair in slot k - 1
  int thr_i;
  float lo_d;   // with LOWER, candidates must lie above this pair
  int lo_i;
  int k, lane;

  // every slot holds (fill, index 0): +inf keeps anything, a finite fill
  // refuses a point at or beyond it
  __device__ __forceinline__ void init(int k_, int lane_, float fill,
                                       float lo_d_ = 0.f, int lo_i_ = 0) {
    top.init();
#pragma unroll
    for (int r = 0; r < KPL; ++r) top.d[r] = fill;
    thr_d = fill;
    thr_i = 0;
    lo_d = lo_d_;
    lo_i = lo_i_;
    k = k_;
    lane = lane_;
  }

  __device__ __forceinline__ bool better(float d, int i) const {
    return (d < thr_d || (d == thr_d && i < thr_i)) &&
           (!LOWER || d > lo_d || (d == lo_d && i > lo_i));
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
      const bool take = u < len && better(dd, oi);
      unsigned mask = __ballot_sync(kFullMask, take);
      if constexpr (KPL == 1) {
        if (__popc(mask) > kMergeAbove) {  // many at once: merge them
          top.merge_lanes(dd, oi, take, lane);
          thr_d = top.dist_at(k - 1);
          thr_i = top.index_at(k - 1);
          continue;
        }
      }
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

}  // namespace amc3d
