// Exact k-nearest-neighbour slots of one query kept by one warp: the
// device code shared, through chunk_search.cuh, by the chunk-pruned scans
// (the listed scan of knn.cu, refine.cu and interpolate.cu) and by
// ball_query.cu (a hit is the pair (0, index)).
//
// The k best (d^2, index) pairs so far live in registers, spread over the
// warp in ascending order: slot s sits in lane s % 32, register s / 32.  A
// candidate is placed by one ballot (its rank = the number of kept pairs
// below it) and a shuffle-up of the slots behind it (insert_pair), or, with
// one slot a lane and many candidates at once, by a bitonic merge
// (merge_lanes); either way the slots stay in (d^2, index) order, ties to
// the lowest index, as a stable top-k keeps them, whatever the order of
// arrival.  d^2 = (dx*dx + dy*dy) + dz*dz, rounded op by op (no FMA),
// exactly as the plain PyTorch twins round it.  Unfilled slots hold index 0
// at +inf.
#pragma once
#include <cuda_runtime.h>
#include <math_constants.h>

namespace amc3d {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kScanWarps = 8;                  // queries per block
constexpr int kScanThreads = kScanWarps * 32;
constexpr int kMaxSlotsPerLane = 4;            // k <= 128

// registers per lane for k slots: 1, 2 or 4; 0 when k is not supported
inline int slots_per_lane(int k) {
  if (k < 1 || k > 32 * kMaxSlotsPerLane) return 0;
  return k <= 32 ? 1 : (k <= 64 ? 2 : 4);
}

template <int KPL>
struct WarpTopK {
  float d[KPL];
  int i[KPL];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int r = 0; r < KPL; ++r) {
      d[r] = CUDART_INF_F;
      i[r] = 0;
    }
  }

  // d^2 and index of slot s, on every lane
  __device__ __forceinline__ float dist_at(int s) const {
    float v = d[0];
#pragma unroll
    for (int r = 1; r < KPL; ++r) v = (s >> 5) == r ? d[r] : v;
    return __shfl_sync(kFullMask, v, s & 31);
  }
  __device__ __forceinline__ int index_at(int s) const {
    int v = i[0];
#pragma unroll
    for (int r = 1; r < KPL; ++r) v = (s >> 5) == r ? i[r] : v;
    return __shfl_sync(kFullMask, v, s & 31);
  }

  // Place (nd, ni) behind every kept pair that is smaller as a (d^2, index)
  // pair, so the slots stay in (d^2, index) order whatever the order of
  // arrival; the last slot falls off.  Called by the whole warp with the
  // same arguments.  A pair must be offered once only.
  __device__ __forceinline__ void insert_pair(float nd, int ni, int lane) {
    int pos = 0;
#pragma unroll
    for (int r = 0; r < KPL; ++r)
      pos += __popc(__ballot_sync(
          kFullMask, d[r] < nd || (d[r] == nd && i[r] < ni)));
    place(nd, ni, pos, lane);
  }

  // One candidate a lane (take false: none), merged into the slots at once
  // (KPL == 1): a bitonic sort of the candidates across the warp, then a
  // bitonic merge with the kept slots, which keeps the 32 smallest pairs in
  // (d^2, index) order.  The first k slots are then what insert_pair would
  // leave after offering each candidate, at about the cost of five inserts.
  __device__ __forceinline__ void merge_lanes(float nd, int ni, bool take,
                                              int lane) {
    static_assert(KPL == 1, "merge_lanes keeps one slot a lane");
    using Key = unsigned long long;
    // d^2 >= +0 orders as its bits; indices are >= 0
    Key c = take ? (static_cast<Key>(__float_as_uint(nd)) << 32) |
                       static_cast<unsigned>(ni)
                 : ~0ull;
#pragma unroll
    for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        const Key o = __shfl_xor_sync(kFullMask, c, stride);
        const bool keep_min = ((lane & stride) == 0) == ((lane & size) == 0);
        c = keep_min ? (o < c ? o : c) : (o > c ? o : c);
      }
    }
    const Key r = __shfl_sync(kFullMask, c, 31 - lane);  // descending
    const Key mine = (static_cast<Key>(__float_as_uint(d[0])) << 32) |
                     static_cast<unsigned>(i[0]);
    Key m = r < mine ? r : mine;  // bitonic, the 32 smallest of both
#pragma unroll
    for (int stride = 16; stride > 0; stride >>= 1) {
      const Key o = __shfl_xor_sync(kFullMask, m, stride);
      m = (lane & stride) ? (o > m ? o : m) : (o < m ? o : m);
    }
    d[0] = __uint_as_float(static_cast<unsigned>(m >> 32));
    i[0] = static_cast<int>(static_cast<unsigned>(m));
  }

  // Put (nd, ni) into slot pos and move the slots from pos on one up.
  __device__ __forceinline__ void place(float nd, int ni, int pos, int lane) {
#pragma unroll
    for (int r = KPL - 1; r >= 0; --r) {
      float ud = __shfl_up_sync(kFullMask, d[r], 1);
      int ui = __shfl_up_sync(kFullMask, i[r], 1);
      if (r > 0) {  // lane 0 takes the last slot of the register below
        const float cd = __shfl_sync(kFullMask, d[r - 1], 31);
        const int ci = __shfl_sync(kFullMask, i[r - 1], 31);
        if (lane == 0) {
          ud = cd;
          ui = ci;
        }
      }
      const int slot = lane + 32 * r;
      if (slot == pos) {
        d[r] = nd;
        i[r] = ni;
      } else if (slot > pos) {
        d[r] = ud;
        i[r] = ui;
      }
    }
  }
};

}  // namespace amc3d
