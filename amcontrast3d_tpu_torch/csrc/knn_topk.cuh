// Exact k-nearest-neighbour selection by one warp per query: the device
// code shared by refine.cu (kernel: fused CrossMask feature; scan_topk) and,
// through chunk_search.cuh, the chunk-pruned kNN kernels (WarpTopK).
//
// scan_topk: a warp scans its cloud's support positions, staged by the
// block through shared memory in tiles of 1024, one candidate per lane and
// step.  The k best (d^2, index) pairs so far live in registers, spread
// over the warp in ascending order: slot s sits in lane s % 32, register
// s / 32.  A ballot against the running k-th d^2 yields the step's
// candidates in index order; each is placed by one more ballot (its rank =
// the number of kept d^2 that are <= its own) and a shuffle-up of the slots
// behind it.  Candidates arrive in ascending index order, so a candidate
// whose d^2 ties a kept one ranks behind it and one that ties the k-th is
// refused: the order is (d^2, index) ascending, ties to the lowest index,
// as a stable top-k.
// d^2 = (dx*dx + dy*dy) + dz*dz, rounded op by op (no FMA), exactly as the
// plain PyTorch twin rounds it.  Unfilled slots hold index 0 at +inf.
#pragma once
#include <cuda_runtime.h>
#include <math_constants.h>

namespace amc3d {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kScanWarps = 8;                  // queries per block
constexpr int kScanThreads = kScanWarps * 32;
constexpr int kScanTile = 1024;                // support points per tile
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

  // Place (nd, ni) behind every kept pair with d^2 <= nd; the last slot
  // falls off.  Called by the whole warp with the same arguments.
  __device__ __forceinline__ void insert(float nd, int ni, int lane) {
    int pos = 0;
#pragma unroll
    for (int r = 0; r < KPL; ++r)
      pos += __popc(__ballot_sync(kFullMask, d[r] <= nd));
    place(nd, ni, pos, lane);
  }

  // The same for candidates that arrive in any index order: (nd, ni) goes
  // behind every kept pair that is smaller as a (d^2, index) pair, so the
  // slots stay in (d^2, index) order whatever the order of arrival.  A
  // pair must be offered once only.
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

// The k nearest of the n support points `sup` (n x 3) to (qx, qy, qz) into
// `top`; with LOWER, the k nearest after the pair (lo_d, lo_i) in
// (d^2, index) order (a pass of a k larger than the registers hold).  Every
// thread of the block calls it (it holds the barriers); a warp with
// active == false keeps nothing.  sx, sy, sz: kScanTile floats of shared
// memory each.
template <int KPL, bool LOWER = false>
__device__ __forceinline__ void scan_topk(const float* __restrict__ sup, int n,
                                          int k, float qx, float qy, float qz,
                                          bool active, float* sx, float* sy,
                                          float* sz, WarpTopK<KPL>& top,
                                          float lo_d = 0.f, int lo_i = 0) {
  const int lane = threadIdx.x & 31;
  top.init();
  float thr = CUDART_INF_F;  // d^2 of slot k - 1
  for (int t0 = 0; t0 < n; t0 += kScanTile) {
    const int len = min(kScanTile, n - t0);
    __syncthreads();  // the previous tile is no longer read
    for (int t = threadIdx.x; t < len; t += kScanThreads) {
      const float* s = sup + static_cast<size_t>(t0 + t) * 3;
      sx[t] = s[0];
      sy[t] = s[1];
      sz[t] = s[2];
    }
    __syncthreads();
    if (!active) continue;
    for (int u0 = 0; u0 < len; u0 += 32) {
      const int u = u0 + lane;
      float dd = CUDART_INF_F;
      if (u < len) {
        const float dx = __fsub_rn(qx, sx[u]);
        const float dy = __fsub_rn(qy, sy[u]);
        const float dz = __fsub_rn(qz, sz[u]);
        dd = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                       __fmul_rn(dz, dz));
      }
      const bool after =
          !LOWER || dd > lo_d || (dd == lo_d && t0 + u > lo_i);
      unsigned mask = __ballot_sync(kFullMask, u < len && dd < thr && after);
      while (mask) {
        const int src = __ffs(mask) - 1;
        mask &= mask - 1;
        const float nd = __shfl_sync(kFullMask, dd, src);
        if (nd < thr) {  // the k-th may have tightened within this step
          top.insert(nd, t0 + u0 + src, lane);
          thr = top.dist_at(k - 1);
        }
      }
    }
  }
}

}  // namespace amc3d
