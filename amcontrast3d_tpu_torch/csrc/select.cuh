// The k-th smallest *distinct* d^2 by one warp per query: the device code
// shared by contrast_select.cu (kernel: the contrast threshold) and vote.cu
// (kernel: the stage-label vote).
//
// The TPU kernels (contrast_pallas.py::_fwd_kernel with has_kth=False and
// ::_vote_kernel) pick their threshold by value-only extraction rounds that
// remove every copy of each minimum, so their k-th value is the k-th
// distinct d^2, and multiply it by (1 + 1e-6) in float32.  Here a warp keeps
// the smallest distinct d^2 seen so far in registers, spread over its lanes
// in ascending order (slot s in lane s % 32, register s / 32, as
// knn_topk.cuh keeps (d^2, index) pairs).  A warp scans its cloud's support
// positions, staged by the block through shared memory in tiles of 1024,
// one candidate per lane and step; a ballot against the running last slot
// yields the candidates, and each joins by one more ballot (its rank) and a
// shuffle-up, unless a kept value equals it.  A pass keeps at most 128
// values; a larger k takes more passes over the support, each keeping only
// values strictly above the previous pass's last one.  d^2 is
// (dx*dx + dy*dy) + dz*dz rounded op by op (no FMA), as the plain twin
// rounds it.  With fewer than k distinct values the k-th is 3e38 (the TPU
// kernels' fill value), so every point lies within the threshold.
#pragma once
#include <cuda_runtime.h>
#include <math_constants.h>

namespace amc3d {

constexpr unsigned kSelFull = 0xffffffffu;
constexpr int kSelWarps = 8;                 // queries per block
constexpr int kSelThreads = kSelWarps * 32;
constexpr int kSelTile = 1024;               // support points per tile
constexpr int kSelPass = 128;                // distinct values a pass keeps
constexpr float kSelNone = 3e38f;            // the k-th of fewer than k values
constexpr float kSelSlack = 1.000001f;       // float32(1 + 1e-6)

// registers per lane for a pass of up to min(k, 128) values
inline int sel_per_lane(int k) {
  if (k < 1) return 0;
  return k <= 32 ? 1 : (k <= 64 ? 2 : 4);
}

__device__ __forceinline__ float sel_d2(float qx, float qy, float qz, float sx,
                                        float sy, float sz) {
  const float dx = __fsub_rn(qx, sx);
  const float dy = __fsub_rn(qy, sy);
  const float dz = __fsub_rn(qz, sz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
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
    return __shfl_sync(kSelFull, v, s & 31);
  }

  // nd joins behind every smaller kept value unless one equals it; the
  // last slot falls off.  Called by the whole warp with the same nd.
  __device__ __forceinline__ void insert(float nd, int lane) {
    bool dup = false;
#pragma unroll
    for (int r = 0; r < KPL; ++r) dup = dup || d[r] == nd;
    if (__any_sync(kSelFull, dup)) return;
    int pos = 0;
#pragma unroll
    for (int r = 0; r < KPL; ++r)
      pos += __popc(__ballot_sync(kSelFull, d[r] < nd));
#pragma unroll
    for (int r = KPL - 1; r >= 0; --r) {
      float up = __shfl_up_sync(kSelFull, d[r], 1);
      if (r > 0) {  // lane 0 takes the last slot of the register below
        const float carry = __shfl_sync(kSelFull, d[r - 1], 31);
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
};

// One pass: the kp (<= 32 * KPL) smallest distinct d^2 above lo of the n
// support points `sup` (n x 3) to (qx, qy, qz); returns the kp-th, +inf
// when fewer exist.  Every thread of the block calls it (it holds the
// barriers); a warp with active == false keeps nothing.  sx, sy, sz:
// kSelTile floats of shared memory each.
template <int KPL>
__device__ __forceinline__ float distinct_pass(const float* __restrict__ sup,
                                               int n, int kp, float qx,
                                               float qy, float qz, bool active,
                                               float lo, float* sx, float* sy,
                                               float* sz) {
  const int lane = threadIdx.x & 31;
  WarpDistinct<KPL> top;
  top.init();
  float last = CUDART_INF_F;  // slot kp - 1
  for (int t0 = 0; t0 < n; t0 += kSelTile) {
    const int len = min(kSelTile, n - t0);
    __syncthreads();  // the previous tile is no longer read
    for (int t = threadIdx.x; t < len; t += kSelThreads) {
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
      if (u < len) dd = sel_d2(qx, qy, qz, sx[u], sy[u], sz[u]);
      unsigned mask = __ballot_sync(kSelFull, dd < last && dd > lo);
      while (mask) {
        const int src = __ffs(mask) - 1;
        mask &= mask - 1;
        const float nd = __shfl_sync(kSelFull, dd, src);
        if (nd < last) {  // the last slot may have tightened within the step
          top.insert(nd, lane);
          last = top.value_at(kp - 1);
        }
      }
    }
  }
  return last;
}

// The threshold of the TPU kernels: the k-th smallest distinct d^2 from
// (qx, qy, qz) to the support, times float32(1 + 1e-6); 3e38 times the same
// when fewer than k distinct values exist.  Block-wide, as distinct_pass.
template <int KPL>
__device__ __forceinline__ float kth_distinct(const float* __restrict__ sup,
                                              int n, int k, float qx, float qy,
                                              float qz, bool active, float* sx,
                                              float* sy, float* sz) {
  float v = -1.f;  // every d^2 is above it
  for (int done = 0; done < k; done += kSelPass) {
    v = distinct_pass<KPL>(sup, n, min(kSelPass, k - done), qx, qy, qz,
                           active, v, sx, sy, sz);
  }
  return __fmul_rn(v == CUDART_INF_F ? kSelNone : v, kSelSlack);
}

}  // namespace amc3d
