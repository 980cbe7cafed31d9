// Spatially sorted support chunks with bounding boxes: the device code
// shared by knn_big.cu and ball_query_big.cu.
//
// ops/spatial.py sorts a cloud's support points along a Morton curve ahead
// of the kernel and cuts the sorted order into chunks of kChunk points.
// The kernels get, per cloud, the sorted points as float4 (x, y, z and the
// bits of the point's index in the caller's order) and one box per chunk
// (lo x, y, z, hi x, y, z: the exact minimum and maximum of its points).
//
// box_lower_bound is formed like a point's d^2, (gx*gx + gy*gy) + gz*gz
// rounded op by op, from the per-axis gaps between the query and the box.
// For a point p of the box and an axis where the query lies below the box,
// p - q >= lo - q >= 0; float subtraction, squaring of a non-negative
// number and addition are all monotone under round-to-nearest, so the
// bound as computed is never above the point's d^2 as computed.  A chunk
// whose bound fails a test `d^2 < t` (or `d^2 <= t`) therefore holds no
// point that passes it, and no slack is needed.
#pragma once
#include <cuda_runtime.h>

namespace amc3d {

constexpr int kChunk = 64;  // support points per chunk

__device__ __forceinline__ float point_d2(float qx, float qy, float qz,
                                          float sx, float sy, float sz) {
  const float dx = __fsub_rn(qx, sx);
  const float dy = __fsub_rn(qy, sy);
  const float dz = __fsub_rn(qz, sz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// box: lo x, y, z, hi x, y, z
__device__ __forceinline__ float box_lower_bound(float qx, float qy, float qz,
                                                 const float* __restrict__ box) {
  const float gx = fmaxf(fmaxf(__fsub_rn(box[0], qx), __fsub_rn(qx, box[3])), 0.f);
  const float gy = fmaxf(fmaxf(__fsub_rn(box[1], qy), __fsub_rn(qy, box[4])), 0.f);
  const float gz = fmaxf(fmaxf(__fsub_rn(box[2], qz), __fsub_rn(qz, box[5])), 0.f);
  return __fadd_rn(__fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy)),
                   __fmul_rn(gz, gz));
}

}  // namespace amc3d
