// Spatially sorted support chunks with bounding boxes: the device code
// shared by the chunk-pruned kernels (knn.cu, ball_query.cu, refine.cu,
// fps_pruned.cu, interpolate_big.cu, contrast.cu, contrast_select.cu,
// vote.cu) and chunk_list.cuh.
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
//
// box_box_lower_bound does the same for every point of one box against
// every point of another: per axis the gap max(lo_b - hi_a, lo_a - hi_b, 0).
// For p in box a and s in box b with lo_b > hi_a, s - p >= lo_b - hi_a >= 0
// holds as computed too (float subtraction is monotone in each operand), so
// the bound is never above the d^2 of any such pair: a block of queries
// whose union box is `a` may skip a chunk whose bound fails the largest
// limit among them.
//
// box_upper_bound is the other side: per axis the larger of |q - lo| and
// |q - hi|.  For p in the box, q - p as computed lies between q - hi and
// q - lo as computed (monotone again), so its magnitude is at most the
// larger of theirs, and the bound is never below the d^2 of a point of the
// box: the k-th nearest of a query is within the largest upper bound of
// any chunks that hold k points.
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

__device__ __forceinline__ float box_upper_bound(float qx, float qy, float qz,
                                                 const float* __restrict__ box) {
  const float gx = fmaxf(fabsf(__fsub_rn(qx, box[0])), fabsf(__fsub_rn(qx, box[3])));
  const float gy = fmaxf(fabsf(__fsub_rn(qy, box[1])), fabsf(__fsub_rn(qy, box[4])));
  const float gz = fmaxf(fabsf(__fsub_rn(qz, box[2])), fabsf(__fsub_rn(qz, box[5])));
  return __fadd_rn(__fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy)),
                   __fmul_rn(gz, gz));
}

// a, b: lo x, y, z, hi x, y, z
__device__ __forceinline__ float box_box_lower_bound(const float* a,
                                                     const float* b) {
  const float gx = fmaxf(fmaxf(__fsub_rn(b[0], a[3]), __fsub_rn(a[0], b[3])), 0.f);
  const float gy = fmaxf(fmaxf(__fsub_rn(b[1], a[4]), __fsub_rn(a[1], b[4])), 0.f);
  const float gz = fmaxf(fmaxf(__fsub_rn(b[2], a[5]), __fsub_rn(a[2], b[5])), 0.f);
  return __fadd_rn(__fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy)),
                   __fmul_rn(gz, gz));
}

}  // namespace amc3d
