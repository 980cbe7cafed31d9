// A block's list of candidate chunks: the device code shared by knn.cu and
// refine.cu (through listed_knn.cuh), contrast_select.cu and vote.cu
// (through listed_select.cuh), ball_query.cu and contrast.cu's three
// kernels.
//
// A block of kListWarps warps works on one point a warp, 8 points that are
// consecutive along the Morton curve of ops/spatial.py, so the union box of
// the 8 is small.  The block tests each chunk's box once against that union
// box (chunks.cuh::box_box_lower_bound, never above the d^2 of any pair of
// points of the two boxes) and a limit the kernel gives; the chunks that
// pass go into a list in shared memory in chunk order, kListChunks chunks a
// window, four a thread.  Each warp then tests the listed boxes against its
// own point, 32 at a time, one a lane, and scans only the chunks it needs,
// reading them through L1, which the 8 warps share.  Where a window holds
// every chunk (up to kListChunks * 64 = 65536 points) the block meets at one
// barrier only, before the warps' own work starts.
#pragma once
#include <math_constants.h>

#include "chunks.cuh"

namespace amc3d {

constexpr int kListWarps = 8;
constexpr int kListThreads = kListWarps * 32;
constexpr int kListPerThread = 4;
constexpr int kListChunks = kListThreads * kListPerThread;

// The chunks c of [w0, min(w0 + kListChunks, nc)) with pass(c) into `list`,
// in chunk order; returns their count.  Every thread of the block calls it
// (three block barriers, the first after every read of the previous list);
// `counts` is kListWarps ints of shared memory.
template <class Pass>
__device__ __forceinline__ int block_list(int w0, int nc, const Pass& pass,
                                          int* list, int* counts) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c0 = w0 + threadIdx.x * kListPerThread;
  unsigned bits = 0;
#pragma unroll
  for (int j = 0; j < kListPerThread; ++j)
    if (c0 + j < nc && pass(c0 + j)) bits |= 1u << j;
  const int mine = __popc(bits);
  int upto = mine;  // inclusive sum over the warp's lanes
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, upto, off);
    if (lane >= off) upto += v;
  }
  __syncthreads();
  if (lane == 31) counts[warp] = upto;
  __syncthreads();
  int at = upto - mine, total = 0;
#pragma unroll
  for (int w = 0; w < kListWarps; ++w) {
    const int c = counts[w];
    at += w < warp ? c : 0;
    total += c;
  }
#pragma unroll
  for (int j = 0; j < kListPerThread; ++j)
    if ((bits >> j) & 1u) list[at++] = c0 + j;
  __syncthreads();
  return total;
}

// the union box (lo x, y, z, hi x, y, z) of the first `count` points of
// pts (kListWarps x 3 floats of shared memory)
__device__ __forceinline__ void union_box(const float (*pts)[3], int count,
                                          float* box) {
  box[0] = box[1] = box[2] = CUDART_INF_F;
  box[3] = box[4] = box[5] = -CUDART_INF_F;
  for (int w = 0; w < count; ++w) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      box[a] = fminf(box[a], pts[w][a]);
      box[3 + a] = fmaxf(box[3 + a], pts[w][a]);
    }
  }
}

}  // namespace amc3d
