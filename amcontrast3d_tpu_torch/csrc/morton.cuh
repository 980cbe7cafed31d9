// The Morton code of a point in a cloud's frame, as ops/spatial.py::
// morton_key forms it: per axis the cell (x - lo) * scale, rounded op by op
// in float32, truncated and clamped to [0, 2^16 - 1], its bits spread to
// every third bit, x above y above z.  layout.cu keys the stage clouds by
// it, and vote.cu and interpolate.cu find a query's home chunk among the
// support's sorted codes by it (home_chunk), so all read the one definition
// here.
#pragma once
#include <cuda_runtime.h>

#include <cstdint>

#include "chunks.cuh"

namespace amc3d {

constexpr int kMortonCells = 65535;  // 2^16 - 1: ops/spatial.py::_BITS

// the low 16 bits of v at every third bit (spatial._spread3)
__device__ __forceinline__ uint64_t spread3(uint64_t v) {
  v = (v | (v << 32)) & 0x1F00000000FFFFull;
  v = (v | (v << 16)) & 0x1F0000FF0000FFull;
  v = (v | (v << 8)) & 0x100F00F00F00F00Full;
  v = (v | (v << 4)) & 0x10C30C30C30C30C3ull;
  v = (v | (v << 2)) & 0x1249249249249249ull;
  return v;
}

__device__ __forceinline__ uint64_t morton_cell(float x, float lo, float scale) {
  const long long c = static_cast<long long>(__fmul_rn(__fsub_rn(x, lo), scale));
  return static_cast<uint64_t>(c < 0 ? 0 : (c > kMortonCells ? kMortonCells : c));
}

// the 48-bit code of (x, y, z) in the frame (lo, scale)
__device__ __forceinline__ uint64_t morton_code(float x, float y, float z,
                                                const float* lo, float scale) {
  return (spread3(morton_cell(x, lo[0], scale)) << 2) |
         (spread3(morton_cell(y, lo[1], scale)) << 1) |
         spread3(morton_cell(z, lo[2], scale));
}

// The chunk of the support where the query's Morton code (ops/spatial.py::
// morton_key in the support's frame) would sit: the first of the n sorted
// codes not below it, found by the whole warp, 32 probes a round (three
// rounds of loads at 24000 points).  Any chunk would be right for a scan
// that lists the rest; a near one makes its first bound tight.  Points
// outside the frame go to its border, as morton_key clamps them.
__device__ __forceinline__ int home_chunk(const long long* __restrict__ codes,
                                          int n, const float* lo, float scale,
                                          float x, float y, float z, int lane) {
  const long long key = static_cast<long long>(morton_code(x, y, z, lo, scale));
  int first = 0, last = n;  // the answer lies in [first, last]
  while (first < last) {
    const int step = (last - first + 31) / 32;
    const int i = first + lane * step;
    const bool below = i < last && codes[i] < key;
    const int cnt = __popc(__ballot_sync(0xffffffffu, below));
    const int nfirst = cnt > 0 ? first + (cnt - 1) * step + 1 : first;
    last = min(last, first + cnt * step);
    first = nfirst;
  }
  return min(first, n - 1) / kChunk;
}

}  // namespace amc3d
