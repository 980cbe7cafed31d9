// The Morton code of a point in a cloud's frame, as ops/spatial.py::
// morton_key forms it: per axis the cell (x - lo) * scale, rounded op by op
// in float32, truncated and clamped to [0, 2^16 - 1], its bits spread to
// every third bit, x above y above z.  layout.cu keys the stage clouds by
// it and vote.cu finds a query's place among the support's sorted codes,
// so both read the one definition here.
#pragma once
#include <cuda_runtime.h>

#include <cstdint>

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

}  // namespace amc3d
