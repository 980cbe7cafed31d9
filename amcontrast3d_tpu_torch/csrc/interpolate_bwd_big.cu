// The VJP of the 3-NN interpolation for large query sets: support-owned
// and deterministic.
//
// Replaces amcontrast3d_tpu/ops/interpolate_pallas.py::_interp_bwd_big_kernel,
// the TPU kernel the JAX package reaches when the padded query buffer
// [g | x y z thr wsum] no longer stays resident on chip (the ScanNet
// recipe's decoder stage fp0: 64000 fine points, C = 128): query blocks
// ride the grid, one support chunk's (cs, C) accumulator stays on chip
// across the sweep, and nothing is scattered.  It computes
// df2[b, j] = sum_q w_qj * g[b, q] over the queries q that hold j among
// their three nearest coarse points.
//
// This kernel takes the forward's saved (idx, weight) triples, as the
// scatter kernel of interpolate.cu does, but keeps the TPU kernel's
// ownership: a block owns `rows` consecutive support rows of one cloud and
// their (rows, C) accumulator in shared memory.  It sweeps all 3 * n1
// indices of its cloud in tiles of 2048: each of its 8 warps takes 256
// consecutive entries (8 loads a lane, in flight together), picks those that
// point into the block's rows with a ballot and appends them to its own
// list in shared memory, so a warp's list is in ascending (query, slot)
// order and the lists in warp order are the tile's hits in that order.
// After one barrier the block adds w * g[q] for them in that order: a
// group of threads owns the rows of one residue (row % groups) and a thread
// its channels of them, so no two threads touch one accumulator cell and a
// cell's sum is formed in one fixed order.  The lists are double-buffered
// by the tile's parity, so a tile costs one barrier.  No float atomic
// touches df2, every row is written exactly once (a row no query selects
// is written as 0, so the caller need not zero df2), and two runs give
// identical bits.  The order is that of the plain twin's index_add_ over
// the flattened triples, and each product and sum rounds as there
// (-fmad=false, __f*_rn).
//
// What bounds it on the card: bytes.  g is read once (65.5 MB at
// (2, 64000, 128)), df2 written once (16.4 MB), which is 0.025 ms at
// 3.35 TB/s; the index array (0.77 MB a cloud) is read again by each of
// the n2 / rows blocks of a cloud, 250 times at n2 = 16000 and 64 rows,
// out of L2, 384 MB in all: that sweep, which every block makes over the
// same lines at the same time, and the hits' dependent loads (w, then a
// row of g) are what the kernel spends its time on (PERF.md); 94 tiles a
// block at n1 = 64000 with some 8 hits each; four blocks share a
// multiprocessor (48 KB of shared memory each).  More rows a block cut the
// sweeps but lengthen each block's chain of hits, and lost on the card;
// reading each triple once needs the triples inverted into per-row lists
// first (ROADMAP.md).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLoads = 8;                      // index loads a lane and tile
constexpr int kWarpEntries = 32 * kLoads;      // entries a warp and tile
constexpr int kTile = kWarps * kWarpEntries;   // 2048
constexpr int kMaxRows = 64;
// the accumulator's limit: 44 KB (11264 floats)
constexpr int kSharedFloats = 11264;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads)
interp_bwd_big_kernel(const float* __restrict__ g, const int* __restrict__ idx,
                      const float* __restrict__ w, int n1, int n2, int c,
                      int rows, float* __restrict__ df2) {
  extern __shared__ float acc[];  // rows * c, then the hit lists
  // per parity of the tile and warp: row << 16 | entry within the tile
  int (*hits)[kWarps][kWarpEntries] =
      reinterpret_cast<int (*)[kWarps][kWarpEntries]>(acc + rows * c);
  __shared__ int warp_hits[2][kWarps];

  const int b = blockIdx.y;
  const int lo = blockIdx.x * rows;
  const int cnt = min(rows, n2 - lo);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int total = 3 * n1;
  const int* ib = idx + static_cast<size_t>(b) * total;
  const float* wb = w + static_cast<size_t>(b) * total;
  const float* gb = g + static_cast<size_t>(b) * n1 * c;
  // threads that share the channels of a row: 32, 64, 128 or all 256; the
  // other threads take the rows of another residue
  const int width = c <= 32 ? 32 : c <= 64 ? 64 : c <= 128 ? 128 : kThreads;
  const int groups = kThreads / width;
  const int group = tid / width, ch0 = tid % width;

  for (int e = tid; e < cnt * c; e += kThreads) acc[e] = 0.f;

  for (int base = 0, tile = 0; base < total; base += kTile, ++tile) {
    const int par = tile & 1;
    int row[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int p = base + warp * kWarpEntries + u * 32 + lane;
      row[u] = p < total ? ib[p] - lo : -1;
    }
    int mine = 0;  // the warp's hits so far in this tile
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const bool hit = static_cast<unsigned>(row[u]) < static_cast<unsigned>(cnt);
      const unsigned ballot = __ballot_sync(kFull, hit);
      if (hit) {
        hits[par][warp][mine + __popc(ballot & ((1u << lane) - 1u))] =
            (row[u] << 16) | (warp * kWarpEntries + u * 32 + lane);
      }
      mine += __popc(ballot);
    }
    if (lane == 0) warp_hits[par][warp] = mine;
    // the lists of this tile are complete (and acc is zeroed); the lists of
    // the tile before the last, which this parity held, have been added
    __syncthreads();
    for (int wi = 0; wi < kWarps; ++wi) {
      const int n = warp_hits[par][wi];
      for (int h = 0; h < n; ++h) {
        const int packed = hits[par][wi][h];
        const int r = packed >> 16;
        if (r % groups != group) continue;
        const int p = base + (packed & 0xffff);
        const float wt = wb[p];
        const float* gq = gb + static_cast<size_t>(p / 3) * c;
        float* a = acc + r * c;
        for (int ch = ch0; ch < c; ch += width) {
          a[ch] = __fadd_rn(a[ch], __fmul_rn(wt, gq[ch]));
        }
      }
    }
  }
  __syncthreads();
  float* d = df2 + (static_cast<size_t>(b) * n2 + lo) * c;
  for (int e = tid; e < cnt * c; e += kThreads) d[e] = acc[e];
}

}  // namespace

// g (b, n1, c) float32, idx (b, n1, 3) int32 with values in [0, n2),
// w (b, n1, 3) float32 -> df2 (b, n2, c) float32, every element written.
// c may be at most 11264 (one row's accumulator in 44 KB of shared memory).
extern "C" int amc3d_three_interpolate_backward_big(
    const void* g, const void* idx, const void* w, void* df2, int b, int n1,
    int n2, int c, void* stream) {
  if (c < 1 || c > kSharedFloats || n1 > (0x7fffffff - kTile) / 3) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int rows = kSharedFloats / c;
  rows = rows > kMaxRows ? kMaxRows : rows;
  const int smem = rows * c * static_cast<int>(sizeof(float)) +
                   2 * kTile * static_cast<int>(sizeof(int));
  cudaError_t err = cudaFuncSetAttribute(
      interp_bwd_big_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n2 + rows - 1) / rows, b);
  interp_bwd_big_kernel<<<grid, kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<const int*>(idx),
      static_cast<const float*>(w), n1, n2, c, rows,
      static_cast<float*>(df2));
  return static_cast<int>(cudaGetLastError());
}
