// The VJP of the 3-NN interpolation, deterministic: the forward's (index,
// weight) triples inverted into per-row lists, then each coarse row summed
// once over its own list.
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
// Here every coarse row is written once, by one warp, as the sum of
// w * g[q] over the (query, slot) pairs that select it, in ascending
// (query, slot) order: the order of the plain twin's index_add_ over the
// flattened triples, each product and sum rounded as there (-fmad=false,
// __f*_rn).  No float atomic touches df2, a row no query selects is
// written as 0 (the caller need not zero df2), and two runs give identical
// bits.
//
// What bounds it on the card: bytes.  g is read once (65.5 MB at
// (2, 64000, 128)), df2 written once (16.4 MB): 0.025 ms at 3.35 TB/s.  The
// TPU kernel's shape, a block owning a run of rows and sweeping every
// triple of its cloud for hits, reads the index array once a block (250
// sweeps at n2 = 16000, 384 MB out of L2).  Design: the triples are read
// once and inverted into per-row bins, in two launches and no scan:
//   1. bin_rows: each entry (its flat index 3q + slot, with its weight)
//      claims a place in its row's bin of kBin by an integer atomic; an
//      entry past a full bin goes to a spill list with its row (the order
//      within a bin varies between runs, the set does not);
//   2. sum_rows: a warp a row, the rows taken in the coarse layout's order
//      where the caller has one (neighbouring rows read neighbouring fine
//      points, whose rows of g then stay in L2).  The warp ranks its row's
//      entries by flat index (up to kBin in registers and shuffles; a
//      spilled row's bin and spilled entries through global scratch, any
//      length), which restores the one ascending order, then sums w * g
//      over them with float4 channel vectors a lane and writes the row.
// Lists are about 12 long at fp0 (3 * n1 / n2), 34 at most in the steps'
// and subclouds' stages; a coarse point in a sparse region can be chosen by
// hundreds of fine points, and the spill takes any length.
#include <climits>
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "vector_red.cuh"

namespace {

using namespace amc3d;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBin = 64;            // entries a row holds before it spills
constexpr unsigned kFull = 0xffffffffu;

// An entry: its flat index 3q + slot within its cloud, its weight's bits.
using Entry = int2;

// counts[row] gains each of the m = 3 * n1 entries of cloud b, which goes
// into its row's bin or, past kBin, onto the spill list (rows and entries,
// *spilled of them).
__global__ void __launch_bounds__(kThreads)
bin_rows(const int* __restrict__ idx, const float* __restrict__ w, int m,
         int n2, int* __restrict__ counts, Entry* __restrict__ bins,
         int* __restrict__ spill_rows, Entry* __restrict__ spill,
         int* __restrict__ spilled) {
  const int* ib = idx + static_cast<size_t>(blockIdx.y) * m;
  const float* wb = w + static_cast<size_t>(blockIdx.y) * m;
  const int rb = blockIdx.y * n2;
  for (int e = blockIdx.x * kThreads + threadIdx.x; e < m;
       e += gridDim.x * kThreads) {
    const int row = rb + ib[e];
    const Entry item = make_int2(e, __float_as_int(wb[e]));
    const int at = atomicAdd(counts + row, 1);
    if (at < kBin) {
      bins[static_cast<size_t>(row) * kBin + at] = item;
    } else {
      const int s = atomicAdd(spilled, 1);
      spill_rows[s] = row;
      spill[s] = item;
    }
  }
}

__device__ __forceinline__ void store(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }

// The len entries at `from` (global memory) ranked by flat index into `to`.
__device__ __forceinline__ void rank_long(const Entry* from, Entry* to,
                                         int len, int lane) {
  for (int t0 = 0; t0 < len; t0 += 32) {
    const Entry item = t0 + lane < len ? from[t0 + lane] : make_int2(INT_MAX, 0);
    int at = 0;
    for (int u0 = 0; u0 < len; u0 += 32) {
      const int o = u0 + lane < len ? from[u0 + lane].x : INT_MAX;
      const int cnt = min(32, len - u0);
      for (int j = 0; j < cnt; ++j) at += __shfl_sync(kFull, o, j) < item.x;
    }
    if (t0 + lane < len) to[at] = item;
  }
}

// V = 4: float4 channel vectors (C % 4 == 0, g and df2 on 16 bytes); V = 1:
// scalar.  rows (b, n2) ints rstride apart: the coarse rows in the order
// they are taken (nullptr: index order).  gather and sorted: scratch of
// b * 3 * n1 entries each, for the spilled rows, claimed through *claimed.
template <int V>
__global__ void __launch_bounds__(kThreads)
sum_rows(const float* __restrict__ g, const int* __restrict__ counts,
         const Entry* __restrict__ bins, const int* __restrict__ spill_rows,
         const Entry* __restrict__ spill, const int* __restrict__ spilled,
         Entry* gather, Entry* sorted, int* __restrict__ claimed,
         const int* __restrict__ rows, int rstride, int n1, int n2, int c,
         float* __restrict__ df2) {
  using Vec = typename std::conditional<V == 4, float4, float>::type;
  __shared__ Entry entries[kWarps][kBin];
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rank = blockIdx.x * kWarps + warp;
  if (rank >= n2) return;
  const size_t rb = static_cast<size_t>(b) * n2;
  const int r = rows != nullptr ? rows[(rb + rank) * rstride] : rank;
  const size_t row = rb + r;
  const int len = counts[row];
  const Entry* bin = bins + row * kBin;
  const Entry* src;  // the row's entries in ascending order
  if (len <= kBin) {
    const Entry lo = lane < len ? bin[lane] : make_int2(INT_MAX, 0);
    const Entry hi = lane + 32 < len ? bin[lane + 32] : make_int2(INT_MAX, 0);
    int at_lo = 0, at_hi = 0;
    for (int j = 0; j < len; ++j) {
      const int o = __shfl_sync(kFull, j < 32 ? lo.x : hi.x, j & 31);
      at_lo += o < lo.x;
      at_hi += o < hi.x;
    }
    if (lane < len) entries[warp][at_lo] = lo;
    if (lane + 32 < len) entries[warp][at_hi] = hi;
    __syncwarp();
    src = entries[warp];
  } else {
    // the bin and the spilled entries of this row into gather, then ranked
    // into sorted
    int base = 0;
    if (lane == 0) base = atomicAdd(claimed, len);
    base = __shfl_sync(kFull, base, 0);
    for (int k = lane; k < kBin; k += 32) gather[base + k] = bin[k];
    int at = kBin;
    const int total = *spilled;
    for (int s0 = 0; s0 < total; s0 += 32) {
      const bool mine = s0 + lane < total && spill_rows[s0 + lane] == static_cast<int>(row);
      const unsigned ballot = __ballot_sync(kFull, mine);
      if (mine) gather[base + at + __popc(ballot & ((1u << lane) - 1u))] = spill[s0 + lane];
      at += __popc(ballot);
    }
    __syncwarp();  // orders the lanes' stores before every lane's loads
    rank_long(gather + base, sorted + base, len, lane);
    __syncwarp();
    src = sorted + base;
  }
  const float* gb = g + static_cast<size_t>(b) * n1 * c;
  float* d = df2 + row * c;
  for (int v = lane * V; v < c; v += 32 * V) {
    Vec acc{};
    int k = 0;
    for (; k + 4 <= len; k += 4) {  // four rows of g in flight
      const Entry e0 = src[k], e1 = src[k + 1], e2 = src[k + 2], e3 = src[k + 3];
      const Vec a0 = load_scaled(gb + static_cast<size_t>(e0.x / 3) * c + v, __int_as_float(e0.y), Vec{});
      const Vec a1 = load_scaled(gb + static_cast<size_t>(e1.x / 3) * c + v, __int_as_float(e1.y), Vec{});
      const Vec a2 = load_scaled(gb + static_cast<size_t>(e2.x / 3) * c + v, __int_as_float(e2.y), Vec{});
      const Vec a3 = load_scaled(gb + static_cast<size_t>(e3.x / 3) * c + v, __int_as_float(e3.y), Vec{});
      acc = add_rn(add_rn(add_rn(add_rn(acc, a0), a1), a2), a3);
    }
    for (; k < len; ++k) {
      const Entry e = src[k];
      acc = add_rn(acc, load_scaled(gb + static_cast<size_t>(e.x / 3) * c + v,
                                    __int_as_float(e.y), Vec{}));
    }
    store(d + v, acc);
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// g (b, n1, c) float32, idx (b, n1, 3) int32 with values in [0, n2),
// w (b, n1, 3) float32; rows (b, n2) int32 rstride apart, each row a
// permutation of the coarse rows (the order a warp takes them), or null;
// work: 16-byte aligned int32 scratch of 4 * ceil((b * n2 + 2) / 4) +
// b * n2 * 2 * kBin + 7 * b * 3 * n1 (ops/interpolate.py holds the same
// sum) -> df2 (b, n2, c) float32, every element written.
extern "C" int amc3d_three_interpolate_backward_big(
    const void* g, const void* idx, const void* w, const void* rows,
    int rstride, void* work, void* df2, int b, int n1, int n2, int c,
    void* stream) {
  if (n2 < 1 || c < 1 || rstride < 1 || n1 < 0 || n1 > INT_MAX / 3 ||
      3LL * b * n1 > INT_MAX || static_cast<long long>(b) * n2 * kBin >= INT_MAX ||
      !aligned16(work))
    return static_cast<int>(cudaErrorInvalidValue);
  if (b < 1) return static_cast<int>(cudaSuccess);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int m = 3 * n1, total = b * n2;
  const size_t entries = static_cast<size_t>(b) * m;
  // the counts and two cursors, then (on 16 bytes) the bins, the spilled
  // entries, gather and sorted, then the spilled entries' rows
  int* counts = static_cast<int*>(work);
  int* spilled = counts + total;
  int* claimed = spilled + 1;
  Entry* bins = reinterpret_cast<Entry*>(counts + (total + 2 + 3) / 4 * 4);
  Entry* spill = bins + static_cast<size_t>(total) * kBin;
  Entry* gather = spill + entries;
  Entry* sorted = gather + entries;
  int* spill_rows = reinterpret_cast<int*>(sorted + entries);
  cudaError_t err = cudaMemsetAsync(counts, 0, (total + 2) * sizeof(int), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (m > 0)
    bin_rows<<<dim3((m + kThreads - 1) / kThreads, b), kThreads, 0, st>>>(
        static_cast<const int*>(idx), static_cast<const float*>(w), m, n2,
        counts, bins, spill_rows, spill, spilled);
  const bool vec = c % 4 == 0 && aligned16(g) && aligned16(df2);
  auto* kernel = vec ? &sum_rows<4> : &sum_rows<1>;
  kernel<<<dim3((n2 + kWarps - 1) / kWarps, b), kThreads, 0, st>>>(
      static_cast<const float*>(g), counts, bins, spill_rows, spill, spilled,
      gather, sorted, claimed, static_cast<const int*>(rows), rstride, n1, n2,
      c, static_cast<float*>(df2));
  return static_cast<int>(cudaGetLastError());
}
