// 3-NN inverse-distance interpolation: the forward (a listed scan over the
// coarse cloud's layout) and its VJP (a scatter in the fine layout's order).
//
// Forward.  Replaces amcontrast3d_tpu/ops/interpolate_pallas.py::_interp_kernel,
// the TPU kernel that finds each fine point's 3rd-nearest coarse d^2 and then
// sums w * f over every coarse point at or below it in one matmul per tile.
// That kernel averages d^2 ties at the 3rd neighbour (a 4th point within a
// 1e-6 relative cushion enters with its own weight); this kernel follows
// the JAX plain path (ops/interpolate.py:42-57) instead: exactly three
// neighbours, ties to the lowest index (as lax.top_k), weights
// w_i = 1 / (sqrt(max(d_i^2, 0)) + 1e-8) / sum_j w_j, and
// out[c] = (f[i0,c]*w0 + f[i1,c]*w1) + f[i2,c]*w2.  Every step rounds as
// the plain PyTorch twin in ops/interpolate.py rounds it (-fmad=false,
// __f*_rn, IEEE sqrt and division).  When a gradient is needed the kernel
// also writes each fine point's 3 indices and weights for the backward.
// Missing neighbours (n2 < 3) are index 0 at d^2 = 1e10, as the exact kNN
// pads them.
//
// What bounds it on the card: a dense scan tests N1 * N2 pairs (0.58 G at
// the 24000-by-6000 stage of a S3DIS step, about 9 float instructions
// each), though only the few coarse chunks around a fine point can hold its
// three nearest; what remains is the weighted sum, 3 rows of C floats read
// and one written a fine point (bytes).  Design: the listed kNN scan of
// knn.cu and refine.cu (listed_knn.cuh) with k = 3 over the coarse stage's
// Morton-sorted layout (ops/spatial.py, sorted once a forward with the
// model's other stage clouds).  A block takes 8 fine points consecutive
// along the fine stage's own curve (the order of its layout, or of
// spatial.query_order in the coarse frame when a caller has no layout), a
// warp each; a warp finds its home chunk in the coarse layout by its Morton
// code in the coarse cloud's frame (morton.cuh::home_chunk; given by the
// caller with query_order), the block lists the chunks within the largest
// bound of its 8 once, and each warp scans its home chunk, the ones beside
// it and the listed chunks within its own running 3rd pair.  The slots end
// in (d^2, index) order, ties to the lowest index: the pairs a dense scan's
// strict insertion keeps, so the indices are the twin's exactly.  The same
// warp then forms the weights and writes the fine row, channel-fastest,
// with float4 reads of the 3 coarse rows and a float4 write where C % 4 == 0
// and the tensors sit on 16 bytes.
//
// Backward.  Replaces interpolate_pallas.py::_interp_bwd_kernel, which
// re-derives each support chunk's weights from the thresholds and forms
// df2 = W^T g as one matmul per (query tile, support chunk).  Here the
// forward's saved indices and weights make it a scatter:
// df2[idx[i,k], c] += w[i,k] * g[i,c] for the 3 neighbours of every fine
// point.  Bound: reading g, idx and w and writing df2 once (bytes); a
// scatter in the caller's order issues 3 * N1 * C float atomics instead
// (69 M a S3DIS step), each coarse row's ~12 from blocks far apart.
// Design: a block takes 64 fine points consecutive in the fine layout's
// order (the forward's), whose 192 (coarse row, weight) pairs share a few
// dozen coarse rows; it sorts the pairs by (coarse row, fine rank) in
// shared memory (a bitonic sort, one pair a thread: shuffles within a warp,
// shared memory across), then for each distinct row and each vector of
// channels sums w * g over the row's pairs in that order and adds the sum
// into df2 with one red.global.add.v4.f32 (vector_red.cuh; scalar atomics
// where C % 4 != 0).  A block takes 32 vectors of channels (grid.z over
// the rest): a decoder's coarse stages are few points of many channels.  The blocks still meet in df2 through float atomics,
// so the summation order varies between runs and df2 agrees with the twin's
// index_add_ to rounding (tolerance stated in the tests), not bit for bit.
#include <cstdint>
#include <type_traits>

#include "listed_knn.cuh"
#include "morton.cuh"
#include "vector_red.cuh"

namespace {

using namespace amc3d;

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// (a*w0 + b*w1) + c*w2, each product and sum rounded on its own
__device__ __forceinline__ float blend(float a, float b, float c, float w0,
                                       float w1, float w2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, w0), __fmul_rn(b, w1)),
                   __fmul_rn(c, w2));
}

// V = 4: float4 rows (C % 4 == 0, 16-byte aligned f2 and out); V = 1: scalar
template <int V>
__global__ void __launch_bounds__(kListThreads)
interp_kernel(const float4* __restrict__ coarse,
              const float* __restrict__ boxes,
              const long long* __restrict__ codes,
              const float* __restrict__ frame_lo, int lo_stride,
              const float* __restrict__ frame_scale, int scale_stride,
              const float* __restrict__ p1, const int* __restrict__ order,
              int ostride, const int* __restrict__ home,
              const float* __restrict__ f2, int n1, int n2, int c,
              float* __restrict__ out, int* __restrict__ idx_out,
              float* __restrict__ w_out) {
  __shared__ ListedShared sh;
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int rank = blockIdx.x * kListWarps + (threadIdx.x >> 5);
  const int nc = (n2 + kChunk - 1) / kChunk;
  const size_t qrow = static_cast<size_t>(b) * n1;
  const float4* sup = coarse + static_cast<size_t>(b) * n2;
  ListedQuery q{rank < n1, 0, 0.f, 0.f, 0.f, 0};
  if (q.active) {
    q.qi = order[(qrow + rank) * ostride];
    const float* p = p1 + (qrow + q.qi) * 3;
    q.x = p[0];
    q.y = p[1];
    q.z = p[2];
    q.home = home != nullptr
                 ? home[qrow + rank]
                 : home_chunk(codes + static_cast<size_t>(b) * n2, n2,
                              frame_lo + static_cast<size_t>(b) * lo_stride,
                              frame_scale[static_cast<size_t>(b) * scale_stride],
                              q.x, q.y, q.z, lane);
  }
  ChunkSearch<1, false> s;
  s.init(3, lane, 1e10f);  // the fillers of missing neighbours
  listed_knn(sup, boxes + static_cast<size_t>(b) * nc * 6, n2, nc, 3, 0,
             min(kListWarps, n1 - static_cast<int>(blockIdx.x) * kListWarps),
             q, sh, s);
  if (!q.active) return;

  // slot s sits in lane s
  const float d0 = __shfl_sync(kFullMask, s.top.d[0], 0);
  const float d1 = __shfl_sync(kFullMask, s.top.d[0], 1);
  const float d2 = __shfl_sync(kFullMask, s.top.d[0], 2);
  const int i0 = __shfl_sync(kFullMask, s.top.i[0], 0);
  const int i1 = __shfl_sync(kFullMask, s.top.i[0], 1);
  const int i2 = __shfl_sync(kFullMask, s.top.i[0], 2);
  const float r0 = __fdiv_rn(1.0f, __fadd_rn(__fsqrt_rn(fmaxf(d0, 0.f)), 1e-8f));
  const float r1 = __fdiv_rn(1.0f, __fadd_rn(__fsqrt_rn(fmaxf(d1, 0.f)), 1e-8f));
  const float r2 = __fdiv_rn(1.0f, __fadd_rn(__fsqrt_rn(fmaxf(d2, 0.f)), 1e-8f));
  const float norm = __fadd_rn(__fadd_rn(r0, r1), r2);
  const float w0 = __fdiv_rn(r0, norm);
  const float w1 = __fdiv_rn(r1, norm);
  const float w2 = __fdiv_rn(r2, norm);
  const size_t row = qrow + q.qi;
  if (idx_out != nullptr && lane < 3) {
    idx_out[row * 3 + lane] = lane == 0 ? i0 : (lane == 1 ? i1 : i2);
    w_out[row * 3 + lane] = lane == 0 ? w0 : (lane == 1 ? w1 : w2);
  }
  const float* f = f2 + static_cast<size_t>(b) * n2 * c;
  const float* g0 = f + static_cast<size_t>(i0) * c;
  const float* g1 = f + static_cast<size_t>(i1) * c;
  const float* g2 = f + static_cast<size_t>(i2) * c;
  float* o = out + row * c;
  if constexpr (V == 4) {
    for (int ch = 4 * lane; ch < c; ch += 128) {
      const float4 a = load4(g0 + ch), e = load4(g1 + ch), h = load4(g2 + ch);
      *reinterpret_cast<float4*>(o + ch) = make_float4(
          blend(a.x, e.x, h.x, w0, w1, w2), blend(a.y, e.y, h.y, w0, w1, w2),
          blend(a.z, e.z, h.z, w0, w1, w2), blend(a.w, e.w, h.w, w0, w1, w2));
    }
  } else {
    for (int ch = lane; ch < c; ch += 32)
      o[ch] = blend(__ldg(g0 + ch), __ldg(g1 + ch), __ldg(g2 + ch), w0, w1, w2);
  }
}

constexpr int kBwdPoints = 64;               // fine points a backward block
constexpr int kBwdPairs = 3 * kBwdPoints;    // their (coarse row, weight) pairs
constexpr int kBwdThreads = 256;             // one pair a thread in the sort
constexpr int kBwdTile = 32;                 // vectors of channels a block
static_assert(kBwdPairs <= kBwdThreads, "the sort holds every pair");
static_assert((kBwdThreads & (kBwdThreads - 1)) == 0, "a bitonic sort's width");

// V = 4: float4 loads and vector reductions (C % 4 == 0, g and df2 on 16
// bytes); V = 1: scalar.  order (b, n1), ostride apart: the fine points in
// the order they are taken (nullptr: the caller's).  Block (x, b, z) takes
// the channel vectors z * kBwdTile ... of its fine points, so a wide row
// spreads over blocks where the fine points are few.
template <int V>
__global__ void __launch_bounds__(kBwdThreads)
interp_bwd_kernel(const float* __restrict__ g, const int* __restrict__ idx,
                  const float* __restrict__ w, const int* __restrict__ order,
                  int ostride, int n1, int n2, int c, float* __restrict__ df2) {
  using Vec = typename std::conditional<V == 4, float4, float>::type;
  using Key = unsigned long long;
  __shared__ Key keys[kBwdThreads];
  __shared__ int fine[kBwdPoints];
  __shared__ float wts[kBwdPairs];
  __shared__ int head[kBwdPairs + 1];
  __shared__ int warp_heads[kBwdThreads / 32];
  const int b = blockIdx.y;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int r0 = blockIdx.x * kBwdPoints;
  const int npairs = 3 * min(kBwdPoints, n1 - r0);
  const size_t qrow = static_cast<size_t>(b) * n1;
  if (t < npairs / 3)
    fine[t] = order != nullptr ? order[(qrow + r0 + t) * ostride] : r0 + t;
  __syncthreads();
  // the pair's key: its coarse row above its rank in the block
  Key key = ~0ull;
  if (t < npairs) {
    const size_t at = (qrow + fine[t / 3]) * 3 + t % 3;
    key = (static_cast<Key>(static_cast<unsigned>(idx[at])) << 32) |
          static_cast<unsigned>(t);
    wts[t] = w[at];
  }
  // bitonic sort, ascending: strides below a warp by shuffles, the others
  // through shared memory
#pragma unroll
  for (int size = 2; size <= kBwdThreads; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      Key other;
      if (stride >= 32) {
        keys[t] = key;
        __syncthreads();
        other = keys[t ^ stride];
        __syncthreads();
      } else {
        other = __shfl_xor_sync(kFullMask, key, stride);
      }
      const bool keep_min = ((t & stride) == 0) == ((t & size) == 0);
      key = keep_min ? (other < key ? other : key) : (other > key ? other : key);
    }
  }
  keys[t] = key;
  __syncthreads();
  // the first pair of each coarse row, compacted into head[0 .. nseg)
  const bool is_head = t < npairs && (t == 0 || (keys[t - 1] >> 32) != (key >> 32));
  const unsigned heads = __ballot_sync(kFullMask, is_head);
  if (lane == 0) warp_heads[warp] = __popc(heads);
  __syncthreads();
  int at = __popc(heads & ((1u << lane) - 1u)), nseg = 0;
#pragma unroll
  for (int v = 0; v < kBwdThreads / 32; ++v) {
    at += v < warp ? warp_heads[v] : 0;
    nseg += warp_heads[v];
  }
  if (is_head) head[at] = t;
  if (t == 0) head[nseg] = npairs;
  __syncthreads();

  // each (row, vector of channels): its pairs' w * g summed in rank order,
  // then one reduction into df2
  const int v0 = blockIdx.z * kBwdTile;
  const int tile = min(kBwdTile, c / V - v0);
  const float* gb = g + qrow * c;
  float* db = df2 + static_cast<size_t>(b) * n2 * c;
  for (int e = t; e < nseg * tile; e += kBwdThreads) {
    const int sg = e / tile, v = v0 + e - sg * tile;
    const int j0 = head[sg], j1 = head[sg + 1];
    const Key k0 = keys[j0];
    int p = static_cast<int>(static_cast<unsigned>(k0));
    Vec acc = load_scaled(gb + static_cast<size_t>(fine[p / 3]) * c + v * V,
                          wts[p], Vec{});
    for (int j = j0 + 1; j < j1; ++j) {
      p = static_cast<int>(static_cast<unsigned>(keys[j]));
      acc = add_rn(acc, load_scaled(gb + static_cast<size_t>(fine[p / 3]) * c + v * V,
                                    wts[p], Vec{}));
    }
    red_add(db + static_cast<size_t>(k0 >> 32) * c + v * V, acc);
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// The coarse cloud's layout: sorted (b, n2) float4, its points along the
// Morton curve with the bits of each point's index in w, boxes
// (b, ceil(n2 / 64), 6), its sorted Morton codes (b, n2) int64 in the frame
// lo (b rows of 3 floats, lo_stride apart) and scale (b floats,
// scale_stride apart); p1 (b, n1, 3) fine points; order: the fine points'
// indices in the order they are worked on, (b, n1) int32 ostride apart;
// home (b, n1) int32, per entry of order the coarse chunk to start from, or
// null (found from the point's Morton code); f2 (b, n2, c) float32 in the
// caller's coarse order -> out (b, n1, c) float32; idx_out (b, n1, 3) int32
// and w_out (b, n1, 3) float32 are written too unless null.
extern "C" int amc3d_three_interpolate(
    const void* sorted, const void* boxes, const void* codes, const void* lo,
    int lo_stride, const void* scale, int scale_stride, const void* p1,
    const void* order, int ostride, const void* home, const void* f2,
    void* out, void* idx_out, void* w_out, int b, int n1, int n2, int c,
    void* stream) {
  if (n2 < 1 || c < 1 || ostride < 1 || !aligned16(sorted))
    return static_cast<int>(cudaErrorInvalidValue);
  if (b < 1 || n1 < 1) return static_cast<int>(cudaSuccess);
  const dim3 grid((n1 + kListWarps - 1) / kListWarps, b);
  const bool vec = c % 4 == 0 && aligned16(f2) && aligned16(out);
  auto* kernel = vec ? &interp_kernel<4> : &interp_kernel<1>;
  kernel<<<grid, kListThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(sorted), static_cast<const float*>(boxes),
      static_cast<const long long*>(codes), static_cast<const float*>(lo),
      lo_stride, static_cast<const float*>(scale), scale_stride,
      static_cast<const float*>(p1), static_cast<const int*>(order), ostride,
      static_cast<const int*>(home), static_cast<const float*>(f2), n1, n2, c,
      static_cast<float*>(out), static_cast<int*>(idx_out),
      static_cast<float*>(w_out));
  return static_cast<int>(cudaGetLastError());
}

// g (b, n1, c), idx (b, n1, 3) int32, w (b, n1, 3) float32, order (b, n1)
// int32 ostride apart (a permutation of each row's fine points: the order
// they are taken in) or null (the caller's order) -> df2 (b, n2, c)
// float32, zeroed here on the stream, then w * g added in.
extern "C" int amc3d_three_interpolate_backward(const void* g, const void* idx,
                                                const void* w,
                                                const void* order, int ostride,
                                                void* df2, int b, int n1,
                                                int n2, int c, void* stream) {
  if (n2 < 1 || c < 1 || ostride < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = cudaMemsetAsync(
      df2, 0, static_cast<size_t>(b) * n2 * c * sizeof(float), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b < 1 || n1 < 1) return static_cast<int>(cudaSuccess);
  const bool vec = c % 4 == 0 && aligned16(g) && aligned16(df2);
  const int vectors = vec ? c / 4 : c;
  const dim3 grid((n1 + kBwdPoints - 1) / kBwdPoints, b,
                  (vectors + kBwdTile - 1) / kBwdTile);
  auto* kernel = vec ? &interp_bwd_kernel<4> : &interp_bwd_kernel<1>;
  kernel<<<grid, kBwdThreads, 0, st>>>(
      static_cast<const float*>(g), static_cast<const int*>(idx),
      static_cast<const float*>(w), static_cast<const int*>(order), ostride,
      n1, n2, c, static_cast<float*>(df2));
  return static_cast<int>(cudaGetLastError());
}
