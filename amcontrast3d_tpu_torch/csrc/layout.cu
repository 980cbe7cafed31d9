// The sorted layout of a train step's stage clouds, built on the card in
// three launches around one library sort (ops/spatial.py::sort_stages), and
// the (label, threshold) columns the contrast kernels read beside it
// (ops/contrast.py::support_layout).
//
// These replace no TPU kernel: in the JAX package the Morton key, the sort
// and the gathers ahead of the Pallas kernels are XLA code
// (contrast_pallas.py::_morton_key, ::_morton_sort, contrast_reductions).
// Here the same work as a chain of small PyTorch ops is some sixty launches
// a step, on a step whose pace the host's launches set; these kernels make
// it three launches and one sort.
//
// The stage clouds (B, n_s, 3) arrive concatenated, stage by stage, each
// flattened over its batch: segment s * B + b is cloud b of stage s, a
// contiguous run of rows.  layout_keys gives every segment its own frame
// (the lower corner and the factor that maps the largest extent onto 2^16
// cells, as spatial.cloud_frame forms it, op by op in float32) and each
// point the Morton code of its cell with the segment's number in the bits
// above the 48 of the code.  One stable sort of the keys then orders the
// points segment by segment and, within one, exactly as sort_support's
// stable sort along the Morton curve orders that cloud alone.  layout_pack
// writes, per sorted point, the float4 the chunk-pruned kernels read (x, y,
// z, the bits of its index in its cloud), its code and its index, and per
// chunk of 64 sorted points of a segment its exact box (a last, partial
// chunk takes its segment's last point as fill, as spatial.chunk_boxes
// does).  support_aux gathers each sorted point's label and threshold and
// the largest threshold of each chunk (spatial.chunk_max).  Everything is
// a copy, a compare or the frame's float32 arithmetic, so the layout is
// bit for bit sort_support's (up to the sign of a zero in a box).
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

#include "chunks.cuh"
#include "morton.cuh"

namespace {

using amc3d::kChunk;
using amc3d::kMortonCells;
using amc3d::morton_code;

constexpr int kKeyThreads = 512;
constexpr int kCodeBits = 48;

// the block's minimum (MAX = false) or maximum of v; every thread gets it
template <bool MAX>
__device__ float block_reduce(float v, float* scratch) {
  for (int o = 16; o > 0; o >>= 1) {
    const float w = __shfl_xor_sync(0xffffffffu, v, o);
    v = MAX ? fmaxf(v, w) : fminf(v, w);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  v = scratch[0];
  for (int w = 1; w < static_cast<int>(blockDim.x >> 5); ++w)
    v = MAX ? fmaxf(v, scratch[w]) : fminf(v, scratch[w]);
  return v;
}

// a block a segment: its frame, then every point's key
__global__ void __launch_bounds__(kKeyThreads)
layout_keys_kernel(const float* __restrict__ points,
                   const long long* __restrict__ seg, long long* __restrict__ keys,
                   float4* __restrict__ frame) {
  __shared__ float scratch[kKeyThreads / 32];
  const int s = blockIdx.x;
  const long long a = seg[s], e = seg[s + 1];
  float lo[3] = {CUDART_INF_F, CUDART_INF_F, CUDART_INF_F};
  float hi[3] = {-CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F};
  for (long long i = a + threadIdx.x; i < e; i += blockDim.x) {
    for (int c = 0; c < 3; ++c) {
      const float x = points[3 * i + c];
      lo[c] = fminf(lo[c], x);
      hi[c] = fmaxf(hi[c], x);
    }
  }
  for (int c = 0; c < 3; ++c) {
    lo[c] = block_reduce<false>(lo[c], scratch);
    hi[c] = block_reduce<true>(hi[c], scratch);
  }
  // spatial.cloud_frame: the largest extent, clamped, into 2^16 - 1 cells;
  // PyTorch forms `number / tensor` as the reciprocal times the number
  const float extent = fmaxf(fmaxf(__fsub_rn(hi[0], lo[0]), __fsub_rn(hi[1], lo[1])),
                             __fsub_rn(hi[2], lo[2]));
  const float scale = __fmul_rn(__frcp_rn(fmaxf(extent, 1e-12f)),
                                static_cast<float>(kMortonCells));
  if (threadIdx.x == 0) frame[s] = make_float4(lo[0], lo[1], lo[2], scale);
  const uint64_t tag = static_cast<uint64_t>(s) << kCodeBits;
  for (long long i = a + threadIdx.x; i < e; i += blockDim.x) {
    const uint64_t code =
        morton_code(points[3 * i], points[3 * i + 1], points[3 * i + 2], lo, scale);
    keys[i] = static_cast<long long>(tag | code);
  }
}

// a block of 64 threads a chunk: chunk c of segment s covers the sorted
// rows seg[s] + 64 (c - cseg[s]) onwards
__global__ void __launch_bounds__(kChunk)
layout_pack_kernel(const float* __restrict__ points,
                   const long long* __restrict__ perm,
                   const long long* __restrict__ skeys,
                   const long long* __restrict__ seg, const int* __restrict__ cseg,
                   int nseg, float4* __restrict__ packed,
                   long long* __restrict__ codes, long long* __restrict__ index,
                   float* __restrict__ boxes) {
  __shared__ float part[2][6];
  const int c = blockIdx.x;
  int s = 0;
  while (s + 1 < nseg && cseg[s + 1] <= c) ++s;
  const long long a = seg[s], e = seg[s + 1];
  const long long row = a + static_cast<long long>(c - cseg[s]) * kChunk + threadIdx.x;
  const long long src = row < e ? row : e - 1;
  const long long g = perm[src];
  const float x = points[3 * g], y = points[3 * g + 1], z = points[3 * g + 2];
  if (row < e) {
    const long long local = g - a;
    packed[row] = make_float4(x, y, z, __int_as_float(static_cast<int>(local)));
    codes[row] = skeys[row] & ((1ll << kCodeBits) - 1);
    index[row] = local;
  }
  float v[6] = {x, y, z, x, y, z};
  for (int o = 16; o > 0; o >>= 1) {
    for (int j = 0; j < 3; ++j) {
      v[j] = fminf(v[j], __shfl_xor_sync(0xffffffffu, v[j], o));
      v[j + 3] = fmaxf(v[j + 3], __shfl_xor_sync(0xffffffffu, v[j + 3], o));
    }
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0)
    for (int j = 0; j < 6; ++j) part[warp][j] = v[j];
  __syncthreads();
  if (threadIdx.x < 6) {
    const int j = threadIdx.x;
    boxes[6ll * c + j] = j < 3 ? fminf(part[0][j], part[1][j])
                               : fmaxf(part[0][j], part[1][j]);
  }
}

// a block of 64 threads a chunk of a (B, n) layout: grid (nc, B)
__global__ void __launch_bounds__(kChunk)
support_aux_kernel(const long long* __restrict__ perm,
                   const float* __restrict__ lab, const float* __restrict__ kth,
                   int n, float2* __restrict__ aux, float* __restrict__ cmax) {
  __shared__ float part[2];
  const int c = blockIdx.x, b = blockIdx.y, nc = gridDim.x;
  const long long base = static_cast<long long>(b) * n;
  const int row = c * kChunk + threadIdx.x;
  const long long i = base + perm[base + (row < n ? row : n - 1)];
  const float t = kth[i];
  if (row < n) aux[base + row] = make_float2(lab[i], t);
  float m = t;
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0)
    cmax[static_cast<long long>(b) * nc + c] = fmaxf(part[0], part[1]);
}

}  // namespace

// points (T,3) f32, the stage clouds one after another; seg (nseg+1) i64
// the first row of each segment and T; keys (T) i64 out; frame (nseg) float4
// out (lo x, y, z, scale)
extern "C" int amc3d_layout_keys(const void* points, const void* seg, void* keys,
                                 void* frame, int nseg, void* stream) {
  if (nseg < 1 || reinterpret_cast<size_t>(frame) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  layout_keys_kernel<<<nseg, kKeyThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(points), static_cast<const long long*>(seg),
      static_cast<long long*>(keys), static_cast<float4*>(frame));
  return static_cast<int>(cudaGetLastError());
}

// points (T,3), perm (T) i64 and skeys (T) i64 from the stable sort of the
// keys, seg (nseg+1) i64, cseg (nseg+1) i32 the first chunk of each segment
// and the number of chunks; packed (T,4) f32, codes (T) i64, index (T) i64,
// boxes (chunks,6) f32 out
extern "C" int amc3d_layout_pack(const void* points, const void* perm,
                                 const void* skeys, const void* seg,
                                 const void* cseg, void* packed, void* codes,
                                 void* index, void* boxes, int nseg, int chunks,
                                 void* stream) {
  if (nseg < 1 || chunks < 1 || reinterpret_cast<size_t>(packed) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  layout_pack_kernel<<<chunks, kChunk, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(points), static_cast<const long long*>(perm),
      static_cast<const long long*>(skeys), static_cast<const long long*>(seg),
      static_cast<const int*>(cseg), nseg, static_cast<float4*>(packed),
      static_cast<long long*>(codes), static_cast<long long*>(index),
      static_cast<float*>(boxes));
  return static_cast<int>(cudaGetLastError());
}

// perm (B,n) i64 the layout's caller index of each sorted point, lab and
// kth (B,n) f32 in the caller's order; aux (B,n,2) f32 and cmax
// (B,ceil(n/64)) f32 out
extern "C" int amc3d_support_aux(const void* perm, const void* lab,
                                 const void* kth, void* aux, void* cmax, int b,
                                 int n, void* stream) {
  if (b < 1 || n < 1 || reinterpret_cast<size_t>(aux) % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + kChunk - 1) / kChunk, b);
  support_aux_kernel<<<grid, kChunk, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(perm), static_cast<const float*>(lab),
      static_cast<const float*>(kth), n, static_cast<float2*>(aux),
      static_cast<float*>(cmax));
  return static_cast<int>(cudaGetLastError());
}
