// 3-NN inverse-distance interpolation onto many fine points: a lane a fine
// point, a block a run of 256 of them along the fine layout's curve, the
// coarse chunks a warp needs staged once in shared memory for its 32 lanes.
//
// Replaces three TPU kernels of amcontrast3d_tpu/ops/interpolate_pallas.py
// (entry _interp_fwd_big, reached when the coarse buffer exceeds VMEM:
// the whole-scene test's fp0 from the 221184 bucket up):
// _interp_thr_seed_kernel (an upper bound on each fine point's 3rd-nearest
// d^2 from one chunk placed proportionally to its query tile),
// _interp_thr_kernel (the exact 3rd-nearest d^2 by a box-pruned sweep of
// the kd-sorted chunks) and _interp_acc_big_kernel (the weighted sum over
// the coarse points within that threshold).  On the TPU the three are grid
// phases because VMEM cannot hold the support; here each lane carries its
// fine point's 3 best (d^2, index) pairs in registers through all three.
//
// Semantics are exactly those of interpolate.cu and of the plain PyTorch
// twin (ops/interpolate.py): exactly three neighbours in (d^2, index)
// order, ties to the lowest index, (1e10, index 0) for missing ones;
// w_i = 1 / (sqrt(max(d_i^2, 0)) + 1e-8) normalised by (r0 + r1) + r2;
// out[c] = (f[i0,c]*w0 + f[i1,c]*w1) + f[i2,c]*w2, every step rounded as
// interpolate.cu rounds it (-fmad=false, __f*_rn), so the output, indices
// and weights are the same bits as interpolate.cu's on the same input.  The
// TPU kernels admit every coarse point within thr * (1 + 1e-6) instead, so
// at a near-tie at the 3rd neighbour they average in a 4th point (a
// difference by design).
//
// What bounds it on the card: the rows, 3 of C floats read and one written
// a fine point (113 MB written at 221184 -> 55296, C = 128), and the box
// tests and distance tests of the chunks around each point.  What held the
// listed scan of interpolate.cu back at these shapes is latency: a warp a
// fine point runs a chain of dependent steps (its home chunk by a search of
// the coarse codes, each chunk's scan and merge, the weights) for one
// point, while at fp0 a 64-point chunk serves about 256 fine points.  Here
// a block takes 256 fine points consecutive on the fine layout's curve (or
// on spatial.query_order's, in the coarse frame), a lane each:
//   1. each warp finds one home chunk, that of its middle point (given by
//      query_order, or morton.cuh::home_chunk over the coarse codes), and
//      scans it and the chunks beside it: the warp copies a chunk into its
//      own 1 KB of shared memory and every lane tests all of its points
//      against its own point, keeping its three best pairs by strict
//      (d^2, index) insertion, so no shuffles or merges are needed;
//   2. each warp posts the union box of its points and the largest 3rd d^2
//      among them (a bound no lane's final 3rd can exceed); the block tests
//      every chunk's box once against the block's union box, then against
//      each warp's (chunks.cuh's monotone float32 bounds), and lists the
//      chunks with the warps that need them, 1024 chunks a window;
//   3. each warp scans the listed chunks it needs whose box bound is not
//      above some lane's running 3rd pair;
//   4. each lane forms its weights, and the warp writes its 32 rows two
//      at a time, channel-fastest, float4 reads of the 3 coarse rows
//      (f2 in the caller's order stays in L2: 28 MB at 55296 x 128) and a
//      float4 write where C % 4 == 0 and the tensors sit on 16 bytes.
// Row offsets are size_t (N1 * C reaches 1.6e8 at the top bucket).
#include <cstdint>

#include <math_constants.h>

#include "chunks.cuh"
#include "morton.cuh"

namespace {

using namespace amc3d;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;       // fine points a block
constexpr int kPerThread = 4;               // chunks a thread lists
constexpr int kWindow = kThreads * kPerThread;
constexpr int kNear = 1;                    // chunks each side of a home
constexpr int kRows = 2;                    // rows a warp writes at once
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool before(float d, int i, float e, int j) {
  return d < e || (d == e && i < j);
}

// a lane's three best (d^2, index) pairs, in (d^2, index) order
struct Top3 {
  float d0, d1, d2;
  int i0, i1, i2;

  __device__ __forceinline__ void insert(float d, int i) {
    if (!before(d, i, d2, i2)) return;
    const bool b1 = before(d, i, d1, i1), b0 = before(d, i, d0, i0);
    d2 = b1 ? d1 : d;
    i2 = b1 ? i1 : i;
    d1 = b0 ? d0 : (b1 ? d : d1);
    i1 = b0 ? i0 : (b1 ? i : i1);
    d0 = b0 ? d : d0;
    i0 = b0 ? i : i0;
  }
};

// The warp scans chunk c of the sorted support: copied into `stage` (the
// warp's 64 float4), then each active lane tests every point.
__device__ __forceinline__ void scan_chunk(const float4* __restrict__ sup,
                                           int n, int c, float4* stage,
                                           int lane, bool active, float qx,
                                           float qy, float qz, Top3& t) {
  const int base = c * kChunk;
  const int len = min(kChunk, n - base);
  __syncwarp();  // the last chunk's reads are done
  if (lane < len) stage[lane] = sup[base + lane];
  if (lane + 32 < len) stage[lane + 32] = sup[base + lane + 32];
  __syncwarp();
  if (!active) return;
#pragma unroll 8
  for (int k = 0; k < len; ++k) {
    const float4 p = stage[k];
    const float d = point_d2(qx, qy, qz, p.x, p.y, p.z);
    if (d <= t.d2) t.insert(d, __float_as_int(p.w));
  }
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fminf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// (a*w0 + b*w1) + c*w2, each product and sum rounded on its own
__device__ __forceinline__ float blend(float a, float b, float c, float w0,
                                       float w1, float w2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, w0), __fmul_rn(b, w1)),
                   __fmul_rn(c, w2));
}

__device__ __forceinline__ float recip(float d2) {
  return __fdiv_rn(1.0f, __fadd_rn(__fsqrt_rn(fmaxf(d2, 0.f)), 1e-8f));
}

// V = 4: float4 rows (C % 4 == 0, 16-byte aligned f2 and out); V = 1: scalar
template <int V>
__global__ void __launch_bounds__(kThreads, 3)
interp_big_kernel(const float4* __restrict__ coarse,
                  const float* __restrict__ boxes,
                  const long long* __restrict__ codes,
                  const float* __restrict__ frame_lo, int lo_stride,
                  const float* __restrict__ frame_scale, int scale_stride,
                  const float* __restrict__ p1, const int* __restrict__ order,
                  int ostride, const int* __restrict__ home,
                  const float* __restrict__ f2, int n1, int n2, int c,
                  float* __restrict__ out, int* __restrict__ idx_out,
                  float* __restrict__ w_out,
                  unsigned long long* __restrict__ visits) {
  __shared__ float4 stage[kWarps][kChunk];
  __shared__ float wbox[kWarps][6];
  __shared__ float wlimit[kWarps];
  __shared__ int wnear[kWarps][2];
  __shared__ int list[kWindow];
  __shared__ unsigned char need[kWindow];
  __shared__ int counts[kWarps];
  __shared__ unsigned long long block_visits;

  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int first = blockIdx.x * kThreads;
  const int rank = first + threadIdx.x;
  const bool active = rank < n1;
  const int nc = (n2 + kChunk - 1) / kChunk;
  const size_t qrow = static_cast<size_t>(b) * n1;
  const float4* sup = coarse + static_cast<size_t>(b) * n2;
  const float* bx = boxes + static_cast<size_t>(b) * nc * 6;
  if (threadIdx.x == 0) block_visits = 0;

  int qi = 0;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (active) {
    qi = order[(qrow + rank) * ostride];
    const float* p = p1 + (qrow + qi) * 3;
    qx = p[0];
    qy = p[1];
    qz = p[2];
  }
  Top3 t{1e10f, 1e10f, 1e10f, 0, 0, 0};  // the fillers of missing neighbours
  unsigned long long scanned = 0;
  // phase 1: the warp's home chunk (its middle point's) and the ones beside
  const unsigned act = __ballot_sync(kFull, active);  // a prefix of lanes
  int near_lo = 0, near_hi = 0;
  if (act != 0) {
    const int mid = min(16, __popc(act) - 1);
    const float mx = __shfl_sync(kFull, qx, mid);
    const float my = __shfl_sync(kFull, qy, mid);
    const float mz = __shfl_sync(kFull, qz, mid);
    const int h = home != nullptr
                      ? home[qrow + first + warp * 32 + mid]
                      : home_chunk(codes + static_cast<size_t>(b) * n2, n2,
                                   frame_lo + static_cast<size_t>(b) * lo_stride,
                                   frame_scale[static_cast<size_t>(b) * scale_stride],
                                   mx, my, mz, lane);
    near_lo = max(0, h - kNear);
    near_hi = min(nc, h + kNear + 1);
    for (int cc = near_lo; cc < near_hi; ++cc)
      scan_chunk(sup, n2, cc, stage[warp], lane, active, qx, qy, qz, t);
    scanned = near_hi - near_lo;
  }
  // the warp's union box and the largest 3rd d^2 of its lanes
  {
    const float lx = warp_min(active ? qx : CUDART_INF_F);
    const float ly = warp_min(active ? qy : CUDART_INF_F);
    const float lz = warp_min(active ? qz : CUDART_INF_F);
    const float hx = warp_max(active ? qx : -CUDART_INF_F);
    const float hy = warp_max(active ? qy : -CUDART_INF_F);
    const float hz = warp_max(active ? qz : -CUDART_INF_F);
    const float lim = warp_max(active ? t.d2 : -1.f);  // an idle warp: none
    if (lane == 0) {
      wbox[warp][0] = lx;
      wbox[warp][1] = ly;
      wbox[warp][2] = lz;
      wbox[warp][3] = hx;
      wbox[warp][4] = hy;
      wbox[warp][5] = hz;
      wlimit[warp] = lim;
      wnear[warp][0] = near_lo;
      wnear[warp][1] = near_hi;
    }
  }
  __syncthreads();
  float ub[6];
  float block_limit = -1.f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    ub[a] = CUDART_INF_F;
    ub[3 + a] = -CUDART_INF_F;
  }
  for (int v = 0; v < kWarps; ++v) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      ub[a] = fminf(ub[a], wbox[v][a]);
      ub[3 + a] = fmaxf(ub[3 + a], wbox[v][3 + a]);
    }
    block_limit = fmaxf(block_limit, wlimit[v]);
  }

  // phases 2 and 3, a window of chunks at a time
  for (int w0 = 0; w0 < nc; w0 += kWindow) {
    const int c0 = w0 + threadIdx.x * kPerThread;
    unsigned masks = 0;  // 8 bits a chunk: the warps that need it
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int cc = c0 + j;
      if (cc >= nc) break;
      const float* box = bx + static_cast<size_t>(cc) * 6;
      if (box_box_lower_bound(ub, box) > block_limit) continue;
      unsigned m = 0;
      for (int v = 0; v < kWarps; ++v) {
        if ((cc < wnear[v][0] || cc >= wnear[v][1]) &&
            !(box_box_lower_bound(wbox[v], box) > wlimit[v]))
          m |= 1u << v;
      }
      masks |= m << (8 * j);
    }
    // the chunks some warp needs, compacted in chunk order
    int mine = 0;
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) mine += ((masks >> (8 * j)) & 0xffu) != 0;
    int upto = mine;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int x = __shfl_up_sync(kFull, upto, off);
      if (lane >= off) upto += x;
    }
    if (lane == 31) counts[warp] = upto;
    __syncthreads();
    int at = upto - mine, total = 0;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) {
      at += v < warp ? counts[v] : 0;
      total += counts[v];
    }
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const unsigned m = (masks >> (8 * j)) & 0xffu;
      if (m != 0) {
        list[at] = c0 + j;
        need[at++] = static_cast<unsigned char>(m);
      }
    }
    __syncthreads();
    if (act != 0) {
      for (int e = 0; e < total; ++e) {
        if (!((need[e] >> warp) & 1u)) continue;
        const int cc = list[e];
        const float lb = box_lower_bound(qx, qy, qz, bx + static_cast<size_t>(cc) * 6);
        if (__any_sync(kFull, active && !(lb > t.d2))) {
          scan_chunk(sup, n2, cc, stage[warp], lane, active, qx, qy, qz, t);
          ++scanned;
        }
      }
    }
    __syncthreads();  // the list and counts are rewritten by the next window
  }
  if (visits != nullptr) {
    if (lane == 0) atomicAdd(&block_visits, scanned);
    __syncthreads();
    if (threadIdx.x == 0) atomicAdd(visits, block_visits);
  }
  if (act == 0) return;

  // phase 4: the weights, then the warp's rows
  const float r0 = recip(t.d0), r1 = recip(t.d1), r2 = recip(t.d2);
  const float norm = __fadd_rn(__fadd_rn(r0, r1), r2);
  const float w0 = __fdiv_rn(r0, norm);
  const float w1 = __fdiv_rn(r1, norm);
  const float w2 = __fdiv_rn(r2, norm);
  if (active && idx_out != nullptr) {
    const size_t row = (qrow + qi) * 3;
    idx_out[row] = t.i0;
    idx_out[row + 1] = t.i1;
    idx_out[row + 2] = t.i2;
    w_out[row] = w0;
    w_out[row + 1] = w1;
    w_out[row + 2] = w2;
  }
  // kRows rows at a time, so a lane has 3 * kRows loads of coarse rows in
  // flight
  const float* f = f2 + static_cast<size_t>(b) * n2 * c;
  const int count = __popc(act);
  for (int j0 = 0; j0 < count; j0 += kRows) {
    const float* g0[kRows];
    const float* g1[kRows];
    const float* g2[kRows];
    float* o[kRows];
    float a0[kRows], a1[kRows], a2[kRows];
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const int j = min(j0 + u, count - 1);  // a row past the end repeats
      o[u] = out + (qrow + __shfl_sync(kFull, qi, j)) * c;
      g0[u] = f + static_cast<size_t>(__shfl_sync(kFull, t.i0, j)) * c;
      g1[u] = f + static_cast<size_t>(__shfl_sync(kFull, t.i1, j)) * c;
      g2[u] = f + static_cast<size_t>(__shfl_sync(kFull, t.i2, j)) * c;
      a0[u] = __shfl_sync(kFull, w0, j);
      a1[u] = __shfl_sync(kFull, w1, j);
      a2[u] = __shfl_sync(kFull, w2, j);
    }
    const int rows = min(kRows, count - j0);
    if constexpr (V == 4) {
      for (int ch = 4 * lane; ch < c; ch += 128) {
        float4 x[kRows], y[kRows], z[kRows];
#pragma unroll
        for (int u = 0; u < kRows; ++u) {
          x[u] = load4(g0[u] + ch);
          y[u] = load4(g1[u] + ch);
          z[u] = load4(g2[u] + ch);
        }
#pragma unroll
        for (int u = 0; u < kRows; ++u) {
          if (u < rows)
            *reinterpret_cast<float4*>(o[u] + ch) = make_float4(
                blend(x[u].x, y[u].x, z[u].x, a0[u], a1[u], a2[u]),
                blend(x[u].y, y[u].y, z[u].y, a0[u], a1[u], a2[u]),
                blend(x[u].z, y[u].z, z[u].z, a0[u], a1[u], a2[u]),
                blend(x[u].w, y[u].w, z[u].w, a0[u], a1[u], a2[u]));
        }
      }
    } else {
      for (int ch = lane; ch < c; ch += 32) {
        float x[kRows], y[kRows], z[kRows];
#pragma unroll
        for (int u = 0; u < kRows; ++u) {
          x[u] = __ldg(g0[u] + ch);
          y[u] = __ldg(g1[u] + ch);
          z[u] = __ldg(g2[u] + ch);
        }
#pragma unroll
        for (int u = 0; u < kRows; ++u)
          if (u < rows) o[u][ch] = blend(x[u], y[u], z[u], a0[u], a1[u], a2[u]);
      }
    }
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
// null (found from the Morton code of each warp's middle point); f2
// (b, n2, c) float32 in the caller's coarse order -> out (b, n1, c)
// float32; idx_out (b, n1, 3) int32 and w_out (b, n1, 3) float32 are
// written too unless null; visits (one uint64 the caller zeroes, or null)
// gains the chunks the warps scanned.
extern "C" int amc3d_three_interpolate_big(
    const void* sorted, const void* boxes, const void* codes, const void* lo,
    int lo_stride, const void* scale, int scale_stride, const void* p1,
    const void* order, int ostride, const void* home, const void* f2,
    void* out, void* idx_out, void* w_out, void* visits, int b, int n1,
    int n2, int c, void* stream) {
  if (n2 < 1 || c < 1 || ostride < 1 || !aligned16(sorted))
    return static_cast<int>(cudaErrorInvalidValue);
  if (b < 1 || n1 < 1) return static_cast<int>(cudaSuccess);
  const dim3 grid((n1 + kThreads - 1) / kThreads, b);
  const bool vec = c % 4 == 0 && aligned16(f2) && aligned16(out);
  auto* kernel = vec ? &interp_big_kernel<4> : &interp_big_kernel<1>;
  kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(sorted), static_cast<const float*>(boxes),
      static_cast<const long long*>(codes), static_cast<const float*>(lo),
      lo_stride, static_cast<const float*>(scale), scale_stride,
      static_cast<const float*>(p1), static_cast<const int*>(order), ostride,
      static_cast<const int*>(home), static_cast<const float*>(f2), n1, n2, c,
      static_cast<float*>(out), static_cast<int*>(idx_out),
      static_cast<float*>(w_out),
      static_cast<unsigned long long*>(visits));
  return static_cast<int>(cudaGetLastError());
}
