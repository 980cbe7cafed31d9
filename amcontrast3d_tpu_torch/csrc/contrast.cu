// Adaptive-margin contrast reductions over threshold neighbourhoods, and
// their VJP: three kernels.
//
// Replaces amcontrast3d_tpu/ops/contrast_pallas.py::_fwd_kernel (in its
// external-threshold mode, has_kth=True), ::_bwd_rows_kernel and
// ::_bwd_sup_kernel.  For point i of a cloud, its neighbours are
// {j != i : d2_ij <= kth_i}, d2 in the direct form (dx*dx + dy*dy) + dz*dz
// (-fmad=false: bit-identical to the plain twin, so membership is exact),
// s_ij = f_i . f_j, e_ij = exp(s_ij * tinv), pm_ij = same label:
//   forward  out[i] = [P, Q, Spos, Sneg, npos, nneg, dpos, dneg, kth_i]
//   rows     df_i = sum_j w_ij f_j
//   support  df_j = sum_i w_ij f_i  (i ranges over the queries whose own
//            threshold admits j, d2_ij <= kth_i)
// with w_ij = (pm ? gP_i : gQ_i) * e_ij * tinv (+ (pm ? gSpos_i : gSneg_i)
// when need_s).  Similarities are full float32 (no tensor cores, no TF32).
//
// None of the three scans the whole cloud.  Like the TPU kernels, which
// skip a chunk whose box lies beyond the tile's threshold bound
// (contrast_pallas.py:237, :279-283 forward, :326-329 rows, :405-411
// support) over a cloud sorted on the way in (:674-695), they read the
// cloud's Morton-sorted layout (ops/spatial.py, the one the stage's
// self-kNN read) and its sorted (label, threshold) columns
// (ops/contrast.py::support_layout).  A block takes 8 points consecutive
// along the curve, a warp each (chunk_list.cuh), and tests each 64-point
// chunk once against the union box of the 8 and a limit: the forward and
// the rows half, where the threshold is the warp's own point's, the largest
// threshold of the 8; the support half, where it is the other point's, the
// chunk's largest threshold.  The chunks that pass form a list in shared
// memory; each warp tests the listed boxes against its own point, one a
// lane, and scans each chunk that passes, one point a lane, reading the
// sorted points and columns through L1.  Every bound is exact in float32
// without a cushion (chunks.cuh), so the members, and the forward's counts,
// are the plain twin's.  A point never counts itself: the test is on its
// place in the sorted order, not its position, since clouds repeat points.
// For each member the warp reads the other point's feature row by its
// original index, coalesced (lane l holds channels l, l+32, ...), reduces
// the dot product with xor shuffles (every lane ends with the same sum) and
// accumulates in registers.  The sums follow the fixed chunk order and lane
// order within a chunk, so two runs give the same bits; each result is
// written once, at the point's original index.  What bounds them on the
// card is the feature work of the ~nsample members a point (2.2 M C-wide
// dot products at the 4 x 24000 stage) and the listed chunks' position
// tests; the dense kernels they replace tested all N^2 pairs.  Staging the
// listed chunks in shared memory by bulk asynchronous copies measured
// slower (PERF.md): each warp then waits on every listed chunk in turn.
#include <cuda_runtime.h>

#include <type_traits>

#include "chunk_list.cuh"

namespace {

using amc3d::kChunk;
using amc3d::kListChunks;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kWarps == amc3d::kListWarps, "a warp a point");

__device__ __forceinline__ float d2_of(float4 s, float qx, float qy, float qz) {
  const float dx = __fsub_rn(s.x, qx);
  const float dy = __fsub_rn(s.y, qy);
  const float dz = __fsub_rn(s.z, qz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// lane holds channels lane, lane + 32, ... of a C-wide row (0 past C)
template <int CPL>
__device__ __forceinline__ void load_row(const float* __restrict__ row, int c,
                                         int lane, float (&v)[CPL]) {
#pragma unroll
  for (int t = 0; t < CPL; ++t) {
    const int ch = lane + 32 * t;
    v[t] = ch < c ? row[ch] : 0.f;
  }
}

template <int CPL>
__device__ __forceinline__ void store_row(float* __restrict__ row, int c,
                                          int lane, const float (&v)[CPL]) {
#pragma unroll
  for (int t = 0; t < CPL; ++t) {
    const int ch = lane + 32 * t;
    if (ch < c) row[ch] = v[t];
  }
}

template <int CPL>
__device__ __forceinline__ float warp_dot(const float (&a)[CPL],
                                          const float (&b)[CPL]) {
  float s = 0.f;
#pragma unroll
  for (int t = 0; t < CPL; ++t) s = fmaf(a[t], b[t], s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
  return s;
}

// The weight of pair (i, j) from query i's incoming gradients g4_i.
__device__ __forceinline__ float pair_weight(float s, bool pos, float4 g,
                                             float tinv, int need_s) {
  const float e = expf(__fmul_rn(s, tinv));
  float w = __fmul_rn(__fmul_rn(pos ? g.x : g.y, e), tinv);
  if (need_s) w = __fadd_rn(w, pos ? g.z : g.w);
  return w;
}

// One batch's cloud in the sorted layout and the warp's own point in it.
struct Scan {
  const float4* pts;  // sorted x, y, z; w the bits of the original index
  const float2* ax;   // (label, threshold) of each sorted point
  const float* bx;    // a box a chunk: lo x, y, z, hi x, y, z
  int n, nc;
  int r;              // the warp's point's place in the sorted order
  bool active;        // r < n: the last block may hold fewer than 8
  float x, y, z;
  int io;             // its index in the caller's order
  float2 la;          // its label and threshold
};

// Every thread of the block: reads the warp's point, and the union box of
// the block's points into ub and their largest threshold into limit.
// spts, slim: kWarps x 3 and kWarps floats of shared memory.
__device__ __forceinline__ Scan block_points(const float4* sorted,
                                             const float2* aux,
                                             const float* boxes, int n,
                                             float (*spts)[3], float* slim,
                                             float* ub, float& limit) {
  const int b = blockIdx.y, warp = threadIdx.x >> 5;
  const int nc = (n + kChunk - 1) / kChunk;
  const size_t base = static_cast<size_t>(b) * n;
  Scan s{sorted + base, aux + base, boxes + static_cast<size_t>(b) * nc * 6,
         n, nc, static_cast<int>(blockIdx.x) * kWarps + warp, false,
         0.f, 0.f, 0.f, 0, make_float2(0.f, -1.f)};
  s.active = s.r < n;
  if (s.active) {
    const float4 p = s.pts[s.r];
    s.x = p.x;
    s.y = p.y;
    s.z = p.z;
    s.io = __float_as_int(p.w);
    s.la = s.ax[s.r];
  }
  if ((threadIdx.x & 31) == 0) {
    spts[warp][0] = s.x;
    spts[warp][1] = s.y;
    spts[warp][2] = s.z;
    slim[warp] = s.la.y;
  }
  __syncthreads();
  const int count = min(kWarps, n - static_cast<int>(blockIdx.x) * kWarps);
  amc3d::union_box(spts, count, ub);
  limit = -1.f;
  for (int w = 0; w < count; ++w) limit = fmaxf(limit, slim[w]);
  return s;
}

// The one scan of the three kernels: visit(io, label, d2) for every member
// of the warp's point among the points of the listed chunks, in chunk order
// and lane order within a chunk.  A chunk is listed when the box-to-box
// bound from the block's union box ub is not above block_limit(chunk), and
// scanned when the bound from the warp's point is not above
// warp_limit(chunk); a point o of it (io its original index) is a member
// when admits(d2, (label_o, threshold_o)) and it is not the warp's point.
// Every thread of the block calls it (block_list's barriers); list and
// counts: kListChunks and kWarps ints of shared memory.
template <class BlockLimit, class WarpLimit, class Admits, class Visit>
__device__ __forceinline__ void for_each_member(
    const Scan& s, const float* ub, int* list, int* counts,
    const BlockLimit& block_limit, const WarpLimit& warp_limit,
    const Admits& admits, const Visit& visit) {
  using namespace amc3d;
  const int lane = threadIdx.x & 31;
  auto box = [&](int c) { return s.bx + static_cast<size_t>(c) * 6; };
  auto listed = [&](int c) {
    return !(box_box_lower_bound(ub, box(c)) > block_limit(c));
  };
  for (int w0 = 0; w0 < s.nc; w0 += kListChunks) {
    const int total = block_list(w0, s.nc, listed, list, counts);
    if (!s.active) continue;
    for (int t0 = 0; t0 < total; t0 += 32) {
      const int t = t0 + lane;
      int c = 0;
      bool want = false;
      if (t < total) {
        c = list[t];
        want = !(box_lower_bound(s.x, s.y, s.z, box(c)) > warp_limit(c));
      }
      unsigned chunks = __ballot_sync(kFull, want);
      while (chunks) {
        const int src = __ffs(chunks) - 1;
        chunks &= chunks - 1;
        const int cc = __shfl_sync(kFull, c, src);
        const int len = min(kChunk, s.n - cc * kChunk);
        const float4* cp = s.pts + static_cast<size_t>(cc) * kChunk;
        const float2* ca = s.ax + static_cast<size_t>(cc) * kChunk;
        for (int u0 = 0; u0 < len; u0 += 32) {
          const int u = u0 + lane;
          bool member = false;
          float4 po = make_float4(0.f, 0.f, 0.f, 0.f);
          float2 la = make_float2(0.f, 0.f);
          float d = 0.f;
          if (u < len) {
            po = cp[u];
            la = ca[u];
            d = d2_of(po, s.x, s.y, s.z);
            member = admits(d, la) && cc * kChunk + u != s.r;
          }
          unsigned mask = __ballot_sync(kFull, member);
          while (mask) {
            const int m = __ffs(mask) - 1;
            mask &= mask - 1;
            visit(__float_as_int(__shfl_sync(kFull, po.w, m)),
                  __shfl_sync(kFull, la.x, m), __shfl_sync(kFull, d, m));
          }
        }
      }
    }
  }
}

// forward: the warp's point is query i; its own threshold admits j
template <int CPL>
__global__ void __launch_bounds__(kThreads)
contrast_fwd_kernel(const float4* __restrict__ sorted,
                    const float2* __restrict__ aux,
                    const float* __restrict__ boxes,
                    const float* __restrict__ f, int n, int c, float tinv,
                    int root, int need_s, int need_d,
                    float* __restrict__ out) {
  __shared__ int list[kListChunks];
  __shared__ float spts[kWarps][3];
  __shared__ float slim[kWarps];
  __shared__ int counts[kWarps];
  const int lane = threadIdx.x & 31;
  float ub[6], limit;
  const Scan s = block_points(sorted, aux, boxes, n, spts, slim, ub, limit);
  const size_t base = static_cast<size_t>(blockIdx.y) * n;
  const float thr = s.la.y, ql = s.la.x;
  float fi[CPL];
#pragma unroll
  for (int t = 0; t < CPL; ++t) fi[t] = 0.f;
  if (s.active) load_row<CPL>(f + (base + s.io) * c, c, lane, fi);
  float acc_p = 0.f, acc_q = 0.f, acc_sp = 0.f, acc_sn = 0.f;
  float acc_np = 0.f, acc_nn = 0.f, acc_dp = 0.f, acc_dn = 0.f;
  for_each_member(
      s, ub, list, counts, [&](int) { return limit; },
      [&](int) { return thr; }, [&](float d, float2) { return d <= thr; },
      [&](int jo, float lj, float dj) {
        float fj[CPL];
        load_row<CPL>(f + (base + jo) * c, c, lane, fj);
        const float sim = warp_dot<CPL>(fi, fj);
        const float e = expf(__fmul_rn(sim, tinv));
        const float dt = root ? __fsqrt_rn(__fadd_rn(fabsf(dj), 1e-12f)) : dj;
        if (lj == ql) {
          acc_p += e;
          acc_np += 1.f;
          if (need_s) acc_sp += sim;
          if (need_d) acc_dp += dt;
        } else {
          acc_q += e;
          acc_nn += 1.f;
          if (need_s) acc_sn += sim;
          if (need_d) acc_dn += dt;
        }
      });
  if (s.active && lane == 0) {
    float* o = out + (base + s.io) * 9;
    o[0] = acc_p;
    o[1] = acc_q;
    o[2] = acc_sp;
    o[3] = acc_sn;
    o[4] = acc_np;
    o[5] = acc_nn;
    o[6] = acc_dp;
    o[7] = acc_dn;
    o[8] = thr;
  }
}

// rows: the warp's point is query i; df_i sums w_ij f_j over its members j
template <int CPL>
__global__ void __launch_bounds__(kThreads)
contrast_grad_rows_kernel(const float4* __restrict__ sorted,
                          const float2* __restrict__ aux,
                          const float* __restrict__ boxes,
                          const float* __restrict__ f,
                          const float4* __restrict__ g4, int n, int c,
                          float tinv, int need_s, float* __restrict__ df) {
  __shared__ int list[kListChunks];
  __shared__ float spts[kWarps][3];
  __shared__ float slim[kWarps];
  __shared__ int counts[kWarps];
  const int lane = threadIdx.x & 31;
  float ub[6], limit;
  const Scan s = block_points(sorted, aux, boxes, n, spts, slim, ub, limit);
  const size_t base = static_cast<size_t>(blockIdx.y) * n;
  const float thr = s.la.y, ml = s.la.x;
  float4 gme = make_float4(0.f, 0.f, 0.f, 0.f);
  float fme[CPL], acc[CPL];
#pragma unroll
  for (int t = 0; t < CPL; ++t) acc[t] = fme[t] = 0.f;
  if (s.active) {
    gme = g4[base + s.io];
    load_row<CPL>(f + (base + s.io) * c, c, lane, fme);
  }
  for_each_member(
      s, ub, list, counts, [&](int) { return limit; },
      [&](int) { return thr; }, [&](float d, float2) { return d <= thr; },
      [&](int jo, float lj, float) {
        float fo[CPL];
        load_row<CPL>(f + (base + jo) * c, c, lane, fo);
        const float w = pair_weight(warp_dot<CPL>(fme, fo), lj == ml, gme,
                                    tinv, need_s);
#pragma unroll
        for (int t = 0; t < CPL; ++t) acc[t] = fmaf(w, fo[t], acc[t]);
      });
  if (s.active) store_row<CPL>(df + (base + s.io) * c, c, lane, acc);
}

// support: the warp's point is support point j; df_j sums w_ij f_i over the
// queries i whose own threshold admits it, so a chunk's limit is the
// largest threshold of its points (cmax)
template <int CPL>
__global__ void __launch_bounds__(kThreads)
contrast_grad_support_kernel(const float4* __restrict__ sorted,
                             const float2* __restrict__ aux,
                             const float* __restrict__ boxes,
                             const float* __restrict__ cmax,
                             const float* __restrict__ f,
                             const float4* __restrict__ g4, int n, int c,
                             float tinv, int need_s,
                             float* __restrict__ df) {
  __shared__ int list[kListChunks];
  __shared__ float spts[kWarps][3];
  __shared__ float slim[kWarps];
  __shared__ int counts[kWarps];
  const int lane = threadIdx.x & 31;
  float ub[6], unused;
  const Scan s = block_points(sorted, aux, boxes, n, spts, slim, ub, unused);
  const size_t base = static_cast<size_t>(blockIdx.y) * n;
  const float* cm = cmax + static_cast<size_t>(blockIdx.y) * s.nc;
  const float ml = s.la.x;
  float fme[CPL], acc[CPL];
#pragma unroll
  for (int t = 0; t < CPL; ++t) acc[t] = fme[t] = 0.f;
  if (s.active) load_row<CPL>(f + (base + s.io) * c, c, lane, fme);
  auto chunk_limit = [&](int cq) { return cm[cq]; };
  for_each_member(
      s, ub, list, counts, chunk_limit, chunk_limit,
      [&](float d, float2 la) { return d <= la.y; },
      [&](int io, float li, float) {
        float fo[CPL];
        load_row<CPL>(f + (base + io) * c, c, lane, fo);
        const float w = pair_weight(warp_dot<CPL>(fme, fo), li == ml,
                                    g4[base + io], tinv, need_s);
#pragma unroll
        for (int t = 0; t < CPL; ++t) acc[t] = fmaf(w, fo[t], acc[t]);
      });
  if (s.active) store_row<CPL>(df + (base + s.io) * c, c, lane, acc);
}

// Launches launch(std::integral_constant<int, CPL>()) with CPL the channels
// a lane holds, the smallest of 1, 2, 4, 8, 16 covering c; the layout's
// pointers must be aligned for their vector loads.
template <class Launch>
int by_lanes(int c, const void* sorted, const void* aux, const Launch& launch) {
  if (reinterpret_cast<size_t>(sorted) % 16 || reinterpret_cast<size_t>(aux) % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (c <= 32 ? 1 : c <= 64 ? 2 : c <= 128 ? 4 : c <= 256 ? 8 : c <= 512 ? 16 : 0) {
    case 1: launch(std::integral_constant<int, 1>()); break;
    case 2: launch(std::integral_constant<int, 2>()); break;
    case 4: launch(std::integral_constant<int, 4>()); break;
    case 8: launch(std::integral_constant<int, 8>()); break;
    case 16: launch(std::integral_constant<int, 16>()); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Every entry point reads the cloud's sorted layout: sorted (b, n, 4)
// float32, the cloud along its Morton curve with the bits of each point's
// index in w; aux (b, n, 2) float32, (label, threshold) of each sorted
// point; boxes (b, ceil(n / 64), 6).  f (b, n, c), 1 <= c <= 512, and
// g4 (b, n, 4), the incoming gradients of P, Q, Spos, Sneg, are in the
// caller's order, as are the outputs.

// -> out (b, n, 9) float32.
extern "C" int amc3d_contrast_forward(const void* sorted, const void* aux,
                                      const void* boxes, const void* f,
                                      void* out, int b, int n, int c,
                                      float tinv, int root, int need_s,
                                      int need_d, void* stream) {
  const dim3 grid((n + kWarps - 1) / kWarps, b);
  const auto st = static_cast<cudaStream_t>(stream);
  return by_lanes(c, sorted, aux, [&](auto cpl) {
    contrast_fwd_kernel<decltype(cpl)::value><<<grid, kThreads, 0, st>>>(
        static_cast<const float4*>(sorted), static_cast<const float2*>(aux),
        static_cast<const float*>(boxes), static_cast<const float*>(f), n, c,
        tinv, root, need_s, need_d, static_cast<float*>(out));
  });
}

// -> df (b, n, c) float32, the query-side part of the VJP.
extern "C" int amc3d_contrast_grad_rows(const void* sorted, const void* aux,
                                        const void* boxes, const void* f,
                                        const void* g4, void* df, int b,
                                        int n, int c, float tinv, int need_s,
                                        void* stream) {
  const dim3 grid((n + kWarps - 1) / kWarps, b);
  const auto st = static_cast<cudaStream_t>(stream);
  return by_lanes(c, sorted, aux, [&](auto cpl) {
    contrast_grad_rows_kernel<decltype(cpl)::value><<<grid, kThreads, 0, st>>>(
        static_cast<const float4*>(sorted), static_cast<const float2*>(aux),
        static_cast<const float*>(boxes), static_cast<const float*>(f),
        static_cast<const float4*>(g4), n, c, tinv, need_s,
        static_cast<float*>(df));
  });
}

// cmax (b, ceil(n / 64)): the largest threshold of each chunk.
// -> df (b, n, c) float32, the support-side part of the VJP.
extern "C" int amc3d_contrast_grad_support(const void* sorted, const void* aux,
                                           const void* boxes, const void* cmax,
                                           const void* f, const void* g4,
                                           void* df, int b, int n, int c,
                                           float tinv, int need_s,
                                           void* stream) {
  const dim3 grid((n + kWarps - 1) / kWarps, b);
  const auto st = static_cast<cudaStream_t>(stream);
  return by_lanes(c, sorted, aux, [&](auto cpl) {
    contrast_grad_support_kernel<decltype(cpl)::value>
        <<<grid, kThreads, 0, st>>>(
            static_cast<const float4*>(sorted), static_cast<const float2*>(aux),
            static_cast<const float*>(boxes), static_cast<const float*>(cmax),
            static_cast<const float*>(f), static_cast<const float4*>(g4), n, c,
            tinv, need_s, static_cast<float*>(df));
  });
}
