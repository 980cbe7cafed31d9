// Fused grouped aggregation: the signed extremum and the slot moments of a
// grouped tensor that is never written, and their VJP.
//
// Replaces amcontrast3d_tpu/ops/aggregate_pallas.py::_fwd_kernel (forward)
// and ::_bwd_kernel (VJP), entry grouped_slot_reduce.  With the separable
// first conv of a PointNeXt aggregation, the grouped value of query i, slot
// k, channel c is h = u[idx[i,k], c] - qp[i, c]; BatchNorm, a monotone
// activation and the max-pool over K then need per (i, c) only
//   ext = s_c * max_k (s_c * u[idx[i,k], c])          (s_c = +-1)
//   su  = sum_k h,  sq = sum_k h * h                   (k = 0, 1, ... in order)
// (su, sq skipped in eval mode), and, for the VJP, the number of slots that
// reach the extremum (ties, a byte: at most kMaxSlots slots).  The VJP: with
// per-slot weights
//   gamma_k = (g_sum + 2 (u_k - qp) g_sq) + eq_k * (g_ext / max(ties, 1))
// (computed as ((g_sum - 2 g_sq qp) + u_k 2 g_sq) + ..., within rounding)
// (eq_k: u_k == ext, which is u_k * s == ext * s for s = +-1; the even split
// of jnp.max and torch.amax), du[idx[i,k]] += gamma_k.  The TPU kernels
// gather by one-hot matmuls on the MXU (bf16 mantissa splits, chunk pruning
// by boxes) because VMEM cannot hold a gather; here the gather is a load.
// An index outside [0, n) reads 0 and receives nothing.
//
// What bounds it on the card: memory, by the bytes the function must move
// (u, idx and the per-query rows read once, 3 rows and the tie count
// written a query); but a query reads K slot rows of u, B * M * K * C
// floats (885 M a S3DIS step, 19 aggregations), and the VJP adds as many
// terms into du.  A thread a (query, channel) with the queries in the
// caller's (FPS) order shares no slot row within a block and loads one
// float at a time; the VJP issues one scalar float atomic a slot value.
// Design, both kernels: a block takes a run of queries that lie next to
// each other on the query cloud's Morton curve (the order of its layout,
// ops/spatial.py; index order without one) and a tile of channels, so
// neighbouring balls' shared rows meet in one multiprocessor's caches.
// The forward: the run's slot indices staged once in shared memory; a
// group of lanes a query (32 lanes of float4 cover 128 channels), 8 slot
// rows in flight a lane, folded in slot order (the moments round as the
// twin's sums); the outputs written at the caller's index; one kernel
// each for the train form (moments, tie count) and the eval form; a call
// too small to fill the card twice takes shorter runs.  Measured (PERF.md
// §6): the slot rows come at L2's rate, not L1's, and the train
// form's arithmetic (max, tie count, moments: ~10 instructions a slot
// value) sets its pace.  The VJP: the run's (row, slot) pairs sorted in
// shared memory (a bitonic sort, one pair a thread, as interpolate.cu's
// kernel 9), the run's per-query terms (ext, g_ext / ties, and folded
// g_sum - 2 g_sq qp, 2 g_sq) staged in shared memory; then each distinct
// row and vector of channels reads u once, sums gamma over its slots in
// (query, slot) order (a query's repeated slots reuse their gamma) and
// adds the sum into du with one red.global.add.v4.f32 (vector_red.cuh).
// Runs still meet in du through float atomics, so du is not
// bit-deterministic.
//
// The bfloat16 forms (the fused tail's u under use_amp, where the JAX entry
// takes a bf16 u and returns float32): the same kernels instantiated for a
// bf16 u.  The forward loads 8 bf16 slot values a 16-byte load (four
// __nv_bfloat162 -> float2), 4 slot rows in flight a lane, and does the
// max, the tie count and the moments in float32 as above, so ext is the
// exact float32 of a value of u.  The VJP reads bf16 u for its tie test
// (4 values an 8-byte load), sums du in a float32 accumulator as above,
// and a closing pass rounds it once to bf16: JAX's du.astype(u.dtype)
// after its float32 kernel.
//
// Second order (the adahessian step's Hessian-vector product), float32
// only.  du is linear in (g_ext, g_sum, g_sq) and depends on u only through
// the 2 g_sq h term (the tie counts are piecewise constant), so its VJP
// for a cotangent w (b, n, c) of du is, per query i and channel,
//   dg_ext = sum_k eq_k w[idx_k] / max(ties, 1)
//   dg_sum = sum_k w[idx_k]
//   dg_sq  = sum_k 2 w[idx_k] (u[idx_k] - qp)
//   dqp    = -(2 g_sq) dg_sum
// and the u term du2[idx_k] += w[idx_k] * 2 g_sq (a scatter), with slots
// outside [0, n) adding nothing (the twin: ops/aggregate.py::
// aggregate_backward2_plain).  No TPU kernel of its own: the JAX step
// differentiates _bwd_kernel's VJP by a jvp.  Bound: u and w read once and
// the four (b, m, c) rows and du2 written once (bytes), though a query
// reads K slot rows of both.  Design: the forward's blocks, a run of
// queries along the query layout's curve and a group of lanes a query,
// float4 channels where C % 4 == 0; each slot's u and w rows read once a
// query, the sums folded in slot order, the u term added with one
// red.global.add.v4.f32 a slot (float atomics: du2 is not
// bit-deterministic).
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "vector_red.cuh"

namespace {

using namespace amc3d;

constexpr int kThreads = 256;
constexpr unsigned kWarpMask = 0xffffffffu;
constexpr int kRunQueries = 32;      // forward: queries a block, at least
constexpr int kStagedSlots = 8192;   // forward: slot indices a block stages
constexpr int kBatch = 8;            // forward: slot loads in flight a lane (4 of 8 bf16)
constexpr int kEntries = kThreads;   // VJP: (row, slot) pairs a block sorts
constexpr int kMaxRun = 16;          // VJP: queries a block, at most
constexpr int kTile = 32;            // VJP: vectors of channels a block
constexpr int kMaxSlots = 255;       // the tie count is a byte
constexpr int kWaves = 2;            // forward: a small call's blocks a multiprocessor
static_assert((kThreads & (kThreads - 1)) == 0, "a bitonic sort's width");
static_assert(kMaxSlots * kRunQueries <= kStagedSlots, "a run's slots fit");

using bf16 = __nv_bfloat16;

// V channels of one row in float32: a float4 (V = 4: C % 4 == 0, rows on 16
// bytes), two (V = 8: the bf16 forward, C % 8 == 0) or a float
template <int V>
struct alignas(V >= 4 ? 16 : 4 * V) Vals {
  float x[V];
};

template <int V>
__device__ __forceinline__ Vals<V> load(const float* p) {
  Vals<V> r;
  if constexpr (V >= 4) {
#pragma unroll
    for (int h = 0; h < V; h += 4) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(p + h));
      r.x[h] = t.x, r.x[h + 1] = t.y, r.x[h + 2] = t.z, r.x[h + 3] = t.w;
    }
  } else {
    r.x[0] = __ldg(p);
  }
  return r;
}

// V bf16 values widened to float32 (exact): one 16-byte load (V = 8), one
// 8-byte load (V = 4) or one value
template <int V>
__device__ __forceinline__ Vals<V> load(const bf16* p) {
  Vals<V> r;
  if constexpr (V == 8 || V == 4) {
    using Word = typename std::conditional<V == 8, uint4, uint2>::type;
    const Word w = __ldg(reinterpret_cast<const Word*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
    for (int j = 0; j < V / 2; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      r.x[2 * j] = f.x, r.x[2 * j + 1] = f.y;
    }
  } else {
    r.x[0] = __bfloat162float(p[0]);
  }
  return r;
}

template <int V>
__device__ __forceinline__ Vals<V> filled(float v) {
  Vals<V> r;
#pragma unroll
  for (int e = 0; e < V; ++e) r.x[e] = v;
  return r;
}

template <int V>
__device__ __forceinline__ void store(float* p, const Vals<V>& r) {
  if constexpr (V >= 4) {
#pragma unroll
    for (int h = 0; h < V; h += 4)
      *reinterpret_cast<float4*>(p + h) =
          make_float4(r.x[h], r.x[h + 1], r.x[h + 2], r.x[h + 3]);
  } else {
    *p = r.x[0];
  }
}

// u's row j of this lane's channels, or 0 for an index outside [0, n)
template <int V, typename T>
__device__ __forceinline__ Vals<V> slot_row(const T* ub, int j, int n,
                                            int c) {
  return static_cast<unsigned>(j) < static_cast<unsigned>(n)
             ? load<V>(ub + static_cast<size_t>(j) * c)
             : filled<V>(0.f);
}

__device__ __forceinline__ int query_at(const int* order, int ostride,
                                        size_t qbase, int r) {
  return order != nullptr ? order[(qbase + r) * ostride] : r;
}

// Block (x, b, z): queries x * run ... of cloud b in the order given (order
// (b, m) int32, ostride apart, or null: index order), the lane's vector of
// channels z * lanes + (lane within its group).  Groups of `lanes` threads
// (a power of two up to 32) take one query at a time.  Dynamic shared
// memory: run * (k + 1) ints.  kMoments: qp, su, sq given (else null);
// kTies: ties given (else null).  T: u's type (float or bf16).
template <typename T, int V, bool kMoments, bool kTies>
__global__ void __launch_bounds__(kThreads)
aggregate_forward_kernel(const T* __restrict__ u, const int* __restrict__ idx,
                         const float* __restrict__ sgn,
                         const float* __restrict__ qp,
                         const int* __restrict__ order, int ostride,
                         float* __restrict__ ext, float* __restrict__ su,
                         float* __restrict__ sq, unsigned char* __restrict__ ties,
                         int n, int m, int k, int c, int lanes, int run) {
  extern __shared__ int staged[];
  int* s_idx = staged;               // run * k slot indices
  int* s_query = staged + run * k;   // the run's query indices
  const int b = blockIdx.y, t = threadIdx.x;
  const int r0 = blockIdx.x * run;
  const int nq = min(run, m - r0);
  const size_t qbase = static_cast<size_t>(b) * m;
  for (int q = t; q < nq; q += kThreads)
    s_query[q] = query_at(order, ostride, qbase, r0 + q);
  __syncthreads();
  for (int e = t; e < nq * k; e += kThreads) {
    const int q = e / k;
    s_idx[e] = idx[(qbase + s_query[q]) * k + (e - q * k)];
  }
  __syncthreads();
  const int groups = kThreads / lanes;
  const int g = t / lanes;
  const int ch = (blockIdx.z * lanes + t - g * lanes) * V;
  if (ch >= c) return;
  constexpr int batch = V == 8 ? kBatch / 2 : kBatch;
  const T* ub = u + static_cast<size_t>(b) * n * c + ch;
  const Vals<V> s = load<V>(sgn + ch);
  for (int q = g; q < nq; q += groups) {
    const int* row = s_idx + q * k;
    const size_t o = (qbase + s_query[q]) * c + ch;
    const Vals<V> off = kMoments ? load<V>(qp + o) : filled<V>(0.f);
    float e[V], a[V], a2[V];
    int cnt[V];
#pragma unroll
    for (int l = 0; l < V; ++l) e[l] = -CUDART_INF_F, a[l] = a2[l] = 0.f, cnt[l] = 0;
    for (int k0 = 0; k0 < k; k0 += batch) {
      Vals<V> gv[batch];
#pragma unroll
      for (int j = 0; j < batch; ++j)
        gv[j] = k0 + j < k ? slot_row<V>(ub, row[k0 + j], n, c) : filled<V>(0.f);
#pragma unroll
      for (int j = 0; j < batch; ++j) {
        if (k0 + j >= k) break;
#pragma unroll
        for (int l = 0; l < V; ++l) {
          const float x = gv[j].x[l], v = __fmul_rn(x, s.x[l]);
          if (kTies) cnt[l] = v > e[l] ? 1 : cnt[l] + (v == e[l] ? 1 : 0);
          e[l] = fmaxf(e[l], v);
          if (kMoments) {
            const float h = __fsub_rn(x, off.x[l]);
            a[l] = __fadd_rn(a[l], h);
            a2[l] = __fadd_rn(a2[l], __fmul_rn(h, h));
          }
        }
      }
    }
    Vals<V> out;
#pragma unroll
    for (int l = 0; l < V; ++l) out.x[l] = __fmul_rn(e[l], s.x[l]);
    store<V>(ext + o, out);
    if (kMoments) {
#pragma unroll
      for (int l = 0; l < V; ++l) out.x[l] = a[l];
      store<V>(su + o, out);
#pragma unroll
      for (int l = 0; l < V; ++l) out.x[l] = a2[l];
      store<V>(sq + o, out);
    }
    if (kTies) {
      if constexpr (V == 8) {
        *reinterpret_cast<uint2*>(ties + o) = make_uint2(
            cnt[0] | cnt[1] << 8 | cnt[2] << 16 | static_cast<unsigned>(cnt[3]) << 24,
            cnt[4] | cnt[5] << 8 | cnt[6] << 16 | static_cast<unsigned>(cnt[7]) << 24);
      } else if constexpr (V == 4) {
        *reinterpret_cast<uchar4*>(ties + o) =
            make_uchar4(cnt[0], cnt[1], cnt[2], cnt[3]);
      } else {
        ties[o] = static_cast<unsigned char>(cnt[0]);
      }
    }
  }
}

// Block (x, b, z): queries x * run ... of cloud b in the order given (as the
// forward), channel vectors z * kTile ...; run * k <= kEntries.  Dynamic
// shared memory: 4 arrays of run * kTile vectors (2 without the moments).
// qp, g_sum, g_sq null without the moments.  T: u's type (float or bf16);
// du float32 either way.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
aggregate_backward_kernel(const T* __restrict__ u, const int* __restrict__ idx,
                          const float* __restrict__ qp,
                          const float* __restrict__ ext,
                          const unsigned char* __restrict__ ties,
                          const float* __restrict__ g_ext,
                          const float* __restrict__ g_sum,
                          const float* __restrict__ g_sq,
                          const int* __restrict__ order, int ostride,
                          float* __restrict__ du, int n, int m, int k, int c,
                          int run) {
  using Key = unsigned long long;
  using Row = Vals<V>;
  extern __shared__ float4 rows_smem[];
  __shared__ Key keys[kEntries];
  __shared__ int s_query[kMaxRun];
  __shared__ int head[kEntries + 1];
  __shared__ int warp_heads[kThreads / 32];
  const int b = blockIdx.y, t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int r0 = blockIdx.x * run;
  const int nq = min(run, m - r0);
  const size_t qbase = static_cast<size_t>(b) * m;
  const bool stats = g_sum != nullptr;
  if (t < nq) s_query[t] = query_at(order, ostride, qbase, r0 + t);
  __syncthreads();
  // the pair's key: its support row above its place in the run (query-major,
  // then slot); a slot outside [0, n) sorts last and adds nothing
  Key key = ~0ull;
  if (t < nq * k) {
    const int q = t / k;
    const int j = idx[(qbase + s_query[q]) * k + (t - q * k)];
    if (static_cast<unsigned>(j) < static_cast<unsigned>(n))
      key = (static_cast<Key>(static_cast<unsigned>(j)) << 32) |
            static_cast<unsigned>(t);
  }
  // the run's per-query rows of this tile
  const int v0 = blockIdx.z * kTile;
  const int tile = min(kTile, c / V - v0);
  // gamma = (lin + u * q2) + eq * ge with lin = g_sum - 2 g_sq qp and
  // q2 = 2 g_sq a query and channel
  Row* s_ext = reinterpret_cast<Row*>(rows_smem);
  Row* s_ge = s_ext + run * kTile;
  Row* s_lin = s_ge + run * kTile;
  Row* s_q2 = s_lin + run * kTile;
  for (int e = t; e < nq * tile; e += kThreads) {
    const int q = e / tile, vv = e - q * tile;
    const size_t o = (qbase + s_query[q]) * c + (v0 + vv) * V;
    const int at = q * kTile + vv;
    s_ext[at] = load<V>(ext + o);
    Row ge = load<V>(g_ext + o);
#pragma unroll
    for (int l = 0; l < V; ++l)
      ge.x[l] = __fdiv_rn(ge.x[l], fmaxf(static_cast<float>(ties[o + l]), 1.f));
    s_ge[at] = ge;
    if (stats) {
      const Row gs = load<V>(g_sum + o), gq = load<V>(g_sq + o), off = load<V>(qp + o);
      Row lin, q2;
#pragma unroll
      for (int l = 0; l < V; ++l) {
        q2.x[l] = __fmul_rn(2.f, gq.x[l]);
        lin.x[l] = __fsub_rn(gs.x[l], __fmul_rn(q2.x[l], off.x[l]));
      }
      s_lin[at] = lin;
      s_q2[at] = q2;
    }
  }
  // bitonic sort, ascending: strides below a warp by shuffles, the others
  // through shared memory
#pragma unroll
  for (int size = 2; size <= kEntries; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      Key other;
      if (stride >= 32) {
        keys[t] = key;
        __syncthreads();
        other = keys[t ^ stride];
        __syncthreads();
      } else {
        other = __shfl_xor_sync(kWarpMask, key, stride);
      }
      const bool keep_min = ((t & stride) == 0) == ((t & size) == 0);
      key = keep_min ? (other < key ? other : key) : (other > key ? other : key);
    }
  }
  keys[t] = key;
  const int npairs = __syncthreads_count(key != ~0ull);
  // the first pair of each support row, compacted into head[0 .. nseg)
  const bool is_head =
      t < npairs && (t == 0 || (keys[t - 1] >> 32) != (key >> 32));
  const unsigned heads = __ballot_sync(kWarpMask, is_head);
  if (lane == 0) warp_heads[warp] = __popc(heads);
  __syncthreads();
  int at = __popc(heads & ((1u << lane) - 1u)), nseg = 0;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) {
    at += w < warp ? warp_heads[w] : 0;
    nseg += warp_heads[w];
  }
  if (is_head) head[at] = t;
  if (t == 0) head[nseg] = npairs;
  __syncthreads();

  // each (row, vector of channels): u read once, gamma summed over the
  // row's slots in (query, slot) order, then one reduction into du
  const T* ub = u + static_cast<size_t>(b) * n * c;
  float* db = du + static_cast<size_t>(b) * n * c;
  for (int e = t; e < nseg * tile; e += kThreads) {
    const int sg = e / tile, vv = e - sg * tile;
    const int j0 = head[sg], j1 = head[sg + 1];
    const size_t off = static_cast<size_t>(keys[j0] >> 32) * c + (v0 + vv) * V;
    const Row x = load<V>(ub + off);
    Row acc = filled<V>(0.f), gam;
    for (int j = j0, last = -1; j < j1; ++j) {
      // a query's slots on one row (the ball query's padding) have one gamma
      const int q = static_cast<int>(static_cast<unsigned>(keys[j])) / k;
      if (q != last) {
        last = q;
        const int qa = q * kTile + vv;
        const Row ex = s_ext[qa], ge = s_ge[qa];
#pragma unroll
        for (int l = 0; l < V; ++l)
          gam.x[l] = __fmul_rn(x.x[l] == ex.x[l] ? 1.f : 0.f, ge.x[l]);
        if (stats) {
          const Row lin = s_lin[qa], q2 = s_q2[qa];
#pragma unroll
          for (int l = 0; l < V; ++l)
            gam.x[l] = __fadd_rn(__fadd_rn(lin.x[l], __fmul_rn(x.x[l], q2.x[l])),
                                 gam.x[l]);
        }
      }
#pragma unroll
      for (int l = 0; l < V; ++l)
        acc.x[l] = j == j0 ? gam.x[l] : __fadd_rn(acc.x[l], gam.x[l]);
    }
    if constexpr (V == 4)
      red_add(db + off, make_float4(acc.x[0], acc.x[1], acc.x[2], acc.x[3]));
    else
      red_add(db + off, acc.x[0]);
  }
}

// Block (x, b, z): queries x * run ... of cloud b in the order given (as the
// forward), groups of `lanes` threads a query, the lane's vector of channels
// z * lanes + (lane within its group).  qp, g_sq, dg_sum, dg_sq, dqp and du
// null without the moments.
template <int V>
__global__ void __launch_bounds__(kThreads)
aggregate_backward2_kernel(const float* __restrict__ u,
                           const int* __restrict__ idx,
                           const float* __restrict__ qp,
                           const float* __restrict__ ext,
                           const unsigned char* __restrict__ ties,
                           const float* __restrict__ g_sq,
                           const float* __restrict__ w,
                           const int* __restrict__ order, int ostride,
                           float* __restrict__ dg_ext,
                           float* __restrict__ dg_sum,
                           float* __restrict__ dg_sq, float* __restrict__ dqp,
                           float* __restrict__ du, int n, int m, int k, int c,
                           int lanes, int run) {
  const int b = blockIdx.y, t = threadIdx.x;
  const int groups = kThreads / lanes, g = t / lanes;
  const int ch = (blockIdx.z * lanes + t - g * lanes) * V;
  if (ch >= c) return;
  const bool stats = g_sq != nullptr;
  const int r0 = blockIdx.x * run;
  const int nq = min(run, m - r0);
  const size_t qbase = static_cast<size_t>(b) * m;
  const size_t cloud = static_cast<size_t>(b) * n * c + ch;
  for (int q = g; q < nq; q += groups) {
    const int qi = query_at(order, ostride, qbase, r0 + q);
    const size_t o = (qbase + qi) * c + ch;
    const int* row = idx + (qbase + qi) * k;
    const Vals<V> ex = load<V>(ext + o);
    Vals<V> off = filled<V>(0.f), q2 = filled<V>(0.f);
    if (stats) {
      off = load<V>(qp + o);
      const Vals<V> gq = load<V>(g_sq + o);
#pragma unroll
      for (int l = 0; l < V; ++l) q2.x[l] = __fmul_rn(2.f, gq.x[l]);
    }
    Vals<V> ae = filled<V>(0.f), as = filled<V>(0.f), aq = filled<V>(0.f);
    for (int kk = 0; kk < k; ++kk) {
      const int j = row[kk];
      if (static_cast<unsigned>(j) >= static_cast<unsigned>(n)) continue;
      const size_t at = cloud + static_cast<size_t>(j) * c;
      const Vals<V> x = load<V>(u + at), wv = load<V>(w + at);
      Vals<V> add = filled<V>(0.f);
#pragma unroll
      for (int l = 0; l < V; ++l) {
        if (x.x[l] == ex.x[l]) ae.x[l] = __fadd_rn(ae.x[l], wv.x[l]);
        if (stats) {
          as.x[l] = __fadd_rn(as.x[l], wv.x[l]);
          const float h = __fsub_rn(x.x[l], off.x[l]);
          aq.x[l] = __fadd_rn(aq.x[l], __fmul_rn(__fmul_rn(2.f, wv.x[l]), h));
          add.x[l] = __fmul_rn(wv.x[l], q2.x[l]);
        }
      }
      if (stats) {
        if constexpr (V == 4)
          red_add(du + at, make_float4(add.x[0], add.x[1], add.x[2], add.x[3]));
        else
          red_add(du + at, add.x[0]);
      }
    }
#pragma unroll
    for (int l = 0; l < V; ++l)
      ae.x[l] = __fdiv_rn(ae.x[l], fmaxf(static_cast<float>(ties[o + l]), 1.f));
    store<V>(dg_ext + o, ae);
    if (stats) {
      store<V>(dg_sum + o, as);
      store<V>(dg_sq + o, aq);
#pragma unroll
      for (int l = 0; l < V; ++l) as.x[l] = -__fmul_rn(q2.x[l], as.x[l]);
      store<V>(dqp + o, as);
    }
  }
}

// the bf16 VJP's closing pass: du = acc rounded to nearest even, 8 values a
// thread where count % 8 == 0 and both ends are aligned, else one
__global__ void __launch_bounds__(kThreads)
round_to_bf16_kernel(const float* __restrict__ acc, bf16* __restrict__ du,
                     size_t count, bool vec) {
  const size_t stride = static_cast<size_t>(gridDim.x) * kThreads;
  const size_t t = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (vec) {
    for (size_t i = t; i < count / 8; i += stride) {
      const Vals<8> v = load<8>(acc + 8 * i);
      uint4 w;
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&w);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        h[j] = __floats2bfloat162_rn(v.x[2 * j], v.x[2 * j + 1]);
      *reinterpret_cast<uint4*>(du + 8 * i) = w;
    }
  } else {
    for (size_t i = t; i < count; i += stride) du[i] = __float2bfloat16_rn(acc[i]);
  }
}

// the current device's multiprocessors (read once a device), or 0 when
// they cannot be read
int multiprocessors() {
  constexpr int kDevices = 64;
  static int sms[kDevices] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kDevices) return 0;
  if (sms[dev] == 0 &&
      cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    sms[dev] = 0;
  return sms[dev];
}

bool aligned(const void* p, int bytes) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// The forward of either form.  W: the vector width (4 float32 or 8 bf16
// values of u a load).
template <typename T, int W>
int forward(const void* u, const void* idx, const void* sgn, const void* qp,
            const void* order, int ostride, void* ext, void* su, void* sq,
            void* ties, int b, int n, int m, int k, int c, int need_stats,
            void* stream) {
  if (c < 1 || k < 1 || ostride < 1 || (ties && k > kMaxSlots) ||
      (need_stats && (!qp || !su || !sq)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (b < 1 || m < 1) return static_cast<int>(cudaSuccess);
  if (!need_stats) qp = su = sq = nullptr;
  const bool vec = c % W == 0 && aligned(u, 16) && aligned(sgn, 16) &&
                   aligned(qp, 16) && aligned(ext, 16) && aligned(su, 16) &&
                   aligned(sq, 16) && aligned(ties, W);
  const int vectors = vec ? c / W : c;
  int lanes = 1;
  while (lanes < vectors && lanes < 32) lanes <<= 1;
  const int groups = kThreads / lanes, tiles = (vectors + lanes - 1) / lanes;
  int run = groups > kRunQueries ? groups : kRunQueries;
  while (run > 1 && run * k > kStagedSlots) run >>= 1;
  if (run * k > kStagedSlots) return static_cast<int>(cudaErrorInvalidValue);
  // a small call: shorter runs (down to a query a group) until the grid
  // fills the card kWaves times over
  const int sms = multiprocessors();
  if (sms < 1) return static_cast<int>(cudaErrorInvalidValue);
  while (run > groups &&
         static_cast<long long>((m + run - 1) / run) * b * tiles < kWaves * sms)
    run >>= 1;
  const dim3 grid((m + run - 1) / run, b, tiles);
  const size_t smem = static_cast<size_t>(run) * (k + 1) * sizeof(int);
  using Forward = void (*)(const T*, const int*, const float*, const float*,
                           const int*, int, float*, float*, float*,
                           unsigned char*, int, int, int, int, int, int);
  const Forward kernels[2][2][2] = {
      {{&aggregate_forward_kernel<T, 1, false, false>, &aggregate_forward_kernel<T, 1, false, true>},
       {&aggregate_forward_kernel<T, 1, true, false>, &aggregate_forward_kernel<T, 1, true, true>}},
      {{&aggregate_forward_kernel<T, W, false, false>, &aggregate_forward_kernel<T, W, false, true>},
       {&aggregate_forward_kernel<T, W, true, false>, &aggregate_forward_kernel<T, W, true, true>}}};
  const Forward kernel = kernels[vec][need_stats != 0][ties != nullptr];
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(u), static_cast<const int*>(idx),
      static_cast<const float*>(sgn), static_cast<const float*>(qp),
      static_cast<const int*>(order), ostride, static_cast<float*>(ext),
      static_cast<float*>(su), static_cast<float*>(sq),
      static_cast<unsigned char*>(ties), n, m, k, c, lanes, run);
  return static_cast<int>(cudaGetLastError());
}

// The VJP of either form into the float32 sums `acc`, zeroed here.
template <typename T>
int backward(const void* u, const void* idx, const void* qp, const void* ext,
             const void* ties, const void* g_ext, const void* g_sum,
             const void* g_sq, const void* order, int ostride, void* acc,
             int b, int n, int m, int k, int c, int has_stats,
             cudaStream_t st) {
  if (c < 1 || k < 1 || k > kMaxSlots || ostride < 1 ||
      (has_stats && (!qp || !g_sum || !g_sq)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!has_stats) qp = g_sum = g_sq = nullptr;
  const cudaError_t err = cudaMemsetAsync(
      acc, 0, static_cast<size_t>(b) * n * c * sizeof(float), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b < 1 || m < 1 || n < 1) return static_cast<int>(cudaSuccess);
  const bool vec = c % 4 == 0 && aligned(u, 4 * sizeof(T)) && aligned(qp, 16) &&
                   aligned(ext, 16) && aligned(g_ext, 16) && aligned(g_sum, 16) &&
                   aligned(g_sq, 16) && aligned(acc, 16) && aligned(ties, 4);
  const int vectors = vec ? c / 4 : c;
  const int run = kEntries / k < kMaxRun ? kEntries / k : kMaxRun;
  const dim3 grid((m + run - 1) / run, b, (vectors + kTile - 1) / kTile);
  const size_t smem = static_cast<size_t>(has_stats ? 4 : 2) * run * kTile *
                      (vec ? sizeof(float4) : sizeof(float));
  auto* kernel = vec ? &aggregate_backward_kernel<T, 4> : &aggregate_backward_kernel<T, 1>;
  kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(u), static_cast<const int*>(idx),
      static_cast<const float*>(qp), static_cast<const float*>(ext),
      static_cast<const unsigned char*>(ties), static_cast<const float*>(g_ext),
      static_cast<const float*>(g_sum), static_cast<const float*>(g_sq),
      static_cast<const int*>(order), ostride, static_cast<float*>(acc), n, m,
      k, c, run);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// u (b, n, c) float32, idx (b, m, k) int32, sgn (c) float32 of +-1, qp
// (b, m, c) float32 or null when need_stats == 0, order (b, m) int32
// ostride apart (a permutation of each cloud's queries: the order the runs
// take them in) or null (index order) -> ext (b, m, c) and, when
// need_stats, su, sq (b, m, c) float32 (else null); ties (b, m, c) uint8,
// the slots at the extremum, unless null (then k may exceed 255).
extern "C" int amc3d_aggregate_forward(const void* u, const void* idx,
                                       const void* sgn, const void* qp,
                                       const void* order, int ostride,
                                       void* ext, void* su, void* sq,
                                       void* ties, int b, int n, int m, int k,
                                       int c, int need_stats, void* stream) {
  return forward<float, 4>(u, idx, sgn, qp, order, ostride, ext, su, sq, ties,
                           b, n, m, k, c, need_stats, stream);
}

// The bf16 form: u (b, n, c) bf16, everything else as above.
extern "C" int amc3d_aggregate_forward_bf16(const void* u, const void* idx,
                                            const void* sgn, const void* qp,
                                            const void* order, int ostride,
                                            void* ext, void* su, void* sq,
                                            void* ties, int b, int n, int m,
                                            int k, int c, int need_stats,
                                            void* stream) {
  return forward<bf16, 8>(u, idx, sgn, qp, order, ostride, ext, su, sq, ties,
                          b, n, m, k, c, need_stats, stream);
}

// The VJP: u, idx, order as above; qp, g_sum, g_sq (b, m, c) or null when
// has_stats == 0; ext and g_ext (b, m, c) float32, ties (b, m, c) uint8 from
// the forward -> du (b, n, c) float32, zeroed here on the stream, then the
// runs' sums added in with vector reductions.
extern "C" int amc3d_aggregate_backward(const void* u, const void* idx,
                                        const void* qp, const void* ext,
                                        const void* ties, const void* g_ext,
                                        const void* g_sum, const void* g_sq,
                                        const void* order, int ostride,
                                        void* du, int b, int n, int m, int k,
                                        int c, int has_stats, void* stream) {
  return backward<float>(u, idx, qp, ext, ties, g_ext, g_sum, g_sq, order,
                         ostride, du, b, n, m, k, c, has_stats,
                         static_cast<cudaStream_t>(stream));
}

// The bf16 form: u (b, n, c) bf16; the sums go into acc (b, n, c) float32
// as du above, then du (b, n, c) bf16 is acc rounded to nearest even.
extern "C" int amc3d_aggregate_backward_bf16(const void* u, const void* idx,
                                             const void* qp, const void* ext,
                                             const void* ties, const void* g_ext,
                                             const void* g_sum, const void* g_sq,
                                             const void* order, int ostride,
                                             void* acc, void* du, int b, int n,
                                             int m, int k, int c, int has_stats,
                                             void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err = backward<bf16>(u, idx, qp, ext, ties, g_ext, g_sum, g_sq,
                                 order, ostride, acc, b, n, m, k, c, has_stats,
                                 st);
  const size_t count = static_cast<size_t>(b) * n * c;
  if (err != 0 || count == 0) return err;
  const bool vec = count % 8 == 0 && aligned(acc, 16) && aligned(du, 16);
  const int sms = multiprocessors();
  if (sms < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t items = vec ? count / 8 : count;
  const size_t blocks = (items + kThreads - 1) / kThreads;
  const int grid = static_cast<int>(blocks < 8u * sms ? blocks : 8u * sms);
  round_to_bf16_kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const float*>(acc), static_cast<bf16*>(du), count, vec);
  return static_cast<int>(cudaGetLastError());
}

// The second order (float32): u, idx, order as the VJP's; qp and g_sq (b, m,
// c) or null when has_stats == 0; ext, ties from the forward; w (b, n, c)
// float32, the cotangent of du -> dg_ext (b, m, c) float32 and, with the
// moments, dg_sum, dg_sq, dqp (b, m, c) float32 and du (b, n, c) float32
// (zeroed here on the stream, then the slots' terms added in; null without
// the moments).
extern "C" int amc3d_aggregate_backward2(const void* u, const void* idx,
                                         const void* qp, const void* ext,
                                         const void* ties, const void* g_sq,
                                         const void* w, const void* order,
                                         int ostride, void* dg_ext,
                                         void* dg_sum, void* dg_sq, void* dqp,
                                         void* du, int b, int n, int m, int k,
                                         int c, int has_stats, void* stream) {
  if (c < 1 || k < 1 || ostride < 1 ||
      (has_stats && (!qp || !g_sq || !dg_sum || !dg_sq || !dqp || !du)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!has_stats) qp = g_sq = nullptr, dg_sum = dg_sq = dqp = du = nullptr;
  if (has_stats) {
    const cudaError_t err = cudaMemsetAsync(
        du, 0, static_cast<size_t>(b) * n * c * sizeof(float), st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (b < 1 || m < 1 || n < 1) return static_cast<int>(cudaSuccess);
  const bool vec = c % 4 == 0 && aligned(u, 16) && aligned(w, 16) &&
                   aligned(qp, 16) && aligned(ext, 16) && aligned(g_sq, 16) &&
                   aligned(dg_ext, 16) && aligned(dg_sum, 16) &&
                   aligned(dg_sq, 16) && aligned(dqp, 16) && aligned(du, 16);
  const int vectors = vec ? c / 4 : c;
  int lanes = 1;
  while (lanes < vectors && lanes < 32) lanes <<= 1;
  const int run = kThreads / lanes;
  const dim3 grid((m + run - 1) / run, b, (vectors + lanes - 1) / lanes);
  auto* kernel = vec ? &aggregate_backward2_kernel<4> : &aggregate_backward2_kernel<1>;
  kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const float*>(u), static_cast<const int*>(idx),
      static_cast<const float*>(qp), static_cast<const float*>(ext),
      static_cast<const unsigned char*>(ties), static_cast<const float*>(g_sq),
      static_cast<const float*>(w), static_cast<const int*>(order), ostride,
      static_cast<float*>(dg_ext), static_cast<float*>(dg_sum),
      static_cast<float*>(dg_sq), static_cast<float*>(dqp),
      static_cast<float*>(du), n, m, k, c, lanes, run);
  return static_cast<int>(cudaGetLastError());
}
