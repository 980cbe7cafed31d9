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
// (su, sq skipped in eval mode).  The VJP: with per-slot weights
//   gamma_k = (g_sum + 2 (u_k - qp) g_sq) + eq_k * (g_ext / max(ties, 1))
// (eq_k = u_k * s == ext * s; ties = sum_k eq_k, the even split of
// jnp.max and torch.amax), du[idx[i,k]] += gamma_k.  The TPU kernels gather
// by one-hot matmuls on the MXU (bf16 mantissa splits, chunk pruning by
// boxes) because VMEM cannot hold a gather; here the gather is a load.
//
// What bounds it on the card: memory.  A query reads its K slot rows of u
// (B * M * K * C floats through L2; u itself, B * N * C, from device memory
// once when it fits in L2) and writes 3 rows; a few float instructions a
// slot value.  The backward reads the slot rows twice (ties, then gamma)
// and scatters B * M * K * C float atomics into du.
// Design: a query's channels across threads (a warp-multiple up to 256,
// several queries a block of 256 when C is narrow), so every slot row is
// read coalesced along C; each thread walks the K slots of its channels in
// order, the moments in registers.  The backward's atomics make du's sums
// take their terms in no fixed order: du is not bit-deterministic.  An
// index outside [0, n) reads 0 and receives nothing.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kAggThreads = 256;

// threads a query gets: its channels rounded up to a warp, at most 256
inline int channel_threads(int c) {
  const int ct = (c + 31) / 32 * 32;
  return ct < kAggThreads ? ct : kAggThreads;
}

__device__ __forceinline__ float slot_value(const float* __restrict__ u,
                                            int j, int n, int c, int ch) {
  return static_cast<unsigned>(j) < static_cast<unsigned>(n)
             ? u[static_cast<size_t>(j) * c + ch]
             : 0.f;
}

__global__ void __launch_bounds__(kAggThreads)
aggregate_forward_kernel(const float* __restrict__ u, const int* __restrict__ idx,
                         const float* __restrict__ sgn,
                         const float* __restrict__ qp, float* __restrict__ ext,
                         float* __restrict__ su, float* __restrict__ sq, int n,
                         int m, int k, int c, int ct, long long queries,
                         int need_stats) {
  const int per_block = kAggThreads / ct;
  const int sub = threadIdx.x / ct;
  const long long q = static_cast<long long>(blockIdx.x) * per_block + sub;
  if (sub >= per_block || q >= queries) return;
  const float* ub = u + static_cast<size_t>(q / m) * n * c;
  const int* row = idx + static_cast<size_t>(q) * k;
  const size_t o = static_cast<size_t>(q) * c;
  for (int ch = threadIdx.x % ct; ch < c; ch += ct) {
    const float s = sgn[ch];
    const float off = need_stats ? qp[o + ch] : 0.f;
    float e = -CUDART_INF_F, a = 0.f, a2 = 0.f;
    for (int kk = 0; kk < k; ++kk) {
      const float g = slot_value(ub, row[kk], n, c, ch);
      e = fmaxf(e, __fmul_rn(g, s));
      if (need_stats) {
        const float h = __fsub_rn(g, off);
        a = __fadd_rn(a, h);
        a2 = __fadd_rn(a2, __fmul_rn(h, h));
      }
    }
    ext[o + ch] = __fmul_rn(e, s);
    if (need_stats) {
      su[o + ch] = a;
      sq[o + ch] = a2;
    }
  }
}

__global__ void __launch_bounds__(kAggThreads)
aggregate_backward_kernel(const float* __restrict__ u,
                          const int* __restrict__ idx,
                          const float* __restrict__ sgn,
                          const float* __restrict__ qp,
                          const float* __restrict__ ext,
                          const float* __restrict__ g_ext,
                          const float* __restrict__ g_sum,
                          const float* __restrict__ g_sq,
                          float* __restrict__ du, int n, int m, int k, int c,
                          int ct, long long queries, int has_stats) {
  const int per_block = kAggThreads / ct;
  const int sub = threadIdx.x / ct;
  const long long q = static_cast<long long>(blockIdx.x) * per_block + sub;
  if (sub >= per_block || q >= queries) return;
  const size_t cloud = static_cast<size_t>(q / m) * n * c;
  const float* ub = u + cloud;
  float* dub = du + cloud;
  const int* row = idx + static_cast<size_t>(q) * k;
  const size_t o = static_cast<size_t>(q) * c;
  for (int ch = threadIdx.x % ct; ch < c; ch += ct) {
    const float s = sgn[ch];
    const float es = __fmul_rn(ext[o + ch], s);
    float ties = 0.f;
    for (int kk = 0; kk < k; ++kk)
      ties = __fadd_rn(ties, __fmul_rn(slot_value(ub, row[kk], n, c, ch), s) == es
                                 ? 1.f : 0.f);
    const float ge = __fdiv_rn(g_ext[o + ch], fmaxf(ties, 1.f));
    const float gs = has_stats ? g_sum[o + ch] : 0.f;
    const float gq = has_stats ? g_sq[o + ch] : 0.f;
    const float off = has_stats ? qp[o + ch] : 0.f;
    for (int kk = 0; kk < k; ++kk) {
      const int j = row[kk];
      if (static_cast<unsigned>(j) >= static_cast<unsigned>(n)) continue;
      const float g = ub[static_cast<size_t>(j) * c + ch];
      const float eq = __fmul_rn(g, s) == es ? 1.f : 0.f;
      const float gamma =
          __fadd_rn(__fadd_rn(gs, __fmul_rn(__fmul_rn(2.f, __fsub_rn(g, off)), gq)),
                    __fmul_rn(eq, ge));
      atomicAdd(dub + static_cast<size_t>(j) * c + ch, gamma);
    }
  }
}

dim3 agg_grid(long long queries, int ct) {
  const int per_block = kAggThreads / ct;
  return dim3(static_cast<unsigned>((queries + per_block - 1) / per_block));
}

}  // namespace

// u (b, n, c) float32, idx (b, m, k) int32, sgn (c) float32 of +-1, qp
// (b, m, c) float32 or null when need_stats == 0 -> ext (b, m, c) and, when
// need_stats, su, sq (b, m, c) float32 (else null).
extern "C" int amc3d_aggregate_forward(const void* u, const void* idx,
                                       const void* sgn, const void* qp,
                                       void* ext, void* su, void* sq, int b,
                                       int n, int m, int k, int c,
                                       int need_stats, void* stream) {
  if (c < 1 || k < 1 || (need_stats && (!qp || !su || !sq)))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long queries = static_cast<long long>(b) * m;
  if (queries == 0) return static_cast<int>(cudaSuccess);
  const int ct = channel_threads(c);
  aggregate_forward_kernel<<<agg_grid(queries, ct), kAggThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(u), static_cast<const int*>(idx),
      static_cast<const float*>(sgn), static_cast<const float*>(qp),
      static_cast<float*>(ext), static_cast<float*>(su),
      static_cast<float*>(sq), n, m, k, c, ct, queries, need_stats);
  return static_cast<int>(cudaGetLastError());
}

// The VJP: u, idx, sgn as above, qp, g_sum, g_sq (b, m, c) or null when
// has_stats == 0, ext and g_ext (b, m, c) -> du (b, n, c), zeroed by the
// caller, accumulated with float atomics.
extern "C" int amc3d_aggregate_backward(const void* u, const void* idx,
                                        const void* sgn, const void* qp,
                                        const void* ext, const void* g_ext,
                                        const void* g_sum, const void* g_sq,
                                        void* du, int b, int n, int m, int k,
                                        int c, int has_stats, void* stream) {
  if (c < 1 || k < 1 || (has_stats && (!qp || !g_sum || !g_sq)))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long queries = static_cast<long long>(b) * m;
  if (queries == 0) return static_cast<int>(cudaSuccess);
  const int ct = channel_threads(c);
  aggregate_backward_kernel<<<agg_grid(queries, ct), kAggThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(u), static_cast<const int*>(idx),
      static_cast<const float*>(sgn), static_cast<const float*>(qp),
      static_cast<const float*>(ext), static_cast<const float*>(g_ext),
      static_cast<const float*>(g_sum), static_cast<const float*>(g_sq),
      static_cast<float*>(du), n, m, k, c, ct, queries, has_stats);
  return static_cast<int>(cudaGetLastError());
}
