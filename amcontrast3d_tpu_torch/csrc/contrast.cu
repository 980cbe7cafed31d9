// Adaptive-margin contrast reductions over threshold neighbourhoods, and
// their VJP: three kernels.
//
// Replaces amcontrast3d_tpu/ops/contrast_pallas.py::_fwd_kernel (in its
// external-threshold mode, has_kth=True), ::_bwd_rows_kernel and
// ::_bwd_sup_kernel.  The TPU kernels are dense: per (query tile, support
// chunk) they form every d^2 on the VPU and every similarity as one MXU
// matmul, then mask.  For point i of a cloud, its neighbours are
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
// What bounds them on the card: the membership scan, N^2 position tests
// per cloud (2.3 G at the 4 x 24000 stage), is instruction throughput; the
// feature work touches only the ~nsample members of each point (2.2 M
// C-wide dot products at that stage), a few hundred MB of L2 reads.  The
// dense C-wide similarity work of the TPU form (N^2 * C) is never done.
// Design: one warp per point, 8 points per block.  The block stages the
// cloud's positions and labels (and, for the support kernel, the queries'
// thresholds) through shared memory in tiles of 1024; each lane tests one
// candidate per step and a ballot yields the warp's members in index
// order.  For each member the warp reads the feature row coalesced (lane l
// holds channels l, l+32, ...), reduces the dot product with xor
// shuffles (every lane ends with the same sum) and accumulates in
// registers, so each point's sums are taken in a fixed order and the
// results are deterministic.  Nothing but the outputs is written.
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 1024;
constexpr unsigned kFull = 0xffffffffu;

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
__device__ __forceinline__ float warp_dot(const float (&a)[CPL],
                                          const float (&b)[CPL]) {
  float s = 0.f;
#pragma unroll
  for (int t = 0; t < CPL; ++t) s = fmaf(a[t], b[t], s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
  return s;
}

// Stage positions and labels of points [t0, t0 + len) of cloud `base`.
__device__ __forceinline__ void stage(const float* __restrict__ p,
                                      const float* __restrict__ lab,
                                      size_t base, int t0, int len,
                                      float4* sp) {
  for (int t = threadIdx.x; t < len; t += kThreads) {
    const float* s = p + (base + t0 + t) * 3;
    sp[t] = make_float4(s[0], s[1], s[2], lab[base + t0 + t]);
  }
}

template <int CPL>
__global__ void __launch_bounds__(kThreads)
contrast_fwd_kernel(const float* __restrict__ p, const float* __restrict__ f,
                    const float* __restrict__ lab,
                    const float* __restrict__ kth, int n, int c, float tinv,
                    int root, int need_s, int need_d,
                    float* __restrict__ out) {
  __shared__ float4 sp[kTile];
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const bool active = i < n;
  const size_t base = static_cast<size_t>(b) * n;
  float qx = 0.f, qy = 0.f, qz = 0.f, ql = 0.f;
  float thr = -1.f;  // an idle warp admits nothing: every d^2 >= 0
  float fi[CPL];
  if (active) {
    qx = p[(base + i) * 3];
    qy = p[(base + i) * 3 + 1];
    qz = p[(base + i) * 3 + 2];
    ql = lab[base + i];
    thr = kth[base + i];
    load_row<CPL>(f + (base + i) * c, c, lane, fi);
  } else {
#pragma unroll
    for (int t = 0; t < CPL; ++t) fi[t] = 0.f;
  }
  float acc_p = 0.f, acc_q = 0.f, acc_sp = 0.f, acc_sn = 0.f;
  float acc_np = 0.f, acc_nn = 0.f, acc_dp = 0.f, acc_dn = 0.f;

  for (int t0 = 0; t0 < n; t0 += kTile) {
    const int len = min(kTile, n - t0);
    __syncthreads();  // the previous tile is no longer read
    stage(p, lab, base, t0, len, sp);
    __syncthreads();
    for (int u0 = 0; u0 < len; u0 += 32) {
      const int u = u0 + lane;
      float d = 0.f;
      bool member = false;
      if (u < len) {
        d = d2_of(sp[u], qx, qy, qz);
        member = d <= thr && t0 + u != i;
      }
      unsigned mask = __ballot_sync(kFull, member);
      while (mask) {
        const int src = __ffs(mask) - 1;
        mask &= mask - 1;
        const int j = t0 + u0 + src;
        const float dj = __shfl_sync(kFull, d, src);
        float fj[CPL];
        load_row<CPL>(f + (base + j) * c, c, lane, fj);
        const float s = warp_dot<CPL>(fi, fj);
        const float e = expf(__fmul_rn(s, tinv));
        const float dt = root ? __fsqrt_rn(__fadd_rn(fabsf(dj), 1e-12f)) : dj;
        if (sp[u0 + src].w == ql) {
          acc_p += e;
          acc_np += 1.f;
          if (need_s) acc_sp += s;
          if (need_d) acc_dp += dt;
        } else {
          acc_q += e;
          acc_nn += 1.f;
          if (need_s) acc_sn += s;
          if (need_d) acc_dn += dt;
        }
      }
    }
  }
  if (active && lane == 0) {
    float* o = out + (base + i) * 9;
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

// The weight of pair (i, j) from query i's incoming gradients g4_i.
__device__ __forceinline__ float pair_weight(float s, bool pos, float4 g,
                                             float tinv, int need_s) {
  const float e = expf(__fmul_rn(s, tinv));
  float w = __fmul_rn(__fmul_rn(pos ? g.x : g.y, e), tinv);
  if (need_s) w = __fadd_rn(w, pos ? g.z : g.w);
  return w;
}

// rows: warp per query i, scanning the support j; support: warp per
// support point j, scanning the queries i (each with its own threshold).
template <int CPL, bool kSupport>
__global__ void __launch_bounds__(kThreads)
contrast_grad_kernel(const float* __restrict__ p, const float* __restrict__ f,
                     const float* __restrict__ lab,
                     const float* __restrict__ kth,
                     const float4* __restrict__ g4, int n, int c, float tinv,
                     int need_s, float* __restrict__ df) {
  __shared__ float4 sp[kTile];
  __shared__ float sthr[kSupport ? kTile : 1];
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int me = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const bool active = me < n;
  const size_t base = static_cast<size_t>(b) * n;
  float mx = 0.f, my = 0.f, mz = 0.f, ml = 0.f;
  float thr = -1.f;  // rows: own threshold; an idle warp admits nothing
  float4 gme = make_float4(0.f, 0.f, 0.f, 0.f);
  float fme[CPL], acc[CPL];
#pragma unroll
  for (int t = 0; t < CPL; ++t) acc[t] = 0.f;
  if (active) {
    mx = p[(base + me) * 3];
    my = p[(base + me) * 3 + 1];
    mz = p[(base + me) * 3 + 2];
    ml = lab[base + me];
    if (!kSupport) {
      thr = kth[base + me];
      gme = g4[base + me];
    }
    load_row<CPL>(f + (base + me) * c, c, lane, fme);
  } else {
#pragma unroll
    for (int t = 0; t < CPL; ++t) fme[t] = 0.f;
  }

  for (int t0 = 0; t0 < n; t0 += kTile) {
    const int len = min(kTile, n - t0);
    __syncthreads();
    stage(p, lab, base, t0, len, sp);
    if (kSupport) {
      for (int t = threadIdx.x; t < len; t += kThreads)
        sthr[t] = kth[base + t0 + t];
    }
    __syncthreads();
    for (int u0 = 0; u0 < len; u0 += 32) {
      const int u = u0 + lane;
      bool member = false;
      if (u < len && active) {
        const float d = d2_of(sp[u], mx, my, mz);
        member = d <= (kSupport ? sthr[u] : thr) && t0 + u != me;
      }
      unsigned mask = __ballot_sync(kFull, member);
      while (mask) {
        const int src = __ffs(mask) - 1;
        mask &= mask - 1;
        const int other = t0 + u0 + src;
        float fo[CPL];
        load_row<CPL>(f + (base + other) * c, c, lane, fo);
        const float s = warp_dot<CPL>(fme, fo);
        const bool pos = sp[u0 + src].w == ml;
        const float w = pair_weight(s, pos, kSupport ? g4[base + other] : gme,
                                    tinv, need_s);
#pragma unroll
        for (int t = 0; t < CPL; ++t) acc[t] = fmaf(w, fo[t], acc[t]);
      }
    }
  }
  if (active) {
    float* o = df + (base + me) * c;
#pragma unroll
    for (int t = 0; t < CPL; ++t) {
      const int ch = lane + 32 * t;
      if (ch < c) o[ch] = acc[t];
    }
  }
}

// channels per lane: the smallest of 1, 2, 4, 8, 16 covering c
int lanes_cpl(int c) {
  int cpl = 1;
  while (cpl * 32 < c) cpl *= 2;
  return cpl;
}

template <int CPL>
void launch_fwd(dim3 grid, cudaStream_t st, const float* p, const float* f,
                const float* lab, const float* kth, int n, int c, float tinv,
                int root, int need_s, int need_d, float* out) {
  contrast_fwd_kernel<CPL><<<grid, kThreads, 0, st>>>(
      p, f, lab, kth, n, c, tinv, root, need_s, need_d, out);
}

template <int CPL, bool kSupport>
void launch_grad(dim3 grid, cudaStream_t st, const float* p, const float* f,
                 const float* lab, const float* kth, const float4* g4, int n,
                 int c, float tinv, int need_s, float* df) {
  contrast_grad_kernel<CPL, kSupport><<<grid, kThreads, 0, st>>>(
      p, f, lab, kth, g4, n, c, tinv, need_s, df);
}

template <bool kSupport>
int grad_entry(const void* p, const void* f, const void* lab, const void* kth,
               const void* g4, void* df, int b, int n, int c, float tinv,
               int need_s, void* stream) {
  const dim3 grid((n + kWarps - 1) / kWarps, b);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* pp = static_cast<const float*>(p);
  const auto* ff = static_cast<const float*>(f);
  const auto* ll = static_cast<const float*>(lab);
  const auto* kk = static_cast<const float*>(kth);
  const auto* gg = static_cast<const float4*>(g4);
  auto* out = static_cast<float*>(df);
  switch (lanes_cpl(c)) {
    case 1: launch_grad<1, kSupport>(grid, st, pp, ff, ll, kk, gg, n, c, tinv, need_s, out); break;
    case 2: launch_grad<2, kSupport>(grid, st, pp, ff, ll, kk, gg, n, c, tinv, need_s, out); break;
    case 4: launch_grad<4, kSupport>(grid, st, pp, ff, ll, kk, gg, n, c, tinv, need_s, out); break;
    case 8: launch_grad<8, kSupport>(grid, st, pp, ff, ll, kk, gg, n, c, tinv, need_s, out); break;
    case 16: launch_grad<16, kSupport>(grid, st, pp, ff, ll, kk, gg, n, c, tinv, need_s, out); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// p (b, n, 3), f (b, n, c), lab (b, n), kth (b, n) float32, 1 <= c <= 512
// -> out (b, n, 9) float32.
extern "C" int amc3d_contrast_forward(const void* p, const void* f,
                                      const void* lab, const void* kth,
                                      void* out, int b, int n, int c,
                                      float tinv, int root, int need_s,
                                      int need_d, void* stream) {
  const dim3 grid((n + kWarps - 1) / kWarps, b);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* pp = static_cast<const float*>(p);
  const auto* ff = static_cast<const float*>(f);
  const auto* ll = static_cast<const float*>(lab);
  const auto* kk = static_cast<const float*>(kth);
  auto* o = static_cast<float*>(out);
  switch (lanes_cpl(c)) {
    case 1: launch_fwd<1>(grid, st, pp, ff, ll, kk, n, c, tinv, root, need_s, need_d, o); break;
    case 2: launch_fwd<2>(grid, st, pp, ff, ll, kk, n, c, tinv, root, need_s, need_d, o); break;
    case 4: launch_fwd<4>(grid, st, pp, ff, ll, kk, n, c, tinv, root, need_s, need_d, o); break;
    case 8: launch_fwd<8>(grid, st, pp, ff, ll, kk, n, c, tinv, root, need_s, need_d, o); break;
    case 16: launch_fwd<16>(grid, st, pp, ff, ll, kk, n, c, tinv, root, need_s, need_d, o); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// g4 (b, n, 4) float32: incoming gradients of P, Q, Spos, Sneg.
// -> df (b, n, c) float32, the query-side part of the VJP.
extern "C" int amc3d_contrast_grad_rows(const void* p, const void* f,
                                        const void* lab, const void* kth,
                                        const void* g4, void* df, int b,
                                        int n, int c, float tinv, int need_s,
                                        void* stream) {
  return grad_entry<false>(p, f, lab, kth, g4, df, b, n, c, tinv, need_s,
                           stream);
}

// -> df (b, n, c) float32, the support-side part of the VJP.
extern "C" int amc3d_contrast_grad_support(const void* p, const void* f,
                                           const void* lab, const void* kth,
                                           const void* g4, void* df, int b,
                                           int n, int c, float tinv,
                                           int need_s, void* stream) {
  return grad_entry<true>(p, f, lab, kth, g4, df, b, n, c, tinv, need_s,
                          stream);
}
