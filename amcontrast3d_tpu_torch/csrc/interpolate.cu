// 3-NN inverse-distance interpolation: the fused forward and its VJP.
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
//
// What bounds it on the card: the selection, N1 * N2 distance tests
// (0.58 G at the slice's 24000-by-6000 stage), is instruction throughput;
// the weighted sum reads 3 rows of C floats per fine point and writes one,
// a few MB per stage, which is bandwidth and is small.
// Design: one block of 128 threads per 128 fine points.  Phase 1: each
// thread keeps its point's 3 smallest (d^2, index) pairs in registers over
// coarse tiles of 1024 points staged through shared memory (broadcast
// reads); comparisons are strict, in index order.  Phase 2: the block's
// 128 (index, weight) triples go to shared memory and the threads sweep
// the (point, channel) pairs with the channel fastest, so each f2 row is
// read and each output row written coalesced.  Nothing is materialised in
// device memory between the two phases.
//
// Backward.  Replaces interpolate_pallas.py::_interp_bwd_kernel, which
// re-derives each support chunk's weights from the thresholds and forms
// df2 = W^T g as one matmul per (query tile, support chunk).  Here the
// forward's saved indices and weights make it a scatter:
// df2[idx[i,k], c] += w[i,k] * g[i,c] for the 3 neighbours of every fine
// point.  Bound: 3 * N1 * C float atomics (37 M at the 24000-to-6000
// stage) into L2, plus reading g once.  Design: the threads sweep the
// (fine point, channel) pairs with the channel fastest, so g is read
// coalesced and each warp's atomics land on one C-contiguous df2 row;
// the atomics (RED.ADD.F32, result unused) make the summation order vary
// from run to run, so df2 agrees with the twin's index_add_ to rounding
// (tolerance stated in the tests), not bit for bit.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 1024;

__global__ void __launch_bounds__(kThreads)
interp_kernel(const float* __restrict__ p1, const float* __restrict__ p2,
              const float* __restrict__ f2, int n1, int n2, int c,
              float* __restrict__ out, int* __restrict__ idx_out,
              float* __restrict__ w_out) {
  __shared__ float sx[kTile], sy[kTile], sz[kTile];
  __shared__ int nb_idx[3][kThreads];
  __shared__ float nb_w[3][kThreads];

  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kThreads;
  const int qi = q0 + threadIdx.x;
  const bool active = qi < n1;
  const float* s = p2 + static_cast<size_t>(b) * n2 * 3;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (active) {
    const float* q = p1 + (static_cast<size_t>(b) * n1 + qi) * 3;
    qx = q[0];
    qy = q[1];
    qz = q[2];
  }
  // ascending; the 1e10 / index 0 fillers stand for missing neighbours
  // when n2 < 3, as the JAX kNN pads them
  float d0 = 1e10f, d1 = 1e10f, d2 = 1e10f;
  int i0 = 0, i1 = 0, i2 = 0;

  for (int base = 0; base < n2; base += kTile) {
    const int len = min(kTile, n2 - base);
    __syncthreads();  // the previous tile is no longer read
    for (int t = threadIdx.x; t < len; t += kThreads) {
      const float* sp = s + static_cast<size_t>(base + t) * 3;
      sx[t] = sp[0];
      sy[t] = sp[1];
      sz[t] = sp[2];
    }
    __syncthreads();
    for (int t = 0; t < len; ++t) {
      const float dx = __fsub_rn(qx, sx[t]);
      const float dy = __fsub_rn(qy, sy[t]);
      const float dz = __fsub_rn(qz, sz[t]);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                __fmul_rn(dz, dz));
      if (d < d2) {
        const int j = base + t;
        if (d < d1) {
          d2 = d1;
          i2 = i1;
          if (d < d0) {
            d1 = d0;
            i1 = i0;
            d0 = d;
            i0 = j;
          } else {
            d1 = d;
            i1 = j;
          }
        } else {
          d2 = d;
          i2 = j;
        }
      }
    }
  }

  const float r0 = __fdiv_rn(1.0f, __fadd_rn(__fsqrt_rn(fmaxf(d0, 0.f)), 1e-8f));
  const float r1 = __fdiv_rn(1.0f, __fadd_rn(__fsqrt_rn(fmaxf(d1, 0.f)), 1e-8f));
  const float r2 = __fdiv_rn(1.0f, __fadd_rn(__fsqrt_rn(fmaxf(d2, 0.f)), 1e-8f));
  const float norm = __fadd_rn(__fadd_rn(r0, r1), r2);
  nb_idx[0][threadIdx.x] = i0;
  nb_idx[1][threadIdx.x] = i1;
  nb_idx[2][threadIdx.x] = i2;
  nb_w[0][threadIdx.x] = __fdiv_rn(r0, norm);
  nb_w[1][threadIdx.x] = __fdiv_rn(r1, norm);
  nb_w[2][threadIdx.x] = __fdiv_rn(r2, norm);
  if (idx_out != nullptr && active) {
    const size_t row = (static_cast<size_t>(b) * n1 + qi) * 3;
    for (int k = 0; k < 3; ++k) {
      idx_out[row + k] = nb_idx[k][threadIdx.x];
      w_out[row + k] = nb_w[k][threadIdx.x];
    }
  }
  __syncthreads();

  const int npts = min(kThreads, n1 - q0);
  const float* f = f2 + static_cast<size_t>(b) * n2 * c;
  float* o = out + (static_cast<size_t>(b) * n1 + q0) * c;
  const int total = npts * c;
  for (int e = threadIdx.x; e < total; e += kThreads) {
    const int q = e / c, ch = e - q * c;
    const float v0 = __fmul_rn(f[static_cast<size_t>(nb_idx[0][q]) * c + ch], nb_w[0][q]);
    const float v1 = __fmul_rn(f[static_cast<size_t>(nb_idx[1][q]) * c + ch], nb_w[1][q]);
    const float v2 = __fmul_rn(f[static_cast<size_t>(nb_idx[2][q]) * c + ch], nb_w[2][q]);
    o[e] = __fadd_rn(__fadd_rn(v0, v1), v2);
  }
}

constexpr int kBwdPoints = 32;  // fine points per backward block

__global__ void __launch_bounds__(kThreads)
interp_bwd_kernel(const float* __restrict__ g, const int* __restrict__ idx,
                  const float* __restrict__ w, int n1, int n2, int c,
                  float* __restrict__ df2) {
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kBwdPoints;
  const int npts = min(kBwdPoints, n1 - q0);
  const size_t row0 = static_cast<size_t>(b) * n1 + q0;
  const float* gb = g + row0 * c;
  const int* ib = idx + row0 * 3;
  const float* wb = w + row0 * 3;
  float* d = df2 + static_cast<size_t>(b) * n2 * c;
  const int total = npts * c;
  for (int e = threadIdx.x; e < total; e += kThreads) {
    const int q = e / c, ch = e - q * c;
    const float v = gb[e];
    for (int k = 0; k < 3; ++k) {
      atomicAdd(d + static_cast<size_t>(ib[q * 3 + k]) * c + ch,
                __fmul_rn(wb[q * 3 + k], v));
    }
  }
}

}  // namespace

// p1 (b, n1, 3) fine, p2 (b, n2, 3) coarse, f2 (b, n2, c) float32
// -> out (b, n1, c) float32; idx_out (b, n1, 3) int32 and w_out (b, n1, 3)
// float32 are written too unless null.
extern "C" int amc3d_three_interpolate(const void* p1, const void* p2,
                                       const void* f2, void* out,
                                       void* idx_out, void* w_out, int b,
                                       int n1, int n2, int c, void* stream) {
  const dim3 grid((n1 + kThreads - 1) / kThreads, b);
  interp_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(p1), static_cast<const float*>(p2),
      static_cast<const float*>(f2), n1, n2, c, static_cast<float*>(out),
      static_cast<int*>(idx_out), static_cast<float*>(w_out));
  return static_cast<int>(cudaGetLastError());
}

// g (b, n1, c), idx (b, n1, 3) int32, w (b, n1, 3) float32 -> adds into
// df2 (b, n2, c) float32, which the caller zeroes.
extern "C" int amc3d_three_interpolate_backward(const void* g, const void* idx,
                                                const void* w, void* df2,
                                                int b, int n1, int n2, int c,
                                                void* stream) {
  const dim3 grid((n1 + kBwdPoints - 1) / kBwdPoints, b);
  interp_bwd_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<const int*>(idx),
      static_cast<const float*>(w), n1, n2, c, static_cast<float*>(df2));
  return static_cast<int>(cudaGetLastError());
}
