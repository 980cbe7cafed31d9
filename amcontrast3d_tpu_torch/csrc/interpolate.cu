// 3-NN inverse-distance interpolation, forward, fused.
//
// Replaces amcontrast3d_tpu/ops/interpolate_pallas.py::_interp_kernel, the
// TPU kernel that finds each fine point's 3rd-nearest coarse d^2 and then
// sums w * f over every coarse point at or below it in one matmul per tile.
// That kernel averages d^2 ties at the 3rd neighbour (a 4th point within a
// 1e-6 relative cushion enters with its own weight); this kernel follows
// the JAX plain path (ops/interpolate.py:42-57) instead: exactly three
// neighbours, ties to the lowest index (as lax.top_k), weights
// w_i = 1 / (sqrt(max(d_i^2, 0)) + 1e-8) / sum_j w_j, and
// out[c] = (f[i0,c]*w0 + f[i1,c]*w1) + f[i2,c]*w2.  Every step rounds as
// the plain PyTorch twin in ops/interpolate.py rounds it (-fmad=false,
// __f*_rn, IEEE sqrt and division).
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
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 1024;

__global__ void __launch_bounds__(kThreads)
interp_kernel(const float* __restrict__ p1, const float* __restrict__ p2,
              const float* __restrict__ f2, int n1, int n2, int c,
              float* __restrict__ out) {
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

}  // namespace

// p1 (b, n1, 3) fine, p2 (b, n2, 3) coarse, f2 (b, n2, c) float32
// -> out (b, n1, c) float32.
extern "C" int amc3d_three_interpolate(const void* p1, const void* p2,
                                       const void* f2, void* out, int b,
                                       int n1, int n2, int c, void* stream) {
  const dim3 grid((n1 + kThreads - 1) / kThreads, b);
  interp_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(p1), static_cast<const float*>(p2),
      static_cast<const float*>(f2), n1, n2, c, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
