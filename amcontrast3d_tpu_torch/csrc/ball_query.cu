// Ball query: the first k support points in index order with d^2 < r^2.
//
// Replaces amcontrast3d_tpu/ops/knn_pallas.py::_ball_kernel_value, the
// value-only TPU ball query, which keeps the best two in-ball points per
// 128-point bin of a fixed support permutation and so returns a random
// k-subset of an overfull ball.  This kernel keeps the semantics of the
// JAX plain path (ops/knn.py::_ball_query_jnp) and of the reference CUDA
// ball_query_gpu.cu instead: the first k hits in index order, empty slots
// padded with the first hit, an empty ball giving 0, and k > N allowed.
// d^2 = (dx*dx + dy*dy) + dz*dz, rounded op by op (-fmad=false, __f*_rn),
// exactly as the plain PyTorch twin in ops/knn.py rounds it.
//
// What bounds it on the card: instruction throughput.  A query whose
// ball holds fewer than k points (most queries on uniform clouds at the
// first radius) must test every support point, M * N distance tests in
// all (about 0.6 G at the slice's 6000-by-24000 shape); the index writes
// are k ints per query.
// Design: one thread per query, 256 queries per block; support tiles of
// 1024 points are staged through shared memory and read as broadcasts (all
// threads read the same point), so the inner loop is a few FLOPs and a
// compare per test.  A block stops staging tiles once every query in it
// holds k hits (__syncthreads_and), which cuts dense, clustered clouds
// short.  A warp per query with __ballot_sync is the alternative for
// dense balls, left for a later change.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;

__global__ void __launch_bounds__(kThreads)
ball_query_kernel(const float* __restrict__ support,
                  const float* __restrict__ query, int n, int m, int k,
                  float r2, int* __restrict__ out) {
  __shared__ float sx[kTile], sy[kTile], sz[kTile];

  const int b = blockIdx.y;
  const int qi = blockIdx.x * kThreads + threadIdx.x;
  const bool active = qi < m;
  const float* s = support + static_cast<size_t>(b) * n * 3;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  int* o = out + (static_cast<size_t>(b) * m + qi) * k;
  if (active) {
    const float* q = query + (static_cast<size_t>(b) * m + qi) * 3;
    qx = q[0];
    qy = q[1];
    qz = q[2];
  }
  int cnt = 0, first = 0;
  bool done = !active;

  for (int base = 0; base < n; base += kTile) {
    // also the barrier that lets the previous tile be overwritten
    if (__syncthreads_and(done)) break;
    const int len = min(kTile, n - base);
    for (int t = threadIdx.x; t < len; t += kThreads) {
      const float* sp = s + static_cast<size_t>(base + t) * 3;
      sx[t] = sp[0];
      sy[t] = sp[1];
      sz[t] = sp[2];
    }
    __syncthreads();
    if (done) continue;
    for (int t = 0; t < len; ++t) {
      const float dx = __fsub_rn(qx, sx[t]);
      const float dy = __fsub_rn(qy, sy[t]);
      const float dz = __fsub_rn(qz, sz[t]);
      const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                 __fmul_rn(dz, dz));
      if (d2 < r2) {
        if (cnt == 0) first = base + t;
        o[cnt] = base + t;
        if (++cnt == k) {
          done = true;
          break;
        }
      }
    }
  }
  if (active) {
    for (int t = cnt; t < k; ++t) o[t] = first;  // first == 0 for an empty ball
  }
}

}  // namespace

// support (b, n, 3), query (b, m, 3) float32 -> out (b, m, k) int32;
// r2 is r^2 rounded to float32.
extern "C" int amc3d_ball_query(const void* support, const void* query,
                                void* out, int b, int n, int m, int k,
                                float r2, void* stream) {
  const dim3 grid((m + kThreads - 1) / kThreads, b);
  ball_query_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(support), static_cast<const float*>(query), n,
      m, k, r2, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
