// Furthest point sampling of a batch: one thread-block cluster a cloud.
//
// Replaces amcontrast3d_tpu/ops/fps_pallas.py::_fps_kernel, the batched
// (B > 1) TPU kernel that keeps x/y/z planes and the (B, N) min-distance
// buffer in VMEM and advances every cloud of the batch per loop step.
// Semantics of both: the first pick is index 0, the min-distance buffer
// starts at 1e10, each step takes the argmax of the buffer with ties to the
// lowest index, and d^2 = (dx*dx + dy*dy) + dz*dz, rounded op by op
// (built with -fmad=false and written with __f*_rn, so it rounds exactly as
// the plain PyTorch twin in ops/fps.py).
//
// What bounds it on the card: the npoint - 1 steps are sequential, so the
// time is the latency of that chain, not bandwidth or arithmetic.  The
// kernel is fps_cluster.cuh's: every cloud of the batch in one launch, one
// cluster of S blocks a cloud, each thread keeping its points and their
// min-distances in registers, one block barrier a pick (S = 1) or one
// exchange through distributed shared memory (S > 1).  ops/fps.py picks S
// from the cloud's size (gates read off the card, PERF.md) and lowers it
// where the card cannot hold the batch's B clusters at once.  A cloud of
// more than 16 x 512 x 20 = 163840 points goes to fps_b1.cu's grid kernel,
// one cloud after another.
#include "fps_cluster.cuh"

using namespace fps_cluster;

// xyz (b, n, 3) float32 -> out (b, npoint) int32, one cluster of s blocks
// (1, 2, 4, 8 or 16) a cloud; n <= s x 512 x 20, else cudaErrorInvalidValue.
extern "C" int amc3d_fps(const void* xyz, void* out, int b, int n, int npoint,
                         int s, void* stream) {
  const auto* x = static_cast<const float*>(xyz);
  auto* o = static_cast<int*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (s) {
    case 1: err = launch<1>(x, o, b, n, npoint, st); break;
    case 2: err = launch<2>(x, o, b, n, npoint, st); break;
    case 4: err = launch<4>(x, o, b, n, npoint, st); break;
    case 8: err = launch<8>(x, o, b, n, npoint, st); break;
    case 16: err = launch<16>(x, o, b, n, npoint, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// How many clusters of s blocks the current device holds at once (0: none);
// a negative number is minus a CUDA error code.
extern "C" int amc3d_fps_clusters(int s) {
  switch (s) {
    case 1: return clusters<1>();
    case 2: return clusters<2>();
    case 4: return clusters<4>();
    case 8: return clusters<8>();
    case 16: return clusters<16>();
    default: return -static_cast<int>(cudaErrorInvalidValue);
  }
}
