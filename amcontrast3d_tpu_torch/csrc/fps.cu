// Furthest point sampling: one thread block per cloud.
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
// What bounds it on the card: the npoint - 1 steps are sequential, and each
// is a pass over N points plus a block-wide argmax with two barriers.  One
// block per cloud puts B blocks on B of the 132 SMs, so the kernel is bound
// by the latency of that chain on one SM, not by bandwidth or arithmetic.
// Design: 1024 threads per block (as the reference sampling_gpu.cu); the
// N-float min-distance buffer lives in shared memory (96 KB at N = 24000,
// dynamic shared memory opted in above 48 KB); xyz (288 KB per cloud) is
// read from global memory and stays in L2 after the first pass; the argmax
// is a warp-shuffle reduction of (value, index) pairs followed by one warp
// over the 32 warp winners.  Spreading a cloud over several blocks (and
// the B = 4 batch over more SMs) is left for a later change.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

// keep the larger value; on equal values keep the lower index
__device__ __forceinline__ void take_better(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, v, off);
    const int oi = __shfl_down_sync(0xffffffffu, i, off);
    take_better(v, i, ov, oi);
  }
}

__global__ void __launch_bounds__(kThreads)
fps_kernel(const float* __restrict__ xyz, int n, int npoint,
           int* __restrict__ out) {
  extern __shared__ float mind[];  // n floats
  __shared__ float warp_val[kWarps];
  __shared__ int warp_idx[kWarps];
  __shared__ int picked;

  const float* p = xyz + static_cast<size_t>(blockIdx.x) * n * 3;
  int* o = out + static_cast<size_t>(blockIdx.x) * npoint;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int i = tid; i < n; i += kThreads) mind[i] = 1e10f;
  if (tid == 0) o[0] = 0;
  int last = 0;
  __syncthreads();

  for (int j = 1; j < npoint; ++j) {
    const float lx = p[last * 3], ly = p[last * 3 + 1], lz = p[last * 3 + 2];
    float best = -1.0f;
    int besti = n;
    for (int i = tid; i < n; i += kThreads) {
      const float dx = __fsub_rn(p[i * 3], lx);
      const float dy = __fsub_rn(p[i * 3 + 1], ly);
      const float dz = __fsub_rn(p[i * 3 + 2], lz);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                __fmul_rn(dz, dz));
      const float m = fminf(mind[i], d);
      mind[i] = m;
      if (m > best) {  // i increases, so a tie keeps the lower index
        best = m;
        besti = i;
      }
    }
    warp_argmax(best, besti);
    if (lane == 0) {
      warp_val[warp] = best;
      warp_idx[warp] = besti;
    }
    __syncthreads();
    if (warp == 0) {
      best = warp_val[lane];
      besti = warp_idx[lane];
      warp_argmax(best, besti);
      if (lane == 0) {
        picked = besti;
        o[j] = besti;
      }
    }
    __syncthreads();
    last = picked;
  }
}

}  // namespace

// xyz (b, n, 3) float32, out (b, npoint) int32; needs n * 4 bytes of
// shared memory per block.
extern "C" int amc3d_fps(const void* xyz, void* out, int b, int n, int npoint,
                         void* stream) {
  const int smem = n * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      fps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fps_kernel<<<b, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xyz), n, npoint, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
