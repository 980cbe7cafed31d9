// Furthest point sampling: a batch, one thread-block cluster a cloud, and
// one cloud spread over the whole card.
//
// Replaces amcontrast3d_tpu/ops/fps_pallas.py::_fps_kernel, the batched
// (B > 1) TPU kernel that keeps x/y/z planes and the (B, N) min-distance
// buffer in VMEM and advances every cloud of the batch per loop step, and
// _fps_kernel_r8 (entry _fps_b1), the TPU kernel a B == 1 call (a whole
// room as one cloud) reaches, where the chunk-pruned kernel of
// fps_pruned.cu does not take it.  Semantics of all: the first pick is
// index 0, the min-distance buffer starts at 1e10, each step takes the
// argmax of the buffer with ties to the lowest index, and
// d^2 = (dx*dx + dy*dy) + dz*dz, rounded op by op (built with -fmad=false
// and written with __f*_rn, so it rounds exactly as the plain PyTorch twin
// in ops/fps.py).
//
// What bounds it on the card: the npoint - 1 steps are sequential, so the
// time is the latency of that chain, not bandwidth or arithmetic.
//
// The cluster kernel (amc3d_fps) is fps_cluster.cuh's: every cloud of the
// batch in one launch, one cluster of S blocks a cloud, each thread
// keeping its points and their min-distances in registers, one block
// barrier a pick (S = 1) or one exchange through distributed shared memory
// (S > 1).  ops/fps.py picks S from the cloud's size (gates read off the
// card, PERF.md) and lowers it where the card cannot hold the batch's B
// clusters at once; it serves a batch, and one whole-room cloud (B = 1) to
// 16 x 512 x 20 = 163840 points.
//
// The grid kernel (amc3d_fps_grid, any cloud up to 14336 points a
// multiprocessor: 1.89 M on 132) serves one cloud above that which the
// chunk-pruned kernel does not take (fewer than ops/fps.py's
// PRUNED_MIN_SHARE of the points picked), a card that holds no cluster
// large enough, and a batch above 163840 points a cloud, cloud by cloud.
// It gives a block a contiguous range of the cloud and keeps its x, y, z
// and min-distance in shared memory (16 bytes a point) for the whole run: a
// cooperative launch of up to one block per SM, so every block is resident
// and may wait for the others.  Per pick a block sweeps its range and
// reduces (value, index) to one 64-bit key = value bits << 32 | ~index
// (d^2 >= +0, whose float bits order as integers; the complement makes the
// lowest index win a tie, and the order survives the reduction across
// blocks because whole keys are compared).  Thread 0 folds the block's key
// into the pick's own slot in device memory with atomicMax, counts the
// block in, and spins until all blocks are in: one barrier a pick, and no
// slot is ever reused, so there is nothing to reset and no pick can
// overtake another.  The wrapper hands in the zeroed slots (8 + 4 bytes a
// pick); the winner's position is read from device memory.  Small clouds
// take fewer blocks (1024 points a block at least).  A barrier in which
// every block polls tagged records of all the others takes twice as long
// at 132 blocks (PERF.md).
#include <cuda_runtime.h>

#include "cluster.cuh"
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

namespace {

namespace fps_grid {

using namespace amc3d;

constexpr int kThreads = 512;  // the grid kernel's block
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlockPoints = 14336;  // 16 B each: 224 KB of shared memory
constexpr int kMinBlockPoints = 1024;

__global__ void __launch_bounds__(kThreads)
fps_grid_kernel(const float* __restrict__ xyz, int n, int npoint, int per_block,
              Key* best, unsigned* arrived, int* __restrict__ out) {
  extern __shared__ float smem[];  // x, y, z, mind: per_block floats each
  float* sx = smem;
  float* sy = sx + per_block;
  float* sz = sy + per_block;
  float* mind = sz + per_block;
  __shared__ Key warp_key[kWarps];
  __shared__ float last[3];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lo = min(n, static_cast<int>(blockIdx.x) * per_block);
  const int cnt = min(n, lo + per_block) - lo;
  for (int i = tid; i < cnt; i += kThreads) {
    const float* p = xyz + static_cast<size_t>(lo + i) * 3;
    sx[i] = p[0];
    sy[i] = p[1];
    sz[i] = p[2];
    mind[i] = 1e10f;
  }
  if (tid < 3) last[tid] = xyz[tid];
  if (blockIdx.x == 0 && tid == 0) out[0] = 0;
  __syncthreads();

  for (int j = 1; j < npoint; ++j) {
    const float lx = last[0], ly = last[1], lz = last[2];
    Key key = 0;  // below every point's key: an empty range never wins
    for (int i = tid; i < cnt; i += kThreads) {
      const float dx = __fsub_rn(sx[i], lx);
      const float dy = __fsub_rn(sy[i], ly);
      const float dz = __fsub_rn(sz[i], lz);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                __fmul_rn(dz, dz));
      const float m = fminf(mind[i], d);
      mind[i] = m;
      const Key c = make_key(m, lo + i);
      key = c > key ? c : key;
    }
    key = warp_max(key);
    if (lane == 0) warp_key[warp] = key;
    __syncthreads();  // also: every thread has read last[] for this pick
    if (warp == 0) {
      key = warp_max(lane < kWarps ? warp_key[lane] : 0);
      if (lane == 0) {
        atomicMax(best + j, key);
        __threadfence();
        atomicAdd(arrived + j, 1u);
        while (*reinterpret_cast<volatile unsigned*>(arrived + j) < gridDim.x) {
        }
        __threadfence();
        const int pick = key_index(*reinterpret_cast<volatile Key*>(best + j));
        const float* p = xyz + static_cast<size_t>(pick) * 3;
        last[0] = p[0];
        last[1] = p[1];
        last[2] = p[2];
        if (blockIdx.x == 0) out[j] = pick;
      }
    }
    __syncthreads();
  }
}

}  // namespace fps_grid

}  // namespace

// xyz (n, 3) float32, one cloud -> out (npoint) int32, through the grid
// kernel.  best (npoint uint64) and arrived (npoint uint32) are scratch the
// caller has zeroed.  Returns cudaErrorInvalidValue when the cloud does not
// fit the card's shared memory (more than 14336 points a resident block).
extern "C" int amc3d_fps_grid(const void* xyz, void* out, void* best,
                              void* arrived, int n, int npoint, void* stream) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // blocks that keep at least kMinBlockPoints each, one per SM at most
  const int least = fps_grid::kMinBlockPoints;
  int blocks = (n + least - 1) / least;
  blocks = blocks < 1 ? 1 : (blocks > sms ? sms : blocks);
  int per_block = (n + blocks - 1) / blocks;
  if (per_block > fps_grid::kMaxBlockPoints)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = per_block * 4 * static_cast<int>(sizeof(float));
  err = cudaFuncSetAttribute(fps_grid::fps_grid_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* x = static_cast<const float*>(xyz);
  auto* bp = static_cast<amc3d::Key*>(best);
  auto* ap = static_cast<unsigned*>(arrived);
  int* o = static_cast<int*>(out);
  void* args[] = {&x, &n, &npoint, &per_block, &bp, &ap, &o};
  // refused, not hung, if the blocks cannot all be resident at once
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(fps_grid::fps_grid_kernel), dim3(blocks),
      dim3(fps_grid::kThreads), args, smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
