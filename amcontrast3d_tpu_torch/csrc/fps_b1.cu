// Furthest point sampling of one large cloud, spread over the whole card.
//
// Replaces amcontrast3d_tpu/ops/fps_pallas.py::_fps_kernel_r8 (entry
// _fps_b1), the TPU kernel every B == 1 call reaches: a whole room as one
// cloud, from a few thousand to more than a million points.  Semantics are
// those of fps.cu and of the plain PyTorch twin in ops/fps.py: the first
// pick is index 0, the min-distance buffer starts at 1e10, each step takes
// the argmax of the buffer with ties to the lowest index, and
// d^2 = (dx*dx + dy*dy) + dz*dz, rounded op by op (-fmad=false, __f*_rn).
//
// What bounds it on the card: the npoint - 1 picks depend on each other,
// and each needs the argmax over the whole cloud, so the time is
// (picks) x (one sweep over a block's share + one card-wide reduction).
// The arithmetic (10 float instructions a point and pick) and the bytes
// are small beside the latency of that reduction.
//
// Both kernels here give a block a contiguous range of the cloud and keep
// its x, y, z and min-distance on chip for the whole run.  Per pick a block
// sweeps its range and reduces (value, index) to one 64-bit key = value
// bits << 32 | ~index (d^2 >= +0, whose float bits order as integers; the
// complement makes the lowest index win a tie, and the order survives the
// reduction across blocks because whole keys are compared).  They differ in
// where the points live and how the blocks' winners meet.
//
// The grid kernel (any cloud up to 14336 points a multiprocessor: 1.89 M
// on 132): a cooperative launch of up to one block per SM, so every block
// is resident and may wait for the others; the points are in shared memory
// (16 bytes each).  Thread 0 folds the block's key
// into the pick's own slot in device memory with atomicMax, counts the
// block in, and spins until all blocks are in: one barrier a pick, and no
// slot is ever reused, so there is nothing to reset and no pick can
// overtake another.  The wrapper hands in the zeroed slots (8 + 4 bytes a
// pick); the winner's position is read from device memory.  Small clouds
// take fewer blocks (1024 points a block at least).  A barrier in which
// every block polls tagged records of all the others takes twice as long
// at 132 blocks (PERF.md).
//
// The cluster path (a cloud of at most 16 x 512 x 20 = 163840 points: every
// voxel-rank subcloud of a room up to the 155648 bucket) leaves device
// memory out of the loop: the register-resident kernel of fps_cluster.cuh,
// shared with the batched kernel of fps.cu, with one cluster of 16 blocks
// (the non-portable size).  On 16 multiprocessors a sweep through shared
// memory would be bound by its bandwidth (16 bytes a point and pick), so a
// thread keeps its points in registers; the blocks exchange their winners
// with st.async and mbarriers, one trip through the cluster's network a pick
// (cluster.sync() takes three times as long, PERF.md).  ops/fps.py asks
// amc3d_fps_clusters whether the card can hold such a cluster and sends the
// cloud to the grid kernel where it cannot.
#include <cuda_runtime.h>

#include "cluster.cuh"
#include "fps_cluster.cuh"

namespace {

using namespace amc3d;

constexpr int kThreads = 512;  // the grid kernel's block
constexpr int kWarps = kThreads / 32;
constexpr int kClusterBlocks = 16;  // the cluster path's
constexpr int kMaxBlockPoints = 14336;  // 16 B each: 224 KB of shared memory
constexpr int kMinBlockPoints = 1024;

__global__ void __launch_bounds__(kThreads)
fps_b1_kernel(const float* __restrict__ xyz, int n, int npoint, int per_block,
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

}  // namespace

// xyz (n, 3) float32, one cloud -> out (npoint) int32, through the grid
// kernel.  best (npoint uint64) and arrived (npoint uint32) are scratch the
// caller has zeroed.  Returns cudaErrorInvalidValue when the cloud does not
// fit the card's shared memory (more than 14336 points a resident block).
extern "C" int amc3d_fps_b1(const void* xyz, void* out, void* best,
                            void* arrived, int n, int npoint, void* stream) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // blocks that keep at least kMinBlockPoints each, one per SM at most
  int blocks = (n + kMinBlockPoints - 1) / kMinBlockPoints;
  blocks = blocks < 1 ? 1 : (blocks > sms ? sms : blocks);
  int per_block = (n + blocks - 1) / blocks;
  if (per_block > kMaxBlockPoints) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = per_block * 4 * static_cast<int>(sizeof(float));
  err = cudaFuncSetAttribute(fps_b1_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* x = static_cast<const float*>(xyz);
  auto* bp = static_cast<Key*>(best);
  auto* ap = static_cast<unsigned*>(arrived);
  int* o = static_cast<int*>(out);
  void* args[] = {&x, &n, &npoint, &per_block, &bp, &ap, &o};
  // refused, not hung, if the blocks cannot all be resident at once
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(fps_b1_kernel), dim3(blocks), dim3(kThreads),
      args, smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// xyz (n, 3) float32, one cloud -> out (npoint) int32 through the cluster
// kernel of fps_cluster.cuh with 16 blocks; n <= 16 x 512 x 20, else
// cudaErrorInvalidValue.
extern "C" int amc3d_fps_b1_cluster(const void* xyz, void* out, int n,
                                    int npoint, void* stream) {
  return static_cast<int>(fps_cluster::launch<kClusterBlocks>(
      static_cast<const float*>(xyz), static_cast<int*>(out), 1, n, npoint,
      static_cast<cudaStream_t>(stream)));
}
