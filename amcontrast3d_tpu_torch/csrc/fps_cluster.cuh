// Furthest point sampling with a cloud's points in registers: one
// thread-block cluster of S blocks a cloud, every cloud of a batch in one
// launch.  fps.cu's kernel, for a batch (B > 1) and for one whole-room
// cloud to 163840 points (B = 1), S chosen from the batch and the cloud
// (ops/fps.py::fps_cluster_size).
//
// Semantics of every FPS kernel of the port and of the plain PyTorch twin in
// ops/fps.py: the first pick is index 0, the min-distance buffer starts at
// 1e10, each step takes the argmax of the buffer with ties to the lowest
// index, and d^2 = (dx*dx + dy*dy) + dz*dz, rounded op by op (-fmad=false,
// __f*_rn).  A candidate travels as one 64-bit key (cluster.cuh): whole keys
// are compared, so the lowest index wins a tie at every level.
//
// What bounds it on the card: the npoint - 1 picks depend on each other,
// so the time is picks x (one sweep over a block's share + one reduction
// over the cloud); the arithmetic (10 float instructions a point and pick)
// and the bytes are small beside the latency of that chain.  The design
// keeps both parts short: a sweep touches registers only, and a cloud
// spreads over S multiprocessors, so B clouds run on B x S of them.
//
// Layout.  Block r of a cluster owns the contiguous range
// [r * per_block, (r + 1) * per_block) of its cloud; thread t keeps the
// points lo + t + 512 q, q < PPT, as x, y, z and min-distance in registers,
// so within a thread q runs in index order and the first maximum it meets
// has the lowest index.  Slots without a point hold min-distance -1 and give
// key 0, which never wins (a point's key is never 0).  Shared memory holds a
// copy of the block's positions, to look up the winner's.
//
// A pick.  Every thread sweeps its points; each warp reduces its keys with
// two redux.sync (warp_max) and writes its key to shared memory; one block
// barrier.  Then
//   S = 1: every warp takes the largest of the 16 warp keys and reads the
//     winner's position from the block's copy.  The warp keys are
//     double-buffered by the pick's parity: a warp writes pick j + 2 only
//     after the barrier of pick j + 1, which every warp reaches after its
//     reads of pick j, so one barrier a pick is enough.
//   S > 1: warp 0 reduces the 16 warp keys and S of its lanes send the
//     block's key and its winner's position into a slot of every block's
//     shared memory with st.async, which counts the bytes in on the
//     receiving block's mbarrier; a block waits on its own mbarrier only
//     (one trip through the cluster's network a pick), and every warp then
//     takes the largest of the S keys.  Slots and mbarriers are
//     double-buffered by the pick's parity: a block can send pick j + 2
//     only after it has every block's pick j + 1, which each block sends
//     after its reads of pick j.
#pragma once
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "cluster.cuh"

// internal linkage (an unnamed namespace at file scope: nvcc's host stubs
// cannot name one nested in another namespace)
namespace {

namespace fps_cluster {

namespace cg = cooperative_groups;
using namespace amc3d;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxThreadPoints = 20;
// what a block sends to each block a pick: a key and a float4
constexpr unsigned kWinnerBytes = sizeof(Key) + sizeof(float4);
constexpr unsigned kFull = 0xffffffffu;

template <int S, int PPT>
__global__ void __launch_bounds__(kThreads, 1)
fps_cluster_kernel(const float* __restrict__ xyz, int n, int npoint,
                   int per_block, int* __restrict__ out) {
  extern __shared__ float spos[];  // x, y, z of the block's points
  // one cluster a cloud: cluster c of the grid samples cloud c
  const size_t cloud = blockIdx.x / S;
  xyz += cloud * n * 3;
  out += cloud * npoint;
  __shared__ Key warp_key[2][kWarps];
  // S > 1: per parity of the pick, the S blocks' winners: key, and x, y, z
  __shared__ __align__(16) Key win_key[2][S];
  __shared__ __align__(16) float4 win_pos[2][S];
  __shared__ __align__(8) unsigned long long arrived[2];  // mbarriers

  int rank = 0;
  if constexpr (S > 1) rank = static_cast<int>(cg::this_cluster().block_rank());
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lo = min(n, rank * per_block);
  const int cnt = min(n, lo + per_block) - lo;
  float px[PPT], py[PPT], pz[PPT], mind[PPT];
#pragma unroll
  for (int q = 0; q < PPT; ++q) {
    const int i = tid + kThreads * q;
    px[q] = py[q] = pz[q] = 0.f;
    mind[q] = -1.f;  // no point: below every min-distance, never a maximum
    if (i < cnt) {
      const float* p = xyz + static_cast<size_t>(lo + i) * 3;
      px[q] = spos[3 * i] = p[0];
      py[q] = spos[3 * i + 1] = p[1];
      pz[q] = spos[3 * i + 2] = p[2];
      mind[q] = 1e10f;
    }
  }
  float lx = xyz[0], ly = xyz[1], lz = xyz[2];
  if (rank == 0 && tid == 0) out[0] = 0;
  if constexpr (S > 1) {
    if (tid == 0) {
      mbarrier_init(shared_address(&arrived[0]));
      mbarrier_init(shared_address(&arrived[1]));
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    // every block runs, with its mbarriers set up, before any block sends
    cg::this_cluster().sync();
  } else {
    __syncthreads();  // the positions' copy is complete
  }

  for (int j = 1; j < npoint; ++j) {
    const int slot = j & 1;
    unsigned mbarrier = 0;
    if constexpr (S > 1) {
      mbarrier = shared_address(&arrived[slot]);
      if (tid == 0) mbarrier_expect(mbarrier, S * kWinnerBytes);
    }
    float best = -1.f;
    int best_q = 0;
#pragma unroll
    for (int q = 0; q < PPT; ++q) {
      const float dx = __fsub_rn(px[q], lx);
      const float dy = __fsub_rn(py[q], ly);
      const float dz = __fsub_rn(pz[q], lz);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                __fmul_rn(dz, dz));
      mind[q] = fminf(mind[q], d);
      if (mind[q] > best) {
        best = mind[q];
        best_q = q;
      }
    }
    Key key = best >= 0.f ? make_key(best, lo + tid + kThreads * best_q) : 0;
    key = warp_max(key);
    if (lane == 0) warp_key[slot][warp] = key;
    __syncthreads();
    Key top;
    if constexpr (S == 1) {
      top = warp_max(lane < kWarps ? warp_key[slot][lane] : 0);
      const float* p = spos + 3 * key_index(top);
      lx = p[0];
      ly = p[1];
      lz = p[2];
    } else {
      if (warp == 0) {
        key = warp_max(lane < kWarps ? warp_key[slot][lane] : 0);
        if (lane < S) {  // lane r sends the winner to block r
          float4 pos = make_float4(0.f, 0.f, 0.f, 0.f);
          if (key != 0) {
            const float* p = spos + 3 * (key_index(key) - lo);
            pos = make_float4(p[0], p[1], p[2], 0.f);
          }
          const unsigned there = address_in_block(mbarrier, lane);
          store_async(address_in_block(shared_address(&win_key[slot][rank]), lane),
                      key, there);
          store_async(address_in_block(shared_address(&win_pos[slot][rank]), lane),
                      pos, there);
        }
      }
      // the slot's mbarrier is in its ((j - 1) / 2)-th phase
      mbarrier_wait(mbarrier, ((j - 1) >> 1) & 1);
      // every warp for itself: no block-wide barrier before the next sweep
      const Key mine = lane < S ? win_key[slot][lane] : 0;
      top = warp_max(mine);
      // keys of points differ in their index bits: one lane holds the winner
      const int src = __ffs(__ballot_sync(kFull, mine == top)) - 1;
      const float4 pos = win_pos[slot][src];
      lx = pos.x;
      ly = pos.y;
      lz = pos.z;
    }
    if (rank == 0 && tid == 0) out[j] = key_index(top);
  }
  // no block leaves while stores to it may be on their way
  if constexpr (S > 1) cg::this_cluster().sync();
}

using Kernel = void (*)(const float*, int, int, int, int*);

// The kernel for `per_block` points a block: a thread keeps the fewest of
// 1, 2, 3, 4, 6, 8, 12, 16, 20 points that holds them; null beyond 512 x 20.
template <int S>
Kernel kernel_for(int per_block) {
  const int ppt = (per_block + kThreads - 1) / kThreads;
  if (ppt <= 1) return fps_cluster_kernel<S, 1>;
  if (ppt <= 2) return fps_cluster_kernel<S, 2>;
  if (ppt <= 3) return fps_cluster_kernel<S, 3>;
  if (ppt <= 4) return fps_cluster_kernel<S, 4>;
  if (ppt <= 6) return fps_cluster_kernel<S, 6>;
  if (ppt <= 8) return fps_cluster_kernel<S, 8>;
  if (ppt <= 12) return fps_cluster_kernel<S, 12>;
  if (ppt <= 16) return fps_cluster_kernel<S, 16>;
  if (ppt <= kMaxThreadPoints) return fps_cluster_kernel<S, kMaxThreadPoints>;
  return nullptr;
}

template <int S>
cudaError_t configure(Kernel kernel, int per_block, int clouds,
                      cudaStream_t stream, cudaLaunchConfig_t* config,
                      cudaLaunchAttribute* attribute) {
  const int smem = per_block * 3 * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  if (S > 8) {  // 16 blocks: the non-portable cluster size
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  attribute->id = cudaLaunchAttributeClusterDimension;
  attribute->val.clusterDim.x = S;
  attribute->val.clusterDim.y = 1;
  attribute->val.clusterDim.z = 1;
  *config = cudaLaunchConfig_t{};
  config->gridDim = dim3(S * clouds);
  config->blockDim = dim3(kThreads);
  config->dynamicSmemBytes = smem;
  config->stream = stream;
  config->attrs = attribute;
  config->numAttrs = S > 1 ? 1 : 0;  // S = 1: a plain launch, no cluster
  return cudaSuccess;
}

// b clouds of n points, one cluster of S blocks each, in one launch;
// cudaErrorInvalidValue where n exceeds S x 512 x 20.
template <int S>
cudaError_t launch(const float* xyz, int* out, int b, int n, int npoint,
                   cudaStream_t stream) {
  if (b < 1 || n < 1 || npoint < 1 || npoint > n) return cudaErrorInvalidValue;
  const int per_block = (n + S - 1) / S;
  const Kernel kernel = kernel_for<S>(per_block);
  if (kernel == nullptr) return cudaErrorInvalidValue;
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attribute;
  cudaError_t err = configure<S>(kernel, per_block, b, stream, &config, &attribute);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&config, kernel, xyz, n, npoint, per_block, out);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// How many clusters of S blocks (of the most points a block takes) the
// current device holds at once: 0 where it holds none; a negative number is
// minus a CUDA error code.
template <int S>
int clusters() {
  const int per_block = kThreads * kMaxThreadPoints;
  const Kernel kernel = kernel_for<S>(per_block);
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attribute;
  cudaError_t err = configure<S>(kernel, per_block, 1, nullptr, &config,
                                 &attribute);
  if (err != cudaSuccess) return -static_cast<int>(err);
  if (S == 1) {  // blocks a multiprocessor, times the multiprocessors
    int device = 0, sms = 0, blocks = 0;
    err = cudaGetDevice(&device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, kernel, kThreads, config.dynamicSmemBytes);
    if (err != cudaSuccess) return -static_cast<int>(err);
    return blocks * sms;
  }
  int count = 0;
  err = cudaOccupancyMaxActiveClusters(&count, kernel, &config);
  if (err != cudaSuccess) {
    cudaGetLastError();  // an unsupported cluster size is an answer: none
    return 0;
  }
  return count;
}

}  // namespace fps_cluster
}  // namespace
