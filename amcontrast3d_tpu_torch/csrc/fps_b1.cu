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
// The cluster kernel (a cloud of at most 16 x 512 x 20 = 163840 points:
// every voxel-rank subcloud of a room up to the 155648 bucket) leaves
// device memory out of the loop: one thread-block cluster of 16 blocks (the
// non-portable size; 8 is the portable one) of 512 threads.  A thread
// keeps its points (up to 20: x, y, z, min-distance) in registers, since
// on 16 multiprocessors a sweep through shared memory is bound by its
// bandwidth (16 bytes a point and pick); shared memory holds a copy of the
// positions for looking up the winner's.  16 lanes of a block's first warp
// send the block's key and its winner's position into a slot of every
// block's shared memory with st.async, which counts the bytes in on the
// receiving block's mbarrier; a block waits on its own mbarrier only (one
// trip through the cluster's network a pick, where cluster.sync() takes
// three times as long, PERF.md), and every warp then takes the largest of
// the 16 keys its block holds.  Slots and mbarriers are double-buffered by
// the pick's parity: a block can send pick j + 2 only after it has every
// block's pick j + 1, which each block sends after its reads of pick j.
// ops/fps.py asks amc3d_fps_b1_clusters whether the card can hold such a
// cluster and sends the cloud to the grid kernel where it cannot.
// The cluster kernel also takes a batch, one cluster a cloud (the clouds
// share nothing, so clusters beyond those the card holds at once simply run
// later): that is where a batch goes whose clouds are too large for the
// shared-memory min-distance buffer of fps.cu (B > 1, N > 57344: the first
// stage of the ScanNet recipe, 2 x 64000 -> 16000).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "cluster.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace amc3d;

constexpr int kThreads = 512;  // the grid kernel's block
constexpr int kWarps = kThreads / 32;
constexpr int kClusterBlocks = 16;
constexpr int kClusterThreads = 512;
constexpr int kClusterWarps = kClusterThreads / 32;
constexpr int kMaxThreadPoints = 20;  // of the cluster kernel, in registers
// what a block sends to each block a pick: a key and a float4
constexpr unsigned kWinnerBytes = sizeof(unsigned long long) + sizeof(float4);
constexpr int kMaxBlockPoints = 14336;  // 16 B each: 224 KB of shared memory
constexpr int kMinBlockPoints = 1024;
constexpr unsigned kFull = 0xffffffffu;

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

// PPT: points a thread keeps; thread t of a block holds the points
// lo + t + 512 r of the cloud, r < PPT, so within a thread r runs in index
// order and the first maximum met is the one with the lowest index.
template <int PPT>
__global__ void __launch_bounds__(kClusterThreads, 1)
fps_b1_cluster_kernel(const float* __restrict__ xyz, int n, int npoint,
                      int per_block, int* __restrict__ out) {
  extern __shared__ float spos[];  // x, y, z of the block's points
  // one cluster a cloud: cluster c of the grid samples cloud c
  const size_t cloud = blockIdx.x / kClusterBlocks;
  xyz += cloud * n * 3;
  out += cloud * npoint;
  __shared__ Key warp_key[kClusterWarps];
  // per parity of the pick, the 16 blocks' winners: key, and x, y, z
  __shared__ __align__(16) Key win_key[2][kClusterBlocks];
  __shared__ __align__(16) float4 win_pos[2][kClusterBlocks];
  __shared__ __align__(8) unsigned long long arrived[2];  // mbarriers

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lo = min(n, rank * per_block);
  const int cnt = min(n, lo + per_block) - lo;
  float px[PPT], py[PPT], pz[PPT], mind[PPT];
#pragma unroll
  for (int r = 0; r < PPT; ++r) {
    const int i = tid + kClusterThreads * r;
    px[r] = py[r] = pz[r] = 0.f;
    mind[r] = -1.f;  // no point: below every min-distance, never a maximum
    if (i < cnt) {
      const float* p = xyz + static_cast<size_t>(lo + i) * 3;
      px[r] = spos[3 * i] = p[0];
      py[r] = spos[3 * i + 1] = p[1];
      pz[r] = spos[3 * i + 2] = p[2];
      mind[r] = 1e10f;
    }
  }
  float lx = xyz[0], ly = xyz[1], lz = xyz[2];
  if (rank == 0 && tid == 0) out[0] = 0;
  if (tid == 0) {
    mbarrier_init(shared_address(&arrived[0]));
    mbarrier_init(shared_address(&arrived[1]));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // every block runs, with its mbarriers set up, before any block sends
  cluster.sync();

  for (int j = 1; j < npoint; ++j) {
    const int slot = j & 1;
    const unsigned mbarrier = shared_address(&arrived[slot]);
    if (tid == 0) mbarrier_expect(mbarrier, kClusterBlocks * kWinnerBytes);
    float best = -1.f;
    int best_r = 0;
#pragma unroll
    for (int r = 0; r < PPT; ++r) {
      const float dx = __fsub_rn(px[r], lx);
      const float dy = __fsub_rn(py[r], ly);
      const float dz = __fsub_rn(pz[r], lz);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                __fmul_rn(dz, dz));
      mind[r] = fminf(mind[r], d);
      if (mind[r] > best) {
        best = mind[r];
        best_r = r;
      }
    }
    Key key = best >= 0.f
                  ? make_key(best, lo + tid + kClusterThreads * best_r) : 0;
    key = warp_max(key);
    if (lane == 0) warp_key[warp] = key;
    __syncthreads();
    if (warp == 0) {
      key = warp_max(lane < kClusterWarps ? warp_key[lane] : 0);
      if (lane < kClusterBlocks) {  // lane r sends the winner to block r
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
    const Key mine = lane < kClusterBlocks ? win_key[slot][lane] : 0;
    const Key top = warp_max(mine);
    // keys of points differ in their index bits: one lane holds the winner
    const int src = __ffs(__ballot_sync(kFull, mine == top)) - 1;
    const float4 pos = win_pos[slot][src];
    lx = pos.x;
    ly = pos.y;
    lz = pos.z;
    if (rank == 0 && tid == 0) out[j] = key_index(top);
  }
  cluster.sync();  // no block leaves while stores to it may be on their way
}

// The cluster kernel for `per_block` points a block (a thread's points in
// steps of 4), or null beyond 512 x 20.
using ClusterKernel = void (*)(const float*, int, int, int, int*);

ClusterKernel cluster_kernel(int per_block) {
  switch ((per_block + kClusterThreads * 4 - 1) / (kClusterThreads * 4)) {
    case 0:
    case 1: return fps_b1_cluster_kernel<4>;
    case 2: return fps_b1_cluster_kernel<8>;
    case 3: return fps_b1_cluster_kernel<12>;
    case 4: return fps_b1_cluster_kernel<16>;
    case 5: return fps_b1_cluster_kernel<kMaxThreadPoints>;
    default: return nullptr;
  }
}

cudaError_t cluster_config(ClusterKernel kernel, int per_block, int clouds,
                           cudaStream_t stream, cudaLaunchConfig_t* config,
                           cudaLaunchAttribute* attribute) {
  const int smem = per_block * 3 * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  attribute->id = cudaLaunchAttributeClusterDimension;
  attribute->val.clusterDim.x = kClusterBlocks;
  attribute->val.clusterDim.y = 1;
  attribute->val.clusterDim.z = 1;
  *config = cudaLaunchConfig_t{};
  config->gridDim = dim3(kClusterBlocks * clouds);
  config->blockDim = dim3(kClusterThreads);
  config->dynamicSmemBytes = smem;
  config->stream = stream;
  config->attrs = attribute;
  config->numAttrs = 1;
  return cudaSuccess;
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

// xyz (b, n, 3) float32 -> out (b, npoint) int32 through the cluster kernel,
// one cluster a cloud; n <= 16 x 512 x 20, else cudaErrorInvalidValue.
extern "C" int amc3d_fps_b1_cluster(const void* xyz, void* out, int b, int n,
                                    int npoint, void* stream) {
  if (b < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int per_block = (n + kClusterBlocks - 1) / kClusterBlocks;
  const ClusterKernel kernel = cluster_kernel(per_block);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attribute;
  cudaError_t err = cluster_config(kernel, per_block, b,
                                   static_cast<cudaStream_t>(stream), &config,
                                   &attribute);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaLaunchKernelEx(&config, kernel, static_cast<const float*>(xyz), n,
                           npoint, per_block, static_cast<int*>(out));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// How many of the cluster kernel's clusters the current device can hold at
// once with the most points a block takes (0: none, every cloud goes to the
// grid kernel); a negative number is minus a CUDA error code.
extern "C" int amc3d_fps_b1_clusters() {
  const int per_block = kClusterThreads * kMaxThreadPoints;
  const ClusterKernel kernel = cluster_kernel(per_block);
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attribute;
  cudaError_t err = cluster_config(kernel, per_block, 1, nullptr, &config,
                                   &attribute);
  if (err != cudaSuccess) return -static_cast<int>(err);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &config);
  if (err != cudaSuccess) {
    cudaGetLastError();  // an unsupported cluster size is an answer: none
    return 0;
  }
  return clusters;
}
