// Furthest point sampling of one large cloud that reads only the chunks a
// pick can change.
//
// Replaces amcontrast3d_tpu/ops/fps_pallas.py::_fps_kernel_pruned (entry
// _fps_b1_pruned), the TPU kernel a B == 1 cloud of 262144 points or more
// reaches: the whole-scene test's subclouds from the 311296 bucket up.
// Semantics are those of fps_b1.cu and of the plain PyTorch twin in
// ops/fps.py, and the picks are the same: the first pick is index 0, the
// min-distance buffer starts at 1e10, each step takes the argmax with ties
// to the lowest index, d^2 = (dx*dx + dy*dy) + dz*dz rounded op by op.
//
// What bounds it on the card: the npoint - 1 picks depend on each other,
// and each needs the argmax over the whole cloud, so the time is picks x
// (one pass over what the pick can change + one reduction across the
// cluster).  Once a few hundred points are picked, a new pick lowers the
// min-distance of only the points around it; a dense sweep (fps_b1.cu's
// grid kernel) still reads all N points and meets across all blocks of the
// card, 2-3 us a pick.
//
// Design.  ops/spatial.py sorts the cloud along a Morton curve into chunks
// of 64 points with exact boxes (chunks.cuh); each point keeps its original
// index in the w of its float4.  One thread-block cluster of 16 blocks of
// 512 threads owns the cloud, a block a contiguous range of chunks.  Every
// chunk has an owner lane, which keeps in registers the chunk's box and its
// key: the largest (min-distance, ~original index) key of its points, and
// the position of that point (adjacent chunks go to different warps, so
// the few chunks around a pick are visited in parallel).  Per pick a lane
// tests its chunks' boxes against the pick; a chunk whose lower bound is
// not below its largest min-distance is skipped: every d^2 in it is then at
// least that value, so no min-distance in it can fall (chunks.cuh: the
// bound as computed is never above a point's d^2 as computed, no slack).
// The warp visits the other chunks one after the other, a lane two points
// each: the min-distances in device memory (L2-resident) are lowered, and
// the chunk's key is taken again.  Keys then meet as in fps_b1.cu's cluster
// kernel: the block's largest through its warps, and the 16 blocks'
// through st.async onto each block's mbarrier, one wait a pick.  The
// positions of the cloud never pass through a register more than the
// visits need, so the cloud's size is bounded by the chunks a lane keeps
// (4): 16 x 512 x 4 chunks of 64 points, 2 M points.  Ties (a padded
// subcloud repeats real points) go to the lowest original index because
// whole keys are compared everywhere, and the first pick is original
// index 0 wherever the sort put it.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "chunks.cuh"
#include "cluster.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace amc3d;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocks = 16;        // the cluster (the non-portable size)
constexpr int kMaxLaneChunks = 4;  // chunks a lane owns
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kWinnerBytes = sizeof(Key) + sizeof(float4);

// Lower the min-distances of chunk c against the pick (lx, ly, lz), or with
// `init` set them to 1e10, and return the chunk's largest key; its point's
// position goes to `pos`.  Called by the whole warp for one chunk.
__device__ __forceinline__ Key visit(const float4* __restrict__ pts,
                                     float* __restrict__ mind, int n, int c,
                                     float lx, float ly, float lz, bool init,
                                     int lane, float3& pos) {
  const int base = c * kChunk;
  const int len = min(kChunk, n - base);
  Key key = 0;
  float px = 0.f, py = 0.f, pz = 0.f;
#pragma unroll
  for (int h = 0; h < kChunk / 32; ++h) {
    const int u = lane + 32 * h;  // a lane always handles the same points
    if (u < len) {
      const float4 p = pts[base + u];
      const float m = init ? 1e10f
                           : fminf(mind[base + u],
                                   point_d2(p.x, p.y, p.z, lx, ly, lz));
      mind[base + u] = m;
      const Key k = make_key(m, __float_as_int(p.w));
      if (k > key) {
        key = k;
        px = p.x;
        py = p.y;
        pz = p.z;
      }
    }
  }
  const Key top = warp_max(key);
  const int src = __ffs(__ballot_sync(kFull, key == top)) - 1;
  pos = make_float3(__shfl_sync(kFull, px, src), __shfl_sync(kFull, py, src),
                    __shfl_sync(kFull, pz, src));
  return top;
}

// R: chunks a lane owns.  Local chunk l of a block sits in warp l % 16,
// lane (l / 16) % 32, register l / 512.
template <int R>
__global__ void __launch_bounds__(kThreads, 1)
fps_pruned_kernel(const float4* __restrict__ pts, const float* __restrict__ boxes,
                  const float* __restrict__ first, float* __restrict__ mind,
                  int n, int npoint, int per_block, int* __restrict__ out,
                  unsigned long long* __restrict__ visits) {
  __shared__ Key warp_key[kWarps];
  __shared__ float4 warp_pos[kWarps];
  // per parity of the pick, the 16 blocks' winners: key, and x, y, z
  __shared__ __align__(16) Key win_key[2][kBlocks];
  __shared__ __align__(16) float4 win_pos[2][kBlocks];
  __shared__ __align__(8) unsigned long long arrived[2];  // mbarriers

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nc = (n + kChunk - 1) / kChunk;
  const int c0 = rank * per_block;

  float box[R][6];
  Key ckey[R];
  float3 cpos[R];
  bool valid[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int l = warp + kWarps * lane + kThreads * r;
    valid[r] = l < per_block && c0 + l < nc;
    ckey[r] = 0;
    cpos[r] = make_float3(0.f, 0.f, 0.f);
#pragma unroll
    for (int e = 0; e < 6; ++e)
      box[r][e] = valid[r] ? boxes[static_cast<size_t>(c0 + l) * 6 + e] : 0.f;
  }
  unsigned long long visited = 0;  // chunk visits of this warp (lane 0)

  // every chunk's key at min-distance 1e10: its lowest original index
#pragma unroll
  for (int r = 0; r < R; ++r) {
    unsigned mask = __ballot_sync(kFull, valid[r]);
    while (mask) {
      const int src = __ffs(mask) - 1;
      mask &= mask - 1;
      float3 pos;
      const Key k = visit(pts, mind, n, c0 + warp + kWarps * src + kThreads * r,
                          0.f, 0.f, 0.f, true, lane, pos);
      if (lane == src) {
        ckey[r] = k;
        cpos[r] = pos;
      }
    }
  }
  float lx = first[0], ly = first[1], lz = first[2];
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
    if (tid == 0) mbarrier_expect(mbarrier, kBlocks * kWinnerBytes);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      // skipped unless the box may hold a point closer to the pick than its
      // min-distance (a chunk that holds no point has key 0: never visited)
      const bool need = valid[r] &&
                        box_lower_bound(lx, ly, lz, box[r]) < key_value(ckey[r]);
      unsigned mask = __ballot_sync(kFull, need);
      while (mask) {
        const int src = __ffs(mask) - 1;
        mask &= mask - 1;
        float3 pos;
        const Key k = visit(pts, mind, n,
                            c0 + warp + kWarps * src + kThreads * r, lx, ly,
                            lz, false, lane, pos);
        ++visited;
        if (lane == src) {
          ckey[r] = k;
          cpos[r] = pos;
        }
      }
    }
    Key best = 0;
    float3 bpos = make_float3(0.f, 0.f, 0.f);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (ckey[r] > best) {
        best = ckey[r];
        bpos = cpos[r];
      }
    }
    Key top = warp_max(best);
    int src = __ffs(__ballot_sync(kFull, best == top)) - 1;
    const float wx = __shfl_sync(kFull, bpos.x, src);
    const float wy = __shfl_sync(kFull, bpos.y, src);
    const float wz = __shfl_sync(kFull, bpos.z, src);
    if (lane == 0) {
      warp_key[warp] = top;
      warp_pos[warp] = make_float4(wx, wy, wz, 0.f);
    }
    __syncthreads();
    if (warp == 0) {
      const Key mine = lane < kWarps ? warp_key[lane] : 0;
      top = warp_max(mine);
      src = __ffs(__ballot_sync(kFull, mine == top)) - 1;
      if (lane < kBlocks) {  // lane r sends the winner to block r
        const unsigned there = address_in_block(mbarrier, lane);
        store_async(address_in_block(shared_address(&win_key[slot][rank]), lane),
                    top, there);
        store_async(address_in_block(shared_address(&win_pos[slot][rank]), lane),
                    warp_pos[src], there);
      }
    }
    // the slot's mbarrier is in its ((j - 1) / 2)-th phase
    mbarrier_wait(mbarrier, ((j - 1) >> 1) & 1);
    // every warp for itself: no block-wide barrier before the next pick
    const Key mine = lane < kBlocks ? win_key[slot][lane] : 0;
    top = warp_max(mine);
    // keys of points differ in their index bits: one lane holds the winner
    src = __ffs(__ballot_sync(kFull, mine == top)) - 1;
    const float4 pos = win_pos[slot][src];
    lx = pos.x;
    ly = pos.y;
    lz = pos.z;
    if (rank == 0 && tid == 0) out[j] = key_index(top);
  }
  if (visits != nullptr && lane == 0) atomicAdd(visits, visited);
  cluster.sync();  // no block leaves while stores to it may be on their way
}

using Kernel = void (*)(const float4*, const float*, const float*, float*, int,
                        int, int, int*, unsigned long long*);

Kernel kernel_for(int per_block) {
  switch ((per_block + kThreads - 1) / kThreads) {
    case 0:
    case 1: return fps_pruned_kernel<1>;
    case 2: return fps_pruned_kernel<2>;
    case 3:
    case 4: return fps_pruned_kernel<kMaxLaneChunks>;
    default: return nullptr;
  }
}

}  // namespace

// pts (n) float4: the cloud sorted along a Morton curve, the original index
// in w; boxes (ceil(n / 64), 6) float32; first: x, y, z of original point 0;
// mind (n) float32 scratch -> out (npoint) int32 original indices; visits
// (one uint64, the caller zeroes it, or null) gains the chunk visits.
// Returns cudaErrorInvalidValue beyond 16 x 512 x 4 chunks.
extern "C" int amc3d_fps_pruned(const void* pts, const void* boxes,
                                const void* first, void* mind, void* out,
                                void* visits, int n, int npoint, void* stream) {
  const int nc = (n + kChunk - 1) / kChunk;
  const int per_block = (nc + kBlocks - 1) / kBlocks;
  const Kernel kernel = kernel_for(per_block);
  if (n < 1 || kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attribute;
  attribute.id = cudaLaunchAttributeClusterDimension;
  attribute.val.clusterDim.x = kBlocks;
  attribute.val.clusterDim.y = 1;
  attribute.val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(kBlocks);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = 0;
  config.stream = static_cast<cudaStream_t>(stream);
  config.attrs = &attribute;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, kernel, static_cast<const float4*>(pts),
                           static_cast<const float*>(boxes),
                           static_cast<const float*>(first),
                           static_cast<float*>(mind), n, npoint, per_block,
                           static_cast<int*>(out),
                           static_cast<unsigned long long*>(visits));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
