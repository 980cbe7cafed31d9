// Furthest point sampling of one large cloud that reads only the chunks a
// pick can change.
//
// Replaces amcontrast3d_tpu/ops/fps_pallas.py::_fps_kernel_pruned (entry
// _fps_b1_pruned) and, where ops/fps.py::fps_is_pruned sends a whole-room
// stage here, _fps_kernel_r8 (entry _fps_b1): the TPU kernels a B == 1
// cloud reaches; here every whole-room stage above what one cluster of
// fps_cluster.cuh holds (163840 points), and any cloud above what fps.cu's
// grid kernel holds (1.89 M points on 132 multiprocessors).  Semantics are those of fps.cu
// and of the plain PyTorch twin in ops/fps.py, and the picks are the same:
// the first pick is index 0, the min-distance buffer starts at 1e10, each
// step takes the argmax with ties to the lowest index, d^2 = (dx*dx +
// dy*dy) + dz*dz rounded op by op.
//
// What bounds it on the card: the npoint - 1 picks depend on each other,
// and each needs the argmax over the whole cloud, so the time is picks x
// (one pass over what the pick can change + one reduction across the
// cluster).  Once a few hundred points are picked, a new pick lowers the
// min-distance of only the points around it; a dense sweep (fps.cu's
// grid kernel) still reads all N points and meets across all blocks of the
// card, 2-3 us a pick.  One block alone would spare the cluster's exchange
// (~0.6 us a pick), but every one-block design tried costs more a pick
// than it spares (PERF.md §6; tools/fps_handover.cu).
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
// The warp visits the other chunks four at a time, lane l taking points l
// and l + 32 of each, every load of the four in flight before the first is
// used (the first picks visit most chunks): the min-distances in device
// memory (L2-resident) are lowered, and each chunk's key is taken again.
// Keys then meet as in fps_cluster.cuh (S > 1): the block's largest
// through its warps, and the 16 blocks' through st.async onto each block's
// mbarrier, one wait a pick.  The positions of the cloud never pass through
// a register more than the visits need, so the cloud's size is bounded by
// the chunks a lane keeps (4): 16 x 512 x 4 chunks of 64 points, 2 M
// points.  Ties (a padded subcloud repeats real points) go to the lowest
// original index because whole keys are compared everywhere, and the first
// pick is original index 0 wherever the sort put it.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "chunks.cuh"
#include "cluster.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace amc3d;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kBatch = 4;          // chunks a warp visits at once
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocks = 16;        // the cluster (the non-portable size)
constexpr int kMaxLaneChunks = 4;  // chunks a lane owns
constexpr unsigned kWinnerBytes = sizeof(Key) + sizeof(float4);

// Lower the min-distances of the chunks cs[0, cnt) (cnt <= K, the same on
// every lane) against the pick (lx, ly, lz), or with `init` set them to
// 1e10; key[a] and pos[a] become chunk cs[a]'s largest key and its point's
// position, on every lane.  Called by the whole warp: lane l takes points l
// and l + 32 of each chunk, every load of the K chunks in flight before the
// first is used.
template <int K>
__device__ __forceinline__ void visit(const float4* __restrict__ pts,
                                      float* __restrict__ mind, int n,
                                      const int (&cs)[kBatch], int cnt,
                                      float lx, float ly, float lz, bool init,
                                      int lane, Key (&key)[kBatch],
                                      float3 (&pos)[kBatch]) {
  float4 p[K][2];
  float m[K][2];
#pragma unroll
  for (int a = 0; a < K; ++a) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = cs[a] * kChunk + lane + 32 * h;
      const bool ok = a < cnt && i < n;
      p[a][h] = ok ? __ldg(pts + i) : make_float4(0.f, 0.f, 0.f, 0.f);
      m[a][h] = ok && !init ? mind[i] : 1e10f;
    }
  }
#pragma unroll
  for (int a = 0; a < K; ++a) {
    if (a >= cnt) break;
    Key best = 0;
    float px = 0.f, py = 0.f, pz = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = cs[a] * kChunk + lane + 32 * h;
      if (i < n) {
        const float4 q = p[a][h];
        const float v =
            init ? 1e10f : fminf(m[a][h], point_d2(q.x, q.y, q.z, lx, ly, lz));
        mind[i] = v;
        const Key k = make_key(v, __float_as_int(q.w));
        if (k > best) {
          best = k;
          px = q.x;
          py = q.y;
          pz = q.z;
        }
      }
    }
    const Key top = warp_max(best);
    const int src = __ffs(__ballot_sync(kFull, best == top)) - 1;
    key[a] = top;
    pos[a] = make_float3(__shfl_sync(kFull, px, src),
                         __shfl_sync(kFull, py, src),
                         __shfl_sync(kFull, pz, src));
  }
}

// Visit the chunks whose owner lanes are set in `mask` (chunk(lane) maps a
// lane to its chunk), up to kBatch at a time (one alone where one is left:
// a late pick's warp has one chunk or none to visit, and the batch's code
// would only slow it); each owner lane gets its chunk's key and position.
// Returns the number of chunks visited.
template <typename ChunkOf>
__device__ __forceinline__ int visit_owned(const float4* __restrict__ pts,
                                           float* __restrict__ mind, int n,
                                           unsigned mask, ChunkOf chunk,
                                           float lx, float ly, float lz,
                                           bool init, int lane, Key& key,
                                           float3& pos) {
  const int count = __popc(mask);
  while (mask) {
    int cs[kBatch], owner[kBatch];
    int cnt = 0;
#pragma unroll
    for (int a = 0; a < kBatch; ++a) {
      owner[a] = -1;
      cs[a] = 0;
      if (mask) {
        owner[a] = __ffs(mask) - 1;
        mask &= mask - 1;
        cs[a] = chunk(owner[a]);
        cnt = a + 1;
      }
    }
    Key k[kBatch];
    float3 q[kBatch];
    if (cnt == 1)
      visit<1>(pts, mind, n, cs, cnt, lx, ly, lz, init, lane, k, q);
    else
      visit<kBatch>(pts, mind, n, cs, cnt, lx, ly, lz, init, lane, k, q);
#pragma unroll
    for (int a = 0; a < kBatch; ++a) {
      if (lane == owner[a]) {
        key = k[a];
        pos = q[a];
      }
    }
  }
  return count;
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
    visit_owned(pts, mind, n, __ballot_sync(kFull, valid[r]),
                [&](int src) { return c0 + warp + kWarps * src + kThreads * r; },
                0.f, 0.f, 0.f, true, lane, ckey[r], cpos[r]);
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
      visited += visit_owned(
          pts, mind, n, __ballot_sync(kFull, need),
          [&](int src) { return c0 + warp + kWarps * src + kThreads * r; },
          lx, ly, lz, false, lane, ckey[r], cpos[r]);
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
  if (n < 1 || npoint < 1 || npoint > n || kernel == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
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
