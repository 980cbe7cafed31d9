// A whole-room FPS whose late picks run in one block: the chunk-pruned
// kernel of csrc/fps_pruned.cu for the first picks, then one block of 512
// threads that holds every chunk's state, handed over on the device.  A
// measurement tool, not a path of the package: on the H100 its late picks
// cost more than the 16-block cluster's (PERF.md §6), so ops/fps.py does
// not launch it.  tools/fps_handover.py builds it and times it beside the
// shipped kernels (tools/profile_room_fps.py --handover); its picks are
// those of every FPS kernel of the port and of the plain PyTorch twin in
// ops/fps.py: the first pick is index 0, the min-distance buffer starts at
// 1e10, each step takes the argmax with ties to the lowest index, d^2 =
// (dx*dx + dy*dy) + dz*dz rounded op by op.
//
// The idea.  Once a few hundred points are picked, a pick lowers the
// min-distance of only the points around it: a few chunks of 64 points.
// Spread over a cluster of 16 multiprocessors, the reduction across them
// (one exchange through distributed shared memory, ~0.6 us) is then half
// of every pick; on one multiprocessor it is a block barrier.
//
// Layout, as in fps_pruned.cu.  ops/spatial.py sorts the cloud along a
// Morton curve into chunks of 64 points with exact boxes (chunks.cuh); each
// point keeps its original index in the w of its float4.  A chunk's key is
// the largest (min-distance, ~original index) key of its points
// (cluster.cuh), with that point's position beside it.  A chunk whose box
// lower bound is not below its largest min-distance is skipped.
// Min-distances live in device memory (L2-resident).
//
// The wide kernel (picks 1 to J) is fps_pruned.cu's, with one addition:
// with each block's winner goes the block's count of chunk visits of the
// pick, so every block sees the same total.  When a pick has visited fewer
// than `handover` chunks, all stop after it, write their chunk keys and
// winners' positions to device memory, and block 0 writes J + 1, the next
// pick.  `handover` 0 runs every pick there.
//
// The narrow kernel (picks J + 1 on): one block of 512 threads reads J + 1
// and the handed-over state (stream order: no host sync), and keeps every
// chunk's box, key and winner's position in shared memory, 44 bytes a
// chunk (kMaxChunks of them: 327680 points; the wrapper runs a larger
// cloud with `handover` 0).  Chunks go in groups of 32 consecutive ones;
// group g belongs to warp g % 16, whose lane g / 16 keeps the group's box
// (the union of its chunks') and key value in registers, and each group's
// exact key sits in shared memory.  A pick, two block barriers: 1. each
// warp tests its groups' boxes, and for each group that passes its 32
// chunks, one a lane, and lists those that pass; | 2. entry k of warp w's
// list goes to warp (w + k) % 16, so the few chunks around a pick, which
// one group lists, are visited by as many warps at once, and their keys
// go back to shared memory; | 3. every warp takes the passed groups' keys
// again and the largest key of all groups, so every warp has the pick
// without another barrier (the owners write the passed groups' keys,
// which no warp reads in that pick).  A list that would spill makes every
// warp visit its own groups' chunks that pick instead.  A chunk may be
// visited by different warps in successive picks: the block barriers
// order its min-distance writes before the next reads.
//
// Ties (a padded subcloud repeats real points) go to the lowest original
// index because whole keys are compared everywhere, across the handover
// too, and the first pick is original index 0 wherever the sort put it.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "chunks.cuh"
#include "cluster.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace amc3d;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kBatch = 4;          // chunks a warp visits at once
constexpr int kThreads = 512;      // both kernels' blocks
constexpr int kWarps = kThreads / 32;
// the wide kernel
constexpr int kBlocks = 16;        // the cluster (the non-portable size)
constexpr int kMaxLaneChunks = 4;  // chunks a lane owns
constexpr unsigned kWinnerBytes = sizeof(Key) + sizeof(float4);
// the narrow kernel
constexpr int kGroup = 32;         // chunks a group
constexpr int kWarpList = 32;      // chunks a warp lists a pick
constexpr int kChunkBytes = sizeof(Key) + 9 * sizeof(float);  // key, box, pos
constexpr int kMaxChunks = 5120;   // 225280 bytes of shared memory
constexpr int kMaxGroups = kMaxChunks / kGroup;

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
fps_wide_kernel(const float4* __restrict__ pts, const float* __restrict__ boxes,
                const float* __restrict__ first, float* __restrict__ mind,
                int n, int npoint, int per_block, int handover,
                int* __restrict__ out, Key* __restrict__ hkey,
                float4* __restrict__ hpos, int* __restrict__ hnext,
                unsigned long long* __restrict__ visits) {
  __shared__ Key warp_key[kWarps];
  __shared__ float4 warp_pos[kWarps];
  __shared__ int warp_visits[kWarps];
  // per parity of the pick, the 16 blocks' winners: key, and x, y, z and
  // the block's chunk visits of the pick (as int bits)
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

  int j = 1;
  for (; j < npoint; ++j) {
    const int slot = j & 1;
    const unsigned mbarrier = shared_address(&arrived[slot]);
    if (tid == 0) mbarrier_expect(mbarrier, kBlocks * kWinnerBytes);
    int pick_visits = 0;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      // skipped unless the box may hold a point closer to the pick than its
      // min-distance (a chunk that holds no point has key 0: never visited)
      const bool need = valid[r] &&
                        box_lower_bound(lx, ly, lz, box[r]) < key_value(ckey[r]);
      pick_visits += visit_owned(
          pts, mind, n, __ballot_sync(kFull, need),
          [&](int src) { return c0 + warp + kWarps * src + kThreads * r; },
          lx, ly, lz, false, lane, ckey[r], cpos[r]);
    }
    visited += pick_visits;
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
      warp_visits[warp] = pick_visits;
    }
    __syncthreads();
    if (warp == 0) {
      const Key mine = lane < kWarps ? warp_key[lane] : 0;
      top = warp_max(mine);
      src = __ffs(__ballot_sync(kFull, mine == top)) - 1;
      const int block_visits =
          __reduce_add_sync(kFull, lane < kWarps ? warp_visits[lane] : 0);
      float4 wpos = warp_pos[src];
      wpos.w = __int_as_float(block_visits);
      if (lane < kBlocks) {  // lane r sends the winner to block r
        const unsigned there = address_in_block(mbarrier, lane);
        store_async(address_in_block(shared_address(&win_key[slot][rank]), lane),
                    top, there);
        store_async(address_in_block(shared_address(&win_pos[slot][rank]), lane),
                    wpos, there);
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
    // every block sees the same total: all stop after the same pick
    const int total = __reduce_add_sync(
        kFull, lane < kBlocks ? __float_as_int(win_pos[slot][lane].w) : 0);
    if (total < handover) {
      ++j;
      break;
    }
  }
  if (handover > 0) {  // hand the chunks' state to the narrow kernel
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (valid[r]) {
        const int c = c0 + warp + kWarps * lane + kThreads * r;
        hkey[c] = ckey[r];
        hpos[c] = make_float4(cpos[r].x, cpos[r].y, cpos[r].z, 0.f);
      }
    }
    if (rank == 0 && tid == 0) *hnext = j;
  }
  if (visits != nullptr && lane == 0) atomicAdd(visits, visited);
  cluster.sync();  // no block leaves while stores to it may be on their way
}

__global__ void __launch_bounds__(kThreads, 1)
fps_narrow_kernel(const float4* __restrict__ pts, const float* __restrict__ boxes,
                  const float* __restrict__ xyz, float* __restrict__ mind,
                  const Key* __restrict__ hkey, const float4* __restrict__ hpos,
                  const int* __restrict__ hnext, int n, int npoint,
                  int* __restrict__ out, unsigned long long* __restrict__ visits) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Key group_key[kMaxGroups];   // each group's largest key
  __shared__ int group_win[kMaxGroups];   // and the chunk that holds it
  __shared__ int listed[kWarps][kWarpList];  // the chunks each warp lists
  __shared__ int counts[kWarps];
  __shared__ unsigned passed_at[2][kWarps];  // per parity: passed groups
  __shared__ int spilled[2];  // per parity: a warp listed more than it holds
  const int j0 = *hnext;
  if (j0 >= npoint) return;  // the wide kernel took every pick
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nc = (n + kChunk - 1) / kChunk;
  const int ng = (nc + kGroup - 1) / kGroup;
  // per chunk: key; lo x, y, z, hi x, y, z; the key's point x, y, z
  Key* ckey = reinterpret_cast<Key*>(smem);
  float* cbox = reinterpret_cast<float*>(ckey + nc);
  float* cpos = cbox + 6 * nc;
  for (int c = tid; c < nc; c += kThreads) {
    ckey[c] = hkey[c];
    const float4 q = hpos[c];
    cpos[c] = q.x;
    cpos[nc + c] = q.y;
    cpos[2 * nc + c] = q.z;
#pragma unroll
    for (int e = 0; e < 6; ++e)
      cbox[e * nc + c] = boxes[static_cast<size_t>(c) * 6 + e];
  }
  if (tid < 2) spilled[tid] = 0;
  __syncthreads();

  // group g (chunks 32 g to 32 g + 31) belongs to warp g % 16, whose lane
  // g / 16 keeps its box and the value of its key
  const int g = warp + kWarps * lane;
  float gbox[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float gval = 0.f;
  if (g < ng) {
    gbox[0] = gbox[1] = gbox[2] = __int_as_float(0x7f800000);   // +inf
    gbox[3] = gbox[4] = gbox[5] = __int_as_float(0xff800000);   // -inf
    Key top = 0;
    int win = g * kGroup;
    for (int c = g * kGroup; c < min(nc, (g + 1) * kGroup); ++c) {
#pragma unroll
      for (int e = 0; e < 3; ++e) {
        gbox[e] = fminf(gbox[e], cbox[e * nc + c]);
        gbox[3 + e] = fmaxf(gbox[3 + e], cbox[(3 + e) * nc + c]);
      }
      if (ckey[c] > top) {
        top = ckey[c];
        win = c;
      }
    }
    group_key[g] = top;
    group_win[g] = win;
    gval = key_value(top);
  }
  const int last = out[j0 - 1];
  float lx = xyz[3 * static_cast<size_t>(last)];
  float ly = xyz[3 * static_cast<size_t>(last) + 1];
  float lz = xyz[3 * static_cast<size_t>(last) + 2];
  unsigned long long visited = 0;  // chunk visits of this warp (lane 0)
  const unsigned below = (1u << lane) - 1;  // the lanes below this one
  __syncthreads();

  for (int j = j0; j < npoint; ++j) {
    const int parity = j & 1;
    // 1. each warp tests its groups, and in each that passes the 32 chunks,
    // and lists those that may hold a point closer to the pick than their
    // min-distance
    const unsigned passed = __ballot_sync(
        kFull, g < ng && box_lower_bound(lx, ly, lz, gbox) < gval);
    int count = 0;
    for (unsigned left = passed; left; left &= left - 1) {
      const int c = (warp + kWarps * (__ffs(left) - 1)) * kGroup + lane;
      bool need = false;
      if (c < nc) {
        const float box[6] = {cbox[c], cbox[nc + c], cbox[2 * nc + c],
                              cbox[3 * nc + c], cbox[4 * nc + c],
                              cbox[5 * nc + c]};
        need = box_lower_bound(lx, ly, lz, box) < key_value(ckey[c]);
      }
      const unsigned mask = __ballot_sync(kFull, need);
      const int at = count + __popc(mask & below);
      if (need && at < kWarpList) listed[warp][at] = c;
      count += __popc(mask);
    }
    if (lane == 0) {
      counts[warp] = min(count, kWarpList);
      passed_at[parity][warp] = passed;
      if (count > kWarpList) spilled[parity] = 1;
    }
    __syncthreads();
    // 2. the visits: entry k of warp w's list goes to warp (w + k) % 16, so
    // the chunks one group lists are visited by as many warps
    if (tid == 0) spilled[parity ^ 1] = 0;  // last read before the barrier
    if (!spilled[parity]) {
      const int from = lane % kWarps;
      const int have = counts[from];
      for (int k = (warp - from) & (kWarps - 1);; k += kWarps) {
        const bool mine = lane < kWarps && k < have;
        const int c = mine ? listed[from][k] : 0;
        const unsigned mask = __ballot_sync(kFull, mine);
        if (mask == 0) break;
        Key key = 0;
        float3 q;
        visited += visit_owned(
            pts, mind, n, mask, [&](int src) { return __shfl_sync(kFull, c, src); },
            lx, ly, lz, false, lane, key, q);
        if (mine) {
          ckey[c] = key;
          cpos[c] = q.x;
          cpos[nc + c] = q.y;
          cpos[2 * nc + c] = q.z;
        }
      }
    } else {  // some list spilled: each warp visits its own groups' chunks
      for (unsigned left = passed; left; left &= left - 1) {
        const int base = (warp + kWarps * (__ffs(left) - 1)) * kGroup;
        const int c = base + lane;
        bool need = false;
        if (c < nc) {
          const float box[6] = {cbox[c], cbox[nc + c], cbox[2 * nc + c],
                                cbox[3 * nc + c], cbox[4 * nc + c],
                                cbox[5 * nc + c]};
          need = box_lower_bound(lx, ly, lz, box) < key_value(ckey[c]);
        }
        Key key = 0;
        float3 q;
        visited += visit_owned(pts, mind, n, __ballot_sync(kFull, need),
                               [&](int src) { return base + src; }, lx, ly, lz,
                               false, lane, key, q);
        if (need) {
          ckey[c] = key;
          cpos[c] = q.x;
          cpos[nc + c] = q.y;
          cpos[2 * nc + c] = q.z;
        }
      }
    }
    __syncthreads();
    // 3. the pick, in every warp: the passed groups' keys taken again, the
    // other groups' as they are
    const unsigned word = lane < kWarps ? passed_at[parity][lane] : 0u;
    Key best = 0;
    int best_chunk = 0;
    for (unsigned owners = __ballot_sync(kFull, word != 0); owners;
         owners &= owners - 1) {
      const int w = __ffs(owners) - 1;
      for (unsigned left = __shfl_sync(kFull, word, w); left; left &= left - 1) {
        const int r = __ffs(left) - 1;
        const int gg = w + kWarps * r;
        const int c = gg * kGroup + lane;
        const Key k = c < nc ? ckey[c] : 0;
        const Key top = warp_max(k);
        const int win = gg * kGroup + __ffs(__ballot_sync(kFull, k == top)) - 1;
        if (top > best) {
          best = top;
          best_chunk = win;
        }
        if (warp == w) {  // the owner keeps the group's new key
          if (lane == r) gval = key_value(top);
          if (lane == 0) {
            group_key[gg] = top;
            group_win[gg] = win;
          }
        }
      }
    }
    Key mine = 0;
    int mine_chunk = 0;
    for (int g0 = 0; g0 < ng; g0 += 32) {
      // group g2 passed if bit g2 / 16 of warp g2 % 16's word is set
      const int g2 = g0 + lane;
      const unsigned w2 = __shfl_sync(kFull, word, g2 % kWarps);
      if (g2 < ng && ((w2 >> (g2 / kWarps)) & 1u) == 0 &&
          group_key[g2] > mine) {
        mine = group_key[g2];
        mine_chunk = group_win[g2];
      }
    }
    Key top = warp_max(mine);
    int win = __shfl_sync(kFull, mine_chunk,
                          __ffs(__ballot_sync(kFull, mine == top)) - 1);
    if (best > top) {
      top = best;
      win = best_chunk;
    }
    lx = cpos[win];
    ly = cpos[nc + win];
    lz = cpos[2 * nc + win];
    if (tid == 0) out[j] = key_index(top);
  }
  if (visits != nullptr && lane == 0) atomicAdd(visits, visited);
}

using WideKernel = void (*)(const float4*, const float*, const float*, float*,
                            int, int, int, int, int*, Key*, float4*, int*,
                            unsigned long long*);

WideKernel wide_kernel_for(int per_block) {
  switch ((per_block + kThreads - 1) / kThreads) {
    case 0:
    case 1: return fps_wide_kernel<1>;
    case 2: return fps_wide_kernel<2>;
    case 3:
    case 4: return fps_wide_kernel<kMaxLaneChunks>;
    default: return nullptr;
  }
}

}  // namespace

// pts (n) float4: the cloud sorted along a Morton curve, the original index
// in w; boxes (ceil(n / 64), 6) float32; xyz (n, 3) the cloud in its
// original order; mind (n) float32 scratch -> out (npoint) int32 original
// indices.  handover > 0: the wide kernel stops after the first pick that
// visits fewer chunks, and the narrow kernel, launched behind it, takes the
// rest; hkey (ceil(n / 64) uint64), hpos (ceil(n / 64) float4) and hnext
// (one int32: the first pick the narrow kernel takes) are then the scratch
// between them.  handover 0: the wide kernel takes every pick (the scratch
// may be null).  visits (one uint64, the caller zeroes it, or null) gains
// the chunk visits.  Returns cudaErrorInvalidValue beyond 16 x 512 x 4
// chunks, or with a handover beyond kMaxChunks.
extern "C" int amc3d_fps_handover(const void* pts, const void* boxes,
                                  const void* xyz, void* mind, void* hkey,
                                  void* hpos, void* hnext, void* out,
                                  void* visits, int n, int npoint,
                                  int handover, void* stream) {
  const int nc = (n + kChunk - 1) / kChunk;
  const int per_block = (nc + kBlocks - 1) / kBlocks;
  const WideKernel wide = wide_kernel_for(per_block);
  if (n < 1 || npoint < 1 || npoint > n || handover < 0 || wide == nullptr ||
      (handover > 0 && (nc > kMaxChunks || hkey == nullptr ||
                        hpos == nullptr || hnext == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* p = static_cast<const float4*>(pts);
  const auto* b = static_cast<const float*>(boxes);
  const auto* x = static_cast<const float*>(xyz);
  auto* m = static_cast<float*>(mind);
  auto* o = static_cast<int*>(out);
  auto* hk = static_cast<Key*>(hkey);
  auto* hp = static_cast<float4*>(hpos);
  auto* hn = static_cast<int*>(hnext);
  auto* v = static_cast<unsigned long long*>(visits);
  cudaError_t err = cudaFuncSetAttribute(
      wide, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
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
  config.stream = st;
  config.attrs = &attribute;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, wide, p, b, x, m, n, npoint, per_block,
                           handover, o, hk, hp, hn, v);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaGetLastError();
  if (err != cudaSuccess || handover == 0) return static_cast<int>(err);
  const int smem = nc * kChunkBytes;
  err = cudaFuncSetAttribute(fps_narrow_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fps_narrow_kernel<<<1, kThreads, smem, st>>>(p, b, x, m, hk, hp, hn, n,
                                               npoint, o, v);
  return static_cast<int>(cudaGetLastError());
}

// The message of a CUDA error code.
extern "C" const char* amc3d_tool_error(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
