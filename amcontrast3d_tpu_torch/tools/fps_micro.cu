// Microbenchmarks of the pieces of a whole-room FPS pick on one
// multiprocessor, in clock64 cycles: what a one-block design of the late
// picks (tools/fps_handover.cu) spends where the 16-block cluster of
// csrc/fps_pruned.cu spends one exchange (~0.6 us).  Built and run by
// tools/fps_handover.py (tools/profile_room_fps.py --micro).
#include <cuda_runtime.h>

#include "chunks.cuh"
#include "cluster.cuh"

namespace {

using namespace amc3d;

constexpr unsigned kFull = 0xffffffffu;
__device__ unsigned long long sink;  // keeps every loop's result alive

// One block of `threads`, each loop `iters` times; out[i] the cycles of one
// round of loop i, as thread 0 reads them: 0 warp_max (two redux), 1 one
// redux of 32 bits, 2 a 64-bit shuffle butterfly (5 steps), 3 a scan of 16
// keys in shared memory, 4 __syncthreads, 5 a chain of dependent L2 loads
// of float4 points, 6 a chain of dependent min-distance loads and stores,
// 7 a shared-memory atomicAdd by lane 0 and its broadcast, 8 a ballot.
__global__ void primitives_kernel(const float4* pts, float* mind, int n,
                                  unsigned long long* out, int iters) {
  __shared__ Key sk[32];
  __shared__ int cnt;
  const int lane = threadIdx.x & 31;
  Key v = (static_cast<Key>(threadIdx.x * 2654435761u) << 20) | threadIdx.x;
  if (threadIdx.x < 32) sk[threadIdx.x] = v;
  if (threadIdx.x == 0) cnt = 0;
  __syncthreads();
  unsigned long long t0, t1, acc = 0;
  t0 = clock64();
  for (int i = 0; i < iters; ++i) v = warp_max(v) + i;
  t1 = clock64();
  if (threadIdx.x == 0) out[0] = (t1 - t0) / iters;
  unsigned u = static_cast<unsigned>(v);
  t0 = clock64();
  for (int i = 0; i < iters; ++i) u = __reduce_max_sync(kFull, u) + i;
  t1 = clock64();
  if (threadIdx.x == 0) out[1] = (t1 - t0) / iters;
  acc += u;
  t0 = clock64();
  for (int i = 0; i < iters; ++i) {
    for (int o = 16; o; o >>= 1) {
      const Key w = __shfl_xor_sync(kFull, v, o);
      v = w > v ? w : v;
    }
    v += i;
  }
  t1 = clock64();
  if (threadIdx.x == 0) out[2] = (t1 - t0) / iters;
  t0 = clock64();
  for (int i = 0; i < iters; ++i) {
    Key b = 0;
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      const Key w = sk[(q + static_cast<int>(v & 1)) & 31];
      b = w > b ? w : b;
    }
    v = b + i;
  }
  t1 = clock64();
  if (threadIdx.x == 0) out[3] = (t1 - t0) / iters;
  t0 = clock64();
  for (int i = 0; i < iters; ++i) __syncthreads();
  t1 = clock64();
  if (threadIdx.x == 0) out[4] = (t1 - t0) / iters;
  int idx = threadIdx.x;
  t0 = clock64();
  for (int i = 0; i < iters; ++i) {
    const float4 p = __ldg(pts + idx);
    idx = (__float_as_int(p.w) * 7919 + i * 104729) % n;
    if (idx < 0) idx = -idx;
  }
  t1 = clock64();
  if (threadIdx.x == 0) out[5] = (t1 - t0) / iters;
  acc += idx;
  t0 = clock64();
  for (int i = 0; i < iters; ++i) {
    const float m = mind[idx];
    mind[idx] = m * 0.5f;
    idx = (static_cast<int>(m) + idx * 31 + i * 104729) % n;
    if (idx < 0) idx = -idx;
  }
  t1 = clock64();
  if (threadIdx.x == 0) out[6] = (t1 - t0) / iters;
  acc += idx;
  t0 = clock64();
  for (int i = 0; i < iters; ++i) {
    int at = 0;
    if (lane == 0) at = atomicAdd(&cnt, 1);
    idx += __shfl_sync(kFull, at, 0);
  }
  t1 = clock64();
  if (threadIdx.x == 0) out[7] = (t1 - t0) / iters;
  acc += idx;
  t0 = clock64();
  for (int i = 0; i < iters; ++i) idx += __ballot_sync(kFull, (idx & 1) != 0);
  t1 = clock64();
  if (threadIdx.x == 0) out[8] = (t1 - t0) / iters;
  acc += idx;
  sink += acc + v;
}

// One round of a late pick's visits: `visitors` warps each visit one
// chunk of 64 points at random (two float4 loads, two min-distance loads,
// with `store` their stores, the chunk's key through warp_max), then one
// block barrier and the block's largest key in every warp.  out[0]: the
// cycles of a round.
__global__ void __launch_bounds__(512, 1)
visit_round_kernel(const float4* __restrict__ pts, float* __restrict__ mind,
                   int nc, int visitors, int store, unsigned long long* out,
                   int iters) {
  __shared__ Key sk[16];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float lx = 0.5f, ly = 0.5f, lz = 0.5f;
  unsigned seed = 12345u + warp * 7919u;
  Key acc = 0;
  const unsigned long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
    if (warp < visitors) {
      seed = seed * 1664525u + 1013904223u;
      const int c = (seed >> 8) % nc;
      const int i0 = c * kChunk + lane, i1 = i0 + 32;
      const float4 p0 = __ldg(pts + i0), p1 = __ldg(pts + i1);
      const float m0 = mind[i0], m1 = mind[i1];
      const float v0 = fminf(m0, point_d2(p0.x, p0.y, p0.z, lx, ly, lz));
      const float v1 = fminf(m1, point_d2(p1.x, p1.y, p1.z, lx, ly, lz));
      if (store) {
        mind[i0] = v0;
        mind[i1] = v1;
      }
      const Key k0 = make_key(v0, __float_as_int(p0.w));
      const Key k1 = make_key(v1, __float_as_int(p1.w));
      const Key best = k0 > k1 ? k0 : k1;
      const Key top = warp_max(best);
      const int src = __ffs(__ballot_sync(kFull, best == top)) - 1;
      lx = __shfl_sync(kFull, p0.x, src) * 0.5f + 0.25f;
      if (lane == 0) sk[warp] = top;
      acc += top;
    }
    __syncthreads();
    const Key t = warp_max(lane < 16 ? sk[lane] : 0);
    lx += __uint_as_float(static_cast<unsigned>(t) & 0x3fffffu) * 1e-30f;
  }
  const unsigned long long t1 = clock64();
  if (threadIdx.x == 0) out[0] = (t1 - t0) / iters;
  sink += acc + static_cast<unsigned long long>(lx);
}

// The narrow kernel's third phase alone: two barriers, then every warp
// scans `groups` group keys in shared memory and reads the winner's
// position; COPIES copies of that body, one taken a round (as a larger
// kernel's code would be).  out[0]: the cycles of a round.
template <int COPIES>
__global__ void __launch_bounds__(512, 1)
pick_round_kernel(int groups, unsigned long long* out, int iters) {
  __shared__ Key gk[160];
  __shared__ float cpos[3 * 2048];
  const int tid = threadIdx.x, lane = tid & 31;
  for (int i = tid; i < 160; i += 512)
    gk[i] = (static_cast<Key>(i * 2654435761u) << 32) | (i * 37);
  for (int i = tid; i < 3 * 2048; i += 512) cpos[i] = i * 0.5f;
  __syncthreads();
  float lx = 0.f;
  unsigned long long acc = 0;
  const unsigned long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
    __syncthreads();
    if (tid == 0) gk[it % groups] += 1;
    __syncthreads();
#pragma unroll
    for (int cp = 0; cp < COPIES; ++cp) {
      if ((it % COPIES) == cp) {
        Key mine = 0;
        for (int g = lane; g < groups; g += 32) mine = gk[g] > mine ? gk[g] : mine;
        const Key top = warp_max(mine + cp);
        const int win = static_cast<int>(top & 2047u);
        lx += cpos[win] + cpos[2048 + win] * (cp + 1) + cpos[2 * 2048 + win];
        acc += top;
      }
    }
  }
  const unsigned long long t1 = clock64();
  if (tid == 0) out[0] = (t1 - t0) / iters;
  sink += acc + static_cast<unsigned long long>(lx);
}

}  // namespace

// pts (n) float4 with an int in w, mind (n) float32 -> out (9) uint64.
extern "C" int amc3d_micro_primitives(const void* pts, void* mind, int n,
                                      void* out, int threads) {
  primitives_kernel<<<1, threads>>>(static_cast<const float4*>(pts),
                                    static_cast<float*>(mind), n,
                                    static_cast<unsigned long long*>(out), 1000);
  return static_cast<int>(cudaDeviceSynchronize());
}

// pts (nc x 64) float4, mind (nc x 64) float32 -> out (1) uint64.
extern "C" int amc3d_micro_visit_round(const void* pts, void* mind, int nc,
                                       int visitors, int store, void* out) {
  visit_round_kernel<<<1, 512>>>(static_cast<const float4*>(pts),
                                 static_cast<float*>(mind), nc, visitors, store,
                                 static_cast<unsigned long long*>(out), 2000);
  return static_cast<int>(cudaDeviceSynchronize());
}

// groups <= 160, copies 1 or 8 -> out (1) uint64.
extern "C" int amc3d_micro_pick_round(int groups, int copies, void* out) {
  if (groups < 1 || groups > 160 || (copies != 1 && copies != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  auto* o = static_cast<unsigned long long*>(out);
  if (copies == 1)
    pick_round_kernel<1><<<1, 512>>>(groups, o, 2000);
  else
    pick_round_kernel<8><<<1, 512>>>(groups, o, 2000);
  return static_cast<int>(cudaDeviceSynchronize());
}

// The message of a CUDA error code.
extern "C" const char* amc3d_tool_error(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
