// Stage labels by majority vote: for each query point, the most frequent
// class among the support points within its k-th smallest distinct d^2
// (times float32(1 + 1e-6)), ties to the lowest class.
//
// Replaces amcontrast3d_tpu/ops/contrast_pallas.py::_vote_kernel (entry
// label_vote), which selects the same threshold as the contrast kernel and
// counts the classes of the members with one MXU matmul against the
// support's one-hot labels.  The support is the full-resolution cloud and
// the queries a subsampled stage of it; they are not support points, so
// nothing is excluded.  Exact where the TPU tournament may overflow above
// 4096 points.
//
// What bounds it on the card: a dense kernel scans the support twice for
// every query (the selection, then the count), M * N distance tests each of
// about 9 float instructions (0.29 G for 4 x 6000 queries over 4 x 24000
// points), though only the support points near a query decide its vote.
// Design: two listed scans over the support's Morton-sorted layout
// (ops/spatial.py, stage 0's as the forward sorted it), the queries taken
// in the order of their own layout (the stage's, points along its own
// curve): a block takes 8 consecutive queries, a warp each.  A warp finds
// its home chunk in the support by its Morton code in the support's frame,
// by a search of the sorted codes with all 32 lanes (morton.cuh::
// home_chunk); any chunk would be right, a near one makes the seed tight.  The selection is listed_select.cuh's.  The count lists again,
// with the block's largest slacked threshold as its limit (a member lies
// at d^2 <= the k-th times 1 + 1e-6, so the bare k-th would drop some), and
// each warp scans the listed chunks within its own threshold and adds each
// member's class, read at the member's index in the caller's order (the w
// bits of the layout), to the warp's own histogram of ncls ints in dynamic
// shared memory (shared-memory atomics); then each lane keeps the best of
// classes lane, lane + 32, ... and a shuffle reduction takes the largest
// count, ties to the lowest class.  A label outside [0, ncls) is counted
// nowhere.
#include "listed_select.cuh"
#include "morton.cuh"

namespace {

using namespace amc3d;

template <int KPL>
__global__ void __launch_bounds__(kListThreads)
label_vote_kernel(const float4* __restrict__ support,
                  const float* __restrict__ boxes,
                  const long long* __restrict__ codes,
                  const float* __restrict__ frame_lo, int lo_stride,
                  const float* __restrict__ frame_scale, int scale_stride,
                  const int* __restrict__ labels,
                  const float4* __restrict__ query, int n, int nc, int m,
                  int k, int ncls, int* __restrict__ out) {
  __shared__ SelectShared sh;
  extern __shared__ int hist[];  // kListWarps * ncls
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rank = blockIdx.x * kListWarps + warp;
  const float4* sup = support + static_cast<size_t>(b) * n;
  const float* bx = boxes + static_cast<size_t>(b) * nc * 6;
  const int* lab = labels + static_cast<size_t>(b) * n;
  const int warps = min(kListWarps, m - static_cast<int>(blockIdx.x) * kListWarps);
  SelectQuery q{rank < m, 0.f, 0.f, 0.f, 0};
  int qi = 0;
  if (q.active) {
    const float4 p = query[static_cast<size_t>(b) * m + rank];
    q.x = p.x;
    q.y = p.y;
    q.z = p.z;
    qi = __float_as_int(p.w);
    q.home = home_chunk(codes + static_cast<size_t>(b) * n, n,
                        frame_lo + static_cast<size_t>(b) * lo_stride,
                        frame_scale[static_cast<size_t>(b) * scale_stride],
                        q.x, q.y, q.z, lane);
  }
  const float thr = listed_kth_distinct<KPL>(sup, bx, n, nc, k, warps, q, sh);

  // the count: list again within the block's largest threshold
  int* h = hist + warp * ncls;
  for (int c = lane; c < ncls; c += 32) h[c] = 0;
  __syncwarp();
  if (lane == 0) sh.limit[warp] = q.active ? thr : -1.f;
  __syncthreads();
  float ub[6];
  union_box(sh.pts, warps, ub);
  float block_limit = -1.f;
  for (int w = 0; w < warps; ++w) block_limit = fmaxf(block_limit, sh.limit[w]);
  auto listed = [&](int c) {
    return !(box_box_lower_bound(ub, bx + static_cast<size_t>(c) * 6) > block_limit);
  };
  for (int w0 = 0; w0 < nc; w0 += kListChunks) {
    const int total = block_list(w0, nc, listed, sh.list, sh.counts);
    if (!q.active) continue;
    for (int t0 = 0; t0 < total; t0 += 32) {
      const int t = t0 + lane;
      int c = 0;
      bool want = false;
      if (t < total) {
        c = sh.list[t];
        want = !(box_lower_bound(q.x, q.y, q.z, bx + static_cast<size_t>(c) * 6) > thr);
      }
      unsigned chunks = __ballot_sync(0xffffffffu, want);
      while (chunks) {
        const int src = __ffs(chunks) - 1;
        chunks &= chunks - 1;
        const int cc = __shfl_sync(0xffffffffu, c, src);
        const int base = cc * kChunk;
        const int len = min(kChunk, n - base);
        for (int u = lane; u < len; u += 32) {
          const float4 p = sup[base + u];
          if (point_d2(q.x, q.y, q.z, p.x, p.y, p.z) <= thr) {
            const int cls = lab[__float_as_int(p.w)];
            if (static_cast<unsigned>(cls) < static_cast<unsigned>(ncls))
              atomicAdd(&h[cls], 1);
          }
        }
      }
    }
  }
  __syncwarp();
  if (!q.active) return;
  int best = -1, best_c = 0;
  for (int c = lane; c < ncls; c += 32) {  // ascending: strict > keeps the lowest
    if (h[c] > best) {
      best = h[c];
      best_c = c;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int ob = __shfl_down_sync(0xffffffffu, best, off);
    const int oc = __shfl_down_sync(0xffffffffu, best_c, off);
    if (ob > best || (ob == best && oc < best_c)) {
      best = ob;
      best_c = oc;
    }
  }
  if (lane == 0) out[static_cast<size_t>(b) * m + qi] = best_c;
}

using VoteKernel = void (*)(const float4*, const float*, const long long*,
                            const float*, int, const float*, int, const int*,
                            const float4*, int, int, int, int, int, int*);

}  // namespace

// support (b, n) float4: the sorted support with its index bits in w; boxes
// (b, nc, 6) float32, nc = ceil(n / 64); codes (b, n) int64: its sorted
// Morton codes, in the frame lo (b rows of 3 floats, lo_stride apart) and
// scale (b floats, scale_stride apart); labels (b, n) int32 in the caller's
// order; query (b, m) float4: the queries in the order they are worked on
// (their own layout), their index bits in w; k >= 1, ncls >= 1 -> out (b, m)
// int32 classes in the caller's query order.
extern "C" int amc3d_label_vote(const void* support, const void* boxes,
                                const void* codes, const void* lo,
                                int lo_stride, const void* scale,
                                int scale_stride, const void* labels,
                                const void* query, void* out, int b, int n,
                                int m, int k, int ncls, void* stream) {
  if (ncls < 1 || n < 1 || reinterpret_cast<size_t>(support) % 16 ||
      reinterpret_cast<size_t>(query) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nc = (n + kChunk - 1) / kChunk;
  const dim3 grid((m + kListWarps - 1) / kListWarps, b);
  const size_t smem = static_cast<size_t>(kListWarps) * ncls * sizeof(int);
  VoteKernel kernel = nullptr;
  switch (sel_per_lane(k)) {
    case 1: kernel = label_vote_kernel<1>; break;
    case 2: kernel = label_vote_kernel<2>; break;
    case 4: kernel = label_vote_kernel<4>; break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  // beyond 48 KB of static and dynamic shared memory a block must opt in
  if (smem + sizeof(SelectShared) > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<grid, kListThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(support), static_cast<const float*>(boxes),
      static_cast<const long long*>(codes), static_cast<const float*>(lo),
      lo_stride, static_cast<const float*>(scale), scale_stride,
      static_cast<const int*>(labels), static_cast<const float4*>(query), n,
      nc, m, k, ncls, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
