// 3-NN inverse-distance interpolation onto a large cloud: only the chunks
// of the coarse support that can still hold one of a fine point's three
// nearest are scanned, and the weighted sum is formed in the same kernel.
//
// Replaces three TPU kernels of amcontrast3d_tpu/ops/interpolate_pallas.py
// (entry _interp_fwd_big, reached when the coarse buffer exceeds VMEM:
// the whole-scene test's fp0 from the 221184 bucket up):
// _interp_thr_seed_kernel (an upper bound on each fine point's 3rd-nearest
// d^2 from one chunk placed proportionally to its query tile),
// _interp_thr_kernel (the exact 3rd-nearest d^2 by a box-pruned sweep of
// the kd-sorted chunks) and _interp_acc_big_kernel (the weighted sum over
// the coarse points within that threshold).  On the TPU the three are grid
// phases because VMEM cannot hold the support; here a warp carries its
// fine point's 3 best (d^2, index) pairs in registers through all three.
//
// Semantics are exactly those of interpolate.cu and of the plain PyTorch
// twin (ops/interpolate.py): exactly three neighbours in (d^2, index)
// order, ties to the lowest index, (1e10, index 0) for missing ones;
// w_i = 1 / (sqrt(max(d_i^2, 0)) + 1e-8) normalised by (r0 + r1) + r2;
// out[c] = (f[i0,c]*w0 + f[i1,c]*w1) + f[i2,c]*w2, every step rounded as
// interpolate.cu rounds it (-fmad=false, __f*_rn), so the output is the
// same bits as interpolate.cu's on the same input.  The TPU kernels admit
// every coarse point within thr * (1 + 1e-6) instead, so at a near-tie at
// the 3rd neighbour they average in a 4th point (a difference by design).
//
// What bounds it on the card: interpolate.cu tests all N1 * N2 pairs
// (1.2e10 at fp0 of the 221184 bucket, 9 float instructions each); a fine
// point needs only the few chunks around it.  What remains is the box tests
// (N1 * N2 / 64), the points of the visited chunks and the weighted sum:
// 3 rows of C floats read and one written a fine point.  Design
// (chunk_search.cuh::search with k = 3): ops/spatial.py sorts the
// coarse points along a Morton curve into chunks of 64 with exact boxes and
// orders the fine points along the same curve, so the 8 warps of a block
// read the same chunks.  A warp scans the chunks around its fine point's
// place in the sorted order (kernel 11's bound), then tests every other
// chunk's box and scans those whose bound is not above its running 3rd
// pair (kernel 12), then forms the weights and sweeps the C channels, a
// lane every 32nd, reading the three coarse rows by their original index
// (f2 is never permuted) and writing the fine row (kernel 13).  Row offsets
// are size_t (N1 * C reaches 1.6e8 at the top bucket).
#include "chunk_search.cuh"

namespace {

using namespace amc3d;

__global__ void __launch_bounds__(kScanThreads)
interp_big_kernel(const float4* __restrict__ support,
                  const float* __restrict__ boxes, const float* __restrict__ p1,
                  const int* __restrict__ order, const int* __restrict__ home,
                  const float* __restrict__ f2, int n1, int n2, int c, int nc,
                  float* __restrict__ out, int* __restrict__ idx_out,
                  float* __restrict__ w_out,
                  unsigned long long* __restrict__ visits) {
  __shared__ unsigned long long block_visits;
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int rank = blockIdx.x * kScanWarps + (threadIdx.x >> 5);
  if (visits != nullptr && threadIdx.x == 0) block_visits = 0;
  if (visits != nullptr) __syncthreads();
  if (rank < n1) {
    const size_t qrow = static_cast<size_t>(b) * n1;
    const int qi = order[qrow + rank];
    const float* q = p1 + (qrow + qi) * 3;
    ChunkSearch<1> s;
    s.init(3, lane, 1e10f);  // interpolate.cu's fillers
    const int scanned = s.search(
        support + static_cast<size_t>(b) * n2,
        boxes + static_cast<size_t>(b) * nc * 6, n2, nc, home[qrow + rank], 1,
        q[0], q[1], q[2]);
    if (visits != nullptr && lane == 0)
      atomicAdd(&block_visits, static_cast<unsigned long long>(scanned));
    // slot s sits in lane s
    const float d0 = __shfl_sync(kFullMask, s.top.d[0], 0);
    const float d1 = __shfl_sync(kFullMask, s.top.d[0], 1);
    const float d2 = __shfl_sync(kFullMask, s.top.d[0], 2);
    const int i0 = __shfl_sync(kFullMask, s.top.i[0], 0);
    const int i1 = __shfl_sync(kFullMask, s.top.i[0], 1);
    const int i2 = __shfl_sync(kFullMask, s.top.i[0], 2);
    const float r0 = __fdiv_rn(1.0f, __fadd_rn(__fsqrt_rn(fmaxf(d0, 0.f)), 1e-8f));
    const float r1 = __fdiv_rn(1.0f, __fadd_rn(__fsqrt_rn(fmaxf(d1, 0.f)), 1e-8f));
    const float r2 = __fdiv_rn(1.0f, __fadd_rn(__fsqrt_rn(fmaxf(d2, 0.f)), 1e-8f));
    const float norm = __fadd_rn(__fadd_rn(r0, r1), r2);
    const float w0 = __fdiv_rn(r0, norm);
    const float w1 = __fdiv_rn(r1, norm);
    const float w2 = __fdiv_rn(r2, norm);
    if (idx_out != nullptr && lane < 3) {
      const size_t row = (qrow + qi) * 3;
      idx_out[row + lane] = lane == 0 ? i0 : (lane == 1 ? i1 : i2);
      w_out[row + lane] = lane == 0 ? w0 : (lane == 1 ? w1 : w2);
    }
    const float* f = f2 + static_cast<size_t>(b) * n2 * c;
    const float* g0 = f + static_cast<size_t>(i0) * c;
    const float* g1 = f + static_cast<size_t>(i1) * c;
    const float* g2 = f + static_cast<size_t>(i2) * c;
    float* o = out + (qrow + qi) * c;
    for (int ch = lane; ch < c; ch += 32) {
      o[ch] = __fadd_rn(__fadd_rn(__fmul_rn(g0[ch], w0), __fmul_rn(g1[ch], w1)),
                        __fmul_rn(g2[ch], w2));
    }
  }
  if (visits != nullptr) {
    __syncthreads();
    if (threadIdx.x == 0) atomicAdd(visits, block_visits);
  }
}

}  // namespace

// support (b, n2) float4: the coarse points sorted along a Morton curve with
// their original index in w; boxes (b, nc, 6) float32, nc = ceil(n2 / 64);
// p1 (b, n1, 3) float32 fine points; order (b, n1) int32: the fine points
// in the order they are worked on; home (b, n1) int32: per entry of order,
// the chunk to start from; f2 (b, n2, c) float32 in the original coarse
// order -> out (b, n1, c) float32; idx_out (b, n1, 3) int32 and w_out
// (b, n1, 3) float32 unless null; visits (one uint64 the caller zeroes, or
// null) gains the chunks scanned.
extern "C" int amc3d_three_interpolate_big(const void* support,
                                           const void* boxes, const void* p1,
                                           const void* order, const void* home,
                                           const void* f2, void* out,
                                           void* idx_out, void* w_out,
                                           void* visits, int b, int n1, int n2,
                                           int c, void* stream) {
  if (n2 < 1 || c < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int nc = (n2 + kChunk - 1) / kChunk;
  const dim3 grid((n1 + kScanWarps - 1) / kScanWarps, b);
  interp_big_kernel<<<grid, kScanThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(support), static_cast<const float*>(boxes),
      static_cast<const float*>(p1), static_cast<const int*>(order),
      static_cast<const int*>(home), static_cast<const float*>(f2), n1, n2, c,
      nc, static_cast<float*>(out), static_cast<int*>(idx_out),
      static_cast<float*>(w_out), static_cast<unsigned long long*>(visits));
  return static_cast<int>(cudaGetLastError());
}
