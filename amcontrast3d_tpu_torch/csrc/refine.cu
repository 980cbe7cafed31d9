// The CrossMask feature of the masked refinement (AMContrast3D++), fused,
// and its VJP: two kernels.
//
// Forward.  Replaces amcontrast3d_tpu/ops/contrast_pallas.py::
// _refine_fwd_kernel (entry dual_masks_cross).  For every point i of a
// cloud: its k nearest points of the same cloud in (d^2, index) order, the
// first slot dropped (the point itself, unless a duplicate position with a
// lower index precedes it), and over the k - 1 slots left
//   MIN       the feature row of the slot with the least ambiguity a, ties
//             to the first slot in ascending-distance order (an argmin
//             over the slots);
//   MIN_ALL0  the sum of the rows whose a <= 0, divided by k - 1.
// Slots past the n points of a small cloud index point 0, as the exact kNN
// pads them.  The TPU kernel selects by a d^2 threshold (a superset at d^2
// ties), averages argmin ties and multiplies a 0/1 weight tile into the
// features on the MXU; this kernel is exact and equals it wherever the
// minimum is unique.  Neither writes the (B, N, k) index tensor nor a
// (B, N, K, C) gather.  When a gradient is needed the kernel also writes
// the selection the backward reads: the chosen index per point (MIN) or the
// k - 1 member indices, -1 where a > 0 (MIN_ALL0).
//
// What bounds it on the card: a dense scan, N^2 distance tests of about 9
// float instructions per cloud (2.3 G for 4 clouds of 24000 points), is
// instruction throughput, though only the k nearest of each point matter;
// the feature traffic is one row read and one written per point (MIN),
// 25 MB each at 4 x 24000 x 64.  Design: the self-kNN is knn.cu's listed
// scan (listed_knn.cuh) over the decoder stage's Morton-sorted layout
// (ops/spatial.py, sorted once a forward with the model's other stage
// clouds): a block of 8 points consecutive along the curve lists the
// chunks within their k-th once, each warp scans its home chunk and the
// listed chunks within its own running k-th, and the slots end in the same
// (d^2, index) order as a dense scan's.  Then the warp reads its slots'
// ambiguities (one per lane and register), reduces the (a, slot) minimum
// with xor shuffles, and copies the chosen row coalesced.  MIN_ALL0 parks
// the member list in shared memory and sums the rows slot by slot, so each
// point's sum has a fixed order, the same as before the layout.
//
// Backward.  Replaces ::_refine_bwd_kernel, a support-side matmul of the
// re-derived 0/1 weights with g.  Here the saved selection makes it a
// scatter: df[sel[i, t]] += scale * g[i] over the slots t with
// sel >= 0 (scale 1 for MIN, 1 / (k - 1) for MIN_ALL0).  Bound: reading g
// and sel and writing df once (bytes).  Design: a group of lanes sized to C
// takes a point's row, reads its sel entries once and broadcasts them by
// shuffles (MIN_ALL0's 11 slots loop in registers), loads g as float4 and
// adds into df with red.global.add.v4.f32 (sm_90: one 16-byte reduction
// where four scalar atomics went before); rows with C % 4 != 0 take the
// scalar form.  The summation order of the atomics varies between runs, so
// df agrees with the twin's index_add_ to rounding, not bit for bit.  No
// gradient reaches the positions or the ambiguity.
//
// Second order (the adahessian step's Hessian-vector product).  The VJP is
// linear in g, so its own VJP, for a cotangent u (b, n, c) of df, is a
// gather by the saved selection: gu[i] = scale * sum_t u[sel[i, t]] over the
// slots with sel >= 0, summed in slot order and then scaled, as the twin
// (ops/refine.py::refine_cross_gather_plain).  No TPU kernel of its own:
// the JAX step differentiates _refine_bwd_kernel's VJP by a jvp.  Bound:
// the selected rows of u, sel read and gu written once (bytes).  Design: a
// thread a (point, vector of channels), float4 rows where C % 4 == 0; a
// point's selection lies within its k nearest, so neighbouring points read
// rows that L1 and L2 already hold.
#include "listed_knn.cuh"
#include "vector_red.cuh"

#include <climits>
#include <cstdint>
#include <type_traits>

namespace {

using namespace amc3d;

constexpr int kMaxSlots = 32 * kMaxSlotsPerLane;

template <int KPL>
__global__ void __launch_bounds__(kListThreads)
refine_cross_kernel(const float4* __restrict__ sorted,
                    const float* __restrict__ boxes,
                    const float* __restrict__ f, const float* __restrict__ a,
                    int n, int c, int k, int fusion_min,
                    float* __restrict__ out, int* __restrict__ sel_out) {
  __shared__ ListedShared sh;
  __shared__ int members[kListWarps][KPL * 32];
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nc = (n + kChunk - 1) / kChunk;
  const size_t base = static_cast<size_t>(b) * n;
  const float4* sup = sorted + base;
  // the points are the support itself, taken in its sorted order
  const ListedQuery q = listed_query(sup, nullptr, nullptr, nullptr, b, n);
  ChunkSearch<KPL, false> search;
  search.init(k, lane, CUDART_INF_F);
  listed_knn(sup, boxes + static_cast<size_t>(b) * nc * 6, n, nc, k, 0,
             min(kListWarps, n - static_cast<int>(blockIdx.x) * kListWarps),
             q, sh, search);
  if (!q.active) return;
  // slots past the n points keep index 0, as the exact kNN pads them
  const WarpTopK<KPL>& top = search.top;
  const int qi = q.qi;
  const float* fb = f + base * c;
  const float* ab = a + base;
  float* o = out + (base + qi) * c;

  if (fusion_min) {
    // (a, slot) minimum over the slots 1 .. k-1
    float best_a = CUDART_INF_F;
    int best_slot = INT_MAX;
#pragma unroll
    for (int r = 0; r < KPL; ++r) {
      const int slot = lane + 32 * r;
      if (slot >= 1 && slot < k) {
        const float av = ab[top.i[r]];
        if (av < best_a || best_slot == INT_MAX) {
          best_a = av;
          best_slot = slot;
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float oa = __shfl_xor_sync(kFullMask, best_a, off);
      const int os = __shfl_xor_sync(kFullMask, best_slot, off);
      const bool take = os != INT_MAX &&
                        (best_slot == INT_MAX || oa < best_a ||
                         (oa == best_a && os < best_slot));
      if (take) {
        best_a = oa;
        best_slot = os;
      }
    }
    const int chosen = top.index_at(best_slot);
    const float* src = fb + static_cast<size_t>(chosen) * c;
    for (int ch = lane; ch < c; ch += 32) o[ch] = src[ch];
    if (sel_out != nullptr && lane == 0) sel_out[base + qi] = chosen;
    return;
  }

  // MIN_ALL0: the members with a <= 0, in slot order
#pragma unroll
  for (int r = 0; r < KPL; ++r) {
    const int slot = lane + 32 * r;
    int j = -1;
    if (slot >= 1 && slot < k && ab[top.i[r]] <= 0.f) j = top.i[r];
    members[warp][slot] = j;
  }
  __syncwarp();
  const float denom = static_cast<float>(k - 1);
  for (int ch = lane; ch < c; ch += 32) {
    float sum = 0.f;
    for (int s = 1; s < k; ++s) {
      const int j = members[warp][s];
      if (j >= 0) sum = __fadd_rn(sum, fb[static_cast<size_t>(j) * c + ch]);
    }
    o[ch] = __fdiv_rn(sum, denom);
  }
  if (sel_out != nullptr) {
    int* so = sel_out + (base + qi) * (k - 1);
    for (int s = 1 + lane; s < k; s += 32) so[s - 1] = members[warp][s];
  }
}

constexpr int kBwdThreads = 256;

// A group of LANES lanes (a power of two, sized to the row) takes one
// point's row: its lanes read the row's sel entries once, LANES at a time,
// and broadcast them by shuffles; each lane scales V floats of g at a time
// (V = 4: float4 loads and vector reductions, rows of C % 4 == 0 on 16-byte
// boundaries; V = 1: scalar) and adds them into every selected row of df.
// The loops run the same number of times on every lane of a warp (C and
// the slot count are the kernel's), so the shuffles stay converged; lanes
// past the row or the rows are predicated off.
template <int LANES, int V>
__global__ void __launch_bounds__(kBwdThreads)
refine_cross_bwd_kernel(const float* __restrict__ g,
                        const int* __restrict__ sel, long long rows, int n,
                        int c, int slots, float scale, float* __restrict__ df) {
  using Vec = typename std::conditional<V == 4, float4, float>::type;
  const int t = threadIdx.x & (LANES - 1);
  const long long row =
      (static_cast<long long>(blockIdx.x) * kBwdThreads + threadIdx.x) / LANES;
  const bool active = row < rows;
  const size_t r = active ? static_cast<size_t>(row) : 0;
  const float* gr = g + r * c;
  const int* sr = sel + r * slots;
  float* db = df + (r / n) * n * c;  // the row's cloud
  const int cv = c / V;              // vectors a row
  for (int s0 = 0; s0 < slots; s0 += LANES) {
    const int ns = min(LANES, slots - s0);
    const int mine = active && t < ns ? __ldg(sr + s0 + t) : -1;
    for (int i0 = 0; i0 < cv; i0 += LANES) {
      const int i = i0 + t;
      const bool on = active && i < cv;
      Vec v{};
      if (on) v = load_scaled(gr + i * V, scale, Vec{});
      for (int s = 0; s < ns; ++s) {
        const int j = __shfl_sync(0xffffffffu, mine, s, LANES);
        if (on && j >= 0) red_add(db + static_cast<size_t>(j) * c + i * V, v);
      }
    }
  }
}

using BwdKernel = void (*)(const float*, const int*, long long, int, int, int,
                           float, float*);

// lanes a row: the least power of two that covers `vectors` vectors, at
// most a warp
int group_lanes(int vectors) {
  int lanes = 1;
  while (lanes < vectors && lanes < 32) lanes *= 2;
  return lanes;
}

template <int V>
BwdKernel bwd_kernel(int lanes) {
  switch (lanes) {
    case 1: return refine_cross_bwd_kernel<1, V>;
    case 2: return refine_cross_bwd_kernel<2, V>;
    case 4: return refine_cross_bwd_kernel<4, V>;
    case 8: return refine_cross_bwd_kernel<8, V>;
    case 16: return refine_cross_bwd_kernel<16, V>;
    default: return refine_cross_bwd_kernel<32, V>;
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

constexpr int kGatherThreads = 256;

// V = 4: float4 rows (C % 4 == 0, 16-byte aligned u and out); V = 1: scalar
template <int V>
__global__ void __launch_bounds__(kGatherThreads)
refine_cross_gather_kernel(const float* __restrict__ u,
                           const int* __restrict__ sel, long long rows, int n,
                           int c, int slots, float scale,
                           float* __restrict__ out) {
  using Vec = typename std::conditional<V == 4, float4, float>::type;
  const int cv = c / V;
  const long long total = rows * cv;
  for (long long e = static_cast<long long>(blockIdx.x) * kGatherThreads +
                     threadIdx.x;
       e < total; e += static_cast<long long>(gridDim.x) * kGatherThreads) {
    const long long r = e / cv;
    const int i = static_cast<int>(e - r * cv);
    const float* ub = u + static_cast<size_t>(r / n) * n * c + i * V;
    const int* sr = sel + r * slots;
    Vec acc{};
    for (int t = 0; t < slots; ++t) {
      const int j = __ldg(sr + t);
      if (j >= 0)
        acc = add_rn(acc, load_scaled(ub + static_cast<size_t>(j) * c, 1.f, Vec{}));
    }
    float* o = out + r * c + i * V;
    if constexpr (V == 4) {
      *reinterpret_cast<float4*>(o) =
          make_float4(__fmul_rn(acc.x, scale), __fmul_rn(acc.y, scale),
                      __fmul_rn(acc.z, scale), __fmul_rn(acc.w, scale));
    } else {
      *o = __fmul_rn(acc, scale);
    }
  }
}

}  // namespace

// The stage cloud's layout: sorted (b, n) float4, its points along the
// Morton curve with the bits of each point's index in w, and boxes
// (b, ceil(n / 64), 6); f (b, n, c), a (b, n) float32 in the caller's order;
// 2 <= k <= 128 (k counts the point itself) -> out (b, n, c) float32;
// sel_out, unless null, is (b, n) int32 for fusion_min and (b, n, k - 1)
// int32 otherwise.
extern "C" int amc3d_refine_cross(const void* sorted, const void* boxes,
                                  const void* f, const void* a, void* out,
                                  void* sel_out, int b, int n, int c, int k,
                                  int fusion_min, void* stream) {
  if (k < 2 || k > kMaxSlots || reinterpret_cast<size_t>(sorted) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + kListWarps - 1) / kListWarps, b);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* sp = static_cast<const float4*>(sorted);
  const auto* bx = static_cast<const float*>(boxes);
  const auto* ff = static_cast<const float*>(f);
  const auto* aa = static_cast<const float*>(a);
  auto* o = static_cast<float*>(out);
  auto* so = static_cast<int*>(sel_out);
  switch (slots_per_lane(k)) {
    case 1: refine_cross_kernel<1><<<grid, kListThreads, 0, st>>>(sp, bx, ff, aa, n, c, k, fusion_min, o, so); break;
    case 2: refine_cross_kernel<2><<<grid, kListThreads, 0, st>>>(sp, bx, ff, aa, n, c, k, fusion_min, o, so); break;
    case 4: refine_cross_kernel<4><<<grid, kListThreads, 0, st>>>(sp, bx, ff, aa, n, c, k, fusion_min, o, so); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// g (b, n, c) float32, sel (b, n, slots) int32 (entries < 0 are skipped)
// -> df (b, n, c) float32: zeroed here on the stream, then scale * g rows
// added in; b * n >= 1, c >= 1 and slots >= 1, else cudaErrorInvalidValue.
// Vector loads and reductions where C % 4 == 0 and g and df start on 16
// bytes.
extern "C" int amc3d_refine_cross_backward(const void* g, const void* sel,
                                           void* df, int b, int n, int c,
                                           int slots, float scale,
                                           void* stream) {
  if (b < 1 || n < 1 || c < 1 || slots < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = c % 4 == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(df) % 16 == 0;
  const int lanes = group_lanes(vec ? c / 4 : c);
  const BwdKernel kernel = vec ? bwd_kernel<4>(lanes) : bwd_kernel<1>(lanes);
  const long long rows = static_cast<long long>(b) * n;
  const long long blocks = (rows * lanes + kBwdThreads - 1) / kBwdThreads;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // the zeros the atomics add into, without a second call from the host
  const cudaError_t err =
      cudaMemsetAsync(df, 0, static_cast<size_t>(rows) * c * sizeof(float), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(blocks), kBwdThreads, 0, st>>>(
      static_cast<const float*>(g), static_cast<const int*>(sel), rows, n, c,
      slots, scale, static_cast<float*>(df));
  return static_cast<int>(cudaGetLastError());
}

// The second order: u (b, n, c) float32, sel (b, n, slots) int32 (entries
// < 0 are skipped) -> out (b, n, c) float32, scale * the sum of u's selected
// rows in slot order; b * n >= 1, c >= 1 and slots >= 1, else
// cudaErrorInvalidValue.
extern "C" int amc3d_refine_cross_gather(const void* u, const void* sel,
                                         void* out, int b, int n, int c,
                                         int slots, float scale,
                                         void* stream) {
  if (b < 1 || n < 1 || c < 1 || slots < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = c % 4 == 0 && aligned16(u) && aligned16(out);
  const long long rows = static_cast<long long>(b) * n;
  const long long items = rows * (vec ? c / 4 : c);
  const long long blocks = (items + kGatherThreads - 1) / kGatherThreads;
  const unsigned grid = static_cast<unsigned>(blocks < 65536 ? blocks : 65536);
  auto* kernel = vec ? &refine_cross_gather_kernel<4> : &refine_cross_gather_kernel<1>;
  kernel<<<grid, kGatherThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(u), static_cast<const int*>(sel), rows, n, c,
      slots, scale, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
