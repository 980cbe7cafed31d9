// Keys, warp reductions and the thread-block-cluster primitives shared by
// fps.cu and fps_pruned.cu.
//
// A candidate of furthest point sampling travels as one 64-bit key:
// value bits << 32 | ~index.  The value is a min-distance d^2 >= +0, whose
// float bits order as integers; the complement makes the lowest index win
// a tie; whole keys are compared, so the order survives every reduction
// across lanes, warps and blocks.  Key 0 is below every point's key.
//
// The blocks of one cluster exchange their winners through distributed
// shared memory: st.async stores a value into another block's shared memory
// and counts its bytes in on that block's mbarrier (PTX: mapa, mbarrier,
// st.async), so a block waits on its own mbarrier only.
#pragma once
#include <cuda_runtime.h>

namespace amc3d {

using Key = unsigned long long;

__device__ __forceinline__ Key make_key(float v, int i) {
  return (static_cast<Key>(__float_as_uint(v)) << 32) |
         (0xffffffffu - static_cast<unsigned>(i));
}

__device__ __forceinline__ int key_index(Key key) {
  return static_cast<int>(0xffffffffu - static_cast<unsigned>(key));
}

__device__ __forceinline__ float key_value(Key key) {
  return __uint_as_float(static_cast<unsigned>(key >> 32));
}

// the largest key of the warp, on every lane: the largest high word, then
// the largest low word among the lanes that hold it (two redux instructions
// instead of five rounds of 64-bit shuffles)
__device__ __forceinline__ Key warp_max(Key k) {
  const unsigned hi = static_cast<unsigned>(k >> 32);
  const unsigned top = __reduce_max_sync(0xffffffffu, hi);
  const unsigned lo = hi == top ? static_cast<unsigned>(k) : 0u;
  return (static_cast<Key>(top) << 32) | __reduce_max_sync(0xffffffffu, lo);
}

__device__ __forceinline__ unsigned shared_address(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ unsigned address_in_block(unsigned address,
                                                     unsigned rank) {
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(remote) : "r"(address), "r"(rank));
  return remote;
}

__device__ __forceinline__ void mbarrier_init(unsigned mbarrier) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(mbarrier));
}

// this phase completes once `bytes` have been stored into the block
__device__ __forceinline__ void mbarrier_expect(unsigned mbarrier,
                                                unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(mbarrier), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbarrier_wait(unsigned mbarrier,
                                              unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.b32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(mbarrier), "r"(parity) : "memory");
  }
}

__device__ __forceinline__ void store_async(unsigned address, Key value,
                                            unsigned mbarrier) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b64 [%0], %1, [%2];"
      ::"r"(address), "l"(value), "r"(mbarrier) : "memory");
}

__device__ __forceinline__ void store_async(unsigned address, float4 value,
                                            unsigned mbarrier) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], "
      "{%1, %2, %3, %4}, [%5];"
      ::"r"(address), "f"(value.x), "f"(value.y), "f"(value.z), "f"(value.w),
      "r"(mbarrier) : "memory");
}

}  // namespace amc3d
