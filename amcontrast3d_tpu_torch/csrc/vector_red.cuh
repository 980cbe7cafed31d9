// Scaled loads and global reductions of one float or four: the device code
// shared by the scatters of refine.cu (kernel 19) and interpolate.cu
// (kernel 9).  The float4 forms need 16-byte aligned addresses (rows of a
// multiple of 4 floats on 16-byte aligned tensors); the kernels take the
// scalar forms otherwise.
#pragma once
#include <cuda_runtime.h>

namespace amc3d {

// df[0..3] += v with one vector reduction (PTX for sm_90: a 16-byte
// red.global, a quarter of the atomic operations of four scalar ones)
__device__ __forceinline__ void red_add(float* address, float4 v) {
  asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};"
               ::"l"(address), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

__device__ __forceinline__ void red_add(float* address, float v) {
  atomicAdd(address, v);
}

// s * p[0..3] (or s * p[0]), each product rounded on its own
__device__ __forceinline__ float4 load_scaled(const float* p, float s, float4) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  return make_float4(__fmul_rn(v.x, s), __fmul_rn(v.y, s), __fmul_rn(v.z, s),
                     __fmul_rn(v.w, s));
}

__device__ __forceinline__ float load_scaled(const float* p, float s, float) {
  return __fmul_rn(__ldg(p), s);
}

__device__ __forceinline__ float4 add_rn(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}

}  // namespace amc3d
