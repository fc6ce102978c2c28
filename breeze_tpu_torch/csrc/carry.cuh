// Loads and stores of the acoustic carries in their storage type, float32
// or bfloat16, shared by the acoustic kernels (acoustic.cu, K3's
// counterpart; acoustic_split.cu, K1/K2's).  The arithmetic is float32:
// ld() and rd() return the stored value widened, st() rounds to nearest
// even and returns the value as stored, rnd<T>() rounds as st() would
// without storing.  ld() reads through the read-only
// cache and is for inputs no kernel of the launch writes; rd() is a plain
// load, for inputs that may alias an output.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(__ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p))));
}
__device__ __forceinline__ float rd(const float* p) { return *p; }
__device__ __forceinline__ float rd(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ float st(float* p, float v) {
  *p = v;
  return v;
}
__device__ __forceinline__ float st(__nv_bfloat16* p, float v) {
  const __nv_bfloat16 b = __float2bfloat16_rn(v);
  *p = b;
  return __bfloat162float(b);
}
template <typename T>
__device__ __forceinline__ float rnd(float v) {
  return v;
}
template <>
__device__ __forceinline__ float rnd<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

}  // namespace
