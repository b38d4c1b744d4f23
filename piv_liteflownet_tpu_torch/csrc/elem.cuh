// The element types of the kernels' two forms, float32 and bfloat16, and their
// conversions. A bf16 form reads bf16, widens each value to f32 exactly (a
// bf16 is the top half of an f32), computes in f32 and rounds once on store,
// to nearest even.

#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace elem {

using bf16 = __nv_bfloat16;

// One value as f32, read through the read-only cache.
__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const bf16* p) {
  return __uint_as_float((uint32_t)__ldg(reinterpret_cast<const unsigned short*>(p)) << 16);
}

// One value, already loaded, as f32.
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(bf16 v) { return __bfloat162float(v); }

// One value from f32.
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) { *p = __float2bfloat16_rn(v); }

// The two bf16 in one 32-bit word (the first in the low half) as f32.
__device__ __forceinline__ float lo(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float hi(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

// Two f32 rounded to bf16 in one 32-bit word, a in the low half.
__device__ __forceinline__ uint32_t pack2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Four adjacent f32 values from shared memory, one 16-byte load (p aligned to it).
__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}

// Four adjacent f32 values from device memory through the read-only cache, one 16-byte load.
__device__ __forceinline__ void ldg4(const float* p, float* v) {
  const float4 t = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}

// Four adjacent f32 values to device memory, each v[i] * s, one 16-byte store.
__device__ __forceinline__ void store4(float* p, const float* v, float s) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0] * s, v[1] * s, v[2] * s, v[3] * s);
}

}  // namespace elem
