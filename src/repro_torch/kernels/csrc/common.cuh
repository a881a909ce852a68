// Shared helpers of the hand-written Hopper kernels: 16-byte loads that
// widen to fp32, scalar conversions, and the masking constant.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define NEG_INF (-1e30f)

typedef long long i64;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Elements in one 16-byte vector.
template <typename T> struct Vec16 { static constexpr int E = 16 / sizeof(T); };

// One 16-byte global load (p must be 16-byte aligned), widened to fp32.
__device__ __forceinline__ void load16(const float* p, float* out) {
  float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x; out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float softcap_f(float s, float cap) {
  return cap > 0.f ? tanhf(s / cap) * cap : s;
}
