// Bilinear taps shared by the warp kernels: grid_sample(mode="bilinear",
// padding_mode="zeros", align_corners=True) at pixel coordinates (x, y).
#pragma once

#include <cuda_runtime.h>

#include "elem.cuh"

struct BilinearTaps {
  int off[4];   // y*W + x of the corners (y0,x0) (y0,x0+1) (y0+1,x0) (y0+1,x0+1); -1 = outside
  float w[4];   // their weights, 0 outside
  float wx, wy; // x - floor(x), y - floor(y)
  int x0, y0;   // the corner (y0,x0) itself; meaningful only where some tap is inside
};

__device__ __forceinline__ BilinearTaps bilinear_taps(float x, float y, int H, int W) {
  BilinearTaps t;
  const float xf = floorf(x);
  const float yf = floorf(y);
  const float wx = x - xf;
  const float wy = y - yf;
  t.wx = wx;
  t.wy = wy;
  const float wxs[2] = {1.f - wx, wx};
  const float wys[2] = {1.f - wy, wy};
  // The floor is converted to int only where some corner can be inside, so a
  // huge or NaN coordinate never reaches the conversion; it reads zeros.
  const bool xr = xf >= -1.f && xf <= (float)(W - 1);
  const bool yr = yf >= -1.f && yf <= (float)(H - 1);
  const int xi = xr ? (int)xf : 0;
  const int yi = yr ? (int)yf : 0;
  t.x0 = xi;
  t.y0 = yi;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int cx = xi + (k & 1);
    const int cy = yi + (k >> 1);
    const bool ok = xr && yr && cx >= 0 && cx < W && cy >= 0 && cy < H;
    t.off[k] = ok ? cy * W + cx : -1;
    t.w[k] = ok ? wxs[k & 1] * wys[k >> 1] : 0.f;
  }
  return t;
}

// The 4-tap sum over one plane of float or bf16 values, in f32.
template <typename T>
__device__ __forceinline__ float bilinear_sample(const T* __restrict__ plane, const BilinearTaps& t) {
  float v = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (t.off[k] >= 0) v += t.w[k] * elem::load(plane + t.off[k]);
  }
  return v;
}
