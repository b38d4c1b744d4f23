// Backward of the bilinear backward warp (csrc/backwarp.cu), f32 NCHW:
// given gout = dL/dout [B, C, Ho, Wo] it gives, in one launch,
//
//   g_img[b,c]            = sum over output pixels of gout * (their 4 tap weights),
//                           scattered onto the 4 taps each pixel read;
//   g_flow[b,0|1,oy,ox]   = sum_c gout[b,c,oy,ox] * d(bilinear sample)/d(u|v).
//
// A tap outside the map reads zero and gets nothing; floor() has zero
// derivative, so d/du of the weights (1-wx, wx) is (-1, +1), as under JAX
// autodiff of piv_liteflownet_tpu/ops/warp.py:backwarp. Strides 1 and 2:
// the sample point is (s*ox + u, s*oy + v), so g_flow lives on the output
// grid and g_img lands only on the taps near the stride-s points.
//
// Replaces the TPU kernel piv_liteflownet_tpu/ops/pallas_warp_vjp.py:
// warp_img_grad_pallas (the image gradient, there a tent-window gather over
// the adjoint, stride 1 only, exact only within its flow bounds, with an XLA
// scatter as fallback) and the XLA flow gradient beside it. Here both are
// exact for every flow and both strides.
//
// Bound on an H100: bytes. At the level-1 NetE-S warp of a 256^2 batch-8
// training step (C=64) it reads img, gout and the flow once and writes
// g_img and g_flow once, ~411 MB, or ~123 us at 3.35 TB/s; ~20 flops per
// value.
//
// Design: one thread per output pixel computes its four taps once, loops
// over the channels, reads gout and the four img taps of each channel,
// accumulates the flow gradient in two registers and adds its four weighted
// taps into g_img with atomics (a warp's threads hit neighbouring addresses
// of one channel plane). The atomics make the summation order, and so the
// last bits of g_img, vary from run to run (about 1e-7 relative). g_img is
// zeroed with cudaMemsetAsync on the same stream first.

#include <cuda_runtime.h>

#include "bilinear.cuh"

namespace {

constexpr int BLOCK = 256;

__global__ void __launch_bounds__(BLOCK)
backwarp_bwd_kernel(const float* __restrict__ img, const float* __restrict__ flow,
                    const float* __restrict__ gout, float* __restrict__ g_img,
                    float* __restrict__ g_flow, int B, int C, int H, int W,
                    int Ho, int Wo, int stride) {
  const int idx = blockIdx.x * BLOCK + threadIdx.x;
  const int npix = Ho * Wo;
  if (idx >= B * npix) return;
  const int b = idx / npix;
  const int p = idx - b * npix;
  const int oy = p / Wo;
  const int ox = p - oy * Wo;

  const float* fb = flow + (size_t)b * 2 * npix;
  const float x = (float)(ox * stride) + fb[p];
  const float y = (float)(oy * stride) + fb[npix + p];
  const BilinearTaps t = bilinear_taps(x, y, H, W);

  // d(weight of tap k)/dx and /dy; zero for a tap outside the map
  const float wxs[2] = {1.f - t.wx, t.wx};
  const float wys[2] = {1.f - t.wy, t.wy};
  float dwx[4], dwy[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const bool ok = t.off[k] >= 0;
    dwx[k] = ok ? ((k & 1) ? wys[k >> 1] : -wys[k >> 1]) : 0.f;
    dwy[k] = ok ? ((k >> 1) ? wxs[k & 1] : -wxs[k & 1]) : 0.f;
  }

  const size_t plane = (size_t)H * W;
  const float* ib = img + (size_t)b * C * plane;
  float* gib = g_img + (size_t)b * C * plane;
  const float* gb = gout + (size_t)b * C * npix + p;
  float gu = 0.f, gv = 0.f;
  for (int c = 0; c < C; ++c) {
    const float g = __ldg(gb + (size_t)c * npix);
    const float* pl = ib + c * plane;
    float* gpl = gib + c * plane;
    float du = 0.f, dv = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (t.off[k] >= 0) {
        const float v = __ldg(pl + t.off[k]);
        du += dwx[k] * v;
        dv += dwy[k] * v;
        atomicAdd(gpl + t.off[k], t.w[k] * g);
      }
    }
    gu += g * du;
    gv += g * dv;
  }
  float* gfb = g_flow + (size_t)b * 2 * npix;
  gfb[p] = gu;
  gfb[npix + p] = gv;
}

}  // namespace

extern "C" int pivk_backwarp_bwd_f32(const void* img, const void* flow, const void* gout,
                                     void* g_img, void* g_flow, int B, int C, int H, int W,
                                     int Ho, int Wo, int stride, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(g_img, 0, (size_t)B * C * H * W * sizeof(float), (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  const long long n = (long long)B * Ho * Wo;
  const dim3 grid((unsigned)((n + BLOCK - 1) / BLOCK));
  backwarp_bwd_kernel<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
      (const float*)img, (const float*)flow, (const float*)gout, (float*)g_img,
      (float*)g_flow, B, C, H, W, Ho, Wo, stride);
  return (int)cudaGetLastError();
}
