// Fused rgb backward warp + occlusion norm, NCHW, in float32 or bfloat16
// (images, flow and output of one type):
//
//   out[b,0,y,x] = sqrt( sum_{c<3} (img1[b,c,y,x] - warp(img2, flow)[b,c,y,x])^2 )
//
// where warp samples img2 bilinearly at (x + u, y + v), zeros outside
// (grid_sample align_corners=True). The warped rgb is never stored.
// Replaces the TPU kernel
// piv_liteflownet_tpu/ops/pallas_rgb_warp.py:rgb_warp_norm_pallas and its
// guarded form rgb_warp_norm (exact result: rgb_warp_norm_gather).
//
// Bound on an H100: bytes. At 1024^2 it reads two rgb images and the flow
// and writes one plane, ~37.7 MB, or ~11 us at 3.35 TB/s (half that in bf16).
//
// Design: one thread per pixel computes the four taps once, gathers the
// three img2 planes with them and reduces the norm in registers. No tent
// tiers or guard: the direct gather is exact for every flow.
//
// The bf16 form (pivk_rgb_warp_norm_bf16) reads bf16 images and flow, keeps
// the warp and the squared sum in f32 and rounds the norm once to bf16 on
// store (the TPU kernel's f32 accumulators, output in img1's dtype).

#include <cuda_runtime.h>

#include "bilinear.cuh"
#include "device_guard.cuh"

namespace {

constexpr int BLOCK = 256;

template <typename T>
__global__ void __launch_bounds__(BLOCK)
rgb_warp_norm_kernel(const T* __restrict__ img1, const T* __restrict__ img2,
                     const T* __restrict__ flow, T* __restrict__ out,
                     int B, int H, int W) {
  const int idx = blockIdx.x * BLOCK + threadIdx.x;
  const int npix = H * W;
  if (idx >= B * npix) return;
  const int b = idx / npix;
  const int p = idx - b * npix;
  const int y = p / W;
  const int x = p - y * W;

  const T* fb = flow + (size_t)b * 2 * npix;
  const BilinearTaps t =
      bilinear_taps((float)x + elem::load(fb + p), (float)y + elem::load(fb + npix + p), H, W);

  const T* i1 = img1 + (size_t)b * 3 * npix;
  const T* i2 = img2 + (size_t)b * 3 * npix;
  float sq = 0.f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float d = elem::load(i1 + c * npix + p) - bilinear_sample(i2 + c * npix, t);
    sq += d * d;
  }
  elem::store(out + (size_t)b * npix + p, sqrtf(sq));
}

template <typename T>
int launch(const void* img1, const void* img2, const void* flow, void* out, int B, int H, int W,
           int device, void* stream) {
  return pivk::on_device(device, [&] {
    const long long n = (long long)B * H * W;
    const dim3 grid((unsigned)((n + BLOCK - 1) / BLOCK));
    rgb_warp_norm_kernel<T><<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
        (const T*)img1, (const T*)img2, (const T*)flow, (T*)out, B, H, W);
    return (int)cudaGetLastError();
  });
}

}  // namespace

extern "C" int pivk_rgb_warp_norm_f32(const void* img1, const void* img2,
                                      const void* flow, void* out,
                                      int B, int H, int W, int device,
                                      void* stream) {
  return launch<float>(img1, img2, flow, out, B, H, W, device, stream);
}

extern "C" int pivk_rgb_warp_norm_bf16(const void* img1, const void* img2,
                                       const void* flow, void* out,
                                       int B, int H, int W, int device,
                                       void* stream) {
  return launch<elem::bf16>(img1, img2, flow, out, B, H, W, device, stream);
}
