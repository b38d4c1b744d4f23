// Bilinear backward warp of a C-channel NCHW map by a pixel-unit flow, on
// the stride-s output grid, in float32 or bfloat16 (map, flow and output of
// one type):
//
//   out[b,c,oy,ox] = img[b,c] sampled at (s*ox + u, s*oy + v),  (u,v) = flow[b,:,oy,ox]
//
// bilinear, zeros outside the map (grid_sample align_corners=True), output
// [B, C, ceil(H/s), ceil(W/s)]. Replaces the TPU kernel
// piv_liteflownet_tpu/ops/pallas_feat_warp.py:feat_warp_pallas, and also
// covers the stride-2 form of ops/warp.py:backwarp that feeds the stride-2
// cost volume.
//
// Bound on an H100: bytes. At level 1 of a 1024^2 pair (C=64, stride 1) it
// reads the map and the flow once and writes the output once, ~545 MB, or
// ~163 us at 3.35 TB/s (half that in bf16); the arithmetic is 8 flops per
// output value.
//
// Design: one thread per output pixel computes the four corner offsets and
// weights once and loops over the channels, so a warp of threads reads
// neighbouring pixels of one channel plane at a time. The TPU kernel's tent
// windows, residual guard and gather fallback are gone: a direct 4-tap
// gather is exact for every flow.
//
// The bf16 form (pivk_backwarp_bf16) reads a bf16 map and flow, computes the
// coordinates, the weights and the 4-tap sum in f32 and rounds once to bf16 on
// store: half the bytes of the f32 form, the same arithmetic.

#include <cuda_runtime.h>

#include "bilinear.cuh"
#include "device_guard.cuh"

namespace {

constexpr int BLOCK = 256;

template <typename T>
__global__ void __launch_bounds__(BLOCK)
backwarp_kernel(const T* __restrict__ img, const T* __restrict__ flow,
                T* __restrict__ out, int B, int C, int H, int W,
                int Ho, int Wo, int stride) {
  const int idx = blockIdx.x * BLOCK + threadIdx.x;
  const int npix = Ho * Wo;
  if (idx >= B * npix) return;
  const int b = idx / npix;
  const int p = idx - b * npix;
  const int oy = p / Wo;
  const int ox = p - oy * Wo;

  const T* fb = flow + (size_t)b * 2 * npix;
  const float x = (float)(ox * stride) + elem::load(fb + p);
  const float y = (float)(oy * stride) + elem::load(fb + npix + p);
  const BilinearTaps t = bilinear_taps(x, y, H, W);

  const size_t plane = (size_t)H * W;
  const T* ib = img + (size_t)b * C * plane;
  T* obp = out + (size_t)b * C * npix + p;
  for (int c = 0; c < C; ++c) {
    elem::store(obp + (size_t)c * npix, bilinear_sample(ib + c * plane, t));
  }
}

template <typename T>
int launch(const void* img, const void* flow, void* out, int B, int C, int H, int W, int Ho, int Wo,
           int stride, int device, void* stream) {
  return pivk::on_device(device, [&] {
    const long long n = (long long)B * Ho * Wo;
    const dim3 grid((unsigned)((n + BLOCK - 1) / BLOCK));
    backwarp_kernel<T><<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
        (const T*)img, (const T*)flow, (T*)out, B, C, H, W, Ho, Wo, stride);
    return (int)cudaGetLastError();
  });
}

}  // namespace

extern "C" int pivk_backwarp_f32(const void* img, const void* flow, void* out,
                                 int B, int C, int H, int W, int Ho, int Wo,
                                 int stride, int device, void* stream) {
  return launch<float>(img, flow, out, B, C, H, W, Ho, Wo, stride, device, stream);
}

extern "C" int pivk_backwarp_bf16(const void* img, const void* flow, void* out,
                                  int B, int C, int H, int W, int Ho, int Wo,
                                  int stride, int device, void* stream) {
  return launch<elem::bf16>(img, flow, out, B, C, H, W, Ho, Wo, stride, device, stream);
}

extern "C" const char* pivk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
