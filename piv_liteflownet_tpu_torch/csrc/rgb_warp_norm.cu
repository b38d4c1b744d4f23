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
// Design: a 2-D grid (column tiles x row bands x batch), no division a
// pixel. A warp takes 32 J pixels of one row, a lane J of them, 32 apart
// (lane + 32 j), so that each load of the warp, direct or gathered, reads
// neighbouring addresses; a block takes WARPS rows. A lane issues all its
// flow and img1 loads, then all its 12 J img2 gathers (three planes, four
// taps), then sums: J pixels in flight a lane. Maps of at least
// LANES2_MIN_PIXELS pixels take J = 2 (64 registers, 4 blocks an SM); smaller
// ones J = 1 (54-55 registers), where two pixels a lane left too few lanes busy.
// No tent tiers or guard: the direct gather is exact for every flow.
//
// Measured (tests/rgb_warp_variants.py, H100 80GB HBM3 at 700 W; ms, f32 /
// bf16). Alone after an L2 flush at [1,3,1024,1024], smooth flow: 0.0256 /
// 0.0229, the first form (a pixel a thread on a 1-D grid, two divisions a
// pixel, its gathers behind its own flow loads) 0.0287 / 0.0230; random
// 8 px flow 0.0307 / 0.0251 against 0.0368 / 0.0290. With the L2 warm, as
// estimate finds the inputs, the six levels of a 1024^2 pair: 0.0272 /
// 0.0251 against 0.0307 / 0.0261. Staging did not pay for three planes (a
// footprint serves 3 planes here, not 64). The script times against this
// kernel, alone and smooth / random / warm over the six levels: each tile's
// footprint staged by cp.async once its flow is known, 0.0263 / 0.0290 /
// 0.0344 in f32 (bf16 0.0268 / 0.0280 / 0.0345); a window of img2 rows
// within 8 pixels of a tile staged before its flow is known, one trip to
// memory, 0.0258 / 0.0258 / 0.0432 (0.0243 / 0.0247 / 0.0447); 16-byte
// loads of adjacent pixels, 0.0252 / 0.0328 / 0.0303 (0.0303 / 0.0386 /
// 0.0438); persistent lanes, 0.0247 / 0.0355 / 0.0323 (0.0267 / 0.0306 /
// 0.0368); this kernel with an L2 prefetch of img2 at each pixel's row
// before its flow loads, 0.0265 / 0.0312 / 0.0282 (0.0256 / 0.0275 /
// 0.0266). The two staged forms win alone with a random flow in f32 (the
// window in bf16 too) but lose warm, where their fixed cost a block
// outweighs them at the smaller levels.
//
// Each pixel's arithmetic is the first form's, in its order (taps in k
// order, channels 0..2, then sqrtf), so the output is bit-equal to it.
//
// The bf16 form (pivk_rgb_warp_norm_bf16) reads bf16 images and flow, keeps
// the warp and the squared sum in f32 and rounds the norm once to bf16 on
// store (the TPU kernel's f32 accumulators, output in img1's dtype).

#include <cuda_runtime.h>

#include "bilinear.cuh"
#include "device_guard.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int BLOCK = 32 * WARPS;
// Pixels (B * H * W) from which a lane takes two; keep in step with ops/rgb_warp.py:LANES2_MIN_PIXELS.
constexpr long long LANES2_MIN_PIXELS = 1 << 17;

template <typename T, int J>
__global__ void __launch_bounds__(BLOCK, 4)
rgb_warp_norm_lanes_kernel(const T* __restrict__ img1, const T* __restrict__ img2, const T* __restrict__ flow,
                           T* __restrict__ out, int H, int W) {
  const int y = blockIdx.y * WARPS + threadIdx.x / 32;
  if (y >= H) return;
  const size_t npix = (size_t)H * W, b = blockIdx.z, row = (size_t)y * W;
  const int x0 = blockIdx.x * 32 * J + threadIdx.x % 32;
  const T* f = flow + 2 * b * npix + row;
  const T* i1 = img1 + 3 * b * npix + row;
  const T* i2 = img2 + 3 * b * npix;
  float u[J], v[J], a[3][J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int x = x0 + 32 * j;
    const bool in = x < W;
    u[j] = in ? elem::load(f + x) : 0.f;
    v[j] = in ? elem::load(f + npix + x) : 0.f;
#pragma unroll
    for (int c = 0; c < 3; ++c) a[c][j] = in ? elem::load(i1 + c * npix + x) : 0.f;
  }
  int off[J][4];
  float w[J][4], g[3][J][4];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int x = x0 + 32 * j;
    const BilinearTaps t = bilinear_taps((float)x + u[j], (float)y + v[j], H, W);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      off[j][k] = x < W ? t.off[k] : -1;
      w[j][k] = t.w[k];
    }
  }
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
      for (int k = 0; k < 4; ++k) g[c][j][k] = off[j][k] >= 0 ? elem::load(i2 + c * npix + off[j][k]) : 0.f;
  T* o = out + b * npix + row;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    float sq = 0.f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float s = 0.f;  // bilinear_sample's sum, in its order
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (off[j][k] >= 0) s += w[j][k] * g[c][j][k];
      }
      const float d = a[c][j] - s;
      sq += d * d;
    }
    const int x = x0 + 32 * j;
    if (x < W) elem::store(o + x, sqrtf(sq));
  }
}

template <typename T, int J>
void launch_lanes(const void* img1, const void* img2, const void* flow, void* out, int B, int H, int W,
                  cudaStream_t stream) {
  const dim3 grid((unsigned)((W + 32 * J - 1) / (32 * J)), (unsigned)((H + WARPS - 1) / WARPS), (unsigned)B);
  rgb_warp_norm_lanes_kernel<T, J><<<grid, BLOCK, 0, stream>>>((const T*)img1, (const T*)img2, (const T*)flow,
                                                               (T*)out, H, W);
}

template <typename T>
int launch(const void* img1, const void* img2, const void* flow, void* out, int B, int H, int W, int device,
           void* stream) {
  return pivk::on_device(device, [&] {
    if ((long long)B * H * W >= LANES2_MIN_PIXELS)
      launch_lanes<T, 2>(img1, img2, flow, out, B, H, W, (cudaStream_t)stream);
    else
      launch_lanes<T, 1>(img1, img2, flow, out, B, H, W, (cudaStream_t)stream);
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
