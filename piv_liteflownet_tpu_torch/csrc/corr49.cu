// 49-tap (7x7) cost volume on phase-subsampled feature maps, f32, NCHW.
//
//   out[b, (dy+3)*7 + dx+3, y, x] = (1/C) * sum_c f1[b,c,y,x] * f2[b,c,y+dy,x+dx]
//
// with f2 read as zero outside the map. Replaces the TPU kernels
// piv_liteflownet_tpu/ops/pallas_corr.py:correlation_pallas and
// :correlation_planar_pallas (same function, two TPU layouts). The stride-2
// subsample and the following leaky_relu stay with the caller.
//
// Bound on an H100: bytes. At level 1 of a 1024^2 pair (C=64, 512^2) the two
// inputs and the output move ~186 MB against ~1.6 GFLOP, so memory time
// (~55 us at 3.35 TB/s) is above the f32 FMA time (~25 us at 67 TFLOP/s).
//
// Design: one thread per output pixel holds the 49 sums in registers and
// loops over the channels. A block covers a 32x8 pixel tile; for each group
// of CC channels it stages the f2 tile plus its 3-pixel halo in shared
// memory, so f2 is read from device memory about (38*14)/(32*8) ~ 2.1 times
// instead of 49 times, and f1 and the output once each.

#include <cuda_runtime.h>

namespace {

constexpr int MD = 3;
constexpr int ND = 2 * MD + 1;  // 7
constexpr int TX = 32;
constexpr int TY = 8;
constexpr int CC = 8;           // channels staged per pass
constexpr int SW = TX + 2 * MD;
constexpr int SH = TY + 2 * MD;

__global__ void __launch_bounds__(TX * TY)
corr49_kernel(const float* __restrict__ f1, const float* __restrict__ f2,
              float* __restrict__ out, int C, int H, int W, float inv_c) {
  __shared__ float tile[CC][SH][SW];

  const int b = blockIdx.z;
  const int x0 = blockIdx.x * TX;
  const int y0 = blockIdx.y * TY;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * TX + tx;
  const int x = x0 + tx;
  const int y = y0 + ty;
  const bool inside = x < W && y < H;

  const size_t plane = (size_t)H * W;
  const float* f1b = f1 + (size_t)b * C * plane;
  const float* f2b = f2 + (size_t)b * C * plane;

  float acc[ND * ND];
#pragma unroll
  for (int d = 0; d < ND * ND; ++d) acc[d] = 0.f;

  for (int c0 = 0; c0 < C; c0 += CC) {
    for (int i = tid; i < CC * SH * SW; i += TX * TY) {
      const int cc = i / (SH * SW);
      const int r = (i / SW) % SH;
      const int s = i % SW;
      const int gc = c0 + cc;
      const int gy = y0 - MD + r;
      const int gx = x0 - MD + s;
      float v = 0.f;
      if (gc < C && gy >= 0 && gy < H && gx >= 0 && gx < W)
        v = __ldg(f2b + gc * plane + (size_t)gy * W + gx);
      tile[cc][r][s] = v;
    }
    __syncthreads();

    const int cn = min(CC, C - c0);
    for (int cc = 0; cc < cn; ++cc) {
      const float a = inside ? __ldg(f1b + (c0 + cc) * plane + (size_t)y * W + x) : 0.f;
#pragma unroll
      for (int dy = 0; dy < ND; ++dy) {
#pragma unroll
        for (int dx = 0; dx < ND; ++dx) {
          acc[dy * ND + dx] += a * tile[cc][ty + dy][tx + dx];
        }
      }
    }
    __syncthreads();
  }

  if (!inside) return;
  float* ob = out + (size_t)b * ND * ND * plane + (size_t)y * W + x;
#pragma unroll
  for (int d = 0; d < ND * ND; ++d) ob[d * plane] = acc[d] * inv_c;
}

}  // namespace

extern "C" int pivk_corr49_f32(const void* f1, const void* f2, void* out,
                               int B, int C, int H, int W, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 block(TX, TY);
  const dim3 grid((W + TX - 1) / TX, (H + TY - 1) / TY, B);
  corr49_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)f1, (const float*)f2, (float*)out, C, H, W, 1.0f / (float)C);
  return (int)cudaGetLastError();
}
