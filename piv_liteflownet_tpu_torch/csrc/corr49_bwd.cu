// Backward of the 49-tap cost volume (csrc/corr49.cu), f32 NCHW: given
// g = dL/dout [B, 49, H, W] it gives, in one launch,
//
//   g_f1[b,c,y,x] = (1/C) sum_d g[b,d,y,x]       * f2[b,c,y+dy,x+dx]
//   g_f2[b,c,y,x] = (1/C) sum_d g[b,d,y-dy,x-dx] * f1[b,c,y-dy,x-dx]
//
// with d = (dy+3)*7 + dx+3 and every read outside the map zero. Both are
// gathers, so the result is the same from run to run. The TPU package has
// no kernel here: JAX computes this as the XLA VJP of the shift-stack in
// piv_liteflownet_tpu/ops/correlation.py:correlation_xla. The port needs
// one because its forward is a kernel.
//
// Bound on an H100: bytes. At level 1 of a 256^2 batch-8 training step
// (C=64, maps 128^2) it reads f1, f2 and g once and writes g_f1 and g_f2
// once, ~160 MB, or ~48 us at 3.35 TB/s, against ~1.6 GFLOP (~24 us at
// 67 TFLOP/s).
//
// Design: the forward's, run twice over (blockIdx.z picks the output). One
// thread per pixel loads its 49 g values into registers once; for g_f2 it
// loads g at the 49 mirrored positions, in the mirrored order, so that both
// outputs read the staged map at (ty+ey, tx+ex). A block covers a 32x8
// pixel tile and, per group of CC channels, stages the other map's tile plus
// its 3-pixel halo in shared memory; each thread then writes one output
// value per channel from 49 multiply-adds.

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
corr49_bwd_kernel(const float* __restrict__ f1, const float* __restrict__ f2,
                  const float* __restrict__ g, float* __restrict__ g_f1,
                  float* __restrict__ g_f2, int B, int C, int H, int W, float inv_c) {
  __shared__ float tile[CC][SH][SW];

  const bool second = (int)blockIdx.z >= B;  // false: g_f1 from f2; true: g_f2 from f1
  const int b = second ? (int)blockIdx.z - B : (int)blockIdx.z;
  const int x0 = blockIdx.x * TX;
  const int y0 = blockIdx.y * TY;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * TX + tx;
  const int x = x0 + tx;
  const int y = y0 + ty;
  const bool inside = x < W && y < H;

  const size_t plane = (size_t)H * W;
  const float* src = (second ? f1 : f2) + (size_t)b * C * plane;
  float* dst = (second ? g_f2 : g_f1) + (size_t)b * C * plane;
  const float* gb = g + (size_t)b * ND * ND * plane;

  // gr[ey*7+ex] multiplies the staged map at (y+ey-3, x+ex-3)
  float gr[ND * ND];
#pragma unroll
  for (int ey = 0; ey < ND; ++ey) {
#pragma unroll
    for (int ex = 0; ex < ND; ++ex) {
      const int e = ey * ND + ex;
      float v = 0.f;
      if (!second) {
        if (inside) v = __ldg(gb + e * plane + (size_t)y * W + x);
      } else {
        const int sy = y + ey - MD;
        const int sx = x + ex - MD;
        if (inside && sy >= 0 && sy < H && sx >= 0 && sx < W)
          v = __ldg(gb + (ND * ND - 1 - e) * plane + (size_t)sy * W + sx);
      }
      gr[e] = v * inv_c;
    }
  }

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
        v = __ldg(src + gc * plane + (size_t)gy * W + gx);
      tile[cc][r][s] = v;
    }
    __syncthreads();

    const int cn = min(CC, C - c0);
    if (inside) {
      for (int cc = 0; cc < cn; ++cc) {
        float acc = 0.f;
#pragma unroll
        for (int ey = 0; ey < ND; ++ey) {
#pragma unroll
          for (int ex = 0; ex < ND; ++ex) {
            acc += gr[ey * ND + ex] * tile[cc][ty + ey][tx + ex];
          }
        }
        dst[(c0 + cc) * plane + (size_t)y * W + x] = acc;
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int pivk_corr49_bwd_f32(const void* f1, const void* f2, const void* g,
                                   void* g_f1, void* g_f2, int B, int C, int H, int W,
                                   int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 block(TX, TY);
  const dim3 grid((W + TX - 1) / TX, (H + TY - 1) / TY, 2 * B);
  corr49_bwd_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)f1, (const float*)f2, (const float*)g, (float*)g_f1, (float*)g_f2,
      B, C, H, W, 1.0f / (float)C);
  return (int)cudaGetLastError();
}
