// Bilinear backward warp of a C-channel NCHW map by a pixel-unit flow, on
// the stride-s output grid, in float32 or bfloat16 (map, flow and output of
// one type):
//
//   out[b,c,oy,ox] = img[b,c] sampled at (s*ox + u, s*oy + row0 + v),  (u,v) = flow[b,:,oy,ox]
//
// bilinear, zeros outside the map (grid_sample align_corners=True), output
// [B, C, Ho, ceil(W/s)]: the whole grid is Ho = ceil(H/s) rows and row0 = 0;
// a slab of an H-sharded map (ops/halo_warp.py) is a map taller than its
// output rows, which start at its row row0, an integer, so that the flow is
// never rebased (in bf16, v + 32 would round to a quarter pixel). The image
// is indexed by its own H and W in both forms. Replaces the TPU kernel
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
// store: the same arithmetic on half the bytes, ~272 MB or ~81 us at the
// shape above. Its first form, the loop above on 2-byte values, took 86 % of
// the f32 form's time (0.2364 against 0.2731 ms alone, H100 80GB HBM3 at
// 700 W, chip_smoke.py): each tap of each channel is a 2-byte gather, four
// per output value, and the gathers, not the bytes, set the rate. So the
// bf16 form stages instead (backwarp_staged_kernel): a block takes a tile of 32 x 8
// output pixels, a thread each, reduces the taps inside the map to the
// tile's footprint, and copies the footprint's rows of G channels at a time
// into shared memory with 16-byte cp.async (two stages, one in flight while
// the other is summed), from x rounded down to a multiple of 8; each thread
// then reads its four taps there. A channel costs ~0.2 copies and four
// shared loads a pixel instead of four gathers. A tile whose footprint has
// more than CHUNKS 16-byte chunks a channel (steep or incoherent flow), or a
// map whose rows are not 16-byte aligned (W % 8, or a tensor off 16 bytes),
// gathers directly, as the float32 form does, and adds one to *n_direct;
// ops/warp.py:staged_tiles mirrors the rule. The sums are the same, in the
// same order, as the float32 form's loop, so either path's output is
// bit-equal to that loop's on the same values. Measured (chip_smoke.py, H100
// 80GB HBM3 at 700 W) at [1,64,1024,1024]: 0.1545 ms alone with a smooth flow
// at stride 1, 53 % of the bound (the one-channel loop on bf16 0.2365 in the
// same call), 0.2474 with a random 8 px flow (0.45-0.46), 0.0772 at stride 2
// (0.1008); 58 registers, 32.9 KB of shared memory. tests/warp_variants.py
// times the choices of G and CHUNKS and the staging as a whole. The float32
// form keeps its loop; staging it, at twice the bytes a stage, was not tried.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "bilinear.cuh"
#include "device_guard.cuh"

namespace {

constexpr int BLOCK = 256;

// The float32 form.
__global__ void __launch_bounds__(BLOCK)
backwarp_kernel(const float* __restrict__ img, const float* __restrict__ flow,
                float* __restrict__ out, int B, int C, int H, int W,
                int Ho, int Wo, int stride, int row0) {
  const int idx = blockIdx.x * BLOCK + threadIdx.x;
  const int npix = Ho * Wo;
  if (idx >= B * npix) return;
  const int b = idx / npix;
  const int p = idx - b * npix;
  const int oy = p / Wo;
  const int ox = p - oy * Wo;

  const float* fb = flow + (size_t)b * 2 * npix;
  const float x = (float)(ox * stride) + elem::load(fb + p);
  const float y = (float)(oy * stride + row0) + elem::load(fb + npix + p);
  const BilinearTaps t = bilinear_taps(x, y, H, W);

  const size_t plane = (size_t)H * W;
  const float* ib = img + (size_t)b * C * plane;
  float* obp = out + (size_t)b * C * npix + p;
  for (int c = 0; c < C; ++c) {
    elem::store(obp + (size_t)c * npix, bilinear_sample(ib + c * plane, t));
  }
}

namespace stg {

using elem::bf16;

constexpr int TW = 32, TH = 8;  // an output tile, a pixel a thread; keep in step with ops/warp.py:STAGED_TILE
constexpr int G = 4;            // channels a stage
// 16-byte chunks of a channel's footprint that a stage holds; keep in step with ops/warp.py:STAGED_CHUNKS
constexpr int CHUNKS = 256;
constexpr int PER = (G * CHUNKS + BLOCK - 1) / BLOCK;  // chunks a thread copies a stage, at most
constexpr int NWARP = BLOCK / 32;
constexpr unsigned FULL = 0xffffffffu;
static_assert(TW * TH == BLOCK, "a pixel a thread");

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"((unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N));
}

// aligned: W % 8 == 0 and img 16-byte aligned, so that every row of a plane starts on 16 bytes
__global__ void __launch_bounds__(BLOCK)
backwarp_staged_kernel(const bf16* __restrict__ img, const bf16* __restrict__ flow, bf16* __restrict__ out,
              unsigned int* __restrict__ n_direct, int C, int H, int W, int Ho, int Wo, int stride,
              int row0, bool aligned) {
  __shared__ uint4 stage[2][G][CHUNKS];
  __shared__ int red[4][NWARP];
  const int tid = threadIdx.x, lane = tid % 32, wid = tid / 32;
  const int ox = blockIdx.x * TW + tid % TW, oy = blockIdx.y * TH + tid / TW, b = blockIdx.z;
  const bool live = ox < Wo && oy < Ho;
  const int npix = Ho * Wo, p = oy * Wo + ox;
  const bf16* fb = flow + (size_t)b * 2 * npix;
  // a pixel outside the output samples far outside the map: every tap out
  const BilinearTaps t = bilinear_taps(live ? (float)(ox * stride) + elem::load(fb + p) : -2.f,
                                       live ? (float)(oy * stride + row0) + elem::load(fb + npix + p) : -2.f,
                                       H, W);
  // the footprint: min x, -max x, min y, -max y of the tile's taps inside the map
  int m[4] = {INT_MAX, INT_MAX, INT_MAX, INT_MAX};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (t.off[k] >= 0) {
      const int cx = t.x0 + (k & 1), cy = t.y0 + (k >> 1);
      m[0] = min(m[0], cx);
      m[1] = min(m[1], -cx);
      m[2] = min(m[2], cy);
      m[3] = min(m[3], -cy);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int v = __reduce_min_sync(FULL, m[i]);
    if (lane == 0) red[i][wid] = v;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = red[i][0];
    for (int w2 = 1; w2 < NWARP; ++w2) m[i] = min(m[i], red[i][w2]);
  }
  const bool empty = m[0] == INT_MAX;  // no tap of the tile inside the map
  const int fx0 = empty ? 0 : m[0] & ~7, fy0 = empty ? 0 : m[2];
  const int ncw = empty ? 0 : (-m[1] - fx0) / 8 + 1;  // chunks a row
  const int n = empty ? 0 : ncw * (-m[3] - fy0 + 1);  // chunks a channel
  const size_t plane = (size_t)H * W;
  const bf16* ib = img + (size_t)b * C * plane;
  bf16* ob = out + (size_t)b * C * npix + p;
  if (!aligned || n > CHUNKS) {
    if (tid == 0) atomicAdd(n_direct, 1u);
    if (live)
      for (int c = 0; c < C; ++c) elem::store(ob + (size_t)c * npix, bilinear_sample(ib + c * plane, t));
    return;
  }
  // tap k in a staged channel: element (y - fy0) * 8 * ncw + x - fx0
  int off[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    off[k] = t.off[k] >= 0 ? (t.y0 + (k >> 1) - fy0) * 8 * ncw + t.x0 + (k & 1) - fx0 : -1;
  // this thread's chunks of a stage: channel g of the stage, source offset in its plane, place
  int cg[PER], csrc[PER], cdst[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int i = tid + j * BLOCK, g = i / max(n, 1), r = i - g * n, row = r / max(ncw, 1);
    cg[j] = i < G * n ? g : G;
    csrc[j] = (fy0 + row) * W + fx0 + 8 * (r - row * ncw);
    cdst[j] = g * CHUNKS + r;
  }
  auto issue = [&](int grp) {
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      if (cg[j] < G && grp * G + cg[j] < C)
        cp_async16(&stage[grp & 1][0][0] + cdst[j], ib + (size_t)(grp * G + cg[j]) * plane + csrc[j]);
    }
    cp_commit();
  };
  const int ngrp = (C + G - 1) / G;
  issue(0);
  for (int grp = 0; grp < ngrp; ++grp) {
    if (grp + 1 < ngrp) {
      issue(grp + 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    if (live) {
      const unsigned short* s16 = reinterpret_cast<const unsigned short*>(&stage[grp & 1][0][0]);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int c = grp * G + g;
        if (c < C) {
          float v = 0.f;  // bilinear_sample's sum, in its order
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if (off[k] >= 0) v += t.w[k] * __uint_as_float((uint32_t)s16[g * 8 * CHUNKS + off[k]] << 16);
          }
          elem::store(ob + (size_t)c * npix, v);
        }
      }
    }
    __syncthreads();  // the stage is read before the next but one group overwrites it
  }
}

}  // namespace stg

}  // namespace

extern "C" int pivk_backwarp_f32(const void* img, const void* flow, void* out,
                                 int B, int C, int H, int W, int Ho, int Wo,
                                 int stride, int row0, int device, void* stream) {
  return pivk::on_device(device, [&] {
    const long long n = (long long)B * Ho * Wo;
    backwarp_kernel<<<(unsigned)((n + BLOCK - 1) / BLOCK), BLOCK, 0, (cudaStream_t)stream>>>(
        (const float*)img, (const float*)flow, (float*)out, B, C, H, W, Ho, Wo, stride, row0);
    return (int)cudaGetLastError();
  });
}

// The bf16 form takes, after out, n_direct: one unsigned int on the device, to which every tile
// that gathers directly adds one (the caller zeroes it when it wants a count).
extern "C" int pivk_backwarp_bf16(const void* img, const void* flow, void* out, void* n_direct,
                                  int B, int C, int H, int W, int Ho, int Wo,
                                  int stride, int row0, int device, void* stream) {
  return pivk::on_device(device, [&] {
    const bool aligned = W % 8 == 0 && reinterpret_cast<uintptr_t>(img) % 16 == 0;
    const dim3 grid((unsigned)((Wo + stg::TW - 1) / stg::TW), (unsigned)((Ho + stg::TH - 1) / stg::TH),
                    (unsigned)B);
    stg::backwarp_staged_kernel<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
        (const elem::bf16*)img, (const elem::bf16*)flow, (elem::bf16*)out, (unsigned int*)n_direct, C, H, W,
        Ho, Wo, stride, row0, aligned);
    return (int)cudaGetLastError();
  });
}

extern "C" const char* pivk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
