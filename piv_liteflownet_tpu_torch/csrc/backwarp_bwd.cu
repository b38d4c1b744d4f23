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
// Replaces the TPU kernel piv_liteflownet_tpu/ops/pallas_warp_vjp.py:119
// warp_img_grad_pallas (the image gradient) and the XLA flow gradient beside
// it (make_backwarp_tvjp, :239). The TPU kernel gathers over the adjoint
// through a tent window: exact only within warp_img_grad_bounds_ok, with an
// XLA scatter as the fallback (:268-276), and stride 1 only. A gather pays
// (2r+3)^2 taps per element for a flow residual r, and still needs the
// fallback; this card has fast atomics, so both paths here scatter, and
// both are exact for every flow and both strides.
//
// Bound on an H100: bytes. At the level-1 NetE-S warp of a 256^2 batch-8
// training step (C=64) it must read img, gout and the flow once and write
// g_img and g_flow once, ~411 MB, or ~123 us at 3.35 TB/s; ~24 flops per
// value. A scatter with one global atomic per tap, channel and pixel (the
// first version of this kernel) makes 4 float reductions in L2 per value of
// gout, 134 M at that shape.
//
// Design. Each warp takes a tile of 32 neighbouring output pixels of one
// row, a lane each, and computes each pixel's taps and weights once. The warp
// reduces the taps inside the map to their bounding box, the footprint,
// whose x origin is rounded down to a multiple of 4. Where the footprint's
// rows times its float4 columns fit the warp's window in shared memory
// (CAP), the warp scatters into that window, one channel at a time, then
// flushes the used part to g_img with one 16-byte global reduction (atomicAdd
// on float4, sm_90) per 4 elements, skipping all-zero vectors, and zeroes it:
// under one vector reduction per value of gout for a smooth flow at stride
// 1 (2-3 rows of 9-10 float4 per 32 pixels), instead of 4 scalar ones.
// Float atomics on shared memory are a compare-and-swap loop on this card,
// so the scatter uses none: the window is the warp's alone, and lanes whose
// taps meet in one element take turns. Which lanes meet depends only on the
// flow, so the turns (__match_any_sync, the rank in the group) are worked
// out once per tile and hold for every channel; where no two lanes meet (the
// common case) each tap is one add. A tile whose footprint does not fit
// (steep or incoherent flow) scatters every tap with a global atomic
// instead, and adds one to *n_global so that a caller can see how many tiles
// took that path. The rule is mirrored line for line by
// ops/warp.py:tile_windows.
//
// The work per channel is short and runs in turn, so the kernel is bound by
// the warps an SM keeps in flight and the instructions a channel costs, not
// by staging depth: measured on an H100, staging img and gout through
// cp.async rings, taller tiles, and more stages were all slower than one-row
// tiles with small windows, 8 blocks of 4 warps per SM, gout and the four img
// taps of the next channel loaded into registers (__ldg) while the current
// one is scattered and flushed, pointers stepped from channel to channel,
// and a single pass for the scatter (no lanes meet) and the flush (at most
// 32 float4 used), the common case.
// g_flow is summed in registers over all channels in channel order and
// written once without atomics, so it is deterministic; g_img is not, in its
// last bits (reductions in a varying order). g_img is zeroed with
// cudaMemsetAsync on the same stream first: the footprints of neighbouring
// tiles overlap, so every element is a sum of reductions, and an element
// that no tap reaches stays zero.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "bilinear.cuh"
#include "device_guard.cuh"

namespace {

constexpr int TILE_W = 32;  // a tile: 32 neighbouring output pixels of one row, a lane each
constexpr int WARPS = 4;    // tiles per block, on consecutive rows
constexpr int NT = 32 * WARPS;
// float4 in a warp's window: the footprint's rows times its float4 columns
// must not exceed it. Keep in step with ops/warp.py:WINDOW_VEC4.
constexpr int CAP = 352;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int tap_delta(int k, int row) { return (k & 1) + (k >> 1) * row; }

template <int S>
__global__ void __launch_bounds__(NT, 8)
backwarp_bwd_kernel(const float* __restrict__ img, const float* __restrict__ flow,
                    const float* __restrict__ gout, float* __restrict__ g_img,
                    float* __restrict__ g_flow, unsigned int* __restrict__ n_global,
                    int C, int H, int W, int Ho, int Wo, bool vec4) {
  __shared__ float4 windows[WARPS][CAP];

  const int lane = threadIdx.x % 32, wid = threadIdx.x / 32;
  const int b = blockIdx.z;
  const int ox = blockIdx.x * TILE_W + lane;
  const int oy = blockIdx.y * WARPS + wid;
  if (oy >= Ho) return;  // a tile below the map (the last block's rows)
  const bool live = ox < Wo;
  const int npix = Ho * Wo;
  const int p = oy * Wo + ox;
  const float* fb = flow + (size_t)b * 2 * npix;
  // a lane past the right edge samples far outside the map: every tap out
  const BilinearTaps t = bilinear_taps(live ? (float)(ox * S) + fb[p] : -2.f,
                                       live ? (float)(oy * S) + fb[npix + p] : -2.f, H, W);
  unsigned in = 0;  // bit k: tap k lies inside the map
  int m[4] = {INT_MAX, INT_MAX, INT_MAX, INT_MAX};  // min x, -max x, min y, -max y
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (t.off[k] >= 0) {
      in |= 1u << k;
      const int cx = t.x0 + (k & 1), cy = t.y0 + (k >> 1);
      m[0] = min(m[0], cx);
      m[1] = min(m[1], -cx);
      m[2] = min(m[2], cy);
      m[3] = min(m[3], -cy);
    }
  }
  // the tile's footprint, and whether it fits the window
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = __reduce_min_sync(FULL, m[i]);
  const bool empty = m[0] == INT_MAX;  // no tap of the tile inside the map
  const int wx0 = m[0] & ~3, xmax = -m[1], wy0 = m[2], ymax = -m[3];
  const int nvx = empty ? 0 : ((xmax - wx0) >> 2) + 1;  // float4 columns used
  const int nrows = empty ? 0 : ymax - wy0 + 1;
  const bool fits = nvx * nrows <= CAP;  // an empty footprint fits

  // tap k lies at corner + tap_delta(k, W) in a plane (read only where it is inside)
  const int corner = in ? t.y0 * W + t.x0 : 0;
  const float wx = in ? t.wx : 0.f, wy = in ? t.wy : 0.f;  // finite where no tap reads
  float w[4];  // the taps' weights
#pragma unroll
  for (int k = 0; k < 4; ++k) w[k] = (k & 1 ? wx : 1.f - wx) * (k >> 1 ? wy : 1.f - wy);

  const size_t plane = (size_t)H * W;
  float* gib = g_img + (size_t)b * C * plane;
  // gout and the four taps (zero outside the map) of the next channel, loaded while the
  // current one is scattered; the pointers step through the channels
  const float* gnext = gout + (size_t)b * C * npix + p;
  const float* inext = img + (size_t)b * C * plane + corner;
  float g_next = 0.f, v_next[4];
  auto load = [&](bool go) {
    g_next = go && live ? __ldg(gnext) : 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      v_next[k] = go && (in & (1u << k)) ? __ldg(inext + tap_delta(k, W)) : 0.f;
    gnext += npix;
    inext += plane;
  };
  // takes channel c's values, loads channel c + 1's, and adds gout * dsample/d(u, v)
  float gu = 0.f, gv = 0.f;
  auto step = [&](int c) {
    const float g = g_next;
    const float v0 = v_next[0], v1 = v_next[1], v2 = v_next[2], v3 = v_next[3];
    load(c + 1 < C);
    // d/dx of the sample is (1-wy)(v1-v0) + wy(v3-v2); d/dy is (1-wx)(v2-v0) + wx(v3-v1)
    const float dx0 = v1 - v0, dy0 = v2 - v0;
    gu += g * (dx0 + wy * ((v3 - v2) - dx0));
    gv += g * (dy0 + wx * ((v3 - v1) - dy0));
    return g;
  };

  load(C > 0);
  if (!fits) {
    // out of the window: every tap of every channel is a global atomic
    if (lane == 0) atomicAdd(n_global, 1u);
    float* gpl = gib + corner;
    for (int c = 0; c < C; ++c, gpl += plane) {
      const float g = step(c);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (in & (1u << k)) atomicAdd(gpl + tap_delta(k, W), w[k] * g);
    }
  } else {
    float4* win4 = windows[wid];
    float* win = reinterpret_cast<float*>(win4);
    const int rs = 4 * nvx;  // the window's row in floats
    const int wbase = (t.y0 - wy0) * rs + (t.x0 - wx0);  // the corner in the window
    // lanes whose tap k meets another lane's in one element take turns by rank in
    // their group: 5 bits per tap for this lane's turn and for the warp's last turn
    const unsigned lower = (1u << lane) - 1u;
    unsigned mine = 0, last = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const bool ok = in & (1u << k);
      const unsigned group = __match_any_sync(FULL, ok ? wbase + tap_delta(k, rs) : -1 - lane);
      const unsigned rank = __popc(group & lower);
      mine |= rank << (5 * k);
      last |= __reduce_max_sync(FULL, ok ? rank : 0u) << (5 * k);
    }
    // the used part of the window: n float4, row-major over nvx columns; where it is no
    // more than a warp's worth (the common case), lane i flushes element i, at (row1, col1)
    const int n = nrows * nvx;
    const int row1 = n ? lane / nvx : 0, col1 = lane - row1 * nvx;
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int i = lane; i < n; i += 32) win4[i] = zero;
    __syncwarp();
    float* gwin = gib + (size_t)wy0 * W + wx0;  // the window's origin in channel c
    // adds element i of the window, at (row, col), to g_img and zeroes it
    auto flush = [&](int i, int row, int col) {
      const float4 v = win4[i];
      win4[i] = zero;
      if (v.x == 0.f && v.y == 0.f && v.z == 0.f && v.w == 0.f) return;
      float* dst = gwin + (size_t)row * W + 4 * col;
      if (vec4) {
        atomicAdd(reinterpret_cast<float4*>(dst), v);
      } else {
        // W % 4 != 0: scalar reductions; columns past xmax (and past W) hold zeros
        if (v.x != 0.f) atomicAdd(dst, v.x);
        if (v.y != 0.f) atomicAdd(dst + 1, v.y);
        if (v.z != 0.f) atomicAdd(dst + 2, v.z);
        if (v.w != 0.f) atomicAdd(dst + 3, v.w);
      }
    };
    for (int c = 0; c < C; ++c, gwin += plane) {
      const float g = step(c);
      if (last == 0) {  // no two lanes meet in one element of a tap: one pass (the common case)
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (in & (1u << k)) win[wbase + tap_delta(k, rs)] += w[k] * g;
          __syncwarp();  // tap k of one lane can be tap k' of another: the adds stay in order
        }
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const bool ok = in & (1u << k);
          const unsigned turn = (mine >> (5 * k)) & 31u;
          const unsigned turns = (last >> (5 * k)) & 31u;  // the same in every lane
          float* cell = win + wbase + tap_delta(k, rs);
          const float val = w[k] * g;
          for (unsigned q = 0; q <= turns; ++q) {
            if (ok && turn == q) *cell += val;
            __syncwarp();
          }
        }
      }
      // flush the window into g_img, row by row over the used columns, and zero it
      if (n <= 32) {
        if (lane < n) flush(lane, row1, col1);
      } else {
        int row = row1, col = col1;
        for (int i = lane; i < n; i += 32) {
          flush(i, row, col);
          col += 32;
          while (col >= nvx) {
            col -= nvx;
            ++row;
          }
        }
      }
      __syncwarp();
    }
  }
  if (live) {
    float* gfb = g_flow + (size_t)b * 2 * npix;
    gfb[p] = gu;
    gfb[npix + p] = gv;
  }
}

template <int S>
cudaError_t launch(const float* img, const float* flow, const float* gout, float* g_img,
                   float* g_flow, unsigned int* n_global, int B, int C, int H, int W, int Ho,
                   int Wo, cudaStream_t stream) {
  const bool vec4 = W % 4 == 0 && reinterpret_cast<uintptr_t>(g_img) % 16 == 0;
  const dim3 grid((unsigned)((Wo + TILE_W - 1) / TILE_W), (unsigned)((Ho + WARPS - 1) / WARPS),
                  (unsigned)B);
  backwarp_bwd_kernel<S><<<grid, NT, 0, stream>>>(img, flow, gout, g_img, g_flow, n_global, C, H,
                                                   W, Ho, Wo, vec4);
  return cudaGetLastError();
}

}  // namespace

// n_global: one unsigned int on the device, to which every tile that takes
// the global-atomic path adds one (the caller zeroes it when it wants a count).
extern "C" int pivk_backwarp_bwd_f32(const void* img, const void* flow, const void* gout,
                                     void* g_img, void* g_flow, void* n_global, int B, int C,
                                     int H, int W, int Ho, int Wo, int stride, int device,
                                     void* stream) {
  if (stride != 1 && stride != 2) return (int)cudaErrorInvalidValue;
  return pivk::on_device(device, [&] {
    const cudaStream_t s = (cudaStream_t)stream;
    cudaError_t err = cudaMemsetAsync(g_img, 0, (size_t)B * C * H * W * sizeof(float), s);
    if (err != cudaSuccess) return (int)err;
    auto* counter = (unsigned int*)n_global;
    err = stride == 1
        ? launch<1>((const float*)img, (const float*)flow, (const float*)gout, (float*)g_img,
                    (float*)g_flow, counter, B, C, H, W, Ho, Wo, s)
        : launch<2>((const float*)img, (const float*)flow, (const float*)gout, (float*)g_img,
                    (float*)g_flow, counter, B, C, H, W, Ho, Wo, s);
    return (int)err;
  });
}
