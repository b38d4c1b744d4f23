// Backward of the bilinear backward warp (csrc/backwarp.cu), NCHW, in float32
// or bfloat16 (map, flow, gout and gradients of one type): given
// gout = dL/dout [B, C, Ho, Wo] it gives, in one launch,
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
// XLA scatter as the fallback (:268-276), and stride 1 only. Both forms here
// are exact for every flow and both strides.
//
// The float32 form (pivk_backwarp_bwd_f32). Bound on an H100: bytes. At the
// level-1 NetE-S warp of a 256^2 batch-8 training step (C=64) it must read
// img, gout and the flow once and write g_img and g_flow once, ~411 MB, or
// ~123 us at 3.35 TB/s; ~24 flops per value. A scatter with one global
// atomic per tap, channel and pixel (the first version of this kernel) makes
// 4 float reductions in L2 per value of gout, 134 M at that shape.
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
//
// The bf16 form (pivk_backwarp_bwd_bf16) has a design of its own, in which
// every element of g_img has one owner. Its f32 sums cannot go through bf16
// reductions (each would round a partial sum, in a varying order), and its
// first form, the kernel above on bf16 inputs summing into an f32 workspace
// of g_img's shape that a memset cleared and a second pass rounded, moved
// ~470 MB at the shape above (bound ~140 us) where the function needs
// ~206 MB (bound ~61 us: img, gout, g_img in bf16 and the flow and g_flow).
//
// Owner rectangles. g_img is cut into rectangles R of RW x RH pixels; one
// block owns R across all channels of a batch image. A pre-pass over the flow
// alone (owner_boxes_kernel: 4 bytes an output pixel read) gives each R its
// candidate box: each warp takes 32 output pixels of one row (the tiles of
// the float32 form), reduces their taps inside the map to a footprint, and
// widens with integer atomicMin the boxes of the rectangles that footprint
// overlaps by the tile's pixels, so that every output pixel with a tap in R
// lies in R's box, for every flow and both strides. The boxes (16 bytes per
// R) are set to "empty" by a memset of that size first; the pre-pass also
// writes g_flow = 0 for the pixels with no tap inside the map. The rule is
// mirrored by ops/warp.py:owner_rects.
//
// The main kernel (backwarp_bwd_owner_kernel), a block of NT threads per R:
// 1. The candidates: the pixels of the box with a tap inside R (and inside
//    the map), in the box's row-major order, compacted in that order (ballots
//    and per-warp counts) into a list of at most CAP. Thread t holds
//    candidates t + s*NT (s < SLOTS) in registers: their fractions and, where
//    the pixel's corner clamped into the map lies in R (its anchor: every
//    pixel with a tap in the map has one anchor, in one R), the offset of its
//    taps in a staged copy of img. Each tap in R appends (its weight, the
//    candidate) to its element's list, at most KMAX a list (shared int
//    atomics), and each thread sorts the lists of its two elements by
//    candidate, so that the order of the sums is set by the flow alone.
// 2. CH channels at a time: gout at the candidates (their rows are
//    contiguous runs for a smooth flow, so the loads coalesce) and img over R
//    plus one column and one row, loaded into registers CH channels ahead,
//    are staged in shared memory as bf16 (double-buffered: one __syncthreads
//    a stage); each thread sums its two elements' lists, weight times staged
//    gout, in f32, rounds once and stores the pair as one bf16x2 word; and
//    each anchored candidate adds gout * dsample/d(u, v) from the staged img
//    to its g_flow sums in registers.
// 3. Each anchored candidate rounds its g_flow once and stores it.
// No memset of g_img, no workspace, no rounding pass and no float atomics.
// Each element is summed by one thread, as a gather over its list, not by a
// scatter into shared memory, whose adds form a read-modify-write chain per
// tap in which the lanes that meet take turns. Every element of g_img and
// g_flow is summed in an order set by the flow alone, so both are
// bit-deterministic. Measured (chip_smoke.py, H100 80GB HBM3 at 700 W) at the
// shape above: 0.2694 ms alone with a smooth flow at stride 1, 23 % of the
// bound (the first form 0.5453-0.5489 in the same call, the float32 form
// 0.3295), 0.3477 with a random 8 px flow (0.98; 0.82), 0.1995 at stride 2
// (0.31-0.32; 0.24); 128 registers, no spills, 41.6 KB of shared memory, 4
// blocks an SM. tests/warp_variants.py times the choices of CH and of the
// launch bounds.
// A rectangle with more than CAP candidates (a flow that converges, e.g. a
// zoom of more than ~1.7x) or an element with more than KMAX taps takes a
// slower path in the same kernel and adds one to *n_slow: per channel, the
// box in rounds of NT pixels, a pixel a thread, taps worked out anew, each
// warp adding into its own f32 copy of R in shared memory (the lanes whose
// taps meet in one element in turn, by rank, __match_any_sync), the copies
// summed in warp order; then its anchored pixels' g_flow from device
// memory, a pixel a thread, every channel in order. It drops nothing and is
// deterministic too. The rule is ops/warp.py:owner_rects.

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

// The float32 form.
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
  const BilinearTaps t = bilinear_taps(live ? (float)(ox * S) + elem::widen(fb[p]) : -2.f,
                                       live ? (float)(oy * S) + elem::widen(fb[npix + p]) : -2.f, H, W);
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
    g_next = go && live ? elem::load(gnext) : 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      v_next[k] = go && (in & (1u << k)) ? elem::load(inext + tap_delta(k, W)) : 0.f;
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
    elem::store(gfb + p, gu);
    elem::store(gfb + npix + p, gv);
  }
}

template <int S>
cudaError_t launch_f32(const float* img, const float* flow, const float* gout, float* g_img,
                       float* g_flow, unsigned int* n_global, int B, int C, int H, int W, int Ho,
                       int Wo, cudaStream_t stream) {
  const bool vec4 = W % 4 == 0 && reinterpret_cast<uintptr_t>(g_img) % 16 == 0;
  const dim3 grid((unsigned)((Wo + TILE_W - 1) / TILE_W), (unsigned)((Ho + WARPS - 1) / WARPS),
                  (unsigned)B);
  backwarp_bwd_kernel<S><<<grid, NT, 0, stream>>>(img, flow, gout, g_img, g_flow, n_global, C, H, W,
                                                  Ho, Wo, vec4);
  return cudaGetLastError();
}

// ---- the bf16 form: owner rectangles ----------------------------------------------------------

namespace own {

using elem::bf16;

constexpr int RW = 32, RH = 8;  // an owner rectangle; keep in step with ops/warp.py:OWNER_W, OWNER_H
// the row of R's copies and of the staged img (R plus one column and one row) in shared memory
constexpr int RS = RW + 8;
constexpr int NT = 128;  // threads a block
constexpr int NWARP = NT / 32;
constexpr int SLOTS = 4;  // candidates a thread holds
// candidates a rectangle may have on the fast path; keep in step with ops/warp.py:OWNER_CAP
constexpr int CAP = NT * SLOTS;
constexpr int IW = RW + 1, ICELLS = (IW * (RH + 1) + NT - 1) / NT;  // staged img: columns, cells a thread
// taps an element of R may receive on the fast path; keep in step with ops/warp.py:OWNER_KMAX
constexpr int KMAX = 16;
constexpr int CH = 4;              // channels an iteration of the fast path
constexpr int EMPTY = 0x7f7f7f7f;  // a box field no tile has widened: the memset's bytes
constexpr int PRE_WARPS = 8;       // tiles a pre-pass block
static_assert(RW * RH == 2 * NT, "each thread sums one pair of elements of R");
static_assert(RW % 2 == 0, "the pairs of R stay in one row");

// An output pixel's taps as bilinear_taps computes them: the corner, its fractions, and in
// bit k whether tap k (corner + (k & 1, k >> 1)) lies inside the map.
struct Taps {
  int x0, y0;
  float wx, wy;
  unsigned in;
};

template <int S>
__device__ __forceinline__ Taps taps_at(const bf16* fb, int npix, int ox, int oy, int Wo, int H, int W) {
  const int p = oy * Wo + ox;
  const BilinearTaps t = bilinear_taps((float)(ox * S) + elem::load(fb + p),
                                       (float)(oy * S) + elem::load(fb + npix + p), H, W);
  Taps r{t.x0, t.y0, t.wx, t.wy, 0u};
#pragma unroll
  for (int k = 0; k < 4; ++k) r.in |= (t.off[k] >= 0 ? 1u : 0u) << k;
  return r;
}

// bit k: tap k lies inside the map and inside the rectangle at (X0, Y0)
__device__ __forceinline__ unsigned in_rect(const Taps& t, int X0, int Y0) {
  unsigned m = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const unsigned cx = (unsigned)(t.x0 + (k & 1) - X0), cy = (unsigned)(t.y0 + (k >> 1) - Y0);
    m |= ((t.in >> k & 1u) && cx < (unsigned)RW && cy < (unsigned)RH ? 1u : 0u) << k;
  }
  return m;
}

// the pixel's anchor, its corner clamped into the map, lies in the rectangle (a pixel with a
// tap inside the map has one anchor, and it is one of its taps)
__device__ __forceinline__ bool anchored(const Taps& t, int X0, int Y0) {
  return t.in && (unsigned)(max(t.x0, 0) - X0) < (unsigned)RW && (unsigned)(max(t.y0, 0) - Y0) < (unsigned)RH;
}

// The pre-pass: the candidate boxes {min ox, -max ox, min oy, -max oy} of every rectangle (set to
// EMPTY before), and g_flow = 0 where no tap lies inside the map. A warp per 32 output pixels of
// a row.
template <int S>
__global__ void __launch_bounds__(32 * PRE_WARPS)
owner_boxes_kernel(const bf16* __restrict__ flow, bf16* __restrict__ g_flow, int* __restrict__ boxes,
                   int H, int W, int Ho, int Wo, int nrx, int nry) {
  const int lane = threadIdx.x % 32;
  const int ntx = (Wo + 31) / 32;
  const int tile = blockIdx.x * PRE_WARPS + threadIdx.x / 32;
  const int oy = tile / ntx;
  if (oy >= Ho) return;  // the whole warp
  const int tx0 = (tile - oy * ntx) * 32, ox = tx0 + lane;
  const int b = blockIdx.y, npix = Ho * Wo;
  const bf16* fb = flow + (size_t)b * 2 * npix;
  const Taps t = ox < Wo ? taps_at<S>(fb, npix, ox, oy, Wo, H, W) : Taps{0, 0, 0.f, 0.f, 0u};
  if (ox < Wo && !t.in) {
    bf16* gfb = g_flow + (size_t)b * 2 * npix + oy * Wo + ox;
    elem::store(gfb, 0.f);
    elem::store(gfb + npix, 0.f);
  }
  int m[4] = {INT_MAX, INT_MAX, INT_MAX, INT_MAX};  // min x, -max x, min y, -max y of the taps inside
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (t.in >> k & 1u) {
      const int cx = t.x0 + (k & 1), cy = t.y0 + (k >> 1);
      m[0] = min(m[0], cx);
      m[1] = min(m[1], -cx);
      m[2] = min(m[2], cy);
      m[3] = min(m[3], -cy);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = __reduce_min_sync(FULL, m[i]);
  if (m[0] == INT_MAX) return;  // no tap of the tile inside the map
  const int rx0 = m[0] / RW, ry0 = m[2] / RH;
  const int nx = -m[1] / RW - rx0 + 1, n = nx * (-m[3] / RH - ry0 + 1);
  const int xhi = min(tx0 + 31, Wo - 1);
  for (int i = lane; i < n; i += 32) {
    const int ry = ry0 + i / nx, rx = rx0 + i % nx;
    int* box = boxes + 4 * (((size_t)b * nry + ry) * nrx + rx);
    atomicMin(box, tx0);
    atomicMin(box + 1, -xhi);
    atomicMin(box + 2, oy);
    atomicMin(box + 3, -oy);
  }
}

// One warp's adds of val[k] (tap k at cell[k], where bit k of m is set) into its copy, the lanes
// whose tap k meets another's in one element in turn by rank (5 bits per tap of m from bit 12;
// last: the largest rank of the warp, the same in every lane).
__device__ __forceinline__ void scatter(float* copy, int q, unsigned m, unsigned last, const float* val) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float* cell = copy + q + tap_delta(k, RS);
    if (last == 0) {
      if (m >> k & 1u) *cell += val[k];
      __syncwarp();  // tap k of one lane can be tap k' of another: the adds stay in order
    } else {
      const unsigned turn = m >> (12 + 5 * k) & 31u;
      for (unsigned r = 0; r <= last; ++r) {
        if ((m >> k & 1u) && turn == r) *cell += val[k];
        __syncwarp();
      }
    }
  }
}

// The ranks of the lanes whose tap k (bit k of m) lands on one element of R, into bits 12-31 of
// m; returns the warp's largest rank.
__device__ __forceinline__ unsigned rank_taps(unsigned& m, int q, int lane) {
  const unsigned lower = (1u << lane) - 1u;
  unsigned last = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const bool ok = m >> k & 1u;
    const unsigned group = __match_any_sync(FULL, ok ? q + tap_delta(k, RS) : -1 - lane);
    const unsigned rank = __popc(group & lower);
    m |= rank << (12 + 5 * k);
    last = max(last, __reduce_max_sync(FULL, ok ? rank : 0u));
  }
  return last;
}

__device__ __forceinline__ void weights(float wx, float wy, float g, float* val) {
#pragma unroll
  for (int k = 0; k < 4; ++k) val[k] = (k & 1 ? wx : 1.f - wx) * (k >> 1 ? wy : 1.f - wy) * g;
}

// d(sample)/d(u, v) times g, added to (gu, gv): d/dx is (1-wy)(v1-v0) + wy(v3-v2), d/dy is
// (1-wx)(v2-v0) + wx(v3-v1), as in the float32 form
__device__ __forceinline__ void add_dflow(const float* v, float wx, float wy, float g, float& gu, float& gv) {
  const float dx0 = v[1] - v[0], dy0 = v[2] - v[0];
  gu += g * (dx0 + wy * ((v[3] - v[2]) - dx0));
  gv += g * (dy0 + wx * ((v[3] - v[1]) - dy0));
}

// bf16 bits as f32, and a bf16 from device memory as its bits
__device__ __forceinline__ float widen(unsigned short u) { return __uint_as_float((uint32_t)u << 16); }
__device__ __forceinline__ unsigned short ldg_bits(const bf16* p) {
  return __ldg(reinterpret_cast<const unsigned short*>(p));
}

// The main kernel's shared memory: the fast path's lists and staged values, or the slower path's
// copies of R, and the candidates.
struct alignas(16) Smem {
  union {
    struct {
      float ew[KMAX][RW * RH];            // the weight of element e's j-th tap: ew[j][e]
      unsigned short ei[KMAX][RW * RH];   // its candidate
      int n[RW * RH];                     // taps of each element
      unsigned short gs[2][CH][CAP];          // gout at the candidates (bf16 bits), double-buffered
      unsigned short ims[2][CH][(RH + 1) * RS];  // img over R plus a column and a row, likewise
    } f;
    float copies[NWARP][RH * RS];  // the slower path: each warp's sums of a channel
  };
  int cand[CAP];  // the candidates' output pixels
  int wcount[NWARP];
};

template <int S>
__global__ void __launch_bounds__(NT, 4)
backwarp_bwd_owner_kernel(const bf16* __restrict__ img, const bf16* __restrict__ flow,
                          const bf16* __restrict__ gout, bf16* __restrict__ g_img,
                          bf16* __restrict__ g_flow, unsigned int* __restrict__ n_slow,
                          const int* __restrict__ boxes, int C, int H, int W, int Ho, int Wo, bool vec2) {
  __shared__ Smem sm;

  const int tid = threadIdx.x, lane = tid % 32, wid = tid / 32;
  const int X0 = blockIdx.x * RW, Y0 = blockIdx.y * RH, b = blockIdx.z;
  const int npix = Ho * Wo;
  const size_t plane = (size_t)H * W;
  const bf16* fb = flow + (size_t)b * 2 * npix;
  const bf16* gb = gout + (size_t)b * C * npix;
  const bf16* ib = img + (size_t)b * C * plane;
  const int4 box = reinterpret_cast<const int4*>(boxes)[((size_t)b * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x];
  const int bw = box.x == EMPTY ? 0 : -box.y - box.x + 1;
  const int bn = box.x == EMPTY ? 0 : bw * (-box.w - box.z + 1);

  // 1. the candidates, in the box's order
  int nc = 0;
  for (int base = 0; base < bn && nc <= CAP; base += NT) {
    const int i = base + tid;
    const int oy = box.z + i / bw, ox = box.x + i % bw;
    const bool is_c = i < bn && in_rect(taps_at<S>(fb, npix, ox, oy, Wo, H, W), X0, Y0);
    const unsigned ballot = __ballot_sync(FULL, is_c);
    if (lane == 0) sm.wcount[wid] = __popc(ballot);
    __syncthreads();
    int pos = nc + __popc(ballot & ((1u << lane) - 1u));
    for (int w2 = 0; w2 < NWARP; ++w2) {
      pos += w2 < wid ? sm.wcount[w2] : 0;
      nc += sm.wcount[w2];
    }
    if (is_c && pos < CAP) sm.cand[pos] = oy * Wo + ox;
    __syncthreads();
  }

  // an adjacent pair of R's elements a thread: e0 = 2 * tid and e0 + 1 (row-major, RW a row)
  const int ry = Y0 + 2 * tid / RW, rx = X0 + 2 * tid % RW;
  const bool own = ry < H && rx < W, own1 = rx + 1 < W;
  bf16* gio = g_img + (size_t)b * C * plane + (size_t)ry * W + rx;
  auto store_pair = [&](int c, float s0, float s1) {
    if (own) {
      bf16* dst = gio + (size_t)c * plane;
      if (vec2 && own1) {
        *reinterpret_cast<uint32_t*>(dst) = elem::pack2(s0, s1);
      } else {
        elem::store(dst, s0);
        if (own1) elem::store(dst + 1, s1);
      }
    }
  };

  // 2. the fast path's candidates: thread t holds t + s*NT; a tap's cell in the staged img is at
  // qb + tap_delta(k, RS)
  int sp[SLOTS], qb[SLOTS];
  unsigned bits[SLOTS];  // 0-3 taps in R, 4-7 taps in the map, 8 anchored
  float wx[SLOTS], wy[SLOTS], gu[SLOTS], gv[SLOTS];
  bool slow = nc > CAP;
  if (!slow) {
    for (int e = tid; e < RW * RH; e += NT) sm.f.n[e] = 0;
    __syncthreads();
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      const int i = tid + s * NT;
      sp[s] = i < nc ? sm.cand[i] : -1;
      const int oy = max(sp[s], 0) / Wo, ox = max(sp[s], 0) - oy * Wo;
      const Taps t = i < nc ? taps_at<S>(fb, npix, ox, oy, Wo, H, W) : Taps{0, 0, 0.f, 0.f, 0u};
      bits[s] = in_rect(t, X0, Y0) | t.in << 4 | (anchored(t, X0, Y0) ? 1u << 8 : 0u);
      qb[s] = (t.y0 - Y0) * RS + (t.x0 - X0);
      wx[s] = t.wx;
      wy[s] = t.wy;
      gu[s] = gv[s] = 0.f;
      // the element lists: each tap in R appends (weight, candidate) to its element's
      float w4[4];
      weights(t.wx, t.wy, 1.f, w4);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (bits[s] >> k & 1u) {
          const int e = (t.y0 - Y0 + (k >> 1)) * RW + t.x0 - X0 + (k & 1);
          const int j = atomicAdd(&sm.f.n[e], 1);
          if (j < KMAX) {
            sm.f.ew[j][e] = w4[k];
            sm.f.ei[j][e] = (unsigned short)i;
          }
        }
      }
    }
    __syncthreads();
  }
  const int n0 = slow ? 0 : sm.f.n[2 * tid], n1 = slow ? 0 : sm.f.n[2 * tid + 1];
  slow = __syncthreads_or(slow || n0 > KMAX || n1 > KMAX);

  if (slow) {
    // the slower path: per channel, the box in rounds of NT pixels, taps worked out anew, each warp
    // into its own copy of R (its lanes that meet in one element in turn)
    if (tid == 0) atomicAdd(n_slow, 1u);
    for (int i = tid; i < NWARP * RH * RS; i += NT) (&sm.copies[0][0])[i] = 0.f;
    __syncthreads();
    const int q0 = 2 * tid / RW * RS + 2 * tid % RW;
    for (int c = 0; c < C; ++c) {
      for (int base = 0; base < bn; base += NT) {
        const int i = base + tid;
        const int oy = box.z + i / bw, ox = box.x + i % bw;
        const Taps t = i < bn ? taps_at<S>(fb, npix, ox, oy, Wo, H, W) : Taps{0, 0, 0.f, 0.f, 0u};
        unsigned m = in_rect(t, X0, Y0);
        const int q = (t.y0 - Y0) * RS + (t.x0 - X0);
        float val[4];
        weights(t.wx, t.wy, m ? elem::load(gb + (size_t)c * npix + oy * Wo + ox) : 0.f, val);
        const unsigned last = rank_taps(m, q, lane);
        scatter(sm.copies[wid], q, m, last, val);
      }
      __syncthreads();
      // the copies of this thread's pair summed in warp order, zeroed, rounded and stored
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int w2 = 0; w2 < NWARP; ++w2) {
        s0 += sm.copies[w2][q0];
        s1 += sm.copies[w2][q0 + 1];
        sm.copies[w2][q0] = sm.copies[w2][q0 + 1] = 0.f;
      }
      store_pair(c, s0, s1);
      __syncthreads();
    }
    // g_flow of the pixels anchored in R, every channel from device memory
    for (int base = 0; base < bn; base += NT) {
      const int i = base + tid;
      const int oy = box.z + i / bw, ox = box.x + i % bw;
      if (i >= bn) continue;
      const Taps t = taps_at<S>(fb, npix, ox, oy, Wo, H, W);
      if (!anchored(t, X0, Y0)) continue;
      const int p = oy * Wo + ox, corner = t.y0 * W + t.x0;  // taps read only inside the map
      float gu1 = 0.f, gv1 = 0.f;
      for (int c = 0; c < C; ++c) {
        float v[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          v[k] = t.in >> k & 1u ? elem::load(ib + (size_t)c * plane + corner + tap_delta(k, W)) : 0.f;
        add_dflow(v, t.wx, t.wy, elem::load(gb + (size_t)c * npix + p), gu1, gv1);
      }
      bf16* gfb = g_flow + (size_t)b * 2 * npix + p;
      elem::store(gfb, gu1);
      elem::store(gfb + npix, gv1);
    }
    return;
  }

  // each of this thread's two lists in candidate order (insertion sort), so that the sums do not
  // depend on the order of the atomics above
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int e = 2 * tid + h, n = h ? n1 : n0;
    for (int a = 1; a < n; ++a) {
      const float kw = sm.f.ew[a][e];
      const unsigned short ki = sm.f.ei[a][e];
      int j = a - 1;
      for (; j >= 0 && sm.f.ei[j][e] > ki; --j) {
        sm.f.ew[j + 1][e] = sm.f.ew[j][e];
        sm.f.ei[j + 1][e] = sm.f.ei[j][e];
      }
      sm.f.ew[j + 1][e] = kw;
      sm.f.ei[j + 1][e] = ki;
    }
  }
  // the img cells this thread stages: (their offset in a plane, -1 outside the map) and their
  // place in the staged rows
  int ioff[ICELLS], icell[ICELLS];
#pragma unroll
  for (int j = 0; j < ICELLS; ++j) {
    const int cell = tid + j * NT, r = cell / IW, col = cell % IW;
    const bool used = r <= RH;
    icell[j] = used ? r * RS + col : -1;
    ioff[j] = used && Y0 + r < H && X0 + col < W ? (Y0 + r) * W + X0 + col : -1;
  }
  // gout at the candidates and the staged img cells of channels c0 .. c0 + CH - 1, as bf16 bits
  unsigned short gn[CH][SLOTS], iv[CH][ICELLS];
  auto load = [&](int c0) {
#pragma unroll
    for (int u = 0; u < CH; ++u) {
      const bool ok = c0 + u < C;
      const bf16* gc = gb + (size_t)(c0 + u) * npix;
      const bf16* ic = ib + (size_t)(c0 + u) * plane;
#pragma unroll
      for (int s = 0; s < SLOTS; ++s) gn[u][s] = ok && sp[s] >= 0 ? ldg_bits(gc + sp[s]) : 0;
#pragma unroll
      for (int j = 0; j < ICELLS; ++j) iv[u][j] = ok && ioff[j] >= 0 ? ldg_bits(ic + ioff[j]) : 0;
    }
  };
  const int nmax = max(n0, n1);
  load(0);
  for (int c0 = 0, it = 0; c0 < C; c0 += CH, ++it) {
    const int buf = it & 1;
    float g[CH][SLOTS];
#pragma unroll
    for (int u = 0; u < CH; ++u) {
#pragma unroll
      for (int s = 0; s < SLOTS; ++s) {
        g[u][s] = widen(gn[u][s]);
        if (sp[s] >= 0) sm.f.gs[buf][u][tid + s * NT] = gn[u][s];
      }
#pragma unroll
      for (int j = 0; j < ICELLS; ++j)
        if (icell[j] >= 0) sm.f.ims[buf][u][icell[j]] = iv[u][j];
    }
    if (c0 + CH < C) load(c0 + CH);
    __syncthreads();
    // g_img: each element's taps in candidate order, f32, rounded once
    float a[CH][2] = {};
    for (int j = 0; j < nmax; ++j) {
      const float2 w2 = reinterpret_cast<const float2*>(sm.f.ew[j])[tid];
      const uint32_t i2 = reinterpret_cast<const uint32_t*>(sm.f.ei[j])[tid];
#pragma unroll
      for (int u = 0; u < CH; ++u) {
        if (j < n0) a[u][0] += w2.x * widen(sm.f.gs[buf][u][i2 & 0xffffu]);
        if (j < n1) a[u][1] += w2.y * widen(sm.f.gs[buf][u][i2 >> 16]);
      }
    }
#pragma unroll
    for (int u = 0; u < CH; ++u)
      if (c0 + u < C) store_pair(c0 + u, a[u][0], a[u][1]);
    // g_flow: the anchored candidates, from the staged img
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      if (bits[s] >> 8 & 1u) {
#pragma unroll
        for (int u = 0; u < CH; ++u) {
          if (c0 + u < C) {
            float v[4];
#pragma unroll
            for (int k = 0; k < 4; ++k)
              v[k] = bits[s] >> (4 + k) & 1u ? widen(sm.f.ims[buf][u][qb[s] + tap_delta(k, RS)]) : 0.f;
            add_dflow(v, wx[s], wy[s], g[u][s], gu[s], gv[s]);
          }
        }
      }
    }
  }
  // 3. the anchored candidates' g_flow
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    if (bits[s] >> 8 & 1u) {
      bf16* gfb = g_flow + (size_t)b * 2 * npix + sp[s];
      elem::store(gfb, gu[s]);
      elem::store(gfb + npix, gv[s]);
    }
  }
}

template <int S>
cudaError_t launch(const bf16* img, const bf16* flow, const bf16* gout, bf16* g_img, bf16* g_flow,
                   unsigned int* n_slow, int* boxes, int B, int C, int H, int W, int Ho, int Wo,
                   cudaStream_t stream) {
  const int nrx = (W + RW - 1) / RW, nry = (H + RH - 1) / RH;
  cudaError_t err = cudaMemsetAsync(boxes, 0x7f, (size_t)B * nry * nrx * 4 * sizeof(int), stream);
  if (err != cudaSuccess) return err;
  const int tiles = Ho * ((Wo + 31) / 32);
  owner_boxes_kernel<S><<<dim3((unsigned)((tiles + PRE_WARPS - 1) / PRE_WARPS), (unsigned)B), 32 * PRE_WARPS,
                          0, stream>>>(flow, g_flow, boxes, H, W, Ho, Wo, nrx, nry);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const bool vec2 = W % 2 == 0 && reinterpret_cast<uintptr_t>(g_img) % 4 == 0;
  backwarp_bwd_owner_kernel<S><<<dim3((unsigned)nrx, (unsigned)nry, (unsigned)B), NT, 0, stream>>>(
      img, flow, gout, g_img, g_flow, n_slow, boxes, C, H, W, Ho, Wo, vec2);
  return cudaGetLastError();
}

}  // namespace own

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
    err = stride == 1 ? launch_f32<1>((const float*)img, (const float*)flow, (const float*)gout, (float*)g_img,
                                      (float*)g_flow, counter, B, C, H, W, Ho, Wo, s)
                      : launch_f32<2>((const float*)img, (const float*)flow, (const float*)gout, (float*)g_img,
                                      (float*)g_flow, counter, B, C, H, W, Ho, Wo, s);
    return (int)err;
  });
}

// The bf16 form takes the f32 form's arguments with n_slow in the counter's place, to which
// every rectangle that takes the slower path adds one, and after it boxes: int32, 4 per owner
// rectangle (B * ceil(H/8) * ceil(W/32) of them), 16 bytes aligned; its contents on entry do
// not matter.
extern "C" int pivk_backwarp_bwd_bf16(const void* img, const void* flow, const void* gout,
                                      void* g_img, void* g_flow, void* n_slow, void* boxes,
                                      int B, int C, int H, int W, int Ho, int Wo, int stride,
                                      int device, void* stream) {
  if (stride != 1 && stride != 2) return (int)cudaErrorInvalidValue;
  using elem::bf16;
  return pivk::on_device(device, [&] {
    const cudaStream_t s = (cudaStream_t)stream;
    auto* counter = (unsigned int*)n_slow;
    const cudaError_t err =
        stride == 1 ? own::launch<1>((const bf16*)img, (const bf16*)flow, (const bf16*)gout, (bf16*)g_img,
                                     (bf16*)g_flow, counter, (int*)boxes, B, C, H, W, Ho, Wo, s)
                    : own::launch<2>((const bf16*)img, (const bf16*)flow, (const bf16*)gout, (bf16*)g_img,
                                     (bf16*)g_flow, counter, (int*)boxes, B, C, H, W, Ho, Wo, s);
    return (int)err;
  });
}
