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
// Design: the forward's tiling (csrc/corr_tiles.cuh), with g as the operand
// that stays in registers. Substituting e = -d in the second sum,
//   g_f2[c,y,x] = (1/C) sum_e g[48-e, y+ey, x+ex] * f1[c, y+ey, x+ex],
// so both outputs are a 49-tap stencil over a staged map (f2 for g_f1, f1
// for g_f2) with per-pixel weights that do not depend on the channel: g at
// the pixel (direct) and g at the 49 shifted positions in the mirrored order
// (mirrored). A block covers 32x8 output pixels of one output (blockIdx.z
// picks it), so it stages one map: with both outputs in a block the tile had
// to be 32x4 to fit the registers, and the larger halo share of the smaller
// tile cost more staging traffic than reading g's tile twice, once per
// output. Staged row ty+j serves output row ty at displacement row j and
// output row ty+1 at j-1, so a lane owns 4 adjacent pixels of two output
// rows and one staged row j (0..7): 2 x 7 x 4 weights, loaded once. The
// direct weights come straight from g (each value by one lane); the
// mirrored ones from windows of g staged in shared memory (per displacement,
// the tile's rows shifted by it), while the first channel groups land. Then,
// per channel, a lane reads 12 staged values (three 16-byte loads) for 56
// multiply-adds, and the 8 lanes of a pixel group sum their partial sums
// with three rounds of shuffles that leave each lane one finished value: a
// fixed order, no atomics. The map's tile plus halo is staged 8 channels at
// a time in a ring of three stages filled with cp.async, one barrier per
// group; g's windows share the third stage's memory, which fills only after
// they are read. The 8 lanes of a quarter-warp read 8 staged rows at the
// same columns, so the rows are 44 floats apart, which puts their 16-byte
// loads on distinct banks. Odd widths take the edge path (4-byte copies,
// scalar reads of g).

#include "corr_tiles.cuh"
#include "device_guard.cuh"

namespace {

using namespace corr_tiles;

constexpr int TX = 32;
constexpr int TY = 8;
constexpr int NG = TX / R;            // 8 pixel groups per row
constexpr int LANES = ND + 1;         // lanes per pixel group and output: staged rows j = 0..7
constexpr int NT = NG * (TY / 2) * LANES;  // 256 threads: groups of 4 pixels x 2 rows
constexpr int SH = TY + 2 * MD;       // 14 staged rows
constexpr int SW = TX + 2 * PAD_X;    // 40 staged columns
constexpr int SWS = SW + 4;           // row stride of the stages (bank spread)
constexpr int CC = 8;                 // channels per stage
constexpr int NS = 3;                 // stages in the ring
constexpr int MAP = SH * SWS;         // floats of one staged map channel
constexpr int STAGE = CC * MAP;
// g's mirrored windows: per displacement d, the rows of the tile shifted by -d in plane
// 48-d, TY x (TX+4) floats from a 16-byte aligned column
constexpr int GMW = TX + 4;
constexpr int GDS = TY * GMW + 4;     // floats per displacement (bank spread)
constexpr int G_OFF = (NS - 1) * STAGE;  // g's windows share the last stage's memory
constexpr int G_FLOATS = NDISP * GDS;
constexpr int SMEM = (G_OFF + (STAGE > G_FLOATS ? STAGE : G_FLOATS)) * (int)sizeof(float);  // 96,656 bytes: two blocks per SM
constexpr int CHUNKS = CC * SH * (SW / 4);          // 16-byte chunks of one stage
constexpr int SLOTS = (CHUNKS + NT - 1) / NT;

// One of a thread's chunks, the same in every channel group (see csrc/corr49.cu).
struct Chunk {
  int meta;  // dst | ch << 14, dst its float offset in the stage; -1: no chunk
  int src;   // float offset from the group's base pointer; -1: outside the map (zero-filled)
};
static_assert(STAGE <= (1 << 14), "Chunk::meta packs dst in 14 bits");

__device__ __forceinline__ Chunk chunk_of(int i, int x0, int y0, int H, int W, int plane) {
  if (i >= CHUNKS) return Chunk{-1, -1};
  constexpr int PER_MAP = SH * (SW / 4);
  const int ch = i / PER_MAP;
  const int r = (i - ch * PER_MAP) / (SW / 4);
  const int j = i - ch * PER_MAP - r * (SW / 4);
  const int gy = y0 - MD + r;
  const int gx = x0 - PAD_X + 4 * j;
  const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
  return Chunk{(ch * MAP + r * SWS + 4 * j) | ch << 14, in ? ch * plane + gy * W + gx : -1};
}

__device__ __forceinline__ void stage_vec(float* st, const Chunk (&chunks)[SLOTS], const float* mc, int left) {
#pragma unroll
  for (int m = 0; m < SLOTS; ++m) {
    const Chunk c = chunks[m];
    if (c.meta < 0) continue;
    const bool ok = c.src >= 0 && (c.meta >> 14) < left;
    cp_async16(st + (c.meta & 16383), ok ? mc + c.src : mc, ok);
  }
}

// The edge path: the same stage, one float per copy.
__device__ __forceinline__ void stage_scalar(float* st, const float* mc, int left,
                                             int x0, int y0, int H, int W, int plane) {
  for (int i = threadIdx.x; i < CC * SH * SW; i += NT) {
    const int ch = i / (SH * SW);
    const int r = (i - ch * (SH * SW)) / SW;
    const int s = i - ch * (SH * SW) - r * SW;
    const int gy = y0 - MD + r;
    const int gx = x0 - PAD_X + s;
    const bool ok = ch < left && gy >= 0 && gy < H && gx >= 0 && gx < W;
    cp_async4(st + ch * MAP + r * SWS + s, ok ? mc + ch * plane + gy * W + gx : mc, ok);
  }
}

// Where the mirrored window of displacement column dxi starts: its column offset from x0.
__device__ __forceinline__ int mirror_x(int dxi) { return -PAD_X + 4 * ((dxi + 1) >> 2); }

// g's mirrored windows into sg, [d][TY][GMW] (d GDS floats apart): the window of
// displacement d from plane 48-d.
template <bool VEC>
__device__ __forceinline__ void stage_g(float* sg, const float* gb, int x0, int y0, int H, int W, int plane) {
  constexpr int UNIT = VEC ? 4 : 1;  // floats per copy
  constexpr int PER_ROW = GMW / UNIT;
  for (int i = threadIdx.x; i < NDISP * TY * PER_ROW; i += NT) {
    const int d = i / (TY * PER_ROW);
    const int r = (i - d * (TY * PER_ROW)) / PER_ROW;
    const int c = UNIT * (i - d * (TY * PER_ROW) - r * PER_ROW);
    const int dyi = d / ND, dxi = d - dyi * ND;
    const int gy = y0 + r + dyi - MD;
    const int gx = x0 + mirror_x(dxi) + c;
    const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W;
    const float* src = ok ? gb + (NDISP - 1 - d) * plane + gy * W + gx : gb;
    if (VEC)
      cp_async16(sg + d * GDS + r * GMW + c, src, ok);
    else
      cp_async4(sg + d * GDS + r * GMW + c, src, ok);
  }
}

// Of the 2R partial sums of a lane (its 4 pixels in the group's first row, then in its
// second), the lane j (0..7) of a group keeps value j (row j/4, pixel j%4) summed over the
// group's 8 lanes.
__device__ __forceinline__ float reduce_scatter(const float (&p)[2 * R], int j) {
  float q[4], h[2];
  const bool b2 = j & 4, b1 = j & 2, b0 = j & 1;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float send = b2 ? p[i] : p[4 + i];
    q[i] = (b2 ? p[4 + i] : p[i]) + __shfl_xor_sync(0xffffffffu, send, 4);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float send = b1 ? q[i] : q[2 + i];
    h[i] = (b1 ? q[2 + i] : q[i]) + __shfl_xor_sync(0xffffffffu, send, 2);
  }
  const float send = b0 ? h[0] : h[1];
  return (b0 ? h[1] : h[0]) + __shfl_xor_sync(0xffffffffu, send, 1);
}

template <bool VEC>
__global__ void __launch_bounds__(NT, 2)
corr49_bwd_kernel(const float* __restrict__ f1, const float* __restrict__ f2, const float* __restrict__ g,
                  float* __restrict__ g_f1, float* __restrict__ g_f2, int* __restrict__ edge_tiles, int C,
                  int H, int W, float inv_c) {
  extern __shared__ __align__(16) float smem[];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int j = lane & (LANES - 1);            // staged row ty+j of the group
  const int o = blockIdx.z & 1;                // output: 0 g_f1 (map f2, direct g), 1 g_f2 (map f1, mirrored g)
  const int warp = tid >> 5;
  const int ty = 2 * (warp >> 1);              // the group's first row; two warps per row pair
  const int k = 4 * (warp & 1) + (lane >> 3);  // pixel group
  const int x0 = blockIdx.x * TX;
  const int y0 = blockIdx.y * TY;
  const int b = blockIdx.z >> 1;
  const int plane = H * W;
  const float* mb = (o ? f1 : f2) + (size_t)b * C * plane;

  if (!VEC && tid == 0 && blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0)
    *edge_tiles += (int)(gridDim.x * gridDim.y * gridDim.z);

  // g's mirrored windows and the first two channel groups, in flight together
  const float* gb = g + (size_t)b * NDISP * plane;
  float* const sg = smem + G_OFF;
  if (o == 1) stage_g<VEC>(sg, gb, x0, y0, H, W, plane);
  cp_async_commit();

  Chunk chunks[SLOTS];
  if (VEC) {
#pragma unroll
    for (int m = 0; m < SLOTS; ++m) chunks[m] = chunk_of(tid + m * NT, x0, y0, H, W, plane);
  }
  auto stage = [&](int grp) {
    const int c0 = grp * CC;
    float* st = smem + (grp % NS) * STAGE;
    if (VEC)
      stage_vec(st, chunks, mb + (size_t)c0 * plane, C - c0);
    else
      stage_scalar(st, mb + (size_t)c0 * plane, C - c0, x0, y0, H, W, plane);
  };

  const int groups = (C + CC - 1) / CC;
  stage(0);
  cp_async_commit();
  if (groups > 1) stage(1);
  cp_async_commit();

  // Staged row ty+j meets output row ty at displacement row j and output row ty+1 at j-1:
  // w[r][dx][i] weighs it, column 4k+i+dx+1, for output row ty+r, displacement d = (j-r)*7+dx.
  // Direct (o = 0): g[d] at the pixel, read from device memory, each value by one lane.
  // Mirrored (o = 1): g[48-d] at the pixel + (j-r-3, dx-3), from the window of d. Displacement
  // rows -1 and 7 do not exist and weigh 0.
  float w[2][ND][R];
  const int xg = x0 + R * k;
  if (o == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int dyi = j - r;
      const bool live = dyi >= 0 && dyi < ND && y0 + ty + r < H;
      const float* gp = gb + (size_t)(live ? dyi * ND : 0) * plane + (size_t)(live ? y0 + ty + r : 0) * W + xg;
#pragma unroll
      for (int dx = 0; dx < ND; ++dx) {
        float v[R] = {0.f, 0.f, 0.f, 0.f};
        if (VEC) {
          if (live && xg < W) {
            const float4 t = __ldg(reinterpret_cast<const float4*>(gp + (size_t)dx * plane));
            v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
          }
        } else {
#pragma unroll
          for (int i = 0; i < R; ++i)
            if (live && xg + i < W) v[i] = __ldg(gp + (size_t)dx * plane + i);
        }
#pragma unroll
        for (int i = 0; i < R; ++i) w[r][dx][i] = v[i] * inv_c;
      }
    }
  }
  cp_async_wait<2>();  // the mirrored windows have landed
  __syncthreads();
  if (o == 1) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int dyi = j - r;
      const bool live = dyi >= 0 && dyi < ND;
      const int dyc = dyi < 0 ? 0 : (dyi < ND ? dyi : ND - 1);
#pragma unroll
      for (int dx = 0; dx < ND; ++dx) {
        const float* gp = sg + (dyc * ND + dx) * GDS + (ty + r) * GMW + R * k + dx - MD - mirror_x(dx);
#pragma unroll
        for (int i = 0; i < R; ++i) w[r][dx][i] = live ? gp[i] * inv_c : 0.f;
      }
    }
  }

  // after the reduction, lane j holds output o at row ty + j/4, pixel x0 + 4k + j%4
  const int y = y0 + ty + (j >> 2);
  const int x = x0 + R * k + (j & 3);
  const bool store = y < H && x < W;
  float* dst = (o ? g_f2 : g_f1) + (size_t)b * C * plane + (size_t)y * W + x;
  const int row = (ty + j) * SWS + R * k;

  for (int grp = 0; grp < groups; ++grp) {
    cp_async_wait<1>();  // group grp has landed (only grp+1 may still be in flight)
    __syncthreads();     // ... for every thread, and every thread is done with group grp-1
    if (grp + 2 < groups) stage(grp + 2);
    cp_async_commit();
    const float* st = smem + (grp % NS) * STAGE + row;
    const int c0 = grp * CC;
#pragma unroll
    for (int ch = 0; ch < CC; ++ch) {
      float v[ROWV], p[2 * R];
      load_row(st + ch * MAP, v);
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int i = 0; i < R; ++i) {
          float a = w[r][0][i] * v[i + 1];
#pragma unroll
          for (int dx = 1; dx < ND; ++dx) a = fmaf(w[r][dx][i], v[i + dx + 1], a);
          p[r * R + i] = a;
        }
      const float val = reduce_scatter(p, j);
      if (store && c0 + ch < C) dst[(size_t)(c0 + ch) * plane] = val;
    }
  }
}

template <bool VEC>
int launch(const float* f1, const float* f2, const float* g, float* g_f1, float* g_f2, int* edge_tiles, int B,
           int C, int H, int W, cudaStream_t stream) {
  cudaError_t err = allow_smem<corr49_bwd_kernel<VEC>>(SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + TX - 1) / TX, (H + TY - 1) / TY, 2 * B);
  corr49_bwd_kernel<VEC><<<grid, NT, SMEM, stream>>>(f1, f2, g, g_f1, g_f2, edge_tiles, C, H, W,
                                                      1.0f / (float)C);
  return (int)cudaGetLastError();
}

}  // namespace

// edge_tiles: one int on the device; a launch that takes the edge path (W not a multiple
// of 4, or an input not 16 bytes aligned) adds its number of tiles to it.
extern "C" int pivk_corr49_bwd_f32(const void* f1, const void* f2, const void* g, void* g_f1, void* g_f2,
                                   void* edge_tiles, int B, int C, int H, int W, int device, void* stream) {
  return pivk::on_device(device, [&] {
    const auto st = (cudaStream_t)stream;
    auto* a = (const float*)f1;
    auto* b = (const float*)f2;
    auto* gg = (const float*)g;
    auto* o1 = (float*)g_f1;
    auto* o2 = (float*)g_f2;
    auto* n = (int*)edge_tiles;
    return vector_path(W, f1, f2, g) ? launch<true>(a, b, gg, o1, o2, n, B, C, H, W, st)
                                     : launch<false>(a, b, gg, o1, o2, n, B, C, H, W, st);
  });
}
