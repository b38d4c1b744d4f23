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
// The 822 M multiply-adds are the next limit: fed one shared-memory load
// each, their operands alone would take about twice the byte bound.
//
// Design (csrc/corr_tiles.cuh): a block covers 32x8 output pixels with 448
// threads, one per (4-pixel group, row, displacement row dy). A thread keeps
// its 7 dx x 4 pixel sums in registers and, per channel, reads its 4 f1
// values with one 16-byte load and 12 f2 values with three, for 28
// multiply-adds: 7 per load instead of 1. The lanes of a quarter-warp are the
// 8 pixel groups of one row, so each 16-byte load is conflict-free. Channels
// are staged 8 at a time (f2 tile + halo, 14x40, and the f1 tile, 8x32) in a
// ring of three stages filled with cp.async, one barrier per group. f2 is
// read from device memory about 560/256 ~ 2.2 times, f1 and the output once;
// the output leaves as 16-byte stores. Odd widths take the edge path
// (4-byte copies, scalar stores).

#include "corr_tiles.cuh"
#include "device_guard.cuh"

namespace {

using namespace corr_tiles;

constexpr int TX = 32;
constexpr int TY = 8;
constexpr int NG = TX / R;            // 8 pixel groups per row
constexpr int NT = NG * TY * ND;      // 448 threads: (group, row, dy)
constexpr int SH = TY + 2 * MD;       // 14 staged f2 rows
constexpr int SW = TX + 2 * PAD_X;    // 40 staged f2 columns
constexpr int CC = 8;                 // channels per stage
constexpr int NS = 3;                 // stages in the ring
constexpr int F2_CH = SH * SW;        // floats of one staged f2 channel
constexpr int F1_CH = TY * TX;        // floats of one staged f1 channel
constexpr int F1_OFF = CC * F2_CH;    // f1 follows the CC f2 channels in a stage
constexpr int STAGE = CC * (F2_CH + F1_CH);
constexpr int SMEM = NS * STAGE * (int)sizeof(float);  // 78,336 bytes: two blocks per SM
// 16-byte chunks of one stage: the f2 chunks, then the f1 chunks
constexpr int F2_CHUNKS = CC * SH * (SW / 4);
constexpr int F1_CHUNKS = CC * TY * (TX / 4);
constexpr int SLOTS = (F2_CHUNKS + F1_CHUNKS + NT - 1) / NT;  // chunks per thread and stage

// One of a thread's chunks, the same in every channel group: where it lands in a stage and
// where it starts in the group's first channel. Worked out once, before the channel loop.
struct Chunk {
  int meta;  // dst | ch << 13 | from_f1 << 16, dst its float offset in the stage; -1: no chunk
  int src;   // float offset from the group's base pointer; -1: outside the map (zero-filled)
};
static_assert(STAGE <= (1 << 13) && CC <= 8, "Chunk::meta packs dst in 13 bits and ch in 3");

__device__ __forceinline__ Chunk chunk_of(int i, int x0, int y0, int H, int W, int plane) {
  int ch, gy, gx, dst, from_f1;
  if (i < F2_CHUNKS) {
    constexpr int PER_CH = SH * (SW / 4);
    ch = i / PER_CH;
    const int r = (i - ch * PER_CH) / (SW / 4);
    const int j = i - ch * PER_CH - r * (SW / 4);
    gy = y0 - MD + r;
    gx = x0 - PAD_X + 4 * j;
    dst = ch * F2_CH + r * SW + 4 * j;
    from_f1 = 0;
  } else if (i < F2_CHUNKS + F1_CHUNKS) {
    constexpr int PER_CH = TY * (TX / 4);
    i -= F2_CHUNKS;
    ch = i / PER_CH;
    const int r = (i - ch * PER_CH) / (TX / 4);
    const int j = i - ch * PER_CH - r * (TX / 4);
    gy = y0 + r;
    gx = x0 + 4 * j;
    dst = F1_OFF + ch * F1_CH + r * TX + 4 * j;
    from_f1 = 1;
  } else {
    return Chunk{-1, -1};
  }
  // W is a multiple of 4 on this path, so a chunk lies wholly inside the map or wholly out
  const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
  return Chunk{dst | ch << 13 | from_f1 << 16, in ? ch * plane + gy * W + gx : -1};
}

// Stage channels c0 .. c0+CC-1 (zeros past C) into st with 16-byte copies.
__device__ __forceinline__ void stage_vec(float* st, const Chunk (&chunks)[SLOTS], const float* f1c,
                                          const float* f2c, int left) {
#pragma unroll
  for (int m = 0; m < SLOTS; ++m) {
    const Chunk c = chunks[m];
    if (c.meta < 0) continue;
    const bool ok = c.src >= 0 && ((c.meta >> 13) & 7) < left;
    const float* base = (c.meta >> 16) ? f1c : f2c;
    cp_async16(st + (c.meta & 8191), ok ? base + c.src : base, ok);
  }
}

// The edge path: the same stage, one float per copy.
__device__ __forceinline__ void stage_scalar(float* st, const float* f1c, const float* f2c, int left,
                                             int x0, int y0, int H, int W, int plane) {
  for (int i = threadIdx.x; i < CC * F2_CH; i += NT) {
    const int ch = i / F2_CH;
    const int r = (i - ch * F2_CH) / SW;
    const int s = i - ch * F2_CH - r * SW;
    const int gy = y0 - MD + r;
    const int gx = x0 - PAD_X + s;
    const bool ok = ch < left && gy >= 0 && gy < H && gx >= 0 && gx < W;
    cp_async4(st + i, ok ? f2c + ch * plane + gy * W + gx : f2c, ok);
  }
  for (int i = threadIdx.x; i < CC * F1_CH; i += NT) {
    const int ch = i / F1_CH;
    const int r = (i - ch * F1_CH) / TX;
    const int s = i - ch * F1_CH - r * TX;
    const int gy = y0 + r;
    const int gx = x0 + s;
    const bool ok = ch < left && gy < H && gx < W;
    cp_async4(st + F1_OFF + i, ok ? f1c + ch * plane + gy * W + gx : f1c, ok);
  }
}

template <bool VEC>
__global__ void __launch_bounds__(NT, 2)
corr49_kernel(const float* __restrict__ f1, const float* __restrict__ f2, float* __restrict__ out,
              int* __restrict__ edge_tiles, int C, int H, int W, float inv_c) {
  extern __shared__ __align__(16) float smem[];

  const int tid = threadIdx.x;
  const int k = tid % NG;
  const int ty = (tid / NG) % TY;
  const int dy = tid / (NG * TY);  // displacement row, 0..6 for -3..3
  const int x0 = blockIdx.x * TX;
  const int y0 = blockIdx.y * TY;
  const int b = blockIdx.z;
  const int plane = H * W;
  const float* f1b = f1 + (size_t)b * C * plane;
  const float* f2b = f2 + (size_t)b * C * plane;

  if (!VEC && tid == 0 && blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0)
    *edge_tiles += (int)(gridDim.x * gridDim.y * gridDim.z);

  Chunk chunks[SLOTS];
  if (VEC) {
#pragma unroll
    for (int m = 0; m < SLOTS; ++m) chunks[m] = chunk_of(tid + m * NT, x0, y0, H, W, plane);
  }
  auto stage = [&](int g) {
    const int c0 = g * CC;
    float* st = smem + (g % NS) * STAGE;
    if (VEC)
      stage_vec(st, chunks, f1b + (size_t)c0 * plane, f2b + (size_t)c0 * plane, C - c0);
    else
      stage_scalar(st, f1b + (size_t)c0 * plane, f2b + (size_t)c0 * plane, C - c0, x0, y0, H, W, plane);
  };

  const int groups = (C + CC - 1) / CC;
  stage(0);
  cp_async_commit();
  if (groups > 1) stage(1);
  cp_async_commit();

  float acc[ND][R];
#pragma unroll
  for (int dx = 0; dx < ND; ++dx)
#pragma unroll
    for (int i = 0; i < R; ++i) acc[dx][i] = 0.f;

  for (int g = 0; g < groups; ++g) {
    cp_async_wait<1>();  // group g has landed (only g+1 may still be in flight)
    __syncthreads();     // ... for every thread, and every thread is done with group g-1
    if (g + 2 < groups) stage(g + 2);  // into the stage group g-1 used
    cp_async_commit();
    const float* st = smem + (g % NS) * STAGE;
    const float* f2row = st + (ty + dy) * SW + R * k;
    const float* f1px = st + F1_OFF + ty * TX + R * k;
#pragma unroll
    for (int ch = 0; ch < CC; ++ch) {
      const float4 a4 = *reinterpret_cast<const float4*>(f1px + ch * F1_CH);
      const float a[R] = {a4.x, a4.y, a4.z, a4.w};
      float v[ROWV];
      load_row(f2row + ch * F2_CH, v);
#pragma unroll
      for (int dx = 0; dx < ND; ++dx)
#pragma unroll
        for (int i = 0; i < R; ++i) acc[dx][i] = fmaf(a[i], v[i + dx + 1], acc[dx][i]);
    }
  }

  const int y = y0 + ty;
  const int x = x0 + R * k;
  if (y >= H || x >= W) return;
  float* o = out + ((size_t)b * NDISP + dy * ND) * plane + (size_t)y * W + x;
#pragma unroll
  for (int dx = 0; dx < ND; ++dx) {
    if (VEC) {
      *reinterpret_cast<float4*>(o + (size_t)dx * plane) =
          make_float4(acc[dx][0] * inv_c, acc[dx][1] * inv_c, acc[dx][2] * inv_c, acc[dx][3] * inv_c);
    } else {
#pragma unroll
      for (int i = 0; i < R; ++i)
        if (x + i < W) o[(size_t)dx * plane + i] = acc[dx][i] * inv_c;
    }
  }
}

template <bool VEC>
int launch(const float* f1, const float* f2, float* out, int* edge_tiles, int B, int C, int H, int W,
           cudaStream_t stream) {
  cudaError_t err = allow_smem<corr49_kernel<VEC>>(SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + TX - 1) / TX, (H + TY - 1) / TY, B);
  corr49_kernel<VEC><<<grid, NT, SMEM, stream>>>(f1, f2, out, edge_tiles, C, H, W, 1.0f / (float)C);
  return (int)cudaGetLastError();
}

}  // namespace

// edge_tiles: one int on the device; a launch that takes the edge path (W not a multiple
// of 4, or a tensor not 16 bytes aligned) adds its number of tiles to it.
extern "C" int pivk_corr49_f32(const void* f1, const void* f2, void* out, void* edge_tiles, int B, int C,
                               int H, int W, int device, void* stream) {
  return pivk::on_device(device, [&] {
    const auto s = (cudaStream_t)stream;
    auto* a = (const float*)f1;
    auto* b = (const float*)f2;
    auto* o = (float*)out;
    auto* n = (int*)edge_tiles;
    return vector_path(W, f1, f2, out) ? launch<true>(a, b, o, n, B, C, H, W, s)
                                       : launch<false>(a, b, o, n, B, C, H, W, s);
  });
}
