// 49-tap (7x7) cost volume on phase-subsampled feature maps, NCHW, in float32
// or bfloat16 (maps and output of one type).
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
//
// The bf16 form (pivk_corr49_bf16) is the same function, summed in f32 and
// rounded once to bf16 on store (the TPU kernel's output is in f1's dtype).
// It stages bf16 through the same ring, 8 values per 16-byte copy, with the
// f2 window widened to columns x0-8 .. x0+TX+7 so that every chunk stays
// aligned (Layout below); a thread widens what it reads to f32 registers
// (8-byte shared loads of 4 values) and the output leaves as 8-byte stores.
// Its vector path needs W % 8 == 0; its edge path stages with plain 2-byte
// loads and stores, since cp.async copies no less than 4 bytes. It moves
// half the f32 form's bytes.

#include "corr_tiles.cuh"
#include "device_guard.cuh"

namespace {

using namespace corr_tiles;

constexpr int TX = 32;
constexpr int TY = 8;
constexpr int NG = TX / R;            // 8 pixel groups per row
constexpr int NT = NG * TY * ND;      // 448 threads: (group, row, dy)
constexpr int SH = TY + 2 * MD;       // 14 staged f2 rows
constexpr int CC = 8;                 // channels per stage
constexpr int NS = 3;                 // stages in the ring

// The shared-memory layout of one element type T (float or bf16). Staged f2 columns start PAD
// columns left of the tile, a whole 16-byte chunk of the map: 4 in f32 (the 3-pixel halo and one
// more), 8 in bf16.
template <typename T>
struct Layout {
  static constexpr int V = 16 / (int)sizeof(T);        // values per 16-byte chunk
  static constexpr int PAD = V > PAD_X ? V : PAD_X;    // 4 / 8
  static constexpr int SW = TX + 2 * PAD;              // 40 / 48 staged f2 columns
  static constexpr int F2_CH = SH * SW;                // values of one staged f2 channel
  static constexpr int F1_CH = TY * TX;                // values of one staged f1 channel
  static constexpr int F1_OFF = CC * F2_CH;            // f1 follows the CC f2 channels in a stage
  static constexpr int STAGE = CC * (F2_CH + F1_CH);
  static constexpr int SMEM = NS * STAGE * (int)sizeof(T);  // 78,336 bytes in f32 (two blocks per SM), 44,544 in bf16
  // 16-byte chunks of one stage: the f2 chunks, then the f1 chunks
  static constexpr int F2_CHUNKS = CC * SH * (SW / V);
  static constexpr int F1_CHUNKS = CC * TY * (TX / V);
  static constexpr int SLOTS = (F2_CHUNKS + F1_CHUNKS + NT - 1) / NT;  // chunks per thread and stage
  static_assert(STAGE <= (1 << 13) && CC <= 8, "Chunk::meta packs dst in 13 bits and ch in 3");
  static_assert((SW * sizeof(T)) % 16 == 0 && (F1_OFF * sizeof(T)) % 16 == 0, "staged rows stay aligned");
};

// One of a thread's chunks, the same in every channel group: where it lands in a stage and
// where it starts in the group's first channel. Worked out once, before the channel loop.
struct Chunk {
  int meta;  // dst | ch << 13 | from_f1 << 16, dst its value offset in the stage; -1: no chunk
  int src;   // value offset from the group's base pointer; -1: outside the map (zero-filled)
};

template <typename T>
__device__ __forceinline__ Chunk chunk_of(int i, int x0, int y0, int H, int W, int plane) {
  using L = Layout<T>;
  int ch, gy, gx, dst, from_f1;
  if (i < L::F2_CHUNKS) {
    constexpr int PER_ROW = L::SW / L::V;
    constexpr int PER_CH = SH * PER_ROW;
    ch = i / PER_CH;
    const int r = (i - ch * PER_CH) / PER_ROW;
    const int j = i - ch * PER_CH - r * PER_ROW;
    gy = y0 - MD + r;
    gx = x0 - L::PAD + L::V * j;
    dst = ch * L::F2_CH + r * L::SW + L::V * j;
    from_f1 = 0;
  } else if (i < L::F2_CHUNKS + L::F1_CHUNKS) {
    constexpr int PER_ROW = TX / L::V;
    constexpr int PER_CH = TY * PER_ROW;
    i -= L::F2_CHUNKS;
    ch = i / PER_CH;
    const int r = (i - ch * PER_CH) / PER_ROW;
    const int j = i - ch * PER_CH - r * PER_ROW;
    gy = y0 + r;
    gx = x0 + L::V * j;
    dst = L::F1_OFF + ch * L::F1_CH + r * TX + L::V * j;
    from_f1 = 1;
  } else {
    return Chunk{-1, -1};
  }
  // W is a multiple of V on this path, so a chunk lies wholly inside the map or wholly out
  const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
  return Chunk{dst | ch << 13 | from_f1 << 16, in ? ch * plane + gy * W + gx : -1};
}

// Stage channels c0 .. c0+CC-1 (zeros past C) into st with 16-byte copies.
template <typename T>
__device__ __forceinline__ void stage_vec(T* st, const Chunk (&chunks)[Layout<T>::SLOTS], const T* f1c,
                                          const T* f2c, int left) {
#pragma unroll
  for (int m = 0; m < Layout<T>::SLOTS; ++m) {
    const Chunk c = chunks[m];
    if (c.meta < 0) continue;
    const bool ok = c.src >= 0 && ((c.meta >> 13) & 7) < left;
    const T* base = (c.meta >> 16) ? f1c : f2c;
    cp_async16(st + (c.meta & 8191), ok ? base + c.src : base, ok);
  }
}

// One value of the edge path: a 4-byte cp.async in f32; in bf16, whose values are 2 bytes and
// cp.async's least copy is 4, a plain load and store (visible after the barrier that precedes
// the stage's use).
__device__ __forceinline__ void copy1(float* dst, const float* src, bool ok) { cp_async4(dst, src, ok); }
__device__ __forceinline__ void copy1(elem::bf16* dst, const elem::bf16* src, bool ok) {
  *dst = ok ? *src : __float2bfloat16_rn(0.f);
}

// The edge path: the same stage, one value per copy.
template <typename T>
__device__ __forceinline__ void stage_scalar(T* st, const T* f1c, const T* f2c, int left,
                                             int x0, int y0, int H, int W, int plane) {
  using L = Layout<T>;
  for (int i = threadIdx.x; i < CC * L::F2_CH; i += NT) {
    const int ch = i / L::F2_CH;
    const int r = (i - ch * L::F2_CH) / L::SW;
    const int s = i - ch * L::F2_CH - r * L::SW;
    const int gy = y0 - MD + r;
    const int gx = x0 - L::PAD + s;
    const bool ok = ch < left && gy >= 0 && gy < H && gx >= 0 && gx < W;
    copy1(st + i, ok ? f2c + ch * plane + gy * W + gx : f2c, ok);
  }
  for (int i = threadIdx.x; i < CC * L::F1_CH; i += NT) {
    const int ch = i / L::F1_CH;
    const int r = (i - ch * L::F1_CH) / TX;
    const int s = i - ch * L::F1_CH - r * TX;
    const int gy = y0 + r;
    const int gx = x0 + s;
    const bool ok = ch < left && gy < H && gx < W;
    copy1(st + L::F1_OFF + i, ok ? f1c + ch * plane + gy * W + gx : f1c, ok);
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(NT, 2)
corr49_kernel(const T* __restrict__ f1, const T* __restrict__ f2, T* __restrict__ out,
              int* __restrict__ edge_tiles, int C, int H, int W, float inv_c) {
  using L = Layout<T>;
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  T* smem = reinterpret_cast<T*>(smem_bytes);

  const int tid = threadIdx.x;
  const int k = tid % NG;
  const int ty = (tid / NG) % TY;
  const int dy = tid / (NG * TY);  // displacement row, 0..6 for -3..3
  const int x0 = blockIdx.x * TX;
  const int y0 = blockIdx.y * TY;
  const int b = blockIdx.z;
  const int plane = H * W;
  const T* f1b = f1 + (size_t)b * C * plane;
  const T* f2b = f2 + (size_t)b * C * plane;

  if (!VEC && tid == 0 && blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0)
    *edge_tiles += (int)(gridDim.x * gridDim.y * gridDim.z);

  Chunk chunks[L::SLOTS];
  if (VEC) {
#pragma unroll
    for (int m = 0; m < L::SLOTS; ++m) chunks[m] = chunk_of<T>(tid + m * NT, x0, y0, H, W, plane);
  }
  auto stage = [&](int g) {
    const int c0 = g * CC;
    T* st = smem + (g % NS) * L::STAGE;
    if (VEC)
      stage_vec<T>(st, chunks, f1b + (size_t)c0 * plane, f2b + (size_t)c0 * plane, C - c0);
    else
      stage_scalar<T>(st, f1b + (size_t)c0 * plane, f2b + (size_t)c0 * plane, C - c0, x0, y0, H, W, plane);
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
    const T* st = smem + (g % NS) * L::STAGE;
    // the 12 values from x0 + 4k - 4 on: column 4k + PAD - 4 of the staged row
    const T* f2row = st + (ty + dy) * L::SW + R * k + (L::PAD - PAD_X);
    const T* f1px = st + L::F1_OFF + ty * TX + R * k;
#pragma unroll
    for (int ch = 0; ch < CC; ++ch) {
      float a[R];
      elem::load4(f1px + ch * L::F1_CH, a);
      float v[ROWV];
      load_row(f2row + ch * L::F2_CH, v);
#pragma unroll
      for (int dx = 0; dx < ND; ++dx)
#pragma unroll
        for (int i = 0; i < R; ++i) acc[dx][i] = fmaf(a[i], v[i + dx + 1], acc[dx][i]);
    }
  }

  const int y = y0 + ty;
  const int x = x0 + R * k;
  if (y >= H || x >= W) return;
  T* o = out + ((size_t)b * NDISP + dy * ND) * plane + (size_t)y * W + x;
#pragma unroll
  for (int dx = 0; dx < ND; ++dx) {
    if (VEC) {
      elem::store4(o + (size_t)dx * plane, acc[dx], inv_c);
    } else {
#pragma unroll
      for (int i = 0; i < R; ++i)
        if (x + i < W) elem::store(o + (size_t)dx * plane + i, acc[dx][i] * inv_c);
    }
  }
}

template <typename T, bool VEC>
int launch(const T* f1, const T* f2, T* out, int* edge_tiles, int B, int C, int H, int W,
           cudaStream_t stream) {
  constexpr int smem = Layout<T>::SMEM;
  cudaError_t err = allow_smem<corr49_kernel<T, VEC>>(smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + TX - 1) / TX, (H + TY - 1) / TY, B);
  corr49_kernel<T, VEC><<<grid, NT, smem, stream>>>(f1, f2, out, edge_tiles, C, H, W, 1.0f / (float)C);
  return (int)cudaGetLastError();
}

template <typename T>
int run(const void* f1, const void* f2, void* out, void* edge_tiles, int B, int C, int H, int W,
        int device, void* stream) {
  return pivk::on_device(device, [&] {
    const auto s = (cudaStream_t)stream;
    auto* a = (const T*)f1;
    auto* b = (const T*)f2;
    auto* o = (T*)out;
    auto* n = (int*)edge_tiles;
    return vector_path(W, f1, f2, out, Layout<T>::V) ? launch<T, true>(a, b, o, n, B, C, H, W, s)
                                                     : launch<T, false>(a, b, o, n, B, C, H, W, s);
  });
}

}  // namespace

// edge_tiles: one int on the device; a launch that takes the edge path (W not a whole number
// of 16-byte chunks, or a tensor not 16 bytes aligned) adds its number of tiles to it.
extern "C" int pivk_corr49_f32(const void* f1, const void* f2, void* out, void* edge_tiles, int B, int C,
                               int H, int W, int device, void* stream) {
  return run<float>(f1, f2, out, edge_tiles, B, C, H, W, device, stream);
}

extern "C" int pivk_corr49_bf16(const void* f1, const void* f2, void* out, void* edge_tiles, int B, int C,
                                int H, int W, int device, void* stream) {
  return run<elem::bf16>(f1, f2, out, edge_tiles, B, C, H, W, device, stream);
}
