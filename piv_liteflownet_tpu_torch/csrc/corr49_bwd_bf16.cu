// The bf16 form of the cost volume's backward (csrc/corr49_bwd.cu), NCHW:
// bf16 maps, g = dL/dout [B, 49, H, W] and gradients,
//
//   g_f1[b,c,y,x] = (1/C) sum_d g[b,d,y,x]       * f2[b,c,y+dy,x+dx]
//   g_f2[b,c,y,x] = (1/C) sum_d g[b,d,y-dy,x-dx] * f1[b,c,y-dy,x-dx]
//
// with d = (dy+3)*7 + dx+3, every read outside the map zero, summed in f32
// and rounded once to bf16 on store. Both are gathers in a fixed order, so
// the result is the same from run to run. The TPU package has no kernel
// here: JAX takes the XLA VJP of the bf16 shift-stack in
// piv_liteflownet_tpu/ops/correlation.py:correlation_xla (:85). The port
// needs one because its forward is a kernel.
//
// Bound on an H100: bytes. At level 1 of a 256^2 batch-8 training step
// (C=64, maps 128^2) it reads f1, f2 and g once and writes both gradients
// once, ~80 MB, ~24 us at 3.35 TB/s; its 1.6 G multiply-adds of bf16
// products summed in f32 are tensor-core work, ~3 us at 989 TFLOP/s.
//
// Design: both gradients as banded products on mma.sync (csrc/corr_mma.cuh),
// with channels as M. For g_f1, output rows y, y+1 and 8 adjacent pixels p
// (two n8 tiles N, one per row), and one staged f2 row r:
//
//   g_f1[c, y+h, p] += sum_q f2[c, r, q] * G_h[q][p],   q = x-4 .. x+11 (K = 16)
//
// with G_h[q][p] = g[(dy, dx), y+h, p] on the band dx = q-p in [-3, 3]
// (dy = r-y-h) and 0 off it. For g_f2 the roles turn: the staged map is f1,
// the output pixel is q, and G_h[p][q] = g[(dy, dx), r, p] with
// dy = y+h-r, dx = q-p. A block takes one output of a tile of 32x8 pixels;
// each of its 16 warps owns 8 pixels of two rows and keeps the B fragments of
// its band, for the 8 staged rows r = y-3 .. y+4 of its row pair, in 28
// registers, built once per tile from g's windows staged in shared memory
// (unscaled: the 1/C goes on the f32 sums). Then per 16 channels it loads 8 A
// fragments (ldmatrix of the staged map rows) for 14 mma into 16 x 16 sums,
// scales and rounds them into its row pair's staged output in shared memory,
// from which the row pair's 4 warps store whole 32-pixel rows of the 16
// channels (8-byte pieces, 8 lanes a row). The 7 displacement rows of a pixel
// meet in one accumulator, so no sum leaves the block.
//
// One block per SM walks its tiles (a persistent grid; a tile's two outputs
// are adjacent tiles of the walk, so the two blocks read g's windows close
// together in time). The tiles start 4 columns left of the 16-byte grid
// (x0 = 32k - 4), so that a group's window, columns x-4 .. x+11, starts on
// the grid: TMA boxes start there, and ldmatrix reads 16-byte-aligned rows.
// Each tile is a job that loads g's windows into one of two buffers, then one
// job per 16 channels of the map (rows y0-3 .. y0+11, columns x0-4 .. x0+35)
// into a ring of three stages; out-of-map reads come back zero. g's window of
// plane d is columns x0-4 .. x0+35 of rows y0 .. y0+8 (g_f1) or of those rows
// shifted by -dy (g_f2): 7 boxes, one per displacement row. The rows past the
// need space the staged channels 1200 bytes apart and g's planes 720, so the
// 8 rows of an ldmatrix matrix, and the lanes' reads of g, fall on distinct
// banks. The warps run free of each other: each waits for a job's boxes on
// its buffer's mbarrier, and the last warp done with a buffer issues the job
// that takes it next. The vector path needs W % 8 == 0 and every tensor 16
// bytes aligned (TMA's rule for the tensor maps); the edge path fills the
// same buffers with plain 2-byte loads and stores, the block in step (two
// barriers a job).

#include "corr_mma.cuh"
#include "corr_tiles.cuh"
#include "device_guard.cuh"
#include "elem.cuh"

namespace {

using namespace corr_tiles;
using namespace corr_mma;
using elem::bf16;

constexpr int TX = 32;
constexpr int TY = 8;
constexpr int RP = TY / 2;           // row pairs
constexpr int NW = 4 * RP;           // warps: 4 groups of 8 pixels x the row pairs
constexpr int NT = 32 * NW;
constexpr int SH = TY + 2 * MD + 1;  // 15 rows of the map's box, y0-3 .. y0+11 (the last one spaces the channels)
constexpr int BW = TX + 8;           // 40 columns of every box, x0-4 .. x0+35
constexpr int CC = 16;               // channels per stage: one m tile
constexpr int NS = 3;                // stages in the ring
constexpr int MC = SH * BW;          // 600 values (1200 bytes, 75 x 16) between staged channels
constexpr int STAGE = CC * MC;
constexpr int GH = TY + 1;           // 9 rows of a g box (the last one spaces the planes)
constexpr int GP = GH * BW;          // 360 values (720 bytes) between g's planes
constexpr int GG = (ND * GP + 63) / 64 * 64;  // 2560 values between g's boxes of 7 planes (to 128 bytes)
constexpr int GBUF = ND * GG;        // one tile's g windows
constexpr int G_OFF = NS * STAGE;    // g's two buffers follow the ring
constexpr int OC = 2 * TX + 8;       // 72 values between the channels of a row pair's staged output (bank spread)
constexpr int ROUT = CC * OC;        // a row pair's staged output: 16 channels x 2 rows x 32 pixels
constexpr int OUT_OFF = G_OFF + 2 * GBUF;  // then two staged outputs of each row pair
constexpr int SMEM = (OUT_OFF + 2 * RP * ROUT) * 2 + 128;  // 147,840 bytes (with the 128 of alignment): one block per SM
static_assert((MC * 2) % 32 == 16 && (GP / 2) % 8 == 4 && (OC / 2) % 32 == 4,
              "ldmatrix rows, the lanes' reads of g and their stores on distinct banks");
static_assert((STAGE * 2) % 128 == 0 && (GG * 2) % 128 == 0 && ND * GP <= GG && (G_OFF * 2) % 128 == 0,
              "TMA destinations 128-byte aligned");

// The tensor maps of the vector path: f1 and f2 in boxes BW x SH x CC, g in boxes BW x GH x ND.
struct Maps {
  CUtensorMap f1, f2, g;
};

// The edge path's map job: channels c0 .. c0+CC-1 (mc: channel c0 of the tile's image; zeros past
// C, `left` channels remain) of tile (x0, y0), one value per copy, in the box's layout.
__device__ __forceinline__ void stage_map_scalar(bf16* st, const bf16* mc, int left, int x0, int y0, int H, int W,
                                                 int plane) {
  for (int i = threadIdx.x; i < CC * (SH - 1) * BW; i += NT) {
    const int ch = i / ((SH - 1) * BW);
    const int r = (i / BW) % (SH - 1);
    const int s = i % BW;
    const int gy = y0 - MD + r;
    const int gx = x0 - 4 + s;
    const bool ok = ch < left && gy >= 0 && gy < H && gx >= 0 && gx < W;
    copy1(st + ch * MC + r * BW + s, ok ? mc + ch * plane + gy * W + gx : mc, ok);
  }
}

// Where displacement row dyi's window rows start for output o: y0 (g_f1) or y0-dy (g_f2).
__device__ __forceinline__ int g_row0(int o, int y0, int dyi) { return o ? y0 + MD - dyi : y0; }

// The edge path's g windows, in the boxes' layout: plane d at (d / 7) * GG + (d % 7) * GP.
__device__ __forceinline__ void stage_g_scalar(bf16* sg, const bf16* gb, int o, int x0, int y0, int H, int W,
                                               int plane) {
  for (int i = threadIdx.x; i < NDISP * TY * BW; i += NT) {
    const int d = i / (TY * BW);
    const int r = (i / BW) % TY;
    const int s = i % BW;
    const int gy = g_row0(o, y0, d / ND) + r;
    const int gx = x0 - 4 + s;
    const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W;
    copy1(sg + (d / ND) * GG + (d % ND) * GP + r * BW + s, ok ? gb + d * plane + gy * W + gx : gb, ok);
  }
}

// Where tile `tile` of the launch lies: output o (0 g_f1, 1 g_f2), batch b, origin (x0, y0),
// x0 = 32k - 4.
struct Tile {
  int o, b, x0, y0;
};

__device__ __forceinline__ Tile tile_at(int tile, int nx, int ny) {
  const int rest = tile >> 1;
  const int tx = rest % nx;
  const int r2 = rest / nx;
  return Tile{tile & 1, r2 / ny, tx * TX - 4, (r2 % ny) * TY};
}

// The B fragments of a warp's band from g's windows sg: bq[ri][h][kh] holds G_h at window
// columns 2t+8kh+e (e = 0 low, 1 high) against pixel g, for window row ri. O is the output.
template <int O>
__device__ __forceinline__ void band_fragments(uint32_t (&bq)[8][2][2], const bf16* sg, int rp, int seg, int g,
                                               int t) {
  const auto* s16 = reinterpret_cast<const unsigned short*>(sg);
  const int s = 2 * t - g;  // column 2t+8kh+e meets pixel g at dx + 3 = s + 8kh + e - 1 (O = 0)
  // g_f1: plane (ri-h, dx+3), row 2rp+h, column 4+8seg+g (pixel g);
  // g_f2: plane (6+h-ri, 3-dx), row 2rp+h, column 8seg+2t+8kh+e (the map's column)
  const unsigned short* base = O == 0 ? s16 + s * GP + 2 * rp * BW + 4 + 8 * seg + g
                                      : s16 - s * GP + 2 * rp * BW + 8 * seg + 2 * t;
#pragma unroll
  for (int ri = 0; ri < 8; ++ri)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int kh = 0; kh < 2; ++kh) {
        uint32_t v[2] = {0u, 0u};
        if (ri - h >= 0 && ri - h < ND) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int dxc = 8 * kh + e - 1;  // dx + 3 = dxc + s
            if ((unsigned)(dxc + s) < (unsigned)ND)
              v[e] = O == 0 ? base[(ri - h) * GG + dxc * GP + h * BW]
                            : base[(6 + h - ri) * GG + (6 - dxc) * GP + h * BW + 8 * kh + e];
          }
        }
        bq[ri][h][kh] = v[0] | v[1] << 16;
      }
}

template <bool VEC>
__global__ void __launch_bounds__(NT, 1)
corr49_bwd_bf16_kernel(const __grid_constant__ Maps maps, const bf16* __restrict__ f1, const bf16* __restrict__ f2,
                       const bf16* __restrict__ g, bf16* __restrict__ g_f1, bf16* __restrict__ g_f2,
                       int* __restrict__ edge_tiles, int B, int C, int H, int W, float inv_c) {
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  __shared__ __align__(8) uint64_t full[NS + 2];  // the ring's stages, then g's two buffers: one phase per use
  __shared__ int done[NS + 2];                    // warps done with each buffer's job
  // TMA destinations need 128-byte alignment
  bf16* const smem = reinterpret_cast<bf16*>(((uintptr_t)smem_bytes + 127) & ~(uintptr_t)127);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int seg = warp & 3;  // pixels x0+8seg .. x0+8seg+7
  const int rp = warp >> 2;  // rows y0+2rp, y0+2rp+1
  const int gl = lane >> 2;
  const int t = lane & 3;
  const int nx = (W + 4 + TX - 1) / TX;
  const int ny = (H + TY - 1) / TY;
  const int n_tiles = 2 * nx * ny * B;
  const int groups = (C + CC - 1) / CC;
  const int plane = H * W;
  const int my_tiles = tiles_of_block(n_tiles);
  const int map_jobs = my_tiles * groups;  // map job m: channel group m % groups of the block's tile m / groups

  if (!VEC && tid == 0 && blockIdx.x == 0) *edge_tiles += n_tiles;

  // The vector path's jobs, issued by one thread: g's windows of the block's tile lt into buffer
  // lt & 1, and map job m into stage m % NS.
  auto issue_g = [&](int lt) {
    if (lt >= my_tiles) return;
    const Tile tl = tile_at((int)blockIdx.x + lt * (int)gridDim.x, nx, ny);
    bf16* dst = smem + G_OFF + (lt & 1) * GBUF;
    uint64_t* bar = &full[NS + (lt & 1)];
    mbar_expect_tx(bar, ND * ND * GP * 2);
    for (int dyi = 0; dyi < ND; ++dyi)
      tma_load(dst + dyi * GG, &maps.g, tl.x0 - 4, g_row0(tl.o, tl.y0, dyi), dyi * ND, tl.b, bar);
  };
  auto issue_map = [&](int m) {
    if (m >= map_jobs) return;
    const int lt = m / groups;
    const Tile tl = tile_at((int)blockIdx.x + lt * (int)gridDim.x, nx, ny);
    uint64_t* bar = &full[m % NS];
    mbar_expect_tx(bar, STAGE * 2);
    tma_load(smem + (m % NS) * STAGE, tl.o ? &maps.f1 : &maps.f2, tl.x0 - 4, tl.y0 - MD, (m - lt * groups) * CC,
             tl.b, bar);
  };
  if (tid == 0) {
    for (int i = 0; i < NS + 2; ++i) {
      done[i] = 0;
      if (VEC) mbar_init(&full[i], 1);
    }
    if (VEC) mbar_fence_init();
  }
  __syncthreads();
  if (VEC && tid == 0) {
    issue_g(0);
    issue_g(1);
    for (int m = 0; m < NS; ++m) issue_map(m);
  }

  // this lane's ldmatrix rows: channel (lane&7) + 8 (bit 3 of the lane) at window row 2rp + ri,
  // column 8seg + 8 (lane>>4) (matrices: channels 0-7, 8-15 at window columns 0-7, then at 8-15)
  const int a_off = ((lane & 7) + 8 * ((lane >> 3) & 1)) * MC + 2 * rp * BW + 8 * seg + 8 * (lane >> 4);
  uint32_t bq[8][2][2];

  int m = 0;
  for (int lt = 0; lt < my_tiles; ++lt) {
    const Tile tl = tile_at((int)blockIdx.x + lt * (int)gridDim.x, nx, ny);
    const int px = tl.x0 + 8 * seg;  // the warp's first pixel
    const bool live = px + 8 > 0 && px < W && tl.y0 + 2 * rp < H;
    bf16* const sg = smem + G_OFF + (lt & 1) * GBUF;
    if (VEC) {
      mbar_wait(&full[NS + (lt & 1)], (lt >> 1) & 1);
    } else {
      __syncthreads();
      stage_g_scalar(sg, g + (size_t)tl.b * NDISP * plane, tl.o, tl.x0, tl.y0, H, W, plane);
      __syncthreads();
    }
    if (live) {
      if (tl.o == 0)
        band_fragments<0>(bq, sg, rp, seg, gl, t);
      else
        band_fragments<1>(bq, sg, rp, seg, gl, t);
    }
    if (VEC && release(&done[NS + (lt & 1)], NW)) issue_g(lt + 2);

    const bf16* mb = tl.o ? f1 : f2;
    bf16* const ob = (tl.o ? g_f2 : g_f1) + (size_t)tl.b * C * plane + tl.x0;
    for (int grp = 0; grp < groups; ++grp, ++m) {
      const int slot = m % NS;
      const bf16* st = smem + slot * STAGE;
      if (VEC) {
        mbar_wait(&full[slot], (m / NS) & 1);
      } else {
        __syncthreads();
        stage_map_scalar(smem + slot * STAGE, mb + ((size_t)tl.b * C + (size_t)grp * CC) * plane, C - grp * CC,
                         tl.x0, tl.y0, H, W, plane);
        __syncthreads();
      }
      float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};  // [h]: channels gl, gl+8 x pixels 2t, 2t+1
      if (live) {
#pragma unroll
        for (int ri = 0; ri < 8; ++ri) {
          uint32_t a[4];
          ldsm_x4(a, st + a_off + ri * BW);
#pragma unroll
          for (int h = 0; h < 2; ++h)
            if (ri - h >= 0 && ri - h < ND) mma_bf16(acc[h], a, bq[ri][h][0], bq[ri][h][1]);
        }
      }
      if (VEC && release(&done[slot], NW)) issue_map(m + NS);
      // the sums, scaled and rounded, into the row pair's staged output m & 1, then its rows out
      bf16* const rout = smem + OUT_OFF + ((m & 1) * RP + rp) * ROUT;
      if (live) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int mm = 0; mm < 2; ++mm)
            *reinterpret_cast<uint32_t*>(rout + (gl + 8 * mm) * OC + h * TX + 8 * seg + 2 * t) =
                elem::pack2(acc[h][2 * mm] * inv_c, acc[h][2 * mm + 1] * inv_c);
      }
      bar_sync(1 + rp, 128);  // (the staged output m-1 was read before this barrier, so job m+1 may write it)
      for (int i = 32 * seg + lane; i < CC * 2 * (TX / 4); i += 128) {  // 4 pixels (8 bytes) a piece
        const int ch = i / (2 * TX / 4);
        const int h = (i / (TX / 4)) & 1;
        const int q = 4 * (i % (TX / 4));
        const int c = grp * CC + ch;
        const int y = tl.y0 + 2 * rp + h;
        const int x = tl.x0 + q;
        if (c >= C || y >= H || x + 4 <= 0 || x >= W) continue;
        const bf16* src = rout + ch * OC + h * TX + q;
        bf16* dst = ob + (size_t)c * plane + (size_t)y * W + q;
        if (VEC) {  // x = 0 mod 4 and W = 0 mod 8: a piece lies wholly inside the map or out
          *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(src);
        } else {
          for (int k = 0; k < 4; ++k)
            if (x + k >= 0 && x + k < W) dst[k] = src[k];
        }
      }
    }
  }
}

template <bool VEC>
int launch(const bf16* f1, const bf16* f2, const bf16* g, bf16* g_f1, bf16* g_f2, int* edge_tiles, int B, int C,
           int H, int W, cudaStream_t stream) {
  cudaError_t err = allow_smem<corr49_bwd_bf16_kernel<VEC>>(SMEM);
  if (err != cudaSuccess) return (int)err;
  Maps maps = {};
  if (VEC) {
    err = encode_nchw(&maps.f1, f1, B, C, H, W, BW, SH, CC);
    if (err == cudaSuccess) err = encode_nchw(&maps.f2, f2, B, C, H, W, BW, SH, CC);
    if (err == cudaSuccess) err = encode_nchw(&maps.g, g, B, NDISP, H, W, BW, GH, ND);
    if (err != cudaSuccess) return (int)err;
  }
  const int n_tiles = 2 * ((W + 4 + TX - 1) / TX) * ((H + TY - 1) / TY) * B;
  int blocks = 0;
  err = persistent_blocks(n_tiles, &blocks);
  if (err != cudaSuccess) return (int)err;
  corr49_bwd_bf16_kernel<VEC><<<blocks, NT, SMEM, stream>>>(maps, f1, f2, g, g_f1, g_f2, edge_tiles, B, C, H, W,
                                                             1.0f / (float)C);
  return (int)cudaGetLastError();
}

}  // namespace

// edge_tiles: one int on the device; a launch that takes the edge path (W not a multiple of 8,
// or a tensor not 16 bytes aligned) adds its number of tiles to it.
extern "C" int pivk_corr49_bwd_bf16(const void* f1, const void* f2, const void* g, void* g_f1, void* g_f2,
                                    void* edge_tiles, int B, int C, int H, int W, int device, void* stream) {
  return pivk::on_device(device, [&] {
    const auto st = (cudaStream_t)stream;
    auto* a = (const bf16*)f1;
    auto* b = (const bf16*)f2;
    auto* gg = (const bf16*)g;
    auto* o1 = (bf16*)g_f1;
    auto* o2 = (bf16*)g_f2;
    auto* n = (int*)edge_tiles;
    const bool vec = vector_path(W, f1, f2, g, 8) && vector_path(W, g_f1, g_f2, g_f1, 8);
    return vec ? launch<true>(a, b, gg, o1, o2, n, B, C, H, W, st)
               : launch<false>(a, b, gg, o1, o2, n, B, C, H, W, st);
  });
}
