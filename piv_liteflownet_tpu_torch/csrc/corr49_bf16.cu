// The bf16 form of the 49-tap cost volume (csrc/corr49.cu), NCHW: bf16 maps
// and output,
//
//   out[b, (dy+3)*7 + dx+3, y, x] = (1/C) * sum_c f1[b,c,y,x] * f2[b,c,y+dy,x+dx]
//
// summed in f32 and rounded once to bf16 on store, f2 read as zero outside
// the map. Replaces the TPU kernels piv_liteflownet_tpu/ops/pallas_corr.py:
// correlation_pallas (:66) and correlation_planar_pallas (:162) in bf16,
// whose output takes f1's dtype; the planar one widens before its products,
// and bf16 products are exact in f32, so summing them in f32 is its function.
//
// Bound on an H100: bytes. At level 1 of a 1024^2 pair (C=64, 512^2) the two
// maps and the output move ~93 MB, ~28 us at 3.35 TB/s, against 822 M
// multiply-adds (~2 us at 989 TFLOP/s). Fed to f32 FMAs those cost more
// issue slots than the byte bound allows (each needs its operands widened and
// loaded from shared memory); on the tensor cores they are a few
// microseconds even at the band's 44 % use of each mma.
//
// Design: a banded product on mma.sync (csrc/corr_mma.cuh). For 8 adjacent
// pixels p of two output rows y, y+1 (the 16 rows M of an mma) and one f2 row
// r, the products with the 16 window columns q = x-4 .. x+11 around them
// (N = two n8 tiles) summed over 16 channels (K) hold, on the band
// 1 <= q-p <= 7, the cost of row y at dy = r-y and of row y+1 at dy = r-y-1,
// dx = q-p-4. A warp keeps these 2 x 16 x 16 sums for its 8 f2 rows
// r = y-3 .. y+4 (64 registers) over all channels, then writes the band, 7 of
// each row's 16 columns (a value of each row in one 32-bit store), to its row
// pair's staged output in shared memory, from which the row pair's 4 warps
// store whole 32-pixel rows of the 49 planes (8-byte streaming stores, 8
// lanes a row: scattered stores of a warp's own 8 pixels took as long as the
// rest of the kernel). Per 16 channels a warp loads one A fragment (f1, value
// pairs from shared memory) and 8 B fragments (ldmatrix.trans of the f2
// rows), for 16 mma.
//
// A block covers 32x8 output pixels with 16 warps (4 groups of 8 pixels x 4
// row pairs); one block per SM walks its tiles (a persistent grid). The tiles
// start 4 columns left of the 16-byte grid (x0 = 32k - 4), so that a group's
// window, columns x-4 .. x+11, starts on the grid: TMA boxes start there, and
// ldmatrix reads 16-byte-aligned rows. A stage is 16 channels of f2's window
// (rows y0-3 .. y0+11, columns x0-4 .. x0+35) and of f1 (rows y0 .. y0+7, the
// same columns), two TMA boxes completing on the stage's mbarrier; out-of-map
// reads come back zero. The row past the need (y0+11) spaces f2's staged
// channels 1200 bytes apart, so the 8 rows of an ldmatrix matrix fall on
// distinct banks; f1's channels lie 640 bytes apart, a 4-way conflict on the
// lanes' one read of f1 a stage, cheaper than the row that would remove it.
// The warps run free of each other: each waits for a stage's boxes on its
// mbarrier, and the last warp done with a stage issues the job three stages
// on into it (more stages in flight ran slower). f2 is read from L2 about
// 15*40/256 ~ 2.3 times, f1 1.25 times, the output written once.
// The vector path needs W % 8 == 0 and every tensor 16 bytes aligned (TMA's
// rule for the tensor maps); the edge path fills the same stages with plain
// 2-byte loads and stores, the block in step (two barriers a stage).

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
constexpr int RP = TY / 2;            // row pairs
constexpr int NW = 4 * RP;            // warps: 4 groups of 8 pixels x the row pairs
constexpr int NT = 32 * NW;
constexpr int SH = TY + 2 * MD + 1;   // 15 rows of f2's box, y0-3 .. y0+11 (the last one spaces the channels)
constexpr int BW = TX + 8;            // 40 columns of both boxes, x0-4 .. x0+35
constexpr int F1H = TY;               // 8 rows of f1's box, y0 .. y0+7
constexpr int CC = 16;                // channels per stage: one k-step
constexpr int NS = 3;                 // stages in the ring
constexpr int F2C = SH * BW;          // 600 values (1200 bytes, 75 x 16) between f2's channels
constexpr int F1C = F1H * BW;         // 320 values (640 bytes) between f1's channels
constexpr int F1_OFF = CC * F2C;      // f1's box follows f2's in a stage
constexpr int STAGE = F1_OFF + CC * F1C;
constexpr int OP = 2 * TX + 8;        // 72 values between the planes of a row pair's staged output (bank spread)
constexpr int ROUT = NDISP * OP;      // a row pair's staged output: 49 planes x 32 pixels x 2 rows (row fastest)
constexpr int OUT_OFF = NS * STAGE;
constexpr int SMEM = (OUT_OFF + RP * ROUT) * 2 + 128;  // 116,672 bytes (with the 128 of alignment): one block per SM
static_assert((F2C * 2) % 32 == 16 && (OP / 2) % 32 == 4, "ldmatrix rows and the band's stores on distinct banks");
static_assert((F1_OFF * 2) % 128 == 0 && (STAGE * 2) % 128 == 0, "TMA destinations 128-byte aligned");
static_assert((OUT_OFF * 2) % 16 == 0 && (ROUT * 2) % 16 == 0 && (OP * 2) % 16 == 0, "aligned output rows");

// The tensor maps of the vector path: f1 in boxes BW x F1H x CC, f2 in boxes BW x SH x CC.
struct Maps {
  CUtensorMap f1, f2;
};

// The edge path's stage: channels c0 .. c0+CC-1 (f1c, f2c: channel c0 of the tile's image; zeros
// past C, `left` channels remain) of tile (x0, y0), one value per copy, in the boxes' layout.
__device__ __forceinline__ void stage_scalar(bf16* st, const bf16* f1c, const bf16* f2c, int left, int x0, int y0,
                                             int H, int W, int plane) {
  for (int i = threadIdx.x; i < CC * (SH - 1) * BW; i += NT) {
    const int ch = i / ((SH - 1) * BW);
    const int r = (i / BW) % (SH - 1);
    const int s = i % BW;
    const int gy = y0 - MD + r;
    const int gx = x0 - 4 + s;
    const bool ok = ch < left && gy >= 0 && gy < H && gx >= 0 && gx < W;
    copy1(st + ch * F2C + r * BW + s, ok ? f2c + ch * plane + gy * W + gx : f2c, ok);
  }
  for (int i = threadIdx.x; i < CC * TY * BW; i += NT) {
    const int ch = i / (TY * BW);
    const int r = (i / BW) % TY;
    const int s = i % BW;
    const int gy = y0 + r;
    const int gx = x0 - 4 + s;
    const bool ok = ch < left && gy < H && gx >= 0 && gx < W;
    copy1(st + F1_OFF + ch * F1C + r * BW + s, ok ? f1c + ch * plane + gy * W + gx : f1c, ok);
  }
}

// Where tile `tile` of the launch lies: batch b, origin (x0, y0), x0 = 32k - 4.
struct Tile {
  int b, x0, y0;
};

__device__ __forceinline__ Tile tile_at(int tile, int nx, int ny) {
  const int tx = tile % nx;
  const int rest = tile / nx;
  return Tile{rest / ny, tx * TX - 4, (rest % ny) * TY};
}

template <bool VEC>
__global__ void __launch_bounds__(NT, 1)
corr49_bf16_kernel(const __grid_constant__ Maps maps, const bf16* __restrict__ f1, const bf16* __restrict__ f2,
                   bf16* __restrict__ out, int* __restrict__ edge_tiles, int B, int C, int H, int W, float inv_c) {
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  __shared__ __align__(8) uint64_t full[NS];  // stage s holds its job: one phase per use
  __shared__ int done[NS];                    // warps done with stage s's job
  // TMA destinations need 128-byte alignment
  bf16* const smem = reinterpret_cast<bf16*>(((uintptr_t)smem_bytes + 127) & ~(uintptr_t)127);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int seg = warp & 3;  // pixels x0+8seg .. x0+8seg+7
  const int rp = warp >> 2;  // rows y0+2rp, y0+2rp+1
  const int g = lane >> 2;
  const int t = lane & 3;
  const int nx = (W + 4 + TX - 1) / TX;
  const int ny = (H + TY - 1) / TY;
  const int n_tiles = nx * ny * B;
  const int groups = (C + CC - 1) / CC;
  const int plane = H * W;
  const int my_tiles = tiles_of_block(n_tiles);
  const int jobs = my_tiles * groups;  // job j: channel group j % groups of the block's tile j / groups

  if (!VEC && tid == 0 && blockIdx.x == 0) *edge_tiles += n_tiles;

  // The vector path's job j into stage j % NS: its two boxes, issued by one thread.
  auto issue = [&](int j) {
    if (j >= jobs) return;
    const int lt = j / groups;
    const int grp = j - lt * groups;
    const Tile tl = tile_at((int)blockIdx.x + lt * (int)gridDim.x, nx, ny);
    bf16* st = smem + (j % NS) * STAGE;
    uint64_t* bar = &full[j % NS];
    mbar_expect_tx(bar, STAGE * 2);
    tma_load(st, &maps.f2, tl.x0 - 4, tl.y0 - MD, grp * CC, tl.b, bar);
    tma_load(st + F1_OFF, &maps.f1, tl.x0 - 4, tl.y0, grp * CC, tl.b, bar);
  };
  if (tid == 0) {
    for (int i = 0; i < NS; ++i) {
      done[i] = 0;
      if (VEC) mbar_init(&full[i], 1);
    }
    if (VEC) mbar_fence_init();
  }
  __syncthreads();
  if (VEC && tid == 0)
    for (int j = 0; j < NS; ++j) issue(j);

  // this lane's reads of a stage: A, f1 channels 2t, 2t+1 (+8) of pixel 8seg+g (column 4+8seg+g)
  // in rows 2rp, 2rp+1; B (ldmatrix.trans), f2 channel (lane&7) + 8 (bit 3) at window row
  // 2rp + ri, column 8seg + 8 (lane>>4) (matrices: n tile 0 at channels 0-7, 8-15, then n tile 1)
  const int a_off = F1_OFF + 2 * t * F1C + 2 * rp * BW + 4 + 8 * seg + g;
  const int b_off = ((lane & 7) + 8 * ((lane >> 3) & 1)) * F2C + 2 * rp * BW + 8 * seg + 8 * (lane >> 4);
  // acc[ri][n][2h+e]: pixel g of row y0+2rp+h against window column 8n+2t+e of window row 2rp+ri,
  // displacement (dy, dx) = (ri-h-3, 8n+2t+e-g-4). acc[dyi][n][e] (h = 0) and acc[dyi+1][n][2+e]
  // (h = 1) are the same displacement and pixel in the two rows: one 32-bit store into the row
  // pair's staged output (plane d, pixel 8seg+g, row h; planes OP apart), at so plus a constant
  // of (dyi, n, e)
  const int s = 2 * t - g;
  bf16* const rout = smem + OUT_OFF + rp * ROUT;
  bf16* const so = rout + s * OP + 2 * (8 * seg + g);
  float acc[8][2][4];

  int j = 0;
  for (int lt = 0; lt < my_tiles; ++lt) {
    const Tile tl = tile_at((int)blockIdx.x + lt * (int)gridDim.x, nx, ny);
    const int px = tl.x0 + 8 * seg;  // the warp's first pixel
    const bool live = px + 8 > 0 && px < W && tl.y0 + 2 * rp < H;
#pragma unroll
    for (int ri = 0; ri < 8; ++ri)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[ri][n][i] = 0.f;
    for (int grp = 0; grp < groups; ++grp, ++j) {
      const int slot = j % NS;
      const bf16* st = smem + slot * STAGE;
      if (VEC) {
        mbar_wait(&full[slot], (j / NS) & 1);
      } else {
        __syncthreads();  // every warp is done with the stage
        const size_t base = ((size_t)tl.b * C + (size_t)grp * CC) * plane;
        stage_scalar(smem + slot * STAGE, f1 + base, f2 + base, C - grp * CC, tl.x0, tl.y0, H, W, plane);
        __syncthreads();
      }
      if (live) {
        const auto* a16 = reinterpret_cast<const unsigned short*>(st) + a_off;
        uint32_t a[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {  // rows g (h = 0), g+8 (h = 1); channels 2t (+8)
          const int o = (r & 1) * BW + (r >> 1) * 8 * F1C;
          a[r] = (uint32_t)a16[o] | (uint32_t)a16[o + F1C] << 16;
        }
#pragma unroll
        for (int ri = 0; ri < 8; ++ri) {
          uint32_t bq[4];
          ldsm_x4_trans(bq, st + b_off + ri * BW);
          mma_bf16(acc[ri][0], a, bq[0], bq[1]);
          mma_bf16(acc[ri][1], a, bq[2], bq[3]);
        }
      }
      if (VEC && release(&done[slot], NW)) issue(j + NS);
    }
    // the band into the row pair's staged output, then its rows out
    bar_sync(1 + rp, 128);  // the row pair's previous rows are out
    if (live) {
#pragma unroll
      for (int dyi = 0; dyi < ND; ++dyi)
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int dxc = 8 * n + e - 1;  // dx + 3 = dxc + s
            if ((unsigned)(dxc + s) < (unsigned)ND)
              *reinterpret_cast<uint32_t*>(so + (dyi * ND + dxc) * OP) =
                  elem::pack2(acc[dyi][n][e] * inv_c, acc[dyi + 1][n][2 + e] * inv_c);
          }
    }
    bar_sync(1 + rp, 128);
    const int y = tl.y0 + 2 * rp;
    bf16* ob = out + (size_t)tl.b * NDISP * plane + (size_t)y * W + tl.x0;
    for (int i = 32 * seg + lane; i < NDISP * (TX / 4); i += 128) {  // 4 pixels of both rows a unit
      const int d = i / (TX / 4);
      const int q = 4 * (i % (TX / 4));
      const int x = tl.x0 + q;
      if (y >= H || x + 4 <= 0 || x >= W) continue;
      const uint4 v = *reinterpret_cast<const uint4*>(rout + d * OP + 2 * q);  // (pixel, row) pairs
      const uint2 r0 = make_uint2(__byte_perm(v.x, v.y, 0x5410), __byte_perm(v.z, v.w, 0x5410));
      const uint2 r1 = make_uint2(__byte_perm(v.x, v.y, 0x7632), __byte_perm(v.z, v.w, 0x7632));
      bf16* dst = ob + (size_t)d * plane + q;
      if (VEC) {  // x = 0 mod 4 and W = 0 mod 8: a piece lies wholly inside the map or out
        // streaming stores (evict first): the output is not read again here, the maps' rows are
        __stcs(reinterpret_cast<uint2*>(dst), r0);
        if (y + 1 < H) __stcs(reinterpret_cast<uint2*>(dst + W), r1);
      } else {
        const uint32_t w0[4] = {r0.x, r0.x >> 16, r0.y, r0.y >> 16}, w1[4] = {r1.x, r1.x >> 16, r1.y, r1.y >> 16};
        for (int k = 0; k < 4; ++k) {
          if (x + k < 0 || x + k >= W) continue;
          dst[k] = __ushort_as_bfloat16((unsigned short)w0[k]);
          if (y + 1 < H) dst[W + k] = __ushort_as_bfloat16((unsigned short)w1[k]);
        }
      }
    }
  }
}

template <bool VEC>
int launch(const bf16* f1, const bf16* f2, bf16* out, int* edge_tiles, int B, int C, int H, int W,
           cudaStream_t stream) {
  cudaError_t err = allow_smem<corr49_bf16_kernel<VEC>>(SMEM);
  if (err != cudaSuccess) return (int)err;
  Maps maps = {};
  if (VEC) {
    err = encode_nchw(&maps.f1, f1, B, C, H, W, BW, F1H, CC);
    if (err == cudaSuccess) err = encode_nchw(&maps.f2, f2, B, C, H, W, BW, SH, CC);
    if (err != cudaSuccess) return (int)err;
  }
  const int n_tiles = ((W + 4 + TX - 1) / TX) * ((H + TY - 1) / TY) * B;
  int blocks = 0;
  err = persistent_blocks(n_tiles, &blocks);
  if (err != cudaSuccess) return (int)err;
  corr49_bf16_kernel<VEC><<<blocks, NT, SMEM, stream>>>(maps, f1, f2, out, edge_tiles, B, C, H, W, 1.0f / (float)C);
  return (int)cudaGetLastError();
}

}  // namespace

// edge_tiles: one int on the device; a launch that takes the edge path (W not a multiple of 8,
// or a tensor not 16 bytes aligned) adds its number of tiles to it.
extern "C" int pivk_corr49_bf16(const void* f1, const void* f2, void* out, void* edge_tiles, int B, int C,
                                int H, int W, int device, void* stream) {
  return pivk::on_device(device, [&] {
    const auto s = (cudaStream_t)stream;
    auto* a = (const bf16*)f1;
    auto* b = (const bf16*)f2;
    auto* o = (bf16*)out;
    auto* n = (int*)edge_tiles;
    return vector_path(W, f1, f2, out, 8) ? launch<true>(a, b, o, n, B, C, H, W, s)
                                          : launch<false>(a, b, o, n, B, C, H, W, s);
  });
}
