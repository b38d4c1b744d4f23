// A whole NetE conv stack in one launch: a float32 form and a bfloat16 form.
//
//   x_0 = concat(parts)                       (never materialised in float32)
//   x_l = act_l(conv_l(x_{l-1}) + bias_l),    l = 1 .. n_layers
//
// Every conv is SAME, stride 1, k x k with k in {1, 3, 5, 7}; act_l is
// LeakyReLU(0.1), except after the last conv when last_linear is set. The
// parts and the output are NCHW. Replaces the TPU kernel
// piv_liteflownet_tpu/ops/pallas_conv.py:conv_chain_pallas; its semantic
// reference is conv_chain_xla there, and the port's plain version is
// ops/conv_chain.py:conv_chain_plain.
//
// Bound on an H100 SXM (700 W): operations. Float32 accuracy on the tensor
// cores takes three TF32 products per multiply-add (below), so the rate is
// 495 / 3 = 165 TFLOP/s: the piv v1 level-1 S stack of a 1024^2 pair (245,056
// multiply-adds per pixel, 514 GFLOP) takes at least 3.11 ms, the R stack
// (916 GFLOP) 5.55 ms; their inputs are 0.5 GB, 0.17 ms at 3.35 TB/s. The
// bf16 form runs at the dense bf16 rate, 989 TFLOP/s: 0.52 ms for the S
// stack, 0.93 ms for the R stack (inputs 0.27 GB, 0.08 ms).
//
// The layers run in turn inside one cooperative launch: a persistent grid
// (as many blocks as fit on the card at once) walks the output tiles of a
// layer, then cooperative_groups' grid.sync() separates it from the next.
// (The TPU kernel keeps a tile's whole chain on chip; a 128-channel f32
// intermediate of a halo-8 tile does not fit the 227 KB a block may take.)
// Intermediates go through two scratch buffers the caller allocates, NHWC
// with a pixel stride of cout rounded up to 16 bytes (4 floats, 8 bf16), so
// that every copy of a channel group is 16 bytes and aligned. A buffer is
// written inside this launch and re-read two layers later, and L1 is not
// coherent across blocks: every read of the scratch bypasses L1
// (cp.async.cg, __ldcg, TMA). Only the read-only parts and weights may go
// through L1.
//
// Float32 form. Layers with cout > 8 (every layer of the M, S and R stacks
// but the last 2-channel conv of M and S) are implicit GEMMs on the tensor
// cores, with mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 (CUTLASS's
// SM80_16x8x8_F32TF32TF32F32_TN): M = a tile's 8 x 32 output pixels, N = BN
// = 64 or 32 output channels (ops/conv_chain.py:layer_plan picks it and
// passes it in), K = cin x k x k walked as (16-channel chunk, ky, kx); eight
// warps, warp (wm, wn) on output rows 2wm, 2wm+1 (four m16 tiles) x BN/2
// channels. Float32 accuracy with the 3xTF32 split (CUTLASS's
// OpMultiplyAddFastF32): x = hi + lo, hi = cvt.rna.tf32(x), lo =
// cvt.rna.tf32(x - hi), a.b ~ lo_a.hi_b + hi_a.lo_b + hi_a.hi_b; the dropped
// lo.lo term is below 2^-22 of a product. The weights come split from the
// packer (ops/conv_chain.py:tf32_split); each staged input chunk is split
// once in shared memory (hi in place, lo beside it), as every element serves
// up to k^2 taps of two warps. The tensor cores do not round an mma's sum
// to nearest: each mma into one accumulator lost up to an ulp of it, toward
// zero, and over the ~480 mma of an output that missed the 1e-5 tolerance
// on the card. So the 6k mma of a step go into a fresh sum that is
// added into the accumulator with an FADD; the two register sets (2 x 64
// floats at BN 64) are why BN stops at 64. A two-stage cp.async ring
// overlaps the loads of step s+1 with the products of step s, one
// __syncthreads() per step; a step is one (chunk, ky): the weight slice
// [kx][hi|lo][BN][16 ci] and, at ky = 0, the chunk's input tile with its
// halo, [pixel][16 ci]. Rows of both are CS = 20 words apart, so that the
// eight 16-byte ldmatrix rows of neighbouring pixels or channels fall in
// distinct banks. Each staged chunk serves all k^2 taps as shifted windows.
// SAME padding, the ragged edge and channels past cin use the zero-fill form
// of cp.async (src-size 0). Layer 0 reads the NCHW parts with 4-byte copies,
// later layers the NHWC scratch with 16-byte ones.
//
// Layers with cout <= 8 (1.3 % of the S stack's work) are direct
// convolutions with exact f32 FMAs: 32 x 32 output pixels x cout (rounded up
// to 2, 4 or 8) channels per block, 8 input channels per pass, each thread
// 4 columns x all the channels.
//
// Bfloat16 form (its own kernel, conv_chain_bf16_kernel): what the TPU kernel
// does in bf16 (pallas_conv.py:89, :171-175, :216-271): bf16 parts, weights
// and biases; every tap, channel and part summed in f32; the bias (widened)
// added and the LeakyReLU applied in f32; one rounding per layer, to nearest
// even, to the bf16 intermediate or output. A first phase of the launch
// repacks the NCHW parts into the NHWC scratch that layer 0 then reads like
// any later layer (a bf16 element is 2 bytes, W may be odd, and TMA copies
// 16-byte channel groups): each thread moves 8 channels x 8 columns of a row,
// loads along the rows, a transposition in registers, 16-byte stores of a
// pixel's 8 channels; it moves the parts' bytes twice more (0.16 ms of bytes
// at the S stack). The layers of cout <= 8 widen their bf16 inputs and
// weights to f32 in shared memory and run the f32 FMA loop above on the two
// consumer warpgroups (below). Between phases the block meets at a grid
// barrier of its own (grid_sync_producer: cooperative_groups' algorithm on a
// counter that follows buf1, zeroed by the launch), whose divergent part
// runs in the producer warpgroup.
//
// The tensor-core layers of the bf16 form are built for Hopper. A block is
// three warpgroups (384 threads, one block per SM): warpgroup 0 produces,
// warpgroups 1 and 2 consume; setmaxnreg gives the producer 40 registers and
// the consumers 232. One producer thread issues every copy into two rings of
// shared-memory stages, each stage with a full and an empty mbarrier:
// - the input ring (3 stages): a 16-channel chunk of the input tile with its
//   halo, (rows + k - 1) x 64 pixels, as two TMA loads (cp.async.bulk.tensor,
//   a 4-D tensor map (C, W, H, B) of the NHWC scratch per layer, encoded on
//   the host) of one 8-channel plane each, [row][column][8 channels]. The
//   loads' out-of-bounds zero fill is the SAME padding, the ragged edge and
//   the channels past cin; start coordinates may be negative.
// - the weight ring (6 stages): a (chunk, ky) slice of the packed weights,
//   [kx][n / 8][ci / 8][8 n][8 ci], one 1-D cp.async.bulk of k x BN x 32
//   bytes, laid out by ops/conv_chain.py:_pack_layer exactly as the B
//   descriptor reads it.
// The producer runs ahead across (chunk, ky) steps, tiles and layers; the
// consumers wait on a stage's full barrier, and after the products that read
// it have completed, one lane of each consumer warp arrives on its empty
// barrier (8 arrivals). The barriers are initialised once per launch; both
// sides walk the same sequence of stages, so their phases carry across tiles
// and layers. Layer l's epilogue writes the scratch with generic stores and
// layer l+1 reads it through TMA (the async proxy), so a fence.proxy.async
// comes before each grid barrier on the writing side and after it on the
// reading side. No divergent branch lies on the consumers' path between
// their wgmma (ptxas would serialise the wgmma, C7520): the barrier waits
// spin inside their PTX, the arrivals are predicated instructions, the
// warpgroup index is broadcast from lane 0, and the grid barrier's one-thread
// part runs in the producer warpgroup.
//
// Products: wgmma.mma_async.sync.aligned.m64nNk16.f32.bf16.bf16, N = BN, the
// layer's channel tile (128, 96, 64 or 32; ops/conv_chain.py:layer_plan picks,
// of those that fit the shared memory, the one of fewest channel tiles, then
// of fewest channels computed), so a 128-channel layer stages and reads each input
// tile once per pixel tile. M is pixels: a tile is tc_rows(BN) output rows
// (4 at BN 128 and 96, 512 / BN below) by 64 - (k - 1) columns, and each
// consumer warpgroup holds half its rows, one m64 block a row, BN / 2 f32
// sums a thread per block (at most 128). The A route is shared memory,
// through a no-swizzle descriptor, because the staged rows are 64 pixels
// wide: a tile's output pixel (r, c) at flattened index 64 r + c reads tap
// (ky, kx) at staged index 64 (r + ky) + c + kx, so the window of every tap
// is the same 64-pixel stretch at another 16-byte-aligned start address
// (64 (m + ky) + kx pixels of 16 bytes in), 8-pixel core matrices 128 bytes
// apart (SBO), the second 8 channels a plane apart (LBO). The k - 1 columns
// past each row's valid ones are computed and dropped (their windows run
// into the next row, and the last row's into 8 spare pixels). B is read
// through a no-swizzle descriptor too: core matrices of 8 channels x 8
// input channels, 128 bytes, the second 8 input channels 128 bytes on
// (LBO), the next 8 channels 256 on (SBO); each is a contiguous 128 bytes,
// so neither operand meets a bank conflict without a swizzle. K is walked
// as (16-channel chunk, ky, kx); a (chunk, ky) step issues k x rows / 2
// wgmma per warpgroup as one commit group and, with the next group in flight,
// waits for the one before it and frees that group's stages. The tensor
// cores do not round an instruction's sum to nearest: an output takes at
// most ceil(386 / 16) x 9 = 225 k16 instructions (the v1 level-6 S stack),
// so the truncation drift stays below 225 x 2^-23 of the sum, under 1 % of
// a bf16 ulp (2^-8), with the sums straight in the accumulators. The
// epilogue adds the bias and applies the LeakyReLU in f32, rounds once to
// bf16 into a [64 pixels][BN + 8] tile in shared memory per warpgroup (the
// 8 of padding spread a quad's rows over the banks), and writes the NHWC
// scratch in 16-byte rows of 8 channels, or, at the stack's last layer, the
// NCHW output along the columns.
//
// Build (nvcc -Xptxas -v, sm_90a, as chip_smoke.py prints it), float32 form: 255 registers, 440
// bytes of stack, 520 bytes of spill stores and 1396 of spill loads, 768
// bytes of static shared memory; dynamic shared memory per layer_plan,
// 143,040 bytes for a 3x3 layer with BN 64 (one block of 256 threads per SM).
// bf16 form (conv_chain_bf16_kernel, 384 threads): 168 registers, the
// launch bound's share (setmaxnreg then moves them: 40 for the producer
// warpgroup, 232 for each consumer's), 192 bytes of stack, 192 bytes of
// spill stores and 276 of spill loads, 912 bytes of static shared memory
// (the mbarriers and the FFMA path's pointers); no C7520 ("wgmma ...
// serialized") warning; 147,200 bytes of dynamic shared memory for a 3x3
// layer with BN 128 (1,024 of alignment, 37,632 of input ring, 73,728 of
// weight ring, 34,816 of epilogue tiles; one block per SM).

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "device_guard.cuh"
#include "elem.cuh"

namespace cg = cooperative_groups;

namespace {

using elem::bf16;

constexpr int MAX_PARTS = 3;
constexpr int MAX_LAYERS = 8;
constexpr int PLAN_FIELDS = 5;  // per layer: k, cout, bn, woff, boff
constexpr int THREADS = 256;
constexpr size_t SMEM_BUDGET = 232448 - 1024;  // 227 KB, less room for static shared memory
constexpr float SLOPE = 0.1f;
// tensor-core path
constexpr int MT_H = 8;       // output rows per tile (two per warp row)
constexpr int MT_W = 32;      // output columns per tile
constexpr int CK = 16;        // input channels per chunk
constexpr int CS = CK + 4;    // staged words per pixel (float32 form)
// FFMA path (cout <= 8)
constexpr int CI_T = 8;       // input channels staged per pass
constexpr int FT_H = 32;      // output rows per tile
constexpr int TW = 32;        // output columns per tile
constexpr int RX = 4;         // output columns per thread
constexpr int FFMA_MAX_COUT = 8;  // output channels of the FFMA path, all in each thread


template <typename T>
constexpr bool is_f32 = std::is_same<T, float>::value;


template <typename T>
struct ChainParams {
  const T* part[MAX_PARTS];
  int part_c[MAX_PARTS];
  int n_layers;
  int k[MAX_LAYERS];
  int cin[MAX_LAYERS];
  int cout[MAX_LAYERS];
  int bn[MAX_LAYERS];    // channels per tile on the tensor-core path, 0 for the FFMA path
  int woff[MAX_LAYERS];  // layer l's packed weights in wpack
  int boff[MAX_LAYERS];  // and its bias [cout]
  const T* wpack;
  T* buf[2];
  T* out;
  int B, H, W;
  int last_linear;
};

// A layer's input: up to MAX_PARTS NCHW segments concatenated over channels
// (stride 0), or one NHWC scratch buffer whose pixels are `stride` elements apart.
template <typename T>
struct Src {
  const T* ptr[MAX_PARTS];
  int c[MAX_PARTS];
  int stride;
};

// A layer's output: NCHW (stride 0) or NHWC scratch.
template <typename T>
struct Dst {
  T* ptr;
  int stride;
};

// channels rounded up to 16 bytes
template <typename T>
__host__ __device__ inline int pixel_stride(int c) {
  constexpr int v = 16 / sizeof(T);
  return (c + v - 1) & ~(v - 1);
}

// f32: two stages of the input chunk with its halo and one of its lo half; two of the weight slice.
__host__ inline size_t mma_smem_bytes(int k, int bn) {
  const size_t a = (size_t)(MT_H + k - 1) * (MT_W + k - 1) * CS;
  const size_t b = (size_t)k * 2 * bn * CS;
  return (3 * a + 2 * b) * sizeof(float);
}

__host__ __device__ inline int ffma_row_stride(int k) { return (TW + k - 1 + 3) & ~3; }

// output channels an FFMA thread computes: cout rounded up to 2, 4 or 8
__host__ __device__ inline int ffma_channels(int cout) { return cout <= 2 ? 2 : cout <= 4 ? 4 : 8; }

// the input and weights staged as f32 in both forms
__host__ inline size_t ffma_smem_bytes(int k, int cout) {
  return sizeof(float) * ((size_t)CI_T * (FT_H + k - 1) * ffma_row_stride(k) +
                          (size_t)CI_T * k * k * ffma_channels(cout));
}

__host__ inline long long layer_tiles(int B, int H, int W, int cout, int bn) {
  if (bn == 0) return (long long)B * ((H + FT_H - 1) / FT_H) * ((W + TW - 1) / TW);
  return (long long)B * ((H + MT_H - 1) / MT_H) * ((W + MT_W - 1) / MT_W) * ((cout + bn - 1) / bn);
}

__device__ __forceinline__ float activate(float v, bool act) {
  return act && v < 0.f ? v * SLOPE : v;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes through L2 only; the bytes past src_bytes (all 16 when it is 0) are zero-filled.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(src_bytes));
}

// 4 bytes (the read-only parts only: .ca may cache in L1).
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// Four 8x8 b16 matrices = one m16 x k8 tf32 A fragment: a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4).
__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a * b on an m16n8k8 tile; b0 = (k t, n g), b1 = (k t+4, n g); d as c0..c3.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One 16-channel chunk of the input tile (with its halo) into [pixel][CS] shared memory.
template <int K>
__device__ __forceinline__ void stage_input(const Src<float>& src, int cin, int c0, int b, int y0, int x0, int H, int W,
                                            float* dst) {
  constexpr int P = K / 2, SH = MT_H + K - 1, SW = MT_W + K - 1;
  const int tid = threadIdx.x;
  if (src.stride) {
    const float* base = src.ptr[0];
    for (int i = tid; i < SH * SW * 4; i += THREADS) {
      const int pix = i >> 2, q = i & 3;
      const int rr = pix / SW, sx = pix - rr * SW;
      const int gy = y0 - P + rr, gx = x0 - P + sx, ch = c0 + 4 * q;
      const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
      const int bytes = in ? max(0, min(16, 4 * (cin - ch))) : 0;
      const float* g = bytes ? base + (((size_t)b * H + gy) * W + gx) * src.stride + ch : base;
      cp_async16(smem_addr(dst + pix * CS + 4 * q), g, bytes);
    }
    return;
  }
  const size_t plane = (size_t)H * W;
  for (int p = tid; p < CK * SW; p += THREADS) {
    const int cc = p / SW, sx = p - cc * SW;
    const int gx = x0 - P + sx;
    int ci = c0 + cc, s = 0;
    bool ok = ci < cin && gx >= 0 && gx < W;
    const float* base = src.ptr[0];
    if (ci < cin) {
      while (ci >= src.c[s]) ci -= src.c[s++];
      base = src.ptr[s] + ((size_t)b * src.c[s] + ci) * plane + gx;
    }
    for (int rr = 0; rr < SH; ++rr) {
      const int gy = y0 - P + rr;
      const bool in = ok && gy >= 0 && gy < H;
      cp_async4(smem_addr(dst + (rr * SW + sx) * CS + cc), in ? base + (size_t)gy * W : src.ptr[0], in ? 4 : 0);
    }
  }
}

// One (chunk, ky) slice of the packed weights, [kx][hi|lo][BN][16 ci] contiguous in global
// memory, into the same order in shared memory with CS words per row.
template <int K, int BN>
__device__ __forceinline__ void stage_weights(const float* __restrict__ src, float* dst) {
  for (int i = threadIdx.x; i < K * 2 * BN * 4; i += THREADS)
    cp_async16(smem_addr(dst + (i >> 2) * CS + 4 * (i & 3)), src + 4 * (size_t)i, 16);
}

// The staged chunk split in place: hi = cvt.rna.tf32(x) over x, lo = cvt.rna.tf32(x - hi) into `lo`.
__device__ __forceinline__ void split_chunk(float* a, float* lo, int pixels) {
  for (int i = threadIdx.x; i < pixels * 4; i += THREADS) {
    const int o = (i >> 2) * CS + 4 * (i & 3);
    float4 v = *reinterpret_cast<float4*>(a + o), r;
    float* x = &v.x;
    float* y = &r.x;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float h = __uint_as_float(tf32_rna(x[j]));
      y[j] = __uint_as_float(tf32_rna(x[j] - h));
      x[j] = h;
    }
    *reinterpret_cast<float4*>(a + o) = v;
    *reinterpret_cast<float4*>(lo + o) = r;
  }
}

template <int K, int BN>
__device__ void mma_layer(const Src<float>& src, int cin, const float* __restrict__ w, const float* __restrict__ bias,
                          int cout, const Dst<float> dst, int B, int H, int W, bool act, float* smem) {
  constexpr int WN = 2;                   // warp columns; each warp takes BN / 2 channels
  constexpr int WM = THREADS / 32 / WN;   // warp rows; each warp takes MI m tiles of 16 pixels
  constexpr int MI = 2 * MT_H / WM;
  constexpr int NT = BN / (8 * WN);       // n tiles of 8 channels per warp
  constexpr int SH = MT_H + K - 1, SW = MT_W + K - 1;
  constexpr int a_words = SH * SW * CS;
  constexpr int b_words = K * 2 * BN * CS;
  constexpr int stage_floats = K * 2 * BN * CK;
  float* const as = smem;                  // two stages of the chunk (raw, then hi)
  float* const alo = smem + 2 * a_words;   // the current chunk's lo
  float* const bs = smem + 3 * a_words;    // two stages of the weight slice
  const int nchunks = (cin + CK - 1) / CK;
  const int steps = nchunks * K;
  const int tiles_n = (cout + BN - 1) / BN;
  const int tiles_x = (W + MT_W - 1) / MT_W;
  const int tiles_y = (H + MT_H - 1) / MT_H;
  const long long ntiles = (long long)B * tiles_y * tiles_x * tiles_n;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WN, wn = warp % WN;  // output rows wm * MI / 2 ..; channels wn * BN / 2 ..
  const int g = lane >> 2, t = lane & 3;
  // ldmatrix rows of this lane: in the A tile of m tile mi (row wm * MI / 2 + mi / 2, columns
  // 16 (mi % 2) ..), pixel lane & 15 at channels 4 (lane >> 4) ..; in the B tile of n tile nt,
  // channel 8 nt + (lane & 7) of plane lane >> 4 (hi, lo) at input channels 4 ((lane >> 3) & 1) ..
  int a_off[MI];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
    a_off[mi] = ((wm * MI / 2 + (mi >> 1)) * SW + 16 * (mi & 1) + (lane & 15)) * CS + 4 * (lane >> 4);
  const int b_off = ((lane >> 4) * BN + wn * (BN / WN) + (lane & 7)) * CS + 4 * ((lane >> 3) & 1);

  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    // channel tiles vary fastest, so blocks that share an input tile run together
    long long r = tile;
    const int nb = (int)(r % tiles_n);
    r /= tiles_n;
    const int bx = (int)(r % tiles_x);
    r /= tiles_x;
    const int by = (int)(r % tiles_y);
    const int b = (int)(r / tiles_y);
    const int x0 = bx * MT_W, y0 = by * MT_H;
    const float* wt = w + (size_t)nb * steps * stage_floats;

    float acc[MI][NT][4];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[mi][nt][j] = 0.f;

    __syncthreads();  // the previous tile's last step has finished with the staging buffers
    stage_input<K>(src, cin, 0, b, y0, x0, H, W, as);
    stage_weights<K, BN>(wt, bs);
    cp_async_commit();
    for (int s = 0; s < steps; ++s) {
      const int c = s / K, ky = s - c * K;
      float* const a = as + (c & 1) * a_words;
      cp_async_wait_all();
      __syncthreads();  // step s is staged everywhere; step s-1's buffers are free
      if (s + 1 < steps) {
        if (ky == K - 1) stage_input<K>(src, cin, (c + 1) * CK, b, y0, x0, H, W, as + ((c + 1) & 1) * a_words);
        stage_weights<K, BN>(wt + (size_t)(s + 1) * stage_floats, bs + ((s + 1) & 1) * b_words);
        cp_async_commit();
      }
      if (ky == 0) {  // a new chunk: split it once for all taps and warps
        split_chunk(a, alo, SH * SW);
        __syncthreads();
      }
      const uint32_t ah_base = smem_addr(a) + 4u * (uint32_t)(ky * SW * CS);
      const uint32_t al_base = smem_addr(alo) + 4u * (uint32_t)(ky * SW * CS);
      const uint32_t b_base = smem_addr(bs + (s & 1) * b_words) + 4u * (uint32_t)b_off;
      // The tensor cores do not round their sums to nearest: the step's products (k taps x 16
      // channels, 6 k mma per fragment) go into a fresh sum, added into acc with an FADD.
      float part[MI][NT][4];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int j = 0; j < 4; ++j) part[mi][nt][j] = 0.f;
#pragma unroll
      for (int kx = 0; kx < K; ++kx)
#pragma unroll
        for (int k8 = 0; k8 < 2; ++k8) {
          uint32_t ah[MI][4], al[MI][4];
#pragma unroll
          for (int mi = 0; mi < MI; ++mi) {
            const uint32_t o = 4u * (uint32_t)(a_off[mi] + kx * CS + 8 * k8);
            ldmatrix_x4(ah_base + o, ah[mi]);
            ldmatrix_x4(al_base + o, al[mi]);
          }
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            uint32_t bf[4];  // b0, b1 of hi, then of lo
            ldmatrix_x4(b_base + 4u * (uint32_t)((2 * kx * BN + 8 * nt) * CS + 8 * k8), bf);
#pragma unroll
            for (int mi = 0; mi < MI; ++mi) mma_tf32(part[mi][nt], al[mi], bf[0], bf[1]);
#pragma unroll
            for (int mi = 0; mi < MI; ++mi) mma_tf32(part[mi][nt], ah[mi], bf[2], bf[3]);
#pragma unroll
            for (int mi = 0; mi < MI; ++mi) mma_tf32(part[mi][nt], ah[mi], bf[0], bf[1]);
          }
        }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[mi][nt][j] += part[mi][nt][j];
    }

    // c0, c1 = (pixel g, channels 2t, 2t+1); c2, c3 = (pixel g + 8, the same channels)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int n = nb * BN + wn * (BN / WN) + 8 * nt + 2 * t;
      const float bias0 = n < cout ? __ldg(bias + n) : 0.f;
      const float bias1 = n + 1 < cout ? __ldg(bias + n + 1) : 0.f;
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int y = y0 + wm * MI / 2 + (mi >> 1);
          const int x = x0 + 16 * (mi & 1) + g + 8 * h;
          if (y >= H || x >= W || n >= cout) continue;
          const float v0 = activate(acc[mi][nt][2 * h] + bias0, act);
          const float v1 = activate(acc[mi][nt][2 * h + 1] + bias1, act);
          if (dst.stride) {
            float* o = dst.ptr + (((size_t)b * H + y) * W + x) * dst.stride + n;
            if (n + 1 < cout) *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
            else o[0] = v0;
          } else {
            float* o = dst.ptr + (((size_t)b * cout + n) * H + y) * W + x;
            o[0] = v0;
            if (n + 1 < cout) o[(size_t)H * W] = v1;
          }
        }
    }
  }
}

// ---- the bf16 form's tensor-core layers: wgmma fed by TMA and bulk copies through mbarrier rings ----

constexpr int TC_THREADS = THREADS + 128;  // producer warpgroup 0, consumer warpgroups 1 and 2 (threads 128-383)
constexpr int TC_CONSUMER0 = 128;          // the first consumer thread
constexpr int TC_SW = 64;                  // staged columns of an input tile: pixels of an m64 block
constexpr int TC_NA = 3;                   // stages of the input ring (a 16-channel chunk with its halo)
constexpr int TC_NB = 6;                   // stages of the weight ring (a (chunk, ky) slice)
constexpr int TC_CONSUMER_WARPS = THREADS / 32;
constexpr int TC_PRODUCER_REGS = 40;
constexpr int TC_CONSUMER_REGS = 232;

// Output rows of a tile at channel tile bn: each consumer warpgroup holds rows / 2 m64 blocks of
// bn / 2 f32 sums a thread, at most 128.
__host__ __device__ constexpr int tc_rows(int bn) { return bn >= 96 ? 4 : 512 / bn; }
// Valid output columns of a tile: the 64 staged columns less the halo.
__host__ __device__ constexpr int tc_cols(int k) { return TC_SW - (k - 1); }
// The bytes of one TMA box: (rows + k - 1) x 64 pixels of one 8-channel plane.
__host__ __device__ constexpr uint32_t tc_box_bytes(int k, int bn) { return (tc_rows(bn) + k - 1) * TC_SW * 16; }
// A staged plane: the box and 8 spare pixels that the last row's dropped columns read.
__host__ __device__ constexpr uint32_t tc_plane_bytes(int k, int bn) { return tc_box_bytes(k, bn) + 8 * 16; }
// A weight stage: the (chunk, ky) slice, k taps of bn x 16 bf16.
__host__ __device__ constexpr uint32_t tc_b_stage_bytes(int k, int bn) { return k * bn * CK * 2; }
// A consumer warpgroup's epilogue tile, [64 pixels][bn + 8] bf16.
__host__ __device__ constexpr uint32_t tc_out_bytes(int bn) { return TC_SW * (bn + 8) * 2; }
// The two rings and two epilogue tiles, and 1024 bytes to align the rings' base.
__host__ inline size_t tc_smem_bytes(int k, int bn) {
  return 1024 + TC_NA * 2 * (size_t)tc_plane_bytes(k, bn) + TC_NB * (size_t)tc_b_stage_bytes(k, bn) +
         2 * (size_t)tc_out_bytes(bn);
}

// The tiles of a tensor-core layer: pixel tiles (image, tile row, tile column) x channel tiles,
// the channel tile varying fastest, so that blocks that share an input tile run together.
__host__ __device__ inline int tc_tiles(int B, int H, int W, int k, int cout, int bn) {
  return B * ((H + tc_rows(bn) - 1) / tc_rows(bn)) * ((W + tc_cols(k) - 1) / tc_cols(k)) * ((cout + bn - 1) / bn);
}

struct TcTile {
  int nb, bx, by, b;
};

__device__ __forceinline__ TcTile tc_tile(int tile, int tiles_n, int tiles_x, int tiles_y) {
  TcTile t;
  t.nb = tile % tiles_n;
  tile /= tiles_n;
  t.bx = tile % tiles_x;
  tile /= tiles_x;
  t.by = tile % tiles_y;
  t.b = tile / tiles_y;
  return t;
}

struct Bf16Params {
  ChainParams<bf16> c;
  unsigned int* grid_counter;    // the grid barrier's counter: 4 bytes after buf1, zeroed by the launch
  CUtensorMap tmap[MAX_LAYERS];  // layer l's input (NHWC scratch) for its TMA loads; unset on the FFMA path
};

// The next stage of each ring and the parity of the pass over it; the producer and the consumers
// each keep one and walk the same sequence of stages.
struct TcRing {
  int a = 0, b = 0;
  uint32_t pa = 0, pb = 0;
  __device__ void next_a() {
    if (++a == TC_NA) a = 0, pa ^= 1;
  }
  __device__ void next_b() {
    if (++b == TC_NB) b = 0, pb ^= 1;
  }
};

// The mbarriers (static shared memory, out of reach of the FFMA layers and the repacking):
// full then empty, of the input ring then of the weight ring.
__device__ __forceinline__ uint32_t full_a(uint32_t bars, int s) { return bars + 8 * s; }
__device__ __forceinline__ uint32_t full_b(uint32_t bars, int s) { return bars + 8 * (TC_NA + s); }
__device__ __forceinline__ uint32_t empty_a(uint32_t bars, int s) { return bars + 8 * (TC_NA + TC_NB + s); }
__device__ __forceinline__ uint32_t empty_b(uint32_t bars, int s) { return bars + 8 * (2 * TC_NA + TC_NB + s); }

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

// One arrival on the barrier if `pred` (a predicated instruction, so that no branch makes the
// path of the wgmma around it divergent).
__device__ __forceinline__ void mbar_arrive_if(uint32_t bar, bool pred) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.u32 p, %1, 0;\n@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(bar),
      "r"((uint32_t)pred)
      : "memory");
}

// Returns once the phase of parity `parity` of the barrier has completed; the spin is inside the
// PTX, so that no branch of the program makes the path of a wgmma divergent. After 2^31 failed
// tries (far beyond any wait of a right program) the kernel traps, and the launch fails with an
// error rather than hang the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .u32 n;\nmov.u32 n, 0;\n"
      "WAIT:\nmbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n@p bra DONE;\n"
      "add.u32 n, n, 1;\nsetp.gt.u32 p, n, 2147483647;\n@p trap;\nbra WAIT;\nDONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// A box of the tensor map at coordinates (c0, c1, c2, c3) (innermost first) into shared memory.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, int c0, int c1, int c2, int c3,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, "
      "%5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// `bytes` contiguous bytes (a multiple of 16, both addresses 16-byte aligned) into shared memory.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                   dst),
               "l"(src), "r"(bytes), "r"(bar)
               : "memory");
}

// A no-swizzle shared-memory matrix descriptor without its start address: LBO (the core matrix
// adjacent along K) and SBO (the next 8 rows along M or N), in bytes.
__device__ __forceinline__ uint64_t smem_desc(uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((lbo >> 4) & 0x3fff) << 16 | (uint64_t)((sbo >> 4) & 0x3fff) << 32;
}

// The descriptor with its start address (bits 4-17 of the shared address).
__device__ __forceinline__ uint64_t at(uint64_t desc, uint32_t addr) { return desc | ((addr >> 4) & 0x3fff); }

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins the sums to this point of the program, so that no other instruction touches them while a
// wgmma may be in flight (after zeroing them; after waiting for the last group).
template <int N>
__device__ __forceinline__ void fence_sums(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d += A * B on an m64 x N x k16 block, A and B through shared-memory descriptors (both K-major),
// d as f32: d[4j + 2h + e] at row 16 (warp in the warpgroup) + lane / 4 + 8h, column 8j + 2 (lane % 4) + e.
template <int N>
__device__ __forceinline__ void wgmma_bf16(float (&d)[N / 2], uint64_t a, uint64_t b);

template <>
__device__ __forceinline__ void wgmma_bf16<128>(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<96>(float (&d)[48], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "%48, %49, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<64>(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<32>(float (&d)[16], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(1));
}

// The producer's half of a tensor-core layer: for every tile of this block, chunk by chunk, the
// chunk's input tile with its halo (two TMA loads, one per 8-channel plane) into the input ring,
// then its k weight slices (one bulk copy each) into the weight ring.
__device__ void tc_produce(const Bf16Params& p, int l, uint8_t* sm, uint32_t bars, TcRing& ring) {
  const ChainParams<bf16>& c = p.c;
  const int k = c.k[l], bn = c.bn[l], pad = k / 2;
  const int th = tc_rows(bn), tw = tc_cols(k);
  const int nchunks = (c.cin[l] + CK - 1) / CK;
  const int tiles_n = (c.cout[l] + bn - 1) / bn, tiles_x = (c.W + tw - 1) / tw, tiles_y = (c.H + th - 1) / th;
  const int ntiles = tc_tiles(c.B, c.H, c.W, k, c.cout[l], bn);
  const uint32_t plane = tc_plane_bytes(k, bn), a_stage = 2 * plane, b_stage = tc_b_stage_bytes(k, bn);
  const uint32_t a_ring = smem_addr(sm), b_ring = a_ring + TC_NA * a_stage, box = tc_box_bytes(k, bn);
  const CUtensorMap* map = &p.tmap[l];
  const size_t slice = (size_t)k * bn * CK;  // bf16 of a (chunk, ky) slice
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const TcTile tt = tc_tile(tile, tiles_n, tiles_x, tiles_y);
    const int x0 = tt.bx * tw - pad, y0 = tt.by * th - pad, b = tt.b;
    const bf16* wt = c.wpack + c.woff[l] + (size_t)tt.nb * nchunks * k * slice;
    for (int ch = 0; ch < nchunks; ++ch) {
      const uint32_t dst = a_ring + ring.a * a_stage, full = full_a(bars, ring.a);
      mbar_wait(empty_a(bars, ring.a), ring.pa ^ 1);
      mbar_expect_tx(full, 2 * box);
      tma_load_4d(dst, map, ch * CK, x0, y0, b, full);
      tma_load_4d(dst + plane, map, ch * CK + 8, x0, y0, b, full);
      ring.next_a();
      for (int ky = 0; ky < k; ++ky) {
        const uint32_t fb = full_b(bars, ring.b);
        mbar_wait(empty_b(bars, ring.b), ring.pb ^ 1);
        mbar_expect_tx(fb, b_stage);
        bulk_load(b_ring + ring.b * b_stage, wt + ((size_t)ch * k + ky) * slice, b_stage, fb);
        ring.next_b();
      }
    }
  }
}

// This thread's warpgroup, broadcast from lane 0 so that the compiler sees it warp-uniform (a
// branch on it then does not make the path of a wgmma divergent).
__device__ __forceinline__ int warpgroup() { return __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0); }

// A consumer warpgroup's named barrier (ids 2 and 3 for consumers 0 and 1; 1 is the two consumer
// warpgroups', 0 the block's).
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
}

// The consumers' half of a tensor-core layer with channel tile BN: consumer wg (warpgroup wg + 1)
// computes output rows wg * MT .. of each tile, one m64 block a row, from the stages the producer
// fills.
template <int BN>
__device__ void tc_consume(const ChainParams<bf16>& p, int l, const Dst<bf16> dst, bool act, uint8_t* sm,
                           uint32_t bars, TcRing& ring) {
  constexpr int TH = tc_rows(BN), MT = TH / 2, NS = BN / 2, SROW = BN + 8, VEC = BN / 8;
  const int k = p.k[l], cout = p.cout[l], H = p.H, W = p.W, tw = tc_cols(k);
  const int nchunks = (p.cin[l] + CK - 1) / CK;
  const int tiles_n = (cout + BN - 1) / BN, tiles_x = (W + tw - 1) / tw, tiles_y = (H + TH - 1) / TH;
  const int ntiles = tc_tiles(p.B, H, W, k, cout, BN);
  const uint32_t plane = tc_plane_bytes(k, BN), a_stage = 2 * plane, b_stage = tc_b_stage_bytes(k, BN);
  const uint32_t a_ring = smem_addr(sm), b_ring = a_ring + TC_NA * a_stage;
  const int tid = threadIdx.x, wg = warpgroup() - 1, warp = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2;
  const int t = lane & 3;
  bf16* const out_tile = reinterpret_cast<bf16*>(sm + TC_NA * a_stage + TC_NB * b_stage + wg * tc_out_bytes(BN));
  const bf16* const bias = p.wpack + p.boff[l];
  // A: 8-pixel core matrices 128 bytes apart, the second 8 channels a plane on; B: 8-channel
  // core matrices 256 bytes apart, the second 8 input channels 128 bytes on
  const uint64_t a_desc = smem_desc(plane, 128), b_desc = smem_desc(128, 256);
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const TcTile tt = tc_tile(tile, tiles_n, tiles_x, tiles_y);
    const int nb = tt.nb, bx = tt.bx, by = tt.by, b = tt.b;

    float acc[MT][NS];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int i = 0; i < NS; ++i) acc[m][i] = 0.f;
      fence_sums(acc[m]);
    }
    int held_a = -1, held_b = -1;  // the stages of the group before the newest, freed once it completes
    for (int ch = 0; ch < nchunks; ++ch) {
      const int sa = ring.a;
      mbar_wait(full_a(bars, sa), ring.pa);
      ring.next_a();
      const uint32_t a_base = a_ring + sa * a_stage + wg * MT * TC_SW * 16;
      for (int ky = 0; ky < k; ++ky) {
        const int sb = ring.b;
        mbar_wait(full_b(bars, sb), ring.pb);
        ring.next_b();
        const uint32_t b_base = b_ring + sb * b_stage;
        wgmma_fence();
        for (int kx = 0; kx < k; ++kx) {
          const uint64_t bd = at(b_desc, b_base + kx * BN * CK * 2);
#pragma unroll
          for (int m = 0; m < MT; ++m)
            wgmma_bf16<BN>(acc[m], at(a_desc, a_base + ((m + ky) * TC_SW + kx) * 16), bd);
        }
        wgmma_commit();
        wgmma_wait<1>();
        mbar_arrive_if(empty_b(bars, max(held_b, 0)), lane == 0 && held_b >= 0);
        mbar_arrive_if(empty_a(bars, max(held_a, 0)), lane == 0 && held_a >= 0);
        held_b = sb;
        held_a = ky == k - 1 ? sa : -1;
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int m = 0; m < MT; ++m) fence_sums(acc[m]);
    mbar_arrive_if(empty_b(bars, held_b), lane == 0);
    mbar_arrive_if(empty_a(bars, held_a), lane == 0);

    // The bias, the LeakyReLU and one rounding, row by row through the warpgroup's tile
    // [pixel][SROW], then the valid pixels out: 16-byte rows of 8 channels into the NHWC
    // scratch, or the NCHW output along the columns (the stack's last layer).
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const int y = by * TH + wg * MT + m;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const int n = nb * BN + 8 * j + 2 * t;
        const float bias0 = n < cout ? elem::load(bias + n) : 0.f;
        const float bias1 = n + 1 < cout ? elem::load(bias + n + 1) : 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<uint32_t*>(out_tile + (16 * warp + g + 8 * h) * SROW + 8 * j + 2 * t) =
              elem::pack2(activate(acc[m][4 * j + 2 * h] + bias0, act),
                          activate(acc[m][4 * j + 2 * h + 1] + bias1, act));
      }
      warpgroup_sync(wg);
      if (y < H) {
        if (dst.stride) {
          for (int i = tid & 127; i < TC_SW * VEC; i += 128) {
            const int px = i / VEC, q = i - px * VEC, x = bx * tw + px, n = nb * BN + 8 * q;
            if (px < tw && x < W && n < cout)
              *reinterpret_cast<uint4*>(dst.ptr + (((size_t)b * H + y) * W + x) * dst.stride + n) =
                  *reinterpret_cast<const uint4*>(out_tile + px * SROW + 8 * q);
          }
        } else {  // two columns of a channel a thread (tw is even): 4-byte stores where W is even
          const uint16_t* const ot = reinterpret_cast<const uint16_t*>(out_tile);
          for (int i = tid & 127; i < TC_SW / 2 * BN; i += 128) {
            const int q = i / (TC_SW / 2), px = 2 * (i - q * (TC_SW / 2)), x = bx * tw + px, n = nb * BN + q;
            if (px >= tw || x >= W || n >= cout) continue;
            uint16_t* o = reinterpret_cast<uint16_t*>(dst.ptr + (((size_t)b * cout + n) * H + y) * W + x);
            const uint32_t v0 = ot[px * SROW + q], v1 = ot[(px + 1) * SROW + q];
            if ((W & 1) == 0) {
              *reinterpret_cast<uint32_t*>(o) = v0 | v1 << 16;
            } else {
              o[0] = (uint16_t)v0;
              if (x + 1 < W) o[1] = (uint16_t)v1;
            }
          }
        }
      }
      warpgroup_sync(wg);
    }
  }
}

// The threads that run the FFMA layers and the repacking: the whole block in the f32 form, the two
// consumer warpgroups (threads 128-383) in the bf16 form; the first of them, and their barrier
// (named barrier 1 in the bf16 form).
template <typename T>
__device__ __forceinline__ constexpr int compute_thread0() {
  return is_f32<T> ? 0 : TC_CONSUMER0;
}

template <typename T>
__device__ __forceinline__ void sync_compute() {
  if constexpr (is_f32<T>) __syncthreads();
  else asm volatile("bar.sync 1, %0;\n" ::"n"(THREADS) : "memory");
}

// The bf16 form's first phase: the NCHW parts, concatenated over channels, into the NHWC buffer
// `dst` (pixels `stride` bf16 apart) that layer 0 reads, by the two consumer warpgroups. A thread
// takes 8 channels x 8 columns of a row at a time: 8 loads along the channel rows (16 bytes each
// where the row is 16-byte aligned and holds the 8 columns, else 2-byte loads), a transposition
// in registers (byte permutes), and 8 stores of 16 bytes, the 8 channels of a pixel (channels past
// cin are zeros in the stride's padding). Neighbouring threads take neighbouring channel groups
// of the same columns, so that a warp's stores fill whole pixels; no shared memory, no barrier.
__device__ void repack_parts(const ChainParams<bf16>& p, bf16* dst) {
  const int cin = p.cin[0], stride = pixel_stride<bf16>(cin), H = p.H, W = p.W;
  const int groups_c = stride / 8, groups_x = (W + 7) / 8;
  const long long n = (long long)p.B * H * groups_x * groups_c;
  const int tid = threadIdx.x - TC_CONSUMER0;
  for (long long i = (long long)blockIdx.x * THREADS + tid; i < n; i += (long long)gridDim.x * THREADS) {
    long long r = i;
    const int gc = (int)(r % groups_c);
    r /= groups_c;
    const int gx = (int)(r % groups_x);
    r /= groups_x;
    const int y = (int)(r % H);
    const int b = (int)(r / H);
    const int x0 = 8 * gx;
    uint32_t v[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {  // channel 8 gc + j, columns x0 .. x0 + 7
      int ci = 8 * gc + j, s = 0;
      uint4 q = make_uint4(0u, 0u, 0u, 0u);
      if (ci < cin) {
        while (ci >= p.part_c[s]) ci -= p.part_c[s++];
        const uint16_t* row =
            reinterpret_cast<const uint16_t*>(p.part[s]) + (((size_t)b * p.part_c[s] + ci) * H + y) * W + x0;
        if (x0 + 8 <= W && (reinterpret_cast<uintptr_t>(row) & 15) == 0) {
          q = __ldg(reinterpret_cast<const uint4*>(row));
        } else {
          uint32_t e[8];
#pragma unroll
          for (int x = 0; x < 8; ++x) e[x] = x0 + x < W ? __ldg(row + x) : 0u;
          q = make_uint4(e[0] | e[1] << 16, e[2] | e[3] << 16, e[4] | e[5] << 16, e[6] | e[7] << 16);
        }
      }
      v[j][0] = q.x;
      v[j][1] = q.y;
      v[j][2] = q.z;
      v[j][3] = q.w;
    }
#pragma unroll
    for (int px = 0; px < 8; ++px) {  // column x0 + px: channels (2m, 2m + 1) from the halves of word px / 2
      if (x0 + px >= W) break;
      const uint32_t sel = px & 1 ? 0x7632u : 0x5410u;
      const uint4 o = make_uint4(__byte_perm(v[0][px >> 1], v[1][px >> 1], sel),
                                 __byte_perm(v[2][px >> 1], v[3][px >> 1], sel),
                                 __byte_perm(v[4][px >> 1], v[5][px >> 1], sel),
                                 __byte_perm(v[6][px >> 1], v[7][px >> 1], sel));
      *reinterpret_cast<uint4*>(dst + (((size_t)b * H + y) * W + x0 + px) * stride + 8 * gc) = o;
    }
  }
}

// Direct convolution with exact f32 FMAs for cout <= 8. A block of 256 threads computes
// 32 output columns x 32 rows x RC channels (cout rounded up to 2, 4 or 8); for every pass
// of 8 input channels it stages the input tile with its halo and the weight slice
// [ci][ky][kx][co] in shared memory; a thread reads each staged input row once as float4s,
// slides it over the k taps of the row, and takes its RC weights per tap as broadcast loads.
// The bf16 form stages its inputs and weights widened to f32 and rounds on store.
template <typename T, int K, int RC>
__device__ void ffma_layer(const Src<T>& src, int cin, const T* __restrict__ w, const T* __restrict__ bias,
                           int cout, const Dst<T> dst, int B, int H, int W, bool act, float* smem) {
  constexpr int P = K / 2;
  constexpr int SW = TW + K - 1;            // staged columns
  constexpr int RS = (SW + 3) & ~3;         // their row stride, float4-aligned
  constexpr int SH = FT_H + K - 1;          // staged rows
  constexpr int NV = (RX + K - 1 + 3) / 4;  // float4s a thread reads per staged row
  __shared__ const T* s_base[CI_T];         // the first element of each staged channel's image

  float* s_in = smem;
  float* s_w = smem + CI_T * SH * RS;
  const int tid = threadIdx.x - compute_thread0<T>();
  const int ty = tid / (TW / RX);
  const int tx = (tid - ty * (TW / RX)) * RX;
  const int tiles_x = (W + TW - 1) / TW;
  const int tiles_y = (H + FT_H - 1) / FT_H;
  const long long ntiles = (long long)B * tiles_y * tiles_x;
  const size_t plane = (size_t)H * W;
  const int pstride = src.stride;

  for (long long t = blockIdx.x; t < ntiles; t += gridDim.x) {
    long long r = t;
    const int bx = (int)(r % tiles_x);
    r /= tiles_x;
    const int by = (int)(r % tiles_y);
    const int b = (int)(r / tiles_y);
    const int x0 = bx * TW;
    const int y0 = by * FT_H;

    float acc[RC][RX];
#pragma unroll
    for (int c = 0; c < RC; ++c)
#pragma unroll
      for (int j = 0; j < RX; ++j) acc[c][j] = 0.f;

    for (int ci0 = 0; ci0 < cin; ci0 += CI_T) {
      const int cn = min(CI_T, cin - ci0);
      sync_compute<T>();  // the previous pass has finished with the staged tiles
      if (tid < cn) {
        int ci = ci0 + tid, s = 0;
        if (src.stride) {
          s_base[tid] = src.ptr[0] + (size_t)b * plane * src.stride + ci;
        } else {
          while (ci >= src.c[s]) ci -= src.c[s++];
          s_base[tid] = src.ptr[s] + ((size_t)b * src.c[s] + ci) * plane;
        }
      }
      sync_compute<T>();
      if constexpr (!is_f32<T>) {  // NHWC bf16 scratch (where the bf16 form repacks its parts too):
                                   // 8 channels of a pixel per 16-byte load, those past cin zeroed
        for (int i = tid; i < SH * SW; i += THREADS) {
          const int rr = i / SW, sx = i - rr * SW;
          const int gy = y0 - P + rr, gx = x0 - P + sx;
          uint4 v = make_uint4(0u, 0u, 0u, 0u);
          if (gy >= 0 && gy < H && gx >= 0 && gx < W)
            v = __ldcg(reinterpret_cast<const uint4*>(s_base[0] + ((size_t)gy * W + gx) * pstride));
          const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int j = 0; j < 8; ++j)
            s_in[(j * SH + rr) * RS + sx] = j < cn ? (j & 1 ? elem::hi(u[j >> 1]) : elem::lo(u[j >> 1])) : 0.f;
        }
      } else if (src.stride) {  // NHWC scratch: 4 channels of a pixel per 16-byte load, those past cin zeroed
        for (int i = tid; i < SH * SW * 2; i += THREADS) {
          const int q = i & 1, pix = i >> 1;
          const int rr = pix / SW, sx = pix - rr * SW;
          const int gy = y0 - P + rr, gx = x0 - P + sx;
          float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
          if (4 * q < cn && gy >= 0 && gy < H && gx >= 0 && gx < W)
            v = __ldcg(reinterpret_cast<const float4*>(s_base[0] + ((size_t)gy * W + gx) * pstride + 4 * q));
          const float f[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) s_in[((4 * q + j) * SH + rr) * RS + sx] = 4 * q + j < cn ? f[j] : 0.f;
        }
      } else {
        for (int i = tid; i < cn * SH * SW; i += THREADS) {
          const int cc = i / (SH * SW);
          const int rem = i - cc * SH * SW;
          const int rr = rem / SW;
          const int s = rem - rr * SW;
          const int gy = y0 - P + rr;
          const int gx = x0 - P + s;
          float v = 0.f;
          if (gy >= 0 && gy < H && gx >= 0 && gx < W) v = __ldcg(s_base[cc] + (size_t)gy * W + gx);
          s_in[(cc * SH + rr) * RS + s] = v;
        }
      }
      const T* wsrc = w + (size_t)ci0 * K * K * cout;
      for (int i = tid; i < cn * K * K * RC; i += THREADS) {
        const int co = i % RC;
        const int rest = i / RC;  // (ci - ci0) * K * K + ky * K + kx
        s_w[i] = co < cout ? elem::load(wsrc + (size_t)rest * cout + co) : 0.f;
      }
      sync_compute<T>();

      for (int cc = 0; cc < cn; ++cc) {
#pragma unroll
        for (int ky = 0; ky < K; ++ky) {
          const float4* row = reinterpret_cast<const float4*>(s_in + (cc * SH + ty + ky) * RS + tx);
          float v[NV * 4];
#pragma unroll
          for (int q = 0; q < NV; ++q) {
            const float4 f = row[q];
            v[4 * q] = f.x;
            v[4 * q + 1] = f.y;
            v[4 * q + 2] = f.z;
            v[4 * q + 3] = f.w;
          }
          const float* wrow = s_w + (cc * K + ky) * K * RC;
#pragma unroll
          for (int kx = 0; kx < K; ++kx) {
            float wv[RC];
#pragma unroll
            for (int q = 0; q < RC; q += 2) {
              const float2 f = *reinterpret_cast<const float2*>(wrow + kx * RC + q);
              wv[q] = f.x;
              wv[q + 1] = f.y;
            }
#pragma unroll
            for (int c = 0; c < RC; ++c)
#pragma unroll
              for (int j = 0; j < RX; ++j) acc[c][j] = fmaf(wv[c], v[j + kx], acc[c][j]);
          }
        }
      }
    }

    const int y = y0 + ty;
    const int x = x0 + tx;
    if (y >= H || x >= W) continue;
#pragma unroll
    for (int c = 0; c < RC; ++c) {
      if (c >= cout) break;
      const float bv = elem::load(bias + c);
      if (dst.stride) {
        T* o = dst.ptr + (((size_t)b * H + y) * W + x) * dst.stride + c;
#pragma unroll
        for (int j = 0; j < RX; ++j)
          if (x + j < W) elem::store(o + (size_t)j * dst.stride, activate(acc[c][j] + bv, act));
      } else {
        T* o = dst.ptr + ((size_t)b * cout + c) * plane + (size_t)y * W + x;
        if ((W & 3) == 0 && x + RX <= W) {
          const float v[RX] = {activate(acc[c][0] + bv, act), activate(acc[c][1] + bv, act),
                               activate(acc[c][2] + bv, act), activate(acc[c][3] + bv, act)};
          if constexpr (is_f32<T>) *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
          else *reinterpret_cast<uint2*>(o) = make_uint2(elem::pack2(v[0], v[1]), elem::pack2(v[2], v[3]));
        } else {
#pragma unroll
          for (int j = 0; j < RX; ++j)
            if (x + j < W) elem::store(o + j, activate(acc[c][j] + bv, act));
        }
      }
    }
  }
}

// The FFMA layer at the k and channel count of the plan.
template <typename T, int K>
__device__ void ffma_layer_k(int rc, const Src<T>& src, int cin, const T* w, const T* bias, int cout,
                             const Dst<T> dst, int B, int H, int W, bool act, float* smem) {
  if (rc == 2) ffma_layer<T, K, 2>(src, cin, w, bias, cout, dst, B, H, W, act, smem);
  else if (rc == 4) ffma_layer<T, K, 4>(src, cin, w, bias, cout, dst, B, H, W, act, smem);
  else ffma_layer<T, K, 8>(src, cin, w, bias, cout, dst, B, H, W, act, smem);
}

__global__ void __launch_bounds__(THREADS, 1) conv_chain_f32_kernel(ChainParams<float> p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  cg::grid_group grid = cg::this_grid();
  for (int l = 0; l < p.n_layers; ++l) {
    Src<float> src;
    if (l == 0) {
      src.stride = 0;
#pragma unroll
      for (int i = 0; i < MAX_PARTS; ++i) {
        src.ptr[i] = p.part[i];
        src.c[i] = p.part_c[i];
      }
    } else {
      src.stride = pixel_stride<float>(p.cin[l]);
      src.ptr[0] = p.buf[(l + 1) & 1];  // layer l-1's output
      src.c[0] = p.cin[l];
    }
    const bool last = l == p.n_layers - 1;
    const Dst<float> dst = last ? Dst<float>{p.out, 0} : Dst<float>{p.buf[l & 1], pixel_stride<float>(p.cout[l])};
    const bool act = !last || !p.last_linear;
    const float* w = p.wpack + p.woff[l];
    const float* bias = p.wpack + p.boff[l];
    const int cin = p.cin[l], cout = p.cout[l];
    const int k = p.k[l];
    const int B = p.B, H = p.H, W = p.W;
    if (p.bn[l] == 0) {
      const int rc = ffma_channels(cout);
      if (k == 1) ffma_layer_k<float, 1>(rc, src, cin, w, bias, cout, dst, B, H, W, act, smem);
      else if (k == 3) ffma_layer_k<float, 3>(rc, src, cin, w, bias, cout, dst, B, H, W, act, smem);
      else if (k == 5) ffma_layer_k<float, 5>(rc, src, cin, w, bias, cout, dst, B, H, W, act, smem);
      else ffma_layer_k<float, 7>(rc, src, cin, w, bias, cout, dst, B, H, W, act, smem);
    } else if (p.bn[l] == 64) {
      if (k == 1) mma_layer<1, 64>(src, cin, w, bias, cout, dst, B, H, W, act, smem);
      else if (k == 3) mma_layer<3, 64>(src, cin, w, bias, cout, dst, B, H, W, act, smem);
      else mma_layer<5, 64>(src, cin, w, bias, cout, dst, B, H, W, act, smem);
    } else {
      if (k == 1) mma_layer<1, 32>(src, cin, w, bias, cout, dst, B, H, W, act, smem);
      else if (k == 3) mma_layer<3, 32>(src, cin, w, bias, cout, dst, B, H, W, act, smem);
      else if (k == 5) mma_layer<5, 32>(src, cin, w, bias, cout, dst, B, H, W, act, smem);
      else mma_layer<7, 32>(src, cin, w, bias, cout, dst, B, H, W, act, smem);
    }
    if (l + 1 < p.n_layers) grid.sync();  // layer l is written everywhere before l+1 reads it
  }
}

// The bf16 form's grid barrier, the algorithm of cooperative_groups' grid_group::sync() on the
// launch's own counter (the launch is cooperative: every block is resident). The block's threads
// meet at bar.sync 0; thread 0 (in the producer warpgroup) adds to the counter, block 0 adding
// 2^31 - (blocks - 1) and every other block 1, so that its top bit flips once all have arrived,
// and waits for the flip; the block meets at bar.sync 0 again. The divergent part runs in the
// producer warpgroup, so that no divergent code lies on the consumers' path between their wgmma
// (ptxas would serialise the wgmma); the consumers' half is the two bar.sync 0.
__device__ __forceinline__ void grid_sync_producer(unsigned int* counter) {
  __syncwarp();
  asm volatile("bar.sync 0;\n" ::: "memory");
  if (threadIdx.x == 0) {
    const unsigned int add = blockIdx.x == 0 ? 0x80000000u - (gridDim.x - 1) : 1u;
    __threadfence();
    const unsigned int old = atomicAdd(counter, add);
    unsigned int now;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(now) : "l"(counter) : "memory");
    } while (((old ^ now) & 0x80000000u) == 0);
    __threadfence();
  }
  __syncwarp();
  asm volatile("bar.sync 0;\n" ::: "memory");
}

__device__ __forceinline__ void grid_sync_consumers() {
  asm volatile("bar.sync 0;\nbar.sync 0;\n" ::: "memory");
}

// The bf16 form: the repacking by the consumer warpgroups, then each layer: the FFMA layers on the
// consumer warpgroups, the tensor-core layers on all three (the producer warpgroup's first thread
// issuing the copies). Every thread of the block takes part in every grid barrier.
__global__ void __launch_bounds__(TC_THREADS, 1) conv_chain_bf16_kernel(const __grid_constant__ Bf16Params p) {
  extern __shared__ float4 smem4[];
  __shared__ __align__(8) uint64_t tc_bars[2 * (TC_NA + TC_NB)];
  // the rings' base, 1024-byte aligned (TMA destinations need 128)
  uint8_t* const sm = reinterpret_cast<uint8_t*>(((uintptr_t)smem4 + 1023) & ~(uintptr_t)1023);
  const uint32_t bars = smem_addr(tc_bars);
  const ChainParams<bf16>& c = p.c;
  if (threadIdx.x == 0) {
    for (int s = 0; s < TC_NA; ++s) {
      mbar_init(full_a(bars, s), 1);  // the producer's expect_tx
      mbar_init(empty_a(bars, s), TC_CONSUMER_WARPS);  // one lane per consumer warp
    }
    for (int s = 0; s < TC_NB; ++s) {
      mbar_init(full_b(bars, s), 1);
      mbar_init(empty_b(bars, s), TC_CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  TcRing ring;
  if (warpgroup() == 0) {  // the producer warpgroup; its path never rejoins the consumers'
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(TC_PRODUCER_REGS));
    grid_sync_producer(p.grid_counter);  // the repacked parts
    for (int l = 0; l < c.n_layers; ++l) {
      if (c.bn[l] && threadIdx.x == 0) {
        asm volatile("fence.proxy.async;\n" ::: "memory");  // the generic stores before the barrier, to TMA
        tc_produce(p, l, sm, bars, ring);
      }
      if (l + 1 < c.n_layers) grid_sync_producer(p.grid_counter);
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(TC_CONSUMER_REGS));
  float* const smem = reinterpret_cast<float*>(smem4);
  repack_parts(c, c.buf[1]);
  asm volatile("fence.proxy.async;\n" ::: "memory");
  grid_sync_consumers();
  for (int l = 0; l < c.n_layers; ++l) {
    Src<bf16> src;
    src.stride = pixel_stride<bf16>(c.cin[l]);
    src.ptr[0] = c.buf[(l + 1) & 1];  // layer l-1's output; the repacked parts for l = 0
    src.c[0] = c.cin[l];
    const bool last = l == c.n_layers - 1;
    const Dst<bf16> dst = last ? Dst<bf16>{c.out, 0} : Dst<bf16>{c.buf[l & 1], pixel_stride<bf16>(c.cout[l])};
    const bool act = !last || !c.last_linear;
    const int k = c.k[l], cout = c.cout[l];
    if (c.bn[l] == 0) {
      const bf16* w = c.wpack + c.woff[l];
      const bf16* bias = c.wpack + c.boff[l];
      const int rc = ffma_channels(cout), cin = c.cin[l], B = c.B, H = c.H, W = c.W;
      if (k == 1) ffma_layer_k<bf16, 1>(rc, src, cin, w, bias, cout, dst, B, H, W, act, smem);
      else if (k == 3) ffma_layer_k<bf16, 3>(rc, src, cin, w, bias, cout, dst, B, H, W, act, smem);
      else if (k == 5) ffma_layer_k<bf16, 5>(rc, src, cin, w, bias, cout, dst, B, H, W, act, smem);
      else ffma_layer_k<bf16, 7>(rc, src, cin, w, bias, cout, dst, B, H, W, act, smem);
    } else if (c.bn[l] == 128) {
      tc_consume<128>(c, l, dst, act, sm, bars, ring);
    } else if (c.bn[l] == 96) {
      tc_consume<96>(c, l, dst, act, sm, bars, ring);
    } else if (c.bn[l] == 64) {
      tc_consume<64>(c, l, dst, act, sm, bars, ring);
    } else {
      tc_consume<32>(c, l, dst, act, sm, bars, ring);
    }
    if (l + 1 < c.n_layers) {
      asm volatile("fence.proxy.async;\n" ::: "memory");  // this layer's stores, to the next one's TMA loads
      grid_sync_consumers();  // layer l is written everywhere before l+1 reads it
    }
  }
}

int launch_chain_f32(const void* parts, const void* part_c, int n_parts, const int* plan, int n_layers,
                     const void* wpack, void* buf0, void* buf1, void* out, int B, int H, int W, int last_linear,
                     int device, cudaStream_t stream) {
  ChainParams<float> p = {};
  const void* const* part_ptrs = (const void* const*)parts;
  const int* pc = (const int*)part_c;
  int cin = 0;
  for (int i = 0; i < n_parts; ++i) {
    p.part[i] = (const float*)part_ptrs[i];
    p.part_c[i] = pc[i];
    cin += pc[i];
  }
  p.n_layers = n_layers;
  long long max_tiles = 1;
  size_t smem = 0;
  for (int l = 0; l < n_layers; ++l) {
    const int* f = plan + PLAN_FIELDS * l;
    const int k = f[0], cout = f[1], bn = f[2];
    if (k != 1 && k != 3 && k != 5 && k != 7) return (int)cudaErrorInvalidValue;
    // the tile widths instantiated: those layer_plan picks for each k
    const bool mma_ok = (bn == 64 && k <= 5) || bn == 32;
    if (bn == 0 ? cout > FFMA_MAX_COUT : !mma_ok || cout <= FFMA_MAX_COUT) return (int)cudaErrorInvalidValue;
    if (cout < 1 || f[3] < 0 || f[4] < 0 || (bn && f[3] % 4)) return (int)cudaErrorInvalidValue;
    p.k[l] = k;
    p.cin[l] = cin;
    p.cout[l] = cout;
    p.bn[l] = bn;
    p.woff[l] = f[3];
    p.boff[l] = f[4];
    cin = cout;
    const size_t bytes = bn ? mma_smem_bytes(k, bn) : ffma_smem_bytes(k, cout);
    if (bytes > SMEM_BUDGET) return (int)cudaErrorInvalidValue;
    smem = bytes > smem ? bytes : smem;
    const long long tiles = layer_tiles(B, H, W, cout, bn);
    max_tiles = tiles > max_tiles ? tiles : max_tiles;
  }
  p.wpack = (const float*)wpack;
  p.buf[0] = (float*)buf0;
  p.buf[1] = (float*)buf1;
  p.out = (float*)out;
  p.B = B;
  p.H = H;
  p.W = W;
  p.last_linear = last_linear;

  cudaError_t err = cudaFuncSetAttribute(conv_chain_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, conv_chain_f32_kernel, THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long fit = (long long)per_sm * sms;
  const dim3 grid((unsigned)(max_tiles < fit ? max_tiles : fit));
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel((const void*)conv_chain_f32_kernel, grid, dim3(THREADS), args, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// libcuda's cuTensorMapEncodeTiled, found through the runtime's entry-point query (the library links no libcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault,
                                                             &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(f);
  }
  return fn;
}

// The tensor map of a layer's input: the NHWC scratch `buf` of cin channels, pixels
// pixel_stride(cin) bf16 apart, as (C, W, H, B); a box is 8 channels x 64 columns x
// (rows + k - 1) rows of one image, zero-filled out of bounds.
int encode_input_map(CUtensorMap* map, const bf16* buf, int cin, int B, int H, int W, int k, int bn) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t px = (cuuint64_t)pixel_stride<bf16>(cin) * sizeof(bf16);
  const cuuint64_t dims[4] = {(cuuint64_t)cin, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {px, px * W, px * W * H};
  const cuuint32_t box[4] = {8, (cuuint32_t)TC_SW, (cuuint32_t)(tc_rows(bn) + k - 1), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult rc = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, (void*)buf, dims, strides, box, unit,
                             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

int launch_chain_bf16(const void* parts, const void* part_c, int n_parts, const int* plan, int n_layers,
                      const void* wpack, void* buf0, void* buf1, void* out, int B, int H, int W, int last_linear,
                      int device, cudaStream_t stream) {
  Bf16Params p = {};
  ChainParams<bf16>& c = p.c;
  const void* const* part_ptrs = (const void* const*)parts;
  const int* pc = (const int*)part_c;
  int cin = 0;
  for (int i = 0; i < n_parts; ++i) {
    c.part[i] = (const bf16*)part_ptrs[i];
    c.part_c[i] = pc[i];
    cin += pc[i];
  }
  c.n_layers = n_layers;
  c.cin[0] = cin;  // the repacking reads it, also without layers
  c.buf[0] = (bf16*)buf0;
  c.buf[1] = (bf16*)buf1;
  // the repacking phase: no shared memory; 8 channels x 8 columns per thread
  size_t smem = 0;
  long long max_tiles = ((long long)B * H * ((W + 7) / 8) * (pixel_stride<bf16>(cin) / 8) + THREADS - 1) / THREADS;
  for (int l = 0; l < n_layers; ++l) {
    const int* f = plan + PLAN_FIELDS * l;
    const int k = f[0], cout = f[1], bn = f[2];
    if (k != 1 && k != 3 && k != 5 && k != 7) return (int)cudaErrorInvalidValue;
    const bool tc_ok = bn == 128 || bn == 96 || bn == 64 || bn == 32;
    if (bn == 0 ? cout > FFMA_MAX_COUT : !tc_ok || cout <= FFMA_MAX_COUT) return (int)cudaErrorInvalidValue;
    if (cout < 1 || f[3] < 0 || f[4] < 0 || (bn && f[3] % 8)) return (int)cudaErrorInvalidValue;
    c.k[l] = k;
    c.cin[l] = cin;
    c.cout[l] = cout;
    c.bn[l] = bn;
    c.woff[l] = f[3];
    c.boff[l] = f[4];
    if (bn) {
      const int rc = encode_input_map(&p.tmap[l], c.buf[(l + 1) & 1], cin, B, H, W, k, bn);
      if (rc != 0) return rc;
    }
    cin = cout;
    const size_t bytes = bn ? tc_smem_bytes(k, bn) : ffma_smem_bytes(k, cout);
    if (bytes > SMEM_BUDGET) return (int)cudaErrorInvalidValue;
    smem = bytes > smem ? bytes : smem;
    const long long tiles = bn ? tc_tiles(B, H, W, k, cout, bn) : layer_tiles(B, H, W, cout, 0);
    max_tiles = tiles > max_tiles ? tiles : max_tiles;
  }
  // the grid barrier's counter: after buf1, whose pixels are the widest stride apart of the input
  // channels and the intermediates (as ops/conv_chain.py:_launch sizes the scratch)
  int mid = pixel_stride<bf16>(c.cin[0]);
  for (int l = 0; l + 1 < n_layers; ++l) mid = max(mid, pixel_stride<bf16>(c.cout[l]));
  p.grid_counter = reinterpret_cast<unsigned int*>(c.buf[1] + (size_t)B * H * W * mid);
  c.wpack = (const bf16*)wpack;
  c.out = (bf16*)out;
  c.B = B;
  c.H = H;
  c.W = W;
  c.last_linear = last_linear;

  cudaError_t err =
      cudaFuncSetAttribute(conv_chain_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(p.grid_counter, 0, sizeof(unsigned int), stream);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, conv_chain_bf16_kernel, TC_THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long fit = (long long)per_sm * sms;
  const dim3 grid((unsigned)(max_tiles < fit ? max_tiles : fit));
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel((const void*)conv_chain_bf16_kernel, grid, dim3(TC_THREADS), args, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// n_layers: 1 to MAX_LAYERS (the bf16 form also takes 0: the repacking of the parts alone).
template <typename T, typename Launch>
int entry(Launch launch, const void* parts, const void* part_c, int n_parts, const void* plan, int n_layers,
          const void* wpack, void* buf0, void* buf1, void* out, int B, int H, int W, int last_linear, int device,
          void* stream) {
  if (n_parts < 1 || n_parts > MAX_PARTS || n_layers < (is_f32<T> ? 1 : 0) || n_layers > MAX_LAYERS)
    return (int)cudaErrorInvalidValue;
  return pivk::on_device(device, [&] {
    return launch(parts, part_c, n_parts, (const int*)plan, n_layers, wpack, buf0, buf1, out, B, H, W, last_linear,
                  device, (cudaStream_t)stream);
  });
}

}  // namespace

// parts: host array of n_parts device pointers (NCHW); part_c: their channel counts. plan:
// host array of n_layers x 5 ints, per layer (k, cout, bn, woff, boff) from
// ops/conv_chain.py:layer_plan: bn 0 takes the FFMA path (weights [cin][k][k][cout] at
// woff), else the tensor-core path with BN = bn (weights [cout/bn][chunk][ky][kx][hi|lo][bn]
// [16] at woff, cin padded to 16 and cout to bn with zeros); the bias [cout] at boff.
// buf0/buf1: NHWC scratch of B * H * W * max((cout + 3) & ~3 over couts[:-1]) floats each.
// The caller's current device is restored on return.
extern "C" int pivk_conv_chain_f32(const void* parts, const void* part_c, int n_parts, const void* plan,
                                   int n_layers, const void* wpack, void* buf0, void* buf1, void* out, int B,
                                   int H, int W, int last_linear, int device, void* stream) {
  return entry<float>(launch_chain_f32, parts, part_c, n_parts, plan, n_layers, wpack, buf0, buf1, out, B, H, W,
                      last_linear, device, stream);
}

// The bf16 form: the arguments of the f32 form, every tensor bf16. The tensor-core weights
// are [cout/bn][chunk][ky][kx][bn/8][2][8][8] (per tap the B descriptor's image: 8 output
// channels x 8 input channels per 128-byte core matrix, the two input-channel halves, then the
// next 8 output channels; no lo half), and each layer's weights start at a multiple of 8
// elements. buf0/buf1: NHWC scratch of B * H * W * max((c + 7) & ~7 over the input channels
// cin_0 and couts[:-1]) bf16 each; buf1 takes the repacked parts first and is followed by 16
// bytes for the grid barrier's counter (zeroed by the launch). With n_layers 0 the launch only
// repacks the parts into buf1 (plan, wpack, buf0 and out unused).
extern "C" int pivk_conv_chain_bf16(const void* parts, const void* part_c, int n_parts, const void* plan,
                                    int n_layers, const void* wpack, void* buf0, void* buf1, void* out, int B,
                                    int H, int W, int last_linear, int device, void* stream) {
  return entry<bf16>(launch_chain_bf16, parts, part_c, n_parts, plan, n_layers, wpack, buf0, buf1, out, B, H, W,
                     last_linear, device, stream);
}
