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
// (cp.async.cg, __ldcg). Only the read-only parts and weights may go
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
// Bfloat16 form: what the TPU kernel does in bf16 (pallas_conv.py:89,
// :171-175, :216-271): bf16 parts, weights and biases; every tap, channel
// and part summed in f32; the bias (widened) added and the LeakyReLU applied
// in f32; one rounding per layer, to nearest even, to the bf16 intermediate
// or output. The tensor-core layers take
// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32: one product per
// multiply-add (a bf16 product is exact in f32), no split and no lo half,
// the same tiles, warps, steps and two-stage ring as above. They add every
// mma straight into the accumulators: an output takes at most
// ceil(386/16) x 9 = 225 mma (the v1 level-6 S stack), so the truncation
// drift stays below 225 x 2^-23 of the sum, under 1 % of a bf16 ulp
// (2^-8), and a fresh sum per step would only cost registers. A staged row
// (16 channels of a pixel, or of a weight row) is CSB = 24 bf16 (48 bytes,
// 12 words) apart: the eight 16-byte ldmatrix rows of neighbouring pixels
// start at banks 0, 12, 24, 4, 16, 28, 8, 20, distinct groups of four. The
// layers of cout <= 8 widen their bf16 inputs and weights to f32 in shared
// memory and run the f32 FMA loop above. A bf16 element is 2 bytes and
// cp.async copies 4 at least, so the NCHW parts are not staged as the f32
// form stages them: a first phase of the launch repacks them into the NHWC
// scratch that layer 0 then reads like any later layer (32 channels x 64
// columns of a row through shared memory per step, 2-byte loads along the
// row, 4-byte stores along the channels), one grid.sync() before layer 0.
// It moves the parts' bytes twice more (0.17 ms of bytes at the S stack).
// The bf16 form uses less shared memory (51,072 bytes for a 3x3 layer with
// BN 64) and is bounded to 128 registers, so two blocks share an SM.
//
// Build (nvcc -Xptxas -v, sm_90a, as chip_smoke.py prints it), float32 form: 255 registers, 440
// bytes of stack, 520 bytes of spill stores and 1396 of spill loads, 768
// bytes of static shared memory; dynamic shared memory per layer_plan,
// 143,040 bytes for a 3x3 layer with BN 64 (one block of 256 threads per SM).
// bf16 form: 128 registers, 368 bytes of stack, 700 bytes of spill stores
// and 1640 of spill loads; one block per SM (248 registers, no spills) is
// 1.1-1.5x slower at the model's stacks (tests/conv_chain_variants.py).

#include <cooperative_groups.h>
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
constexpr int CSB = CK + 8;   // staged bf16 per pixel (bf16 form)
// FFMA path (cout <= 8)
constexpr int CI_T = 8;       // input channels staged per pass
constexpr int FT_H = 32;      // output rows per tile
constexpr int TW = 32;        // output columns per tile
constexpr int RX = 4;         // output columns per thread
constexpr int FFMA_MAX_COUT = 8;  // output channels of the FFMA path, all in each thread
// the bf16 form's repacking of the parts: channels x columns of one row per step
constexpr int RP_C = 32;
constexpr int RP_W = 64;
constexpr int RP_S = RP_W + 2;  // staged bf16 per channel row (33 words: column reads spread over the banks)

template <typename T>
constexpr bool is_f32 = std::is_same<T, float>::value;

// blocks per SM the kernel is compiled for: the f32 form takes up to 255 registers
template <typename T>
constexpr int MIN_BLOCKS = is_f32<T> ? 1 : 2;

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

// f32: two stages of the input chunk with its halo and one of its lo half; two of the weight
// slice. bf16: two stages of each, no lo half.
template <typename T>
__host__ inline size_t mma_smem_bytes(int k, int bn) {
  if (is_f32<T>) {
    const size_t a = (size_t)(MT_H + k - 1) * (MT_W + k - 1) * CS;
    const size_t b = (size_t)k * 2 * bn * CS;
    return (3 * a + 2 * b) * sizeof(float);
  }
  const size_t a = (size_t)(MT_H + k - 1) * (MT_W + k - 1) * CSB;
  const size_t b = (size_t)k * bn * CSB;
  return (2 * a + 2 * b) * sizeof(bf16);
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

// d += a * b on an m16n8k16 tile of bf16 operands into f32: a0 (g, 2t..2t+1), a1 (g+8, 2t..),
// a2 (g, 2t+8..), a3 (g+8, 2t+8..); b0 = (k 2t..2t+1, n g), b1 = (k 2t+8.., n g); d as c0..c3.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// bf16 form: one 16-channel chunk of the input tile (with its halo) from the NHWC scratch into
// [pixel][CSB] shared memory, two 16-byte copies per pixel.
template <int K>
__device__ __forceinline__ void stage_input_bf16(const bf16* base, int stride, int cin, int c0, int b, int y0,
                                                 int x0, int H, int W, bf16* dst) {
  constexpr int P = K / 2, SH = MT_H + K - 1, SW = MT_W + K - 1;
  for (int i = threadIdx.x; i < SH * SW * 2; i += THREADS) {
    const int pix = i >> 1, q = i & 1;
    const int rr = pix / SW, sx = pix - rr * SW;
    const int gy = y0 - P + rr, gx = x0 - P + sx, ch = c0 + 8 * q;
    const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
    const int bytes = in ? max(0, min(16, 2 * (cin - ch))) : 0;
    const bf16* g = bytes ? base + (((size_t)b * H + gy) * W + gx) * stride + ch : base;
    cp_async16(smem_addr(dst + pix * CSB + 8 * q), g, bytes);
  }
}

// bf16 form: one (chunk, ky) slice of the packed weights, [kx][BN][16 ci] contiguous in global
// memory, into the same order in shared memory with CSB bf16 per row.
template <int K, int BN>
__device__ __forceinline__ void stage_weights_bf16(const bf16* __restrict__ src, bf16* dst) {
  for (int i = threadIdx.x; i < K * BN * 2; i += THREADS)
    cp_async16(smem_addr(dst + (i >> 1) * CSB + 8 * (i & 1)), src + 8 * (size_t)i, 16);
}

// The tensor-core layer of the bf16 form: the tiles, warps and steps of mma_layer, one bf16
// product per multiply-add; the sums, the bias and the activation in f32, rounded once on store.
template <int K, int BN>
__device__ void mma_layer_bf16(const Src<bf16>& src, int cin, const bf16* __restrict__ w,
                               const bf16* __restrict__ bias, int cout, const Dst<bf16> dst, int B, int H, int W,
                               bool act, bf16* smem) {
  constexpr int WN = 2;                   // warp columns; each warp takes BN / 2 channels
  constexpr int WM = THREADS / 32 / WN;   // warp rows; each warp takes MI m tiles of 16 pixels
  constexpr int MI = 2 * MT_H / WM;
  constexpr int NT = BN / (8 * WN);       // n tiles of 8 channels per warp, loaded in pairs
  constexpr int SH = MT_H + K - 1, SW = MT_W + K - 1;
  constexpr int a_elems = SH * SW * CSB;
  constexpr int b_elems = K * BN * CSB;
  constexpr int stage_elems = K * BN * CK;
  bf16* const as = smem;                  // two stages of the chunk
  bf16* const bs = smem + 2 * a_elems;    // two stages of the weight slice
  const int nchunks = (cin + CK - 1) / CK;
  const int steps = nchunks * K;
  const int tiles_n = (cout + BN - 1) / BN;
  const int tiles_x = (W + MT_W - 1) / MT_W;
  const int tiles_y = (H + MT_H - 1) / MT_H;
  const long long ntiles = (long long)B * tiles_y * tiles_x * tiles_n;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WN, wn = warp % WN;
  const int g = lane >> 2, t = lane & 3;
  // ldmatrix rows of this lane: in the A tile of m tile mi, pixel lane & 15 at channels
  // 8 (lane >> 4) ..; in the B tiles of n tiles 2np, 2np+1, channel 8 (lane >> 4) + (lane & 7)
  // at input channels 8 ((lane >> 3) & 1) ..
  int a_off[MI];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
    a_off[mi] = ((wm * MI / 2 + (mi >> 1)) * SW + 16 * (mi & 1) + (lane & 15)) * CSB + 8 * (lane >> 4);
  const int b_off = (wn * (BN / WN) + 8 * (lane >> 4) + (lane & 7)) * CSB + 8 * ((lane >> 3) & 1);

  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    long long r = tile;
    const int nb = (int)(r % tiles_n);
    r /= tiles_n;
    const int bx = (int)(r % tiles_x);
    r /= tiles_x;
    const int by = (int)(r % tiles_y);
    const int b = (int)(r / tiles_y);
    const int x0 = bx * MT_W, y0 = by * MT_H;
    const bf16* wt = w + (size_t)nb * steps * stage_elems;

    float acc[MI][NT][4];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[mi][nt][j] = 0.f;

    __syncthreads();  // the previous tile's last step has finished with the staging buffers
    stage_input_bf16<K>(src.ptr[0], src.stride, cin, 0, b, y0, x0, H, W, as);
    stage_weights_bf16<K, BN>(wt, bs);
    cp_async_commit();
    for (int s = 0; s < steps; ++s) {
      const int c = s / K, ky = s - c * K;
      cp_async_wait_all();
      __syncthreads();  // step s is staged everywhere; step s-1's buffers are free
      if (s + 1 < steps) {
        if (ky == K - 1)
          stage_input_bf16<K>(src.ptr[0], src.stride, cin, (c + 1) * CK, b, y0, x0, H, W,
                              as + ((c + 1) & 1) * a_elems);
        stage_weights_bf16<K, BN>(wt + (size_t)(s + 1) * stage_elems, bs + ((s + 1) & 1) * b_elems);
        cp_async_commit();
      }
      const uint32_t a_base = smem_addr(as + (c & 1) * a_elems) + 2u * (uint32_t)(ky * SW * CSB);
      const uint32_t b_base = smem_addr(bs + (s & 1) * b_elems) + 2u * (uint32_t)b_off;
#pragma unroll
      for (int kx = 0; kx < K; ++kx) {
        uint32_t af[MI][4];
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) ldmatrix_x4(a_base + 2u * (uint32_t)(a_off[mi] + kx * CSB), af[mi]);
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t bf[4];  // b0, b1 of n tile 2np, then of 2np + 1
          ldmatrix_x4(b_base + 2u * (uint32_t)((kx * BN + 16 * np) * CSB), bf);
#pragma unroll
          for (int mi = 0; mi < MI; ++mi) {
            mma_bf16(acc[mi][2 * np], af[mi], bf[0], bf[1]);
            mma_bf16(acc[mi][2 * np + 1], af[mi], bf[2], bf[3]);
          }
        }
      }
    }

    // c0, c1 = (pixel g, channels 2t, 2t+1); c2, c3 = (pixel g + 8, the same channels)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int n = nb * BN + wn * (BN / WN) + 8 * nt + 2 * t;
      const float bias0 = n < cout ? elem::load(bias + n) : 0.f;
      const float bias1 = n + 1 < cout ? elem::load(bias + n + 1) : 0.f;
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
            bf16* o = dst.ptr + (((size_t)b * H + y) * W + x) * dst.stride + n;
            if (n + 1 < cout) *reinterpret_cast<uint32_t*>(o) = elem::pack2(v0, v1);
            else elem::store(o, v0);
          } else {
            bf16* o = dst.ptr + (((size_t)b * cout + n) * H + y) * W + x;
            elem::store(o, v0);
            if (n + 1 < cout) elem::store(o + (size_t)H * W, v1);
          }
        }
    }
  }
}

// The bf16 form's first phase: the NCHW parts, concatenated over channels, into the NHWC buffer
// `dst` (pixels `stride` bf16 apart) that layer 0 reads. A step moves RP_C channels x RP_W
// columns of one row through shared memory: 2-byte loads along the row, 4-byte stores of two
// channels along the pixel (a stored channel past cin is a 0 in the stride's padding).
__device__ void repack_parts(const ChainParams<bf16>& p, bf16* dst, uint16_t* tile) {
  const int cin = p.cin[0], stride = pixel_stride<bf16>(cin), H = p.H, W = p.W;
  const int tiles_x = (W + RP_W - 1) / RP_W, tiles_c = (cin + RP_C - 1) / RP_C;
  const long long ntiles = (long long)p.B * H * tiles_x * tiles_c;
  for (long long t = blockIdx.x; t < ntiles; t += gridDim.x) {
    long long r = t;
    const int ct = (int)(r % tiles_c);
    r /= tiles_c;
    const int bx = (int)(r % tiles_x);
    r /= tiles_x;
    const int y = (int)(r % H);
    const int b = (int)(r / H);
    const int c0 = ct * RP_C, x0 = bx * RP_W;
    __syncthreads();  // the previous step's stores have read the staged rows
    for (int i = threadIdx.x; i < RP_C * RP_W; i += THREADS) {
      const int cc = i / RP_W, xx = i - cc * RP_W;
      int ci = c0 + cc, s = 0;
      uint16_t v = 0;
      if (ci < cin && x0 + xx < W) {
        while (ci >= p.part_c[s]) ci -= p.part_c[s++];
        v = __ldg(reinterpret_cast<const uint16_t*>(p.part[s]) +
                  (((size_t)b * p.part_c[s] + ci) * H + y) * W + x0 + xx);
      }
      tile[cc * RP_S + xx] = v;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < RP_W * RP_C / 2; i += THREADS) {
      const int xx = i / (RP_C / 2), q = i - xx * (RP_C / 2), c = c0 + 2 * q;
      if (x0 + xx >= W || c >= cin) continue;
      const uint32_t v = tile[2 * q * RP_S + xx] | (uint32_t)tile[(2 * q + 1) * RP_S + xx] << 16;
      *reinterpret_cast<uint32_t*>(dst + (((size_t)b * H + y) * W + x0 + xx) * stride + c) = v;
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
  const int tid = threadIdx.x;
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
      __syncthreads();  // the previous pass has finished with the staged tiles
      if (tid < cn) {
        int ci = ci0 + tid, s = 0;
        if (src.stride) {
          s_base[tid] = src.ptr[0] + (size_t)b * plane * src.stride + ci;
        } else {
          while (ci >= src.c[s]) ci -= src.c[s++];
          s_base[tid] = src.ptr[s] + ((size_t)b * src.c[s] + ci) * plane;
        }
      }
      __syncthreads();
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
      __syncthreads();

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

template <typename T>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS<T>) conv_chain_kernel(ChainParams<T> p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  cg::grid_group grid = cg::this_grid();
  if constexpr (!is_f32<T>) {  // the parts into NHWC scratch, read by layer 0 as by any later layer
    repack_parts(p, p.buf[1], reinterpret_cast<uint16_t*>(smem4));
    grid.sync();
  }
  for (int l = 0; l < p.n_layers; ++l) {
    Src<T> src;
    if (l == 0 && is_f32<T>) {
      src.stride = 0;
#pragma unroll
      for (int i = 0; i < MAX_PARTS; ++i) {
        src.ptr[i] = p.part[i];
        src.c[i] = p.part_c[i];
      }
    } else {
      src.stride = pixel_stride<T>(p.cin[l]);
      src.ptr[0] = p.buf[(l + 1) & 1];  // layer l-1's output; the repacked parts for l = 0
      src.c[0] = p.cin[l];
    }
    const bool last = l == p.n_layers - 1;
    const Dst<T> dst = last ? Dst<T>{p.out, 0} : Dst<T>{p.buf[l & 1], pixel_stride<T>(p.cout[l])};
    const bool act = !last || !p.last_linear;
    const T* w = p.wpack + p.woff[l];
    const T* bias = p.wpack + p.boff[l];
    const int cin = p.cin[l], cout = p.cout[l];
    const int k = p.k[l];
    const int B = p.B, H = p.H, W = p.W;
    if (p.bn[l] == 0) {
      const int rc = ffma_channels(cout);
      if (k == 1) ffma_layer_k<T, 1>(rc, src, cin, w, bias, cout, dst, B, H, W, act, smem);
      else if (k == 3) ffma_layer_k<T, 3>(rc, src, cin, w, bias, cout, dst, B, H, W, act, smem);
      else if (k == 5) ffma_layer_k<T, 5>(rc, src, cin, w, bias, cout, dst, B, H, W, act, smem);
      else ffma_layer_k<T, 7>(rc, src, cin, w, bias, cout, dst, B, H, W, act, smem);
    } else if constexpr (is_f32<T>) {
      if (p.bn[l] == 64) {
        if (k == 1) mma_layer<1, 64>(src, cin, w, bias, cout, dst, B, H, W, act, smem);
        else if (k == 3) mma_layer<3, 64>(src, cin, w, bias, cout, dst, B, H, W, act, smem);
        else mma_layer<5, 64>(src, cin, w, bias, cout, dst, B, H, W, act, smem);
      } else {
        if (k == 1) mma_layer<1, 32>(src, cin, w, bias, cout, dst, B, H, W, act, smem);
        else if (k == 3) mma_layer<3, 32>(src, cin, w, bias, cout, dst, B, H, W, act, smem);
        else if (k == 5) mma_layer<5, 32>(src, cin, w, bias, cout, dst, B, H, W, act, smem);
        else mma_layer<7, 32>(src, cin, w, bias, cout, dst, B, H, W, act, smem);
      }
    } else {
      bf16* const sm = reinterpret_cast<bf16*>(smem4);
      if (p.bn[l] == 64) {
        if (k == 1) mma_layer_bf16<1, 64>(src, cin, w, bias, cout, dst, B, H, W, act, sm);
        else if (k == 3) mma_layer_bf16<3, 64>(src, cin, w, bias, cout, dst, B, H, W, act, sm);
        else if (k == 5) mma_layer_bf16<5, 64>(src, cin, w, bias, cout, dst, B, H, W, act, sm);
        else mma_layer_bf16<7, 64>(src, cin, w, bias, cout, dst, B, H, W, act, sm);
      } else {
        if (k == 1) mma_layer_bf16<1, 32>(src, cin, w, bias, cout, dst, B, H, W, act, sm);
        else if (k == 3) mma_layer_bf16<3, 32>(src, cin, w, bias, cout, dst, B, H, W, act, sm);
        else if (k == 5) mma_layer_bf16<5, 32>(src, cin, w, bias, cout, dst, B, H, W, act, sm);
        else mma_layer_bf16<7, 32>(src, cin, w, bias, cout, dst, B, H, W, act, sm);
      }
    }
    if (l + 1 < p.n_layers) grid.sync();  // layer l is written everywhere before l+1 reads it
  }
}

template <typename T>
int launch_chain(const void* parts, const void* part_c, int n_parts, const int* plan, int n_layers,
                 const void* wpack, void* buf0, void* buf1, void* out, int B, int H, int W, int last_linear,
                 int device, cudaStream_t stream) {
  ChainParams<T> p = {};
  const void* const* part_ptrs = (const void* const*)parts;
  const int* pc = (const int*)part_c;
  int cin = 0;
  for (int i = 0; i < n_parts; ++i) {
    p.part[i] = (const T*)part_ptrs[i];
    p.part_c[i] = pc[i];
    cin += pc[i];
  }
  p.n_layers = n_layers;
  long long max_tiles = 1;
  size_t smem = 0;
  if (!is_f32<T>) {  // the repacking phase
    smem = RP_C * RP_S * sizeof(bf16);
    max_tiles = (long long)B * H * ((W + RP_W - 1) / RP_W) * ((cin + RP_C - 1) / RP_C);
  }
  for (int l = 0; l < n_layers; ++l) {
    const int* f = plan + PLAN_FIELDS * l;
    const int k = f[0], cout = f[1], bn = f[2];
    if (k != 1 && k != 3 && k != 5 && k != 7) return (int)cudaErrorInvalidValue;
    // the tile widths instantiated: those layer_plan picks for each k
    const bool mma_ok = (bn == 64 && (k <= 5 || !is_f32<T>)) || bn == 32;
    if (bn == 0 ? cout > FFMA_MAX_COUT : !mma_ok || cout <= FFMA_MAX_COUT)
      return (int)cudaErrorInvalidValue;
    if (cout < 1 || f[3] < 0 || f[4] < 0 || (bn && f[3] % (16 / sizeof(T)))) return (int)cudaErrorInvalidValue;
    p.k[l] = k;
    p.cin[l] = cin;
    p.cout[l] = cout;
    p.bn[l] = bn;
    p.woff[l] = f[3];
    p.boff[l] = f[4];
    cin = cout;
    const size_t bytes = bn ? mma_smem_bytes<T>(k, bn) : ffma_smem_bytes(k, cout);
    if (bytes > SMEM_BUDGET) return (int)cudaErrorInvalidValue;
    smem = bytes > smem ? bytes : smem;
    const long long tiles = layer_tiles(B, H, W, cout, bn);
    max_tiles = tiles > max_tiles ? tiles : max_tiles;
  }
  p.wpack = (const T*)wpack;
  p.buf[0] = (T*)buf0;
  p.buf[1] = (T*)buf1;
  p.out = (T*)out;
  p.B = B;
  p.H = H;
  p.W = W;
  p.last_linear = last_linear;

  cudaError_t err =
      cudaFuncSetAttribute(conv_chain_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, conv_chain_kernel<T>, THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long fit = (long long)per_sm * sms;
  const dim3 grid((unsigned)(max_tiles < fit ? max_tiles : fit));
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel((const void*)conv_chain_kernel<T>, grid, dim3(THREADS), args, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int entry(const void* parts, const void* part_c, int n_parts, const void* plan, int n_layers, const void* wpack,
          void* buf0, void* buf1, void* out, int B, int H, int W, int last_linear, int device, void* stream) {
  if (n_parts < 1 || n_parts > MAX_PARTS || n_layers < 1 || n_layers > MAX_LAYERS)
    return (int)cudaErrorInvalidValue;
  return pivk::on_device(device, [&] {
    return launch_chain<T>(parts, part_c, n_parts, (const int*)plan, n_layers, wpack, buf0, buf1, out, B, H, W,
                           last_linear, device, (cudaStream_t)stream);
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
  return entry<float>(parts, part_c, n_parts, plan, n_layers, wpack, buf0, buf1, out, B, H, W, last_linear,
                      device, stream);
}

// The bf16 form: the arguments of the f32 form, every tensor bf16. The tensor-core weights
// are [cout/bn][chunk][ky][kx][bn][16] (no lo half), and each layer's weights start at a
// multiple of 8 elements. buf0/buf1: NHWC scratch of B * H * W * max((c + 7) & ~7 over the
// input channels cin_0 and couts[:-1]) bf16 each; buf1 takes the repacked parts first.
extern "C" int pivk_conv_chain_bf16(const void* parts, const void* part_c, int n_parts, const void* plan,
                                    int n_layers, const void* wpack, void* buf0, void* buf1, void* out, int B,
                                    int H, int W, int last_linear, int device, void* stream) {
  return entry<bf16>(parts, part_c, n_parts, plan, n_layers, wpack, buf0, buf1, out, B, H, W, last_linear,
                     device, stream);
}
