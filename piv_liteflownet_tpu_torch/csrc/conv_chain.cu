// A whole NetE conv stack in one launch, f32, NCHW.
//
//   x_0 = concat(parts)                       (never materialised)
//   x_l = act_l(conv_l(x_{l-1}) + bias_l),    l = 1 .. n_layers
//
// Every conv is SAME, stride 1, k x k with k in {1, 3, 5, 7}; act_l is
// LeakyReLU(0.1), except after the last conv when last_linear is set.
// Replaces the TPU kernel piv_liteflownet_tpu/ops/pallas_conv.py:
// conv_chain_pallas; its semantic reference is conv_chain_xla there, and the
// port's plain version is ops/conv_chain.py:conv_chain_plain.
//
// Bound on an H100: operations. The piv v1 level-1 R stack of a 1024^2 pair
// is 436,608 multiply-adds per pixel, 916 GFLOP, 13.7 ms at 67 TFLOP/s
// (float32 on the CUDA cores); its input is 0.5 GB, 0.17 ms at 3.35 TB/s.
//
// Design. The TPU kernel keeps each tile's whole chain on chip with a halo
// of up to 8 pixels; on this card a 128-channel f32 intermediate of a
// halo-8 16x16 tile alone would take 512 KB of shared memory, against 227 KB
// per block. So the layers run in turn inside one cooperative launch: a
// persistent grid (as many blocks as fit on the card at once) walks the
// output tiles of a layer, then cooperative_groups' grid.sync() separates it
// from the next. Intermediates ping-pong through two [B, <=128, H, W] scratch
// buffers that the caller allocates; they are read with __ldcg (L2, not the
// per-SM L1, which is not coherent across blocks within a launch). SAME
// padding at every layer is a bounds check while a tile is staged, and the
// first layer reads each part through its own pointer.
//
// A layer is a direct convolution with exact f32 FMAs (no TF32, no tensor
// cores). A block of 256 threads computes 32 output columns x TH rows x
// 8*G output channels, G = 1, 2 or 4 by the layer's width (TH = 32/G); each
// thread holds 8 channels x 4 neighbouring columns in registers. For every
// pass of 8 input channels the block stages the input tile with its halo and
// the weight slice [ci][ky][kx][co] in shared memory; a thread then reads
// each staged input row once as float4s, slides it over the k taps of the
// row, and takes its 8 weights per tap as two broadcast float4 loads.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_PARTS = 3;
constexpr int MAX_LAYERS = 8;
constexpr int THREADS = 256;
constexpr int CI_T = 8;   // input channels staged per pass
constexpr int TW = 32;    // tile width in pixels
constexpr int RX = 4;     // output columns per thread
constexpr int RC = 8;     // output channels per thread
constexpr float SLOPE = 0.1f;

struct ChainParams {
  const float* part[MAX_PARTS];
  int part_c[MAX_PARTS];
  int n_parts;
  int n_layers;
  int k[MAX_LAYERS];
  int cin[MAX_LAYERS];
  int cout[MAX_LAYERS];
  long long woff[MAX_LAYERS];  // layer l's weights [cin][k][k][cout] in wpack
  long long boff[MAX_LAYERS];  // and its bias [cout]
  const float* wpack;
  float* buf[2];
  float* out;
  int B, H, W;
  int last_linear;
};

// A layer's input: up to MAX_PARTS NCHW segments, concatenated over channels.
struct Src {
  const float* ptr[MAX_PARTS];
  int c[MAX_PARTS];
  int n;
};

__host__ __device__ inline int channel_groups(int cout) {
  return cout <= RC ? 1 : (cout <= 2 * RC ? 2 : 4);
}

__host__ __device__ inline int tile_rows(int cout) {
  return (THREADS / channel_groups(cout)) / (TW / RX);
}

__host__ __device__ inline int row_stride(int k) { return (TW + k - 1 + 3) & ~3; }

__host__ inline size_t layer_smem_bytes(int k, int cout) {
  const int g = channel_groups(cout);
  const int sh = tile_rows(cout) + k - 1;
  return sizeof(float) * ((size_t)CI_T * sh * row_stride(k) + (size_t)CI_T * k * k * RC * g);
}

__host__ inline long long layer_tiles(int B, int H, int W, int cout) {
  const int th = tile_rows(cout);
  const int cob = RC * channel_groups(cout);
  return (long long)B * ((H + th - 1) / th) * ((W + TW - 1) / TW) * ((cout + cob - 1) / cob);
}

__device__ __forceinline__ float activate(float v, bool act) {
  return act && v < 0.f ? v * SLOPE : v;
}

template <int K>
__device__ void conv_layer(const Src& src, int cin, const float* __restrict__ w,
                           const float* __restrict__ bias, int cout, float* dst,
                           int B, int H, int W, bool act, float* smem) {
  constexpr int P = K / 2;
  constexpr int SW = TW + K - 1;            // staged columns
  constexpr int RS = (SW + 3) & ~3;         // their row stride, float4-aligned
  constexpr int NV = (RX + K - 1 + 3) / 4;  // float4s a thread reads per staged row
  __shared__ const float* s_base[CI_T];     // channel plane of each staged channel

  const int gco = channel_groups(cout);
  const int gpx = THREADS / gco;
  const int th = tile_rows(cout);
  const int cob = RC * gco;
  const int sh = th + K - 1;
  float* s_in = smem;
  float* s_w = smem + CI_T * sh * RS;

  const int tid = threadIdx.x;
  const int grp = tid / gpx;               // this thread's group of RC output channels
  const int pg = tid - grp * gpx;
  const int ty = pg / (TW / RX);
  const int tx = (pg - ty * (TW / RX)) * RX;

  const int tiles_x = (W + TW - 1) / TW;
  const int tiles_y = (H + th - 1) / th;
  const int tiles_c = (cout + cob - 1) / cob;
  const long long ntiles = (long long)B * tiles_y * tiles_x * tiles_c;
  const size_t plane = (size_t)H * W;

  for (long long t = blockIdx.x; t < ntiles; t += gridDim.x) {
    // channel tiles vary fastest, so blocks that share an input tile run together
    long long r = t;
    const int tc = (int)(r % tiles_c);
    r /= tiles_c;
    const int bx = (int)(r % tiles_x);
    r /= tiles_x;
    const int by = (int)(r % tiles_y);
    const int b = (int)(r / tiles_y);
    const int x0 = bx * TW;
    const int y0 = by * th;
    const int co0 = tc * cob;

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
        while (ci >= src.c[s]) ci -= src.c[s++];
        s_base[tid] = src.ptr[s] + ((size_t)b * src.c[s] + ci) * plane;
      }
      __syncthreads();
      for (int i = tid; i < cn * sh * SW; i += THREADS) {
        const int cc = i / (sh * SW);
        const int rem = i - cc * sh * SW;
        const int rr = rem / SW;
        const int s = rem - rr * SW;
        const int gy = y0 - P + rr;
        const int gx = x0 - P + s;
        float v = 0.f;
        if (gy >= 0 && gy < H && gx >= 0 && gx < W) v = __ldcg(s_base[cc] + (size_t)gy * W + gx);
        s_in[(cc * sh + rr) * RS + s] = v;
      }
      const float* wsrc = w + (size_t)ci0 * K * K * cout;
      for (int i = tid; i < cn * K * K * cob; i += THREADS) {
        const int co = i % cob;
        const int rest = i / cob;  // (ci - ci0) * K * K + ky * K + kx
        const int gc = co0 + co;
        s_w[i] = gc < cout ? __ldg(wsrc + (size_t)rest * cout + gc) : 0.f;
      }
      __syncthreads();

      for (int cc = 0; cc < cn; ++cc) {
#pragma unroll
        for (int ky = 0; ky < K; ++ky) {
          const float4* row = reinterpret_cast<const float4*>(s_in + (cc * sh + ty + ky) * RS + tx);
          float v[NV * 4];
#pragma unroll
          for (int q = 0; q < NV; ++q) {
            const float4 f = row[q];
            v[4 * q] = f.x;
            v[4 * q + 1] = f.y;
            v[4 * q + 2] = f.z;
            v[4 * q + 3] = f.w;
          }
          const float* wrow = s_w + (cc * K + ky) * K * cob + grp * RC;
#pragma unroll
          for (int kx = 0; kx < K; ++kx) {
            const float4 wa = *reinterpret_cast<const float4*>(wrow + kx * cob);
            const float4 wb = *reinterpret_cast<const float4*>(wrow + kx * cob + 4);
            const float wv[RC] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
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
    const bool vec = (W & 3) == 0 && x + RX <= W;
#pragma unroll
    for (int c = 0; c < RC; ++c) {
      const int co = co0 + grp * RC + c;
      if (co >= cout) break;
      const float bv = __ldg(bias + co);
      float* o = dst + ((size_t)b * cout + co) * plane + (size_t)y * W + x;
      if (vec) {
        *reinterpret_cast<float4*>(o) =
            make_float4(activate(acc[c][0] + bv, act), activate(acc[c][1] + bv, act),
                        activate(acc[c][2] + bv, act), activate(acc[c][3] + bv, act));
      } else {
#pragma unroll
        for (int j = 0; j < RX; ++j)
          if (x + j < W) o[j] = activate(acc[c][j] + bv, act);
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS, 2) conv_chain_kernel(ChainParams p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  cg::grid_group grid = cg::this_grid();
  for (int l = 0; l < p.n_layers; ++l) {
    Src src;
    if (l == 0) {
      src.n = p.n_parts;
#pragma unroll
      for (int i = 0; i < MAX_PARTS; ++i) {
        src.ptr[i] = p.part[i];
        src.c[i] = p.part_c[i];
      }
    } else {
      src.n = 1;
      src.ptr[0] = p.buf[(l - 1) & 1];
      src.c[0] = p.cin[l];
    }
    float* dst = l == p.n_layers - 1 ? p.out : p.buf[l & 1];
    const bool act = l < p.n_layers - 1 || !p.last_linear;
    const float* w = p.wpack + p.woff[l];
    const float* bias = p.wpack + p.boff[l];
    switch (p.k[l]) {
      case 1: conv_layer<1>(src, p.cin[l], w, bias, p.cout[l], dst, p.B, p.H, p.W, act, smem); break;
      case 3: conv_layer<3>(src, p.cin[l], w, bias, p.cout[l], dst, p.B, p.H, p.W, act, smem); break;
      case 5: conv_layer<5>(src, p.cin[l], w, bias, p.cout[l], dst, p.B, p.H, p.W, act, smem); break;
      default: conv_layer<7>(src, p.cin[l], w, bias, p.cout[l], dst, p.B, p.H, p.W, act, smem); break;
    }
    if (l + 1 < p.n_layers) grid.sync();  // layer l is written everywhere before l+1 reads it
  }
}

}  // namespace

// parts: host array of n_parts device pointers; part_c: their channel counts;
// ks, couts: host arrays of n_layers kernel sizes and output widths. wpack
// holds, per layer, weights [cin][k][k][cout] then bias [cout]. buf0/buf1:
// scratch of B * max(couts[:-1]) * H * W floats each (unused for one layer).
extern "C" int pivk_conv_chain_f32(const void* parts, const void* part_c, int n_parts,
                                   const void* ks, const void* couts, int n_layers,
                                   const void* wpack, void* buf0, void* buf1, void* out,
                                   int B, int H, int W, int last_linear, int device,
                                   void* stream) {
  if (n_parts < 1 || n_parts > MAX_PARTS || n_layers < 1 || n_layers > MAX_LAYERS)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  ChainParams p = {};
  const void* const* part_ptrs = (const void* const*)parts;
  const int* pc = (const int*)part_c;
  const int* k = (const int*)ks;
  const int* co = (const int*)couts;
  int cin = 0;
  for (int i = 0; i < n_parts; ++i) {
    p.part[i] = (const float*)part_ptrs[i];
    p.part_c[i] = pc[i];
    cin += pc[i];
  }
  p.n_parts = n_parts;
  p.n_layers = n_layers;
  long long off = 0, max_tiles = 1;
  size_t smem = 0;
  for (int l = 0; l < n_layers; ++l) {
    if (k[l] != 1 && k[l] != 3 && k[l] != 5 && k[l] != 7) return (int)cudaErrorInvalidValue;
    p.k[l] = k[l];
    p.cin[l] = cin;
    p.cout[l] = co[l];
    p.woff[l] = off;
    off += (long long)cin * k[l] * k[l] * co[l];
    p.boff[l] = off;
    off += co[l];
    cin = co[l];
    const size_t bytes = layer_smem_bytes(k[l], co[l]);
    smem = bytes > smem ? bytes : smem;
    const long long tiles = layer_tiles(B, H, W, co[l]);
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

  err = cudaFuncSetAttribute(conv_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, conv_chain_kernel, THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long fit = (long long)per_sm * sms;
  const dim3 grid((unsigned)(max_tiles < fit ? max_tiles : fit));
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel((const void*)conv_chain_kernel, grid, dim3(THREADS), args, smem,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
