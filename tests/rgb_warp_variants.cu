// Variants of the rgb warp-norm kernel (csrc/rgb_warp_norm.cu), built beside it by
// tests/rgb_warp_variants.py, which times them in turns. This file includes the tree's source, so
// its library holds the tree's two entry points and, for each variant and dtype, an entry point
// rgbv_<variant>_<f32|bf16> with the float32 form's arguments (a counter of pixels or tiles that
// gathered directly after out; the variants without a direct path leave it alone):
//
//   lanes     the tree's kernel with two pixels a lane (32 apart) whatever the map's size;
//   lanes1    the same with one pixel a lane;
//   window    a tile of 64 x 16 pixels stages the img2 rows within R = 8 pixels of it before its flow
//             is known (one trip to memory); a pixel with a tap beyond the window, and every pixel
//             of a map whose rows are not 16-byte aligned, gathers directly and is counted;
//   window_r4 the same with R = 4;
//   vec       adjacent pixels a lane, 16 bytes of each plane (4 f32 or 8 bf16): one 16-byte load of
//             u, v and each img1 plane, one 16-byte store; rows not 16-byte aligned take lanes;
//   staged    the footprint of each tile's taps, staged once its flow is known (two trips);
//   pipe      persistent lanes, one pixel a lane, the next segment's flow and img1 loads issued
//             before the current segment's sums.
//
// Every variant keeps each pixel's arithmetic and its order: outputs bit-equal to the tree's.

#include <algorithm>
#include <climits>
#include <cstdint>
#include <type_traits>

#include "rgb_warp_norm.cu"

namespace var {

using elem::bf16;

constexpr int SCAP = 960;  // 16-byte chunks of a plane's footprint that the staged variant holds

// The window variant's tile and reach.
constexpr int TW = 64, TH = 16, R = 8;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"((unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}

// The window of a tile in shared memory: [3][NR][PITCH] values of T.
template <typename T, int TH_, int R_>
struct Window {
  static constexpr int CW = 16 / sizeof(T);                                 // values a 16-byte chunk
  static constexpr int PITCH = (TW + 2 * R_ + 1 + 2 * (CW - 1)) / CW * CW;  // values a row
  static constexpr int NR = TH_ + 2 * R_ + 1;                               // rows, at most
};

// A warp takes rows wid, wid + WARPS, ... of the tile, a lane the columns lane and lane + 32.
// aligned: W % CW == 0 and img2 16-byte aligned, so that every row of a plane starts on 16 bytes.
template <typename T, int TH_, int R_>
__global__ void __launch_bounds__(BLOCK)
window_kernel(const T* __restrict__ img1, const T* __restrict__ img2, const T* __restrict__ flow,
              T* __restrict__ out, unsigned int* __restrict__ n_direct, int H, int W, bool aligned) {
  using Win = Window<T, TH_, R_>;
  constexpr int CW = Win::CW, PITCH = Win::PITCH, NR = Win::NR, PX = 2 * TH_ / WARPS;  // pixels a lane
  __shared__ __align__(16) unsigned char smem[3 * NR * PITCH * sizeof(T)];
  T* win = reinterpret_cast<T*>(smem);
  const int lane = threadIdx.x % 32, wid = threadIdx.x / 32;
  const int tx0 = blockIdx.x * TW, ty0 = blockIdx.y * TH_;
  const size_t npix = (size_t)H * W, b = blockIdx.z;
  const T* f = flow + 2 * b * npix;
  const T* i1 = img1 + 3 * b * npix;
  const T* i2 = img2 + 3 * b * npix;
  // the window: columns ws .. ws + CW * ncw - 1, rows rs .. rs + nr - 1
  const int ws = max(tx0 - R_, 0) & ~(CW - 1), ncw = (min(tx0 + TW + R_, W - 1) - ws) / CW + 1;
  const int rs = max(ty0 - R_, 0), nr = min(ty0 + TH_ + R_, H - 1) - rs + 1;
  if (aligned) {
    for (int r = wid; r < 3 * nr; r += WARPS) {
      const int c = r / nr, row = r - c * nr;
      if (lane < ncw)
        cp_async16(win + (c * NR + row) * PITCH + lane * CW, i2 + c * npix + (size_t)(rs + row) * W + ws + lane * CW);
    }
    asm volatile("cp.async.commit_group;");
  }
  float u[PX], v[PX], a[3][PX];
#pragma unroll
  for (int p = 0; p < PX; ++p) {
    const int y = ty0 + wid + WARPS * (p / 2), x = tx0 + lane + 32 * (p % 2);
    const bool in = y < H && x < W;
    const size_t q = (size_t)y * W + x;
    u[p] = in ? elem::load(f + q) : 0.f;
    v[p] = in ? elem::load(f + npix + q) : 0.f;
#pragma unroll
    for (int c = 0; c < 3; ++c) a[c][p] = in ? elem::load(i1 + c * npix + q) : 0.f;
  }
  if (aligned) asm volatile("cp.async.wait_group 0;");
  __syncthreads();
  unsigned ndir = 0;
  T* o = out + b * npix;
#pragma unroll
  for (int p = 0; p < PX; ++p) {
    const int y = ty0 + wid + WARPS * (p / 2), x = tx0 + lane + 32 * (p % 2);
    const bool in = y < H && x < W;
    const BilinearTaps t = bilinear_taps((float)x + u[p], (float)y + v[p], H, W);
    bool direct = !aligned;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int cx = t.x0 + (k & 1), cy = t.y0 + (k >> 1);
      if (t.off[k] >= 0)
        direct |= (unsigned)(cx - ws) >= (unsigned)(CW * ncw) || (unsigned)(cy - rs) >= (unsigned)nr;
    }
    ndir += __popc(__ballot_sync(FULL, in && direct));
    if (!in) continue;
    float sq = 0.f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float s = 0.f;  // bilinear_sample's sum, in its order
      if (direct) {
        s = bilinear_sample(i2 + c * npix, t);
      } else {
        const T* wc = win + (c * NR + t.y0 - rs) * PITCH + t.x0 - ws;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (t.off[k] >= 0) s += t.w[k] * elem::widen(wc[(k >> 1) * PITCH + (k & 1)]);
        }
      }
      const float d = a[c][p] - s;
      sq += d * d;
    }
    elem::store(o + (size_t)y * W + x, sqrtf(sq));
  }
  if (lane == 0 && ndir) atomicAdd(n_direct, ndir);
}


template <typename T, int TH_ = TH, int R_ = R>
int launch_window(const void* img1, const void* img2, const void* flow, void* out, void* n_direct, int B, int H,
                  int W, int device, void* stream) {
  const bool aligned = W % Window<T, TH_, R_>::CW == 0 && reinterpret_cast<uintptr_t>(img2) % 16 == 0;
  return pivk::on_device(device, [&] {
    const dim3 grid((unsigned)((W + TW - 1) / TW), (unsigned)((H + TH_ - 1) / TH_), (unsigned)B);
    window_kernel<T, TH_, R_><<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
        (const T*)img1, (const T*)img2, (const T*)flow, (T*)out, (unsigned int*)n_direct, H, W, aligned);
    return (int)cudaGetLastError();
  });
}

// The tree's lane kernel with J pixels a lane whatever the map's size.
template <typename T, int J>
int launch_lanes_fixed(const void* img1, const void* img2, const void* flow, void* out, int B, int H, int W,
                       int device, void* stream) {
  return pivk::on_device(device, [&] {
    launch_lanes<T, J>(img1, img2, flow, out, B, H, W, (cudaStream_t)stream);
    return (int)cudaGetLastError();
  });
}


// V adjacent values from device memory as f32: one load of 16 bytes (p aligned to it).
template <int V, typename T>
__device__ __forceinline__ void ldv(const T* p, float* v) {
  if constexpr (std::is_same_v<T, float>) {
    static_assert(V == 4);
    elem::ldg4(p, v);
  } else {
    static_assert(V == 8);
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = elem::lo(w[i]);
      v[2 * i + 1] = elem::hi(w[i]);
    }
  }
}

// V adjacent values to device memory, rounded to T: one store of 16 bytes.
template <int V, typename T>
__device__ __forceinline__ void stv(T* p, const float* v) {
  if constexpr (std::is_same_v<T, float>) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *reinterpret_cast<uint4*>(p) = make_uint4(elem::pack2(v[0], v[1]), elem::pack2(v[2], v[3]),
                                              elem::pack2(v[4], v[5]), elem::pack2(v[6], v[7]));
  }
}

template <typename T>
__global__ void __launch_bounds__(BLOCK)
vec_kernel(const T* __restrict__ img1, const T* __restrict__ img2, const T* __restrict__ flow,
           T* __restrict__ out, int H, int W) {
  constexpr int V = 16 / sizeof(T);
  const int y = blockIdx.y * WARPS + threadIdx.x / 32;
  const int x = (blockIdx.x * 32 + threadIdx.x % 32) * V;
  if (y >= H || x >= W) return;
  const size_t npix = (size_t)H * W, b = blockIdx.z, row = (size_t)y * W;
  const T* f = flow + 2 * b * npix + row;
  const T* i1 = img1 + 3 * b * npix + row;
  const T* i2 = img2 + 3 * b * npix;
  float u[V], v[V], a[3][V];
  ldv<V>(f + x, u);
  ldv<V>(f + npix + x, v);
#pragma unroll
  for (int c = 0; c < 3; ++c) ldv<V>(i1 + c * npix + x, a[c]);
  int off[V][4];
  float w[V][4], g[3][V][4];
#pragma unroll
  for (int e = 0; e < V; ++e) {
    const BilinearTaps t = bilinear_taps((float)(x + e) + u[e], (float)y + v[e], H, W);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      off[e][k] = t.off[k];
      w[e][k] = t.w[k];
    }
  }
#pragma unroll
  for (int e = 0; e < V; ++e)
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
      for (int k = 0; k < 4; ++k) g[c][e][k] = off[e][k] >= 0 ? elem::load(i2 + c * npix + off[e][k]) : 0.f;
  float n[V];
#pragma unroll
  for (int e = 0; e < V; ++e) {
    float sq = 0.f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (off[e][k] >= 0) s += w[e][k] * g[c][e][k];
      }
      const float d = a[c][e] - s;
      sq += d * d;
    }
    n[e] = sqrtf(sq);
  }
  stv<V>(out + b * npix + row + x, n);
}

// Staged: a block of 8 rows x 32 J pixels loads its flow, reduces its taps inside the map to their
// footprint, copies the footprint's rows of the three img2 planes from x rounded down to 16 bytes
// into shared memory with 16-byte cp.async and sums from there (two trips to memory); a tile whose
// footprint has more than SCAP chunks a plane, or rows not 16-byte aligned, gathers directly and
// adds one to the counter.
template <typename T, int J, int MINB>
__global__ void __launch_bounds__(BLOCK, MINB)
staged_kernel(const T* __restrict__ img1, const T* __restrict__ img2, const T* __restrict__ flow,
               T* __restrict__ out, unsigned int* __restrict__ n_direct, int H, int W, bool aligned) {
  constexpr int CW = 16 / sizeof(T);
  __shared__ uint4 stage[3][SCAP];
  __shared__ int red[4][WARPS];
  const int lane = threadIdx.x % 32, wid = threadIdx.x / 32;
  const int y = blockIdx.y * WARPS + wid;
  const size_t npix = (size_t)H * W, b = blockIdx.z, row = (size_t)y * W;
  const int x0 = blockIdx.x * 32 * J + lane;
  const T* f = flow + 2 * b * npix + row;
  const T* i1 = img1 + 3 * b * npix + row;
  const T* i2 = img2 + 3 * b * npix;
  float a[3][J];
  BilinearTaps t[J];
  int m[4] = {INT_MAX, INT_MAX, INT_MAX, INT_MAX};
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int x = x0 + 32 * j;
    const bool in = y < H && x < W;
#pragma unroll
    for (int c = 0; c < 3; ++c) a[c][j] = in ? elem::load(i1 + c * npix + x) : 0.f;
    t[j] = bilinear_taps(in ? (float)x + elem::load(f + x) : -2.f, in ? (float)y + elem::load(f + npix + x) : -2.f,
                         H, W);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (t[j].off[k] >= 0) {
        const int cx = t[j].x0 + (k & 1), cy = t[j].y0 + (k >> 1);
        m[0] = min(m[0], cx);
        m[1] = min(m[1], -cx);
        m[2] = min(m[2], cy);
        m[3] = min(m[3], -cy);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = __reduce_min_sync(FULL, m[i]);
    if (lane == 0) red[i][wid] = r;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = red[i][0];
#pragma unroll
    for (int w2 = 1; w2 < WARPS; ++w2) m[i] = min(m[i], red[i][w2]);
  }
  const bool empty = m[0] == INT_MAX;
  const int fx0 = empty ? 0 : m[0] & ~(CW - 1), fy0 = empty ? 0 : m[2];
  const int ncw = empty ? 0 : (-m[1] - fx0) / CW + 1;
  const int n = empty ? 0 : ncw * (-m[3] - fy0 + 1);
  const bool direct = !aligned || n > SCAP;
  if (direct) {
    if (threadIdx.x == 0) atomicAdd(n_direct, 1u);
  } else {
    for (int i = threadIdx.x; i < 3 * n; i += BLOCK) {
      const int c = i / n, r = i - c * n, rr = r / ncw;
      cp_async16(&stage[c][r], i2 + c * npix + (size_t)(fy0 + rr) * W + fx0 + CW * (r - rr * ncw));
    }
    asm volatile("cp.async.commit_group;");
    asm volatile("cp.async.wait_group 0;");
    __syncthreads();
  }
  if (y >= H) return;
  T* o = out + b * npix + row;
  const T* s = reinterpret_cast<const T*>(&stage[0][0]);
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int x = x0 + 32 * j;
    if (x >= W) continue;
    float sq = 0.f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float sum = 0.f;
      if (direct) {
        sum = bilinear_sample(i2 + c * npix, t[j]);
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (t[j].off[k] >= 0) {
            const int so = c * SCAP * CW + (t[j].y0 + (k >> 1) - fy0) * ncw * CW + t[j].x0 + (k & 1) - fx0;
            float val;
            if constexpr (std::is_same_v<T, float>) val = s[so];
            else val = __uint_as_float((uint32_t)reinterpret_cast<const unsigned short*>(s)[so] << 16);
            sum += t[j].w[k] * val;
          }
        }
      }
      const float d = a[c][j] - sum;
      sq += d * d;
    }
    elem::store(o + x, sqrtf(sq));
  }
}

// Persistent lanes: a grid of resident blocks whose warps walk the row segments (32 J pixels), the
// next segment's flow and img1 loads issued before the current segment's sums.
template <typename T, int J>
__global__ void __launch_bounds__(BLOCK)
pipe_kernel(const T* __restrict__ img1, const T* __restrict__ img2, const T* __restrict__ flow,
            T* __restrict__ out, int B, int H, int W) {
  const int ntx = (W + 32 * J - 1) / (32 * J);
  const int nseg = ntx * H * B;
  const int step = gridDim.x * WARPS;
  const size_t npix = (size_t)H * W;
  const int lane = threadIdx.x % 32;
  int seg = blockIdx.x * WARPS + threadIdx.x / 32;
  float u[J], v[J], a[3][J];
  auto fetch = [&](int sg, float* uu, float* vv, float (*aa)[J]) {
    const int xt = sg % ntx, rest = sg / ntx, y = rest % H, b = rest / H;
    const int x0 = xt * 32 * J + lane;
    const T* f = flow + 2 * (size_t)b * npix + (size_t)y * W;
    const T* i1 = img1 + 3 * (size_t)b * npix + (size_t)y * W;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int x = x0 + 32 * j;
      const bool in = sg < nseg && x < W;
      uu[j] = in ? elem::load(f + x) : 0.f;
      vv[j] = in ? elem::load(f + npix + x) : 0.f;
#pragma unroll
      for (int c = 0; c < 3; ++c) aa[c][j] = in ? elem::load(i1 + c * npix + x) : 0.f;
    }
  };
  fetch(seg, u, v, a);
  for (; seg < nseg; seg += step) {
    const int xt = seg % ntx, rest = seg / ntx, y = rest % H, b = rest / H;
    const int x0 = xt * 32 * J + lane;
    const T* i2 = img2 + 3 * (size_t)b * npix;
    int off[J][4];
    float w[J][4], g[3][J][4];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int x = x0 + 32 * j;
      const BilinearTaps t = bilinear_taps((float)x + u[j], (float)y + v[j], H, W);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        off[j][k] = x < W ? t.off[k] : -1;
        w[j][k] = t.w[k];
      }
    }
#pragma unroll
    for (int j = 0; j < J; ++j)
#pragma unroll
      for (int c = 0; c < 3; ++c)
#pragma unroll
        for (int k = 0; k < 4; ++k) g[c][j][k] = off[j][k] >= 0 ? elem::load(i2 + c * npix + off[j][k]) : 0.f;
    float cur[3][J];
#pragma unroll
    for (int j = 0; j < J; ++j)
#pragma unroll
      for (int c = 0; c < 3; ++c) cur[c][j] = a[c][j];
    fetch(seg + step, u, v, a);
    T* o = out + (size_t)b * npix + (size_t)y * W;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      float sq = 0.f;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        float s = 0.f;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (off[j][k] >= 0) s += w[j][k] * g[c][j][k];
        }
        const float d = cur[c][j] - s;
        sq += d * d;
      }
      const int x = x0 + 32 * j;
      if (x < W) elem::store(o + x, sqrtf(sq));
    }
  }
}

template <typename T, int J, int MINB>
int launch_staged(const void* img1, const void* img2, const void* flow, void* out, void* n_direct, int B,
                   int H, int W, int device, void* stream) {
  const bool aligned = W % (16 / (int)sizeof(T)) == 0 && reinterpret_cast<uintptr_t>(img2) % 16 == 0;
  return pivk::on_device(device, [&] {
    const dim3 grid((unsigned)((W + 32 * J - 1) / (32 * J)), (unsigned)((H + WARPS - 1) / WARPS), (unsigned)B);
    staged_kernel<T, J, MINB><<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
        (const T*)img1, (const T*)img2, (const T*)flow, (T*)out, (unsigned int*)n_direct, H, W, aligned);
    return (int)cudaGetLastError();
  });
}

template <typename T, int J, int PER_SM>
int launch_pipe(const void* img1, const void* img2, const void* flow, void* out, int B, int H, int W,
                int device, void* stream) {
  return pivk::on_device(device, [&] {
    int sms = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    const long long nseg = (long long)((W + 32 * J - 1) / (32 * J)) * H * B;
    const long long blocks = std::min<long long>((long long)sms * PER_SM, (nseg + WARPS - 1) / WARPS);
    pipe_kernel<T, J><<<(unsigned)blocks, BLOCK, 0, (cudaStream_t)stream>>>(
        (const T*)img1, (const T*)img2, (const T*)flow, (T*)out, B, H, W);
    return (int)cudaGetLastError();
  });
}

// The tree's lane kernel with an L2 prefetch of img2 at rows y - LO .. y - LO + ROWS - 1 of each
// pixel's own column in the three planes, issued before its flow loads: the gathers of a smooth
// flow then find their rows in L2 instead of device memory.
template <typename T, int J, int ROWS, int LO>
__global__ void __launch_bounds__(BLOCK, 4)
pref_kernel(const T* __restrict__ img1, const T* __restrict__ img2, const T* __restrict__ flow,
            T* __restrict__ out, int H, int W) {
  const int y = blockIdx.y * WARPS + threadIdx.x / 32;
  if (y >= H) return;
  const size_t npix = (size_t)H * W, b = blockIdx.z, row = (size_t)y * W;
  const int x0 = blockIdx.x * 32 * J + threadIdx.x % 32;
  const T* f = flow + 2 * b * npix + row;
  const T* i1 = img1 + 3 * b * npix + row;
  const T* i2 = img2 + 3 * b * npix;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int x = x0 + 32 * j;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int yy = y - LO + r;
      if (x < W && yy >= 0 && yy < H)
#pragma unroll
        for (int c = 0; c < 3; ++c)
          asm volatile("prefetch.global.L2 [%0];" ::"l"(i2 + c * npix + (size_t)yy * W + x));
    }
  }
  float u[J], v[J], a[3][J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int x = x0 + 32 * j;
    const bool in = x < W;
    u[j] = in ? elem::load(f + x) : 0.f;
    v[j] = in ? elem::load(f + npix + x) : 0.f;
#pragma unroll
    for (int c = 0; c < 3; ++c) a[c][j] = in ? elem::load(i1 + c * npix + x) : 0.f;
  }
  int off[J][4];
  float w[J][4], g[3][J][4];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int x = x0 + 32 * j;
    const BilinearTaps t = bilinear_taps((float)x + u[j], (float)y + v[j], H, W);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      off[j][k] = x < W ? t.off[k] : -1;
      w[j][k] = t.w[k];
    }
  }
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
      for (int k = 0; k < 4; ++k) g[c][j][k] = off[j][k] >= 0 ? elem::load(i2 + c * npix + off[j][k]) : 0.f;
  T* o = out + b * npix + row;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    float sq = 0.f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (off[j][k] >= 0) s += w[j][k] * g[c][j][k];
      }
      const float d = a[c][j] - s;
      sq += d * d;
    }
    const int x = x0 + 32 * j;
    if (x < W) elem::store(o + x, sqrtf(sq));
  }
}

template <typename T, int ROWS, int LO>
int launch_pref(const void* img1, const void* img2, const void* flow, void* out, int B, int H, int W,
                int device, void* stream) {
  return pivk::on_device(device, [&] {
    if ((long long)B * H * W >= LANES2_MIN_PIXELS) {
      const dim3 grid((unsigned)((W + 63) / 64), (unsigned)((H + WARPS - 1) / WARPS), (unsigned)B);
      pref_kernel<T, 2, ROWS, LO><<<grid, BLOCK, 0, (cudaStream_t)stream>>>((const T*)img1, (const T*)img2,
                                                                            (const T*)flow, (T*)out, H, W);
    } else {
      const dim3 grid((unsigned)((W + 31) / 32), (unsigned)((H + WARPS - 1) / WARPS), (unsigned)B);
      pref_kernel<T, 1, ROWS, LO><<<grid, BLOCK, 0, (cudaStream_t)stream>>>((const T*)img1, (const T*)img2,
                                                                            (const T*)flow, (T*)out, H, W);
    }
    return (int)cudaGetLastError();
  });
}

template <typename T>
int launch_vec(const void* img1, const void* img2, const void* flow, void* out, int B, int H, int W,
               int device, void* stream) {
  constexpr int V = 16 / sizeof(T);
  const bool aligned = W % V == 0 && (reinterpret_cast<uintptr_t>(img1) | reinterpret_cast<uintptr_t>(flow) |
                                      reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  if (!aligned) return launch<T>(img1, img2, flow, out, B, H, W, device, stream);
  return pivk::on_device(device, [&] {
    const dim3 grid((unsigned)((W + 32 * V - 1) / (32 * V)), (unsigned)((H + WARPS - 1) / WARPS), (unsigned)B);
    vec_kernel<T><<<grid, BLOCK, 0, (cudaStream_t)stream>>>((const T*)img1, (const T*)img2, (const T*)flow,
                                                            (T*)out, H, W);
    return (int)cudaGetLastError();
  });
}


}  // namespace var

#define RGBV_ENTRY(name, body)                                                                        \
  extern "C" int rgbv_##name(const void* img1, const void* img2, const void* flow, void* out,        \
                             void* n_direct, int B, int H, int W, int device, void* stream) {        \
    (void)n_direct;                                                                                   \
    return body;                                                                                      \
  }

RGBV_ENTRY(lanes_f32, (var::launch_lanes_fixed<float, 2>(img1, img2, flow, out, B, H, W, device, stream)))
RGBV_ENTRY(lanes_bf16, (var::launch_lanes_fixed<elem::bf16, 2>(img1, img2, flow, out, B, H, W, device, stream)))
RGBV_ENTRY(lanes1_f32, (var::launch_lanes_fixed<float, 1>(img1, img2, flow, out, B, H, W, device, stream)))
RGBV_ENTRY(lanes1_bf16, (var::launch_lanes_fixed<elem::bf16, 1>(img1, img2, flow, out, B, H, W, device, stream)))
RGBV_ENTRY(window_f32, (var::launch_window<float>(img1, img2, flow, out, n_direct, B, H, W, device, stream)))
RGBV_ENTRY(window_bf16,
           (var::launch_window<elem::bf16>(img1, img2, flow, out, n_direct, B, H, W, device, stream)))
RGBV_ENTRY(window_r4_f32,
           (var::launch_window<float, 16, 4>(img1, img2, flow, out, n_direct, B, H, W, device, stream)))
RGBV_ENTRY(window_r4_bf16,
           (var::launch_window<elem::bf16, 16, 4>(img1, img2, flow, out, n_direct, B, H, W, device, stream)))
RGBV_ENTRY(vec_f32, (var::launch_vec<float>(img1, img2, flow, out, B, H, W, device, stream)))
RGBV_ENTRY(vec_bf16, (var::launch_vec<elem::bf16>(img1, img2, flow, out, B, H, W, device, stream)))
RGBV_ENTRY(staged_f32, (var::launch_staged<float, 2, 4>(img1, img2, flow, out, n_direct, B, H, W, device, stream)))
RGBV_ENTRY(staged_bf16,
           (var::launch_staged<elem::bf16, 2, 4>(img1, img2, flow, out, n_direct, B, H, W, device, stream)))
RGBV_ENTRY(pipe_f32, (var::launch_pipe<float, 1, 4>(img1, img2, flow, out, B, H, W, device, stream)))
RGBV_ENTRY(pipe_bf16, (var::launch_pipe<elem::bf16, 1, 4>(img1, img2, flow, out, B, H, W, device, stream)))
RGBV_ENTRY(pref1_f32, (var::launch_pref<float, 1, 0>(img1, img2, flow, out, B, H, W, device, stream)))
RGBV_ENTRY(pref1_bf16, (var::launch_pref<elem::bf16, 1, 0>(img1, img2, flow, out, B, H, W, device, stream)))
RGBV_ENTRY(pref2_f32, (var::launch_pref<float, 2, 0>(img1, img2, flow, out, B, H, W, device, stream)))
RGBV_ENTRY(pref2_bf16, (var::launch_pref<elem::bf16, 2, 0>(img1, img2, flow, out, B, H, W, device, stream)))
RGBV_ENTRY(pref4_f32, (var::launch_pref<float, 4, 1>(img1, img2, flow, out, B, H, W, device, stream)))
RGBV_ENTRY(pref4_bf16, (var::launch_pref<elem::bf16, 4, 1>(img1, img2, flow, out, B, H, W, device, stream)))
