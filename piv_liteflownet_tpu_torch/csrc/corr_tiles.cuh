// The tiling scheme shared by the cost-volume kernels, csrc/corr49.cu (forward)
// and csrc/corr49_bwd.cu (backward).
//
// Both are the same 7x7 stencil: an output pixel at (y, x) and displacement
// (dy, dx), both in [-3, 3], meets a map at (y+dy, x+dx). A block covers a
// tile of TX x TY output pixels and stages, per channel, the map's tile plus
// its 3-pixel halo in shared memory: rows y0-3 .. y0+TY+2 and columns
// x0-4 .. x0+TX+3, so that every staged row starts 16 bytes aligned (one
// column more than the halo on each side). A thread owns R = 4 adjacent
// output pixels x0+4k .. x0+4k+3 and one staged row: of one output row at
// one displacement row in the forward, of two output rows at adjacent
// displacement rows in the backward. For each channel it reads the 12 staged
// values at columns 4k .. 4k+11 of its staged row with three 16-byte loads;
// pixel i at displacement dx then reads value i+dx+4 (dx in [-3, 3]), so each
// loaded value serves up to 7 multiply-adds per output row.
//
// Channels are staged CC at a time in a ring of stages filled with cp.async,
// so the next groups land while the current one is summed. A 16-byte copy
// needs the map's rows 16 bytes aligned: W a multiple of 4 and the tensors 16
// bytes aligned. Otherwise the kernel takes its edge path, the same ring
// filled with 4-byte copies (and, in the forward, scalar stores). The path is
// one for the whole launch; the first block adds the launch's tile count to a
// device counter so the caller can see which path ran (one plain add by one
// thread per launch: no atomics).
//
// The forward has a bf16 form too (csrc/corr49.cu). A 16-byte chunk then holds 8
// values, so the vector path needs W a multiple of 8, and the staged columns
// start 8 to the left of the tile to keep each chunk aligned.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "elem.cuh"

namespace corr_tiles {

constexpr int MD = 3;
constexpr int ND = 2 * MD + 1;    // 7 displacements per axis
constexpr int NDISP = ND * ND;    // 49
constexpr int R = 4;              // output pixels per thread along x
constexpr int PAD_X = MD + 1;     // staged columns start at x0 - 4
constexpr int ROWV = R + 2 * PAD_X;  // 12 staged values a thread reads per row

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes from src to dst, or 16 zero bytes when !ok (src is then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(ok ? 16 : 0));
}

// 4 bytes from src to dst, or a zero when !ok.
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// Wait until at most N of this thread's committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// v[0..11] = row[0..11] as f32 with three shared-memory loads: 16-byte ones in f32 (row 16
// bytes aligned), 8-byte ones in bf16 (row 8 bytes aligned).
template <typename T>
__device__ __forceinline__ void load_row(const T* row, float (&v)[ROWV]) {
#pragma unroll
  for (int q = 0; q < ROWV / 4; ++q) elem::load4(row + 4 * q, v + 4 * q);
}

// Lets Kernel take `bytes` of dynamic shared memory on the current device (set once per
// kernel and device).
template <auto Kernel>
__host__ cudaError_t allow_smem(int bytes) {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && done[dev])) return err;
  err = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

// Whether a launch may take the 16-byte path: rows of W values a whole number of 16-byte chunks
// (per_chunk values each: 4 f32, 8 bf16) and every tensor 16 bytes aligned.
__host__ inline bool vector_path(int W, const void* a, const void* b, const void* c, int per_chunk = 4) {
  return W % per_chunk == 0 && (reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
                                reinterpret_cast<uintptr_t>(c)) % 16 == 0;
}

}  // namespace corr_tiles
