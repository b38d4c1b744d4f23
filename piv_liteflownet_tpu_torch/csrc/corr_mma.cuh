// What the bf16 cost-volume kernels (csrc/corr49_bf16.cu, forward, and
// csrc/corr49_bwd_bf16.cu, backward) share: TMA loads of NCHW boxes, the
// tensor-core product and its operand loads, and the schedule of a persistent
// grid.
//
// Both are banded products on mma.sync.m16n8k16 with bf16 operands and f32
// sums: bf16 products are exact in f32, so this is the function the f32
// forms compute on the same values, up to the order of the sums (and the
// tensor cores' truncation of each mma's sum, at most an f32 ulp toward zero
// per mma into an accumulator).
//
// Fragments of m16n8k16 (PTX ISA, "Matrix Fragments for mma.m16n8k16"), for
// lane = 4g + t (g = lane / 4, t = lane % 4):
//   A (16 x 16, row major), 4 registers of two bf16 each:
//     a0 = A[g][2t, 2t+1], a1 = A[g+8][2t, 2t+1], a2 = A[g][2t+8, 2t+9], a3 = A[g+8][2t+8, 2t+9]
//   B (16 x 8), 2 registers: b0 = B[2t, 2t+1][g], b1 = B[2t+8, 2t+9][g]
//   C, D (16 x 8, f32): c0, c1 = C[g][2t, 2t+1], c2, c3 = C[g+8][2t, 2t+1]
// (the lower half of a register holds the first of its two values). ldmatrix
// .x4 reads four 8x8 matrices of 16-byte rows, lanes 8i .. 8i+7 giving the
// row addresses of matrix i; lane l receives row l/4, columns 2(l%4), 2(l%4)+1
// of each, or, with .trans, column l/4 at rows 2(l%4), 2(l%4)+1. So a tile
// staged channel-major (rows of 8 pixels, one row per channel) gives, without
// .trans, an operand indexed [channel][pixel] (A with M = channels, or B
// with N = channels), and with .trans one indexed [pixel][channel].

#pragma once

#include <cstdint>

#include <cuda.h>
#include <cuda_runtime.h>

#include "corr_tiles.cuh"

namespace corr_mma {

using corr_tiles::smem_addr;

// ---- TMA: boxes of an NCHW tensor into shared memory, completed on an mbarrier ----

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}

// Makes the barriers' initialisation visible to the async proxy (TMA); then a __syncthreads.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// The issuing thread's arrival, expecting `bytes` of TMA loads to complete the phase.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}

// Returns once the phase of parity `parity` of the barrier has completed. After 2^31 failed tries
// (far beyond any wait of a right program) the kernel traps, and the launch fails with an error
// rather than hang the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .u32 n;\nmov.u32 n, 0;\n"
      "WAIT:\nmbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n@p bra DONE;\n"
      "add.u32 n, n, 1;\nsetp.gt.u32 p, n, 2147483647;\n@p trap;\nbra WAIT;\nDONE:\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// The box of `map` at element coordinates (x, y, p, b) (innermost first; out of the tensor reads
// zero) into shared memory at dst (128-byte aligned), completing on bar. x must be a whole number
// of 16 bytes from the row's start: a box from 8 bytes off is an illegal instruction on an H100.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int x, int y, int p, int b,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, "
      "%5}], [%6];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(p), "r"(b), "r"(smem_addr(bar))
      : "memory");
}

// libcuda's cuTensorMapEncodeTiled, found through the runtime's entry-point query (the library
// links no libcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

__host__ inline EncodeTiled encode_tiled() {
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

// The tensor map of a bf16 tensor [B, P, H, W] (P planes: channels or displacements) as (W, H, P, B),
// a box bw x bh x bp of one image, zero-filled out of bounds. Needs W % 8 == 0 and a 16-byte
// aligned base (the vector path's rule).
__host__ inline cudaError_t encode_nchw(CUtensorMap* map, const void* base, int B, int P, int H, int W, int bw,
                                        int bh, int bp) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)P, (cuuint64_t)B};
  const cuuint64_t row = 2ull * (cuuint64_t)W;
  const cuuint64_t strides[3] = {row, row * H, row * H * P};
  const cuuint32_t box[4] = {(cuuint32_t)bw, (cuuint32_t)bh, (cuuint32_t)bp, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult rc = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box,
                             unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// ---- the tensor cores ----

// Four 8x8 bf16 matrices; lanes 8i .. 8i+7 give the 16-byte-aligned rows of matrix i.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
}

// The same, each matrix transposed.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
}

// d += a * b on an m16n8k16 tile, bf16 operands and f32 sums.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A persistent grid: one block per SM walks tiles blockIdx.x, blockIdx.x + gridDim.x, ... and
// each tile is a fixed number of jobs (stages of the ring), so that the next tile's first stages
// are in flight while the current tile's last ones are summed. The warps of a block run free of
// each other: a warp waits for a job's boxes on the stage's mbarrier, and the last warp done with
// a stage (release) issues the job that takes it next.
__device__ __forceinline__ int tiles_of_block(int n_tiles) {
  return n_tiles > (int)blockIdx.x ? (n_tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
}

// Blocks of a persistent launch into *blocks: one per SM of the current device, no more than the
// tiles.
__host__ inline cudaError_t persistent_blocks(int n_tiles, int* blocks) {
  static int sms[64] = {};
  int dev = 0, n = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && sms[dev] > 0) {
    n = sms[dev];
  } else {
    err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    if (dev < 64) sms[dev] = n;
  }
  *blocks = n_tiles < n ? n_tiles : n;
  return cudaSuccess;
}

// Named barrier `id` (1 .. 15; 0 is __syncthreads') of `threads` threads, whole warps.
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// This warp is done reading a stage: lane 0 counts it in *done, and returns true in the lane of
// the warp that completes the count of `warps` (the count is then back at 0): that lane issues the
// stage's next job. The warp's reads of the stage have returned before its count (their values feed
// instructions that precede it), so the next job's TMA writes land after them.
__device__ __forceinline__ bool release(int* done, int warps) {
  __syncwarp();
  if ((threadIdx.x & 31) != 0) return false;
  int old;
  asm volatile("atom.shared.add.u32 %0, [%1], 1;\n" : "=r"(old) : "r"(smem_addr(done)) : "memory");
  if (old != warps - 1) return false;
  atomicAdd(done, -warps);
  return true;
}

}  // namespace corr_mma
