// Tensor-core building blocks shared by the bf16 flash-attention bodies
// (K2 in flash_attention.cu, K5 in flash_attention_bwd.cu).
//
// * 16-byte cp.async (4-byte for row vectors) with zero fill, so rows past
//   L arrive as zeros and need no padding in device memory;
// * ldmatrix.x4 (plain and .trans) to fill mma fragments from shared
//   memory;
// * mma.sync m16n8k16, bf16 operands, f32 accumulation.
//
// Fragment layouts of m16n8k16 (lane = 4 * g + t, g = lane / 4, t = lane % 4):
//   A 16x16 (4 regs): {row g, cols 2t..2t+1}, {row g+8, cols 2t..},
//                     {row g, cols 2t+8..}, {row g+8, cols 2t+8..};
//   B 16x8  (2 regs): {rows 2t..2t+1, col g}, {rows 2t+8.., col g};
//   C 16x8  (4 f32):  {row g, cols 2t, 2t+1}, {row g+8, cols 2t, 2t+1}.
// Two C tiles side by side are one A fragment once converted to bf16,
// which is how p and ds go from the score accumulators into the second
// product of each pair without passing through shared memory (K2) or
// through it in the A layout (K5).
//
// Shared-memory tiles hold rows of W bf16 (W = 64 or 128) in 16-byte
// chunks, chunk c of row r stored at chunk c ^ (r & 7): the 8 rows an
// ldmatrix phase reads then fall in 8 different bank groups.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace fgt_mma {

using bf16 = __nv_bfloat16;

// element offset of (row, 16-byte chunk) in a swizzled [rows][W] tile
template <int W>
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * W + ((chunk ^ (row & 7)) << 3);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; !valid writes 16 zero bytes instead
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

// 4 bytes global -> shared; !valid writes zero
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// rows [r0, r0 + ROWS) of a [len, 128] bf16 matrix into a swizzled
// [ROWS][128] tile, one 16-byte cp.async per chunk; rows past len are zero
template <int ROWS, int THREADS>
__device__ __forceinline__ void load_rows_async(const bf16* __restrict__ src,
                                                int r0, int len, bf16* dst) {
#pragma unroll
  for (int i = 0; i < ROWS * 16 / THREADS; ++i) {
    const int idx = threadIdx.x + i * THREADS;
    const int r = idx >> 4;
    const int c = idx & 15;
    const bool ok = r0 + r < len;
    const bf16* s = ok ? src + static_cast<size_t>(r0 + r) * 128 + c * 8 : src;
    cp_async16(dst + swz<128>(r, c), s, ok);
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a . b on the tensor cores (m16n8k16, bf16 in, f32 accumulate)
__device__ __forceinline__ void mma_bf16(float d[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 rounded to bf16 in one register, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A fragment (rows = 16-row slab, cols = 16) from two adjacent C tiles
__device__ __forceinline__ void c_to_a(uint32_t a[4], const float lo[4],
                                       const float hi[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// The row and 16-byte chunk, relative to a 16x16 block's top-left, whose
// address a lane hands to ldmatrix.x4 to read the block as:
// ... one A fragment from a row-major [m][k] tile;
__device__ __forceinline__ int a_row(int lane) { return lane & 15; }
__device__ __forceinline__ int a_chunk(int lane) { return lane >> 4; }
// ... the B fragments of two n-tiles from an [n][k] tile (non-transposed):
// regs {b0, b1} of n-tile 0, then {b0, b1} of n-tile 1;
__device__ __forceinline__ int bn_row(int lane) {
  return (lane & 7) + ((lane >> 4) << 3);
}
__device__ __forceinline__ int bn_chunk(int lane) { return (lane >> 3) & 1; }
// ... the B fragments of two n-tiles from a [k][n] tile (.trans), in the
// same register order.
__device__ __forceinline__ int bt_row(int lane) {
  return (lane & 7) + (((lane >> 3) & 1) << 3);
}
__device__ __forceinline__ int bt_chunk(int lane) { return lane >> 4; }

}  // namespace fgt_mma
