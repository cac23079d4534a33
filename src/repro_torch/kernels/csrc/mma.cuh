// Warp-level bf16 tensor-core helpers for sm_90a (raw PTX), shared by the
// FlashMoBA forward and backward kernels.
//
// Fragment layouts of mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32,
// with g = lane / 4 and t = lane % 4:
//   A (16 x 16, row-major), 4 regs of bf16x2:
//     a0 (row g,   cols 2t, 2t+1)    a1 (row g+8, cols 2t, 2t+1)
//     a2 (row g,   cols 2t+8, +9)    a3 (row g+8, cols 2t+8, +9)
//   B (16 x 8, "col": B[k][n] with k contiguous per n), 2 regs:
//     b0 (rows k 2t, 2t+1; col n g)  b1 (rows k 2t+8, +9; col n g)
//   C (16 x 8 fp32), 4 floats:
//     c0, c1 (row g, cols 2t, 2t+1)  c2, c3 (row g+8, cols 2t, 2t+1)
// So two n8 accumulator tiles that cover k16 consecutive columns are, once
// rounded to bf16, the A fragment of a product over those columns (FA2's
// register reuse): {pack(c[0]), pack(c[2]), pack(c'[0]), pack(c'[2])}.
//
// ldmatrix.x4 loads four 8x8 b16 matrices; lane l gives the row address of
// matrix l / 8, row l % 8, and receives in register i the elements
// (row g, cols 2t, 2t+1) of matrix i (.trans: (rows 2t, 2t+1; col g)).
// The address helpers below say which matrix goes where for each use.
// Shared-memory rows are padded by 8 bf16 (16 bytes), so the eight row
// addresses of one matrix fall in distinct 16-byte bank groups.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace mma {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy; `full` false zero-fills the destination and
// reads nothing (src must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full = true) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(full ? 16 : 0));
}

// 4-byte asynchronous copy, zero-filling when `full` is false.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool full = true) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(full ? 4 : 0));
}

// Copy `rows` rows of width D (row stride D) into shared memory rows of
// stride D + 8 with the THREADS threads of the CTA; rows in [rows,
// pad_rows) are zero-filled.
template <int D, int THREADS>
__device__ __forceinline__ void copy_rows(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int rows,
                                          int pad_rows) {
  constexpr int kChunks = D / 8;             // 16-byte chunks a row
  for (int e = threadIdx.x; e < pad_rows * kChunks; e += THREADS) {
    const int r = e / kChunks;
    const int c = (e - r * kChunks) * 8;
    const bool in = r < rows;
    cp_async16(dst + r * (D + 8) + c,
               src + static_cast<size_t>(in ? r : 0) * D + c, in);
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(const void* p, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(const void* p, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a · [b0 b1]
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two fp32 values as bf16x2 (lo in the low half: the lower column).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A fragment of the k16 step over accumulator tiles c0 (columns
// 0..7) and c1 (columns 8..15), rounded to bf16.
__device__ __forceinline__ void acc_to_a(const float (&c0)[4],
                                         const float (&c1)[4],
                                         uint32_t (&a)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// The same A fragment split in two: hi = bf16(c), lo = bf16(c - hi), so
// hi + lo carries c to ~16 bits and a product over both is as exact as
// one in fp32 for a bf16 B.
__device__ __forceinline__ void acc_to_a_split(const float (&c0)[4],
                                               const float (&c1)[4],
                                               uint32_t (&hi)[4],
                                               uint32_t (&lo)[4]) {
  const float* c[2] = {c0, c1};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float x = c[i >> 1][2 * (i & 1)];
    const float y = c[i >> 1][2 * (i & 1) + 1];
    const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
    hi[i] = *reinterpret_cast<const uint32_t*>(&h);
    lo[i] = pack_bf16(x - __low2float(h), y - __high2float(h));
  }
}

// Row addresses (element offsets) for the four uses of ldmatrix.x4, in a
// row-major tile of row stride `ld` elements:
// A (16 x 16) at (r0, c0), non-transposed: matrices (r0, c0), (r0+8, c0),
// (r0, c0+8), (r0+8, c0+8).
__device__ __forceinline__ int a_offset(int lane, int r0, int c0, int ld) {
  return (r0 + (lane & 15)) * ld + c0 + (lane >> 4) * 8;
}
// B of two n8 tiles from a tile stored [n][k] (k contiguous), n0 and k0:
// registers {0, 1} = (b0, b1) of tile n0, {2, 3} of tile n0 + 8.
__device__ __forceinline__ int bn_offset(int lane, int n0, int k0, int ld) {
  return (n0 + (lane & 7) + ((lane >> 4) << 3)) * ld + k0 +
         ((lane >> 3) & 1) * 8;
}
// B of two n8 tiles from a tile stored [k][n] (n contiguous), .trans:
// registers {0, 1} = (b0, b1) of tile n0, {2, 3} of tile n0 + 8.
__device__ __forceinline__ int bk_offset(int lane, int k0, int n0, int ld) {
  return (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + n0 +
         (lane >> 4) * 8;
}
// A (16 x 16) at rows m0, columns k0 from a tile stored [k][m] (m
// contiguous), .trans.
__device__ __forceinline__ int at_offset(int lane, int m0, int k0, int ld) {
  return (k0 + (lane & 7) + (lane >> 4) * 8) * ld + m0 +
         ((lane >> 3) & 1) * 8;
}

}  // namespace mma
