// Tensor-core building blocks for the port's kernels (sm_90a): `mma.sync`
// m16n8k16 on bf16 and m16n8k8 on TF32, both with f32 accumulation,
// `ldmatrix` from shared memory, and 16-byte `cp.async` copies from device to
// shared memory.
//
// Fragment layout of mma.m16n8k16 (lane = 4 g + t, g = lane / 4, t = lane % 4):
//   A (16 x 16, row-major), 4 registers of two bf16: a0 (g, 2t..2t+1),
//     a1 (g + 8, 2t..), a2 (g, 2t + 8..), a3 (g + 8, 2t + 8..);
//   B (16 x 8, k x n, "col"), 2 registers: b0 (k 2t..2t+1, n g), b1 (k 2t + 8.., n g);
//   C (16 x 8 f32): c0, c1 (g, 2t..2t+1), c2, c3 (g + 8, 2t..2t+1).
// So the C fragments of two neighbouring n-tiles, rounded to bf16 and packed
// in pairs, are the A fragment of one 16-wide k-slice: a score tile never has
// to leave the registers to become the left operand of the next product.
//
// Fragment layout of mma.m16n8k8 on TF32 (one 32-bit value a register):
//   A (16 x 8, row-major): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4);
//   B (8 x 8, k x n, "col"): b0 (k t, n g), b1 (k t + 4, n g);
//   C (16 x 8 f32): as above.
// TF32 keeps 10 bits of mantissa: a bf16 value is exact in it, an f32 value
// is rounded (to_tf32) before it enters the product.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace tc {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory; bytes past `src_bytes` (0 or 16)
// are zero-filled, so a row past the sequence end reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// 4 bytes (one f32), zero-filled when `src_bytes` is 0.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N committed groups of this thread are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8 x 8 bf16 matrices; lanes 8i..8i+7 give the row addresses of matrix i,
// and register i of lane l holds its row l / 4, columns 2 (l % 4) and + 1.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// The same, each matrix transposed: register i of lane l holds row 2 (l % 4)
// and + 1, column l / 4.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a b for one m16n8k16 tile, bf16 operands, f32 accumulation.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b for one m16n8k8 tile, TF32 operands (as 32-bit patterns), f32
// accumulation.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An f32 value rounded to TF32, to nearest with ties away from zero, as the
// 32-bit pattern an mma_tf32 operand takes.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(y) : "f"(x));
  return y;
}

// The same rounding of a finite x, as an mma_tf32 operand, in one integer add:
// half a TF32 unit in the last place is added to the magnitude, and the
// tensor core ignores the 13 low bits that remain (cvt.rna takes three
// instructions on sm_90a).  Not for a value that is read back as f32.
__device__ __forceinline__ uint32_t tf32_operand(float x) { return __float_as_uint(x) + 0x1000u; }

// 2^x on the special-function unit, subnormal results flushed to zero (a
// probability below 2^-126 adds nothing that an f32 sum of them keeps).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two f32 rounded to nearest bf16 and packed, `lo` in the low half (the
// lower column of an mma fragment).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A fragment of k-slice j from the f32 C fragments of n-tiles 2j and 2j + 1.
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// Copies rows [r0, r0 + ROWS) of a (rows, D) bf16 matrix in device memory to
// shared memory with row stride D + 8 elements, 16 bytes per cp.async, rows
// at or past `rows` zero-filled.  All THREADS threads of the block take part.
template <int D, int ROWS, int THREADS>
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                                int r0, int rows) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  constexpr int kTotal = ROWS * kChunks;
#pragma unroll
  for (int it = 0; it < (kTotal + THREADS - 1) / THREADS; ++it) {
    const int i = it * THREADS + static_cast<int>(threadIdx.x);
    if (kTotal % THREADS != 0 && i >= kTotal) break;
    const int r = i / kChunks;
    const int c = i - r * kChunks;
    const bool in = r0 + r < rows;
    // a row past the end points at row 0, which exists, and reads no byte of it
    const __nv_bfloat16* g = src + (in ? static_cast<int64_t>(r0 + r) * D : 0) + c * 8;
    cp_async16(dst + r * (D + 8) + c * 8, g, in ? 16 : 0);
  }
}

}  // namespace tc
