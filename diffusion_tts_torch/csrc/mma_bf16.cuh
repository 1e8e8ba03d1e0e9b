// Building blocks of the bf16 tensor-core kernels for Hopper (sm_90a) on the
// warp-level mma.sync path: 16-byte cp.async copies into shared memory,
// ldmatrix fragment loads and the m16n8k16 product with fp32 accumulators.
// Used by csrc/qkv_attention.cu, csrc/attention_bwd.cu, csrc/geglu_ff.cu and
// csrc/conv3x3.cu.
//
// Fragment layouts of mma.sync.m16n8k16.row.col (lane = 4 g + t):
//   A (16 x 16, row-major): a0 = A[g][2t..2t+1], a1 = A[g+8][2t..], a2 = A[g][2t+8..],
//                           a3 = A[g+8][2t+8..];
//   B (16 x 8, "col": stored as [n][k]): b0 = B[2t..2t+1][g], b1 = B[2t+8..][g];
//   C (16 x 8, fp32):       c0, c1 = C[g][2t..2t+1], c2, c3 = C[g+8][2t..2t+1].
// So an fp32 accumulator pair (c0, c1) rounded to bf16 is an A register of
// the next product: attention's P never leaves the registers.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace dtts {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronously. With valid false
// nothing is read (gmem must still be a mapped address) and the 16 bytes are
// zeroed: ragged tiles are padded with zeros by the copy itself.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid = true) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(smem)),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Commit what was issued and wait for every copy of this thread.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d[0..3] += A . B for one m16n8k16 tile: bf16 operands, fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float* d, uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  mma_bf16(d, a[0], a[1], a[2], a[3], b0, b1);
}

// The A fragment of rows r0..r0+15 and columns c0..c0+15 of a row-major bf16
// tile in shared memory with a row pitch of `pitch` elements.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* tile, int pitch,
                                       int r0, int c0, int lane) {
  const int r = r0 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int c = c0 + (lane >> 4) * 8;
  ldmatrix_x4(a, tile + r * pitch + c);
}

// B fragments of two neighbouring n-blocks (rows n0..n0+7 and n0+8..n0+15)
// at depth c0..c0+15 of a [n][k] tile: b[0], b[1] for the first, b[2], b[3]
// for the second.
__device__ __forceinline__ void load_b2(uint32_t (&b)[4], const __nv_bfloat16* tile, int pitch,
                                        int n0, int c0, int lane) {
  const int n = n0 + (lane & 7) + (lane >> 4) * 8;
  const int c = c0 + ((lane >> 3) & 1) * 8;
  ldmatrix_x4(b, tile + n * pitch + c);
}

// The same from a [k][n] tile (transposed on the fly): depth rows k0..k0+15,
// n-blocks n0..n0+7 and n0+8..n0+15.
__device__ __forceinline__ void load_b2_trans(uint32_t (&b)[4], const __nv_bfloat16* tile,
                                              int pitch, int k0, int n0, int lane) {
  const int k = k0 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int n = n0 + (lane >> 4) * 8;
  ldmatrix_x4_trans(b, tile + k * pitch + n);
}

// Two fp32 values as one bf16 pair, lo in the low half (the lower index).
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

}  // namespace dtts
