// Tensor-core and copy primitives for the port's bf16 kernels (inline PTX,
// sm_80 and later; built for sm_90a): cp.async global -> shared copies,
// ldmatrix fragment loads, mma.sync m16n8k16 with fp32 accumulators, bf16
// packing, and the host-side 16-byte alignment test that picks between
// those and masked scalar accesses. Included by the grouped-LoRA kernels
// (grouped_lora/csrc/ranklocal_common.cuh) and the flash-attention kernel
// (flash_attention/csrc/flash_attention.cu); the functions are inline, so
// every translation unit keeps its own copy.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

// host side: may a pointer take cp.async and 16-byte vector accesses?
inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1, with only the first nbytes
// (0-16) read and the rest filled with zeros (src must still be a valid
// address)
__device__ __forceinline__ void cp_async16n(void* dst, const void* src,
                                            int nbytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(nbytes));
}
// all 16 bytes, or (!ok) zeros and nothing read
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  cp_async16n(dst, src, ok ? 16 : 0);
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four 8x8 b16 matrices; lane l gives the row address of matrix l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&d)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&d)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(smem_addr(p)));
}
// two 8x8 b16 matrices; lanes 0-15 give the row addresses
__device__ __forceinline__ void ldsm_x2(uint32_t (&d)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(d[0]), "=r"(d[1])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&d)[2], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(d[0]), "=r"(d[1])
      : "r"(smem_addr(p)));
}

// d (16 x 8 fp32) += a (16 x 16 bf16, row) * b (16 x 8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (lo, hi) rounded to bf16 (round to nearest even, as __float2bfloat16_rn),
// lo in the low half: one register of an MMA fragment
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
