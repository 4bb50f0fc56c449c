// sm90_mma.cuh — device helpers shared by the Hopper (sm_90a) kernels of
// this package: 16-byte cp.async copies, ldmatrix fragment loads from
// XOR-swizzled tiles, mma.sync.m16n8k16 bf16 products with fp32
// accumulators, and the exact three-term bf16 split of an fp32 operand.
//
// Fragment layouts of mma.m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16x16, row): regs {a[g][2t..], a[g+8][2t..], a[g][2t+8..], a[g+8][2t+8..]}
//   B (16x8, col):  regs {b[2t..][g], b[2t+8..][g]}
//   C (16x8):       {c[g][2t], c[g][2t+1], c[g+8][2t], c[g+8][2t+1]}

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }
__host__ __device__ constexpr int cmin(int a, int b) { return a < b ? a : b; }
__host__ __device__ constexpr size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

// the four lanes of a quad hold one fragment row
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(kFull, v, 1));
  return fmaxf(v, __shfl_xor_sync(kFull, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(kFull, v, 1);
  return v + __shfl_xor_sync(kFull, v, 2);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; full = false writes zeros (src is not read)
__device__ __forceinline__ void cp16(void* dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// ldmatrix x4 (and .trans) from a shared-space address, or a generic pointer
__device__ __forceinline__ void ldsm4(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void ldsm4t(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void ldsm4(uint32_t* r, const void* p) { ldsm4(r, smem_addr(p)); }
__device__ __forceinline__ void ldsm4t(uint32_t* r, const void* p) { ldsm4t(r, smem_addr(p)); }

// c += a · b on tensor cores: m16n8k16, bf16 in, fp32 accumulate
__device__ __forceinline__ void mma(float* c, const uint32_t* a, uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// (a, b) as three bf16x2 terms, largest first: a == a0 + a1 + a2 exactly
// for normal fp32 (each residual is exact in fp32 and fits 8 more bits)
__device__ __forceinline__ void split3(float a, float b, uint32_t* o) {
  const __nv_bfloat16 a0 = __float2bfloat16_rn(a), b0 = __float2bfloat16_rn(b);
  const float ra = a - __bfloat162float(a0), rb = b - __bfloat162float(b0);
  const __nv_bfloat16 a1 = __float2bfloat16_rn(ra), b1 = __float2bfloat16_rn(rb);
  o[0] = pack(a0, b0);
  o[1] = pack(a1, b1);
  o[2] = pack(__float2bfloat16_rn(ra - __bfloat162float(a1)),
              __float2bfloat16_rn(rb - __bfloat162float(b1)));
}

// 16-byte chunk ch of row `row` lies at chunk ch ^ (row % 8) (within the
// row's first min(chunks, 8) chunks)
template <int CPR>
__device__ __forceinline__ int swz(int row, int ch) {
  return ch ^ (row & (cmin(CPR, 8) - 1));
}

}  // namespace
