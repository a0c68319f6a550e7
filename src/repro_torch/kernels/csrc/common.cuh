// Device helpers shared by the kernels: 16-byte asynchronous copies into
// shared memory (cp.async), the TF32 split of an f32 value, the warp-level
// tensor-core products (mma.sync) in TF32 and bf16, and the warpgroup
// products' (wgmma) fences and shared-memory descriptors.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f(float x, float* out) { *out = x; }
__device__ __forceinline__ void from_f(float x, __nv_bfloat16* out) { *out = __float2bfloat16_rn(x); }

// Copy 16 bytes from global to shared memory without passing through
// registers. With src_bytes = 0 nothing is read and the 16 bytes are zeroed.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}
// The same for 4 bytes (any 4-byte aligned address).
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, int src_bytes) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// Wait until at most N committed groups of this thread are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// x = big + small with both TF32, so big * big' + big * small' + small *
// big' keeps near f32 accuracy (small * small' is dropped). big is x
// rounded to nearest (ties away from zero) by two integer operations on the
// sign-and-magnitude bits, half an ulp added to the magnitude and the 13
// dropped bits cleared: cvt.rna.tf32.f32's rounding, bit for bit, at every
// finite x. small is x - big (exact) cut toward zero by one operation: what
// it drops is below 2^-21 of x and takes the sign of x - big, which is as
// often positive as negative. On the H100 the integer operations are the
// faster: with the conversion instruction the backward kernel's f32 path
// took 0.517 ms at qwen2-0.5b's training shape, with these 0.413; with a
// compare and select on each half that kept a NaN a NaN, 0.92
// (scripts/kernel_timing.py). A NaN x needs none: its big may come out as
// a zero or an infinity (the add carries its payload), but x - big is a
// quiet NaN, whose top payload bit small keeps, so each product with a NaN
// operand is a NaN.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  small = __float_as_uint(x - __uint_as_float(big)) & 0xFFFFE000u;
}

// c += a (16x8, row) * b (8x8, col), TF32 in, f32 accumulate.
// Fragments, with g = lane / 4 and t = lane % 4: a = {A[g][t], A[g+8][t],
// A[g][t+4], A[g+8][t+4]}, b = {B[t][g], B[t+4][g]}, c = {C[g][2t],
// C[g][2t+1], C[g+8][2t], C[g+8][2t+1]}.
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a, const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// The 3xTF32 product: c += a * b to f32 accuracy from split operands,
// small terms first.
__device__ __forceinline__ void mma_3xtf32(float* c, const uint32_t* a_big, const uint32_t* a_small,
                                           const uint32_t* b_big, const uint32_t* b_small) {
  mma_tf32(c, a_small, b_big);
  mma_tf32(c, a_big, b_small);
  mma_tf32(c, a_big, b_big);
}

// c += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate. Each b32
// holds two bf16, the lower index in the low half: a = {A[g][2t..2t+1],
// A[g+8][2t..], A[g][2t+8..], A[g+8][2t+8..]}, b = {B[2t..2t+1][g],
// B[2t+8..2t+9][g]}, c as for mma_tf32.
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
// Shared-memory writes of this thread become visible to the async proxy
// (TMA, wgmma).
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed wgmma groups of this warpgroup are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// wgmma descriptor of a K-major operand (its reduced dimension along
// 128-byte rows) in the 128-byte swizzle, the rows of PANELS side-by-side
// panels in 8-row groups PANELS x 1024 bytes apart (the leading offset is
// unused in this layout)
template <int PANELS>
__device__ __forceinline__ uint64_t desc_k(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(PANELS * 1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// Two floats as a bf16 pair, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

// Let `kernel` use `bytes` of dynamic shared memory on the current device,
// setting the attribute only when `allowed` (the caller's record, one entry
// a device) is below it: a decode step launches hundreds of kernels, and
// each host call costs time.
constexpr int MAX_DEVICES = 64;
inline cudaError_t allow_smem(const void* kernel, size_t bytes, size_t* allowed) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && allowed[dev] >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess && dev < MAX_DEVICES) allowed[dev] = bytes;
  return err;
}

}  // namespace repro
