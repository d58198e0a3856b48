// Parts shared by the port's tensor-core kernels (flash_attention.cu and the
// GEMM core tf32x3_gemm.cuh): the 3xTF32 split of an fp32 operand, the TF32
// m16n8k8 mma.sync, the cp.async copies that fill their shared-memory
// rings, and the opt-in to more than 48 KB of dynamic shared memory.
//
// 3xTF32: x = hi + lo, each a TF32 value; a product a*b is formed as
// a_lo*b_hi + a_hi*b_lo + a_hi*b_hi (small terms first), a_lo*b_lo dropped,
// about 2^-21 relative per product (tests/test_torch_tf32x3.py emulates it).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {

// Every C entry point reports the template arguments of the kernel it
// launched through an out-argument of VARIANT_LEN ints, in the kernel's
// template order, bools as 0 / 1, unused slots -1 (a null pointer: nothing
// is reported).  kernels/build.py records them beside its launch counts.
constexpr int VARIANT_LEN = 8;

inline void report_variant(int* out, int a0, int a1 = -1, int a2 = -1, int a3 = -1,
                           int a4 = -1, int a5 = -1) {
  if (out == nullptr) return;
  const int vals[6] = {a0, a1, a2, a3, a4, a5};
  for (int i = 0; i < VARIANT_LEN; ++i) out[i] = i < 6 ? vals[i] : -1;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s), "l"(src),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x = hi + lo, each a TF32 value (fp32 with the low 13 mantissa bits 0):
// hi is x rounded to nearest, ties away from zero, as cvt.rna.tf32.f32
// rounds it, by adding half of the dropped unit to the bit pattern and
// clearing the low 13 bits (equal to cvt.rna for every finite x, and it
// keeps inf; a NaN x still gives a NaN lo).  Two integer instructions: on
// sm_90a cvt.rna.tf32.f32 compiles to these plus an inf/NaN test and a
// select.  lo = x - hi is exact in fp32 and rounded the same way.
__device__ __forceinline__ uint32_t round_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = round_tf32(x);
  lo = round_tf32(x - __uint_as_float(hi));
}

// D = A B + C for one m16n8k8 tile, TF32 operands, fp32 accumulation.
// Fragments (g = lane / 4, t = lane % 4): A a0 (g, t), a1 (g+8, t),
// a2 (g, t+4), a3 (g+8, t+4); B b0 (t, g), b1 (t+4, g); C and D c0 (g, 2t),
// c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1).
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a, const uint32_t* b,
                                         const float* c) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(c[0]),
        "f"(c[1]), "f"(c[2]), "f"(c[3]));
}

// acc = c + a b by 3xTF32 from the split operands, small terms first.
__device__ __forceinline__ void mma_3xtf32(float* acc, const uint32_t* ahi, const uint32_t* alo,
                                           const uint32_t* bhi, const uint32_t* blo,
                                           const float* c) {
  mma_tf32(acc, alo, bhi, c);
  mma_tf32(acc, ahi, blo, acc);
  mma_tf32(acc, ahi, bhi, acc);
}

// Lets KERNEL launch with `bytes` of dynamic shared memory (above 48 KB
// only after this opt-in), once a device: the attribute is per device.
template <auto KERNEL>
cudaError_t allow_smem(int bytes) {
  constexpr int MAX_DEVICES = 64;
  static bool raised[MAX_DEVICES] = {};
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < MAX_DEVICES && raised[dev])) return err;
  err = cudaFuncSetAttribute(KERNEL, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < MAX_DEVICES) raised[dev] = true;
  return err;
}

}  // namespace repro_torch
