// Batched fp32 SIMT GEMM core shared by two of the port's optimizer kernels
// (back_project.cu, back_project_epilogue.cu; lowrank_update.cu,
// poly_apply.cu and gram.cu run on the tensor cores, tf32x3_gemm.cuh).
//
//   C[l](i, j) = alpha * sum_k A[l](i, k) * B[l](k, j)  +  beta * D[l](i, j)
//
// A and B are read through one leading dimension each; the template flags say
// which of their two axes is contiguous in memory:
//   A_KC  true : A(i, k) = a[i * lda + k]     false : A(i, k) = a[k * lda + i]
//   B_NC  true : B(k, j) = b[k * ldb + j]     false : B(k, j) = b[j * ldb + k]
// C and the optional epilogue operand D share one row-major layout (ldc).
//
// Design: one 256-thread block owns a 128 x 128 output tile of one batch
// member (grid = (ceil(N/128), ceil(M/128), L)) and walks the whole K axis in
// 16-deep slices staged through shared memory, so no partial sum crosses a
// block and no atomics are needed.  Each thread keeps an 8 x 8 register tile
// (rows tr*4+{0..3} and 64+tr*4+{0..3}, the same split for columns) and reads
// its A and B fragments as float4s, which keeps the shared-memory reads free
// of bank conflicts.  Ragged M, N and K edges are masked in the loads (zeros)
// and in the stores.  Products accumulate with fmaf in full fp32: the kernels
// replace fp32 Pallas kernels and are held to fp32 parity, so no TF32.
//
// Bound on the H100: at the port's shapes every caller does 2*M*N*K flops on
// O(M*K + K*N + M*N) floats, i.e. 40-120 flops per byte, above the fp32 SIMT
// ridge (67 TFLOP/s / 3.35 TB/s = 20 flops per byte), so the kernels are
// bound by fp32 FMA issue.  The register tile gives 64 FMAs per 4 shared
// loads.  Tensor cores (the 3xTF32 core of tf32x3_gemm.cuh) are left for a
// later change.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 16;
constexpr int THREADS = 256;
constexpr int PAD = 4;  // keeps rows 16-byte aligned, spreads the tile stores

struct GemmArgs {
  const float* a;
  const float* b;
  const float* d;  // epilogue operand, may be null
  float* c;
  int M, N, K;
  int lda, ldb, ldc;
  long long a_batch, b_batch, c_batch;  // element strides between members
  float alpha, beta;
  int vec_out;  // 1 when C (and D) rows allow float4 access
};

// The body of every kernel: one block's output tile.  Each .cu file wraps it
// in a __global__ function of its own name, so traces tell them apart.
template <bool A_KC, bool B_NC>
__device__ __forceinline__ void gemm_tile(const GemmArgs& p) {
  __shared__ __align__(16) float As[BK][BM + PAD];
  __shared__ __align__(16) float Bs[BK][BN + PAD];

  const int tid = threadIdx.x;
  const int l = blockIdx.z;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const float* a = p.a + (size_t)l * p.a_batch;
  const float* b = p.b + (size_t)l * p.b_batch;
  const int tr = tid / 16;
  const int tc = tid % 16;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < p.K; k0 += BK) {
    // Stage A's (BM x BK) slice as As[k][i]; consecutive threads walk the
    // contiguous axis so the global loads coalesce.
#pragma unroll
    for (int t = 0; t < (BM * BK) / THREADS; ++t) {
      const int e = tid + t * THREADS;
      const int i = A_KC ? e / BK : e % BM;
      const int k = A_KC ? e % BK : e / BM;
      const int gi = m0 + i;
      const int gk = k0 + k;
      float v = 0.f;
      if (gi < p.M && gk < p.K)
        v = A_KC ? a[(size_t)gi * p.lda + gk] : a[(size_t)gk * p.lda + gi];
      As[k][i] = v;
    }
    // Stage B's (BK x BN) slice as Bs[k][j].
#pragma unroll
    for (int t = 0; t < (BN * BK) / THREADS; ++t) {
      const int e = tid + t * THREADS;
      const int j = B_NC ? e % BN : e / BK;
      const int k = B_NC ? e / BN : e % BK;
      const int gj = n0 + j;
      const int gk = k0 + k;
      float v = 0.f;
      if (gj < p.N && gk < p.K)
        v = B_NC ? b[(size_t)gk * p.ldb + gj] : b[(size_t)gj * p.ldb + gk];
      Bs[k][j] = v;
    }
    __syncthreads();

#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[k][tr * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[k][64 + tr * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[k][tc * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[k][64 + tc * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  // Epilogue: C = alpha * acc + beta * D, masked at the ragged edges.
  float* c = p.c + (size_t)l * p.c_batch;
  const float* d = p.d ? p.d + (size_t)l * p.c_batch : nullptr;
#pragma unroll
  for (int ii = 0; ii < 8; ++ii) {
    const int gi = m0 + (ii < 4 ? tr * 4 + ii : 64 + tr * 4 + (ii - 4));
    if (gi >= p.M) continue;
    float* crow = c + (size_t)gi * p.ldc;
    const float* drow = d ? d + (size_t)gi * p.ldc : nullptr;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gj = n0 + h * 64 + tc * 4;
      if (p.vec_out && gj + 3 < p.N) {
        float4 o;
        o.x = p.alpha * acc[ii][h * 4 + 0];
        o.y = p.alpha * acc[ii][h * 4 + 1];
        o.z = p.alpha * acc[ii][h * 4 + 2];
        o.w = p.alpha * acc[ii][h * 4 + 3];
        if (drow) {
          const float4 dv = *reinterpret_cast<const float4*>(drow + gj);
          o.x = fmaf(p.beta, dv.x, o.x);
          o.y = fmaf(p.beta, dv.y, o.y);
          o.z = fmaf(p.beta, dv.z, o.z);
          o.w = fmaf(p.beta, dv.w, o.w);
        }
        *reinterpret_cast<float4*>(crow + gj) = o;
      } else {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          if (gj + jj < p.N) {
            float o = p.alpha * acc[ii][h * 4 + jj];
            if (drow) o = fmaf(p.beta, drow[gj + jj], o);
            crow[gj + jj] = o;
          }
        }
      }
    }
  }
}

inline bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0;
}

// Launches `kernel` (a __global__ wrapper of gemm_tile) on `stream` and
// returns cudaGetLastError() (0 on success); a refused launch never runs, so
// the caller must check the code.
inline int launch_gemm(void (*kernel)(GemmArgs), GemmArgs p, int L, void* stream) {
  if (L <= 0 || p.M <= 0 || p.N <= 0 || p.K <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  p.vec_out = (p.ldc % 4 == 0) && (p.c_batch % 4 == 0) && aligned16(p.c) &&
              (p.d == nullptr || aligned16(p.d));
  const dim3 grid((p.N + BN - 1) / BN, (p.M + BM - 1) / BM, L);
  kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro_torch
