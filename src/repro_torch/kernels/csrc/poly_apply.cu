// Polynomial apply  out = a * X + A2 @ X  (second half of a Newton-Schulz
// step, A2 = b * G + c * G @ G).
//
// Replaces the Pallas kernel _poly_apply_kernel
// (src/repro/kernels/newton_schulz.py:71, poly_matmul_axpy:78).  The a * X
// term rides in the GEMM epilogue, so the product never round-trips device
// memory before the axpy.
//
// Bound: at llama-130m, A2 (4, 768, 768) and X (4, 768, 2048) give 9.7 GFLOP
// on 60 MB: fp32 FMA issue (see gemm.cuh).
#include "gemm.cuh"

__global__ void __launch_bounds__(repro_torch::THREADS)
    poly_apply_kernel(repro_torch::GemmArgs p) {
  repro_torch::gemm_tile<true, true>(p);
}

// a2 (L, s, s), x (L, s, n), out (L, s, n); contiguous fp32 on the device.
extern "C" int poly_apply(const float* a2, const float* x, float* out, int L, int s,
                          int n, float a, void* stream) {
  repro_torch::GemmArgs g{};
  g.a = a2;  // A(i, k) = A2[i, k]
  g.lda = s;
  g.a_batch = static_cast<long long>(s) * s;
  g.b = x;  // B(k, j) = X[k, j]
  g.ldb = n;
  g.b_batch = static_cast<long long>(s) * n;
  g.d = x;  // epilogue operand: a * X in the output layout
  g.c = out;
  g.ldc = n;
  g.c_batch = static_cast<long long>(s) * n;
  g.M = s;
  g.N = n;
  g.K = s;
  g.alpha = 1.f;
  g.beta = a;
  return repro_torch::launch_gemm(poly_apply_kernel, g, L, stream);
}
