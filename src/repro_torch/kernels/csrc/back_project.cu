// Back-projection GEMM  out = P @ S.
//
// Replaces the Pallas kernel _back_project_kernel
// (src/repro/kernels/lowrank_update.py:105, back_project_batched:116).  The
// TPU version holds the whole rank axis in one tile and does one MXU product
// per output tile; here the block loops over r in 16-deep slices, so any rank
// works.
//
// Bound: at llama-130m, P (12, 768, 256) and S (12, 256, 2048) give 9.7
// GFLOP on 110 MB, 88 flops per byte: fp32 FMA issue (see gemm.cuh).
#include "gemm.cuh"

__global__ void __launch_bounds__(repro_torch::THREADS)
    back_project_kernel(repro_torch::GemmArgs p) {
  repro_torch::gemm_tile<true, true>(p);
}

// p (L, m, r), s (L, r, n), out (L, m, n); all contiguous fp32 on the device.
extern "C" int back_project(const float* p, const float* s, float* out, int L,
                            int m, int r, int n, void* stream) {
  repro_torch::GemmArgs a{};
  a.a = p;  // A(i, k) = P[i, k]
  a.lda = r;
  a.a_batch = static_cast<long long>(m) * r;
  a.b = s;  // B(k, j) = S[k, j]
  a.ldb = n;
  a.b_batch = static_cast<long long>(r) * n;
  a.d = nullptr;
  a.c = out;
  a.ldc = n;
  a.c_batch = static_cast<long long>(m) * n;
  a.M = m;
  a.N = n;
  a.K = r;
  a.alpha = 1.f;
  a.beta = 0.f;
  return repro_torch::launch_gemm(back_project_kernel, a, L, stream);
}
