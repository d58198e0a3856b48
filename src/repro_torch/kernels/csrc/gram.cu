// Gram matrix  out = X X^T  (first half of a Newton-Schulz step).
//
// Replaces the Pallas kernel _gram_kernel
// (src/repro/kernels/newton_schulz.py:34, gram:50).  The TPU version keeps
// the whole (s, s) sum in VMEM and walks n as its sequential grid axis, which
// capped s at 1024; here the (s, s) output is tiled over blocks and each
// block loops over n, so s = 768 (llama-130m's full slots) and s = 1024
// (llama-350m) both work.  Both halves of the symmetric result are computed.
//
// Bound: at llama-130m, X (12, 256, 2048) gives 3.2 GFLOP on 28 MB and X
// (4, 768, 2048) 9.7 GFLOP on 35 MB: fp32 FMA issue (see gemm.cuh).  The
// (12, 256, n) case runs only 48 blocks on 132 SMs; split-K would fill the
// card and is left for a later change.
#include "gemm.cuh"

__global__ void __launch_bounds__(repro_torch::THREADS)
    gram_kernel(repro_torch::GemmArgs p) {
  repro_torch::gemm_tile<true, false>(p);
}

// x (L, s, n), out (L, s, s); contiguous fp32 on the device.
extern "C" int gram(const float* x, float* out, int L, int s, int n, void* stream) {
  repro_torch::GemmArgs a{};
  a.a = x;  // A(i, k) = X[i, k]
  a.lda = n;
  a.a_batch = static_cast<long long>(s) * n;
  a.b = x;  // B(k, j) = X[j, k]: k is contiguous
  a.ldb = n;
  a.b_batch = static_cast<long long>(s) * n;
  a.d = nullptr;
  a.c = out;
  a.ldc = s;
  a.c_batch = static_cast<long long>(s) * s;
  a.M = s;
  a.N = s;
  a.K = n;
  a.alpha = 1.f;
  a.beta = 0.f;
  return repro_torch::launch_gemm(gram_kernel, a, L, stream);
}
