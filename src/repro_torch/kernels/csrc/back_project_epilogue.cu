// Fused back-projection epilogue  out = scale * back_project(P, S) + decay * W
// (W may be null: out = scale * back_project(P, S)).
//
// Replaces the Pallas kernels _epilogue_kernel and _epilogue_w_kernel
// (src/repro/kernels/fused_step.py:35 and :42, back_project_epilogue_batched:53)
// — the write-back of a galore-family step with fused_epilogue=True, where
// scale carries -lr (times GaLore's alpha) and decay -lr * wd.  The TPU
// version reads the two scalars from a (1, 2) SMEM operand because they are
// traced; here the step count is a Python int and the learning rate a Python
// float, so both are passed by value.
//
// It shares back_project.cu's GEMM tile (gemm.cuh); the epilogue is the
// core's own  alpha * acc + beta * D  store with alpha = scale, beta = decay,
// D = W, so the product never round-trips device memory before the affine.
// Both sides are taken natively through the operand-layout flags, in W's own
// (m, n) layout:
//   left   P (m, r), S (r, n):  out(i, j) = sum_k P(i, k) S(k, j)
//   right  P (n, r), S (m, r):  out(i, j) = sum_k S(i, k) P(j, k)
// so the right side (mlp/w_out) needs no transpose of S, W or out.
//
// Bound: at llama-130m's mlp family, P (24, 768, 256), S (24, 256, 2048) and
// W (24, 768, 2048) give 19.3 GFLOP on 371 MB, 52 flops per byte: above the
// fp32 SIMT ridge (20 flops per byte), so fp32 FMA issue bounds it (see
// gemm.cuh).
#include "gemm.cuh"

__global__ void __launch_bounds__(repro_torch::THREADS)
    back_project_epilogue_kernel(repro_torch::GemmArgs p) {
  repro_torch::gemm_tile<true, true>(p);
}

__global__ void __launch_bounds__(repro_torch::THREADS)
    back_project_epilogue_kernel_right(repro_torch::GemmArgs p) {
  repro_torch::gemm_tile<true, false>(p);
}

// left:  p (L, m, r), s (L, r, n);  right (right != 0):  p (L, n, r),
// s (L, m, r);  w (L, m, n) or null, out (L, m, n).  All contiguous fp32 on
// the device.
extern "C" int back_project_epilogue(const float* p, const float* s, const float* w,
                                     float* out, int L, int m, int r, int n,
                                     int right, float scale, float decay,
                                     void* stream) {
  repro_torch::GemmArgs a{};
  if (right) {
    a.a = s;  // A(i, k) = S[i, k]
    a.lda = r;
    a.a_batch = static_cast<long long>(m) * r;
    a.b = p;  // B(k, j) = P[j, k]: k (the rank axis) is contiguous
    a.ldb = r;
    a.b_batch = static_cast<long long>(n) * r;
  } else {
    a.a = p;  // A(i, k) = P[i, k]
    a.lda = r;
    a.a_batch = static_cast<long long>(m) * r;
    a.b = s;  // B(k, j) = S[k, j]
    a.ldb = n;
    a.b_batch = static_cast<long long>(r) * n;
  }
  a.d = w;
  a.c = out;
  a.ldc = n;
  a.c_batch = static_cast<long long>(m) * n;
  a.M = m;
  a.N = n;
  a.K = r;
  a.alpha = scale;
  a.beta = decay;
  return repro_torch::launch_gemm(
      right ? back_project_epilogue_kernel_right : back_project_epilogue_kernel, a, L,
      stream);
}
