// Fused back-projection epilogue  out = scale * back_project(P, S) + decay * W
// (W may be null: out = scale * back_project(P, S)), fp32 accurate by 3xTF32
// on the tensor cores.
//
// Replaces the Pallas kernels _epilogue_kernel and _epilogue_w_kernel
// (src/repro/kernels/fused_step.py:35 and :42, back_project_epilogue_batched:53)
// — the write-back of a galore-family step with fused_epilogue=True, where
// scale carries -lr (times GaLore's alpha) and decay -lr * wd.  The TPU
// version reads the two scalars from a (1, 2) SMEM operand because they are
// traced; here the step count is a Python int and the learning rate a Python
// float, so both are passed by value.
//
// It is back_project.cu's product on the shared core of tf32x3_gemm.cuh,
// with the core's own epilogue  alpha * acc + beta * D  (alpha = scale,
// beta = decay, D = W), so the product never round-trips device memory
// before the affine.  Both sides are taken natively, in W's own (m, n)
// layout:
//   left   P (m, r), S (r, n):  out(i, j) = sum_k P(i, k) S(k, j)
//   right  P (n, r), S (m, r):  out(i, j) = sum_k S(i, k) P(j, k)
// so the right side (mlp/w_out) needs no transpose of S, W or out.
//
// W is fp32, or bf16 when the parameters are stored in bf16
// (ModelConfig.param_dtype="bfloat16", as the TPU kernel's body casts a W of
// any dtype to fp32): the same GEMM, instantiated with a bf16 epilogue
// operand that each thread widens to fp32 as it reads it, so no fp32 copy of
// the W stack is made.  P, S and out stay fp32 (the TPU kernel's output is
// fp32 too).  The instantiation is the fifth template argument reported
// (0 fp32 W or none, 1 bf16 W).
//
// Bound on the H100: at llama-130m's mlp family, P (24, 768, 256),
// S (24, 256, 2048) and W (24, 768, 2048) give 19.3 GFLOP on 371 MB: three
// TF32 products per fp32 product over 495 TFLOP/s is 0.1171 ms, just above
// the bytes' 0.1108 ms at 3.35 TB/s, so it sits near the ridge (bound by
// operations).  A bf16 W moves 296 MB (0.088 ms): still bound by operations.
#include <cuda_runtime.h>

#include "tf32x3_gemm.cuh"

namespace {

using namespace repro_torch::tc;

template <int BM, int BN, bool B_KC, bool VEC, typename WT>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) back_project_epilogue_kernel(Args p) {
  gemm_tile<BM, BN, true, B_KC, VEC, false, WT>(p);
}

template <int BM, int BN, bool B_KC, bool VEC, typename WT>
int launch_tile(const Args& p, int L, int* variant, cudaStream_t stream) {
  constexpr auto kernel = back_project_epilogue_kernel<BM, BN, B_KC, VEC, WT>;
  repro_torch::report_variant(variant, BM, BN, B_KC, VEC, sizeof(WT) == 2);
  return launch<kernel, Tile<BM, BN, true, B_KC>>(p, L, stream);
}

template <bool B_KC, bool VEC, typename WT>
int launch_tiled(const Args& p, int L, int* variant, cudaStream_t stream) {
  switch (pick_tile(p, L)) {
    case 64064: return launch_tile<64, 64, B_KC, VEC, WT>(p, L, variant, stream);
    case 64032: return launch_tile<64, 32, B_KC, VEC, WT>(p, L, variant, stream);
    default: return launch_tile<32, 32, B_KC, VEC, WT>(p, L, variant, stream);
  }
}

template <typename WT>
int launch_w(const Args& a, int right, int L, int* variant, cudaStream_t st) {
  const bool vec = rows_aligned16(a);
  if (right)
    return vec ? launch_tiled<true, true, WT>(a, L, variant, st)
               : launch_tiled<true, false, WT>(a, L, variant, st);
  return vec ? launch_tiled<false, true, WT>(a, L, variant, st)
             : launch_tiled<false, false, WT>(a, L, variant, st);
}

}  // namespace

// left:  p (L, m, r), s (L, r, n);  right (right != 0):  p (L, n, r),
// s (L, m, r);  w (L, m, n) or null, out (L, m, n).  All contiguous on the
// device, fp32 but w, which is bf16 when w_bf16 is 1.  Returns
// cudaGetLastError() (0 on success): a refused launch never runs, so the
// caller must check the code.
extern "C" int back_project_epilogue(const float* p, const float* s, const void* w,
                                     float* out, int L, int m, int r, int n,
                                     int right, int w_bf16, float scale, float decay,
                                     int* variant, void* stream) {
  if (L <= 0 || m <= 0 || r <= 0 || n <= 0 || (right != 0 && right != 1) ||
      (w_bf16 != 0 && w_bf16 != 1) || (w_bf16 && w == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.lda = r;
  a.a_batch = static_cast<long long>(m) * r;
  if (right) {  // A(i, k) = S[i, k]; B(k, j) = P[j, k]: k contiguous
    a.a = s;
    a.b = p;
    a.ldb = r;
  } else {  // A(i, k) = P[i, k]; B(k, j) = S[k, j]
    a.a = p;
    a.b = s;
    a.ldb = n;
  }
  a.b_batch = static_cast<long long>(r) * n;
  a.d = w;
  a.c = out;
  a.ldc = n;
  a.c_batch = static_cast<long long>(m) * n;
  a.M = m;
  a.N = n;
  a.K = r;
  a.alpha = scale;
  a.beta = decay;
  set_out_vec(a, w_bf16 ? 2 : 4);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (w_bf16) return launch_w<__nv_bfloat16>(a, right, L, variant, st);
  return launch_w<float>(a, right, L, variant, st);
}
