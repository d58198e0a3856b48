// Polynomial apply  out = a * X + A2 @ X  (second half of a Newton-Schulz
// step, A2 = b * G + c * G @ G), fp32 accurate by 3xTF32 on the tensor
// cores.
//
// Replaces the Pallas kernel _poly_apply_kernel
// (src/repro/kernels/newton_schulz.py:71, poly_matmul_axpy:78).  The a * X
// term rides in the GEMM epilogue, so the product never round-trips device
// memory before the axpy.
//
// It is lowrank_update.cu's right side (out = beta * R + coeff * G P) on the
// shared core of tf32x3_gemm.cuh, with G := A2 read K-contiguous, P := X
// row-major, R := X, beta = a and coeff = 1: no device code of its own
// beyond the kernel's name.
//
// Bound on the H100: three TF32 products per fp32 product, so at llama-130m,
// A2 (4, 768, 768) and X (4, 768, 2048), 3 * 9.66 GFLOP over 495 TFLOP/s is
// 0.0586 ms, above the 60 MB's 0.018 ms at 3.35 TB/s: bound by operations.
#include <cuda_runtime.h>

#include "tf32x3_gemm.cuh"

namespace {

using namespace repro_torch::tc;

template <int BM, int BN, bool VEC>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) poly_apply_kernel(Args p) {
  gemm_tile<BM, BN, true, false, VEC, false>(p);
}

template <int BM, int BN, bool VEC>
int launch_tile(const Args& p, int L, int* variant, cudaStream_t stream) {
  constexpr auto kernel = poly_apply_kernel<BM, BN, VEC>;
  repro_torch::report_variant(variant, BM, BN, VEC);
  return launch<kernel, Tile<BM, BN, true, false>>(p, L, stream);
}

template <bool VEC>
int launch_tiled(const Args& p, int L, int* variant, cudaStream_t stream) {
  switch (pick_tile(p, L)) {
    case 64064: return launch_tile<64, 64, VEC>(p, L, variant, stream);
    case 64032: return launch_tile<64, 32, VEC>(p, L, variant, stream);
    default: return launch_tile<32, 32, VEC>(p, L, variant, stream);
  }
}

bool valid(int L, int s, int n) { return L > 0 && s > 0 && n > 0; }

}  // namespace

// a2 (L, s, s), x (L, s, n), out (L, s, n); contiguous fp32 on the device.
// Returns cudaGetLastError() (0 on success): a refused launch never runs, so
// the caller must check the code.
extern "C" int poly_apply(const float* a2, const float* x, float* out, int L, int s,
                          int n, float a, int* variant, void* stream) {
  if (!valid(L, s, n)) return static_cast<int>(cudaErrorInvalidValue);
  Args g{};
  g.a = a2;  // A(i, k) = A2[i, k]: k contiguous
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
  set_out_vec(g);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return rows_aligned16(g) ? launch_tiled<true>(g, L, variant, st)
                           : launch_tiled<false>(g, L, variant, st);
}

// The block tile poly_apply picks for these operands, as BM * 1000 + BN
// (64064, 64032 or 32032); 0 for arguments it refuses.  Launches nothing.
extern "C" int poly_apply_tile(int L, int s, int n) {
  if (!valid(L, s, n)) return 0;
  Args g{};
  g.M = s;
  g.N = n;
  return pick_tile(g, L);
}
