// Back-projection GEMM on the tensor cores, fp32 accurate by 3xTF32:
//
//   right 0 (left):  out = P S      P (L, m, r), S (L, r, n)
//   right 1 (right): out = S P^T    P (L, n, r), S (L, m, r)
//
// out (L, m, n) either way, contiguous: the right side reads P along its
// rank axis as it lies (a K-major B operand), so there is no transposed copy
// of S and no transposed view of the output.
//
// Replaces the Pallas kernel _back_project_kernel
// (src/repro/kernels/lowrank_update.py:105, back_project_batched:116).  The
// TPU version holds the whole rank axis in one tile and does one MXU product
// per output tile; here the block loops over r in 32-deep slices, so any rank
// works, and a rank below one slice (r = 4) is zero-filled in the copies.
//
// Bound on the H100: three TF32 products per fp32 product, so at llama-130m,
// P (12, 768, 256) and S (12, 256, 2048), 3 * 9.66 GFLOP over 495 TFLOP/s is
// 0.0586 ms, above the 110 MB's 0.0329 ms at 3.35 TB/s: bound by operations.
// The reduction is short (K = r = 256, 8 slices), so the ring's fill is a
// quarter of each block's slices.
//
// It runs on the shared core of tf32x3_gemm.cuh: A (P on the left, S on the
// right) K-contiguous, B = S row-major on the left, B(k, j) = P[j, k] on the
// right; no epilogue operand.
#include <cuda_runtime.h>

#include "tf32x3_gemm.cuh"

namespace {

using namespace repro_torch::tc;

template <int BM, int BN, bool B_KC, bool VEC>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) back_project_kernel(Args p) {
  gemm_tile<BM, BN, true, B_KC, VEC, false>(p);
}

template <int BM, int BN, bool B_KC, bool VEC>
int launch_tile(const Args& p, int L, int* variant, cudaStream_t stream) {
  constexpr auto kernel = back_project_kernel<BM, BN, B_KC, VEC>;
  repro_torch::report_variant(variant, BM, BN, B_KC, VEC);
  return launch<kernel, Tile<BM, BN, true, B_KC>>(p, L, stream);
}

template <bool B_KC, bool VEC>
int launch_tiled(const Args& p, int L, int* variant, cudaStream_t stream) {
  switch (pick_tile(p, L)) {
    case 64064: return launch_tile<64, 64, B_KC, VEC>(p, L, variant, stream);
    case 64032: return launch_tile<64, 32, B_KC, VEC>(p, L, variant, stream);
    default: return launch_tile<32, 32, B_KC, VEC>(p, L, variant, stream);
  }
}

bool valid(int L, int m, int r, int n, int right) {
  return L > 0 && m > 0 && r > 0 && n > 0 && (right == 0 || right == 1);
}

}  // namespace

// left:  p (L, m, r), s (L, r, n);  right (right != 0):  p (L, n, r),
// s (L, m, r);  out (L, m, n).  All contiguous fp32 on the device.  Returns
// cudaGetLastError() (0 on success): a refused launch never runs, so the
// caller must check the code.
extern "C" int back_project(const float* p, const float* s, float* out, int L, int m,
                            int r, int n, int right, int* variant, void* stream) {
  if (!valid(L, m, r, n, right)) return static_cast<int>(cudaErrorInvalidValue);
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
  a.c = out;
  a.ldc = n;
  a.c_batch = static_cast<long long>(m) * n;
  a.M = m;
  a.N = n;
  a.K = r;
  a.alpha = 1.f;
  set_out_vec(a);
  const bool vec = rows_aligned16(a);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (right)
    return vec ? launch_tiled<true, true>(a, L, variant, st) : launch_tiled<true, false>(a, L, variant, st);
  return vec ? launch_tiled<false, true>(a, L, variant, st) : launch_tiled<false, false>(a, L, variant, st);
}

// The block tile back_project picks for these operands, as BM * 1000 + BN
// (64064, 64032 or 32032); 0 for arguments it refuses.  Launches nothing.
extern "C" int back_project_tile(int L, int m, int r, int n, int right) {
  if (!valid(L, m, r, n, right)) return 0;
  Args a{};
  a.M = m;
  a.N = n;
  return pick_tile(a, L);
}
