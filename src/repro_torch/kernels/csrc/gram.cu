// Gram matrix  out = X X^T  (first half of a Newton-Schulz step), fp32
// accurate by 3xTF32 on the tensor cores.
//
// Replaces the Pallas kernel _gram_kernel
// (src/repro/kernels/newton_schulz.py:34, gram:50).  The TPU version keeps
// the whole (s, s) sum in VMEM and walks n as its sequential grid axis, which
// capped s at 1024; here the (s, s) output is tiled over blocks and each
// block loops over n, so s = 768 (llama-130m's full slots) and s = 1024
// (llama-350m) both work.
//
// It runs on the shared core of tf32x3_gemm.cuh with both operands X
// (L, s, n) row-major as they are: A(i, k) = X[i, k] and B(k, j) = X[j, k],
// both K-contiguous (A_KC, B_KC), so no transposed copy.  X X^T is
// symmetric: the grid covers the T (T + 1) / 2 square tiles (bi <= bj) of
// one triangle of each member's T x T tiles, and each block writes its
// upper entries and their mirror (the core's SYM mode), so the output is
// exactly symmetric and each mirrored tile is computed once.
//
// Bound on the H100: the work is one triangle and the diagonal, s (s + 1) / 2
// dot products of length n a member, three TF32 products each (3xTF32): at
// llama-130m's X (4, 768, 2048), 3 * 4.84 GFLOP over 495 TFLOP/s is
// 0.0293 ms, above the 34.6 MB's 0.0103 ms at 3.35 TB/s: bound by operations.
#include <cuda_runtime.h>

#include "tf32x3_gemm.cuh"

namespace {

using namespace repro_torch::tc;

// X is both operands.  Setting B from A here, where the compiler sees it,
// lets the two loaders share their base addresses: the 64 x 64 kernel with
// 4-byte copies spilled without it.
template <int B, bool VEC>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) gram_kernel(Args p) {
  p.b = p.a;
  p.ldb = p.lda;
  p.b_batch = p.a_batch;
  gemm_tile<B, B, true, true, VEC, true>(p);
}

template <int B, bool VEC>
int launch_tile(const Args& p, int L, int* variant, cudaStream_t stream) {
  constexpr auto kernel = gram_kernel<B, VEC>;
  repro_torch::report_variant(variant, B, VEC);
  return launch<kernel, Tile<B, B, true, true>, true>(p, L, stream);
}

// The square tile, as B * 1000 + B: 64 x 64 when one triangle of them gives
// two blocks an SM, else 32 x 32.
int pick_gram_tile(int L, int s) {
  const long long t = (s + 63) / 64;
  return t * (t + 1) / 2 * L >= 2 * SMS ? 64064 : 32032;
}

bool valid(int L, int s, int n) { return L > 0 && s > 0 && n > 0; }

}  // namespace

// x (L, s, n), out (L, s, s); contiguous fp32 on the device.  Returns
// cudaGetLastError() (0 on success): a refused launch never runs, so the
// caller must check the code.
extern "C" int gram(const float* x, float* out, int L, int s, int n, int* variant,
                    void* stream) {
  if (!valid(L, s, n)) return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.a = x;  // A(i, k) = X[i, k]; B(k, j) = X[j, k], set in the kernel
  a.lda = n;
  a.a_batch = static_cast<long long>(s) * n;
  a.b = x;
  a.ldb = n;
  a.b_batch = a.a_batch;
  a.c = out;
  a.ldc = s;
  a.c_batch = static_cast<long long>(s) * s;
  a.M = s;
  a.N = s;
  a.K = n;
  a.alpha = 1.f;
  const bool vec = rows_aligned16(a);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (pick_gram_tile(L, s) == 64064)
    return vec ? launch_tile<64, true>(a, L, variant, st)
               : launch_tile<64, false>(a, L, variant, st);
  return vec ? launch_tile<32, true>(a, L, variant, st)
             : launch_tile<32, false>(a, L, variant, st);
}

// The square tile gram picks for these operands, as B * 1000 + B (64064 or
// 32032); 0 for arguments it refuses.  Launches nothing.
extern "C" int gram_tile(int L, int s, int n) {
  return valid(L, s, n) ? pick_gram_tile(L, s) : 0;
}
