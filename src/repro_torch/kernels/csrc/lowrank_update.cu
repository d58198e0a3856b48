// Fused low-rank momentum update and projection on the tensor cores, fp32
// accurate by 3xTF32:
//
//   side 0 (left):  out = beta * R + coeff * P^T G
//                   P (L, m, r), G (L, m, n), R and out (L, r, n)
//   side 1 (right): out = beta * R + coeff * G P
//                   P (L, n, r), G (L, m, n), R and out (L, m, r)
//
// and out = coeff * (the product) when R is null.  All operands contiguous
// fp32 on the device, in the caller's layouts: the right side reads G and R
// as they are, with no transposed copies.
//
// Replaces the Pallas kernels _lowrank_update_kernel
// (src/repro/kernels/lowrank_update.py:30, lowrank_update_batched:51) and
// _project_kernel (src/repro/kernels/lowrank_update.py:146,
// project_batched:165).  The TPU versions walk m as a sequential grid axis
// and carry the (r, block_n) sum in VMEM; here a block owns one output tile
// and loops over the whole reduction itself, so no sum crosses a block and
// there is no split-K (K = 768 is short, and atomics would make the sums
// depend on the run).
//
// Bound on the H100: 3xTF32 issues three TF32 products per fp32 product, so
// the least time is max(3 * 2*L*M*N*K / 495 TFLOP/s, bytes / 3.35 TB/s).  At
// llama-130m, P (12, 768, 256), G (12, 768, 2048) with R that is 29.0 GFLOP
// executed on 135.3 MB: 0.0586 ms, bound by operations; the projection
// P (4, 768, 256), G (4, 768, 2048): 9.66 GFLOP on 36.7 MB, 0.0195 ms.
//
// The product runs on the 3xTF32 tensor-core core of tf32x3_gemm.cuh
// (mma.sync with each operand split into two TF32 halves, a 3-stage cp.async
// ring, 128-thread blocks of at most 128 registers, a block tile picked per
// launch), which the port's other GEMM kernels share; its note gives the
// design.
#include <cuda_runtime.h>

#include "tf32x3_gemm.cuh"

namespace {

using namespace repro_torch::tc;

template <int BM, int BN, bool A_KC, bool VEC>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) lowrank_update_kernel(Args p) {
  gemm_tile<BM, BN, A_KC, false, VEC, false>(p);
}

template <int BM, int BN, bool A_KC, bool VEC>
int launch_tile(const Args& p, int L, int* variant, cudaStream_t stream) {
  constexpr auto kernel = lowrank_update_kernel<BM, BN, A_KC, VEC>;
  repro_torch::report_variant(variant, BM, BN, A_KC, VEC);
  return launch<kernel, Tile<BM, BN, A_KC, false>>(p, L, stream);
}

template <bool A_KC, bool VEC>
int launch_tiled(const Args& p, int L, int* variant, cudaStream_t stream) {
  switch (pick_tile(p, L)) {
    case 64064: return launch_tile<64, 64, A_KC, VEC>(p, L, variant, stream);
    case 64032: return launch_tile<64, 32, A_KC, VEC>(p, L, variant, stream);
    default: return launch_tile<32, 32, A_KC, VEC>(p, L, variant, stream);
  }
}

// The product's (M, N, K) on each side.
void set_dims(Args& a, int m, int r, int n, int side) {
  if (side == 0) {  // C (r, n) = P^T G
    a.M = r;
    a.N = n;
    a.K = m;
  } else {  // C (m, r) = G P
    a.M = m;
    a.N = r;
    a.K = n;
  }
}

}  // namespace

// side 0: p (L, m, r), g (L, m, n), r_state and out (L, r, n).
// side 1: p (L, n, r), g (L, m, n), r_state and out (L, m, r).
// r_state may be null.  Returns cudaGetLastError() (0 on success): a refused
// launch never runs, so the caller must check the code.
extern "C" int lowrank_update(const float* p, const float* g, const float* r_state,
                              float* out, int L, int m, int r, int n, float beta,
                              float coeff, int side, int* variant, void* stream) {
  if (L <= 0 || m <= 0 || r <= 0 || n <= 0 || (side != 0 && side != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.d = r_state;
  a.c = out;
  a.alpha = coeff;
  a.beta = beta;
  if (side == 0) {  // C (r, n) = P^T G: A(i, k) = P[k, i], B = G
    a.a = p;
    a.lda = r;
    a.a_batch = static_cast<long long>(m) * r;
    a.b = g;
    a.ldb = n;
    a.b_batch = static_cast<long long>(m) * n;
  } else {  // C (m, r) = G P: A = G (K contiguous), B = P
    a.a = g;
    a.lda = n;
    a.a_batch = static_cast<long long>(m) * n;
    a.b = p;
    a.ldb = r;
    a.b_batch = static_cast<long long>(n) * r;
  }
  set_dims(a, m, r, n, side);
  a.ldc = a.N;
  a.c_batch = static_cast<long long>(a.M) * a.N;
  set_out_vec(a);
  const bool vec = rows_aligned16(a);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (side == 0)
    return vec ? launch_tiled<false, true>(a, L, variant, s) : launch_tiled<false, false>(a, L, variant, s);
  return vec ? launch_tiled<true, true>(a, L, variant, s) : launch_tiled<true, false>(a, L, variant, s);
}

// The block tile lowrank_update picks for these operands, as BM * 1000 + BN
// (64064, 64032 or 32032); 0 for arguments it refuses.  Launches nothing.
extern "C" int lowrank_update_tile(int L, int m, int r, int n, int side) {
  if (L <= 0 || m <= 0 || r <= 0 || n <= 0 || (side != 0 && side != 1)) return 0;
  Args a{};
  set_dims(a, m, r, n, side);
  return pick_tile(a, L);
}
