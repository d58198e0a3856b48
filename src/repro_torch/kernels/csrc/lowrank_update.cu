// Fused low-rank momentum update  out = beta * R + coeff * P^T G  (and the
// projection  coeff * P^T G  when R is null).
//
// Replaces the Pallas kernels _lowrank_update_kernel
// (src/repro/kernels/lowrank_update.py:30, lowrank_update_batched:51) and
// _project_kernel (src/repro/kernels/lowrank_update.py:146, project_batched:165).
// The TPU version walks m as its sequential grid axis and carries the
// (r, block_n) sum in VMEM; here each block owns an (r_tile x n_tile) output
// tile and loops over m itself, and r is tiled too (a 256 x 512 fp32 tile
// does not fit one SM's shared memory).
//
// Bound: at llama-130m, P (12, 768, 256) and G (12, 768, 2048) give 9.7
// GFLOP on 135 MB, 72 flops per byte: fp32 FMA issue, not memory (see
// gemm.cuh for the design).
#include "gemm.cuh"

__global__ void __launch_bounds__(repro_torch::THREADS)
    lowrank_update_kernel(repro_torch::GemmArgs p) {
  repro_torch::gemm_tile<false, true>(p);
}

// p (L, m, r), g (L, m, n), r_state (L, r, n) or null, out (L, r, n); all
// contiguous fp32 on the device.
extern "C" int lowrank_update(const float* p, const float* g, const float* r_state,
                              float* out, int L, int m, int r, int n, float beta,
                              float coeff, void* stream) {
  repro_torch::GemmArgs a{};
  a.a = p;  // A(i, k) = P[k, i]: i (the rank axis) is contiguous
  a.lda = r;
  a.a_batch = static_cast<long long>(m) * r;
  a.b = g;  // B(k, j) = G[k, j]
  a.ldb = n;
  a.b_batch = static_cast<long long>(m) * n;
  a.d = r_state;
  a.c = out;
  a.ldc = n;
  a.c_batch = static_cast<long long>(r) * n;
  a.M = r;
  a.N = n;
  a.K = m;
  a.alpha = coeff;
  a.beta = beta;
  return repro_torch::launch_gemm(lowrank_update_kernel, a, L, stream);
}
