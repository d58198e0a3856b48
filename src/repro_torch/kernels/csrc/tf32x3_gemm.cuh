// The batched 3xTF32 tensor-core GEMM core of the port's optimizer kernels
// (lowrank_update.cu, back_project.cu, back_project_epilogue.cu,
// poly_apply.cu, gram.cu), fp32 accurate:
//
//   C[l](i, j) = alpha * sum_k A[l](i, k) * B[l](k, j)  +  beta * D[l](i, j)
//
// over L members, with D optional and of type DT (fp32, or bf16 widened to
// fp32 as it is read: back_project_epilogue.cu's bf16-stored W; the other
// callers keep the fp32 default).  A and B are read through one leading
// dimension each, in the caller's layout; the template flags say which of
// their two axes is contiguous in memory:
//   A_KC  true : A(i, k) = a[i * lda + k]     false : A(i, k) = a[k * lda + i]
//   B_KC  true : B(k, j) = b[j * ldb + k]     false : B(k, j) = b[k * ldb + j]
// C and D share one row-major layout (ldc).  SYM (square tiles, M = N, no D)
// is the symmetric mode of gram.cu: the grid covers the tiles (bi, bj) with
// bi <= bj of one triangle, and each block writes its entries (i, j) with
// i <= j and mirrors those with i < j to (j, i), so C is exactly symmetric
// and each mirrored tile is computed once.  A diagonal tile needs the rule
// too: its (i, j) and (j, i) sum the same products in another order.
//
// Each .cu declares its own __global__ <name>_kernel around gemm_tile, so
// traces tell the kernels apart, and picks its block tile per launch.
//
// Design, against the four limits of the fp32 SIMT core these kernels first
// ran on (128 x 128 block tiles of fmaf, 256-thread blocks, no asynchronous
// copies):
//  1. Tensor cores.  mma.sync.m16n8k8 TF32 with fp32 accumulation.  Each
//     operand x is split in registers as its fragment is read: hi = x
//     rounded to TF32 (as cvt.rna.tf32.f32 rounds, see round_tf32), lo = the
//     rest rounded the same way; the products are accumulated as
//     a_lo*b_hi + a_hi*b_lo + a_hi*b_hi (small terms first) and a_lo*b_lo is
//     dropped: about 2^-21 relative per product.  The tensor cores truncate
//     when they add into their accumulator, which biases a long sum (6e-6
//     relative at K = 768, 1.6e-5 at K = 2048 when one accumulator took the
//     whole reduction), so each 32-deep slice sums from zero on the tensor
//     cores and fp32 adds carry the slices' sums.  mma.sync, not wgmma: A and
//     B are MN-major in some callers (lowrank_update's left side reads P
//     along its rank axis, G along n), which wgmma takes only for 16-bit
//     types; mma.sync fragments are plain 32-bit shared loads in any layout.
//  2. Loads overlap compute.  A ring of STAGES = 3 32-deep slices in dynamic
//     shared memory (above 48 KB for the 64 x 64 tile), filled by cp.async:
//     16-byte cp.async.cg when every row of both operands is 16-byte
//     aligned, else 4-byte cp.async.ca, with the source size 0 past a ragged
//     edge so that the copy fills zeros.  Slices k+1 and k+2 load while
//     slice k computes; one __syncthreads a slice.
//  3. Occupancy.  128-thread blocks of 2 x 2 warps, warp tiles of at most
//     32 x 32, at most 128 registers a thread (__launch_bounds__ in each
//     .cu): four blocks, 16 warps, an SM, with no spills.
//  4. Grids that fill the card.  The callers pick the block tile per launch
//     (pick_tile: the largest of 64x64, 64x32 and 32x32 that gives at least
//     two blocks an SM, else the smallest; gram's square tiles by its own
//     rule).  The grid's fast axis walks the dimension with fewer tiles, so
//     the blocks that share a slab of the large operand run together and
//     find it in L2.
// Shared rows are padded (MN-major rows by 8 floats, K-major rows by 4) so
// that every fragment load of a warp hits 32 distinct banks.  Ragged M, N
// and K are zero-filled in the copies and masked in the stores.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace repro_torch {
namespace tc {

constexpr int BK = 32;         // reduction depth of one ring slice
constexpr int STAGES = 3;      // slices in the ring
constexpr int THREADS = 128;   // 2 x 2 warps
constexpr int MIN_BLOCKS = 4;  // blocks an SM: at most 128 registers a thread
constexpr int SMS = 132;       // H100 SXM

struct Args {
  const float* a;  // A(i, k), layout by A_KC
  const float* b;  // B(k, j), layout by B_KC
  const void* d;   // epilogue operand of the kernel's DT, (M, N) row-major like C; may be null
  float* c;
  int M, N, K;
  int lda, ldb, ldc;
  long long a_batch, b_batch, c_batch;  // element strides between members
  float alpha, beta;
  int out_vec;  // 1 when C (and D) allow 8-byte accesses
  int m_fast;   // 1 when blockIdx.x walks the M tiles
};

// Copies one operand's BK-deep slices into the ring.  The slice is ROWS x
// COLS in shared memory (row stride LD) and in memory (stride ld); K_ROWS
// says its rows run along k (the other axis, M or N, contiguous), else its
// columns do (K contiguous).  A copy moves W = 4 floats (cp.async.cg,
// 16-byte aligned rows) or 1 (cp.async.ca); a thread keeps one column and
// every RS-th row, so its addresses and its masks on the fixed axis are
// computed once, and a slice costs a few instructions a copy.  Past a
// ragged edge the source size is 0: the copy reads nothing and writes
// zeros, so its address may lie outside the operand and no register holds
// a fallback source (that register spilled the non-symmetric 64 x 64
// kernel with both operands K-major and 4-byte copies).
template <int ROWS, int COLS, int LD, bool K_ROWS, bool VEC>
struct SliceLoader {
  static constexpr int W = VEC ? 4 : 1;
  static constexpr int CPR = COLS / W;             // copies a row
  static constexpr int RS = THREADS / CPR;         // rows between a thread's copies
  static constexpr int NC = ROWS / RS;             // copies a thread
  static_assert(THREADS % CPR == 0 && ROWS % RS == 0, "slice must tile the block");
  static_assert(NC <= 32, "row mask is 32 bits");

  const float* src;   // this thread's first copy at k = 0
  int ld, K, c, r0;
  int dst0;           // shared offset of the first copy
  int fixed;          // K_ROWS: bytes valid on the fixed axis; else row mask

  __device__ __forceinline__ SliceLoader(const float* base, int ld_, int K_, int mn0, int mn) {
    ld = ld_;
    K = K_;
    const int tid = threadIdx.x;
    c = (tid % CPR) * W;
    r0 = tid / CPR;
    dst0 = r0 * LD + c;
    if (K_ROWS) {  // rows k, columns mn0 + c
      const int left = mn - (mn0 + c);
      fixed = (left <= 0 ? 0 : (left >= W ? W : left)) * 4;
      src = base + (size_t)r0 * ld + mn0 + c;
    } else {  // rows mn0 + r, columns k
      fixed = 0;
#pragma unroll
      for (int t = 0; t < NC; ++t)
        if (mn0 + r0 + t * RS < mn) fixed |= 1 << t;
      src = base + (size_t)(mn0 + r0) * ld + c;
    }
  }

  __device__ __forceinline__ void load(float* stage, int k0) const {
    int kbytes = 0;
    if (!K_ROWS) {
      const int left = K - (k0 + c);
      kbytes = (left <= 0 ? 0 : (left >= W ? W : left)) * 4;
    }
#pragma unroll
    for (int t = 0; t < NC; ++t) {
      int bytes;
      const float* from;
      if (K_ROWS) {
        bytes = k0 + r0 + t * RS < K ? fixed : 0;
        from = src + (size_t)(k0 + t * RS) * ld;
      } else {
        bytes = (fixed >> t) & 1 ? kbytes : 0;
        from = src + (size_t)(t * RS) * ld + k0;
      }
      float* dst = stage + dst0 + t * RS * LD;
      if (VEC)
        cp_async16(dst, from, bytes);
      else
        cp_async4(dst, from, bytes);
    }
  }
};

template <int BM_, int BN_, bool A_KC, bool B_KC>
struct Tile {
  static constexpr int BM = BM_;
  static constexpr int BN = BN_;
  static constexpr int WM = BM / 2;  // warp tile (2 x 2 warps)
  static constexpr int WN = BN / 2;
  static constexpr int MT = WM / 16;  // m16n8k8 tiles a warp
  static constexpr int NT = WN / 8;
  // Shared layout of one slice: an MN-major operand as [BK][BM + 8] (or
  // BN + 8), a K-major one as [BM][BK + 4] (or BN).
  static constexpr int LDA = A_KC ? BK + 4 : BM + 8;
  static constexpr int A_FLOATS = A_KC ? BM * LDA : BK * LDA;
  static constexpr int LDB = B_KC ? BK + 4 : BN + 8;
  static constexpr int B_FLOATS = B_KC ? BN * LDB : BK * LDB;
  static constexpr int STAGE_FLOATS = A_FLOATS + B_FLOATS;
  static constexpr int SMEM_BYTES = STAGES * STAGE_FLOATS * 4;
  static_assert(WM % 16 == 0 && WN % 8 == 0, "warp tile must hold whole mma tiles");
};

// The epilogue operand's entries as fp32: one, or two neighbours (8 bytes
// of fp32, 4 of bf16).
__device__ __forceinline__ float load_d(const float* d) { return *d; }
__device__ __forceinline__ float load_d(const __nv_bfloat16* d) { return __bfloat162float(*d); }
__device__ __forceinline__ float2 load_d2(const float* d) {
  return *reinterpret_cast<const float2*>(d);
}
__device__ __forceinline__ float2 load_d2(const __nv_bfloat16* d) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(d));
}

// The body of every kernel on the core: one block's output tile.
template <int BM, int BN, bool A_KC, bool B_KC, bool VEC, bool SYM, typename DT = float>
__device__ __forceinline__ void gemm_tile(const Args& p) {
  static_assert(!SYM || BM == BN, "the symmetric mode takes square tiles");
  using T = Tile<BM, BN, A_KC, B_KC>;
  extern __shared__ __align__(16) float smem[];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;  // mma group id
  const int t = lane & 3;   // thread in group
  const int wm0 = (warp >> 1) * T::WM;
  const int wn0 = (warp & 1) * T::WN;
  const int l = blockIdx.z;
  int bi, bj;
  if (SYM) {  // blockIdx.x = bj (bj + 1) / 2 + bi, bi <= bj
    const int b = blockIdx.x;
    bj = static_cast<int>((sqrtf(8.f * b + 1.f) - 1.f) * 0.5f);
    while (bj * (bj + 1) / 2 > b) --bj;
    while ((bj + 1) * (bj + 2) / 2 <= b) ++bj;
    bi = b - bj * (bj + 1) / 2;
  } else {
    bi = p.m_fast ? blockIdx.x : blockIdx.y;
    bj = p.m_fast ? blockIdx.y : blockIdx.x;
  }
  const int m0 = bi * BM;
  const int n0 = bj * BN;
  const SliceLoader<A_KC ? BM : BK, A_KC ? BK : BM, T::LDA, !A_KC, VEC> load_a(
      p.a + (size_t)l * p.a_batch, p.lda, p.K, m0, p.M);
  const SliceLoader<B_KC ? BN : BK, B_KC ? BK : BN, T::LDB, !B_KC, VEC> load_b(
      p.b + (size_t)l * p.b_batch, p.ldb, p.K, n0, p.N);
  auto load_slice = [&](int stage, int k0) {
    float* as = smem + stage * T::STAGE_FLOATS;
    load_a.load(as, k0);
    load_b.load(as + T::A_FLOATS, k0);
  };

  // Each slice sums into `part` from zero on the tensor cores; `acc` takes
  // the slices' sums with fp32 adds (see note 1 above).
  float acc[T::MT][T::NT][4];
#pragma unroll
  for (int i = 0; i < T::MT; ++i)
#pragma unroll
    for (int j = 0; j < T::NT; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.f;
  const float zero[4] = {0.f, 0.f, 0.f, 0.f};

  const int KT = (p.K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load_slice(s, s * BK);
    cp_async_commit();
  }

  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();  // slice kt has landed (for this thread) ...
    __syncthreads();              // ... and for all; slice kt-1 is free again
    const int next = kt + STAGES - 1;
    if (next < KT) load_slice(next % STAGES, next * BK);
    cp_async_commit();

    const float* as = smem + (kt % STAGES) * T::STAGE_FLOATS;
    const float* bs = as + T::A_FLOATS;
    float part[T::MT][T::NT][4];
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      uint32_t ahi[T::MT][4], alo[T::MT][4], bhi[T::NT][2], blo[T::NT][2];
#pragma unroll
      for (int i = 0; i < T::MT; ++i) {
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int row = wm0 + i * 16 + g + (v & 1) * 8;  // a0 (g, t), a1 (g+8, t),
          const int col = kk + t + (v >> 1) * 4;           // a2 (g, t+4), a3 (g+8, t+4)
          const float x = A_KC ? as[row * T::LDA + col] : as[col * T::LDA + row];
          split_tf32(x, ahi[i][v], alo[i][v]);
        }
      }
#pragma unroll
      for (int j = 0; j < T::NT; ++j) {
        const int col = wn0 + j * 8 + g;  // b0 (t, g), b1 (t+4, g)
        if (B_KC) {
          split_tf32(bs[col * T::LDB + kk + t], bhi[j][0], blo[j][0]);
          split_tf32(bs[col * T::LDB + kk + t + 4], bhi[j][1], blo[j][1]);
        } else {
          split_tf32(bs[(kk + t) * T::LDB + col], bhi[j][0], blo[j][0]);
          split_tf32(bs[(kk + t + 4) * T::LDB + col], bhi[j][1], blo[j][1]);
        }
      }
      // Small terms first; consecutive mmas feed different accumulators.
#pragma unroll
      for (int i = 0; i < T::MT; ++i)
#pragma unroll
        for (int j = 0; j < T::NT; ++j)
          mma_tf32(part[i][j], alo[i], bhi[j], kk == 0 ? zero : part[i][j]);
#pragma unroll
      for (int i = 0; i < T::MT; ++i)
#pragma unroll
        for (int j = 0; j < T::NT; ++j) mma_tf32(part[i][j], ahi[i], blo[j], part[i][j]);
#pragma unroll
      for (int i = 0; i < T::MT; ++i)
#pragma unroll
        for (int j = 0; j < T::NT; ++j) mma_tf32(part[i][j], ahi[i], bhi[j], part[i][j]);
    }
#pragma unroll
    for (int i = 0; i < T::MT; ++i)
#pragma unroll
      for (int j = 0; j < T::NT; ++j)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[i][j][v] += part[i][j][v];
  }
  cp_async_wait<0>();

  // Epilogue: C = alpha * acc + beta * D, masked at the ragged edges.  c0,
  // c1 lie at (g, 2t), (g, 2t+1); c2, c3 eight rows down.
  float* c = p.c + (size_t)l * p.c_batch;
  const DT* d = p.d ? static_cast<const DT*>(p.d) + (size_t)l * p.c_batch : nullptr;
#pragma unroll
  for (int i = 0; i < T::MT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gi = m0 + wm0 + i * 16 + g + h * 8;
      if (gi >= p.M) continue;
      float* crow = c + (size_t)gi * p.ldc;
      const DT* drow = d ? d + (size_t)gi * p.ldc : nullptr;
#pragma unroll
      for (int j = 0; j < T::NT; ++j) {
        const int gj = n0 + wn0 + j * 8 + 2 * t;
        float o0 = p.alpha * acc[i][j][2 * h];
        float o1 = p.alpha * acc[i][j][2 * h + 1];
        if (SYM) {  // (gi, col) where gi <= col, and its mirror where gi < col
          const float o[2] = {o0, o1};
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = gj + e;
            if (col >= p.N || col < gi) continue;
            crow[col] = o[e];
            if (col > gi) c[(size_t)col * p.ldc + gi] = o[e];
          }
        } else if (p.out_vec && gj + 1 < p.N) {
          if (drow) {
            const float2 dv = load_d2(drow + gj);
            o0 = fmaf(p.beta, dv.x, o0);
            o1 = fmaf(p.beta, dv.y, o1);
          }
          *reinterpret_cast<float2*>(crow + gj) = make_float2(o0, o1);
        } else {
          if (gj < p.N) crow[gj] = drow ? fmaf(p.beta, load_d(drow + gj), o0) : o0;
          if (gj + 1 < p.N) crow[gj + 1] = drow ? fmaf(p.beta, load_d(drow + gj + 1), o1) : o1;
        }
      }
    }
  }
}

inline bool aligned(const void* ptr, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(ptr) & (bytes - 1)) == 0;
}

// True when every row of A and B starts 16-byte aligned (16-byte copies).
inline bool rows_aligned16(const Args& p) {
  return aligned(p.a, 16) && p.lda % 4 == 0 && p.a_batch % 4 == 0 && aligned(p.b, 16) &&
         p.ldb % 4 == 0 && p.b_batch % 4 == 0;
}

// Sets out_vec: C takes 8-byte accesses and D two-entry ones (d_bytes the
// size of D's entries: 4 for fp32, 2 for bf16).
inline void set_out_vec(Args& p, int d_bytes = 4) {
  p.out_vec = p.ldc % 2 == 0 && aligned(p.c, 8) && (!p.d || aligned(p.d, 2 * d_bytes));
}

inline long long blocks(const Args& p, int L, int bm, int bn) {
  return static_cast<long long>((p.M + bm - 1) / bm) * ((p.N + bn - 1) / bn) * L;
}

// The block tile, as BM * 1000 + BN: the largest of 64x64, 64x32 and 32x32
// that gives two blocks an SM, else the smallest.
inline int pick_tile(const Args& p, int L) {
  if (blocks(p, L, 64, 64) >= 2 * SMS) return 64064;
  if (blocks(p, L, 64, 32) >= 2 * SMS) return 64032;
  return 32032;
}

// Launches KERNEL (a __global__ wrapper of gemm_tile over tile T, SYM as
// given) on `stream` and returns cudaGetLastError() (0 on success): a
// refused launch never runs, so the caller must check the code.
template <auto KERNEL, class T, bool SYM = false>
int launch(Args p, int L, cudaStream_t stream) {
  const cudaError_t err = allow_smem<KERNEL>(T::SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int mt = (p.M + T::BM - 1) / T::BM, nt = (p.N + T::BN - 1) / T::BN;
  p.m_fast = mt <= nt;
  const dim3 grid = SYM ? dim3(mt * (mt + 1) / 2, 1, L)
                        : dim3(p.m_fast ? mt : nt, p.m_fast ? nt : mt, L);
  KERNEL<<<grid, THREADS, T::SMEM_BYTES, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc
}  // namespace repro_torch
