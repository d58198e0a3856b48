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
// Design, against the four limits of the fp32 SIMT kernel it replaces:
//  1. Tensor cores.  mma.sync.m16n8k8 TF32 with fp32 accumulation.  Each
//     operand x is split in registers as its fragment is read: hi = x
//     rounded to TF32 (as cvt.rna.tf32.f32 rounds, see round_tf32), lo = the
//     rest rounded the same way; the products are accumulated as
//     a_lo*b_hi + a_hi*b_lo + a_hi*b_hi (small terms first) and a_lo*b_lo is
//     dropped: about 2^-21 relative per product.  The tensor cores truncate
//     when they add into their accumulator, which biases a long sum (6e-6
//     relative at K = 768, 1.6e-5 at K = 2048 when one accumulator took the
//     whole reduction), so each 32-deep slice sums from zero on the tensor
//     cores and fp32 adds carry the slices' sums.  mma.sync, not wgmma: both
//     operands are MN-major on the left side (P is read along its rank axis,
//     G along n), which wgmma takes only for 16-bit types; mma.sync
//     fragments are plain 32-bit shared loads in any layout.
//  2. Loads overlap compute.  A ring of STAGES = 3 32-deep slices in dynamic
//     shared memory (above 48 KB for the 64 x 64 tile), filled by cp.async:
//     16-byte cp.async.cg when every row of both operands is 16-byte
//     aligned, else 4-byte cp.async.ca, with the source size 0 past a ragged
//     edge so that the copy fills zeros.  Slices k+1 and k+2 load while
//     slice k computes; one __syncthreads a slice.
//  3. Occupancy.  128-thread blocks of 2 x 2 warps, warp tiles of at most
//     32 x 32, at most 128 registers a thread (__launch_bounds__): four
//     blocks, 16 warps, an SM, with no spills.
//  4. Grids that fill the card.  The C entry point picks the block tile per
//     launch: the largest of 64x64, 64x32 and 32x32 that gives at least two
//     blocks an SM (264), else the smallest (lowrank_update_tile reports
//     the choice without launching).  The grid's fast axis walks the
//     dimension with fewer tiles, so the blocks that share a slab of the
//     large operand run together and find it in L2.
// Shared rows are padded (MN-major rows by 8 floats, K-major rows by 4) so
// that every fragment load of a warp hits 32 distinct banks.  Ragged M, N
// and K are zero-filled in the copies and masked in the stores.
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

using namespace repro_torch;

constexpr int BK = 32;         // reduction depth of one ring slice
constexpr int STAGES = 3;      // slices in the ring
constexpr int THREADS = 128;   // 2 x 2 warps
constexpr int MIN_BLOCKS = 4;  // blocks an SM: at most 128 registers a thread
constexpr int SMS = 132;       // H100 SXM

struct Args {
  const float* a;  // A(i, k): a[k * lda + i] (left) or a[i * lda + k] (right)
  const float* b;  // B(k, j) = b[k * ldb + j]
  const float* d;  // epilogue operand, (M, N) row-major like C; may be null
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
// says its rows run along k (the other axis, M or N, contiguous: A on the
// left, B), else its columns do (A on the right, K contiguous).  A copy moves
// W = 4 floats (cp.async.cg, 16-byte aligned rows) or 1 (cp.async.ca); a
// thread keeps one column and every RS-th row, so its addresses and its
// masks on the fixed axis are computed once, and a slice costs a few
// instructions a copy.  Past a ragged edge the source size is 0: zeros.
template <int ROWS, int COLS, int LD, bool K_ROWS, bool VEC>
struct SliceLoader {
  static constexpr int W = VEC ? 4 : 1;
  static constexpr int CPR = COLS / W;             // copies a row
  static constexpr int RS = THREADS / CPR;         // rows between a thread's copies
  static constexpr int NC = ROWS / RS;             // copies a thread
  static_assert(THREADS % CPR == 0 && ROWS % RS == 0, "slice must tile the block");
  static_assert(NC <= 32, "row mask is 32 bits");

  const float* base;  // the operand's member (the source of masked copies)
  const float* src;   // this thread's first copy at k = 0
  int ld, K, c, r0;
  int dst0;           // shared offset of the first copy
  int fixed;          // K_ROWS: bytes valid on the fixed axis; else row mask

  __device__ __forceinline__ SliceLoader(const float* base_, int ld_, int K_, int mn0, int mn) {
    base = base_;
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
        cp_async16(dst, bytes ? from : base, bytes);
      else
        cp_async4(dst, bytes ? from : base, bytes);
    }
  }
};

template <int BM, int BN, bool A_KC>
struct Tile {
  static constexpr int WM = BM / 2;  // warp tile (2 x 2 warps)
  static constexpr int WN = BN / 2;
  static constexpr int MT = WM / 16;  // m16n8k8 tiles a warp
  static constexpr int NT = WN / 8;
  // Shared layout of one slice: A as [BK][BM + 8] (left, M contiguous) or
  // [BM][BK + 4] (right, K contiguous); B as [BK][BN + 8].
  static constexpr int LDA = A_KC ? BK + 4 : BM + 8;
  static constexpr int A_FLOATS = A_KC ? BM * LDA : BK * LDA;
  static constexpr int LDB = BN + 8;
  static constexpr int B_FLOATS = BK * LDB;
  static constexpr int STAGE_FLOATS = A_FLOATS + B_FLOATS;
  static constexpr int SMEM_BYTES = STAGES * STAGE_FLOATS * 4;
  static_assert(WM % 16 == 0 && WN % 8 == 0, "warp tile must hold whole mma tiles");
};

template <int BM, int BN, bool A_KC, bool VEC>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) lowrank_update_kernel(Args p) {
  using T = Tile<BM, BN, A_KC>;
  extern __shared__ __align__(16) float smem[];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;  // mma group id
  const int t = lane & 3;   // thread in group
  const int wm0 = (warp >> 1) * T::WM;
  const int wn0 = (warp & 1) * T::WN;
  const int l = blockIdx.z;
  const int m0 = (p.m_fast ? blockIdx.x : blockIdx.y) * BM;
  const int n0 = (p.m_fast ? blockIdx.y : blockIdx.x) * BN;
  const SliceLoader<A_KC ? BM : BK, A_KC ? BK : BM, T::LDA, !A_KC, VEC> load_a(
      p.a + (size_t)l * p.a_batch, p.lda, p.K, m0, p.M);
  const SliceLoader<BK, BN, T::LDB, true, VEC> load_b(
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
        split_tf32(bs[(kk + t) * T::LDB + col], bhi[j][0], blo[j][0]);
        split_tf32(bs[(kk + t + 4) * T::LDB + col], bhi[j][1], blo[j][1]);
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
  const float* d = p.d ? p.d + (size_t)l * p.c_batch : nullptr;
#pragma unroll
  for (int i = 0; i < T::MT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gi = m0 + wm0 + i * 16 + g + h * 8;
      if (gi >= p.M) continue;
      float* crow = c + (size_t)gi * p.ldc;
      const float* drow = d ? d + (size_t)gi * p.ldc : nullptr;
#pragma unroll
      for (int j = 0; j < T::NT; ++j) {
        const int gj = n0 + wn0 + j * 8 + 2 * t;
        float o0 = p.alpha * acc[i][j][2 * h];
        float o1 = p.alpha * acc[i][j][2 * h + 1];
        if (p.out_vec && gj + 1 < p.N) {
          if (drow) {
            const float2 dv = *reinterpret_cast<const float2*>(drow + gj);
            o0 = fmaf(p.beta, dv.x, o0);
            o1 = fmaf(p.beta, dv.y, o1);
          }
          *reinterpret_cast<float2*>(crow + gj) = make_float2(o0, o1);
        } else {
          if (gj < p.N) crow[gj] = drow ? fmaf(p.beta, drow[gj], o0) : o0;
          if (gj + 1 < p.N) crow[gj + 1] = drow ? fmaf(p.beta, drow[gj + 1], o1) : o1;
        }
      }
    }
  }
}

bool aligned(const void* ptr, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(ptr) & (bytes - 1)) == 0;
}

long long blocks(const Args& p, int L, int bm, int bn) {
  return static_cast<long long>((p.M + bm - 1) / bm) * ((p.N + bn - 1) / bn) * L;
}

template <int BM, int BN, bool A_KC, bool VEC>
int launch(Args p, int L, cudaStream_t stream) {
  using T = Tile<BM, BN, A_KC>;
  constexpr auto kernel = lowrank_update_kernel<BM, BN, A_KC, VEC>;
  const cudaError_t err = allow_smem<kernel>(T::SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int mt = (p.M + BM - 1) / BM, nt = (p.N + BN - 1) / BN;
  p.m_fast = mt <= nt;
  const dim3 grid(p.m_fast ? mt : nt, p.m_fast ? nt : mt, L);
  kernel<<<grid, THREADS, T::SMEM_BYTES, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The block tile, as BM * 1000 + BN: the largest that gives two blocks an
// SM, else the smallest.
int pick_tile(const Args& p, int L) {
  if (blocks(p, L, 64, 64) >= 2 * SMS) return 64064;
  if (blocks(p, L, 64, 32) >= 2 * SMS) return 64032;
  return 32032;
}

template <bool A_KC, bool VEC>
int launch_tiled(const Args& p, int L, cudaStream_t stream) {
  switch (pick_tile(p, L)) {
    case 64064: return launch<64, 64, A_KC, VEC>(p, L, stream);
    case 64032: return launch<64, 32, A_KC, VEC>(p, L, stream);
    default: return launch<32, 32, A_KC, VEC>(p, L, stream);
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
                              float coeff, int side, void* stream) {
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
  a.out_vec = a.ldc % 2 == 0 && aligned(out, 8) && (!r_state || aligned(r_state, 8));
  // 16-byte copies when every row of A and B starts 16-byte aligned.
  const bool vec = aligned(a.a, 16) && a.lda % 4 == 0 && a.a_batch % 4 == 0 &&
                   aligned(a.b, 16) && a.ldb % 4 == 0 && a.b_batch % 4 == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (side == 0)
    return vec ? launch_tiled<false, true>(a, L, s) : launch_tiled<false, false>(a, L, s);
  return vec ? launch_tiled<true, true>(a, L, s) : launch_tiled<true, false>(a, L, s);
}

// The block tile lowrank_update picks for these operands, as BM * 1000 + BN
// (64064, 64032 or 32032); 0 for arguments it refuses.  Launches nothing.
extern "C" int lowrank_update_tile(int L, int m, int r, int n, int side) {
  if (L <= 0 || m <= 0 || r <= 0 || n <= 0 || (side != 0 && side != 1)) return 0;
  Args a{};
  set_dims(a, m, r, n, side);
  return pick_tile(a, L);
}
