// Mamba-2 SSD (state-space duality) chunked scan, forward only, fp32
// accurate on the tensor cores by 3xTF32:
//   per chunk of length Lc, with L_ij = exp(G_i - G_j) for i >= j else 0,
//     y  = ((C B^T) . L)(dt . X) + (C . e^G) S_prev
//     S  = e^{G_last} S_prev + (B . dt . e^{G_last - G})^T X
//   carrying the (N, P) state S across the chunks; returns y (without the
//   D.x skip) and the final state.
//
// Replaces the Pallas kernel _ssd_kernel / ssd_scan
// (src/repro/kernels/ssd_scan.py:25, :60).  As there, G (the per-chunk
// inclusive cumulative sum of a.dt) is computed outside the kernel, the skip
// is added by the caller, b and c are shared by all heads (ngroups = 1),
// x may be bf16 or fp32 and everything inside, y and the state are fp32.
// The exponent is masked before expf (upper-triangle differences are
// positive and would overflow, and inf * 0 is nan); expf, no fast math.
// Unlike the Pallas kernel it takes a ragged last chunk: its missing steps
// act as dt = 0 (decay 1, no state increment), which is what the
// reference's zero padding gives, without padding anything.
//
// Bound on the H100.  At mamba2-370m's prefill, x (4, 4096, 32, 64) bf16,
// b and c (4, 4096, 128), chunk 128, the function needs C B^T once per batch
// row and chunk (0.54 GFLOP; all heads share it), the causal triangle of the
// intra-chunk product (4.33), the inter-chunk product (8.59) and the state
// update (8.59).  By 3xTF32 a product takes three TF32 products, but two
// where one operand is bf16 x (exact in TF32, so its low part is zero):
// (3 (0.54 + 8.59) + 2 (4.33 + 8.59)) GFLOP / 495 TFLOP/s = 0.1075 ms, above
// the 224 MB of inputs and outputs (0.067 ms at 3.35 TB/s): bound by
// operations (0.3290 ms by fp32 SIMT FMA).
//
// Design: two kernels behind the one entry point.
//  1. ssd_cb_kernel: C B^T once per (batch row, chunk) into a workspace
//     (B, nch, Lc, ldcb) fp32 that the wrapper allocates (8.4 MB at the
//     prefill shape, which stays in the 50 MB L2).  It is the product of the
//     port's GEMM core (tf32x3_gemm.cuh) with both operands K-contiguous:
//     A(i, k) = c[i, k], B(k, j) = b[j, k].  The core's members share one M
//     and N, so each block points its member at its own rows of b and c and
//     sets M = N = the chunk's length: the ragged last chunk of the last
//     batch row reads nothing past S, and rows and columns past its length
//     are neither read nor written.  0.016 ms at the prefill shape.
//  2. ssd_scan_kernel: one block per (batch row, head, PC columns of P)
//     walks the chunks in order.  Its warps stand 8 along the chunk (warp
//     row r takes rows 16r .. 16r + 15 of y and of the state) by PC / 32
//     along P (32 columns each); each keeps its part of the state in
//     registers, and in shared memory for the other warps to read.  PC is
//     64 (16 warps) while those blocks cover more than half the SMs, else 32
//     (8 warps) for twice the blocks.  At the prefill shape that is 128
//     blocks of 16 warps, one an SM: 16 warps an SM (the fp32 SIMT kernel
//     ran 128 blocks of 8 warps); shared memory 143 KB a block with bf16 x
//     at chunk 128 (179 KB with fp32 x), at most 128 registers a thread.  At
//     batch 1 it is 64 blocks of 8 warps (111 KB; two fit an SM).
//     Each chunk is a sequence of KS = 64-deep slices through a ring of two
//     shared-memory stages, filled by cp.async one slice ahead:
//       intra  ceil(len/64) slices of the C B^T tile, columns j: each warp
//              forms its rows of M = (C B^T) . L . dt in registers as it
//              reads them (the exponent masked before expf) and multiplies
//              them by X, only over the k8 steps at or below its diagonal;
//       inter  ceil(N/64) slices of c, columns n (none for the first chunk,
//              whose S_prev is 0): A = c . e^{G_i}, B = S_prev;
//       state  ceil(len/64) slices of b, rows j: A(n, j) = b[j, n] w_j with
//              w_j = dt_j e^{G_last - G_j}, B = X.
//     x, dt and G of the next chunk load (double-buffered) while the current
//     one computes.  Every product is mma.sync.m16n8k8 TF32 with fp32
//     accumulation, each fp32 operand split in registers as it is read
//     (tf32x3.cuh).  Where x is bf16 its value is exactly its TF32 high part
//     and its low part is zero, so the products with x drop the a * x_lo
//     term: two TF32 products, not three.  Each KD = 32-deep part of a slice
//     sums from zero on the tensor cores and fp32 adds carry the parts (the
//     tensor cores truncate when they accumulate).  y sums its intra and
//     inter parts that way; the state's increment sums its parts from zero
//     and is then added as S = e^{G_last} S + inc in fp32, never accumulated
//     into a register that holds S, so the truncation cannot compound over
//     the chunks.
//  Shared rows are padded so that every fragment load of a warp hits 32
//  distinct banks (K-major slices KS + 4 floats, b slices N + 8, X and S
//  PC + 8).  What holds it back, and what the variants in
//  tools/ssd_scan_variants.py measured, is in PERF.md.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3_gemm.cuh"

namespace {

using namespace repro_torch;

constexpr int MAX_CHUNK = 128;
constexpr int MAX_N = 128;
constexpr int MAX_P = 64;

// ------------------------------------------------------------------ C B^T

struct CbGeom {
  int S, nch, chunk;
};

// One block's tile of C B^T for member blockIdx.z = batch row * nch + chunk.
template <int BM, int BN, bool VEC>
__global__ void __launch_bounds__(tc::THREADS, tc::MIN_BLOCKS)
    ssd_cb_kernel(tc::Args p, CbGeom geo) {
  const int l = blockIdx.z;
  const int z = l % geo.nch;
  const size_t row0 = static_cast<size_t>(l / geo.nch) * geo.S + static_cast<size_t>(z) * geo.chunk;
  const int len = min(geo.chunk, geo.S - z * geo.chunk);
  p.a += row0 * p.lda;  // c
  p.b += row0 * p.ldb;  // b
  p.M = len;
  p.N = len;
  tc::gemm_tile<BM, BN, true, true, VEC, false>(p);
}

template <int BM, int BN, bool VEC>
int launch_cb(const tc::Args& p, const CbGeom& geo, int L, int* variant,
              cudaStream_t stream) {
  constexpr auto kernel = ssd_cb_kernel<BM, BN, VEC>;
  report_variant(variant, BM, BN, VEC);
  using T = tc::Tile<BM, BN, true, true>;
  const cudaError_t err = allow_smem<kernel>(T::SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.M + BM - 1) / BM, (p.N + BN - 1) / BN, L);
  kernel<<<grid, tc::THREADS, T::SMEM_BYTES, stream>>>(p, geo);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------------ the scan

constexpr int KS = 64;          // depth of a ring slice
constexpr int KD = 32;          // depth of one sum from zero on the tensor cores
constexpr int STAGES = 2;
constexpr int NT = 4;           // n8 tiles a warp: 32 columns of P
constexpr int LDK = KS + 4;     // K-major slices (C B^T, c): [MAX_CHUNK][LDK]
constexpr int LDB = MAX_N + 8;  // b slices, rows j: [KS][LDB]
constexpr int STAGE_FLOATS = MAX_CHUNK * LDK > KS * LDB ? MAX_CHUNK * LDK : KS * LDB;
static_assert((LDK / 4) % 2 == 1 && LDB % 32 == 8, "bank-free fragment loads");

// A block of WC warps along P (32 columns each) by 8 along the chunk (16
// rows each).
template <int WC>
struct Geometry {
  static constexpr int THREADS = 256 * WC;
  static constexpr int MIN_BLOCKS = 2 / WC;  // at most 128 registers a thread
  static constexpr int PC = 32 * WC;         // columns of P a block
  static constexpr int LDX = PC + 8;         // rows of X (x's type) and of S (fp32)
  static constexpr int FIXED_BYTES = (STAGES * STAGE_FLOATS + MAX_N * LDX + 6 * MAX_CHUNK) * 4;
  static_assert(LDX % 32 == 8, "bank-free fragment loads");
};

__host__ __device__ constexpr int x_rows(int chunk) { return (chunk + KS - 1) / KS * KS; }

// Shared memory of a block: the ring, S, the chunk vectors, two X buffers.
template <typename XT, int WC>
__host__ __device__ constexpr int smem_bytes(int chunk) {
  return Geometry<WC>::FIXED_BYTES +
         2 * x_rows(chunk) * Geometry<WC>::LDX * static_cast<int>(sizeof(XT));
}

struct ScanArgs {
  const void* x;
  const float* dt;
  const float* g;
  const float* b;
  const float* c;
  const float* cb;  // (B, nch, chunk, ldcb), from ssd_cb_kernel
  float* y;
  float* state;
  int B, S, H, P, N, chunk, nch, ldcb;
  int xvec;  // 1 when x's rows allow 16-byte copies
  int yvec;  // 1 when y and the state allow 8-byte stores
};

// Where the block is in its walk: chunk z, slice q of it.  A chunk runs
// nj intra slices, ni inter slices (none in chunk 0), then nj state slices.
struct Cursor {
  int z, q, len, nj, ni, n;
  __device__ __forceinline__ void at(int z_, const ScanArgs& p) {
    z = z_;
    q = 0;
    len = min(p.chunk, p.S - z * p.chunk);
    nj = (len + KS - 1) / KS;
    ni = z > 0 ? (p.N + KS - 1) / KS : 0;
    n = 2 * nj + ni;
  }
  __device__ __forceinline__ void next(const ScanArgs& p) {
    if (++q == n) at(z + 1, p);
  }
};

// Copies a ROWS x COLS slice (row stride ld floats in memory, LD in shared
// memory); entries at rows >= rows or columns >= cols fill zeros (source
// size 0: nothing is read).  W = 4 floats a copy (16-byte cp.async.cg) or 1.
template <int ROWS, int COLS, int LD, bool VEC, int THREADS>
__device__ __forceinline__ void load_slice(float* dst, const float* src, size_t ld, int rows,
                                           int cols) {
  constexpr int W = VEC ? 4 : 1;
  constexpr int CPR = COLS / W;
  constexpr int TOTAL = ROWS * CPR;
  static_assert(TOTAL % THREADS == 0, "slice must tile the block");
#pragma unroll 4
  for (int k = 0; k < TOTAL / THREADS; ++k) {
    const int e = threadIdx.x + k * THREADS;
    const int r = e / CPR, col = (e % CPR) * W;
    const int left = r < rows ? cols - col : 0;
    const int bytes = (left <= 0 ? 0 : (left >= W ? W : left)) * 4;
    const float* from = bytes ? src + r * ld + col : src;
    if (VEC)
      cp_async16(dst + r * LD + col, from, bytes);
    else
      cp_async4(dst + r * LD + col, from, bytes);
  }
}

// X element as a TF32 operand: bf16 is exact (hi = x, lo = 0); fp32 splits.
__device__ __forceinline__ void x_operand(__nv_bfloat16 v, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(__bfloat162float(v));
  lo = 0u;
}
__device__ __forceinline__ void x_operand(float v, uint32_t& hi, uint32_t& lo) {
  split_tf32(v, hi, lo);
}

template <typename XT>
__device__ __forceinline__ XT zero_x();
template <>
__device__ __forceinline__ float zero_x<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero_x<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

// B fragments of the warp's NT n8 tiles of a row-major B (X or S), rows
// k0 + t and k0 + t + 4: at points at B[k0 + t][w0 + g].
template <int LD, typename T>
__device__ __forceinline__ void b_fragments(const T* at, uint32_t (&bhi)[NT][2],
                                            uint32_t (&blo)[NT][2]) {
#pragma unroll
  for (int jn = 0; jn < NT; ++jn) {
    x_operand(at[jn * 8], bhi[jn][0], blo[jn][0]);
    x_operand(at[4 * LD + jn * 8], bhi[jn][1], blo[jn][1]);
  }
}

// part[jn] += A B over the warp's NT n8 tiles by 3xTF32 from the split
// operands: small terms first, consecutive mmas on different accumulators.
// B_EXACT: B's low parts are zero (bf16 x), so a_hi * b_lo is dropped.
template <bool B_EXACT>
__device__ __forceinline__ void mma_tiles(float (&part)[NT][4], const uint32_t (&ahi)[4],
                                          const uint32_t (&alo)[4],
                                          const uint32_t (&bhi)[NT][2],
                                          const uint32_t (&blo)[NT][2]) {
#pragma unroll
  for (int jn = 0; jn < NT; ++jn) mma_tf32(part[jn], alo, bhi[jn], part[jn]);
  if (!B_EXACT) {
#pragma unroll
    for (int jn = 0; jn < NT; ++jn) mma_tf32(part[jn], ahi, blo[jn], part[jn]);
  }
#pragma unroll
  for (int jn = 0; jn < NT; ++jn) mma_tf32(part[jn], ahi, bhi[jn], part[jn]);
}

template <typename XT, bool VEC, int WC>
__global__ void __launch_bounds__(Geometry<WC>::THREADS, Geometry<WC>::MIN_BLOCKS)
    ssd_scan_kernel(ScanArgs p) {
  using Geo = Geometry<WC>;
  constexpr int THREADS = Geo::THREADS, PC = Geo::PC, LDX = Geo::LDX;
  constexpr bool X_EXACT = sizeof(XT) == 2;  // bf16 x: its low part is zero
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                               // STAGES x STAGE_FLOATS
  float* Ss = ring + STAGES * STAGE_FLOATS;         // [MAX_N][LDX]   S_prev
  float* dts = Ss + MAX_N * LDX;                    // [2][MAX_CHUNK] dt
  float* Gs = dts + 2 * MAX_CHUNK;                  // [2][MAX_CHUNK] G
  float* ws = Gs + 2 * MAX_CHUNK;                   // [MAX_CHUNK]    dt_j e^{G_last - G_j}
  float* eGs = ws + MAX_CHUNK;                      // [MAX_CHUNK]    e^{G_i}
  XT* Xs = reinterpret_cast<XT*>(eGs + MAX_CHUNK);  // [2][xr][LDX]   X

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;  // mma group id
  const int t = lane & 3;   // thread in group
  const int m0 = (warp & 7) * 16;   // this warp's rows of y (i) and of the state (n)
  const int w0 = (warp >> 3) * 32;  // and its columns in the block's PC
  const int p0 = blockIdx.x * PC;
  const int h = blockIdx.y;
  const int bi = blockIdx.z;
  const int z_first = 0, z_end = p.nch;  // the chunks this block walks
  const int N = p.N;
  const int pc = min(PC, p.P - p0);  // this block's columns of P
  const int xr = x_rows(p.chunk);
  const XT* x = static_cast<const XT*>(p.x);
  const size_t x_ld = static_cast<size_t>(p.H) * p.P;

  for (int e = tid; e < MAX_N * LDX; e += THREADS) Ss[e] = 0.f;

  // x, dt and G of chunk z into buffer z & 1.  x: 16-byte copies where its
  // rows allow them, else plain loads and stores (complete before the
  // barrier that precedes the chunk).
  auto load_vectors = [&](int z) {
    const int c0 = z * p.chunk;
    const int len = min(p.chunk, p.S - c0);
    const size_t row0 = static_cast<size_t>(bi) * p.S + c0;
    XT* xs = Xs + (z & 1) * xr * LDX;
    const XT* xg = x + (row0 * p.H + h) * p.P + p0;
    if (p.xvec) {
      constexpr int E = 16 / sizeof(XT);  // elements a copy
      constexpr int CPR = PC / E;
      for (int e = tid; e < xr * CPR; e += THREADS) {
        const int r = e / CPR, col = (e % CPR) * E;
        const bool ok = r < len && col < pc;
        cp_async16(reinterpret_cast<float*>(xs + r * LDX + col),
                   reinterpret_cast<const float*>(ok ? xg + r * x_ld + col : xg), ok ? 16 : 0);
      }
    } else {
      for (int e = tid; e < xr * PC; e += THREADS) {
        const int r = e / PC, col = e % PC;
        xs[r * LDX + col] = r < len && col < pc ? xg[r * x_ld + col] : zero_x<XT>();
      }
    }
    for (int j = tid; j < 2 * MAX_CHUNK; j += THREADS) {
      const int jj = j % MAX_CHUNK;
      if (jj >= xr) continue;
      const float* src = (j < MAX_CHUNK ? p.dt : p.g) + (row0 * p.H + h);
      const bool ok = jj < len;
      cp_async4((j < MAX_CHUNK ? dts : Gs) + (z & 1) * MAX_CHUNK + jj,
                ok ? src + static_cast<size_t>(jj) * p.H : src, ok ? 4 : 0);
    }
  };

  // Slice (z, q) of the walk into ring stage `stage`.
  auto load = [&](const Cursor& cu, int stage) {
    float* dst = ring + stage * STAGE_FLOATS;
    const size_t row0 = static_cast<size_t>(bi) * p.S + static_cast<size_t>(cu.z) * p.chunk;
    if (cu.q < cu.nj) {  // C B^T[:, KS s ..]
      const int s = cu.q;
      const float* src = p.cb + (static_cast<size_t>(bi) * p.nch + cu.z) * p.chunk * p.ldcb;
      load_slice<MAX_CHUNK, KS, LDK, true, THREADS>(dst, src + s * KS, p.ldcb, cu.len,
                                                     cu.len - s * KS);
    } else if (cu.q < cu.nj + cu.ni) {  // c[:, KS s ..]
      const int s = cu.q - cu.nj;
      load_slice<MAX_CHUNK, KS, LDK, VEC, THREADS>(dst, p.c + row0 * N + s * KS, N, cu.len,
                                                    N - s * KS);
    } else {  // b[KS s .., :]
      const int s = cu.q - cu.nj - cu.ni;
      load_slice<KS, MAX_N, LDB, VEC, THREADS>(dst, p.b + (row0 + s * KS) * N, N,
                                                cu.len - s * KS, N);
    }
  };

  float st[NT][4];   // the state: rows m0 + g (+ 8), columns 2t, 2t + 1 of each n8 tile
  float acc[NT][4];  // the chunk's y, then its state increment
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int v = 0; v < 4; ++v) st[j][v] = 0.f;

  Cursor cons, prod;
  cons.at(z_first, p);
  prod.at(z_first, p);
  load_vectors(z_first);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (prod.z < z_end) {
      load(prod, s);
      prod.next(p);
    }
    cp_async_commit();
  }

  for (int k = 0; cons.z < z_end; ++k) {
    cp_async_wait<STAGES - 2>();  // slice k (and its chunk's vectors) landed for this thread ...
    __syncthreads();              // ... and for all; slice k-1's stage is free again
    const int buf = cons.z & 1;
    const float* dtc = dts + buf * MAX_CHUNK;
    const float* Gc = Gs + buf * MAX_CHUNK;
    if (cons.q == 0) {
      // Chunk start: the previous chunk is done with ws, eGs and the other
      // buffers, so its successor's vectors may load there.
      const float g_last = Gc[cons.len - 1];
      for (int j = tid; j < MAX_CHUNK; j += THREADS) {
        const bool ok = j < cons.len;
        ws[j] = ok ? dtc[j] * expf(g_last - Gc[j]) : 0.f;
        eGs[j] = ok ? expf(Gc[j]) : 0.f;
      }
      if (cons.z + 1 < z_end) load_vectors(cons.z + 1);
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[j][v] = 0.f;
    }
    if (prod.z < z_end) {
      load(prod, (k + STAGES - 1) % STAGES);
      prod.next(p);
    }
    cp_async_commit();

    const float* sl = ring + (k % STAGES) * STAGE_FLOATS;
    const XT* xs = Xs + buf * xr * LDX;
    const int len = cons.len;
    // Each KD-deep part of the slice sums into `part` from zero on the
    // tensor cores; fp32 adds carry it into acc after its last k8 step.
    float part[NT][4];
    auto carry = [&]() {
#pragma unroll
      for (int jn = 0; jn < NT; ++jn)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          acc[jn][v] += part[jn][v];
          part[jn][v] = 0.f;
        }
    };
#pragma unroll
    for (int jn = 0; jn < NT; ++jn)
#pragma unroll
      for (int v = 0; v < 4; ++v) part[jn][v] = 0.f;

    if (cons.q < cons.nj) {
      // intra: M = (C B^T) . L . dt of rows m0 .. m0 + 15, columns j0 .. j0 + 7
      // of each k8 step at or below the diagonal, times X.
      const int s = cons.q;
#pragma unroll
      for (int kk = 0; kk < KS; kk += 8) {
        const int j0 = s * KS + kk;
        if (m0 >= len || j0 > m0 + 15 || j0 >= len) break;
        uint32_t ahi[4], alo[4];
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int i = m0 + g + (v & 1) * 8;
          const int j = j0 + t + (v >> 1) * 4;
          const float e = j <= i && i < len ? Gc[i] - Gc[j] : -INFINITY;  // masked before expf
          split_tf32(sl[i * LDK + kk + t + (v >> 1) * 4] * expf(e) * dtc[j], ahi[v], alo[v]);
        }
        uint32_t bhi[NT][2], blo[NT][2];
        b_fragments<LDX>(xs + (j0 + t) * LDX + w0 + g, bhi, blo);
        mma_tiles<X_EXACT>(part, ahi, alo, bhi, blo);
        if (kk % KD == KD - 8) carry();
      }
    } else if (cons.q < cons.nj + cons.ni) {
      // inter: (C . e^G) S_prev over n = KS s .. KS s + KS - 1.
      const int s = cons.q - cons.nj;
#pragma unroll
      for (int kk = 0; kk < KS; kk += 8) {
        const int n0 = s * KS + kk;
        if (m0 >= len || n0 >= N) break;
        uint32_t ahi[4], alo[4];
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int i = m0 + g + (v & 1) * 8;
          split_tf32(sl[i * LDK + kk + t + (v >> 1) * 4] * eGs[i], ahi[v], alo[v]);
        }
        uint32_t bhi[NT][2], blo[NT][2];
        b_fragments<LDX>(Ss + (n0 + t) * LDX + w0 + g, bhi, blo);
        mma_tiles<false>(part, ahi, alo, bhi, blo);
        if (kk % KD == KD - 8) carry();
      }
    } else {
      // state increment: (B . w)^T X over j = KS s .. KS s + KS - 1, rows n
      // of this warp.
      const int s = cons.q - cons.nj - cons.ni;
#pragma unroll
      for (int kk = 0; kk < KS; kk += 8) {
        const int j0 = s * KS + kk;
        if (m0 >= N || j0 >= len) break;
        uint32_t ahi[4], alo[4];
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int jr = kk + t + (v >> 1) * 4;
          split_tf32(sl[jr * LDB + m0 + g + (v & 1) * 8] * ws[s * KS + jr], ahi[v], alo[v]);
        }
        uint32_t bhi[NT][2], blo[NT][2];
        b_fragments<LDX>(xs + (j0 + t) * LDX + w0 + g, bhi, blo);
        mma_tiles<X_EXACT>(part, ahi, alo, bhi, blo);
        if (kk % KD == KD - 8) carry();
      }
    }
    carry();  // a part the slice's guards cut short

    if (cons.q == cons.nj + cons.ni - 1) {
      // y of the chunk is complete: store rows < len, columns < P; then
      // acc starts the state increment.
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = m0 + g + r * 8;
        if (i >= len) continue;
        float* yrow = p.y + ((static_cast<size_t>(bi) * p.S + cons.z * p.chunk + i) * p.H + h) *
                                p.P + p0;
#pragma unroll
        for (int jn = 0; jn < NT; ++jn) {
          const int col = w0 + jn * 8 + 2 * t;
          if (p.yvec && col + 1 < pc) {
            *reinterpret_cast<float2*>(yrow + col) = make_float2(acc[jn][2 * r], acc[jn][2 * r + 1]);
          } else {
            if (col < pc) yrow[col] = acc[jn][2 * r];
            if (col + 1 < pc) yrow[col + 1] = acc[jn][2 * r + 1];
          }
        }
      }
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[j][v] = 0.f;
    } else if (cons.q == cons.n - 1) {
      // S = e^{G_last} S + inc in fp32; the other warps read it next chunk.
      const float decay = expf(Gc[len - 1]);
#pragma unroll
      for (int jn = 0; jn < NT; ++jn) {
#pragma unroll
        for (int v = 0; v < 4; ++v) st[jn][v] = fmaf(decay, st[jn][v], acc[jn][v]);
#pragma unroll
        for (int r = 0; r < 2; ++r)
          *reinterpret_cast<float2*>(Ss + (m0 + g + r * 8) * LDX + w0 + jn * 8 + 2 * t) =
              make_float2(st[jn][2 * r], st[jn][2 * r + 1]);
      }
    }
    cons.next(p);
  }
  cp_async_wait<0>();

  // The final state: rows n < N, columns < P.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int n = m0 + g + r * 8;
    if (n >= N) continue;
    float* srow = p.state + ((static_cast<size_t>(bi) * p.H + h) * N + n) * p.P + p0;
#pragma unroll
    for (int jn = 0; jn < NT; ++jn) {
      const int col = w0 + jn * 8 + 2 * t;
      if (p.yvec && col + 1 < pc) {
        *reinterpret_cast<float2*>(srow + col) = make_float2(st[jn][2 * r], st[jn][2 * r + 1]);
      } else {
        if (col < pc) srow[col] = st[jn][2 * r];
        if (col + 1 < pc) srow[col + 1] = st[jn][2 * r + 1];
      }
    }
  }
}

// The variant's slots 3-5: the scan kernel's template arguments (x bf16,
// VEC, WC) after the C B^T kernel's three.
template <typename XT, bool VEC, int WC>
int launch_scan(const ScanArgs& a, int* variant, cudaStream_t stream) {
  using Geo = Geometry<WC>;
  if (variant != nullptr) {
    variant[3] = sizeof(XT) == 2;
    variant[4] = VEC;
    variant[5] = WC;
  }
  constexpr auto kernel = ssd_scan_kernel<XT, VEC, WC>;
  const cudaError_t err = allow_smem<kernel>(smem_bytes<XT, WC>(MAX_CHUNK));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.P + Geo::PC - 1) / Geo::PC, a.H, a.B);
  const int bytes = smem_bytes<XT, WC>(a.chunk);
  kernel<<<grid, Geo::THREADS, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Two warps along P, 64 columns a block, read each chunk's C B^T, b and c
// tiles once for twice the columns; one warp gives twice the blocks.  Two
// while their blocks cover more than half the SMs (measured at mamba2-370m's
// prefill, 128 blocks, and at half its batch, 64: PERF.md).
template <typename XT, bool VEC>
int launch_scan(const ScanArgs& a, int* variant, cudaStream_t stream) {
  const long long wide_blocks = static_cast<long long>(a.B) * a.H * ((a.P + 63) / 64);
  return 2 * wide_blocks > tc::SMS ? launch_scan<XT, VEC, 2>(a, variant, stream)
                                   : launch_scan<XT, VEC, 1>(a, variant, stream);
}

int launch_all(const ScanArgs& a, int x_bf16, int* variant, cudaStream_t stream) {
  // C B^T: A(i, k) = c[i, k], B(k, j) = b[j, k], members (batch row, chunk)
  // placed by the kernel itself (a_batch and b_batch unused).
  tc::Args cb{};
  cb.a = a.c;
  cb.b = a.b;
  cb.c = const_cast<float*>(a.cb);
  cb.M = a.chunk;
  cb.N = a.chunk;
  cb.K = a.N;
  cb.lda = a.N;
  cb.ldb = a.N;
  cb.ldc = a.ldcb;
  cb.c_batch = static_cast<long long>(a.chunk) * a.ldcb;
  cb.alpha = 1.f;
  cb.m_fast = 1;
  tc::set_out_vec(cb);
  const bool vec = tc::rows_aligned16(cb);
  const CbGeom geo{a.S, a.nch, a.chunk};
  const int L = a.B * a.nch;
  int tile = tc::pick_tile(cb, L);
  if (!vec && tile == 64064) tile = 64032;  // 64 x 64 with 4-byte copies spilled
  int rc;
  switch (tile) {
    case 64064:
      rc = launch_cb<64, 64, true>(cb, geo, L, variant, stream);
      break;
    case 64032:
      rc = vec ? launch_cb<64, 32, true>(cb, geo, L, variant, stream)
               : launch_cb<64, 32, false>(cb, geo, L, variant, stream);
      break;
    default:
      rc = vec ? launch_cb<32, 32, true>(cb, geo, L, variant, stream)
               : launch_cb<32, 32, false>(cb, geo, L, variant, stream);
  }
  if (rc != 0) return rc;
  if (x_bf16)
    return vec ? launch_scan<__nv_bfloat16, true>(a, variant, stream)
               : launch_scan<__nv_bfloat16, false>(a, variant, stream);
  return vec ? launch_scan<float, true>(a, variant, stream)
             : launch_scan<float, false>(a, variant, stream);
}

}  // namespace

// x (B, S, H, P) fp32 or bf16 (x_bf16 != 0), dt and g (B, S, H), b and c
// (B, S, N) fp32; cb a workspace of B * ceil(S / chunk) * chunk * ldcb
// floats, ldcb = chunk rounded up to a multiple of 4; y (B, S, H, P) and
// state (B, H, N, P) fp32.  All contiguous on the device; chunk <= 128,
// N <= 128, P <= 64.  Returns cudaGetLastError() of the two launches (0 on
// success): a refused launch never runs, so the caller must check the code.
extern "C" int ssd_scan(const void* x, const float* dt, const float* g, const float* b,
                        const float* c, float* cb, float* y, float* state, int B, int S, int H,
                        int P, int N, int chunk, int x_bf16, int* variant, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || P > MAX_P || N <= 0 || N > MAX_N ||
      chunk <= 0 || chunk > MAX_CHUNK || B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nch = (S + chunk - 1) / chunk;
  if (static_cast<long long>(B) * nch > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const size_t xsize = x_bf16 ? 2 : 4;
  const int xvec = (P * xsize) % 16 == 0 && tc::aligned(x, 16);
  const int yvec = P % 2 == 0 && tc::aligned(y, 8) && tc::aligned(state, 8);
  const ScanArgs a{x, dt, g, b, c, cb, y, state, B, S, H, P, N, chunk, nch, (chunk + 3) / 4 * 4,
                   xvec, yvec};
  return launch_all(a, x_bf16, variant, static_cast<cudaStream_t>(stream));
}
