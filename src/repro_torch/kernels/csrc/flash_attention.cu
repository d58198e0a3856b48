// Causal GQA flash attention, forward only, fp32 accurate on the tensor cores
// by 3xTF32, for fp32, bf16 and fp16 q, k, v:
//   o = softmax(q k^T * scale) v   over q (B, S, H, D), k/v (B, T, KV, D)
//
// Replaces the Pallas kernel _flash_kernel / flash_attention
// (src/repro/kernels/flash_attention.py:35, :88), which the JAX package runs
// for attn_impl="pallas".  It computes what that kernel computes: every
// block cast to fp32, a running max m, denominator l and accumulator per
// query row over the kv blocks, P kept in fp32, the reference's -1e30 mask
// value and its max(l, 1e-30) in the denominator, the output rounded to
// q's dtype only at the store, the causal row offset T - S (the S queries
// are the last S positions of the T keys), GQA by reading kv head
// h / (H / KV) with no repeated K/V, and kv blocks wholly above the
// diagonal skipped.  Unlike the Pallas kernel it takes ragged S and T: rows
// past S are not stored and columns past T are masked like the causal ones.
//
// Bound on the H100: the causal pairs need 4 * D flops each (q k and p v).
// fp32: 3xTF32 issues three TF32 products per fp32 one, so the least time
// is max(3 * flops / 495 TFLOP/s, bytes / 3.35 TB/s).  At llama-130m's
// prefill, q/k/v (8, 1024, 12, 64), that is 12.9 GFLOP executed three
// times on 100.7 MB: 0.0782 ms, bound by operations (0.1925 ms by fp32 SIMT
// FMA).  bf16 and fp16 values are exact in TF32 (8 and 10 mantissa bits,
// inside its exponent range), so the low part of q, k and v is zero: q k
// takes one TF32 product and p v two (P's high and low parts times V), 1.5x
// the flops in all.  At chatglm3-6b's prefill, q (4, 2048, 32, 128) and k/v
// (4, 2048, 2, 128) bf16, that is 137.5 GFLOP executed 1.5 times on
// 142.6 MB: 0.417 ms by operations (0.043 ms by bytes).  A native bf16
// m16n8k16 product for q k would be exact too, at twice TF32's rate; the
// TF32 product keeps one fragment layout, one code path for bf16 and fp16
// and the fp32 kernel's order of sums.
//
// Design.  A 128-thread block owns a 64-row q tile of one (b, h); each of its
// four warps owns 16 query rows and loops over the 32-row kv tiles, so the
// running state never leaves registers.  Against the four limits of the
// fp32 SIMT kernel this replaces:
//  1. Tensor cores.  Both products are mma.sync.m16n8k8 TF32 with fp32
//     accumulation, each fp32 operand split as it is read (tf32x3.cuh); a
//     16-bit element becomes its exact TF32 pattern (bf16: a shift) and its
//     zero low-part products are skipped.  The accumulator truncates each
//     add toward zero, so a long sum drifts:
//     each kv tile's scores sum on the tensor cores in 32-deep slices from
//     zero, the slices added in fp32, as the GEMM core's do (at D = 128 one
//     128-deep sum left the output 1.4x farther from fp64 than the fp32
//     plain path: tools/flash_attention_seed_sweep.py, and the model in
//     tests/test_torch_tf32x3.py), and its P V, 32 deep, from zero; acc =
//     alpha * acc + (P V of the tile) carries the output in fp32, as the
//     Pallas kernel's scratch does.  The slice's accumulator is live only
//     while the scores form, when P V's is not.  Q's fragments are read
//     from shared memory and split again at every tile: held split in
//     registers (with 64-row kv tiles) they took the kernel to 239 registers
//     at D = 64 and two blocks an SM; re-read, it needs 128, and four blocks
//     (16 warps) fit an SM in registers and in shared memory (52 KB a block
//     at D = 64 in fp32), which measured faster (PERF.md).  expf, not
//     __expf: the kernel is held to the fp32 reference.
//  2. Loads overlap compute.  K and V tiles come through a ring of two
//     stages in dynamic shared memory, filled by cp.async, in the operands'
//     own element type (a 16-bit tile takes half the bytes: 52 KB a block
//     at D = 128): 16-byte cp.async.cg where every base pointer is 16-byte
//     aligned and rows are whole 16-byte chunks, else 8- or 4-byte
//     cp.async.ca, the source size 0 past a ragged T or past D so the copy
//     fills zeros.  The 16-byte copies are an instantiation of their own
//     (V16): with the width tested at run time for every row the fp32
//     kernel ran 2-3% slower than the fp32-only kernel before it and the
//     bf16 one 13% slower than this (tools/flash_attention_variants.py,
//     PERF.md).  Tile j+1 loads while tile j computes; one __syncthreads a
//     tile.  Each thread keeps one 16-byte column chunk and every RS-th
//     row, so a copy costs no division; where a row's chunks do not divide
//     the block's threads (D padded to 192: 48 chunks a row in fp32, 24 in
//     16-bit) it keeps three chunks, a third of a row apart (16 or 8
//     threads a row; a warp's copies stay contiguous).
//     D is padded in shared memory to 16, 32, 64, 128, 192 or 256 with zeros
//     (written once), so a k8 step never reads past the head.
//  3. P stays in registers.  The score fragment c0, c1 (row g, columns 2t,
//     2t+1; c2, c3 eight rows down) gives each thread two rows, so row max
//     and row sum are two xor shuffles within the four threads of a group.
//     P V wants A fragments at columns t and t+4; a sum over k does not
//     depend on its order, so A's k index t reads column 2t and t+4 reads
//     2t+1 (a0 = c0, a1 = c2, a2 = c1, a3 = c3), and V's B fragment reads kv
//     rows 2t and 2t+1 in the same order.  No shared round trip, no barrier.
//     16-bit Q K^T takes the same order along d, so a0/a2 of Q and b0/b1 of
//     K are one 32-bit shared load each.  Above D_pad 128 the accumulator
//     alone takes KD * 4 registers a thread (96 at 192, 128 at 256), and a
//     tile's P V beside it as many again: P V forms PG = 8 column tiles at a
//     time, each group folded into the accumulator before the next starts
//     (P split again for each group from the scores, 16 registers, not
//     kept split, 32).  A column tile's sum runs over the same kv rows in
//     the same order in either form, so the result is the same bits.
//  4. Mask only where needed.  A warp skips the mask test on kv tiles that
//     lie wholly at or below its rows' diagonal and inside T, and skips the
//     products of tiles wholly above it (their p would all be 0).
// Shared rows are D_pad + 16 bytes: D_pad / 2 + 4 words (16-bit) or D_pad +
// 4 (fp32), 4 mod 8 at every D_pad, so every fragment load of a warp (Q and
// K along d, V along kv rows 2t, 2t+1) hits distinct banks.  The grid's slowest axis
// walks the q tiles from the last (the longest causal loop) to the first,
// so the long tiles of every head start first.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

using namespace repro_torch;

constexpr int BQ = 64;       // query rows per block, 16 per warp
constexpr int BKV = 32;      // kv rows a tile
constexpr int KSL = 4;       // k8 steps of a slice of Q K^T (32 deep)
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int STAGES = 2;    // K/V tiles in the ring
constexpr float NEG_INF = -1e30f;  // the reference's mask value

// Element types by the C entry's code: 0 fp32, 1 bf16, 2 fp16.  A 16-bit
// element is kept as its bits (uint16_t) in shared memory and converted as
// a fragment reads it.
template <int EC>
struct Elem {
  using S = uint16_t;
};
template <>
struct Elem<0> {
  using S = float;
};

struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, S, T, H, KV, D;
  float scale;
  int causal;
  int cw;    // bytes a cp.async copies: 16, 8 or 4
  int pair;  // 1 when o is aligned for a store of two elements
};

// Shapes of one instantiation: DP = D padded (16, 32, 64, 128, 192 or 256).
template <int EC, int DP>
struct Layout {
  using S = typename Elem<EC>::S;
  static constexpr int EB = sizeof(S);
  static constexpr int LD = DP + 16 / EB;  // shared row stride, elements
  static constexpr int KD = DP / 8;        // k8 steps of Q K^T, n8 tiles of P V
  static constexpr int EPC = 16 / EB;      // elements of a 16-byte chunk
  static constexpr int CPR = DP / EPC;     // chunks a row
  static constexpr int Q_ELEMS = BQ * LD;
  static constexpr int KV_ELEMS = BKV * LD;
  static constexpr int STAGE_ELEMS = 2 * KV_ELEMS;  // K tile, then V tile
  static constexpr int SMEM_BYTES = (Q_ELEMS + STAGES * STAGE_ELEMS) * EB;
  // Blocks an SM the registers must allow (ptxas then uses at most 128 a
  // thread at D <= 64, with no spills).  Above D_pad 128 shared memory sets
  // it: one fp32 block (147 KB at 192, 195 KB at 256) or two 16-bit ones
  // (75 KB, 99 KB) fit an SM's 228 KB.
  static constexpr int MIN_BLOCKS = DP <= 64 ? 4 : DP <= 128 || EC != 0 ? 2 : 1;
  // Column tiles of P V formed at a time (see the design note, item 3).
  static constexpr int PG = DP <= 128 ? KD : 8;
  // 16-byte chunks of a row a thread copies (load_rows): one where a row's
  // chunks divide the block's threads, else three (D_pad 192: 48 chunks a
  // row in fp32, 24 in 16-bit, so 16 or 8 threads a row).
  static constexpr int CPT = THREADS % CPR == 0 ? 1 : 3;
  static_assert(CPR % CPT == 0 && THREADS % (CPR / CPT) == 0, "chunk groups must tile rows");
  static_assert((LD * EB / 4) % 8 == 4, "fragment loads must hit distinct banks");
  static_assert(KD % PG == 0, "P V's column groups must tile the head");
  static_assert(SMEM_BYTES <= 227 * 1024, "a block's shared memory");
};

// Copies ROWS rows of D elements (rows `stride` elements apart in memory)
// into shared rows LD elements apart, in 16-byte chunks of CPR a row: with
// TPR = CPR / CPT threads a row, thread tid keeps the CPT chunks tid % TPR
// + k TPR (c0 the first's column) of rows r0 = tid / TPR, r0 + RS, ...
// below ROWS, so a warp's copies of one k are contiguous in memory.  A
// chunk is one 16-byte copy (V16), else copies of cw bytes (8 or 4); a copy
// of a row at or past rows_left, or of columns at or past D, fills zeros
// (source size 0), and a chunk wholly past D is not copied (padding).
template <int ROWS, int LD, int CPR, int CPT, bool V16, typename S>
__device__ __forceinline__ void load_rows(S* dst, const S* src, size_t stride, int rows_left,
                                          int D, int c0, int r0, int cw) {
  constexpr int RS = THREADS / (CPR / CPT);  // rows a pass (above ROWS: 16-bit, D_pad 16)
  constexpr int EB = sizeof(S), EPC = 16 / EB;
  static_assert(ROWS % RS == 0 || RS % ROWS == 0, "rows must tile the block");
#pragma unroll
  for (int i = 0; i < (ROWS + RS - 1) / RS; ++i) {
    const int r = r0 + i * RS;
    if (RS > ROWS && r >= ROWS) break;
    const bool ok = r < rows_left;
#pragma unroll
    for (int c = c0; c < c0 + CPR * EPC; c += CPR / CPT * EPC) {
      if (CPT > 1 && c >= D) break;  // CPT = 1: the caller skips chunks past D
      const S* from = ok ? src + r * stride + c : src;
      S* to = dst + r * LD + c;
      if constexpr (V16) {
        cp_async16(to, from, ok ? 16 : 0);
      } else {
        const int n = cw / EB;  // elements a copy
        for (int e = 0; e < EPC; e += n) {
          const bool in = ok && c + e < D;
          if (cw == 8)
            cp_async8(to + e, in ? from + e : src, in ? 8 : 0);
          else
            cp_async4(to + e, in ? from + e : src, in ? 4 : 0);
        }
      }
    }
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// A 16-bit element's exact TF32 pattern (its fp32 bits): bf16 by a shift,
// fp16 by the conversion.
template <int EC>
__device__ __forceinline__ uint32_t tf32_of(uint16_t h) {
  if constexpr (EC == 1) return static_cast<uint32_t>(h) << 16;
  return __float_as_uint(__half2float(__ushort_as_half(h)));
}

// The two 16-bit elements of one 32-bit word (lower address first).
template <int EC>
__device__ __forceinline__ void tf32_of_pair(uint32_t w, uint32_t& first, uint32_t& second) {
  first = tf32_of<EC>(static_cast<uint16_t>(w & 0xffffu));
  second = tf32_of<EC>(static_cast<uint16_t>(w >> 16));
}

// Two fp32 outputs rounded to nearest even in the element type, packed into
// one word (the first at the lower address).
template <int EC>
__device__ __forceinline__ uint32_t pack_pair(float a, float b) {
  if constexpr (EC == 1) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    return *reinterpret_cast<const uint32_t*>(&h);
  } else {
    const __half2 h = __floats2half2_rn(a, b);
    return *reinterpret_cast<const uint32_t*>(&h);
  }
}

template <int EC, int DP, bool V16>
__global__ void __launch_bounds__(THREADS, Layout<EC, DP>::MIN_BLOCKS)
    flash_attention_kernel(FlashArgs p) {
  using L = Layout<EC, DP>;
  using S = typename L::S;
  constexpr bool EXACT = EC != 0;  // 16-bit q, k, v: their low TF32 parts are zero
  constexpr int LD = L::LD, KD = L::KD, PG = L::PG, NS = BKV / 8;  // NS: n8 tiles of the scores
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S* smem = reinterpret_cast<S*>(smem_raw);
  S* Qs = smem;                   // [BQ][LD]
  S* ring = smem + L::Q_ELEMS;    // STAGES x ([BKV][LD] K, [BKV][LD] V)

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;  // mma group id
  const int t = lane & 3;   // thread in group
  const int D = p.D;
  const int nq = (p.S + BQ - 1) / BQ;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.z)) * BQ;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int kvh = h / (p.H / p.KV);
  const int offset = p.T - p.S;  // causal row offset for short q
  const size_t q_row = static_cast<size_t>(p.H) * D;    // stride of s in q, o
  const size_t kv_row = static_cast<size_t>(p.KV) * D;  // stride of t in k, v
  const S* qb = static_cast<const S*>(p.q) + (static_cast<size_t>(b) * p.S * p.H + h) * D;
  const S* kb = static_cast<const S*>(p.k) + (static_cast<size_t>(b) * p.T * p.KV + kvh) * D;
  const S* vb = static_cast<const S*>(p.v) + (static_cast<size_t>(b) * p.T * p.KV + kvh) * D;

  // Pad columns of Q and of every ring stage are zero: the copies fill the
  // columns of chunks they copy and never touch the chunks past D.
  if (D < DP) {
    const int pad = DP - D;
    const int rows = BQ + STAGES * 2 * BKV;
    for (int e = tid; e < rows * pad; e += THREADS) smem[(e / pad) * LD + D + e % pad] = S(0);
  }

  // This thread's first copy chunk and first row.
  constexpr int TPR = L::CPR / L::CPT;  // threads a row
  const int c0 = (tid % TPR) * L::EPC;
  const int r0 = tid / TPR;
  const bool copies = c0 < D;  // chunks past D are padding

  // Last kv column any stored row of this block may see, and the tiles.
  const int last_row = min(q0 + BQ, p.S) - 1 + offset;
  const int k_end = p.causal ? min(p.T, last_row + 1) : p.T;
  const int ntiles = (k_end + BKV - 1) / BKV;
  auto load_tile = [&](int j) {
    S* ks = ring + (j % STAGES) * L::STAGE_ELEMS;
    const int kv0 = j * BKV;
    load_rows<BKV, LD, L::CPR, L::CPT, V16>(ks, kb + kv0 * kv_row, kv_row, p.T - kv0, D, c0,
                                            r0, p.cw);
    load_rows<BKV, LD, L::CPR, L::CPT, V16>(ks + L::KV_ELEMS, vb + kv0 * kv_row, kv_row,
                                            p.T - kv0, D, c0, r0, p.cw);
  };
  if (copies) {
    load_rows<BQ, LD, L::CPR, L::CPT, V16>(Qs, qb + q0 * q_row, q_row, p.S - q0, D, c0, r0,
                                           p.cw);
#pragma unroll
    for (int j = 0; j < STAGES - 1; ++j)
      if (j < ntiles) load_tile(j);
  }
  cp_async_commit();

  // This warp's rows: wr0 .. wr0 + 15, of which those below S are stored.
  const int wr0 = q0 + warp * 16;
  const bool warp_rows = wr0 < p.S;
  const int wlast = min(wr0 + 15, p.S - 1) + offset;  // its last row's last key

  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[KD][4];
#pragma unroll
  for (int j = 0; j < KD; ++j)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[j][v] = 0.f;
  const float zero[4] = {0.f, 0.f, 0.f, 0.f};

  for (int it = 0; it < ntiles; ++it) {
    cp_async_wait<STAGES - 2>();  // tile it (and Q) landed for this thread ...
    __syncthreads();              // ... and for all; tile it-1's stage is free
    if (copies && it + STAGES - 1 < ntiles) load_tile(it + STAGES - 1);
    cp_async_commit();

    const int kv0 = it * BKV;
    // Tiles wholly above this warp's diagonal contribute p = 0 exactly.
    if (!warp_rows || (p.causal && kv0 > wlast)) continue;
    const S* Ks = ring + (it % STAGES) * L::STAGE_ELEMS;
    const S* Vs = Ks + L::KV_ELEMS;

    // S = Q K^T in slices of KSL k8 steps, each from zero, added in fp32.
    // Q's A fragment of the warp's 16 rows: a0 (g, t), a1 (g+8, t), a2 (g,
    // t+4), a3 (g+8, t+4); B(k = d, n = kv) = K[kv][d]: b0 (t, g), b1 (t+4, g).
    // 16-bit: k index t reads column 2t and t+4 column 2t+1 of the k8 step,
    // in A and in B alike, so each pair is one 32-bit load.
    float s[NS][4], slice[NS][4];
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      if constexpr (EXACT) {
        uint32_t a[4];
        const S* qr = Qs + (warp * 16 + g) * LD + kk * 8 + 2 * t;
        tf32_of_pair<EC>(*reinterpret_cast<const uint32_t*>(qr), a[0], a[2]);
        tf32_of_pair<EC>(*reinterpret_cast<const uint32_t*>(qr + 8 * LD), a[1], a[3]);
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          uint32_t bk[2];
          tf32_of_pair<EC>(
              *reinterpret_cast<const uint32_t*>(Ks + (j * 8 + g) * LD + kk * 8 + 2 * t),
              bk[0], bk[1]);
          mma_tf32(slice[j], a, bk, kk % KSL == 0 ? zero : slice[j]);
        }
      } else {
        uint32_t ahi[4], alo[4];
#pragma unroll
        for (int v = 0; v < 4; ++v)
          split_tf32(Qs[(warp * 16 + g + (v & 1) * 8) * LD + kk * 8 + t + (v >> 1) * 4],
                     ahi[v], alo[v]);
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          const float* kr = Ks + (j * 8 + g) * LD + kk * 8 + t;
          uint32_t bhi[2], blo[2];
          split_tf32(kr[0], bhi[0], blo[0]);
          split_tf32(kr[4], bhi[1], blo[1]);
          mma_3xtf32(slice[j], ahi, alo, bhi, blo, kk % KSL == 0 ? zero : slice[j]);
        }
      }
      if (kk % KSL == KSL - 1 || kk == KD - 1) {
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int v = 0; v < 4; ++v) s[j][v] = kk < KSL ? slice[j][v] : s[j][v] + slice[j][v];
      }
    }

    // Online softmax over the thread's two rows: r = 0 holds c0, c1 (row
    // g), r = 1 holds c2, c3 (row g + 8).
    const bool mask = (p.causal && kv0 + BKV - 1 > wr0 + offset) || kv0 + BKV > p.T;
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        float x = s[j][v] * p.scale;
        if (mask) {
          const int col = kv0 + j * 8 + 2 * t + (v & 1);
          const int qpos = wr0 + g + (v >> 1) * 8 + offset;
          x = (col < p.T && (!p.causal || col <= qpos)) ? x : NEG_INF;
        }
        s[j][v] = x;
        mx[v >> 1] = fmaxf(mx[v >> 1], x);
      }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]));
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        s[j][v] = expf(s[j][v] - m[v >> 1]);
        sum[v >> 1] += s[j][v];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = fmaf(alpha[r], l[r], quad_sum(sum[r]));

    // P V of this tile, from zero, PG column tiles at a time (all KD up to
    // D_pad 128): k runs over the tile's kv rows in the permuted order (k
    // index t -> row 2t, t+4 -> 2t+1 of each k8 step).  P is fp32 (split);
    // 16-bit V is exact, so P_lo V + P_hi V.
#pragma unroll
    for (int j0 = 0; j0 < KD; j0 += PG) {
      float part[PG][4];
#pragma unroll
      for (int ks = 0; ks < NS; ++ks) {
        uint32_t ahi[4], alo[4];
        split_tf32(s[ks][0], ahi[0], alo[0]);
        split_tf32(s[ks][2], ahi[1], alo[1]);
        split_tf32(s[ks][1], ahi[2], alo[2]);
        split_tf32(s[ks][3], ahi[3], alo[3]);
        const S* vr = Vs + (ks * 8 + 2 * t) * LD + g + j0 * 8;
#pragma unroll
        for (int j = 0; j < PG; ++j) {
          if constexpr (EXACT) {
            const uint32_t bv[2] = {tf32_of<EC>(vr[j * 8]), tf32_of<EC>(vr[LD + j * 8])};
            mma_tf32(part[j], alo, bv, ks == 0 ? zero : part[j]);
            mma_tf32(part[j], ahi, bv, part[j]);
          } else {
            uint32_t bhi[2], blo[2];
            split_tf32(vr[j * 8], bhi[0], blo[0]);
            split_tf32(vr[LD + j * 8], bhi[1], blo[1]);
            mma_3xtf32(part[j], ahi, alo, bhi, blo, ks == 0 ? zero : part[j]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < PG; ++j)
#pragma unroll
        for (int v = 0; v < 4; ++v)
          acc[j0 + j][v] = fmaf(alpha[v >> 1], acc[j0 + j][v], part[j][v]);
    }
  }
  cp_async_wait<0>();

  // o = acc / max(l, 1e-30), rounded to the element type here only: c0, c1
  // at (g, 2t), (g, 2t+1); c2, c3 eight rows down.  D % 4 == 0, so d < D
  // implies d + 1 < D.
  S* ob = static_cast<S*>(p.o) + (static_cast<size_t>(b) * p.S * p.H + h) * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wr0 + g + r * 8;
    if (row >= p.S) continue;
    const float den = fmaxf(l[r], 1e-30f);
    S* orow = ob + row * q_row;
#pragma unroll
    for (int j = 0; j < KD; ++j) {
      const int d = j * 8 + 2 * t;
      if (d >= D) continue;
      const float o0 = acc[j][2 * r] / den, o1 = acc[j][2 * r + 1] / den;
      if constexpr (EXACT) {
        *reinterpret_cast<uint32_t*>(orow + d) = pack_pair<EC>(o0, o1);
      } else if (p.pair) {
        *reinterpret_cast<float2*>(orow + d) = make_float2(o0, o1);
      } else {
        orow[d] = o0;
        orow[d + 1] = o1;
      }
    }
  }
}

bool aligned(const void* ptr, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(ptr) & (bytes - 1)) == 0;
}

template <int EC, int DP, bool V16>
int launch_kernel(const FlashArgs& a, int* variant, cudaStream_t stream) {
  using L = Layout<EC, DP>;
  report_variant(variant, EC, DP, a.cw);
  const cudaError_t err = allow_smem<flash_attention_kernel<EC, DP, V16>>(L::SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(a.H, a.B, (a.S + BQ - 1) / BQ);
  flash_attention_kernel<EC, DP, V16><<<grid, THREADS, L::SMEM_BYTES, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int EC, int DP>
int launch(const FlashArgs& a, int* variant, cudaStream_t stream) {
  return a.cw == 16 ? launch_kernel<EC, DP, true>(a, variant, stream)
                    : launch_kernel<EC, DP, false>(a, variant, stream);
}

template <int EC>
int launch_dp(const FlashArgs& a, int* variant, cudaStream_t stream) {
  if (a.D <= 16) return launch<EC, 16>(a, variant, stream);
  if (a.D <= 32) return launch<EC, 32>(a, variant, stream);
  if (a.D <= 64) return launch<EC, 64>(a, variant, stream);
  if (a.D <= 128) return launch<EC, 128>(a, variant, stream);
  if (a.D <= 192) return launch<EC, 192>(a, variant, stream);
  return launch<EC, 256>(a, variant, stream);
}

}  // namespace

// q (B, S, H, D), k/v (B, T, KV, D), o (B, S, H, D): contiguous on the
// device, all of one element type `dtype` (0 fp32, 1 bf16, 2 fp16), every
// pointer 4-byte aligned; H % KV == 0, D % 4 == 0, D <= 256 (the wrapper
// checks).  The variant reported: (dtype, D padded, copy bytes).
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* o, int B,
                               int S, int T, int H, int KV, int D, float scale, int causal,
                               int dtype, int* variant, void* stream) {
  if (B <= 0 || S <= 0 || T <= 0 || KV <= 0 || H % KV != 0 || D <= 0 || D % 4 != 0 ||
      D > 256 || B > 65535 || (S + BQ - 1) / BQ > 65535 || dtype < 0 || dtype > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const int eb = dtype == 0 ? 4 : 2;
  auto all = [&](uintptr_t bytes) {
    return aligned(q, bytes) && aligned(k, bytes) && aligned(v, bytes) && aligned(o, bytes);
  };
  if (!all(4)) return static_cast<int>(cudaErrorMisalignedAddress);
  // Rows start D * eb bytes apart, so a copy width divides every row's start
  // when it divides the base pointers and D * eb.
  const int cw = all(16) && D * eb % 16 == 0 ? 16 : all(8) && D * eb % 8 == 0 ? 8 : 4;
  const FlashArgs a{q, k, v, o, B, S, T, H, KV, D, scale, causal, cw,
                    aligned(o, 2 * eb) ? 1 : 0};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch_dp<1>(a, variant, s);
  if (dtype == 2) return launch_dp<2>(a, variant, s);
  return launch_dp<0>(a, variant, s);
}
