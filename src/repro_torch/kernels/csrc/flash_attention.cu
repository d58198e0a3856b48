// Causal GQA flash attention, forward only, fp32 inside:
//   o = softmax(q k^T * scale) v   over q (B, S, H, D), k/v (B, T, KV, D)
//
// Replaces the Pallas kernel _flash_kernel / flash_attention
// (src/repro/kernels/flash_attention.py:35, :88), which the JAX package runs
// for attn_impl="pallas".  It computes what that kernel computes: a running
// max m, denominator l and accumulator per query row over the kv blocks, the
// reference's -1e30 mask value and its max(l, 1e-30) in the denominator, the
// causal row offset T - S (the S queries are the last S positions of the T
// keys), GQA by reading kv head h / (H / KV) with no repeated K/V, and kv
// blocks wholly above the diagonal skipped.  Unlike the Pallas kernel it
// takes ragged S and T: rows past S are not stored and columns past T are
// masked like the causal ones.
//
// Design: the TPU runs the kv axis as a sequential grid dimension with the
// running state in VMEM scratch; here one 256-thread block owns a 64-row q
// tile of one (b, h) and loops over the 64-row kv tiles itself, so the state
// never leaves registers.  Thread (ty, tx) = (tid / 16, tid % 16) owns query
// rows ty*4 + {0..3}; for the scores it owns kv columns tx + 16*{0..3}, for
// the output head dims tx + 16*{0..NC-1}.  The 16 threads of a row group
// share a half warp, so row max and row sum are xor shuffles within it.
// Q and K sit in shared memory with rows of D + 4 floats, so a quarter warp's
// float4 reads of K along d hit 32 distinct banks; V and the probability tile
// P are read along their contiguous axis.  Blocks walk the q tiles from the
// last (the longest causal loop) to the first, so the long ones start early.
//
// Bound: at llama-130m's prefill, q/k/v (8, 1024, 12, 64), the causal pairs
// need 4 * D flops each (q k and p v): 12.9 GFLOP on 101 MB, far above the
// fp32 SIMT ridge (20 flops per byte), so fp32 FMA issue bounds it (0.19 ms
// at 67 TFLOP/s).  fmaf in full fp32 and expf (not __expf): the kernel is
// held to the fp32 reference, so no TF32 and no fast math.  Tensor cores,
// TMA and a q tile per warpgroup are left for a later change.
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;    // query rows per block
constexpr int BKV = 64;   // kv rows per tile
constexpr int THREADS = 256;
constexpr float NEG_INF = -1e30f;  // the reference's mask value

struct FlashArgs {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  int B, S, T, H, KV, D;
  float scale;
  int causal;
};

__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// NC = head-dim columns per thread (D <= 16 * NC).
template <int NC>
__global__ void __launch_bounds__(THREADS) flash_attention_kernel(FlashArgs p) {
  extern __shared__ __align__(16) float smem[];
  const int D = p.D;
  const int ld = D + 4;              // row stride of Qs, Ks, Vs
  float* Qs = smem;                  // [BQ][ld]
  float* Ks = Qs + BQ * ld;          // [BKV][ld]
  float* Vs = Ks + BKV * ld;         // [BKV][ld]
  float* Ps = Vs + BKV * ld;         // [BQ][BKV + 4]
  constexpr int ldp = BKV + 4;

  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int nq = (p.S + BQ - 1) / BQ;
  const int q0 = (nq - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const int offset = p.T - p.S;       // causal row offset for short q
  const size_t q_row = static_cast<size_t>(p.H) * D;    // stride of s in q, o
  const size_t kv_row = static_cast<size_t>(p.KV) * D;  // stride of t in k, v
  const float* qb = p.q + (static_cast<size_t>(b) * p.S * p.H + h) * D;
  const float* kb = p.k + (static_cast<size_t>(b) * p.T * p.KV + kvh) * D;
  const float* vb = p.v + (static_cast<size_t>(b) * p.T * p.KV + kvh) * D;

  for (int e = tid; e < BQ * D; e += THREADS) {
    const int r = e / D, d = e % D;
    Qs[r * ld + d] = (q0 + r < p.S) ? qb[(q0 + r) * q_row + d] : 0.f;
  }

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  // Last kv column any stored row of this tile may see.
  const int last_row = min(q0 + BQ, p.S) - 1 + offset;
  const int k_end = p.causal ? min(p.T, last_row + 1) : p.T;

  for (int k0 = 0; k0 < k_end; k0 += BKV) {
    __syncthreads();  // the previous tile's Ks, Vs and Ps are consumed
    for (int e = tid; e < BKV * D; e += THREADS) {
      const int r = e / D, d = e % D;
      const bool ok = k0 + r < p.T;
      Ks[r * ld + d] = ok ? kb[(k0 + r) * kv_row + d] : 0.f;
      Vs[r * ld + d] = ok ? vb[(k0 + r) * kv_row + d] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&Qs[(ty * 4 + i) * ld + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(&Ks[(tx + 16 * j) * ld + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i + offset;
      float row_max = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool ok = col < p.T && (!p.causal || col <= qpos);
        s[i][j] = ok ? s[i][j] * p.scale : NEG_INF;
        row_max = fmaxf(row_max, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group_max(row_max));
      const float alpha = expf(m[i] - m_new);
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pij = expf(s[i][j] - m_new);
        row_sum += pij;
        Ps[(ty * 4 + i) * ldp + tx + 16 * j] = pij;
      }
      l[i] = fmaf(alpha, l[i], group_sum(row_sum));
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    const int kn = min(BKV, p.T - k0);
    for (int kk = 0; kk < kn; kk += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(&Ps[(ty * 4 + i) * ldp + kk]);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d = tx + 16 * c;
        if (d < D) {
          const float v0 = Vs[(kk + 0) * ld + d], v1 = Vs[(kk + 1) * ld + d];
          const float v2 = Vs[(kk + 2) * ld + d], v3 = Vs[(kk + 3) * ld + d];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][c] = fmaf(pv[i].x, v0, acc[i][c]);
            acc[i][c] = fmaf(pv[i].y, v1, acc[i][c]);
            acc[i][c] = fmaf(pv[i].z, v2, acc[i][c]);
            acc[i][c] = fmaf(pv[i].w, v3, acc[i][c]);
          }
        }
      }
    }
  }

  float* ob = p.o + (static_cast<size_t>(b) * p.S * p.H + h) * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= p.S) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx + 16 * c;
      if (d < D) ob[r * q_row + d] = acc[i][c] * inv;
    }
  }
}

template <int NC>
int launch(const FlashArgs& a, void* stream) {
  const int bytes = static_cast<int>(sizeof(float)) *
                    ((BQ + 2 * BKV) * (a.D + 4) + BQ * (BKV + 4));
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.S + BQ - 1) / BQ, a.H, a.B);
  flash_attention_kernel<NC>
      <<<grid, THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, S, H, D), k/v (B, T, KV, D), o (B, S, H, D): contiguous fp32 on the
// device; H % KV == 0, D % 4 == 0, D <= 128 (the wrapper checks).
extern "C" int flash_attention(const float* q, const float* k, const float* v, float* o,
                               int B, int S, int T, int H, int KV, int D, float scale,
                               int causal, void* stream) {
  if (B <= 0 || S <= 0 || T <= 0 || KV <= 0 || H % KV != 0 || D <= 0 || D % 4 != 0 ||
      D > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  const FlashArgs a{q, k, v, o, B, S, T, H, KV, D, scale, causal};
  if (D <= 32) return launch<2>(a, stream);
  if (D <= 64) return launch<4>(a, stream);
  return launch<8>(a, stream);
}
