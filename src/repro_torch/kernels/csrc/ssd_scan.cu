// Mamba-2 SSD (state-space duality) chunked scan, forward only:
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
// The exponent is masked before exp (upper-triangle differences are positive
// and would overflow, and inf * 0 is nan).  Unlike the Pallas kernel it takes
// a ragged last chunk: its missing steps act as dt = 0 (decay 1, no state
// increment), which is what the reference's zero padding gives, without
// padding anything.
//
// Design: the TPU runs the chunks as a sequential grid dimension with the
// state in VMEM scratch; here one 256-thread block owns one (batch, head)
// and walks the chunks itself, the state kept in shared memory the whole
// scan.  One chunk's fp32 b, c, x, state and C B^T would take about 256 KB at
// (Lc, N, P) = (128, 128, 64), over the 227 KB a block may use, so b and c
// pass through 32-column tiles of N: C B^T accumulates over them in
// registers (an 8 x 8 tile per thread), then is masked, decayed and stored
// once as M = (C B^T) . L . dt; the inter-chunk term and the state update
// re-read their tile of c or b with e^G or the state weight folded in.
// Shared memory: S (N, P), X (Lc, P), M (Lc, Lc + 1), two (Lc, 33) tiles, dt
// and G: 166 KB at the slice shape, so one block per SM.  Rows of the tiles
// are padded to an odd stride, so each thread's column reads fall in
// distinct banks.
//
// Bound: at mamba2-370m's prefill, x (4, 4096, 32, 64), N 128, chunk 128,
// the work is fp32 FMA issue (C B^T is recomputed per head here; the bound
// counts it once per batch and chunk, since all heads share it, and only
// the causal triangle of the intra-chunk product).  fmaf and expf in full
// fp32, no TF32 and no fast math.  Sharing C B^T across heads and tensor
// cores are left for a later change.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int NT = 32;         // columns of N per b/c tile
constexpr int LDT = NT + 1;    // row stride of the b/c tiles
constexpr int MAX_CHUNK = 128;
constexpr int MAX_N = 128;
constexpr int MAX_P = 64;

struct SsdArgs {
  const void* x;
  const float* dt;
  const float* g;
  const float* b;
  const float* c;
  float* y;
  float* state;
  int B, S, H, P, N, chunk;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename XT>
__global__ void __launch_bounds__(THREADS) ssd_scan_kernel(SsdArgs p) {
  extern __shared__ __align__(16) float smem[];
  const int Lc = p.chunk, N = p.N, P = p.P;
  const int ldm = Lc + 1;
  float* St = smem;            // [N][P]   the carried state
  float* Xs = St + N * P;      // [Lc][P]
  float* Ms = Xs + Lc * P;     // [Lc][Lc + 1]
  float* Ct = Ms + Lc * ldm;   // [Lc][LDT]
  float* Bt = Ct + Lc * LDT;   // [Lc][LDT]
  float* dts = Bt + Lc * LDT;  // [Lc]
  float* Gs = dts + Lc;        // [Lc]

  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int h = blockIdx.x;
  const int bi = blockIdx.y;
  const XT* x = static_cast<const XT*>(p.x);

  for (int e = tid; e < N * P; e += THREADS) St[e] = 0.f;

  for (int c0 = 0; c0 < p.S; c0 += Lc) {
    const int len = min(Lc, p.S - c0);
    __syncthreads();  // the previous chunk is done with Xs, dts, Gs
    for (int e = tid; e < Lc * P; e += THREADS) {
      const int j = e / P, q = e % P;
      Xs[e] = j < len ? to_f32(x[((static_cast<size_t>(bi) * p.S + c0 + j) * p.H + h) * P + q])
                      : 0.f;
    }
    for (int j = tid; j < Lc; j += THREADS) {
      const size_t at = (static_cast<size_t>(bi) * p.S + c0 + j) * p.H + h;
      dts[j] = j < len ? p.dt[at] : 0.f;
      Gs[j] = j < len ? p.g[at] : 0.f;
    }
    __syncthreads();
    const float g_last = Gs[len - 1];
    const float* bc = p.b + (static_cast<size_t>(bi) * p.S + c0) * N;
    const float* cc = p.c + (static_cast<size_t>(bi) * p.S + c0) * N;

    // ---- C B^T over the N tiles: rows ty + 16a, columns tx + 16b.
    float cb[8][8];
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int b = 0; b < 8; ++b) cb[a][b] = 0.f;
    for (int n0 = 0; n0 < N; n0 += NT) {
      for (int e = tid; e < Lc * NT; e += THREADS) {
        const int i = e / NT, nn = e % NT;
        const bool ok = i < len && n0 + nn < N;
        Ct[i * LDT + nn] = ok ? cc[static_cast<size_t>(i) * N + n0 + nn] : 0.f;
        Bt[i * LDT + nn] = ok ? bc[static_cast<size_t>(i) * N + n0 + nn] : 0.f;
      }
      __syncthreads();
      for (int nn = 0; nn < NT; ++nn) {
        float cv[8], bv[8];
#pragma unroll
        for (int a = 0; a < 8; ++a) {
          const int i = ty + 16 * a;
          cv[a] = i < Lc ? Ct[i * LDT + nn] : 0.f;
          bv[a] = tx + 16 * a < Lc ? Bt[(tx + 16 * a) * LDT + nn] : 0.f;
        }
#pragma unroll
        for (int a = 0; a < 8; ++a)
#pragma unroll
          for (int b = 0; b < 8; ++b) cb[a][b] = fmaf(cv[a], bv[b], cb[a][b]);
      }
      __syncthreads();
    }
    // M = (C B^T) . L . dt, the exponent masked before exp.
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      const int i = ty + 16 * a;
      if (i >= Lc) continue;
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        const int j = tx + 16 * b;
        if (j >= Lc) continue;
        Ms[i * ldm + j] = (i >= j && i < len) ? cb[a][b] * expf(Gs[i] - Gs[j]) * dts[j] : 0.f;
      }
    }
    __syncthreads();

    // ---- y: rows ty + 16a, head dims tx + 16q.
    float yv[8][4];
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int q = 0; q < 4; ++q) yv[a][q] = 0.f;
    for (int j = 0; j < len; ++j) {
      float xv[4], mv[8];
#pragma unroll
      for (int q = 0; q < 4; ++q) xv[q] = tx + 16 * q < P ? Xs[j * P + tx + 16 * q] : 0.f;
#pragma unroll
      for (int a = 0; a < 8; ++a) mv[a] = ty + 16 * a < Lc ? Ms[(ty + 16 * a) * ldm + j] : 0.f;
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int q = 0; q < 4; ++q) yv[a][q] = fmaf(mv[a], xv[q], yv[a][q]);
    }
    // inter-chunk: (C . e^G) S_prev, c re-read with e^{G_i} folded in.
    for (int n0 = 0; n0 < N; n0 += NT) {
      for (int e = tid; e < Lc * NT; e += THREADS) {
        const int i = e / NT, nn = e % NT;
        const bool ok = i < len && n0 + nn < N;
        Ct[i * LDT + nn] = ok ? cc[static_cast<size_t>(i) * N + n0 + nn] * expf(Gs[i]) : 0.f;
      }
      __syncthreads();
      const int nk = min(NT, N - n0);
      for (int nn = 0; nn < nk; ++nn) {
        float sv[4], cv[8];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          sv[q] = tx + 16 * q < P ? St[(n0 + nn) * P + tx + 16 * q] : 0.f;
#pragma unroll
        for (int a = 0; a < 8; ++a) cv[a] = ty + 16 * a < Lc ? Ct[(ty + 16 * a) * LDT + nn] : 0.f;
#pragma unroll
        for (int a = 0; a < 8; ++a)
#pragma unroll
          for (int q = 0; q < 4; ++q) yv[a][q] = fmaf(cv[a], sv[q], yv[a][q]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      const int i = ty + 16 * a;
      if (i >= len) continue;
      float* yrow = p.y + ((static_cast<size_t>(bi) * p.S + c0 + i) * p.H + h) * P;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (tx + 16 * q < P) yrow[tx + 16 * q] = yv[a][q];
    }

    // ---- state: S = e^{G_last} S + (B . w)^T X, w_j = dt_j e^{G_last - G_j};
    // each thread owns rows n0 + ty + 16u of every tile, head dims tx + 16q.
    const float decay = expf(g_last);
    for (int n0 = 0; n0 < N; n0 += NT) {
      for (int e = tid; e < Lc * NT; e += THREADS) {
        const int j = e / NT, nn = e % NT;
        const bool ok = j < len && n0 + nn < N;
        Bt[j * LDT + nn] =
            ok ? bc[static_cast<size_t>(j) * N + n0 + nn] * (dts[j] * expf(g_last - Gs[j])) : 0.f;
      }
      __syncthreads();
      float inc[2][4];
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int q = 0; q < 4; ++q) inc[u][q] = 0.f;
      for (int j = 0; j < len; ++j) {
        float xv[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) xv[q] = tx + 16 * q < P ? Xs[j * P + tx + 16 * q] : 0.f;
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const float bw = Bt[j * LDT + ty + 16 * u];
#pragma unroll
          for (int q = 0; q < 4; ++q) inc[u][q] = fmaf(bw, xv[q], inc[u][q]);
        }
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int n = n0 + ty + 16 * u;
        if (n >= N) continue;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int pp = tx + 16 * q;
          if (pp < P) St[n * P + pp] = fmaf(decay, St[n * P + pp], inc[u][q]);
        }
      }
      __syncthreads();
    }
  }

  float* sout = p.state + (static_cast<size_t>(bi) * p.H + h) * N * P;
  for (int e = tid; e < N * P; e += THREADS) sout[e] = St[e];
}

template <typename XT>
int launch(const SsdArgs& a, void* stream) {
  const int Lc = a.chunk;
  const int floats = a.N * a.P + Lc * a.P + Lc * (Lc + 1) + 2 * Lc * LDT + 2 * Lc;
  const int bytes = floats * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<XT>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(a.H, a.B);
  ssd_scan_kernel<XT><<<grid, THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (B, S, H, P) fp32 or bf16 (x_bf16 != 0), dt and g (B, S, H), b and c
// (B, S, N) fp32; y (B, S, H, P) and state (B, H, N, P) fp32.  All
// contiguous on the device; chunk <= 128, N <= 128, P <= 64.
extern "C" int ssd_scan(const void* x, const float* dt, const float* g, const float* b,
                        const float* c, float* y, float* state, int B, int S, int H, int P,
                        int N, int chunk, int x_bf16, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || P > MAX_P || N <= 0 || N > MAX_N ||
      chunk <= 0 || chunk > MAX_CHUNK)
    return static_cast<int>(cudaErrorInvalidValue);
  const SsdArgs a{x, dt, g, b, c, y, state, B, S, H, P, N, chunk};
  return x_bf16 ? launch<__nv_bfloat16>(a, stream) : launch<float>(a, stream);
}
