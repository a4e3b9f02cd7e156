// Chunked gated linear scan (RWKV6 / SSD core) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/linear_scan/linear_scan.py:linear_scan (def :89,
// pallas_call :111, body _kernel :36). Per fused row b (B = Z*b*H slots,
// lanes and heads) and chunk of C tokens, with L the chunk's cumulative
// log-decay (L_t = sum_{s<=t} logw_s, <= 0) and Lq = L (decay_on_query,
// SSD) or L shifted down one token with Lq_0 = 0 (RWKV):
//   P[t,i] = sum_k q[t,k] k[i,k] exp(Lq[t,k] - L[i,k])   over visible
//            pairs (t > i for RWKV, t >= i for SSD), plus the bonus
//            sum_k q[t,k] u[k] k[t,k] on the diagonal when u is given;
//   y      = (q . exp(Lq)) S_prev + P v;
//   S      = diag(exp(L_end)) S_prev + (k . exp(L_end - L))^T v.
// q, k [B,S,K] and v [B,S,V] share one type (fp32 or bf16); logw [B,S,K],
// the bonus [B,K] and the initial state [B,K,V] are fp32; y [B,S,V] is in
// q's type, the final state [B,K,V] fp32. All arithmetic is fp32.
//
// Exact log space: every pair term takes exp of the DIFFERENCE Lq - L,
// which is <= 0 on visible pairs; invisible pairs take exp(-1e30) = 0, as
// the TPU kernel's NEG_INF. rwkv_time_mix's decay reaches -e^4 per token,
// so L reaches about -7,000 within a 128-token chunk: the factorisation
// (q e^{Lq}) (k e^{-L})^T would overflow e^{-L}, and is not used.
//
// Design. One block of 544 threads per row walks the row's chunks in
// order; the carried state [K,V] stays in shared memory from the first
// chunk to the last. Per chunk the block stages q, k and L transposed
// ([K][C], so a thread reads four consecutive tokens of one channel as a
// float4), v row-major [C][V], and P [C][C]: 221,184 bytes at C = 128,
// K = V = 64, under the 227 KB a block may use. The TPU kernel's [C,C,K]
// pair tensor (4 MiB per chunk at that shape) is never formed: each thread
// owns one 4x4 tile (4 tokens t by 4 tokens i) of the lower triangle of P
// and sums its 16 entries over k in registers (528 tiles at C = 128, one
// per thread). The cumulative sum runs one thread per channel, t
// ascending, in the order of the plain version's torch.cumsum over an
// outer dimension. Then y takes 4x4 tiles of (t, v) and the state update
// 4x4 tiles of (k, v) from shared memory.
//
// What bounds it on an H100: the C*C*K/2 visible exponentials per chunk
// (671M for the train step's 640 rows of 256 tokens at K = 64) on the
// special-function units, 16 a clock per SM, about 0.16 ms at 1.98 GHz;
// the bytes (q, k, v bf16 and logw fp32 read once, y written once: 105 MB,
// 0.031 ms) are well under that. Each exact expf also costs the fp32
// pipes about eight operations, so this first design reaches at best
// about two thirds of the SFU bound. Tensor cores, TMA and a pipelined
// chunk load are later work.
//
// Batch independence: a block reads only its own row; every output is one
// sum in one fixed order (k ascending for P and the state term of y,
// i ascending for P v and the state update); no atomics, no split of K or
// of the chunks across blocks. A row's result does not depend on B.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 544;     // 17 warps: one P tile each at C = 128
constexpr float NEG = -1e30f;    // the TPU kernel's NEG_INF
constexpr int SMEM_MAX = 232448; // dynamic shared memory a block may use

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as torch's .to()
}

__host__ __device__ __forceinline__ int round4(int x) { return (x + 3) & ~3; }

// shared floats: q, k and L transposed [K][CP], v [Cr][VP], the state
// [K][VP], P [Cr][CP]
__host__ __device__ __forceinline__ long long smem_floats(int C, int K,
                                                          int V) {
  const long long Cr = round4(C), CP = Cr + 4, VP = V + 4;
  return 3 * K * CP + Cr * VP + K * VP + Cr * CP;
}

// the (tile row, tile column) of lower-triangle tile u, column <= row
__device__ __forceinline__ void tri_tile(int u, int& tr, int& ic) {
  tr = (int)((sqrtf(8.f * (float)u + 1.f) - 1.f) * 0.5f);
  while ((tr + 1) * (tr + 2) / 2 <= u) ++tr;
  while (tr * (tr + 1) / 2 > u) --tr;
  ic = u - tr * (tr + 1) / 2;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Lq for tokens t0..t0+3 of channel row Lrow
__device__ __forceinline__ void load_lq(const float* Lrow, int t0, int doq,
                                        float lq[4]) {
  if (doq) {
    const float4 l = ld4(Lrow + t0);
    lq[0] = l.x; lq[1] = l.y; lq[2] = l.z; lq[3] = l.w;
  } else {
    lq[0] = t0 ? Lrow[t0 - 1] : 0.f;
    lq[1] = Lrow[t0];
    lq[2] = Lrow[t0 + 1];
    lq[3] = Lrow[t0 + 2];
  }
}

// One 4x4 tile of P: tokens t0..t0+3 (rows) by i0..i0+3 (columns).
__device__ __forceinline__ void pair_tile(const float* QT, const float* KT,
                                          const float* LT, float* Ps,
                                          const float* u, int K, int CP,
                                          int tr, int ic, int doq) {
  const int t0 = 4 * tr, i0 = 4 * ic;
  float acc[4][4], dg[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    dg[a] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[a][j] = 0.f;
  }
  if (ic < tr) {  // every pair of the tile is visible: t >= i + 1
    for (int kk = 0; kk < K; ++kk) {
      const float* Lrow = LT + kk * CP;
      const float4 q4 = ld4(QT + kk * CP + t0);
      const float4 k4 = ld4(KT + kk * CP + i0);
      const float4 l4 = ld4(Lrow + i0);
      const float qa[4] = {q4.x, q4.y, q4.z, q4.w};
      const float ka[4] = {k4.x, k4.y, k4.z, k4.w};
      const float la[4] = {l4.x, l4.y, l4.z, l4.w};
      float lq[4];
      load_lq(Lrow, t0, doq, lq);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[a][j] = fmaf(qa[a] * ka[j], expf(lq[a] - la[j]), acc[a][j]);
    }
  } else {  // the diagonal tile: mask per pair, and the bonus
    for (int kk = 0; kk < K; ++kk) {
      const float* Lrow = LT + kk * CP;
      const float4 q4 = ld4(QT + kk * CP + t0);
      const float4 k4 = ld4(KT + kk * CP + i0);
      const float4 l4 = ld4(Lrow + i0);
      const float qa[4] = {q4.x, q4.y, q4.z, q4.w};
      const float ka[4] = {k4.x, k4.y, k4.z, k4.w};
      const float la[4] = {l4.x, l4.y, l4.z, l4.w};
      float lq[4];
      load_lq(Lrow, t0, doq, lq);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool vis = doq ? (a >= j) : (a > j);
          const float d = vis ? lq[a] - la[j] : NEG;
          acc[a][j] = fmaf(qa[a] * ka[j], expf(d), acc[a][j]);
        }
        if (u) dg[a] = fmaf(qa[a] * u[kk], ka[a], dg[a]);
      }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) acc[a][a] += dg[a];
  }
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int j = 0; j < 4; ++j) Ps[(t0 + a) * CP + i0 + j] = acc[a][j];
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
linear_scan_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ logw,
                   const float* __restrict__ bonus,
                   const float* __restrict__ s0, T* __restrict__ y,
                   float* __restrict__ sout, int S, int C, int K, int V,
                   int doq) {
  extern __shared__ __align__(16) float sm[];
  const int Cr = round4(C), CP = Cr + 4, VP = V + 4;
  float* QT = sm;
  float* KT = QT + K * CP;
  float* LT = KT + K * CP;
  float* Vs = LT + K * CP;
  float* Ss = Vs + Cr * VP;
  float* Ps = Ss + K * VP;

  const long long b = blockIdx.x;
  const int tid = threadIdx.x;
  const T* qb = q + b * S * K;
  const T* kb = k + b * S * K;
  const float* lb = logw + b * S * K;
  const T* vb = v + b * S * V;
  T* yb = y + b * S * V;
  const float* u = bonus ? bonus + b * K : nullptr;

  for (int e = tid; e < K * V; e += THREADS)
    Ss[(e / V) * VP + e % V] = s0 ? s0[b * K * V + e] : 0.f;

  const int nt = Cr / 4, vt = V / 4;
  const int units_p = nt * (nt + 1) / 2, units_y = nt * vt;
  const int units_s = (K / 4) * vt;
  for (int c = 0; c < S / C; ++c) {
    const long long r0 = (long long)c * C;
    __syncthreads();  // the previous chunk's readers are done
    // stage the chunk (tokens past C in the last tile read as 0)
    for (int e = tid; e < Cr * K; e += THREADS) {
      const int t = e / K, kk = e % K;
      const bool in = t < C;
      const long long g = (r0 + t) * K + kk;
      QT[kk * CP + t] = in ? to_f32(qb[g]) : 0.f;
      KT[kk * CP + t] = in ? to_f32(kb[g]) : 0.f;
      LT[kk * CP + t] = in ? lb[g] : 0.f;
    }
    for (int e = tid; e < Cr * V; e += THREADS) {
      const int t = e / V, vv = e % V;
      Vs[t * VP + vv] = t < C ? to_f32(vb[(r0 + t) * V + vv]) : 0.f;
    }
    __syncthreads();
    // cumulative log-decay: one thread per channel, tokens ascending
    for (int kk = tid; kk < K; kk += THREADS) {
      float* row = LT + kk * CP;
      float run = 0.f;
      for (int t = 0; t < C; ++t) {
        run += row[t];
        row[t] = run;
      }
    }
    __syncthreads();
    for (int w = tid; w < units_p; w += THREADS) {
      int tr, ic;
      tri_tile(w, tr, ic);
      pair_tile(QT, KT, LT, Ps, u, K, CP, tr, ic, doq);
    }
    __syncthreads();
    // q . exp(Lq) and k . exp(L_end - L), in place
    for (int e = tid; e < K * C; e += THREADS) {
      const int kk = e / C, t = e % C;
      const float* Lrow = LT + kk * CP;
      const float lq = doq ? Lrow[t] : (t ? Lrow[t - 1] : 0.f);
      QT[kk * CP + t] *= expf(lq);
      KT[kk * CP + t] *= expf(Lrow[C - 1] - Lrow[t]);
    }
    __syncthreads();
    // y = (q . exp(Lq)) S_prev + P v, 4 tokens by 4 value columns a thread
    for (int w = tid; w < units_y; w += THREADS) {
      const int t0 = 4 * (w / vt), v0 = 4 * (w % vt);
      float ys[4][4], yi[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int j = 0; j < 4; ++j) ys[a][j] = yi[a][j] = 0.f;
      for (int kk = 0; kk < K; ++kk) {
        const float4 q4 = ld4(QT + kk * CP + t0);
        const float4 s4 = ld4(Ss + kk * VP + v0);
        const float qa[4] = {q4.x, q4.y, q4.z, q4.w};
        const float sa[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int j = 0; j < 4; ++j) ys[a][j] = fmaf(qa[a], sa[j], ys[a][j]);
      }
      const int i_end = min(C, t0 + 4);
      for (int i = 0; i < i_end; ++i) {
        const float4 v4 = ld4(Vs + i * VP + v0);
        const float va[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float p = Ps[(t0 + a) * CP + i];
#pragma unroll
          for (int j = 0; j < 4; ++j) yi[a][j] = fmaf(p, va[j], yi[a][j]);
        }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        if (t0 + a >= C) break;
        T* out = yb + (r0 + t0 + a) * V + v0;
#pragma unroll
        for (int j = 0; j < 4; ++j) store(out + j, ys[a][j] + yi[a][j]);
      }
    }
    __syncthreads();  // S_prev is read by y above; now it is replaced
    for (int w = tid; w < units_s; w += THREADS) {
      const int k0 = 4 * (w / vt), v0 = 4 * (w % vt);
      float acc[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[a][j] = 0.f;
      for (int i = 0; i < C; ++i) {
        const float4 v4 = ld4(Vs + i * VP + v0);
        const float va[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float ks = KT[(k0 + a) * CP + i];
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[a][j] = fmaf(ks, va[j], acc[a][j]);
        }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float decay = expf(LT[(k0 + a) * CP + C - 1]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float* s = Ss + (k0 + a) * VP + v0 + j;
          *s = *s * decay + acc[a][j];
        }
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < K * V; e += THREADS)
    sout[b * K * V + e] = Ss[(e / V) * VP + e % V];
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* logw,
           const void* bonus, const void* s0, void* y, void* sout, int B,
           int S, int C, int K, int V, int doq, cudaStream_t stream) {
  const size_t smem = smem_floats(C, K, V) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      linear_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  linear_scan_kernel<T><<<B, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(logw),
      static_cast<const float*>(bonus), static_cast<const float*>(s0),
      static_cast<T*>(y), static_cast<float*>(sout), S, C, K, V, doq);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// bytes of dynamic shared memory a block takes at this (C, K, V)
long long ls_smem_bytes(int C, int K, int V) {
  return smem_floats(C, K, V) * (long long)sizeof(float);
}

long long ls_smem_max() { return SMEM_MAX; }

// dtype 0: q/k/v/y fp32; 1: bf16. bonus and s0 may be null. Returns a
// cudaError_t (0 = launched).
int ls_forward(const void* q, const void* k, const void* v, const void* logw,
               const void* bonus, const void* s0, void* y, void* sout, int B,
               int S, int C, int K, int V, int doq, int dtype,
               void* stream) {
  if (B < 1 || C < 1 || S % C || K % 4 || V % 4 || K < 4 || V < 4 ||
      ls_smem_bytes(C, K, V) > SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, logw, bonus, s0, y, sout, B, S, C,
                                 K, V, doq, st);
  return launch<float>(q, k, v, logw, bonus, s0, y, sout, B, S, C, K, V, doq,
                       st);
}

}  // extern "C"
