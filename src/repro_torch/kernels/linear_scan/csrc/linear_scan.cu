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
// The pair term, pivoted by blocks of 16 tokens. rwkv_time_mix's decay
// reaches -e^4 per token, so L reaches about -7,000 within a 128-token
// chunk and the plain factorisation (q e^{Lq}) (k e^{-L})^T overflows
// e^{-L}; it is not used. Pivot instead at block boundaries: with PV[T] =
// L at the last token of block T-1 (PV[0] = 0) and PV[nb] = L_end,
//   exp(Lq_t - L_i) = exp(Lq_t - PV[T]) exp(PV[T] - PV[I+1]) exp(PV[I+1] - L_i)
// for t in block T and i in an earlier block I. L does not increase, so
// each of the three exponents is <= 0 in both modes, and a 16 x 16 tile of
// P is a plain contraction over k of q~ = q e^{Lq - PV[T]}, the
// per-channel g = e^{PV[T] - PV[I+1]} and k~ = k e^{PV[I+1] - L}. Inside a
// diagonal tile the same split at 4-token quads (below_part) leaves one
// exponential per visible pair only in the 4 quads on the diagonal. The
// state term's q e^{Lq} = q~ e^{PV[T]} and the update's k e^{L_end - L} =
// k~ e^{PV[nb] - PV[I+1]} reuse q~ and k~ with one factor per (block,
// channel). No exponent anywhere is above 0. Per chunk-row at C = 128,
// K = V = 64 the exponentials fall from the 520k of the form with one
// exponential per visible pair (RWKV) to 60,288.
//
// What bounds it on an H100: the fp32 multiply-adds. At the train step's
// 640 rows of 256 tokens (C 128, K = V = 64) the kernel does 2.1M FFMA
// per chunk-row (the off-diagonal tiles, the state term, P v and the
// update, about 0.5M each; the diagonal tiles 61k): 5.4 GFLOP, 0.080 ms at
// 67 TFLOP/s. The bytes (q, k, v bf16 and logw fp32 read once, y and the
// state written once: 136.5 MB) take 0.041 ms, the exponentials 0.018 ms
// at the special-function units' 16 a clock per SM.
//
// Design. One block per row walks the row's chunks in order; the carried
// state [K,V] stays in shared memory. 512 threads (16 warps, so that the
// compiler may give each 128 registers: 18 warps allowed 96, and spilled)
// in three groups:
//   - the y group (threads 0-255) owns y: each thread holds 4 + 4 rows (row
//     quads p and Cr/4-1-p, so that every thread sums the same number of
//     P v terms) by 4 columns in registers, the state term first and P v
//     after; it also copies the NEXT chunk's logw in by cp.async while it
//     takes the state term;
//   - the pair group (threads 256-479) builds the off-diagonal P tiles
//     (4 x 8 per thread), then loads this chunk's v;
//   - the load warp (threads 480-511) runs the next chunk's cumulative
//     sum, one thread per channel, tokens ascending, the order of the
//     plain version's torch.cumsum over an outer dimension.
// The pair group and the load warp then update the state while the y
// group takes P v. A chunk is thus three phases: B (all 512 threads)
// prefetches the next chunk into L2, builds the diagonal tiles (a unit is
// a quad below the diagonal or two rows of a quad on it, over one
// sixteenth of K; the 16 parts sit in consecutive lanes and add by a
// fixed shuffle tree), scales q~, k~ and q^ into shared memory transposed
// ([K][C], four tokens of a channel are one float4) and fills the tables;
// X, the state term beside the off-diagonal tiles and v beside the next
// chunk's logw; Y, P v beside the update. Every contraction runs on the
// FP32 FFMA pipes from 4 x 4 or 4 x 8 register tiles whose operands load
// four tokens or channels at a time. Shared memory at C = 128, K = V = 64:
// 230,144 bytes, one block per SM. In the bf16 body the exponentials that
// reach y alone (the diagonal pairs, q~, q^, g) take one ex2.approx.ftz;
// those that reach the state, and all of the fp32 body's, take expf.
//
// Batch independence: a block reads only its own row; every output is one
// sum in one fixed order set by the shape alone (k ascending within each
// tile and within each part of a diagonal quad, i ascending for P v and
// within each block of the update); no atomics, no split of K or of the
// chunks across blocks. A row's result does not depend on B.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TB = 16;                // tokens of a block of the pivoted form
constexpr int NY = 256;               // y group: threads 0-255
constexpr int NP = 224;               // pair group: threads 256-479
constexpr int NL = 32;                // load warp: threads 480-511
constexpr int NS = NP + NL;           // state group (phase Y): 256-511
constexpr int THREADS = NY + NS;      // 512: 16 warps, up to 128 registers
constexpr int DIAG_PARTS = 16;        // lanes splitting K for a diagonal quad
constexpr int SMEM_MAX = 232448;      // dynamic shared memory a block may use

// shared memory, in floats: L (the chunk's logw, then its cumulative sum)
// [Cr][K+4]; q~, k~ and q^ = q e^{Lq} transposed [K][Cr+4]; the
// lower-triangle tiles of P, tile (T, I) at T(T+1)/2 + I, each stored [i][t]
// so that P[t][i] sits at tile_base(T) + 16 i + t % 16 for every
// i < 16 T + 16; v [Cr][V]; the state [K][V]; the tables
// e^{PV[nb] - PV[I+1]} [nb][K], g [1 + (nb-1)(nb-2)/2][K] (row 0 all ones
// for I = T-1, where g = e^0; row 1 + (T-1)(T-2)/2 + I for I < T-1) and
// e^{L_end} [K]
struct Layout {
  int Cr, nb, LP, CP, ngt, ng;
  long long lw, qt, kt, qh, pt, vf, s, ks, g, dec, total;
};

__host__ __device__ __forceinline__ Layout layout(int C, int K, int V) {
  Layout l;
  l.Cr = (C + TB - 1) / TB * TB;
  l.nb = l.Cr / TB;
  l.LP = K + 4;
  l.CP = l.Cr + 4;
  l.ngt = l.nb * (l.nb - 1) / 2;
  l.ng = 1 + (l.nb > 1 ? (l.nb - 1) * (l.nb - 2) / 2 : 0);
  long long o = 0;
  l.lw = o; o += (long long)l.Cr * l.LP;
  l.qt = o; o += (long long)K * l.CP;
  l.kt = o; o += (long long)K * l.CP;
  l.qh = o; o += (long long)K * l.CP;
  l.pt = o; o += (long long)(l.nb * (l.nb + 1) / 2) * TB * TB;
  l.vf = o; o += (long long)l.Cr * V;
  l.s = o;  o += (long long)K * V;
  l.ks = o; o += (long long)l.nb * K;
  l.g = o;  o += (long long)l.ng * K;
  l.dec = o; o += K;
  l.total = o;
  return l;
}

__device__ __forceinline__ float4 ld4s(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4s(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}
__device__ __forceinline__ float4 ld4g(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 ld4g(const __nv_bfloat16* p) {
  const uint2 w = __ldg(reinterpret_cast<const uint2*>(p));
  return make_float4(__uint_as_float(w.x << 16),
                     __uint_as_float(w.x & 0xffff0000u),
                     __uint_as_float(w.y << 16),
                     __uint_as_float(w.y & 0xffff0000u));
}
__device__ __forceinline__ void st4g(float* p, float a, float b, float c,
                                     float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void st4g(__nv_bfloat16* p, float a, float b,
                                     float c, float d) {
  // round to nearest even, as torch's .to()
  const __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
  uint2 w;
  w.x = *reinterpret_cast<const uint32_t*>(&lo);
  w.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = w;
}
__device__ __forceinline__ float at(const float4& x, int j) {
  return j == 0 ? x.x : j == 1 ? x.y : j == 2 ? x.z : x.w;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}
// named barriers: id 1, the load warp (its cp.async of the first chunk's
// logw has landed); id 2, the y group (arrives once its cp.async of the
// next chunk's logw has landed) and the load warp (waits before the
// cumulative sum); id 3, every thread between phases X and Y
__device__ __forceinline__ void group_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void group_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// (T, I) of the g-th off-diagonal tile, g = T(T-1)/2 + I, I < T
__device__ __forceinline__ void off_tile(int g, int& T, int& I) {
  T = (int)((1.f + sqrtf(8.f * (float)g + 1.f)) * 0.5f);
  while (T * (T - 1) / 2 > g) --T;
  while ((T + 1) * T / 2 <= g) ++T;
  I = g - T * (T - 1) / 2;
}

// an exponential that reaches y alone (the diagonal pairs, q~, q^, g):
// one ex2.approx.ftz of the log2-scaled argument on the special-function
// units in the bf16 body, whose y is held to one bf16 rounding (results
// under 2^-126 flush to 0); expf in the fp32 body. Those that
// reach the state (k~, e^{PV[nb] - PV[I+1]}, e^{L_end}) are expf in both.
__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
template <bool FAST>
__device__ __forceinline__ float y_exp(float d) {
  return FAST ? ex2_ftz(d * 1.44269504f) : expf(d);
}

// logw of one chunk into L by cp.async, thread w of nw
__device__ __forceinline__ void issue_logw(const float* lg, float* LW, int C,
                                           int K, int LP, int w, int nw) {
  const int K4 = K / 4;
  for (int e = w; e < C * K4; e += nw) {
    const int t = e / K4, j = e % K4;
    cp_async16(LW + t * LP + 4 * j, lg + (long long)t * K + 4 * j);
  }
}

// the load warp: the cumulative sum of L per channel, tokens ascending, two
// channels a thread at a time
__device__ __forceinline__ void cumsum(float* LW, int C, int K, int LP,
                                       int lt) {
  for (int k0 = lt; k0 < K; k0 += 2 * NL) {
    const int k1 = k0 + NL < K ? k0 + NL : k0;
    float r0 = 0.f, r1 = 0.f;
    for (int t0 = 0; t0 < C; t0 += 8) {
      float x[8], z[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const bool in = t0 + j < C;
        x[j] = in ? LW[(t0 + j) * LP + k0] : 0.f;
        z[j] = in ? LW[(t0 + j) * LP + k1] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        r0 += x[j];
        r1 += z[j];
        if (t0 + j < C) {
          LW[(t0 + j) * LP + k1] = r1;
          LW[(t0 + j) * LP + k0] = r0;
        }
      }
    }
  }
}

template <typename T>
__device__ __forceinline__ void prefetch_chunk(const T* p, long long n, int w,
                                               int nw) {
  const char* c = reinterpret_cast<const char*>(p);
  for (long long off = 128LL * w; off < n * (long long)sizeof(T);
       off += 128LL * nw)
    prefetch_l2(c + off);
}

// the state term of one y unit over channels k0..k1-1: rows ra..ra+3 and
// rb..rb+3, columns 4 vg..4 vg+3, from q^ = q e^{Lq}
__device__ __forceinline__ void state_term(const float* QH, const float* Ss,
                                           int k0, int k1, int V, int CP,
                                           int ra, int rb, int vg,
                                           float (&top)[4][4],
                                           float (&bot)[4][4]) {
#pragma unroll 4
  for (int kk = k0; kk < k1; ++kk) {
    const float4 qa = ld4s(QH + kk * CP + ra);
    const float4 qb = ld4s(QH + kk * CP + rb);
    const float4 s = ld4s(Ss + kk * V + 4 * vg);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        top[a][j] = fmaf(at(qa, a), at(s, j), top[a][j]);
        bot[a][j] = fmaf(at(qb, a), at(s, j), bot[a][j]);
      }
  }
}

// P v of one y unit, added to the state term, and the stores of y
template <typename T>
__device__ __forceinline__ void pair_values(const float* PT, const float* VF,
                                            T* yc, int C, int V, int ra,
                                            int rb, int vg,
                                            float (&top)[4][4],
                                            float (&bot)[4][4]) {
  const int Ta = ra / TB, Tb = rb / TB;
  const float* pa = PT + Ta * (Ta + 1) / 2 * TB * TB + ra % TB;
  const float* pb = PT + Tb * (Tb + 1) / 2 * TB * TB + rb % TB;
  const float* vp = VF + 4 * vg;
  int i = 0;
  // four tokens at a time (ra + 4 and rb + 4 are multiples of 4): the loads
  // of a step issue together before its 128 or 64 multiply-adds
  for (; i < ra + 4; i += 4) {
    float4 x[4], z[4], w[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      x[m] = ld4s(pa + (i + m) * TB);
      z[m] = ld4s(pb + (i + m) * TB);
      w[m] = ld4s(vp + (i + m) * V);
    }
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          top[a][j] = fmaf(at(x[m], a), at(w[m], j), top[a][j]);
          bot[a][j] = fmaf(at(z[m], a), at(w[m], j), bot[a][j]);
        }
  }
  for (; i < rb + 4; i += 4) {
    float4 z[4], w[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      z[m] = ld4s(pb + (i + m) * TB);
      w[m] = ld4s(vp + (i + m) * V);
    }
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          bot[a][j] = fmaf(at(z[m], a), at(w[m], j), bot[a][j]);
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    if (ra + a < C)
      st4g(yc + (long long)(ra + a) * V + 4 * vg, top[a][0], top[a][1],
           top[a][2], top[a][3]);
    if (rb + a < C)
      st4g(yc + (long long)(rb + a) * V + 4 * vg, bot[a][0], bot[a][1],
           bot[a][2], bot[a][3]);
  }
}

// Diagonal tiles, in 4 x 4 quads of tokens. The 6 quads below the diagonal
// are pivoted once more at quad boundaries: for t in quad tq and i in quad
// iq < tq of block T, with pt = L at token 16T + 4tq - 1 and pi = L at the
// last token of quad iq,
//   e^{Lq_t - L_i} = e^{Lq_t - pt} e^{pt - pi} e^{pi - L_i},
// three exponents <= 0; such a quad of one channel takes 4 + 4 + 1
// exponentials for its 16 pairs. The 4 quads on the diagonal keep one
// exponential per visible pair. A unit is one quad below the diagonal, or
// two rows (half h) of a quad on it, over one sixteenth of K; the 16 parts
// of a unit sit in 16 consecutive lanes and add by a fixed shuffle tree.
__device__ __forceinline__ void below_unit(int e, int& Tt, int& tq, int& iq) {
  const int qd = e / DIAG_PARTS, op = qd % 6;
  Tt = qd / 6;
  tq = op < 1 ? 1 : op < 3 ? 2 : 3;
  iq = op - tq * (tq - 1) / 2;
}
__device__ __forceinline__ void on_unit(int e, int& Tt, int& tq, int& h) {
  const int r = e / DIAG_PARTS;
  h = r % 2;
  tq = (r / 2) % 4;
  Tt = r / 8;
}

// a quad below the diagonal: this lane's part of K's sums, rows t0..t0+3
// against columns i0..i0+3
template <typename T, bool FAST>
__device__ __forceinline__ void below_part(const T* qc, const T* kc,
                                           const float* LW, int e, int C,
                                           int K, int LP, int doq,
                                           float (&acc)[4][4]) {
  int Tt, tq, iq;
  below_unit(e, Tt, tq, iq);
  const int t0 = TB * Tt + 4 * tq, i0 = TB * Tt + 4 * iq;
  const int pe = min(i0 + 3, C - 1);
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[a][j] = 0.f;
  if (t0 >= C) return;    // rows past the chunk: zeros
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int kq = e % DIAG_PARTS; kq < K / 4; kq += DIAG_PARTS) {
    const int kk = 4 * kq;
    const float4 pt = ld4s(LW + (t0 - 1) * LP + kk);
    const float4 pi = ld4s(LW + pe * LP + kk);
    float g[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) g[m] = y_exp<FAST>(at(pt, m) - at(pi, m));
    float kt[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = i0 + j;
      const float4 kv = i < C ? ld4g(kc + (long long)i * K + kk) : zero;
      const float4 li = i < C ? ld4s(LW + i * LP + kk) : pi;
#pragma unroll
      for (int m = 0; m < 4; ++m)
        kt[j][m] = at(kv, m) * y_exp<FAST>(at(pi, m) - at(li, m));
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int t = t0 + a;
      const bool in = t < C;
      const float4 qv = in ? ld4g(qc + (long long)t * K + kk) : zero;
      const float4 lq = !in ? pt
                        : doq ? ld4s(LW + t * LP + kk)
                              : ld4s(LW + (t - 1) * LP + kk);
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const float x = at(qv, m) * y_exp<FAST>(at(lq, m) - at(pt, m)) * g[m];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[a][j] = fmaf(x, kt[j][m], acc[a][j]);
      }
    }
  }
}

// two rows of a quad on the diagonal: this lane's part of K's sums for rows
// t0, t0+1 (t0 = 16 T + 4 tq + 2 h) against columns i0..i0+3 (i0 = 16 T +
// 4 tq), one exponential per visible pair, and the bonus on the diagonal
template <typename T, bool FAST>
__device__ __forceinline__ void on_part(const T* qc, const T* kc,
                                        const float* LW, const float* u,
                                        int e, int C, int K, int LP, int doq,
                                        float (&acc)[2][4]) {
  int Tt, tq, h;
  on_unit(e, Tt, tq, h);
  const int t0 = TB * Tt + 4 * tq + 2 * h, i0 = TB * Tt + 4 * tq;
  float dg[2] = {0.f, 0.f};
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[a][j] = 0.f;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int kq = e % DIAG_PARTS; kq < K / 4; kq += DIAG_PARTS) {
    const int kk = 4 * kq;
    float4 kv[4], li[4], qv[2], lq[2];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool in = i0 + j < C;
      kv[j] = in ? ld4g(kc + (long long)(i0 + j) * K + kk) : zero;
      li[j] = in ? ld4s(LW + (i0 + j) * LP + kk) : zero;
    }
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int t = t0 + a;
      qv[a] = t < C ? ld4g(qc + (long long)t * K + kk) : zero;
      lq[a] = t >= C ? zero
              : doq  ? ld4s(LW + t * LP + kk)
              : t    ? ld4s(LW + (t - 1) * LP + kk)
                     : zero;
    }
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int t = t0 + a;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = i0 + j;
        if (doq ? t < i : t <= i) continue;
#pragma unroll
        for (int m = 0; m < 4; ++m)
          acc[a][j] = fmaf(at(qv[a], m) * at(kv[j], m),
                           y_exp<FAST>(at(lq[a], m) - at(li[j], m)),
                           acc[a][j]);
      }
    }
    if (u && !doq) {
      const float4 uk = ld4g(u + kk);
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const float4 kd = h ? kv[a + 2] : kv[a];   // k at i = t
#pragma unroll
        for (int m = 0; m < 4; ++m)
          dg[a] = fmaf(at(qv[a], m) * at(uk, m), at(kd, m), dg[a]);
      }
    }
  }
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j == 2 * h + a) acc[a][j] += dg[a];
}

// the pair group's off-diagonal tiles of P: unit e is 4 rows t by 8 columns
// i of tile (T, I), I < T, summed over k from q~ g and k~
__device__ __forceinline__ void pair_tiles(const float* QT, const float* KT,
                                           const float* G, float* PT, int ngt,
                                           int K, int CP, int w) {
  for (int e = w; e < ngt * 8; e += NP) {
    const int gi = e / 8, sub = e % 8, tq = sub / 2, io = sub % 2;
    int Tt, I;
    off_tile(gi, Tt, I);
    const int t0 = TB * Tt + 4 * tq, i0 = TB * I + 8 * io;
    const float* gp =
        G + (I == Tt - 1 ? 0 : 1 + (Tt - 1) * (Tt - 2) / 2 + I) * K;
    float acc[4][8];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[a][j] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < K; ++kk) {
      const float4 qv = ld4s(QT + kk * CP + t0);
      const float4 k0 = ld4s(KT + kk * CP + i0);
      const float4 k1 = ld4s(KT + kk * CP + i0 + 4);
      const float g = gp[kk];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float x = at(qv, a) * g;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[a][j] = fmaf(x, at(k0, j), acc[a][j]);
          acc[a][j + 4] = fmaf(x, at(k1, j), acc[a][j + 4]);
        }
      }
    }
    float* tile = PT + (Tt * (Tt + 1) / 2 + I) * TB * TB;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      st4s(tile + (8 * io + j) * TB + 4 * tq,
           make_float4(acc[0][j], acc[1][j], acc[2][j], acc[3][j]));
  }
}

// one 4 x 4 tile of the state update over every token of the chunk:
// k^ v summed per block from k~ (block I's sum of k~ v scaled once by
// e^{PV[nb] - PV[I+1]}), blocks in order
__device__ __forceinline__ void update_tile(const float* KT, const float* VF,
                                            const float* KS, const float* DEC,
                                            float* Ss, int nb, int K, int V,
                                            int CP, int kq, int vg) {
  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[a][j] = 0.f;
  const float* kp = KT + 4 * kq * CP;
  const float* vp = VF + 4 * vg;
  for (int I = 0; I < nb; ++I) {
    float part[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int j = 0; j < 4; ++j) part[a][j] = 0.f;
#pragma unroll 2
    for (int i = TB * I; i < TB * I + TB; i += 4) {
      float4 kh[4], w[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) kh[a] = ld4s(kp + a * CP + i);
#pragma unroll
      for (int m = 0; m < 4; ++m) w[m] = ld4s(vp + (i + m) * V);
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            part[a][j] = fmaf(at(kh[a], m), at(w[m], j), part[a][j]);
    }
    const float4 sc = ld4s(KS + I * K + 4 * kq);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[a][j] = fmaf(at(sc, a), part[a][j], acc[a][j]);
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    float* s = Ss + (4 * kq + a) * V + 4 * vg;
    const float d = DEC[4 * kq + a];
    const float4 o = ld4s(s);
    st4s(s, make_float4(o.x * d + acc[a][0], o.y * d + acc[a][1],
                        o.z * d + acc[a][2], o.w * d + acc[a][3]));
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
linear_scan_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ logw,
                   const float* __restrict__ bonus,
                   const float* __restrict__ s0, T* __restrict__ y,
                   float* __restrict__ sout, int S, int C, int K, int V,
                   int doq) {
  constexpr bool FAST = sizeof(T) == 2;
  extern __shared__ __align__(16) float sm[];
  const Layout l = layout(C, K, V);
  float* LW = sm + l.lw;
  float* QT = sm + l.qt;
  float* KT = sm + l.kt;
  float* QH = sm + l.qh;
  float* PT = sm + l.pt;
  float* VF = sm + l.vf;
  float* Ss = sm + l.s;
  float* KS = sm + l.ks;
  float* G = sm + l.g;
  float* DEC = sm + l.dec;
  const int Cr = l.Cr, nb = l.nb, LP = l.LP, CP = l.CP, ngt = l.ngt;
  const int ng = l.ng;
  const int K4 = K / 4, V4 = V / 4;

  const long long b = blockIdx.x;
  const int tid = threadIdx.x;
  const T* qb = q + b * S * K;
  const T* kb = k + b * S * K;
  const float* lb = logw + b * S * K;
  const T* vb = v + b * S * V;
  T* yb = y + b * S * V;
  const float* u = bonus ? bonus + b * K : nullptr;
  const int n = S / C;
  // one y unit per y-group thread keeps the state term in registers from
  // phase X to phase Y; more units (V > 64 at C = 128) take both in Y and
  // the update in a fourth phase
  const int units_y = (Cr / 8) * V4;
  const bool fast = units_y <= NY;
  const int lt = tid - NY - NP;

  for (int e = tid; e < K * V4; e += THREADS)
    st4s(Ss + 4 * e, s0 ? ld4g(s0 + b * K * V + 4 * e)
                        : make_float4(0.f, 0.f, 0.f, 0.f));
  for (int e = tid; e < (Cr - C) * V4; e += THREADS)
    st4s(VF + C * V + 4 * e, make_float4(0.f, 0.f, 0.f, 0.f));
  if (lt >= 0) {
    issue_logw(lb, LW, C, K, LP, lt, NL);
    prefetch_chunk(qb, (long long)C * K, lt, NL);
    prefetch_chunk(kb, (long long)C * K, lt, NL);
    prefetch_chunk(vb, (long long)C * V, lt, NL);
    cp_async_wait_all();
    group_sync(1, NL);
    cumsum(LW, C, K, LP, lt);
  }
  __syncthreads();

  for (int c = 0; c < n; ++c) {
    const long long c0 = (long long)c * C;
    const T* qc = qb + c0 * K;
    const T* kc = kb + c0 * K;
    // ---- phase B (every thread): the next chunk into L2; the diagonal
    // tiles; q~, k~, q^; the tables
    if (c + 1 < n) {
      prefetch_chunk(lb + (c0 + C) * K, (long long)C * K, tid, THREADS);
      prefetch_chunk(qc + (long long)C * K, (long long)C * K, tid, THREADS);
      prefetch_chunk(kc + (long long)C * K, (long long)C * K, tid, THREADS);
      prefetch_chunk(vb + (c0 + C) * V, (long long)C * V, tid, THREADS);
    }
    // the diagonal tiles (see below_part and on_part)
    {
      const int n_below = nb * 6 * DIAG_PARTS;
      const int n_all = n_below + nb * 8 * DIAG_PARTS;
      const unsigned mask = 0xffffu << (tid & 16);
      for (int e = tid; e < n_all; e += THREADS) {
        if (e < n_below) {
          float acc[4][4];
          below_part<T, FAST>(qc, kc, LW, e, C, K, LP, doq, acc);
#pragma unroll
          for (int off = DIAG_PARTS / 2; off > 0; off /= 2)
#pragma unroll
            for (int a = 0; a < 4; ++a)
#pragma unroll
              for (int j = 0; j < 4; ++j)
                acc[a][j] += __shfl_xor_sync(mask, acc[a][j], off);
          if (e % DIAG_PARTS == 0) {
            int Tt, tq, iq;
            below_unit(e, Tt, tq, iq);
            float* tile = PT + (Tt * (Tt + 1) / 2 + Tt) * TB * TB + 4 * tq;
#pragma unroll
            for (int j = 0; j < 4; ++j)
              st4s(tile + (4 * iq + j) * TB,
                   make_float4(acc[0][j], acc[1][j], acc[2][j], acc[3][j]));
          }
        } else {
          float acc[2][4];
          on_part<T, FAST>(qc, kc, LW, u, e - n_below, C, K, LP, doq, acc);
#pragma unroll
          for (int off = DIAG_PARTS / 2; off > 0; off /= 2)
#pragma unroll
            for (int a = 0; a < 2; ++a)
#pragma unroll
              for (int j = 0; j < 4; ++j)
                acc[a][j] += __shfl_xor_sync(mask, acc[a][j], off);
          if (e % DIAG_PARTS == 0) {
            int Tt, tq, h;
            on_unit(e - n_below, Tt, tq, h);
            float* tile = PT + (Tt * (Tt + 1) / 2 + Tt) * TB * TB + 4 * tq +
                          2 * h;
#pragma unroll
            for (int j = 0; j < 4; ++j)
              *reinterpret_cast<float2*>(tile + (4 * tq + j) * TB) =
                  make_float2(acc[0][j], acc[1][j]);
          }
        }
      }
    }
    // q~ = q e^{Lq - PV[T]}, k~ = k e^{PV[T+1] - L} and q^ = q~ e^{PV[T]}:
    // a unit is 4 tokens by 4 channels (lanes: 8 token quads by 4 channel
    // groups), stored as float4s of 4 tokens; beside it one table entry of
    // 4 channels: e^{PV[nb] - PV[I+1]}, g (PV[T] = L at the last token of
    // block T-1, PV[0] = 0, PV[nb] = L_end), e^{L_end}
    {
      const int nq = Cr / 4, nu = 8 * K4 * ((nq + 7) / 8);
      const int ntab = (nb + ng + 1) * K4;
      for (int e = tid; e < nu || e < ntab; e += THREADS) {
        const int cq = (e / 8) % K4, t0 = 4 * (e % 8 + 8 * (e / (8 * K4)));
        if (e < nu && t0 < Cr) {
          const int kk = 4 * cq, Tt = t0 / TB;
          const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
          const float4 p0 = Tt ? ld4s(LW + (TB * Tt - 1) * LP + kk) : zero;
          const float4 p1 = ld4s(LW + (min(TB * Tt + TB, C) - 1) * LP + kk);
          float4 qv[4], kv[4], Lt[4], Lq[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const int t = t0 + a;
            const bool in = t < C;
            qv[a] = in ? ld4g(qc + (long long)t * K + kk) : zero;
            kv[a] = in ? ld4g(kc + (long long)t * K + kk) : zero;
            Lt[a] = in ? ld4s(LW + t * LP + kk) : zero;
          }
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const int t = t0 + a;
            Lq[a] = doq || t >= C ? Lt[a]
                    : a       ? Lt[a - 1]
                    : t       ? ld4s(LW + (t - 1) * LP + kk)
                              : zero;
          }
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            const float ep = y_exp<FAST>(at(p0, m));   // e^{PV[T]}
            float qs[4], ks[4];
#pragma unroll
            for (int a = 0; a < 4; ++a) {
              const bool in = t0 + a < C;
              qs[a] = in ? at(qv[a], m) *
                               y_exp<FAST>(at(Lq[a], m) - at(p0, m))
                         : 0.f;
              ks[a] = in ? at(kv[a], m) * expf(at(p1, m) - at(Lt[a], m))
                         : 0.f;
            }
            const int o = (kk + m) * CP + t0;
            st4s(QT + o, make_float4(qs[0], qs[1], qs[2], qs[3]));
            st4s(KT + o, make_float4(ks[0], ks[1], ks[2], ks[3]));
            st4s(QH + o, make_float4(qs[0] * ep, qs[1] * ep, qs[2] * ep,
                                     qs[3] * ep));
          }
        }
        if (e < ntab) {
          const int row = e / K4, kk = 4 * (e % K4);
          auto pv = [&](int Tt) {
            return Tt ? ld4s(LW + (min(TB * Tt, C) - 1) * LP + kk)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
          };
          float4 x;
          float* dst;
          if (row < nb) {         // e^{PV[nb] - PV[I+1]}
            const float4 a = pv(nb), b = pv(row + 1);
            x = make_float4(expf(a.x - b.x), expf(a.y - b.y),
                            expf(a.z - b.z), expf(a.w - b.w));
            dst = KS + row * K + kk;
          } else if (row == nb) { // g of I = T - 1: e^0
            x = make_float4(1.f, 1.f, 1.f, 1.f);
            dst = G + kk;
          } else if (row < nb + ng) {
            int Tt, I;
            off_tile(row - nb - 1, Tt, I);
            const float4 a = pv(Tt + 1), b = pv(I + 1);
            x = make_float4(y_exp<FAST>(a.x - b.x), y_exp<FAST>(a.y - b.y),
                            y_exp<FAST>(a.z - b.z), y_exp<FAST>(a.w - b.w));
            dst = G + (row - nb) * K + kk;
          } else {                // e^{L_end}
            const float4 a = pv(nb);
            x = make_float4(expf(a.x), expf(a.y), expf(a.z), expf(a.w));
            dst = DEC + kk;
          }
          st4s(dst, x);
        }
      }
    }
    __syncthreads();
    // ---- phases X (the state term | off-diagonal P tiles, then v | the
    // next chunk's logw) and Y (P v | the state update). The y group keeps its
    // rows of y in registers from X to Y, so each group runs both phases in
    // its own branch and they meet at barrier 3 in between.
    const bool next = c + 1 < n;
    if (tid < NY) {
      float top[4][4], bot[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int j = 0; j < 4; ++j) top[a][j] = bot[a][j] = 0.f;
      if (next) issue_logw(lb + (c0 + C) * K, LW, C, K, LP, tid, NY);
      const bool mine = fast && tid < units_y;
      const int vg = tid % V4, ra = 4 * (tid / V4), rb = Cr - 4 - ra;
      const int k1 = K / 16 * 4;  // a quarter of the channels, then
      if (mine) state_term(QH, Ss, 0, k1, V, CP, ra, rb, vg, top, bot);
      if (next) {  // the logw has landed (from L2): release the load warp
        cp_async_wait_all();
        group_arrive(2, NY + NL);
      }
      if (mine) state_term(QH, Ss, k1, K, V, CP, ra, rb, vg, top, bot);
      group_sync(3, THREADS);
      if (mine) {
        pair_values(PT, VF, yb + c0 * V, C, V, ra, rb, vg, top, bot);
      } else if (!fast) {
        for (int w = tid; w < units_y; w += NY) {
          const int wv = w % V4, wa = 4 * (w / V4), wb = Cr - 4 - wa;
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int j = 0; j < 4; ++j) top[a][j] = bot[a][j] = 0.f;
          state_term(QH, Ss, 0, K, V, CP, wa, wb, wv, top, bot);
          pair_values(PT, VF, yb + c0 * V, C, V, wa, wb, wv, top, bot);
        }
      }
    } else {
      if (lt < 0) {
        pair_tiles(QT, KT, G, PT, ngt, K, CP, tid - NY);
        // this chunk's v, as fp32
        const T* vc = vb + c0 * V;
        for (int e = tid - NY; e < C * V4; e += NP)
          st4s(VF + 4 * e, ld4g(vc + 4 * e));
      } else if (next) {
        group_sync(2, NY + NL);
        cumsum(LW, C, K, LP, lt);
      }
      group_sync(3, THREADS);
      if (fast)
        for (int e = tid - NY; e < K4 * V4; e += NS)
          update_tile(KT, VF, KS, DEC, Ss, nb, K, V, CP, e / V4, e % V4);
    }
    __syncthreads();
    if (!fast) {
      if (tid >= NY)
        for (int e = tid - NY; e < K4 * V4; e += NS)
          update_tile(KT, VF, KS, DEC, Ss, nb, K, V, CP, e / V4, e % V4);
      __syncthreads();
    }
  }
  for (int e = tid; e < K * V4; e += THREADS)
    st4s(sout + b * K * V + 4 * e, ld4s(Ss + 4 * e));
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* logw,
           const void* bonus, const void* s0, void* y, void* sout, int B,
           int S, int C, int K, int V, int doq, cudaStream_t stream) {
  const size_t smem = layout(C, K, V).total * sizeof(float);
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

bool aligned(const void* p, int bytes) {
  return (reinterpret_cast<uintptr_t>(p) % bytes) == 0;
}

}  // namespace

extern "C" {

// bytes of dynamic shared memory a block takes at this (C, K, V)
long long ls_smem_bytes(int C, int K, int V) {
  return layout(C, K, V).total * (long long)sizeof(float);
}

long long ls_smem_max() { return SMEM_MAX; }

// dtype 0: q/k/v/y fp32; 1: bf16. bonus and s0 may be null. Every pointer
// must be aligned to four of its elements (16 bytes for fp32, 8 for bf16;
// a tensor's own allocation always is). Returns a cudaError_t (0 =
// launched).
int ls_forward(const void* q, const void* k, const void* v, const void* logw,
               const void* bonus, const void* s0, void* y, void* sout, int B,
               int S, int C, int K, int V, int doq, int dtype,
               void* stream) {
  if (B < 1 || C < 1 || S % C || K % 4 || V % 4 || K < 4 || V < 4 ||
      ls_smem_bytes(C, K, V) > SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  const int e = dtype == 1 ? 8 : 16;
  if (!aligned(q, e) || !aligned(k, e) || !aligned(v, e) || !aligned(y, e) ||
      !aligned(logw, 16) || !aligned(bonus, 16) || !aligned(s0, 16) ||
      !aligned(sout, 16))
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, logw, bonus, s0, y, sout, B, S, C,
                                 K, V, doq, st);
  return launch<float>(q, k, v, logw, bonus, s0, y, sout, B, S, C, K, V, doq,
                       st);
}

}  // extern "C"
