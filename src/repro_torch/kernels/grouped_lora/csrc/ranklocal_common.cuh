// Shared pieces of the grouped-LoRA kernels (sm_90a): type helpers, the
// three kernel templates and their launchers, instantiated by the
// rank-local forward pair (ranklocal.cu), the rank-local backward set
// (ranklocal_bwd.cu), the ragged set (ragged.cu) and the dense set
// (grouped_lora.cu).
//
//   narrow_out_kernel  — a long contraction into a narrow rank-wide output:
//                        S  = X  @ A   (xa, contraction over din)
//                        dS = dY @ B^T (ds, contraction over dout)
//   rank_sum_kernel    — a contraction over at most r_max ranks into a wide
//                        output:
//                        Y  = S  @ B   (sb_add)
//                        dX = dS @ A^T (dx)
//   tn_kernel          — a contraction over token rows into an fp32 weight
//                        gradient:
//                        dA = X^T @ dS       (da)
//                        dB = scale * S^T dY (db)
//
// Two compile-time flags say which per-slot counts exist. ROWS: each block
// reads rows[z], skips dead row tiles and masks the boundary row tile on
// load. RANKS: each block reads ranks[z], skips dead rank tiles and masks
// the boundary rank tile. Three instantiations:
//   rank-local <ROWS = true,  RANKS = true>   (ranklocal*.cu)
//   ragged     <ROWS = true,  RANKS = false>  (ragged.cu)
//   dense      <ROWS = false, RANKS = false>  (grouped_lora.cu)
// A flag that is false compiles its tests out: every row (rank) is live.
// All three run one grid, one tiling and one fp32 summation order per
// output element, so at full rank and every row live they agree bit for
// bit: dense == ragged at rows = T == rank-local at ranks = r_max, and
// ragged == rank-local at ranks = r_max for any rows. The executor needs
// it: a full-rank slot takes the dense kernels when its co-tenants are
// full-width and full-rank, the ragged ones beside a narrower co-tenant and
// the rank-local ones beside a lower-rank co-tenant, and its losses must
// not move a bit. A speed change to one instantiation is a change to all
// three.
//
// Every kernel rounds the fp32 adapter masters to the activation type in
// registers and sums in fp32 in a fixed order inside one block (no
// atomics, no split of a contraction across blocks), so a slot's result
// depends on nothing but its own operands.
//
// Included by each .cu file; everything is in an anonymous namespace so the
// translation units keep separate copies.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// an fp32 master value as the activation type would hold it
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f<T>(from_f<T>(v));
}

// live extent of slot z on an axis of extent hi: v[z] clamped to [0, hi]
// (v null: hi); without COUNTED the whole extent, read from nowhere
template <bool COUNTED>
__device__ __forceinline__ int live_count(const int* v, int z, int hi) {
  if (!COUNTED || v == nullptr) return hi;
  int c = v[z];
  return c < 0 ? 0 : (c > hi ? hi : c);
}

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

bool grid_ok(int gx, int gy, int gz) {
  return gx >= 1 && gy >= 1 && gz >= 1 && gy <= 65535 && gz <= 65535;
}

// ---------------------------------------------------------------------------
// OUT[z][t][j] = scale[z] * sum_k X[z][t][k] * W[z](k, j), for token rows
// t < rows[z] and rank columns j < ranks[z]; every other entry exactly 0.
// W(k, j) is the fp32 master at W + z*K*r + k*sk + j*sj (xa: A [K, r], so
// sk = r, sj = 1; ds: B [r, K], so sk = 1, sj = K). One block per (4 token
// rows, 16 rank columns, slot). The K contraction is split over the block's
// 256 threads (thread k-strided, so a warp's X loads are contiguous), each
// thread keeping a 4 x 16 fp32 partial tile in registers; warp shuffles and
// one shared-memory pass sum the partials in a fixed order. A block has only
// K/256 contraction steps per thread instead of a serial loop over K, so
// load latency overlaps.
// ---------------------------------------------------------------------------
constexpr int NO_BM = 4, NO_BR = 16, NO_THREADS = 256;
constexpr int NO_WARPS = NO_THREADS / 32;

template <typename T, bool ROWS, bool RANKS>
__global__ void __launch_bounds__(NO_THREADS)
narrow_out_kernel(const T* __restrict__ X, const float* __restrict__ W,
                  int sk, int sj, const float* __restrict__ scale,
                  T* __restrict__ OUT, const int* __restrict__ rows,
                  const int* __restrict__ ranks, int T_, int K, int r) {
  __shared__ float red[NO_WARPS][NO_BM * NO_BR];
  const int z = blockIdx.z;
  const int m0 = blockIdx.y * NO_BM;
  const int j0 = blockIdx.x * NO_BR;
  const int tid = threadIdx.x;
  const int nrow = min(NO_BM, live_count<ROWS>(rows, z, T_) - m0);  // rows
  const int ncol = min(NO_BR, live_count<RANKS>(ranks, z, r) - j0);  // ranks

  const T* xz = X + ((size_t)z * T_ + m0) * K;
  const float* wz = W + (size_t)z * K * r + (size_t)j0 * sj;
  float acc[NO_BM][NO_BR];
#pragma unroll
  for (int i = 0; i < NO_BM; ++i)
#pragma unroll
    for (int j = 0; j < NO_BR; ++j) acc[i][j] = 0.f;

  if (nrow > 0 && ncol > 0) {           // dead rank/row tiles skip the work
    for (int k = tid; k < K; k += NO_THREADS) {
      float xv[NO_BM];
#pragma unroll
      for (int i = 0; i < NO_BM; ++i)
        xv[i] = i < nrow ? to_f<T>(xz[(size_t)i * K + k]) : 0.f;
      const float* wk = wz + (size_t)k * sk;
#pragma unroll
      for (int j = 0; j < NO_BR; ++j) {
        const float w = j < ncol ? round_to<T>(wk[(size_t)j * sj]) : 0.f;
#pragma unroll
        for (int i = 0; i < NO_BM; ++i) acc[i][j] = fmaf(xv[i], w, acc[i][j]);
      }
    }
  }
  const int warp = tid / 32, lane = tid % 32;
#pragma unroll
  for (int i = 0; i < NO_BM; ++i)
#pragma unroll
    for (int j = 0; j < NO_BR; ++j) {
      float v = acc[i][j];
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == 0) red[warp][i * NO_BR + j] = v;
    }
  __syncthreads();
  if (tid < NO_BM * NO_BR) {
    const int i = tid / NO_BR, j = tid % NO_BR;
    const int t = m0 + i, jj = j0 + j;
    if (t < T_ && jj < r) {
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < NO_WARPS; ++w) v += red[w][tid];
      if (scale != nullptr) v *= scale[z];
      if (i >= nrow || j >= ncol) v = 0.f;                  // exact zeros
      OUT[((size_t)z * T_ + t) * r + jj] = from_f<T>(v);
    }
  }
}

// ---------------------------------------------------------------------------
// OUT[z][t][n] = (sum_{j < ranks[z]} S[z][t][j] * W[z](j, n)) * scale[z]
// (+ BASE[z][t][n]) for t < rows[z]; dead rows give acc = 0 (the base
// passes through). W(j, n) is the fp32 master: W_T = false -> W [r, N]
// (sb_add's B), W_T = true -> W [N, r] (dx's A, read transposed). One block
// per (32 token rows, 64 output columns, slot); the rank contraction is a
// loop over 16-wide rank tiles that stops at ranks[z]; each thread owns a
// 4 x 4 micro-tile (columns strided by 16 so neighbouring threads read
// neighbouring shared-memory words). The W tile is staged with the load
// order that keeps global reads contiguous for its layout.
// ---------------------------------------------------------------------------
constexpr int RS_BM = 32, RS_BN = 64, RS_BR = 16, RS_THREADS = 128;

template <typename T, bool W_T, bool ROWS, bool RANKS>
__global__ void __launch_bounds__(RS_THREADS)
rank_sum_kernel(const T* __restrict__ S, const float* __restrict__ W,
                const float* __restrict__ scale, float scale_all,
                const T* __restrict__ base, T* __restrict__ OUT,
                const int* __restrict__ rows, const int* __restrict__ ranks,
                int T_, int r, int N) {
  __shared__ float ss[RS_BM][RS_BR + 1];
  __shared__ float sw[RS_BR][RS_BN + 1];
  const int z = blockIdx.z;
  const int m0 = blockIdx.y * RS_BM;
  const int n0 = blockIdx.x * RS_BN;
  const int tid = threadIdx.x;
  const int vrows = live_count<ROWS>(rows, z, T_);
  const int vr = live_count<RANKS>(ranks, z, r);
  const int cn = tid % 16;
  const int rg = (tid / 16) * 4;

  const T* sz = S + (size_t)z * T_ * r;
  const float* wz = W + (size_t)z * r * N;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[i][q] = 0.f;

  const int rend = (m0 < vrows) ? vr : 0;   // dead row tile: no rank tiles
  for (int j0 = 0; j0 < rend; j0 += RS_BR) {
    for (int e = tid; e < RS_BM * RS_BR; e += RS_THREADS) {
      const int i = e / RS_BR, jj = e % RS_BR;
      const int t = m0 + i, j = j0 + jj;
      ss[i][jj] = (t < vrows && j < vr) ? to_f<T>(sz[(size_t)t * r + j]) : 0.f;
    }
    for (int e = tid; e < RS_BR * RS_BN; e += RS_THREADS) {
      // W [r, N]: neighbouring threads take neighbouring n; W [N, r]:
      // neighbouring threads take neighbouring j
      const int jj = W_T ? e % RS_BR : e / RS_BN;
      const int nn = W_T ? e / RS_BR : e % RS_BN;
      const int j = j0 + jj, n = n0 + nn;
      float w = 0.f;
      if (j < vr && n < N)
        w = round_to<T>(W_T ? wz[(size_t)n * r + j] : wz[(size_t)j * N + n]);
      sw[jj][nn] = w;
    }
    __syncthreads();
#pragma unroll
    for (int jj = 0; jj < RS_BR; ++jj) {
      float b[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) b[q] = sw[jj][cn + 16 * q];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float s = ss[rg + i][jj];
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][q] = fmaf(s, b[q], acc[i][q]);
      }
    }
    __syncthreads();
  }

  const float sc = scale != nullptr ? scale[z] : scale_all;
  T* oz = OUT + (size_t)z * T_ * N;
  const T* bz = base != nullptr ? base + (size_t)z * T_ * N : nullptr;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = m0 + rg + i;
    if (t >= T_) break;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int n = n0 + cn + 16 * q;
      if (n >= N) continue;
      const size_t o = (size_t)t * N + n;
      float v = acc[i][q] * sc;       // dead rows/slots: acc is exactly 0
      if (bz != nullptr) v += to_f<T>(bz[o]);
      oz[o] = from_f<T>(v);
    }
  }
}

// ---------------------------------------------------------------------------
// OUT[z][a][b] = sc * sum_{t < rows[z]} P[z][t][a] * Q[z][t][b]  (fp32 out)
// P: [T, NA], Q: [T, NB] in the activation type; OUT: [NA, NB] fp32. The
// rank axis is b (RANK_A = false: dA = X^T dS, NB = r) or a (RANK_A = true:
// dB = S^T dY, NA = r); entries past ranks[z] on it are exactly 0, and dead
// rank tiles skip the row loop. Both operands' dead rows are masked. A
// 2048-entry output tile per block (BA x BB), a loop over 32-row token
// chunks staged in shared memory, 4 x 4 fp32 accumulators per thread.
// ---------------------------------------------------------------------------
constexpr int TN_BT = 32, TN_THREADS = 128;

template <typename T, int BA, int BB, bool RANK_A, bool ROWS, bool RANKS>
__global__ void __launch_bounds__(TN_THREADS)
tn_kernel(const T* __restrict__ P, const T* __restrict__ Q,
          const float* __restrict__ scale, float* __restrict__ OUT,
          const int* __restrict__ rows, const int* __restrict__ ranks,
          int T_, int NA, int NB, int r) {
  static_assert(BA * BB == 16 * TN_THREADS, "4 x 4 outputs per thread");
  constexpr int TA = BA / 4, TB = BB / 4;
  __shared__ float sp[TN_BT][BA];
  __shared__ float sq[TN_BT][BB];
  const int z = blockIdx.z;
  const int a0 = blockIdx.y * BA;
  const int b0 = blockIdx.x * BB;
  const int tid = threadIdx.x;
  const int ia = tid / TB, ib = tid % TB;
  const int vrows = live_count<ROWS>(rows, z, T_);
  const int vr = live_count<RANKS>(ranks, z, r);
  const int va = RANK_A ? min(vr, NA) : NA;    // live extent of each axis
  const int vb = RANK_A ? NB : min(vr, NB);

  const T* pz = P + (size_t)z * T_ * NA;
  const T* qz = Q + (size_t)z * T_ * NB;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[i][q] = 0.f;

  const bool live = a0 < va && b0 < vb;        // dead rank tile: no loads
  for (int t0 = 0; live && t0 < vrows; t0 += TN_BT) {
    for (int e = tid; e < TN_BT * BA; e += TN_THREADS) {
      const int i = e / BA, a = e % BA;
      const int t = t0 + i, aa = a0 + a;
      sp[i][a] = (t < vrows && aa < va) ? to_f<T>(pz[(size_t)t * NA + aa])
                                        : 0.f;
    }
    for (int e = tid; e < TN_BT * BB; e += TN_THREADS) {
      const int i = e / BB, b = e % BB;
      const int t = t0 + i, bb = b0 + b;
      sq[i][b] = (t < vrows && bb < vb) ? to_f<T>(qz[(size_t)t * NB + bb])
                                        : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int i = 0; i < TN_BT; ++i) {
      float pv[4], qv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) pv[u] = sp[i][ia + TA * u];
#pragma unroll
      for (int u = 0; u < 4; ++u) qv[u] = sq[i][ib + TB * u];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int w = 0; w < 4; ++w) acc[u][w] = fmaf(pv[u], qv[w], acc[u][w]);
    }
    __syncthreads();
  }

  const float sc = scale != nullptr ? scale[z] : 1.f;
  float* oz = OUT + (size_t)z * NA * NB;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int a = a0 + ia + TA * u;
    if (a >= NA) continue;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const int b = b0 + ib + TB * w;
      if (b >= NB) continue;
      // past ranks[z] on the rank axis: exactly 0
      oz[(size_t)a * NB + b] = (a < va && b < vb) ? acc[u][w] * sc : 0.f;
    }
  }
}

// ---------------------------------------------------------------------------
// Launchers: one grid per function, shared by all three instantiations.
// Act is the activation type of every non-master operand. rows is read only
// when ROWS (null rows: every row live), ranks only when RANKS. Each
// returns cudaGetLastError() after its launch (0 = launched).
// ---------------------------------------------------------------------------

template <typename Act, bool ROWS, bool RANKS>
int launch_xa(const void* x, const float* A, void* S, const int* rows,
              const int* ranks, int Z, int T, int din, int r,
              cudaStream_t st) {
  dim3 grid(cdiv(r, NO_BR), cdiv(T, NO_BM), Z);
  if (!grid_ok(grid.x, grid.y, grid.z) || din < 1)
    return (int)cudaErrorInvalidValue;
  narrow_out_kernel<Act, ROWS, RANKS><<<grid, NO_THREADS, 0, st>>>(
      (const Act*)x, A, r, 1, nullptr, (Act*)S, rows, ranks, T, din, r);
  return (int)cudaGetLastError();
}

template <typename Act, bool ROWS, bool RANKS>
int launch_sb_add(const void* S, const float* B, const float* scale,
                  float scale_all, const void* ybase, void* Y,
                  const int* rows, const int* ranks, int Z, int T, int r,
                  int dout, cudaStream_t st) {
  dim3 grid(cdiv(dout, RS_BN), cdiv(T, RS_BM), Z);
  if (!grid_ok(grid.x, grid.y, grid.z) || r < 1)
    return (int)cudaErrorInvalidValue;
  rank_sum_kernel<Act, false, ROWS, RANKS><<<grid, RS_THREADS, 0, st>>>(
      (const Act*)S, B, scale, scale_all, (const Act*)ybase, (Act*)Y, rows,
      ranks, T, r, dout);
  return (int)cudaGetLastError();
}

template <typename Act, bool ROWS, bool RANKS>
int launch_ds(const void* dy, const float* B, const float* scale, void* dS,
              const int* rows, const int* ranks, int Z, int T, int dout,
              int r, cudaStream_t st) {
  dim3 grid(cdiv(r, NO_BR), cdiv(T, NO_BM), Z);
  if (!grid_ok(grid.x, grid.y, grid.z) || dout < 1 || scale == nullptr)
    return (int)cudaErrorInvalidValue;
  narrow_out_kernel<Act, ROWS, RANKS><<<grid, NO_THREADS, 0, st>>>(
      (const Act*)dy, B, 1, dout, scale, (Act*)dS, rows, ranks, T, dout, r);
  return (int)cudaGetLastError();
}

template <typename Act, bool ROWS, bool RANKS>
int launch_dx(const void* dS, const float* A, void* dX, const int* rows,
              const int* ranks, int Z, int T, int din, int r,
              cudaStream_t st) {
  dim3 grid(cdiv(din, RS_BN), cdiv(T, RS_BM), Z);
  if (!grid_ok(grid.x, grid.y, grid.z) || r < 1)
    return (int)cudaErrorInvalidValue;
  rank_sum_kernel<Act, true, ROWS, RANKS><<<grid, RS_THREADS, 0, st>>>(
      (const Act*)dS, A, nullptr, 1.f, nullptr, (Act*)dX, rows, ranks, T, r,
      din);
  return (int)cudaGetLastError();
}

template <typename Act, bool ROWS, bool RANKS>
int launch_da(const void* x, const void* dS, float* dA, const int* rows,
              const int* ranks, int Z, int T, int din, int r,
              cudaStream_t st) {
  constexpr int BA = 128, BB = 16;
  dim3 grid(cdiv(r, BB), cdiv(din, BA), Z);
  if (!grid_ok(grid.x, grid.y, grid.z) || T < 1)
    return (int)cudaErrorInvalidValue;
  tn_kernel<Act, BA, BB, false, ROWS, RANKS><<<grid, TN_THREADS, 0, st>>>(
      (const Act*)x, (const Act*)dS, nullptr, dA, rows, ranks, T, din, r, r);
  return (int)cudaGetLastError();
}

template <typename Act, bool ROWS, bool RANKS>
int launch_db(const void* S, const void* dy, const float* scale, float* dB,
              const int* rows, const int* ranks, int Z, int T, int dout,
              int r, cudaStream_t st) {
  constexpr int BA = 16, BB = 128;
  dim3 grid(cdiv(dout, BB), cdiv(r, BA), Z);
  if (!grid_ok(grid.x, grid.y, grid.z) || T < 1 || scale == nullptr)
    return (int)cudaErrorInvalidValue;
  tn_kernel<Act, BA, BB, true, ROWS, RANKS><<<grid, TN_THREADS, 0, st>>>(
      (const Act*)S, (const Act*)dy, scale, dB, rows, ranks, T, r, dout, r);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns the launcher call given after
// it with ``Act`` bound to that activation type; refuses any other code.
#define GL_DISPATCH_ACT(dtype, ...)                                   \
  do {                                                                \
    if ((dtype) == 0) { using Act = float; return __VA_ARGS__; }      \
    if ((dtype) == 1) { using Act = __nv_bfloat16; return __VA_ARGS__; } \
    return (int)cudaErrorInvalidValue;                                \
  } while (0)
