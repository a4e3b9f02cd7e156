// Shared pieces of the rank-local grouped-LoRA kernels (sm_90a): type
// helpers and the two kernel templates that both the forward pair
// (ranklocal.cu) and the backward set (ranklocal_bwd.cu) instantiate.
//
//   narrow_out_kernel  — a long contraction into a narrow rank-wide output:
//                        S  = X  @ A   (rl_xa, contraction over din)
//                        dS = dY @ B^T (rl_ds, contraction over dout)
//   rank_sum_kernel    — a contraction over at most r_max ranks into a wide
//                        output:
//                        Y  = S  @ B   (rl_sb_add)
//                        dX = dS @ A^T (rl_dx)
//
// Both read rows[z] / ranks[z] in the block, skip dead rank and row tiles,
// mask the boundary tile on load, round the fp32 adapter masters to the
// activation type in registers, and sum in fp32 in a fixed order (no
// atomics), so a slot's result depends on nothing but its own operands.
//
// Included by each .cu file; everything is in an anonymous namespace so the
// two translation units keep separate copies.
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

__device__ __forceinline__ int clamp_count(const int* v, int z, int hi) {
  if (v == nullptr) return hi;
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

template <typename T>
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
  const int nrow = min(NO_BM, clamp_count(rows, z, T_) - m0);   // live rows
  const int ncol = min(NO_BR, clamp_count(ranks, z, r) - j0);   // live ranks

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

template <typename T, bool W_T>
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
  const int vrows = clamp_count(rows, z, T_);
  const int vr = clamp_count(ranks, z, r);
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

}  // namespace
