// Rank-local grouped multi-adapter LoRA forward kernels for Hopper (sm_90a).
//
// Replaces the two forward Pallas TPU kernels of
// src/repro/kernels/grouped_lora/ranklocal.py:
//   rl_xa      <- ranklocal.py:xa     (def :88, pallas_call :97)
//                 S[z] = X[z] @ A[z] over token rows < rows[z] and rank
//                 columns < ranks[z]; every other S entry is exactly 0.
//   rl_sb_add  <- ranklocal.py:sb_add (def :165, pallas_call :187;
//                 _sb_kernel :121 and _sb_add_kernel :142 as one kernel
//                 with an optional base pointer)
//                 Y[z] = (S[z] @ B[z] over rank < ranks[z], rows < rows[z])
//                        * scale[z] (+ Y_base[z]).
//
// Layout: x [Z,T,din], A [Z,din,r] fp32, B [Z,r,dout] fp32, S [Z,T,r],
// Y and Y_base [Z,T,dout], scale [Z] fp32, rows/ranks [Z] int32. x, S, Y
// and Y_base share one activation type (fp32 or bf16). All contiguous.
//
// Numerics (kept from the JAX package, or bf16 parity drifts): the fp32
// adapter masters are rounded to the activation type on load (the cast
// ops.py:69-70 does before its kernels), products are summed in fp32, S is
// rounded to the activation type (ranklocal.py:112), and Y is
// fp32 acc * scale[z] (+ base) rounded once (ranklocal.py:139, :161-162).
//
// What bounds them on an H100: at decode (T = lanes per slot, a handful of
// rows) each call moves sum_z ranks[z]*din fp32 values of A (sum_z
// ranks[z]*dout of B) and does ~2*T flops per value read, far below the
// ~295 flops/byte the card needs to be compute bound, so they are bound by
// bytes. The design reads only live rank columns (dead rank tiles are
// skipped, the boundary tile is masked on load) and reads the fp32 masters
// directly instead of a separate cast pass. A decode step of stablelm-3b
// launches 7 targets x 32 layers x 2 = 448 of these kernels, so launch
// overhead will likely dominate until a later change captures the step in a
// CUDA graph.
//
// Structure: the TPU grid's sequential contraction axis becomes a loop
// inside the block; each block reads rows[z] and ranks[z] itself; edges are
// masked in the kernel (no padding to tile multiples). Plain fp32 FMA (no
// tensor cores): a simple, correct first kernel (wgmma/TMA come later).

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

// ---------------------------------------------------------------------------
// S = X @ A: one block per (4 token rows, 16 rank columns, slot). The din
// contraction is split over the block's 256 threads (thread k-strided, so a
// warp's x loads are contiguous), each thread keeping a 4 x 16 fp32 partial
// tile in registers; warp shuffles and one shared-memory pass sum the
// partials in a fixed order. At decode a block has ~10 contraction steps
// per thread instead of a serial loop over din, so load latency overlaps.
// ---------------------------------------------------------------------------
constexpr int XA_BM = 4, XA_BR = 16, XA_THREADS = 256;
constexpr int XA_WARPS = XA_THREADS / 32;

template <typename T>
__global__ void __launch_bounds__(XA_THREADS)
xa_kernel(const T* __restrict__ x, const float* __restrict__ A,
          T* __restrict__ S, const int* __restrict__ rows,
          const int* __restrict__ ranks, int T_, int din, int r) {
  __shared__ float red[XA_WARPS][XA_BM * XA_BR];
  const int z = blockIdx.z;
  const int m0 = blockIdx.y * XA_BM;
  const int j0 = blockIdx.x * XA_BR;
  const int tid = threadIdx.x;
  const int nrow = min(XA_BM, clamp_count(rows, z, T_) - m0);   // live rows
  const int ncol = min(XA_BR, clamp_count(ranks, z, r) - j0);   // live ranks

  const T* xz = x + ((size_t)z * T_ + m0) * din;
  const float* az = A + (size_t)z * din * r + j0;
  float acc[XA_BM][XA_BR];
#pragma unroll
  for (int i = 0; i < XA_BM; ++i)
#pragma unroll
    for (int j = 0; j < XA_BR; ++j) acc[i][j] = 0.f;

  if (nrow > 0 && ncol > 0) {           // dead rank/row tiles skip the work
    for (int k = tid; k < din; k += XA_THREADS) {
      float xv[XA_BM];
#pragma unroll
      for (int i = 0; i < XA_BM; ++i)
        xv[i] = i < nrow ? to_f<T>(xz[(size_t)i * din + k]) : 0.f;
      const float* ak = az + (size_t)k * r;
#pragma unroll
      for (int j = 0; j < XA_BR; ++j) {
        const float a = j < ncol ? round_to<T>(ak[j]) : 0.f;
#pragma unroll
        for (int i = 0; i < XA_BM; ++i) acc[i][j] = fmaf(xv[i], a, acc[i][j]);
      }
    }
  }
  const int warp = tid / 32, lane = tid % 32;
#pragma unroll
  for (int i = 0; i < XA_BM; ++i)
#pragma unroll
    for (int j = 0; j < XA_BR; ++j) {
      float v = acc[i][j];
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == 0) red[warp][i * XA_BR + j] = v;
    }
  __syncthreads();
  if (tid < XA_BM * XA_BR) {
    const int i = tid / XA_BR, j = tid % XA_BR;
    const int t = m0 + i, jj = j0 + j;
    if (t < T_ && jj < r) {
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < XA_WARPS; ++w) v += red[w][tid];
      if (i >= nrow || j >= ncol) v = 0.f;                  // exact zeros
      S[((size_t)z * T_ + t) * r + jj] = from_f<T>(v);
    }
  }
}

// ---------------------------------------------------------------------------
// Y = S @ B * scale (+ base): one block per (32 token rows, 64 output
// columns, slot); the rank contraction is a loop over 16-wide rank tiles
// that stops at ranks[z]; each thread owns a 4 x 4 micro-tile (columns
// strided by 16 so neighbouring threads read neighbouring B values).
// ---------------------------------------------------------------------------
constexpr int SB_BM = 32, SB_BN = 64, SB_BR = 16, SB_THREADS = 128;

template <typename T>
__global__ void __launch_bounds__(SB_THREADS)
sb_kernel(const T* __restrict__ S, const float* __restrict__ B,
          const float* __restrict__ scale, float scale_all,
          const T* __restrict__ ybase, T* __restrict__ Y,
          const int* __restrict__ rows, const int* __restrict__ ranks,
          int T_, int r, int dout) {
  __shared__ float ss[SB_BM][SB_BR + 1];
  __shared__ float sb[SB_BR][SB_BN];
  const int z = blockIdx.z;
  const int m0 = blockIdx.y * SB_BM;
  const int n0 = blockIdx.x * SB_BN;
  const int tid = threadIdx.x;
  const int vrows = clamp_count(rows, z, T_);
  const int vr = clamp_count(ranks, z, r);
  const int cn = tid % 16;
  const int rg = (tid / 16) * 4;

  const T* sz = S + (size_t)z * T_ * r;
  const float* bz = B + (size_t)z * r * dout;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[i][q] = 0.f;

  const int rend = (m0 < vrows) ? vr : 0;   // dead row tile: no rank tiles
  for (int j0 = 0; j0 < rend; j0 += SB_BR) {
    for (int e = tid; e < SB_BM * SB_BR; e += SB_THREADS) {
      const int i = e / SB_BR, jj = e % SB_BR;
      const int t = m0 + i, j = j0 + jj;
      ss[i][jj] = (t < vrows && j < vr) ? to_f<T>(sz[(size_t)t * r + j]) : 0.f;
    }
    for (int e = tid; e < SB_BR * SB_BN; e += SB_THREADS) {
      const int jj = e / SB_BN, nn = e % SB_BN;
      const int j = j0 + jj, n = n0 + nn;
      sb[jj][nn] = (j < vr && n < dout)
                       ? round_to<T>(bz[(size_t)j * dout + n]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int jj = 0; jj < SB_BR; ++jj) {
      float b[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) b[q] = sb[jj][cn + 16 * q];
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
  T* yz = Y + (size_t)z * T_ * dout;
  const T* bsz = ybase != nullptr ? ybase + (size_t)z * T_ * dout : nullptr;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = m0 + rg + i;
    if (t >= T_) break;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int n = n0 + cn + 16 * q;
      if (n >= dout) continue;
      const size_t o = (size_t)t * dout + n;
      float v = acc[i][q] * sc;       // dead rows/slots: acc is exactly 0
      if (bsz != nullptr) v += to_f<T>(bsz[o]);
      yz[o] = from_f<T>(v);
    }
  }
}

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

bool grid_ok(int gx, int gy, int gz) {
  return gx >= 1 && gy >= 1 && gz >= 1 && gy <= 65535 && gz <= 65535;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. rows may be null (every row live).
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int rl_xa(const void* x, const float* A, void* S, const int* rows,
                     const int* ranks, int Z, int T, int din, int r,
                     int dtype, void* stream) {
  dim3 grid(cdiv(r, XA_BR), cdiv(T, XA_BM), Z);
  if (!grid_ok(grid.x, grid.y, grid.z) || din < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    xa_kernel<float><<<grid, XA_THREADS, 0, st>>>(
        (const float*)x, A, (float*)S, rows, ranks, T, din, r);
  } else if (dtype == 1) {
    xa_kernel<__nv_bfloat16><<<grid, XA_THREADS, 0, st>>>(
        (const __nv_bfloat16*)x, A, (__nv_bfloat16*)S, rows, ranks, T, din,
        r);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// scale may be null (then every slot uses scale_all); ybase may be null
// (no base add); rows may be null (every row live).
extern "C" int rl_sb_add(const void* S, const float* B, const float* scale,
                         float scale_all, const void* ybase, void* Y,
                         const int* rows, const int* ranks, int Z, int T,
                         int r, int dout, int dtype, void* stream) {
  dim3 grid(cdiv(dout, SB_BN), cdiv(T, SB_BM), Z);
  if (!grid_ok(grid.x, grid.y, grid.z) || r < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    sb_kernel<float><<<grid, SB_THREADS, 0, st>>>(
        (const float*)S, B, scale, scale_all, (const float*)ybase, (float*)Y,
        rows, ranks, T, r, dout);
  } else if (dtype == 1) {
    sb_kernel<__nv_bfloat16><<<grid, SB_THREADS, 0, st>>>(
        (const __nv_bfloat16*)S, B, scale, scale_all,
        (const __nv_bfloat16*)ybase, (__nv_bfloat16*)Y, rows, ranks, T, r,
        dout);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
