// Rank-local grouped multi-adapter LoRA backward kernels for Hopper (sm_90a).
//
// Replaces the four backward Pallas TPU kernels of
// src/repro/kernels/grouped_lora/ranklocal.py (the custom VJP of
// ops.py:303-347, schedule ops.py:287-300):
//   rl_ds <- ranklocal.py:ds (def :231, pallas_call :240)
//            dS[z] = scale[z] * dY[z] @ B[z]^T, contraction over dout; dY
//            rows >= rows[z] and B rows >= ranks[z] masked; dS columns
//            >= ranks[z] (and rows >= rows[z]) exactly 0.
//   rl_dx <- ranklocal.py:dx (def :288, pallas_call :297)
//            dX[z] = dS[z] @ A[z]^T, contraction over rank < ranks[z]; dS
//            rows >= rows[z] and A columns >= ranks[z] masked.
//   rl_da <- ranklocal.py:da (def :346, pallas_call :355)
//            dA[z] = X[z]^T @ dS[z], contraction over token rows < rows[z];
//            dA columns >= ranks[z] exactly 0. fp32 out.
//   rl_db <- ranklocal.py:db (def :398, pallas_call :407)
//            dB[z] = scale[z] * S[z]^T @ dY[z], contraction over token rows
//            < rows[z]; dB rows >= ranks[z] exactly 0. fp32 out.
//
// Layout: x, dY, dX [Z,T,d], S, dS [Z,T,r] in one activation type (fp32 or
// bf16); A [Z,din,r] and B [Z,r,dout] fp32 masters; dA [Z,din,r] and
// dB [Z,r,dout] fp32; scale [Z] fp32; rows/ranks [Z] int32. Contiguous.
//
// Numerics (the JAX VJP's rounding points): A and B are rounded to the
// activation type in registers (the cast ops.py:69-70 does), dY arrives
// already in the activation type (the caller casts it, ops.py:80), products
// are summed in fp32, dS and dX are rounded once to the activation type, dA
// and dB stay fp32 (dB = fp32 acc * scale[z]).
//
// What bounds them on an H100, at the training shapes (T = 1024 token rows
// per slot, d in {2560, 6912}, ranks 4-32 of r_max 64): each does
// 2 * sum_z rows[z]*ranks[z]*d flops on ~2 * rows*d bytes of activations,
// i.e. about ranks[z] flops per byte, far below the ~295 the tensor cores
// need, so the bound is bytes (reading dY or X once, writing dX once).
// These first kernels run on fp32 FMA units and re-read the narrow operand
// from L2 per tile; what the design does about the bound is to touch only
// live rows and live rank tiles (dead tiles skip all loads and write exact
// zeros) and to read the fp32 masters directly, with no cast pass.
//
// Structure. The TPU kernels carry an fp32 accumulator across a sequential
// grid axis; Hopper blocks run in no order, so every contraction is a loop
// inside one block (no atomics, no split across blocks): each slot's
// results are deterministic and independent of the other slots, which the
// port's co-located == solo and migrated == never-migrated invariants need.
//   ds: narrow_out_kernel (ranklocal_common.cuh), as xa: 4 token rows x 16
//       ranks per block, the dout contraction split over 256 threads.
//   dx: rank_sum_kernel with A read transposed, as sb_add: 32 rows x 64
//       columns per block, a loop over <= 4 live 16-wide rank tiles.
//   da, db: tn_kernel below: a 2048-entry output tile (128 x 16 for dA,
//       16 x 128 for dB) per block, a loop over 32-row token chunks staged
//       in shared memory, 4 x 4 fp32 accumulators per thread.

#include "ranklocal_common.cuh"

namespace {

// ---------------------------------------------------------------------------
// OUT[z][a][b] = sc * sum_{t < rows[z]} P[z][t][a] * Q[z][t][b]  (fp32 out)
// P: [T, NA], Q: [T, NB] in the activation type; OUT: [NA, NB] fp32. The
// rank axis is b (RANK_A = false: dA = X^T dS, NB = r) or a (RANK_A = true:
// dB = S^T dY, NA = r); entries past ranks[z] on it are exactly 0, and dead
// rank tiles skip the row loop. Both operands' dead rows are masked.
// ---------------------------------------------------------------------------
constexpr int TN_BT = 32, TN_THREADS = 128;

template <typename T, int BA, int BB, bool RANK_A>
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
  const int vrows = clamp_count(rows, z, T_);
  const int vr = clamp_count(ranks, z, r);
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

template <typename Act>
int launch_ds(const void* dy, const float* B, const float* scale, void* dS,
              const int* rows, const int* ranks, int Z, int T, int dout,
              int r, cudaStream_t st) {
  dim3 grid(cdiv(r, NO_BR), cdiv(T, NO_BM), Z);
  if (!grid_ok(grid.x, grid.y, grid.z) || dout < 1)
    return (int)cudaErrorInvalidValue;
  narrow_out_kernel<Act><<<grid, NO_THREADS, 0, st>>>(
      (const Act*)dy, B, 1, dout, scale, (Act*)dS, rows, ranks, T, dout, r);
  return (int)cudaGetLastError();
}

template <typename Act>
int launch_dx(const void* dS, const float* A, void* dX, const int* rows,
              const int* ranks, int Z, int T, int din, int r,
              cudaStream_t st) {
  dim3 grid(cdiv(din, RS_BN), cdiv(T, RS_BM), Z);
  if (!grid_ok(grid.x, grid.y, grid.z) || r < 1)
    return (int)cudaErrorInvalidValue;
  rank_sum_kernel<Act, true><<<grid, RS_THREADS, 0, st>>>(
      (const Act*)dS, A, nullptr, 1.f, nullptr, (Act*)dX, rows, ranks, T, r, din);
  return (int)cudaGetLastError();
}

template <typename Act>
int launch_da(const void* x, const void* dS, float* dA, const int* rows,
              const int* ranks, int Z, int T, int din, int r,
              cudaStream_t st) {
  constexpr int BA = 128, BB = 16;
  dim3 grid(cdiv(r, BB), cdiv(din, BA), Z);
  if (!grid_ok(grid.x, grid.y, grid.z) || T < 1)
    return (int)cudaErrorInvalidValue;
  tn_kernel<Act, BA, BB, false><<<grid, TN_THREADS, 0, st>>>(
      (const Act*)x, (const Act*)dS, nullptr, dA, rows, ranks, T, din, r, r);
  return (int)cudaGetLastError();
}

template <typename Act>
int launch_db(const void* S, const void* dy, const float* scale, float* dB,
              const int* rows, const int* ranks, int Z, int T, int dout,
              int r, cudaStream_t st) {
  constexpr int BA = 16, BB = 128;
  dim3 grid(cdiv(dout, BB), cdiv(r, BA), Z);
  if (!grid_ok(grid.x, grid.y, grid.z) || T < 1)
    return (int)cudaErrorInvalidValue;
  tn_kernel<Act, BA, BB, true><<<grid, TN_THREADS, 0, st>>>(
      (const Act*)S, (const Act*)dy, scale, dB, rows, ranks, T, r, dout, r);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (the activation type of every non-master
// operand). rows may be null (every row live); scale is [Z] fp32, never
// null. Each returns cudaGetLastError() after its launch (0 = launched).
extern "C" int rl_ds(const void* dy, const float* B, const float* scale,
                     void* dS, const int* rows, const int* ranks, int Z,
                     int T, int dout, int r, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (scale == nullptr) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_ds<float>(dy, B, scale, dS, rows, ranks, Z, T, dout, r, st);
  if (dtype == 1)
    return launch_ds<__nv_bfloat16>(dy, B, scale, dS, rows, ranks, Z, T, dout,
                                    r, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int rl_dx(const void* dS, const float* A, void* dX,
                     const int* rows, const int* ranks, int Z, int T,
                     int din, int r, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_dx<float>(dS, A, dX, rows, ranks, Z, T, din, r, st);
  if (dtype == 1)
    return launch_dx<__nv_bfloat16>(dS, A, dX, rows, ranks, Z, T, din, r, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int rl_da(const void* x, const void* dS, float* dA,
                     const int* rows, const int* ranks, int Z, int T,
                     int din, int r, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_da<float>(x, dS, dA, rows, ranks, Z, T, din, r, st);
  if (dtype == 1)
    return launch_da<__nv_bfloat16>(x, dS, dA, rows, ranks, Z, T, din, r, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int rl_db(const void* S, const void* dy, const float* scale,
                     float* dB, const int* rows, const int* ranks, int Z,
                     int T, int dout, int r, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (scale == nullptr) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_db<float>(S, dy, scale, dB, rows, ranks, Z, T, dout, r, st);
  if (dtype == 1)
    return launch_db<__nv_bfloat16>(S, dy, scale, dB, rows, ranks, Z, T, dout,
                                    r, st);
  return (int)cudaErrorInvalidValue;
}
