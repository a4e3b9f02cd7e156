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
// What the design does about the bound: touch only live rows and live rank
// tiles (dead tiles skip all loads and write exact zeros), read the fp32
// masters directly, with no cast pass, and in bf16 contract all four on
// the tensor cores (mma.sync, fp32 accumulators) over cp.async stages,
// reading dY once per 32 rank columns (ds), X or dY once (da, db), and
// writing dX once in 16-byte stores (dx). Every fp32 instantiation runs on
// fp32 FMA units (fp32 holds 1e-5 relative, which TF32 cannot).
//
// Structure. The TPU kernels carry an fp32 accumulator across a sequential
// grid axis; Hopper blocks run in no order, so every contraction is a loop
// inside one block (no atomics, no split across blocks): each slot's
// results are deterministic and independent of the other slots, which the
// port's co-located == solo and migrated == never-migrated invariants need.
// All in ranklocal_common.cuh, instantiated with ROWS = RANKS = true:
//   ds: narrow_out_kernel, as xa: in bf16 32 token rows x 32 ranks per
//       block (16 x 8 when T <= 16), the dout contraction split over the
//       block's 8 warps in k32 chunks (warp w takes chunks w, w + 8, ...),
//       the partial tiles summed in warp order; in fp32 4 rows x 16 ranks,
//       the contraction split over 256 threads.
//   dx: rank_sum_kernel with A read transposed, as sb_add: in bf16 128
//       rows x 128 columns per block (16 x 64 when T <= 16), the live
//       ranks staged at once, rounded to bf16 into a [column][rank] tile
//       and contracted in k16 steps up to ranks[z]; in fp32 32 rows x 64
//       columns, a loop over <= 4 live 16-wide rank tiles.
//   da, db: tn_kernel: in bf16 a 64 x 64 output tile per block (every rank
//       of r_max 64 on one side), 8 warps of 32 x 16, the token loop in
//       128-row stages, k16 steps from row 0 up to rows[z]; in fp32 a
//       2048-entry tile (128 x 16 for dA, 16 x 128 for dB), a loop over
//       32-row token chunks staged in shared memory, 4 x 4 fp32
//       accumulators per thread.

#include "ranklocal_common.cuh"

// dtype: 0 = float32, 1 = bfloat16 (the activation type of every non-master
// operand). plan: an index into GL_PLANS (bf16 only), negative = the
// default tile. rows may be null (every row live); scale is [Z] fp32, never
// null. Each returns cudaGetLastError() after its launch (0 = launched).
extern "C" int rl_ds(const void* dy, const float* B, const float* scale,
                     void* dS, const int* rows, const int* ranks, int Z,
                     int T, int dout, int r, int dtype, int plan,
                     void* stream) {
  GL_DISPATCH_ACT(dtype, launch_ds<Act, true, true>(
      dy, B, scale, dS, rows, ranks, Z, T, dout, r, plan,
      (cudaStream_t)stream));
}

extern "C" int rl_dx(const void* dS, const float* A, void* dX,
                     const int* rows, const int* ranks, int Z, int T,
                     int din, int r, int dtype, int plan, void* stream) {
  GL_DISPATCH_ACT(dtype, launch_dx<Act, true, true>(
      dS, A, dX, rows, ranks, Z, T, din, r, plan,
      (cudaStream_t)stream));
}

extern "C" int rl_da(const void* x, const void* dS, float* dA,
                     const int* rows, const int* ranks, int Z, int T,
                     int din, int r, int dtype, int plan, void* stream) {
  GL_DISPATCH_ACT(dtype, launch_da<Act, true, true>(
      x, dS, dA, rows, ranks, Z, T, din, r, plan,
      (cudaStream_t)stream));
}

extern "C" int rl_db(const void* S, const void* dy, const float* scale,
                     float* dB, const int* rows, const int* ranks, int Z,
                     int T, int dout, int r, int dtype, int plan,
                     void* stream) {
  GL_DISPATCH_ACT(dtype, launch_db<Act, true, true>(
      S, dy, scale, dB, rows, ranks, Z, T, dout, r, plan,
      (cudaStream_t)stream));
}
