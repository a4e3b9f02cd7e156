// Ragged grouped multi-adapter LoRA kernels for Hopper (sm_90a): every slot
// at full rank r, slot z confined to its first rows[z] token rows.
//
// Replaces the six Pallas TPU kernels of
// src/repro/kernels/grouped_lora/ragged.py (the custom VJP of
// ops.py:174-270):
//   rg_xa     <- ragged.py:xa     (def :71,  pallas_call :80)
//                S[z] = X[z] @ A[z] over token rows < rows[z]; S rows past
//                rows[z] are exactly 0.
//   rg_sb_add <- ragged.py:sb_add (def :133, pallas_call :152; _sb_kernel
//                :102 and _sb_add_kernel :117 as one kernel with an optional
//                base pointer)
//                Y[z] = (S[z] @ B[z]) * scale[z] (+ Y_base[z]) on rows <
//                rows[z]; dead rows give 0, or Y_base passed through.
//   rg_ds     <- ragged.py:ds     (def :190, pallas_call :198)
//                dS[z] = scale[z] * dY[z] @ B[z]^T, dY rows past rows[z]
//                masked; dS rows past rows[z] exactly 0.
//   rg_dx     <- ragged.py:dx     (def :236, pallas_call :244)
//                dX[z] = dS[z] @ A[z]^T on rows < rows[z], zeros past them.
//   rg_da     <- ragged.py:da     (def :286, pallas_call :295)
//                dA[z] = X[z]^T @ dS[z] over rows < rows[z], fp32 out.
//   rg_db     <- ragged.py:db     (def :333, pallas_call :341)
//                dB[z] = scale[z] * S[z]^T @ dY[z] over rows < rows[z],
//                fp32 out.
//
// Layout: x, dY, dX, Y, Y_base [Z,T,d] and S, dS [Z,T,r] in one activation
// type (fp32 or bf16); A [Z,din,r] and B [Z,r,dout] fp32 masters; dA
// [Z,din,r] and dB [Z,r,dout] fp32; scale [Z] fp32; rows [Z] int32 (clamped
// to [0, T]). All contiguous.
//
// Numerics (the JAX package's rounding points, as in the dense and
// rank-local kernels): A and B rounded to the activation type in registers,
// products summed in fp32, S, Y, dS and dX rounded once to the activation
// type, dA and dB fp32.
//
// Structure: the templates of ranklocal_common.cuh instantiated with ROWS =
// true and RANKS = false: each block reads rows[z], a dead row tile skips
// its loads and MMAs or FMAs (in xa/ds/sb_add/dx the block's tile, in da/db
// the token loop stops at rows[z]) and the boundary tile is masked on load,
// while the rank tests are compiled out. One fp32 summation order per
// output element with the dense and rank-local instantiations (in bf16 all
// six run on the tensor cores, their order a function of the contraction
// length alone), so a ragged kernel equals its dense twin at rows = T and
// its rank-local twin at ranks = r for any rows, bit for bit — what the
// co-located == solo contract needs when a full-rank slot's co-tenants
// change width. fp32 instantiations run on the FMA units (1e-5 relative,
// which TF32 cannot hold).
//
// Unlike the TPU kernels, which skip whole 128-row tiles, a narrow slot
// here pays at most for the rest of the tile holding its last live row: 64
// rows (bf16 xa, ds), 16 (da, db: one k16 step) or 16 (bf16 sb_add, dx:
// one m16 step of a 128-row tile; its dead rows are written, as 0 or the
// base, but read no operand). The backbone still runs over the padded
// lane; only the LoRA kernels skip the dead rows.

#include "ranklocal_common.cuh"

// dtype: 0 = float32, 1 = bfloat16 (the activation type of every non-master
// operand). plan: an index into GL_PLANS (bf16 only), negative = the
// default tile. rows is [Z] int32, never null; scale is [Z] fp32, never null;
// ybase may be null (no base add). Each returns cudaGetLastError() after
// its launch (0 = launched).
extern "C" int rg_xa(const void* x, const float* A, void* S, const int* rows,
                     int Z, int T, int din, int r, int dtype, int plan,
                     void* stream) {
  if (rows == nullptr) return (int)cudaErrorInvalidValue;
  GL_DISPATCH_ACT(dtype, launch_xa<Act, true, false>(
      x, A, S, rows, nullptr, Z, T, din, r, plan,
      (cudaStream_t)stream));
}

extern "C" int rg_sb_add(const void* S, const float* B, const float* scale,
                         const void* ybase, void* Y, const int* rows, int Z,
                         int T, int r, int dout, int dtype, int plan,
                         void* stream) {
  if (rows == nullptr || scale == nullptr) return (int)cudaErrorInvalidValue;
  GL_DISPATCH_ACT(dtype, launch_sb_add<Act, true, false>(
      S, B, scale, 0.f, ybase, Y, rows, nullptr, Z, T, r, dout, plan,
      (cudaStream_t)stream));
}

extern "C" int rg_ds(const void* dy, const float* B, const float* scale,
                     void* dS, const int* rows, int Z, int T, int dout, int r,
                     int dtype, int plan, void* stream) {
  if (rows == nullptr) return (int)cudaErrorInvalidValue;
  GL_DISPATCH_ACT(dtype, launch_ds<Act, true, false>(
      dy, B, scale, dS, rows, nullptr, Z, T, dout, r, plan,
      (cudaStream_t)stream));
}

extern "C" int rg_dx(const void* dS, const float* A, void* dX,
                     const int* rows, int Z, int T, int din, int r, int dtype,
                     int plan, void* stream) {
  if (rows == nullptr) return (int)cudaErrorInvalidValue;
  GL_DISPATCH_ACT(dtype, launch_dx<Act, true, false>(
      dS, A, dX, rows, nullptr, Z, T, din, r, plan,
      (cudaStream_t)stream));
}

extern "C" int rg_da(const void* x, const void* dS, float* dA,
                     const int* rows, int Z, int T, int din, int r, int dtype,
                     int plan, void* stream) {
  if (rows == nullptr) return (int)cudaErrorInvalidValue;
  GL_DISPATCH_ACT(dtype, launch_da<Act, true, false>(
      x, dS, dA, rows, nullptr, Z, T, din, r, plan,
      (cudaStream_t)stream));
}

extern "C" int rg_db(const void* S, const void* dy, const float* scale,
                     float* dB, const int* rows, int Z, int T, int dout,
                     int r, int dtype, int plan, void* stream) {
  if (rows == nullptr) return (int)cudaErrorInvalidValue;
  GL_DISPATCH_ACT(dtype, launch_db<Act, true, false>(
      S, dy, scale, dB, rows, nullptr, Z, T, dout, r, plan,
      (cudaStream_t)stream));
}
