// Dense grouped multi-adapter LoRA kernels for Hopper (sm_90a): every slot
// at full rank r and every token row live.
//
// Replaces the six Pallas TPU kernels of
// src/repro/kernels/grouped_lora/grouped_lora.py (the custom VJP of
// ops.py:112-170):
//   gl_xa     <- grouped_lora.py:xa     (def :64,  pallas_call :71)
//                S[z] = X[z] @ A[z], fp32 sums over din, S in x's dtype.
//   gl_sb_add <- grouped_lora.py:sb_add (def :102, pallas_call :121;
//                _sb_kernel :89 and _sb_add_kernel :95 as one kernel with an
//                optional base pointer)
//                Y[z] = (S[z] @ B[z]) * scale[z] (+ Y_base[z]).
//   gl_ds     <- grouped_lora.py:ds     (def :155, pallas_call :162)
//                dS[z] = scale[z] * dY[z] @ B[z]^T, fp32 sums over dout.
//   gl_dx     <- grouped_lora.py:dx     (def :190, pallas_call :197)
//                dX[z] = dS[z] @ A[z]^T.
//   gl_da     <- grouped_lora.py:da     (def :231, pallas_call :238)
//                dA[z] = X[z]^T @ dS[z], fp32 sums over T, fp32 out.
//   gl_db     <- grouped_lora.py:db     (def :268, pallas_call :275)
//                dB[z] = scale[z] * S[z]^T @ dY[z], fp32 out.
//
// Layout: x, dY, dX, Y, Y_base [Z,T,d] and S, dS [Z,T,r] in one activation
// type (fp32 or bf16); A [Z,din,r] and B [Z,r,dout] fp32 masters; dA
// [Z,din,r] and dB [Z,r,dout] fp32; scale [Z] fp32. All contiguous.
//
// Numerics (the JAX package's rounding points): A and B are rounded to the
// activation type in registers (the cast ops.py:69-70 makes before its
// kernels), products are summed in fp32, S, Y, dS and dX are rounded once
// to the activation type, dA and dB stay fp32.
//
// Structure: these are the rank-local kernels' templates
// (ranklocal_common.cuh) instantiated with ROWS = RANKS = false — the same
// grids, tiles and fp32 summation order with the row and rank tests
// compiled out — so each output element equals, bit for bit, the
// rank-local kernel's at ranks = r and rows = T, and the ragged kernel's
// (ragged.cu) at rows = T. The executor relies on it: a full-rank slot takes
// these kernels when every resident slot is full-width and at r_max, the
// ragged ones beside a narrower co-tenant and the rank-local ones beside a
// lower-rank co-tenant, and its losses must not move a bit
// (docs/ARCHITECTURE.md, "Bitwise loss isolation"). Not re-derived from
// the Pallas tiling: the TPU kernels carry their fp32 sums across a
// sequential grid axis, which Hopper blocks do not have.
//
// What bounds them on an H100, at the training shapes (T = 1,024 rows per
// slot, d in {2560, 6912}, r = 64): each reads one [Z,T,d] activation and
// the fp32 master once and does 2*T*r*d flops per slot, ~r flops per byte,
// far below the ~295 the tensor cores need, so the bound is bytes (about
// 24 MB, ~0.007 ms at din = dout = 2560). In bf16 all six contract on the
// tensor cores (mma.sync, fp32 accumulators) over operand tiles staged by
// cp.async: xa and ds read each activation row once per 32 rank columns
// and their fp32 master once per 64-row tile; da and db read each
// activation row once (a block holds all 64 ranks); sb_add and dx write
// each wide output row once, in 16-byte stores, from 128 x 128 tiles that
// stage the whole rank extent, so their master crosses L2 once per 128
// rows. Every fp32 instantiation stays on the FMA units (fp32 must hold
// 1e-5 relative, which TF32 cannot). A redesign for speed has to change
// the rank-local and ragged twins with it, or the bitwise contract above
// breaks.

#include "ranklocal_common.cuh"

// dtype: 0 = float32, 1 = bfloat16 (the activation type of every non-master
// operand). scale is [Z] fp32, never null; ybase may be null (no base add).
// plan: an index into GL_PLANS (bf16 only), negative = the default tile.
// Each returns cudaGetLastError() after its launch (0 = launched).
extern "C" int gl_xa(const void* x, const float* A, void* S, int Z, int T,
                     int din, int r, int dtype, int plan, void* stream) {
  GL_DISPATCH_ACT(dtype, launch_xa<Act, false, false>(
      x, A, S, nullptr, nullptr, Z, T, din, r, plan,
      (cudaStream_t)stream));
}

extern "C" int gl_sb_add(const void* S, const float* B, const float* scale,
                         const void* ybase, void* Y, int Z, int T, int r,
                         int dout, int dtype, int plan, void* stream) {
  if (scale == nullptr) return (int)cudaErrorInvalidValue;
  GL_DISPATCH_ACT(dtype, launch_sb_add<Act, false, false>(
      S, B, scale, 0.f, ybase, Y, nullptr, nullptr, Z, T, r, dout, plan,
      (cudaStream_t)stream));
}

extern "C" int gl_ds(const void* dy, const float* B, const float* scale,
                     void* dS, int Z, int T, int dout, int r, int dtype,
                     int plan, void* stream) {
  GL_DISPATCH_ACT(dtype, launch_ds<Act, false, false>(
      dy, B, scale, dS, nullptr, nullptr, Z, T, dout, r, plan,
      (cudaStream_t)stream));
}

extern "C" int gl_dx(const void* dS, const float* A, void* dX, int Z, int T,
                     int din, int r, int dtype, int plan, void* stream) {
  GL_DISPATCH_ACT(dtype, launch_dx<Act, false, false>(
      dS, A, dX, nullptr, nullptr, Z, T, din, r, plan,
      (cudaStream_t)stream));
}

extern "C" int gl_da(const void* x, const void* dS, float* dA, int Z, int T,
                     int din, int r, int dtype, int plan, void* stream) {
  GL_DISPATCH_ACT(dtype, launch_da<Act, false, false>(
      x, dS, dA, nullptr, nullptr, Z, T, din, r, plan,
      (cudaStream_t)stream));
}

extern "C" int gl_db(const void* S, const void* dy, const float* scale,
                     float* dB, int Z, int T, int dout, int r, int dtype,
                     int plan, void* stream) {
  GL_DISPATCH_ACT(dtype, launch_db<Act, false, false>(
      S, dy, scale, dB, nullptr, nullptr, Z, T, dout, r, plan,
      (cudaStream_t)stream));
}
