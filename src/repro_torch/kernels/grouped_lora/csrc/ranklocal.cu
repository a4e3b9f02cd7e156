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
// bytes. In training (T = 1024 rows per slot) xa does 2*T flops per A value
// read, still bytes. The design reads only live rank columns (dead rank
// tiles are skipped, the boundary tile is masked on load) and reads the
// fp32 masters directly instead of a separate cast pass. In bf16, xa runs
// on the tensor cores (mma.sync, fp32 accumulators) over cp.async stages:
// a 16-row x 8-rank tile a block at decode, so a slot's A is spread over
// ranks[z] / 8 blocks, and 32 x 32 in training, each master tile read once
// per 32 rows. In bf16, sb_add runs on the tensor cores too, writing each
// output row once in 16-byte stores: a 16-row x 64-column tile a block at
// decode (a slot's B spread over dout / 64 blocks), 128 x 128 in training,
// the live ranks staged at once and contracted in k16 steps up to
// ranks[z]. Every fp32 instantiation runs on fp32 FMA units (1e-5
// relative, which TF32 cannot hold). A decode step of
// stablelm-3b launches 7 targets x 32 layers x 2 = 448 of these kernels,
// so launch overhead will likely dominate until a later change captures the
// step in a CUDA graph.
//
// Structure (ranklocal_common.cuh, ROWS = RANKS = true): the TPU grid's
// sequential contraction axis becomes a loop inside the block (xa's split
// over the block's 8 warps in a fixed order, a function of din alone);
// each block reads rows[z] and ranks[z] itself; edges are masked in the
// kernel (no padding to tile multiples).

#include "ranklocal_common.cuh"

// dtype: 0 = float32, 1 = bfloat16. rows may be null (every row live).
// plan: an index into GL_PLANS (bf16 only), negative = the default tile.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int rl_xa(const void* x, const float* A, void* S, const int* rows,
                     const int* ranks, int Z, int T, int din, int r,
                     int dtype, int plan, void* stream) {
  GL_DISPATCH_ACT(dtype, launch_xa<Act, true, true>(
      x, A, S, rows, ranks, Z, T, din, r, plan,
      (cudaStream_t)stream));
}

// scale may be null (then every slot uses scale_all); ybase may be null
// (no base add); rows may be null (every row live).
extern "C" int rl_sb_add(const void* S, const float* B, const float* scale,
                         float scale_all, const void* ybase, void* Y,
                         const int* rows, const int* ranks, int Z, int T,
                         int r, int dout, int dtype, int plan,
                         void* stream) {
  GL_DISPATCH_ACT(dtype, launch_sb_add<Act, true, true>(
      S, B, scale, scale_all, ybase, Y, rows, ranks, Z, T, r, dout, plan,
      (cudaStream_t)stream));
}

// The compiled plan set (GL_PLANS, ranklocal_common.cuh): the number of
// plans, and plan i's (bm, bn, br) in out[0..2] (-1 for an index outside
// the set). The wrappers hold a copy of the list (autotune.PLAN_SET); the
// autotuner's card check compares the two.
extern "C" int gl_plan_count() {
#define GL_PLAN_ONE(i, bm, bn, br) +1
  return 0 GL_PLANS(GL_PLAN_ONE);
#undef GL_PLAN_ONE
}

extern "C" int gl_plan_tiles(int i, int* out) {
  return with_plan(i, [&](auto p) {
    using P = decltype(p);
    out[0] = P::bm;
    out[1] = P::bn;
    out[2] = P::br;
    return 0;
  });
}
