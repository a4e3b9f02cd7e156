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
// All three run one fp32 summation order per output element, so at full
// rank and every row live they agree bit for bit: dense == ragged at rows
// = T == rank-local at ranks = r_max, and ragged == rank-local at ranks =
// r_max for any rows. The executor needs it: a full-rank slot takes the
// dense kernels when its co-tenants are full-width and full-rank, the
// ragged ones beside a narrower co-tenant and the rank-local ones beside a
// lower-rank co-tenant, and its losses must not move a bit. A speed change
// to one instantiation is a change to all three.
//
// Every kernel rounds the fp32 adapter masters to the activation type once
// and sums in fp32 in a fixed order inside one block (no atomics, no split
// of a contraction across blocks), so a slot's result depends on nothing
// but its own operands. In bf16 all three templates contract on the tensor
// cores (mma.sync m16n8k16, fp32 accumulators) over operands staged with
// cp.async; their fp32 instantiations run on the fp32 FMA units: the fp32
// path must hold the plain versions to 1e-5 relative, which TF32 tensor
// cores (10-bit mantissas) cannot, and nothing timed runs in fp32. Each
// template picks its body at compile time (if constexpr on the type).
//
// Included by each .cu file; everything is in an anonymous namespace so the
// translation units keep separate copies. The tensor-core and copy
// primitives are in ../../tensor_core.cuh, shared with flash attention.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "../../tensor_core.cuh"

namespace {

using bf16 = __nv_bfloat16;

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<bf16>(bf16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
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

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

bool grid_ok(int gx, int gy, int gz) {
  return gx >= 1 && gy >= 1 && gz >= 1 && gy <= 65535 && gz <= 65535;
}

// ---------------------------------------------------------------------------
// narrow_out_kernel:
// OUT[z][t][j] = scale[z] * sum_k X[z][t][k] * W[z](k, j), for token rows
// t < rows[z] and rank columns j < ranks[z]; every other entry exactly 0.
// W(k, j) is the fp32 master: W_KN -> W [K, r] (xa's A: sk = r, sj = 1),
// else W [r, K] (ds's B: sk = 1, sj = K).
//
// bf16 (every timed call). What bounds it: 2*T*r*K flops on T*K bf16
// activations plus K*r fp32 masters, ~r flops a byte, far below the ~295
// the tensor cores need: bytes. A block owns BM token rows x BN rank
// columns of one slot (by default; a tile plan may pick another tile):
// 64 x 32 (32 x 32 for rank-local calls, where most
// rank tiles past 32 are dead; 16 x 8 when a slot has at most 16 rows, as
// at decode, so that a slot's master spreads over ranks[z] / 8 blocks).
// The tile moves no bit. Its 8 warps split the contraction: warp w takes
// the k32 chunks k0 = 32*w + 256*i, i = 0, 1, ..., and each chunk's two k16
// steps in order, accumulating with mma.sync in fp32 registers; the 8
// partial tiles meet in shared memory and are summed in warp order 0..7.
// That order depends on K alone, so every output element has one summation
// order whatever T, rows, ranks, Z or the tile. Each 256-wide k stage
// lands in a ring of up to 8 shared-memory buffers (220 KB: one block an
// SM) by cp.async, 16 bytes a thread, coalesced (the X tile in rows of 256
// bf16, the master in rows of BN (xa) or 256 (ds) fp32), with dead rows,
// dead rank columns and the K tail filled with zeros instead of read:
// large stages, because each stage costs a barrier and a wait. X fragments
// come by ldmatrix; each warp rounds the fp32 master entries of its own
// k16 step to bf16 (__floats2bfloat162_rn, the value round_to gives)
// straight into B fragments, so every master entry is rounded once per
// block. Dead rank n8 tiles and dead row m16 tiles skip their MMAs; a block
// with no live row or rank skips every load. The epilogue scales (ds),
// zeroes every entry past rows[z] / ranks[z] and rounds once. A row that
// is not 16-byte aligned (K % 8, r % 4, or the pointer) takes masked scalar
// loads into the same tiles: the MMA sequence stays the same. What is left
// between it and the byte bound: the fp32 master is read once per row tile
// from L2 (twice the bytes of a bf16 copy), and X once per 32 ranks.
//
// fp32 (FMA, unchanged): one block per (4 token rows, 16 rank columns,
// slot); the K contraction is split over the block's 256 threads (thread
// k-strided), each thread keeping a 4 x 16 fp32 partial tile in registers;
// warp shuffles and one shared-memory pass sum the partials in a fixed
// order.
// ---------------------------------------------------------------------------
constexpr int NO_BM = 4, NO_BR = 16, NO_THREADS = 256;
constexpr int NO_WARPS = NO_THREADS / 32;
constexpr int NO_KW = 32;                    // k per warp per stage
constexpr int NO_BK = NO_WARPS * NO_KW;      // k per stage
constexpr int NO_XS = NO_BK + 8;             // bf16 row stride of an X tile
constexpr int NO_SMEM_BUDGET = 220 * 1024;   // ring bytes: 1 block an SM
constexpr int NO_MAX_STAGES = 8;

template <int BM, int BN, bool W_KN> struct NoTile {
  static_assert(BM % 16 == 0 && BN % 8 == 0, "m16 x n8 MMA tiles");
  // fp32 row stride of the master tile: [256 k][BN] (xa) or [BN][256 k]
  // (ds), padded so that the fragment reads hit 32 distinct banks
  static constexpr int WS = W_KN ? BN + 4 : NO_BK + 8;
  static constexpr int X_BYTES = BM * NO_XS * 2;
  static constexpr int W_BYTES = (W_KN ? NO_BK : BN) * WS * 4;
  static constexpr int STAGE = X_BYTES + W_BYTES;
  static constexpr int STAGES = NO_SMEM_BUDGET / STAGE < NO_MAX_STAGES
                                    ? NO_SMEM_BUDGET / STAGE
                                    : NO_MAX_STAGES;
  static_assert(STAGES >= 2, "a ring of at least two stages");
  // fp32 row stride of a warp's partial tile in the reduction
  static constexpr int RS = (BN % 32 == 8 || BN % 32 == 24) ? BN : BN + 8;
  static constexpr int RED = NO_WARPS * BM * RS * 4;
  static constexpr int SMEM = STAGES * STAGE > RED ? STAGES * STAGE : RED;
};

template <typename T, bool ROWS, bool RANKS>
__device__ __forceinline__ void narrow_out_fma(
    const T* __restrict__ X, const float* __restrict__ W, int sk, int sj,
    const float* __restrict__ scale, T* __restrict__ OUT,
    const int* __restrict__ rows, const int* __restrict__ ranks, int T_,
    int K, int r) {
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

// vec bit 0: X rows are 16-byte aligned (cp.async); bit 1: the master's are
template <bool W_KN, int BM, int BN, bool ROWS, bool RANKS>
__device__ __forceinline__ void narrow_out_mma(
    const bf16* __restrict__ X, const float* __restrict__ W,
    const float* __restrict__ scale, bf16* __restrict__ OUT,
    const int* __restrict__ rows, const int* __restrict__ ranks, int T_,
    int K, int r, int vec) {
  using Cfg = NoTile<BM, BN, W_KN>;
  constexpr int MT = BM / 16, NT = BN / 8, WS = Cfg::WS;
  extern __shared__ __align__(16) unsigned char smem[];
  const int z = blockIdx.z;
  const int m0 = blockIdx.y * BM;
  const int j0 = blockIdx.x * BN;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int nrow = min(BM, live_count<ROWS>(rows, z, T_) - m0);  // live rows
  const int ncol = min(BN, live_count<RANKS>(ranks, z, r) - j0);  // ranks
  const bf16* xz = X + ((size_t)z * T_ + m0) * K;
  const float* wz = W + (size_t)z * K * r;

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0.f;

  // stage s (k in [NO_BK s, NO_BK s + NO_BK)) into ring buffer b
  auto load = [&](int s, int b) {
    unsigned char* st = smem + b * Cfg::STAGE;
    bf16* xs = reinterpret_cast<bf16*>(st);
    float* ws = reinterpret_cast<float*>(st + Cfg::X_BYTES);
    const int k0 = s * NO_BK;
    if (vec & 1) {
      for (int e = tid; e < BM * (NO_BK / 8); e += NO_THREADS) {
        const int m = e / (NO_BK / 8), c = e % (NO_BK / 8), k = k0 + 8 * c;
        const bool ok = m < nrow && k < K;
        cp_async16(xs + m * NO_XS + 8 * c, ok ? xz + (size_t)m * K + k : X,
                   ok);
      }
    } else {
      for (int e = tid; e < BM * NO_BK; e += NO_THREADS) {
        const int m = e / NO_BK, kk = e % NO_BK, k = k0 + kk;
        xs[m * NO_XS + kk] = (m < nrow && k < K) ? xz[(size_t)m * K + k]
                                                 : __float2bfloat16_rn(0.f);
      }
    }
    if constexpr (W_KN) {          // A [K, r]: a row of r rank columns
      if (vec & 2) {
        for (int e = tid; e < NO_BK * (BN / 4); e += NO_THREADS) {
          const int kk = e / (BN / 4), c = e % (BN / 4), k = k0 + kk;
          const bool ok = k < K && 4 * c < ncol;
          cp_async16(ws + kk * WS + 4 * c,
                     ok ? wz + (size_t)k * r + j0 + 4 * c : W, ok);
        }
      } else {
        for (int e = tid; e < NO_BK * BN; e += NO_THREADS) {
          const int kk = e / BN, n = e % BN, k = k0 + kk;
          ws[kk * WS + n] =
              (k < K && n < ncol) ? wz[(size_t)k * r + j0 + n] : 0.f;
        }
      }
    } else {                       // B [r, K]: a row of K contraction entries
      if (vec & 2) {
        for (int e = tid; e < BN * (NO_BK / 4); e += NO_THREADS) {
          const int n = e / (NO_BK / 4), c = e % (NO_BK / 4), k = k0 + 4 * c;
          const bool ok = n < ncol && k < K;
          cp_async16(ws + n * WS + 4 * c,
                     ok ? wz + (size_t)(j0 + n) * K + k : W, ok);
        }
      } else {
        for (int e = tid; e < BN * NO_BK; e += NO_THREADS) {
          const int n = e / NO_BK, kk = e % NO_BK, k = k0 + kk;
          ws[n * WS + kk] =
              (n < ncol && k < K) ? wz[(size_t)(j0 + n) * K + k] : 0.f;
        }
      }
    }
  };

  // this warp's k16 step of ring buffer b
  const int g = lane / 4, c2 = 2 * (lane % 4);
  const int lq = lane / 8, li = lane % 8;
  auto compute = [&](int b) {
    const unsigned char* st = smem + b * Cfg::STAGE;
    const bf16* xs = reinterpret_cast<const bf16*>(st);
    const float* ws = reinterpret_cast<const float*>(st + Cfg::X_BYTES);
#pragma unroll
    for (int kw = warp * NO_KW; kw < (warp + 1) * NO_KW; kw += 16) {
      uint32_t bfr[NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        if (8 * nt >= ncol) break;                  // dead rank n8 tiles
        const int n = 8 * nt + g, k = kw + c2;
        if constexpr (W_KN) {
          bfr[nt][0] = pack_bf16(ws[k * WS + n], ws[(k + 1) * WS + n]);
          bfr[nt][1] = pack_bf16(ws[(k + 8) * WS + n], ws[(k + 9) * WS + n]);
        } else {
          const float2 lo = *reinterpret_cast<const float2*>(ws + n * WS + k);
          const float2 hi =
              *reinterpret_cast<const float2*>(ws + n * WS + k + 8);
          bfr[nt][0] = pack_bf16(lo.x, lo.y);
          bfr[nt][1] = pack_bf16(hi.x, hi.y);
        }
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if (16 * mt >= nrow) break;                 // dead row m16 tiles
        uint32_t afr[4];
        ldsm_x4(afr, xs + (16 * mt + li + 8 * (lq & 1)) * NO_XS + kw +
                         8 * (lq >> 1));
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          if (8 * nt >= ncol) break;
          mma_bf16(acc[mt][nt], afr, bfr[nt][0], bfr[nt][1]);
        }
      }
    }
  };

  constexpr int S = Cfg::STAGES;
  const int nst = (nrow > 0 && ncol > 0) ? cdiv(K, NO_BK) : 0;
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < nst) load(s, s);
    cp_async_commit();
  }
  for (int s = 0; s < nst; ++s) {
    cp_async_wait<S - 2>();
    __syncthreads();               // stage s landed; stage s - 1 consumed
    if (s + S - 1 < nst) load(s + S - 1, (s + S - 1) % S);
    cp_async_commit();
    compute(s % S);
  }
  cp_async_wait<0>();
  __syncthreads();

  // the 8 warps' partial tiles, summed in warp order
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float* p = red + (warp * BM + 16 * mt + g) * Cfg::RS + 8 * nt + c2;
      *reinterpret_cast<float2*>(p) = make_float2(acc[mt][nt][0],
                                                  acc[mt][nt][1]);
      *reinterpret_cast<float2*>(p + 8 * Cfg::RS) =
          make_float2(acc[mt][nt][2], acc[mt][nt][3]);
    }
  __syncthreads();
  const float sc = scale != nullptr ? scale[z] : 1.f;
  for (int e = tid; e < BM * BN; e += NO_THREADS) {
    const int m = e / BN, n = e % BN, t = m0 + m, j = j0 + n;
    if (t >= T_ || j >= r) continue;
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < NO_WARPS; ++w) v += red[(w * BM + m) * Cfg::RS + n];
    if (scale != nullptr) v *= sc;
    if (m >= nrow || n >= ncol) v = 0.f;                    // exact zeros
    OUT[((size_t)z * T_ + t) * r + j] = __float2bfloat16_rn(v);
  }
}

// BM, BN and W_KN shape the bf16 path only; the fp32 path reads the
// master's layout from sk, sj, and its launcher fixes the three, so xa
// and ds share one fp32 kernel
template <typename T, bool W_KN, int BM, int BN, bool ROWS, bool RANKS>
__global__ void __launch_bounds__(NO_THREADS)
narrow_out_kernel(const T* __restrict__ X, const float* __restrict__ W,
                  int sk, int sj, const float* __restrict__ scale,
                  T* __restrict__ OUT, const int* __restrict__ rows,
                  const int* __restrict__ ranks, int T_, int K, int r,
                  int vec) {
  if constexpr (std::is_same<T, float>::value)
    narrow_out_fma<T, ROWS, RANKS>(X, W, sk, sj, scale, OUT, rows, ranks, T_,
                                   K, r);
  else
    narrow_out_mma<W_KN, BM, BN, ROWS, RANKS>(X, W, scale, OUT, rows, ranks,
                                              T_, K, r, vec);
}

// ---------------------------------------------------------------------------
// rank_sum_kernel:
// OUT[z][t][n] = (sum_{j < ranks[z]} S[z][t][j] * W[z](j, n)) * scale[z]
// (+ BASE[z][t][n]) for t < rows[z]; dead rows give acc = 0 (the base
// passes through). W(j, n) is the fp32 master: W_T = false -> W [r, N]
// (sb_add's B), W_T = true -> W [N, r] (dx's A, read transposed).
//
// bf16 (every timed call). What bounds it: 2*T*r*N flops on a [T, N] bf16
// output (and as many base bytes for sb_add), T*r bf16 of S and r*N fp32
// masters, ~r/2 flops a byte: bytes, almost all of them the wide output.
// So the design moves each output byte once, in 16-byte stores, and keeps
// the rest on chip. A block owns BM token rows x BN output columns of one
// slot (by default; a tile plan may pick another tile): 128 x 128, its 8
// warps 32 x 64 each (2 m16 x 8 n8 tiles, fp32
// accumulators), so the fp32 master crosses L2 once per 128 rows and S
// once per 128 columns; at T <= 16 (decode) 16 x 64, each warp 16 x 8, so
// a slot's master spreads over N / 64 blocks. The block stages the whole
// live rank extent at once (64 ranks a chunk): S by cp.async (zero-filled
// past rows[z] and ranks[z] instead of read) and the master by 16-byte
// loads, rounded once to bf16 (__floats2bfloat162_rn, the value round_to
// gives) into the layout the MMA's B operand wants ([rank][column] for
// ldmatrix.trans, [column][rank] for ldmatrix). The contraction runs with
// mma.sync m16n8k16 in k16 steps from rank 0 up to the live extent,
// never split, so every output element has one summation order, a
// function of the rank extent alone: the same bits whatever T, rows, Z or
// the tile, and in the three sets where they meet. The accumulators pass
// through shared memory to an epilogue in which each thread writes 8
// outputs, v = fmaf(acc, scale, base) (acc * scale without a base), in
// one 16-byte store beside one 16-byte base load. A row or pointer that is
// not 16-byte aligned takes masked scalar loads and stores on the same
// tiles: the MMA sequence and the epilogue's arithmetic stay the same.
// What is left between it and the byte bound: one stage a block, so a
// block's loads, MMAs and stores do not overlap inside it, only across the
// two or three blocks an SM holds.
//
// fp32 (FMA, unchanged): one block of 128 threads per (32 token rows, 64
// output columns, slot); the rank contraction is a loop over 16-wide rank
// tiles that stops at ranks[z]; each thread owns a 4 x 4 micro-tile
// (columns strided by 16 so neighbouring threads read neighbouring
// shared-memory words). fp32 must hold the plain versions to 1e-5
// relative, which TF32 tensor cores cannot.
// ---------------------------------------------------------------------------
constexpr int RS_BM = 32, RS_BN = 64, RS_BR = 16, RS_THREADS = 128;
constexpr int RC_THREADS = 256;             // bf16: 8 warps
constexpr int RC_RK = 64;                   // ranks staged a chunk
constexpr int RC_SS = RC_RK + 8;            // bf16 row stride of S, W [n][r]

template <typename T, bool W_T, bool ROWS, bool RANKS>
__device__ __forceinline__ void rank_sum_fma(
    const T* __restrict__ S, const float* __restrict__ W,
    const float* __restrict__ scale, float scale_all,
    const T* __restrict__ base, T* __restrict__ OUT,
    const int* __restrict__ rows, const int* __restrict__ ranks, int T_,
    int r, int N) {
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

// shared bytes of the bf16 tile: S [BM][RC_SS] and the rounded master
// ([RC_RK][BN + 8] for W [r, N], [BN][RC_SS] for W [N, r]) while the
// contraction runs, then the fp32 accumulators [BM][BN + 8]
template <int BM, int BN, bool W_T> struct RcTile {
  static constexpr int WM = BM / 16 < 4 ? BM / 16 : 4;   // warps along rows
  static constexpr int WN = RC_THREADS / 32 / WM;        // along columns
  static constexpr int MT = BM / (16 * WM), NT = BN / (8 * WN);
  static_assert(MT >= 1 && NT >= 1 && (NT == 1 || NT % 2 == 0),
                "m16 x n8 tiles, n8 tiles in pairs");
  static constexpr int WS = W_T ? RC_SS : BN + 8;        // bf16 master stride
  static constexpr int S_BYTES = BM * RC_SS * 2;
  static constexpr int W_BYTES = (W_T ? BN : RC_RK) * WS * 2;
  static constexpr int RS = BN + 8;                      // fp32 epilogue stride
  static constexpr int RED = BM * RS * 4;
  static constexpr int SMEM =
      S_BYTES + W_BYTES > RED ? S_BYTES + W_BYTES : RED;
};

// one output of the epilogue: acc * scale (+ base), one fp32 rounding
__device__ __forceinline__ float rs_out(float a, float sc, bool has_base,
                                        float b) {
  return has_base ? fmaf(a, sc, b) : a * sc;
}

// vec bit 0: S rows are 16-byte aligned (cp.async); bit 1: the master's
// rows are (float4 loads); bit 2: OUT and BASE rows are (16-byte stores)
template <bool W_T, int BM, int BN, bool ROWS, bool RANKS>
__device__ __forceinline__ void rank_sum_mma(
    const bf16* __restrict__ S, const float* __restrict__ W,
    const float* __restrict__ scale, float scale_all,
    const bf16* __restrict__ base, bf16* __restrict__ OUT,
    const int* __restrict__ rows, const int* __restrict__ ranks, int T_,
    int r, int N, int vec) {
  using Cfg = RcTile<BM, BN, W_T>;
  constexpr int MT = Cfg::MT, NT = Cfg::NT, WS = Cfg::WS;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ss = reinterpret_cast<bf16*>(smem);
  bf16* ws = reinterpret_cast<bf16*>(smem + Cfg::S_BYTES);
  const int z = blockIdx.z;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = 16 * MT * (warp / Cfg::WN), wn = 8 * NT * (warp % Cfg::WN);
  const int g = lane / 4, c2 = 2 * (lane % 4);
  const int lq = lane / 8, li = lane % 8;
  const int vrows = live_count<ROWS>(rows, z, T_);
  const int vr = live_count<RANKS>(ranks, z, r);
  const int nrow = min(BM, vrows - m0);      // live rows of this tile
  const bf16* sz = S + ((size_t)z * T_ + m0) * r;
  const float* wz = W + (size_t)z * r * N;

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  // a dead row tile skips every load and MMA
  for (int j0 = 0; nrow > 0 && j0 < vr; j0 += RC_RK) {
    const int kext = min(RC_RK, vr - j0);          // live ranks this chunk
    const int kpad = (kext + 15) & ~15;            // in k16 steps
    if (j0 > 0) __syncthreads();                   // last chunk consumed
    // S [BM][kpad]: rows >= nrow and ranks >= kext zero-filled
    if (vec & 1) {
      for (int e = tid; e < BM * (kpad / 8); e += RC_THREADS) {
        const int m = e / (kpad / 8), c = 8 * (e % (kpad / 8));
        const int nb = m < nrow ? 2 * max(0, min(8, kext - c)) : 0;
        cp_async16n(ss + m * RC_SS + c,
                    nb > 0 ? sz + (size_t)m * r + j0 + c : S, nb);
      }
      cp_async_commit();
    } else {
      for (int e = tid; e < BM * kpad; e += RC_THREADS) {
        const int m = e / kpad, c = e % kpad;
        ss[m * RC_SS + c] = (m < nrow && c < kext)
                                ? sz[(size_t)m * r + j0 + c]
                                : __float2bfloat16_rn(0.f);
      }
    }
    // the master [kpad ranks][BN columns], rounded to bf16 once
    if constexpr (!W_T) {            // W [r, N]: rows of N columns
      for (int e = tid; e < kpad * (BN / 4); e += RC_THREADS) {
        const int jj = e / (BN / 4), c = 4 * (e % (BN / 4));
        const int n = n0 + c;
        float4 w = make_float4(0.f, 0.f, 0.f, 0.f);
        if (jj < kext && n < N) {
          const float* src = wz + (size_t)(j0 + jj) * N + n;
          if (vec & 2) {
            w = *reinterpret_cast<const float4*>(src);
          } else {
            w.x = src[0];
            if (n + 1 < N) w.y = src[1];
            if (n + 2 < N) w.z = src[2];
            if (n + 3 < N) w.w = src[3];
          }
        }
        *reinterpret_cast<uint2*>(ws + jj * WS + c) =
            make_uint2(pack_bf16(w.x, w.y), pack_bf16(w.z, w.w));
      }
    } else {                         // W [N, r]: rows of r ranks
      for (int e = tid; e < BN * (kpad / 4); e += RC_THREADS) {
        const int nn = e / (kpad / 4), c = 4 * (e % (kpad / 4));
        const int n = n0 + nn;
        float4 w = make_float4(0.f, 0.f, 0.f, 0.f);
        if (c < kext && n < N) {
          const float* src = wz + (size_t)n * r + j0 + c;
          if (vec & 2) {
            w = *reinterpret_cast<const float4*>(src);
          } else {
            w.x = src[0];
            if (c + 1 < kext) w.y = src[1];
            if (c + 2 < kext) w.z = src[2];
            if (c + 3 < kext) w.w = src[3];
          }
          if (c + 1 >= kext) w.y = 0.f;            // ranks past the extent
          if (c + 2 >= kext) w.z = 0.f;
          if (c + 3 >= kext) w.w = 0.f;
        }
        *reinterpret_cast<uint2*>(ws + nn * WS + c) =
            make_uint2(pack_bf16(w.x, w.y), pack_bf16(w.z, w.w));
      }
    }
    if (vec & 1) cp_async_wait<0>();
    __syncthreads();

    for (int ks = 0; ks < kpad; ks += 16) {
      uint32_t af[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        if (wm + 16 * mt < nrow)
          ldsm_x4(af[mt], ss + (wm + 16 * mt + li + 8 * (lq & 1)) * RC_SS +
                              ks + 8 * (lq >> 1));
#pragma unroll
      for (int np = 0; np < (NT + 1) / 2; ++np) {
        uint32_t bq[4];
        const int n = wn + 16 * np;
        if constexpr (NT == 1) {
          uint32_t b2[2];
          if constexpr (W_T)
            ldsm_x2(b2, ws + (n + li) * WS + ks + 8 * (lq & 1));
          else
            ldsm_x2_t(b2, ws + (ks + li + 8 * (lq & 1)) * WS + n);
          bq[0] = b2[0];
          bq[1] = b2[1];
        } else if constexpr (W_T) {
          ldsm_x4(bq, ws + (n + li + 8 * (lq >> 1)) * WS + ks + 8 * (lq & 1));
        } else {
          ldsm_x4_t(bq, ws + (ks + li + 8 * (lq & 1)) * WS + n +
                            8 * (lq >> 1));
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          if (wm + 16 * mt >= nrow) break;       // dead m16 tiles
          mma_bf16(acc[mt][2 * np], af[mt], bq[0], bq[1]);
          if constexpr (NT > 1)
            mma_bf16(acc[mt][2 * np + 1], af[mt], bq[2], bq[3]);
        }
      }
    }
  }

  // epilogue: the accumulators through shared memory, 8 outputs a thread
  __syncthreads();                   // the tiles' last reads are done
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float* p = red + (wm + 16 * mt + g) * Cfg::RS + wn + 8 * nt + c2;
      *reinterpret_cast<float2*>(p) = make_float2(acc[mt][nt][0],
                                                  acc[mt][nt][1]);
      *reinterpret_cast<float2*>(p + 8 * Cfg::RS) =
          make_float2(acc[mt][nt][2], acc[mt][nt][3]);
    }
  __syncthreads();
  const float sc = scale != nullptr ? scale[z] : scale_all;
  const bool has_base = base != nullptr;
  const size_t zo = (size_t)z * T_ * N;
  for (int e = tid; e < BM * (BN / 8); e += RC_THREADS) {
    const int m = e / (BN / 8), c = 8 * (e % (BN / 8));
    const int t = m0 + m, n = n0 + c;
    if (t >= T_ || n >= N) continue;
    const bool live = m < nrow;      // dead rows: acc is exactly 0
    const float* a = red + m * Cfg::RS + c;
    const size_t o = zo + (size_t)t * N + n;
    if (vec & 4) {
      float4 a0 = make_float4(0.f, 0.f, 0.f, 0.f), a1 = a0;
      if (live) {
        a0 = *reinterpret_cast<const float4*>(a);
        a1 = *reinterpret_cast<const float4*>(a + 4);
      }
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      uint4 bv = make_uint4(0, 0, 0, 0);
      if (has_base) bv = *reinterpret_cast<const uint4*>(base + o);
      const uint32_t bw[4] = {bv.x, bv.y, bv.z, bv.w};
      uint32_t outv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)            // bf16 -> fp32 is exact
        outv[i] = pack_bf16(
            rs_out(av[2 * i], sc, has_base, __uint_as_float(bw[i] << 16)),
            rs_out(av[2 * i + 1], sc, has_base,
                   __uint_as_float(bw[i] & 0xffff0000u)));
      *reinterpret_cast<uint4*>(OUT + o) =
          make_uint4(outv[0], outv[1], outv[2], outv[3]);
    } else {
      for (int i = 0; i < 8 && n + i < N; ++i)
        OUT[o + i] = __float2bfloat16_rn(rs_out(
            live ? a[i] : 0.f, sc, has_base,
            has_base ? __bfloat162float(base[o + i]) : 0.f));
    }
  }
}

// BM, BN shape the bf16 path only; the fp32 launcher fixes them
template <typename T, bool W_T, int BM, int BN, bool ROWS, bool RANKS>
__global__ void __launch_bounds__(std::is_same<T, float>::value
                                      ? RS_THREADS : RC_THREADS)
rank_sum_kernel(const T* __restrict__ S, const float* __restrict__ W,
                const float* __restrict__ scale, float scale_all,
                const T* __restrict__ base, T* __restrict__ OUT,
                const int* __restrict__ rows, const int* __restrict__ ranks,
                int T_, int r, int N, int vec) {
  if constexpr (std::is_same<T, float>::value)
    rank_sum_fma<T, W_T, ROWS, RANKS>(S, W, scale, scale_all, base, OUT,
                                      rows, ranks, T_, r, N);
  else
    rank_sum_mma<W_T, BM, BN, ROWS, RANKS>(S, W, scale, scale_all, base, OUT,
                                           rows, ranks, T_, r, N, vec);
}

// ---------------------------------------------------------------------------
// tn_kernel:
// OUT[z][a][b] = sc * sum_{t < rows[z]} P[z][t][a] * Q[z][t][b]  (fp32 out)
// P: [T, NA], Q: [T, NB] in the activation type; OUT: [NA, NB] fp32. The
// rank axis is b (RANK_A = false: dA = X^T dS, NB = r) or a (RANK_A = true:
// dB = S^T dY, NA = r); entries past ranks[z] on it are exactly 0, and dead
// rank tiles skip their loads and MMAs. Both operands' dead rows are masked.
//
// bf16 (every timed call). What bounds it: 2*rows*r*d flops on rows*d bf16
// of the wide operand (X or dY) and rows*r of the narrow one: bytes. A
// block owns BA x BB = 64 x 64 outputs, so one block covers every rank of
// r_max = 64 and reads each wide-operand entry once (the default tile; a
// tile plan may pick another); 8 warps own 32 x 16
// each (2 m16 x 2 n8 tiles, fp32 accumulators). The token loop runs in
// 128-row stages from row 0 up to rows[z], staged in a 3-deep cp.async
// ring (110 KB: two blocks an SM) with dead rows and dead rank columns
// filled with zeros instead of read; both operands are contracted over
// their leading (token) axis, so their fragments come by ldmatrix.trans,
// and each k16 step at or past rows[z] is skipped. Each output element is
// summed in k16 steps from row 0 in order: the same bits whether a slot
// has T = 512 or T = 1,024 with rows = 512, and whatever the tile. The
// epilogue scales (db) and writes exact zeros past ranks[z]. A row that is
// not 16-byte aligned takes masked scalar loads into the same tiles.
//
// fp32 (FMA, unchanged): a 2048-entry output tile per block (BA x BB), a
// loop over 32-row token chunks staged in shared memory, 4 x 4 fp32
// accumulators per thread.
// ---------------------------------------------------------------------------
constexpr int TN_BT = 32, TN_THREADS = 128;
constexpr int TC_STAGES = 3, TC_BK = 128;    // ring depth, rows a stage
constexpr int TC_TILE = 64;                  // bf16 tile: TC_TILE squared
constexpr int TC_WN = 16;                    // b columns a warp (a rows: 32)

template <typename T, int BA, int BB, bool RANK_A, bool ROWS, bool RANKS>
__device__ __forceinline__ void tn_fma(
    const T* __restrict__ P, const T* __restrict__ Q,
    const float* __restrict__ scale, float* __restrict__ OUT,
    const int* __restrict__ rows, const int* __restrict__ ranks, int T_,
    int NA, int NB, int r) {
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

// vec bit 0: P rows are 16-byte aligned (cp.async); bit 1: Q rows are
template <int BA, int BB, bool RANK_A, bool ROWS, bool RANKS>
__device__ __forceinline__ void tn_mma(
    const bf16* __restrict__ P, const bf16* __restrict__ Q,
    const float* __restrict__ scale, float* __restrict__ OUT,
    const int* __restrict__ rows, const int* __restrict__ ranks, int T_,
    int NA, int NB, int r, int vec) {
  static_assert(BA % 32 == 0 && BB % TC_WN == 0, "32 x TC_WN a warp");
  constexpr int BK = TC_BK, S = TC_STAGES, NT = TC_WN / 8;
  constexpr int SA = BA + 8, SB = BB + 8;      // bf16 row strides
  constexpr int THREADS = BA * BB / TC_WN;
  extern __shared__ __align__(16) unsigned char smem[];
  // rings of [BK rows][BA columns] tiles of P and [BK][BB] tiles of Q
  const auto sp = reinterpret_cast<bf16 (*)[BK][SA]>(smem);
  const auto sq = reinterpret_cast<bf16 (*)[BK][SB]>(
      smem + S * BK * SA * sizeof(bf16));
  const int z = blockIdx.z;
  const int a0 = blockIdx.y * BA;
  const int b0 = blockIdx.x * BB;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wa = 32 * (warp / (BB / TC_WN));
  const int wb = TC_WN * (warp % (BB / TC_WN));
  const int vrows = live_count<ROWS>(rows, z, T_);
  const int vr = live_count<RANKS>(ranks, z, r);
  const int va = RANK_A ? min(vr, NA) : NA;    // live extent of each axis
  const int vb = RANK_A ? NB : min(vr, NB);
  const int la = min(BA, va - a0);             // live extent in this tile
  const int lb = min(BB, vb - b0);
  const bf16* pz = P + (size_t)z * T_ * NA;
  const bf16* qz = Q + (size_t)z * T_ * NB;

  float acc[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0.f;

  // one [BK rows][W columns] tile of an operand: columns >= live and rows
  // >= vrows filled with zeros
  auto load_tile = [&](auto dst, auto width, const bf16* src, int N, int c0,
                       int live, int t0, bool v16, const bf16* any) {
    constexpr int W = decltype(width)::value;
    if (v16) {
      for (int e = tid; e < BK * (W / 8); e += THREADS) {
        const int i = e / (W / 8), c = 8 * (e % (W / 8)), t = t0 + i;
        const bool ok = t < vrows && c < live;
        cp_async16(&dst[i][c], ok ? src + (size_t)t * N + c0 + c : any, ok);
      }
    } else {
      for (int e = tid; e < BK * W; e += THREADS) {
        const int i = e / W, c = e % W, t = t0 + i;
        dst[i][c] = (t < vrows && c < live) ? src[(size_t)t * N + c0 + c]
                                            : __float2bfloat16_rn(0.f);
      }
    }
  };
  auto load = [&](int s, int b) {
    load_tile(sp[b], std::integral_constant<int, BA>(), pz, NA, a0, la,
              s * BK, vec & 1, P);
    load_tile(sq[b], std::integral_constant<int, BB>(), qz, NB, b0, lb,
              s * BK, vec & 2, Q);
  };

  const int lq = lane / 8, li = lane % 8;
  auto compute = [&](int b, int t0) {
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      if (t0 + ks >= vrows) break;              // k16 steps past rows[z]
      uint32_t af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        if (wa + 16 * mt < la)
          ldsm_x4_t(af[mt], &sp[b][ks + li + 8 * (lq >> 1)]
                                [wa + 16 * mt + 8 * (lq & 1)]);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        const int n = wb + 16 * np;
        if (n >= lb) break;                     // dead n8 tiles
        uint32_t bq[4];
        ldsm_x4_t(bq, &sq[b][ks + li + 8 * (lq & 1)][n + 8 * (lq >> 1)]);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          if (wa + 16 * mt >= la) break;        // dead m16 tiles
          mma_bf16(acc[mt][2 * np], af[mt], bq[0], bq[1]);
          if (n + 8 < lb) mma_bf16(acc[mt][2 * np + 1], af[mt], bq[2], bq[3]);
        }
      }
    }
  };

  const int nst = (la > 0 && lb > 0) ? cdiv(vrows, BK) : 0;
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < nst) load(s, s);
    cp_async_commit();
  }
  for (int s = 0; s < nst; ++s) {
    cp_async_wait<S - 2>();
    __syncthreads();               // stage s landed; stage s - 1 consumed
    if (s + S - 1 < nst) load(s + S - 1, (s + S - 1) % S);
    cp_async_commit();
    compute(s % S, s * BK);
  }
  cp_async_wait<0>();

  const float sc = scale != nullptr ? scale[z] : 1.f;
  float* oz = OUT + (size_t)z * NA * NB;
  const int g = lane / 4, c2 = 2 * (lane % 4);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int a = a0 + wa + 16 * mt + g + 8 * (q / 2);
        const int b = b0 + wb + 8 * nt + c2 + (q % 2);
        if (a >= NA || b >= NB) continue;
        // past ranks[z] on the rank axis: exactly 0
        oz[(size_t)a * NB + b] =
            (a < va && b < vb) ? acc[mt][nt][q] * sc : 0.f;
      }
}

// BA x BB is the block's output tile (fp32: 128 threads of 4 x 4 outputs;
// bf16: one warp per 32 x TC_WN = 32 x 16)
template <typename T, int BA, int BB, bool RANK_A, bool ROWS, bool RANKS>
__global__ void __launch_bounds__(std::is_same<T, float>::value
                                      ? TN_THREADS : BA * BB / TC_WN)
tn_kernel(const T* __restrict__ P, const T* __restrict__ Q,
          const float* __restrict__ scale, float* __restrict__ OUT,
          const int* __restrict__ rows, const int* __restrict__ ranks,
          int T_, int NA, int NB, int r, int vec) {
  if constexpr (std::is_same<T, float>::value)
    tn_fma<T, BA, BB, RANK_A, ROWS, RANKS>(P, Q, scale, OUT, rows, ranks, T_,
                                           NA, NB, r);
  else
    tn_mma<BA, BB, RANK_A, ROWS, RANKS>(P, Q, scale, OUT, rows, ranks, T_,
                                        NA, NB, r, vec);
}

// ---------------------------------------------------------------------------
// Tile plans (bf16 only). A plan is an index into GL_PLANS, the set compiled
// into the library: plan (bm, bn, br) tiles narrow_out (xa, ds) by bm token
// rows x br rank columns, rank_sum (sb_add, dx) by bm rows x bn output
// columns and tn by bn feature x br rank entries (da: BA = bn, BB = br; db:
// BA = br, BB = bn). A negative plan is each launcher's default tile for
// the shape; any other index is refused. Every tile of a template gives each
// output element the same fp32 summation order (the contraction splits
// NO_BK and TC_BK are not part of a plan), so a plan moves no bit; the
// autotuner (autotune.py) checks that on the card before it keeps one. The
// fp32 instantiations have one tile each and refuse a plan. The list must
// match autotune.PLAN_SET (gl_plan_tiles reports it).
// ---------------------------------------------------------------------------
#define GL_PLANS(X)                                                     \
  X(0, 64, 128, 32) X(1, 32, 128, 32) X(2, 32, 64, 64) X(3, 16, 128, 32) \
  X(4, 64, 64, 32)

template <int BM, int BN, int BR> struct Plan {
  static constexpr int bm = BM, bn = BN, br = BR;
};

// f(Plan<bm, bn, br>{}) for plan index p; an index outside the set:
// cudaErrorInvalidValue
template <typename F> int with_plan(int p, F&& f) {
  switch (p) {
#define GL_PLAN_CASE(i, bm, bn, br) \
  case i:                           \
    return f(Plan<bm, bn, br>{});
    GL_PLANS(GL_PLAN_CASE)
#undef GL_PLAN_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// Launchers: one grid per function and tile, shared by all three
// instantiations. Act is the activation type of every non-master operand.
// rows is read only when ROWS (null rows: every row live), ranks only when
// RANKS; plan as above. Each returns cudaGetLastError() after its launch
// (0 = launched).
// ---------------------------------------------------------------------------

template <typename Act, bool W_KN, int BM, int BN, bool ROWS, bool RANKS>
int launch_narrow_out(const void* x, const float* W, int sk, int sj,
                      const float* scale, void* out, const int* rows,
                      const int* ranks, int Z, int T, int K, int r, int vec,
                      cudaStream_t st) {
  constexpr bool FP32 = std::is_same<Act, float>::value;
  constexpr int TM = FP32 ? NO_BM : BM, TR = FP32 ? NO_BR : BN;
  dim3 grid(cdiv(r, TR), cdiv(T, TM), Z);
  if (!grid_ok(grid.x, grid.y, grid.z) || K < 1)
    return (int)cudaErrorInvalidValue;
  const auto kern = narrow_out_kernel<Act, W_KN, BM, BN, ROWS, RANKS>;
  int smem = 0;
  if constexpr (!FP32) {
    smem = NoTile<BM, BN, W_KN>::SMEM;     // above 48 KB: opt in, once
    static const cudaError_t opt_in = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (opt_in != cudaSuccess) return (int)opt_in;
  }
  kern<<<grid, NO_THREADS, smem, st>>>((const Act*)x, W, sk, sj, scale,
                                       (Act*)out, rows, ranks, T, K, r, vec);
  return (int)cudaGetLastError();
}

// the default bf16 tile of xa / ds: 16 x 8 when a slot has at most 16 rows
// (decode: the most blocks for the master's bytes), else 32 or 64 rows x
// 32 ranks (rank-local calls: most rank tiles past 32 are dead, so half the
// rows a block keeps the card filled); a plan: bm x br
template <typename Act, bool W_KN, bool ROWS, bool RANKS>
int launch_narrow(const void* x, const float* W, int sk, int sj,
                  const float* scale, void* out, const int* rows,
                  const int* ranks, int Z, int T, int K, int r, int vec,
                  int plan, cudaStream_t st) {
  if constexpr (std::is_same<Act, float>::value) {
    if (plan >= 0) return (int)cudaErrorInvalidValue;   // one fp32 tile
    return launch_narrow_out<Act, false, NO_BM, NO_BR, ROWS, RANKS>(
        x, W, sk, sj, scale, out, rows, ranks, Z, T, K, r, vec, st);
  } else if (plan >= 0) {
    return with_plan(plan, [&](auto p) {
      using P = decltype(p);
      return launch_narrow_out<Act, W_KN, P::bm, P::br, ROWS, RANKS>(
          x, W, sk, sj, scale, out, rows, ranks, Z, T, K, r, vec, st);
    });
  } else if (T <= 16)
    return launch_narrow_out<Act, W_KN, 16, 8, ROWS, RANKS>(
        x, W, sk, sj, scale, out, rows, ranks, Z, T, K, r, vec, st);
  else
    return launch_narrow_out<Act, W_KN, RANKS ? 32 : 64, 32, ROWS, RANKS>(
        x, W, sk, sj, scale, out, rows, ranks, Z, T, K, r, vec, st);
}

template <typename Act, bool ROWS, bool RANKS>
int launch_xa(const void* x, const float* A, void* S, const int* rows,
              const int* ranks, int Z, int T, int din, int r, int plan,
              cudaStream_t st) {
  const int vec = (aligned16(x) && din % 8 == 0 ? 1 : 0) |
                  (aligned16(A) && r % 4 == 0 ? 2 : 0);
  return launch_narrow<Act, true, ROWS, RANKS>(
      x, A, r, 1, nullptr, S, rows, ranks, Z, T, din, r, vec, plan, st);
}

template <typename Act, bool W_T, int BM, int BN, bool ROWS, bool RANKS>
int launch_rank_sum_tile(const void* S, const float* W, const float* scale,
                         float scale_all, const void* base, void* out,
                         const int* rows, const int* ranks, int Z, int T,
                         int r, int N, int vec, cudaStream_t st) {
  constexpr bool FP32 = std::is_same<Act, float>::value;
  dim3 grid(cdiv(N, BN), cdiv(T, BM), Z);
  if (!grid_ok(grid.x, grid.y, grid.z) || r < 1)
    return (int)cudaErrorInvalidValue;
  const auto kern = rank_sum_kernel<Act, W_T, BM, BN, ROWS, RANKS>;
  int smem = 0, threads = RS_THREADS;
  if constexpr (!FP32) {
    smem = RcTile<BM, BN, W_T>::SMEM;      // above 48 KB: opt in, once
    threads = RC_THREADS;
    static const cudaError_t opt_in = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (opt_in != cudaSuccess) return (int)opt_in;
  }
  kern<<<grid, threads, smem, st>>>((const Act*)S, W, scale, scale_all,
                                    (const Act*)base, (Act*)out, rows, ranks,
                                    T, r, N, vec);
  return (int)cudaGetLastError();
}

// the default bf16 tile of sb_add / dx: 16 x 64 when a slot has at most 16
// rows (decode: the most blocks for the master's bytes), else 128 x 128; a
// plan: bm x bn; fp32 32 x 64
template <typename Act, bool W_T, bool ROWS, bool RANKS>
int launch_rank_sum(const void* S, const float* W, const float* scale,
                    float scale_all, const void* base, void* out,
                    const int* rows, const int* ranks, int Z, int T, int r,
                    int N, int plan, cudaStream_t st) {
  const bool rows16 = aligned16(out) && N % 8 == 0 &&
                      (base == nullptr || aligned16(base));
  const int vec = (aligned16(S) && r % 8 == 0 ? 1 : 0) |
                  (aligned16(W) && (W_T ? r : N) % 4 == 0 ? 2 : 0) |
                  (rows16 ? 4 : 0);
  if constexpr (std::is_same<Act, float>::value) {
    if (plan >= 0) return (int)cudaErrorInvalidValue;   // one fp32 tile
    return launch_rank_sum_tile<Act, W_T, RS_BM, RS_BN, ROWS, RANKS>(
        S, W, scale, scale_all, base, out, rows, ranks, Z, T, r, N, vec, st);
  } else if (plan >= 0) {
    return with_plan(plan, [&](auto p) {
      using P = decltype(p);
      return launch_rank_sum_tile<Act, W_T, P::bm, P::bn, ROWS, RANKS>(
          S, W, scale, scale_all, base, out, rows, ranks, Z, T, r, N, vec,
          st);
    });
  } else if (T <= 16)
    return launch_rank_sum_tile<Act, W_T, 16, 64, ROWS, RANKS>(
        S, W, scale, scale_all, base, out, rows, ranks, Z, T, r, N, vec, st);
  else
    return launch_rank_sum_tile<Act, W_T, 128, 128, ROWS, RANKS>(
        S, W, scale, scale_all, base, out, rows, ranks, Z, T, r, N, vec, st);
}

template <typename Act, bool ROWS, bool RANKS>
int launch_sb_add(const void* S, const float* B, const float* scale,
                  float scale_all, const void* ybase, void* Y,
                  const int* rows, const int* ranks, int Z, int T, int r,
                  int dout, int plan, cudaStream_t st) {
  return launch_rank_sum<Act, false, ROWS, RANKS>(
      S, B, scale, scale_all, ybase, Y, rows, ranks, Z, T, r, dout, plan, st);
}

template <typename Act, bool ROWS, bool RANKS>
int launch_ds(const void* dy, const float* B, const float* scale, void* dS,
              const int* rows, const int* ranks, int Z, int T, int dout,
              int r, int plan, cudaStream_t st) {
  if (scale == nullptr) return (int)cudaErrorInvalidValue;
  const int vec = (aligned16(dy) && dout % 8 == 0 ? 1 : 0) |
                  (aligned16(B) && dout % 4 == 0 ? 2 : 0);
  return launch_narrow<Act, false, ROWS, RANKS>(
      dy, B, 1, dout, scale, dS, rows, ranks, Z, T, dout, r, vec, plan, st);
}

template <typename Act, bool ROWS, bool RANKS>
int launch_dx(const void* dS, const float* A, void* dX, const int* rows,
              const int* ranks, int Z, int T, int din, int r, int plan,
              cudaStream_t st) {
  return launch_rank_sum<Act, true, ROWS, RANKS>(
      dS, A, nullptr, 1.f, nullptr, dX, rows, ranks, Z, T, r, din, plan, st);
}

// OUT [NA, NB] = sc * P^T Q over BA x BB output tiles
template <typename Act, int BA, int BB, bool RANK_A, bool ROWS, bool RANKS>
int launch_tn(const void* P, const void* Q, const float* scale, float* out,
              const int* rows, const int* ranks, int Z, int T, int NA,
              int NB, int r, cudaStream_t st) {
  constexpr bool FP32 = std::is_same<Act, float>::value;
  dim3 grid(cdiv(NB, BB), cdiv(NA, BA), Z);
  if (!grid_ok(grid.x, grid.y, grid.z) || T < 1)
    return (int)cudaErrorInvalidValue;
  const int vec = (aligned16(P) && NA % 8 == 0 ? 1 : 0) |
                  (aligned16(Q) && NB % 8 == 0 ? 2 : 0);
  const auto kern = tn_kernel<Act, BA, BB, RANK_A, ROWS, RANKS>;
  int smem = 0, threads = TN_THREADS;
  if constexpr (!FP32) {
    smem = TC_STAGES * TC_BK * (BA + BB + 16) * (int)sizeof(bf16);
    threads = BA * BB / TC_WN;
    static const cudaError_t opt_in = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (opt_in != cudaSuccess) return (int)opt_in;
  }
  kern<<<grid, threads, smem, st>>>((const Act*)P, (const Act*)Q, scale, out,
                                    rows, ranks, T, NA, NB, r, vec);
  return (int)cudaGetLastError();
}

// fp32 tiles 128 x 16 (da) and 16 x 128 (db); bf16 64 x 64 by default
// (every rank of r_max 64 in one block), a plan's bn x br (da) and br x bn
// (db)
template <typename Act, bool ROWS, bool RANKS>
int launch_da(const void* x, const void* dS, float* dA, const int* rows,
              const int* ranks, int Z, int T, int din, int r, int plan,
              cudaStream_t st) {
  if constexpr (std::is_same<Act, float>::value) {
    if (plan >= 0) return (int)cudaErrorInvalidValue;   // one fp32 tile
    return launch_tn<Act, 128, 16, false, ROWS, RANKS>(
        x, dS, nullptr, dA, rows, ranks, Z, T, din, r, r, st);
  } else if (plan >= 0) {
    return with_plan(plan, [&](auto p) {
      using P = decltype(p);
      return launch_tn<Act, P::bn, P::br, false, ROWS, RANKS>(
          x, dS, nullptr, dA, rows, ranks, Z, T, din, r, r, st);
    });
  } else {
    return launch_tn<Act, TC_TILE, TC_TILE, false, ROWS, RANKS>(
        x, dS, nullptr, dA, rows, ranks, Z, T, din, r, r, st);
  }
}

template <typename Act, bool ROWS, bool RANKS>
int launch_db(const void* S, const void* dy, const float* scale, float* dB,
              const int* rows, const int* ranks, int Z, int T, int dout,
              int r, int plan, cudaStream_t st) {
  if (scale == nullptr) return (int)cudaErrorInvalidValue;
  if constexpr (std::is_same<Act, float>::value) {
    if (plan >= 0) return (int)cudaErrorInvalidValue;   // one fp32 tile
    return launch_tn<Act, 16, 128, true, ROWS, RANKS>(
        S, dy, scale, dB, rows, ranks, Z, T, r, dout, r, st);
  } else if (plan >= 0) {
    return with_plan(plan, [&](auto p) {
      using P = decltype(p);
      return launch_tn<Act, P::br, P::bn, true, ROWS, RANKS>(
          S, dy, scale, dB, rows, ranks, Z, T, r, dout, r, st);
    });
  } else {
    return launch_tn<Act, TC_TILE, TC_TILE, true, ROWS, RANKS>(
        S, dy, scale, dB, rows, ranks, Z, T, r, dout, r, st);
  }
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
