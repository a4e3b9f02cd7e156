// Causal flash-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention/flash_attention.py:flash_attention
// (def :77, pallas_call :89):
//   O[b] = softmax(Q[b] K[b]^T * hd^-0.5 + mask) V[b]
// with q [B,Sq,hd], k and v [B,Sk,hd], O [B,Sq,hd] in q's type (fp32 or
// bf16; all three share it), B = Z*b*H fused slots, lanes and heads. Query i
// sees key j iff j <= i + (Sk - Sq) when causal (suffix alignment) and, with
// window > 0, j > i + (Sk - Sq) - window. The softmax is fp32 in both
// bodies: masked scores are -1e30 and their p is written as 0, the running
// max m, denominator l and accumulator acc follow the streaming-softmax
// recurrence of the TPU kernel, and the output is acc / max(l, 1e-30), so a
// fully masked row is exactly 0.
//
// What bounds it on an H100: at the training shape (B = 512, S = 256,
// hd = 80, bf16) the function moves 84 MB (q, k, v read once, O written
// once; 0.025 ms at 3.35 TB/s) and does 5.4 GFLOP of causal products
// (0.005 ms at the bf16 tensor-core peak), so the bound is bytes. Off the
// tensor cores the products alone need 0.08 ms at the fp32 FMA peak, so
// the bf16 body runs them on the tensor cores:
//
// bf16 (every timed call), FA2-style on mma.sync m16n8k16 with fp32
// accumulators. A block of 4 warps owns one fused head and 64 query rows,
// each warp 16 rows; blocks run longest causal rows first. Q is staged once
// by cp.async and held as bf16 A fragments (ldmatrix). K and V stream in
// 64-key tiles through a two-stage cp.async ring in shared memory (rows
// padded by 16 bytes, so ldmatrix hits distinct banks; tails of Sq and Sk
// are zero-filled, not read). S = Q K^T lands in fp32 registers (K
// fragments by ldmatrix) and is scaled there; the online softmax stays in
// registers, the row max and sum taken across the four lanes of a row in
// one fixed shuffle order. P goes from the accumulator layout straight into
// A fragments for P V (V fragments by ldmatrix.trans), split in two bf16
// halves, hi = bf16(p) and lo = bf16(p - hi), each multiplied by V: a
// single bf16 P would leave the output tens of bf16 roundings from the
// plain version, the pair keeps p to ~16 bits. The output is divided,
// rounded once to bf16 and leaves through shared memory in 16-byte stores.
// Key tiles that the mask hides from every row of the block are skipped (p
// = 0 with alpha = 1 changes no bit); only tiles that cross the mask's edge
// test each score. What is left between it and the byte bound: the hi/lo
// split doubles the P V products, and each block re-reads its head's K and
// V from L2.
//
// fp32 (FMA, unchanged since the port): one block of 256 threads per
// (fused head, 64 query rows), four threads per row, the scaled q row in
// registers, 32-key K and V tiles converted into shared memory, scores
// and output columns summed on the fp32 CUDA cores. The fp32 path is held
// to 1e-5 relative, which TF32 tensor cores (10-bit mantissas) cannot
// give, and nothing timed runs in fp32.
//
// Batch independence: a block reads only its own fused head and query
// rows and sums every score and output column over one fixed sequence of
// key tiles and products; no atomics and no split of the keys across
// blocks. The result for one (b, row) does not depend on B or on any other
// row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "../../tensor_core.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int BQ = 64;          // query rows per block (both bodies)
constexpr float NEG = -1e30f;   // the TPU kernel's masked score

// fp32 body
constexpr int BK = 32;          // keys per shared-memory tile
constexpr int THREADS = 4 * BQ; // four threads per query row
constexpr int KPT = BK / 4;     // scores per thread per tile

// bf16 body
constexpr int TK = 64;          // keys per K / V tile
constexpr int TC_THREADS = 128; // 4 warps of 16 query rows

__device__ __forceinline__ bool visible(int kpos, int qpos, int Sk,
                                        int causal, int window) {
  return kpos < Sk && (!causal || kpos <= qpos) &&
         (window <= 0 || kpos > qpos - window);
}

// ---------------------------------------------------------------------------
// fp32 body
// ---------------------------------------------------------------------------

// shared floats: K and V tiles [BK][HD + 4] (the Q tile is staged through
// the same space first), P [BQ][BK + 1]
template <int HD>
constexpr int smem_floats() {
  return 2 * BK * (HD + 4) + BQ * (BK + 1);
}

template <int HD>
__device__ __forceinline__ void flash_fwd_fma(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o, int Sq, int Sk,
    int n_qt, float scale, int causal, int window) {
  constexpr int KS = HD + 4;    // row stride of K and V: 16-byte rows
  constexpr int PS = BK + 1;
  constexpr int DPT = HD / 4;   // output columns per thread
  static_assert(HD % 16 == 0, "hd must be a multiple of 16");
  static_assert(BQ * HD <= 2 * BK * KS, "Q tile must fit the K/V space");
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + BK * KS;
  float* Ps = Vs + BK * KS;

  const int n = (int)(blockIdx.x % n_qt);
  const long long b = blockIdx.x / n_qt;
  const int q0 = (n_qt - 1 - n) * BQ;   // the longest causal rows first
  const int off = Sk - Sq;
  const int tid = threadIdx.x;
  const int row = tid >> 2, quad = tid & 3;
  const int qi = q0 + row;
  const int qpos = qi + off;
  const float* qb = q + b * Sq * HD;
  const float* kb = k + b * Sk * HD;
  const float* vb = v + b * Sk * HD;

  // Q tile -> shared (coalesced) -> each thread's row into registers
  for (int e = tid; e < BQ * HD; e += THREADS) {
    const int r = e / HD;
    smem[e] = q0 + r < Sq ? qb[(long long)q0 * HD + e] * scale : 0.f;
  }
  __syncthreads();
  float qr[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) qr[d] = smem[row * HD + d];

  // the key tiles some row of this block can see
  int kt_lo = 0, kt_hi = (Sk + BK - 1) / BK;
  if (causal) {
    const int last = q0 + BQ - 1 + off;     // last row's last visible key
    kt_hi = last < 0 ? 0 : min(kt_hi, last / BK + 1);
  }
  if (window > 0) {
    const int first = q0 + off - window + 1;  // first row's first key
    kt_lo = first <= 0 ? 0 : first / BK;
  }

  float m = NEG, l = 0.f;
  float acc[DPT];
#pragma unroll
  for (int c = 0; c < DPT; ++c) acc[c] = 0.f;

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();   // Q staging and the last tile's reads are done
    for (int e = tid; e < BK * HD; e += THREADS) {
      const int r = e / HD, d = e - r * HD;
      const bool in = k0 + r < Sk;
      const long long g = (long long)k0 * HD + e;
      Ks[r * KS + d] = in ? kb[g] : 0.f;
      Vs[r * KS + d] = in ? vb[g] : 0.f;
    }
    __syncthreads();

    float s[KPT];
    float tmax = NEG;
#pragma unroll
    for (int i = 0; i < KPT; ++i) {
      const int j = quad + 4 * i;
      const float4* kr = reinterpret_cast<const float4*>(Ks + j * KS);
      float dot = 0.f;
#pragma unroll
      for (int d4 = 0; d4 < HD / 4; ++d4) {
        const float4 kk = kr[d4];
        dot = fmaf(qr[4 * d4 + 0], kk.x, dot);
        dot = fmaf(qr[4 * d4 + 1], kk.y, dot);
        dot = fmaf(qr[4 * d4 + 2], kk.z, dot);
        dot = fmaf(qr[4 * d4 + 3], kk.w, dot);
      }
      s[i] = visible(k0 + j, qpos, Sk, causal, window) ? dot : NEG;
      tmax = fmaxf(tmax, s[i]);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
    const float m_new = fmaxf(m, tmax);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < KPT; ++i) {
      const int j = quad + 4 * i;
      const float p = visible(k0 + j, qpos, Sk, causal, window)
                          ? expf(s[i] - m_new) : 0.f;
      Ps[row * PS + j] = p;
      psum += p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * alpha + psum;
    m = m_new;
    __syncwarp();      // the row's P is written by its own four threads

#pragma unroll
    for (int c = 0; c < DPT; ++c) acc[c] *= alpha;
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      const float p = Ps[row * PS + j];
      const float4* vr = reinterpret_cast<const float4*>(Vs + j * KS +
                                                         quad * DPT);
#pragma unroll
      for (int c4 = 0; c4 < DPT / 4; ++c4) {
        const float4 vv = vr[c4];
        acc[4 * c4 + 0] = fmaf(p, vv.x, acc[4 * c4 + 0]);
        acc[4 * c4 + 1] = fmaf(p, vv.y, acc[4 * c4 + 1]);
        acc[4 * c4 + 2] = fmaf(p, vv.z, acc[4 * c4 + 2]);
        acc[4 * c4 + 3] = fmaf(p, vv.w, acc[4 * c4 + 3]);
      }
    }
  }

  if (qi < Sq) {
    const float denom = fmaxf(l, 1e-30f);
    float* orow = o + (b * Sq + qi) * HD + quad * DPT;
#pragma unroll
    for (int c = 0; c < DPT; ++c) orow[c] = acc[c] / denom;
  }
}

// ---------------------------------------------------------------------------
// bf16 body (primitives in ../../tensor_core.cuh)
// ---------------------------------------------------------------------------

// p = hi + lo: hi = bf16(p), lo = bf16(p - hi), two values a register
__device__ __forceinline__ void split_bf16(float p0, float p1, uint32_t& hi,
                                           uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = pack_bf16(p0 - __low2float(h), p1 - __high2float(h));
}

// shared bytes of the bf16 body: Q [BQ][HD + 8] and two stages of K and V
// [TK][HD + 8]
template <int HD> __host__ __device__ constexpr int tc_stride() {
  return HD + 8;
}
template <int HD> __host__ __device__ constexpr int tc_smem_bytes() {
  return (BQ + 4 * TK) * tc_stride<HD>() * (int)sizeof(bf16);
}

// vec: q, k, v and o all 16-byte aligned (cp.async and 16-byte stores);
// else masked scalar loads and stores into the same tiles
template <int HD>
__device__ __forceinline__ void flash_fwd_mma(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ o, int Sq, int Sk,
    int n_qt, float scale, int causal, int window, int vec) {
  constexpr int STR = tc_stride<HD>();
  constexpr int KD = HD / 16;     // k16 steps of Q K^T; d16 pairs of P V
  constexpr int CH = HD / 8;      // 16-byte chunks a row
  static_assert(HD % 16 == 0, "hd must be a multiple of 16");
  extern __shared__ __align__(16) unsigned char fsm[];
  bf16* Qs = reinterpret_cast<bf16*>(fsm);
  bf16* KV = Qs + BQ * STR;       // stage s: K at 2 s TK STR, V after it

  const int n = (int)(blockIdx.x % n_qt);
  const long long b = blockIdx.x / n_qt;
  const int q0 = (n_qt - 1 - n) * BQ;   // the longest causal rows first
  const int off = Sk - Sq;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c2 = 2 * (lane % 4);
  const int lq = lane / 8, li = lane % 8;
  const bf16* qb = q + b * Sq * HD;
  const bf16* kb = k + b * Sk * HD;
  const bf16* vb = v + b * Sk * HD;

  // the key tiles some row of this block can see
  int kt_lo = 0, kt_hi = (Sk + TK - 1) / TK;
  if (causal) {
    const int last = q0 + BQ - 1 + off;     // last row's last visible key
    kt_hi = last < 0 ? 0 : min(kt_hi, last / TK + 1);
  }
  if (window > 0) {
    const int first = q0 + off - window + 1;  // first row's first key
    kt_lo = first <= 0 ? 0 : first / TK;
  }
  const int nkt = kt_hi - kt_lo;

  // rows [r0, r0 + count) of src ([rows, HD]) into dst; rows >= rows
  // filled with zeros instead of read
  auto load_rows = [&](bf16* dst, const bf16* src, int r0, int count,
                       int rows) {
    if (vec) {
      for (int e = tid; e < count * CH; e += TC_THREADS) {
        const int r = e / CH, c = 8 * (e % CH);
        const bool ok = r0 + r < rows;
        cp_async16(dst + r * STR + c,
                   ok ? src + (long long)(r0 + r) * HD + c : src, ok);
      }
    } else {
      for (int e = tid; e < count * HD; e += TC_THREADS) {
        const int r = e / HD, c = e % HD;
        dst[r * STR + c] = r0 + r < rows ? src[(long long)(r0 + r) * HD + c]
                                         : __float2bfloat16_rn(0.f);
      }
    }
  };
  auto load_kv = [&](int kt, int st) {
    bf16* Kt = KV + 2 * st * TK * STR;
    load_rows(Kt, kb, kt * TK, TK, Sk);
    load_rows(Kt + TK * STR, vb, kt * TK, TK, Sk);
  };

  float acc[2 * KD][4];           // 16 rows x HD outputs of this warp
#pragma unroll
  for (int dt = 0; dt < 2 * KD; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};   // rows g and g + 8
  uint32_t qf[KD][4];
  const int qpos = q0 + 16 * warp + g + off;    // row g; row g + 8: + 8

  if (nkt > 0) {
    load_rows(Qs, qb, q0, BQ, Sq);
    load_kv(kt_lo, 0);
  }
  cp_async_commit();
  for (int i = 0; i < nkt; ++i) {
    const int kt = kt_lo + i, k0 = kt * TK;
    if (i + 1 < nkt) load_kv(kt + 1, (i + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();                // tile i (and Q) landed
    if (i == 0) {
#pragma unroll
      for (int ks = 0; ks < KD; ++ks)
        ldsm_x4(qf[ks], Qs + (16 * warp + li + 8 * (lq & 1)) * STR +
                            16 * ks + 8 * (lq >> 1));
    }
    const bf16* Kt = KV + 2 * (i & 1) * TK * STR;
    const bf16* Vt = Kt + TK * STR;

    // S = Q K^T: 16 rows x 64 keys, k16 steps over d in order
    float s[TK / 8][4];
#pragma unroll
    for (int nt = 0; nt < TK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KD; ++ks)
#pragma unroll
      for (int np = 0; np < TK / 16; ++np) {
        uint32_t kf[4];
        ldsm_x4(kf, Kt + (16 * np + li + 8 * (lq >> 1)) * STR + 16 * ks +
                        8 * (lq & 1));
        mma_bf16(s[2 * np], qf[ks], kf[0], kf[1]);
        mma_bf16(s[2 * np + 1], qf[ks], kf[2], kf[3]);
      }

    // does the mask cut this tile for some row of the block?
    const bool cut = k0 + TK > Sk ||
                     (causal && k0 + TK - 1 > q0 + off) ||
                     (window > 0 && k0 <= q0 + BQ - 1 + off - window);
    float mx[2] = {NEG, NEG};
#pragma unroll
    for (int nt = 0; nt < TK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e / 2, kpos = k0 + 8 * nt + c2 + (e & 1);
        float x = s[nt][e] * scale;
        if (cut && !visible(kpos, qpos + 8 * r, Sk, causal, window)) x = NEG;
        s[nt][e] = x;
        mx[r] = fmaxf(mx[r], x);
      }
    float alpha[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = __expf(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < TK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e / 2, kpos = k0 + 8 * nt + c2 + (e & 1);
        const bool vis =
            !cut || visible(kpos, qpos + 8 * r, Sk, causal, window);
        const float p = vis ? __expf(s[nt][e] - m[r]) : 0.f;
        s[nt][e] = p;
        psum[r] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 1);
      psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 2);
      l[r] = l[r] * alpha[r] + psum[r];
    }
#pragma unroll
    for (int dt = 0; dt < 2 * KD; ++dt) {
      acc[dt][0] *= alpha[0];
      acc[dt][1] *= alpha[0];
      acc[dt][2] *= alpha[1];
      acc[dt][3] *= alpha[1];
    }

    // acc += P V: the accumulator layout of two n8 key tiles is the A
    // fragment of one k16 key step; P as hi + lo, both against V
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) {
      uint32_t ph[4], pl[4];
      split_bf16(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      split_bf16(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int dp = 0; dp < KD; ++dp) {
        uint32_t vf[4];
        ldsm_x4_t(vf, Vt + (16 * kk + li + 8 * (lq & 1)) * STR + 16 * dp +
                          8 * (lq >> 1));
        mma_bf16(acc[2 * dp], ph, vf[0], vf[1]);
        mma_bf16(acc[2 * dp + 1], ph, vf[2], vf[3]);
        mma_bf16(acc[2 * dp], pl, vf[0], vf[1]);
        mma_bf16(acc[2 * dp + 1], pl, vf[2], vf[3]);
      }
    }
    __syncthreads();                // stage i & 1 consumed
  }
  cp_async_wait<0>();

  // epilogue: acc / max(l, 1e-30) rounded once, through this warp's own
  // 16 rows of the Q tile (only this warp read them), 16-byte stores
  const float d0 = fmaxf(l[0], 1e-30f), d1 = fmaxf(l[1], 1e-30f);
  bf16* Ow = Qs + 16 * warp * STR;
#pragma unroll
  for (int dt = 0; dt < 2 * KD; ++dt) {
    *reinterpret_cast<uint32_t*>(Ow + g * STR + 8 * dt + c2) =
        pack_bf16(acc[dt][0] / d0, acc[dt][1] / d0);
    *reinterpret_cast<uint32_t*>(Ow + (g + 8) * STR + 8 * dt + c2) =
        pack_bf16(acc[dt][2] / d1, acc[dt][3] / d1);
  }
  __syncwarp();
  bf16* ob = o + (b * Sq + q0 + 16 * warp) * HD;
  const int nrow = min(16, Sq - q0 - 16 * warp);
  if (vec) {
    for (int e = lane; e < 16 * CH; e += 32) {
      const int r = e / CH, c = 8 * (e % CH);
      if (r < nrow)
        *reinterpret_cast<uint4*>(ob + (long long)r * HD + c) =
            *reinterpret_cast<const uint4*>(Ow + r * STR + c);
    }
  } else {
    for (int e = lane; e < 16 * HD; e += 32) {
      const int r = e / HD, c = e % HD;
      if (r < nrow) ob[(long long)r * HD + c] = Ow[r * STR + c];
    }
  }
}

// T selects the body at compile time: fp32 FMA or bf16 tensor cores
template <typename T, int HD>
__global__ void __launch_bounds__(std::is_same<T, float>::value ? THREADS
                                                                : TC_THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int Sq, int Sk,
                 int n_qt, float scale, int causal, int window, int vec) {
  if constexpr (std::is_same<T, float>::value)
    flash_fwd_fma<HD>(q, k, v, o, Sq, Sk, n_qt, scale, causal, window);
  else
    flash_fwd_mma<HD>(q, k, v, o, Sq, Sk, n_qt, scale, causal, window, vec);
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int Sq, int Sk, float scale, int causal,
                   int window, cudaStream_t stream) {
  const int n_qt = (Sq + BQ - 1) / BQ;
  const long long blocks = (long long)B * n_qt;
  if (B <= 0 || Sq <= 0 || Sk <= 0 || blocks > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const auto kern = flash_fwd_kernel<T, HD>;
  int threads, bytes, vec = 0;
  if constexpr (std::is_same<T, float>::value) {
    threads = THREADS;
    bytes = smem_floats<HD>() * (int)sizeof(float);
    static_assert(smem_floats<HD>() * sizeof(float) <= 48 * 1024,
                  "needs no dynamic shared memory opt-in");
  } else {
    threads = TC_THREADS;
    bytes = tc_smem_bytes<HD>();   // above 48 KB: opt in, once
    static const cudaError_t opt_in = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (opt_in != cudaSuccess) return opt_in;
    vec = aligned16(q) && aligned16(k) && aligned16(v) && aligned16(o);
  }
  kern<<<(unsigned)blocks, threads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Sk, n_qt, scale,
      causal, window, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v,
                        void* o, int B, int Sq, int Sk, float scale,
                        int causal, int window, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, o, B, Sq, Sk, scale, causal,
                                  window, stream);
    case 32: return launch<T, 32>(q, k, v, o, B, Sq, Sk, scale, causal,
                                  window, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, Sq, Sk, scale, causal,
                                  window, stream);
    case 80: return launch<T, 80>(q, k, v, o, B, Sq, Sk, scale, causal,
                                  window, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, Sq, Sk, scale, causal,
                                    window, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o share it); hd one of
// 16, 32, 64, 80 (stablelm-3b), 128. Returns the launch's cudaGetLastError() (0 =
// launched), or cudaErrorInvalidValue for a shape it does not take.
extern "C" int fa_forward(const void* q, const void* k, const void* v,
                          void* o, int B, int Sq, int Sk, int hd,
                          float scale, int causal, int window, int dtype,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_hd<float>(hd, q, k, v, o, B, Sq, Sk, scale, causal,
                              window, s);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, o, B, Sq, Sk, scale,
                                      causal, window, s);
  return cudaErrorInvalidValue;
}
