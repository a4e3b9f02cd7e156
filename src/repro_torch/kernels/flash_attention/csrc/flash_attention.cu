// Causal flash-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention/flash_attention.py:flash_attention
// (def :77, pallas_call :89):
//   O[b] = softmax(Q[b] K[b]^T * hd^-0.5 + mask) V[b]
// with q [B,Sq,hd], k and v [B,Sk,hd], O [B,Sq,hd] in q's type (fp32 or
// bf16; all three share it), B = Z*b*H fused slots, lanes and heads. Query i
// sees key j iff j <= i + (Sk - Sq) when causal (suffix alignment) and, with
// window > 0, j > i + (Sk - Sq) - window. Everything inside is fp32: q is
// taken to fp32 and scaled before the product, masked scores are -1e30 with
// p = 0, the running max m, denominator l and accumulator acc follow the
// streaming-softmax recurrence of the TPU kernel, and the output is
// acc / max(l, 1e-30), so a fully masked row is exactly 0.
//
// What bounds it on an H100: at the training shape (B = 512, S = 256,
// hd = 80, bf16) the function moves 84 MB (q, k, v read once, O written
// once; 0.025 ms at 3.35 TB/s) and does 5.4 GFLOP of causal products
// (0.005 ms on the bf16 tensor cores), so the bound is bytes. This kernel
// runs the products on the fp32 CUDA cores (67 TFLOP/s at most), a
// simple first design: one block of 256 threads per (fused head, 64-row
// query tile), four threads per query row. Each thread keeps its row of
// scaled q in registers, scores a quarter of each 32-key tile of K staged
// in shared memory (float4 reads, rows padded against bank conflicts),
// and accumulates a quarter of the output columns from the V tile. Key
// tiles the mask hides from every row of the block are skipped: such a
// tile would add p = 0 with alpha = 1, so skipping it changes no bit.
// Tensor cores (wgmma) and TMA are later work.
//
// Batch independence: a block reads only its own fused head and query
// rows, sums every score in one fixed order (d ascending), the row max and
// denominator over the four threads of a row in one fixed shuffle tree,
// and every output column over keys ascending; no atomics and no split of
// the keys across blocks. The result for one (b, row) does not depend on B
// or on any other row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 32;          // keys per shared-memory tile
constexpr int THREADS = 4 * BQ; // four threads per query row
constexpr int KPT = BK / 4;     // scores per thread per tile
constexpr float NEG = -1e30f;   // the TPU kernel's masked score

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as XLA's convert
}

__device__ __forceinline__ bool visible(int kpos, int qpos, int Sk,
                                        int causal, int window) {
  return kpos < Sk && (!causal || kpos <= qpos) &&
         (window <= 0 || kpos > qpos - window);
}

// shared floats: K and V tiles [BK][HD + 4] (the Q tile is staged through
// the same space first), P [BQ][BK + 1]
template <int HD>
constexpr int smem_floats() {
  return 2 * BK * (HD + 4) + BQ * (BK + 1);
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int Sq, int Sk,
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
  const T* qb = q + b * Sq * HD;
  const T* kb = k + b * Sk * HD;
  const T* vb = v + b * Sk * HD;

  // Q tile -> shared (coalesced) -> each thread's row into registers
  for (int e = tid; e < BQ * HD; e += THREADS) {
    const int r = e / HD;
    smem[e] = q0 + r < Sq ? to_f32(qb[(long long)q0 * HD + e]) * scale : 0.f;
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
      Ks[r * KS + d] = in ? to_f32(kb[g]) : 0.f;
      Vs[r * KS + d] = in ? to_f32(vb[g]) : 0.f;
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
    T* orow = o + (b * Sq + qi) * HD + quad * DPT;
#pragma unroll
    for (int c = 0; c < DPT; ++c) store(orow + c, acc[c] / denom);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int Sq, int Sk, float scale, int causal,
                   int window, cudaStream_t stream) {
  const int n_qt = (Sq + BQ - 1) / BQ;
  const long long blocks = (long long)B * n_qt;
  if (B <= 0 || Sq <= 0 || Sk <= 0 || blocks > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  constexpr size_t bytes = smem_floats<HD>() * sizeof(float);
  static_assert(bytes <= 48 * 1024, "needs no dynamic shared memory opt-in");
  flash_fwd_kernel<T, HD><<<(unsigned)blocks, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Sk, n_qt, scale,
      causal, window);
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
