// flash attention, backward: dQ, dK and dV of csrc/flash_attention.cu's
// forward, with the same GQA, causal mask, sliding window, logit softcap and
// scale (kv_len is not taken: the wrapper refuses it); float32 or bfloat16
// in and out, float32 arithmetic throughout.
//
// The TPU side has no backward kernel: the JAX package trains through jnp
// attention (src/repro/models/attention.py:blockwise_attention) and
// differentiates it with jax.vjp; the forward's Pallas kernel is
// src/repro/kernels/flash_attention.py:flash_attention.  This is
// FlashAttention-2's backward (Dao, 2023), deterministic, with no float
// atomics, in three kernels a call:
//   1. flash_bwd_dot:  D_i = sum_d dO_i,d O_i,d, one warp a query row;
//   2. flash_bwd_dkdv: one block per (tile of keys, kv head, batch).  It
//      keeps its K and V tile in shared memory and its dK and dV in
//      registers, and walks the query heads of its kv head (the GQA sum)
//      and, for each, the query tiles that can see its keys.  Per tile it
//      recomputes S = scale Q K^T (softcapped: cap tanh(S / cap)) and
//      P = exp(S - lse) from the forward's per-row log-sum-exp, and
//      dP = dO V^T, dS = P (dP - D) (times 1 - tanh^2 under the softcap);
//      then dV += P^T dO and dK += dS^T Q;
//   3. flash_bwd_dq:   one block per (tile of queries, head, batch), the
//      same recomputation over the key tiles its rows can see, dQ += dS K.
// A query row whose every key is masked (the forward averages V over all
// Sk keys: its scores are all the same -2^30) gets P = 1/Sk and dS = 0, so
// it adds dO/Sk to every dV and nothing to dQ or dK; when the call has such
// rows, the dK/dV blocks visit every query tile.
//
// Bound on the card: five products of 2·B·H·S²·hd operations (S, dP, dV,
// dK, dQ; halved under the causal mask) against q, o, dO (and lse) read and
// dq written, k and v read and dk, dv written, each once.  With bf16 inputs
// and causal GQA that is about 5·H·S / (8·(H + KV)) operations a byte, so on
// an H100 (989 TFLOP/s bf16 over 3.35 TB/s) the bytes bound it below
// S ~ 630 at 24/8 heads, granite's training length of 512 included, and the
// operations above.  This first version is simple, not fast: every
// product is FP32 FMAs on the CUDA cores (67 TFLOP/s, not the 989 of bf16
// tensor cores), each thread an (8 x 4) piece of a score tile and of an
// accumulator, operands in padded shared-memory rows (HD + 1 floats, no
// bank conflicts), one block of 128 threads; making it fast (mma.sync or
// wgmma, S kept in registers) is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

struct Strides {
  long long b, h, s;
};

struct Problem {
  int H, group, Sq, Sk;
  Strides q, k;  // q: q, o, dO, dq; k: k, v, dk, dv
  float scale, cap;
  int causal, window;
  int all_keyed;  // every query row has at least one key it may see
  const float* lse;  // (B, H, Sq)
  float* D;          // (B, H, Sq)
};

// keys a block of BK keys, query rows a tile of BQ rows
template <int HD>
struct Tile {
  static constexpr int BK = HD <= 64 ? 64 : (HD <= 128 ? 32 : 16);
  static constexpr int BQ = HD <= 64 ? 64 : 32;
  static constexpr int LD = HD + 1;  // padded row of Q, dO, K, V
  static constexpr int LP = BK + 1;  // padded row of P and dS
  static constexpr int RQ = BQ / 8;  // score rows a thread
  static constexpr int CK = BK / 16;  // score columns a thread
  static constexpr int CD = HD / 16;  // head-dim columns a thread
  static constexpr int RK = BK / 8;   // dK / dV rows a thread
  static constexpr size_t kSmem =
      sizeof(float) * (size_t)(2 * BK * LD + 2 * BQ * LD + 2 * BQ * LP +
                               2 * BQ);
  static_assert(HD % 16 == 0 && BK % 16 == 0 && BQ % 8 == 0, "tiles");
};

__device__ __forceinline__ bool keyless(const Problem& P, int i) {
  int lo = i - P.window + 1;
  if (lo < 0) lo = 0;
  int hi = P.Sk - 1;
  if (P.causal && i < hi) hi = i;
  return lo > hi;
}

// rows [r0, r0 + rows) of a (.., hd) tensor into shared memory as float32,
// zeros past `limit`
template <typename T, int HD>
__device__ __forceinline__ void load_rows(float* dst, const T* src,
                                          long long stride, int r0, int rows,
                                          int limit) {
  constexpr int LD = HD + 1;
  for (int e = threadIdx.x; e < rows * HD; e += kThreads) {
    const int r = e / HD, d = e % HD, row = r0 + r;
    dst[r * LD + d] = row < limit ? ld(src + row * stride + d) : 0.0f;
  }
}

// Per thread: the score tile's rows ty*RQ + i and columns tx + 16 j.  Makes
// P and dS of the (q0.., k0..) tile from Qs, dOs, Ks, Vs and the rows' lse
// and D, into Ps and dSs.
template <int HD>
__device__ __forceinline__ void p_and_ds(const Problem& P, const float* Qs,
                                         const float* dOs, const float* Ks,
                                         const float* Vs, const float* lse_s,
                                         const float* D_s, float* Ps,
                                         float* dSs, int q0, int k0) {
  using Tl = Tile<HD>;
  constexpr int LD = Tl::LD, LP = Tl::LP, RQ = Tl::RQ, CK = Tl::CK;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float s[RQ][CK], dp[RQ][CK];
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int j = 0; j < CK; ++j) s[i][j] = dp[i][j] = 0.0f;
#pragma unroll 2
  for (int d = 0; d < HD; ++d) {
    float qv[RQ], ov[RQ], kv[CK], vv[CK];
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      qv[i] = Qs[(ty * RQ + i) * LD + d];
      ov[i] = dOs[(ty * RQ + i) * LD + d];
    }
#pragma unroll
    for (int j = 0; j < CK; ++j) {
      kv[j] = Ks[(tx + 16 * j) * LD + d];
      vv[j] = Vs[(tx + 16 * j) * LD + d];
    }
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        s[i][j] += qv[i] * kv[j];
        dp[i][j] += ov[i] * vv[j];
      }
  }
  const float inv_sk = 1.0f / (float)P.Sk;
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int r = ty * RQ + i, qi = q0 + r;
    const bool row_ok = qi < P.Sq;
    const bool no_key = row_ok && keyless(P, qi);
#pragma unroll
    for (int j = 0; j < CK; ++j) {
      const int c = tx + 16 * j, kj = k0 + c;
      float val = s[i][j] * P.scale, deriv = 1.0f;
      if (P.cap > 0.0f) {
        const float t = tanhf(val / P.cap);
        val = P.cap * t;
        deriv = 1.0f - t * t;
      }
      bool ok = row_ok && kj < P.Sk && kj > qi - P.window;
      if (P.causal) ok = ok && kj <= qi;
      float p = 0.0f, ds = 0.0f;
      if (ok) {
        p = expf(val - lse_s[r]);
        ds = p * (dp[i][j] - D_s[r]) * deriv;
      } else if (no_key && kj < P.Sk) {
        p = inv_sk;
      }
      Ps[r * LP + c] = p;
      dSs[r * LP + c] = ds;
    }
  }
}

// D_i = sum_d dO_i,d O_i,d: one warp a row
template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dot(const T* __restrict__ o, const T* __restrict__ dO, int hd,
                  Problem P) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * (kThreads / 32) + warp;
  const int h = blockIdx.y, b = blockIdx.z;
  if (row >= P.Sq) return;
  const long long off = b * P.q.b + h * P.q.h + row * P.q.s;
  float acc = 0.0f;
  for (int d = lane; d < hd; d += 32) acc += ld(o + off + d) * ld(dO + off + d);
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, w);
  if (lane == 0) P.D[((long long)b * P.H + h) * P.Sq + row] = acc;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dO,
                   T* __restrict__ dk, T* __restrict__ dv, Problem P) {
  using Tl = Tile<HD>;
  constexpr int BK = Tl::BK, BQ = Tl::BQ, LD = Tl::LD, LP = Tl::LP;
  constexpr int RK = Tl::RK, CD = Tl::CD;
  extern __shared__ float smem[];
  float* Ks = smem;              // BK x LD
  float* Vs = Ks + BK * LD;      // BK x LD
  float* Qs = Vs + BK * LD;      // BQ x LD
  float* dOs = Qs + BQ * LD;     // BQ x LD
  float* Ps = dOs + BQ * LD;     // BQ x LP
  float* dSs = Ps + BQ * LP;     // BQ x LP
  float* lse_s = dSs + BQ * LP;  // BQ
  float* D_s = lse_s + BQ;       // BQ

  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int k0 = blockIdx.x * BK, kvh = blockIdx.y, b = blockIdx.z;
  const T* kp = k + b * P.k.b + kvh * P.k.h;
  const T* vp = v + b * P.k.b + kvh * P.k.h;
  load_rows<T, HD>(Ks, kp, P.k.s, k0, BK, P.Sk);
  load_rows<T, HD>(Vs, vp, P.k.s, k0, BK, P.Sk);

  // the query rows that can see a key of this tile
  int q_begin = 0, q_end = P.Sq;
  if (P.all_keyed) {
    const long long k_last = (k0 + BK < P.Sk ? k0 + BK : P.Sk) - 1;
    if (P.causal) q_begin = k0;
    const long long last = k_last + (long long)P.window - 1;
    if (last + 1 < q_end) q_end = (int)(last + 1);
    q_begin = (q_begin / BQ) * BQ;
  }

  float acc_k[RK][CD], acc_v[RK][CD];
#pragma unroll
  for (int i = 0; i < RK; ++i)
#pragma unroll
    for (int j = 0; j < CD; ++j) acc_k[i][j] = acc_v[i][j] = 0.0f;

  for (int g = 0; g < P.group; ++g) {
    const int h = kvh * P.group + g;
    const long long qoff = b * P.q.b + h * P.q.h;
    const float* lse = P.lse + ((long long)b * P.H + h) * P.Sq;
    const float* D = P.D + ((long long)b * P.H + h) * P.Sq;
    for (int q0 = q_begin; q0 < q_end; q0 += BQ) {
      __syncthreads();  // the last tile's readers are done
      load_rows<T, HD>(Qs, q + qoff, P.q.s, q0, BQ, P.Sq);
      load_rows<T, HD>(dOs, dO + qoff, P.q.s, q0, BQ, P.Sq);
      for (int r = threadIdx.x; r < BQ; r += kThreads) {
        const bool in = q0 + r < P.Sq;
        lse_s[r] = in ? lse[q0 + r] : 0.0f;
        D_s[r] = in ? D[q0 + r] : 0.0f;
      }
      __syncthreads();
      p_and_ds<HD>(P, Qs, dOs, Ks, Vs, lse_s, D_s, Ps, dSs, q0, k0);
      __syncthreads();
      // dV += P^T dO, dK += dS^T Q: keys ty*RK + i, columns tx + 16 j
#pragma unroll 4
      for (int r = 0; r < BQ; ++r) {
        float pv[RK], sv[RK], ov[CD], qv[CD];
#pragma unroll
        for (int i = 0; i < RK; ++i) {
          pv[i] = Ps[r * LP + ty * RK + i];
          sv[i] = dSs[r * LP + ty * RK + i];
        }
#pragma unroll
        for (int j = 0; j < CD; ++j) {
          ov[j] = dOs[r * LD + tx + 16 * j];
          qv[j] = Qs[r * LD + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < RK; ++i)
#pragma unroll
          for (int j = 0; j < CD; ++j) {
            acc_v[i][j] += pv[i] * ov[j];
            acc_k[i][j] += sv[i] * qv[j];
          }
      }
    }
  }

  T* dkp = dk + b * P.k.b + kvh * P.k.h;
  T* dvp = dv + b * P.k.b + kvh * P.k.h;
#pragma unroll
  for (int i = 0; i < RK; ++i) {
    const int key = k0 + ty * RK + i;
    if (key >= P.Sk) continue;
#pragma unroll
    for (int j = 0; j < CD; ++j) {
      st(dkp + key * P.k.s + tx + 16 * j, acc_k[i][j] * P.scale);
      st(dvp + key * P.k.s + tx + 16 * j, acc_v[i][j]);
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dO,
                 T* __restrict__ dq, Problem P) {
  using Tl = Tile<HD>;
  constexpr int BK = Tl::BK, BQ = Tl::BQ, LD = Tl::LD, LP = Tl::LP;
  constexpr int RQ = Tl::RQ, CD = Tl::CD;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + BK * LD;
  float* Qs = Vs + BK * LD;
  float* dOs = Qs + BQ * LD;
  float* Ps = dOs + BQ * LD;
  float* dSs = Ps + BQ * LP;
  float* lse_s = dSs + BQ * LP;
  float* D_s = lse_s + BQ;

  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int nq = (P.Sq + BQ - 1) / BQ;
  const int q0 = (nq - 1 - (int)blockIdx.x) * BQ;  // longest rows first
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / P.group;
  const long long qoff = b * P.q.b + h * P.q.h;
  const T* kp = k + b * P.k.b + kvh * P.k.h;
  const T* vp = v + b * P.k.b + kvh * P.k.h;
  load_rows<T, HD>(Qs, q + qoff, P.q.s, q0, BQ, P.Sq);
  load_rows<T, HD>(dOs, dO + qoff, P.q.s, q0, BQ, P.Sq);
  const float* lse = P.lse + ((long long)b * P.H + h) * P.Sq;
  const float* D = P.D + ((long long)b * P.H + h) * P.Sq;
  for (int r = threadIdx.x; r < BQ; r += kThreads) {
    const bool in = q0 + r < P.Sq;
    lse_s[r] = in ? lse[q0 + r] : 0.0f;
    D_s[r] = in ? D[q0 + r] : 0.0f;
  }

  // the keys this tile's rows may see (dS is 0 on every other key)
  const int q_last = (q0 + BQ < P.Sq ? q0 + BQ : P.Sq) - 1;
  int k_begin = q0 - P.window + 1;
  if (k_begin < 0) k_begin = 0;
  k_begin = (k_begin / BK) * BK;
  int k_end = P.Sk;
  if (P.causal && q_last + 1 < k_end) k_end = q_last + 1;

  float acc[RQ][CD];
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int j = 0; j < CD; ++j) acc[i][j] = 0.0f;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();  // the last tile's readers are done (and Q's stores)
    load_rows<T, HD>(Ks, kp, P.k.s, k0, BK, P.Sk);
    load_rows<T, HD>(Vs, vp, P.k.s, k0, BK, P.Sk);
    __syncthreads();
    p_and_ds<HD>(P, Qs, dOs, Ks, Vs, lse_s, D_s, Ps, dSs, q0, k0);
    __syncthreads();
    // dQ += dS K: rows ty*RQ + i, columns tx + 16 j
#pragma unroll 2
    for (int c = 0; c < BK; ++c) {
      float sv[RQ], kv[CD];
#pragma unroll
      for (int i = 0; i < RQ; ++i) sv[i] = dSs[(ty * RQ + i) * LP + c];
#pragma unroll
      for (int j = 0; j < CD; ++j) kv[j] = Ks[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < CD; ++j) acc[i][j] += sv[i] * kv[j];
    }
  }

  T* dqp = dq + qoff;
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int row = q0 + ty * RQ + i;
    if (row >= P.Sq) continue;
#pragma unroll
    for (int j = 0; j < CD; ++j)
      st(dqp + row * P.q.s + tx + 16 * j, acc[i][j] * P.scale);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dO, void* dq, void* dk, void* dv, int B,
           const Problem& P, cudaStream_t stream) {
  using Tl = Tile<HD>;
  const T* q_ = static_cast<const T*>(q);
  const T* k_ = static_cast<const T*>(k);
  const T* v_ = static_cast<const T*>(v);
  const T* dO_ = static_cast<const T*>(dO);
  flash_bwd_dot<T><<<dim3((P.Sq + 3) / 4, P.H, B), kThreads, 0, stream>>>(
      static_cast<const T*>(o), dO_, HD, P);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  auto kv_kern = flash_bwd_dkdv<T, HD>;
  err = cudaFuncSetAttribute(kv_kern,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)Tl::kSmem);
  if (err != cudaSuccess) return (int)err;
  kv_kern<<<dim3((P.Sk + Tl::BK - 1) / Tl::BK, P.H / P.group, B), kThreads,
            Tl::kSmem, stream>>>(q_, k_, v_, dO_, static_cast<T*>(dk),
                                 static_cast<T*>(dv), P);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  auto q_kern = flash_bwd_dq<T, HD>;
  err = cudaFuncSetAttribute(q_kern,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)Tl::kSmem);
  if (err != cudaSuccess) return (int)err;
  q_kern<<<dim3((P.Sq + Tl::BQ - 1) / Tl::BQ, P.H, B), kThreads, Tl::kSmem,
           stream>>>(q_, k_, v_, dO_, static_cast<T*>(dq), P);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_hd(int dtype, const void* q, const void* k, const void* v,
              const void* o, const void* dO, void* dq, void* dk, void* dv,
              int B, const Problem& P, cudaStream_t stream) {
  if (dtype == 0)
    return launch<float, HD>(q, k, v, o, dO, dq, dk, dv, B, P, stream);
  return launch<__nv_bfloat16, HD>(q, k, v, o, dO, dq, dk, dv, B, P, stream);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  q, o, dO and dq share the (b, h, s)
// strides q*; k, v, dk and dv share k*; the head dim is contiguous.  lse:
// the forward's (B, H, Sq) float32 log-sum-exp; D: (B, H, Sq) float32
// scratch.  window: keys k > q - window are kept (2^30 for none).
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dO, const float* lse, void* dq, void* dk, void* dv, float* D,
    int dtype, int B, int H, int KV, int Sq, int Sk, int hd, long long qb,
    long long qh, long long qs, long long kb, long long kh, long long ks,
    float scale, float cap, int causal, int window, int device,
    cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0) return 0;
  if (KV <= 0 || H % KV || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  Problem P;
  P.H = H;
  P.group = H / KV;
  P.Sq = Sq;
  P.Sk = Sk;
  P.q = {qb, qh, qs};
  P.k = {kb, kh, ks};
  P.scale = scale;
  P.cap = cap;
  P.causal = causal;
  P.window = window;
  // every row has a key: a window of at least one key, and no row past the
  // last key's window (rows Sk + window - 1 and on see none)
  P.all_keyed =
      window >= 1 && (long long)Sq - 1 < (long long)Sk + window - 1;
  P.lse = lse;
  P.D = D;
  switch (hd) {
    case 16: return launch_hd<16>(dtype, q, k, v, o, dO, dq, dk, dv, B, P, stream);
    case 32: return launch_hd<32>(dtype, q, k, v, o, dO, dq, dk, dv, B, P, stream);
    case 64: return launch_hd<64>(dtype, q, k, v, o, dO, dq, dk, dv, B, P, stream);
    case 80: return launch_hd<80>(dtype, q, k, v, o, dO, dq, dk, dv, B, P, stream);
    case 128: return launch_hd<128>(dtype, q, k, v, o, dO, dq, dk, dv, B, P, stream);
    case 256: return launch_hd<256>(dtype, q, k, v, o, dO, dq, dk, dv, B, P, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
