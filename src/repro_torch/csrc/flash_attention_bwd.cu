// flash attention, backward: dQ, dK and dV of csrc/flash_attention.cu's
// forward, with the same GQA, causal mask, sliding window, logit softcap and
// scale (kv_len is not taken: the wrapper refuses it); float32 or bfloat16
// in and out, float32 accumulation throughout.
//
// The TPU side has no backward kernel: the JAX package trains through jnp
// attention (src/repro/models/attention.py:blockwise_attention) and
// differentiates it with jax.vjp; the forward's Pallas kernel is
// src/repro/kernels/flash_attention.py:flash_attention.  This is
// FlashAttention-2's backward (Dao, 2023), deterministic, with no float
// atomics, in three kernels a call:
//   1. D_i = sum_d dO_i,d O_i,d, one warp a query row (bf16: a few threads
//      a row, 16-byte loads);
//   2. dK/dV: one block per (kv head, batch, tile of keys), the tiles with
//      the most visible queries (the first, under the causal mask) launched
//      first.  It keeps its K and V tile in shared memory and its dK and dV
//      in registers, and walks the query heads of its kv head (the GQA sum)
//      and, for each, the query tiles that can see its keys.  Per tile it
//      recomputes S = scale Q K^T (softcapped: cap tanh(S / cap)) and
//      P = exp(S - lse) from the forward's per-row log-sum-exp, and
//      dP = dO V^T, dS = P (dP - D) (times 1 - tanh^2 under the softcap);
//      then dV += P^T dO and dK += dS^T Q;
//   3. dQ: one block per (head, batch, tile of queries), the longest rows
//      first, the same recomputation over the key tiles its rows can see,
//      dQ += dS K.
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
// operations above.
//
// - bfloat16 (the models' path): every product on the tensor cores,
//   mma.sync m16n8k16 bf16 into float32 registers, with the forward's
//   pieces (flash_mma.cuh).  Operands stay bf16 in shared memory, in rows
//   padded to hd + 8 (conflict-free ldmatrix), brought in by cp.async
//   rings.  The dK/dV kernel gives each warp 16 keys and computes the
//   transposed scores S^T = K Q^T and dP^T = V dO^T, a piece of 32 query
//   rows at a time (16 above hd 80), so that its accumulator fragments are
//   laid out by key: P^T and
//   dS^T are formed in registers (lse and D per fragment column, from
//   shared memory) and are at once the A fragments of dV += P^T dO and
//   dK += dS^T Q, whose B fragments are ldmatrix.trans of the dO and Q
//   rows; nothing of P or dS touches shared memory.  The dQ kernel gives
//   each warp 16 query rows: S = Q K^T and dP = dO V^T over 16 keys at a
//   time, dS in registers, dQ += dS K with K through ldmatrix.trans.  D
//   reads o and dO with 16-byte loads, a few threads a row.  P and dS stay
//   float32-accurate: the reference differentiates in float32, and one
//   bf16 rounding of P or dS (8 bits) leaves elements where dO or Q cancel
//   outside one bf16 step of the gradient, so each is split into
//   hi = bf16(x) and lo = bf16(x - hi) and both products are issued
//   (tests/test_torch_flash_bwd_split.py emulates this on the CPU).  The
//   softcap is a template parameter, so the common path computes no tanh;
//   masks are applied only where a warp's piece may meet a masked pair,
//   and pieces with no visible pair are skipped.  At hd 256 the
//   16 x 256 dK and dV of a warp would take 256 registers a thread, so two
//   warps share 16 keys, each accumulating half the columns (the scores are
//   computed by both).
// - float32: FP32 FMAs on the CUDA cores (TF32 would not hold the 1e-4
//   bound), each thread an (8 x 4) piece of a score tile and of an
//   accumulator, operands in padded shared-memory rows (HD + 1 floats, no
//   bank conflicts), P and dS through shared memory, one block of 128
//   threads.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_mma.cuh"

namespace {

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

// ---- float32: CUDA cores ---------------------------------------------------

// rows [r0, r0 + rows) of a (.., hd) tensor into shared memory, zeros past
// `limit`
template <int HD>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          long long stride, int r0, int rows,
                                          int limit) {
  constexpr int LD = HD + 1;
  for (int e = threadIdx.x; e < rows * HD; e += kThreads) {
    const int r = e / HD, d = e % HD, row = r0 + r;
    dst[r * LD + d] = row < limit ? src[row * stride + d] : 0.0f;
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
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dot(const float* __restrict__ o, const float* __restrict__ dO,
                  int hd, Problem P) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * (kThreads / 32) + warp;
  const int h = blockIdx.y, b = blockIdx.z;
  if (row >= P.Sq) return;
  const long long off = b * P.q.b + h * P.q.h + row * P.q.s;
  float acc = 0.0f;
  for (int d = lane; d < hd; d += 32) acc += o[off + d] * dO[off + d];
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, w);
  if (lane == 0) P.D[((long long)b * P.H + h) * P.Sq + row] = acc;
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkdv(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ dO,
                   float* __restrict__ dk, float* __restrict__ dv, Problem P) {
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
  const float* kp = k + b * P.k.b + kvh * P.k.h;
  const float* vp = v + b * P.k.b + kvh * P.k.h;
  load_rows<HD>(Ks, kp, P.k.s, k0, BK, P.Sk);
  load_rows<HD>(Vs, vp, P.k.s, k0, BK, P.Sk);

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
      load_rows<HD>(Qs, q + qoff, P.q.s, q0, BQ, P.Sq);
      load_rows<HD>(dOs, dO + qoff, P.q.s, q0, BQ, P.Sq);
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

  float* dkp = dk + b * P.k.b + kvh * P.k.h;
  float* dvp = dv + b * P.k.b + kvh * P.k.h;
#pragma unroll
  for (int i = 0; i < RK; ++i) {
    const int key = k0 + ty * RK + i;
    if (key >= P.Sk) continue;
#pragma unroll
    for (int j = 0; j < CD; ++j) {
      dkp[key * P.k.s + tx + 16 * j] = acc_k[i][j] * P.scale;
      dvp[key * P.k.s + tx + 16 * j] = acc_v[i][j];
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dO,
                 float* __restrict__ dq, Problem P) {
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
  const float* kp = k + b * P.k.b + kvh * P.k.h;
  const float* vp = v + b * P.k.b + kvh * P.k.h;
  load_rows<HD>(Qs, q + qoff, P.q.s, q0, BQ, P.Sq);
  load_rows<HD>(dOs, dO + qoff, P.q.s, q0, BQ, P.Sq);
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
    load_rows<HD>(Ks, kp, P.k.s, k0, BK, P.Sk);
    load_rows<HD>(Vs, vp, P.k.s, k0, BK, P.Sk);
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

  float* dqp = dq + qoff;
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int row = q0 + ty * RQ + i;
    if (row >= P.Sq) continue;
#pragma unroll
    for (int j = 0; j < CD; ++j)
      dqp[row * P.q.s + tx + 16 * j] = acc[i][j] * P.scale;
  }
}

// ---- bfloat16: tensor cores -------------------------------------------------

namespace tc {

// The dK/dV kernel's shape at head dim HD: 4 warps, SPLIT of them on each
// 16 keys (each accumulating HD / SPLIT columns of dK and dV; at hd 256 a
// warp's 16 x 256 dK and dV alone would take 256 registers a thread); BQ
// query rows a ring stage, STAGES stages; PQ query rows a piece (the
// products of a piece are independent, so wider pieces keep more in
// flight, as far as the registers allow); kMinBlocks resident on an SM
// (caps the registers).  chip_kernel_shapes.py times the alternatives.
template <int HD_>
struct KvShape {
  static constexpr int HD = HD_;
  static constexpr int SPLIT = HD > 128 ? 2 : 1;
  static constexpr int BQ = HD > 128 ? 32 : 64;
  static constexpr int STAGES = 2;
  static constexpr int PQ = HD <= 80 ? 32 : 16;
  static constexpr int kMinBlocks = HD <= 128 ? 2 : 1;
  static constexpr int BK = 16 * (kThreads / 32) / SPLIT;  // keys a block
  static constexpr int HDW = HD / SPLIT;  // dK/dV columns a warp
  static constexpr int LD = HD + 8;
  // K's and V's A fragments held in registers across the query tiles
  // (above hd 80 they are re-read from shared memory)
  static constexpr bool kKVInRegs = HD <= 80;
  // depth steps of the scores unrolled (at hd 256, 4 of 16: fewer
  // fragments in flight, no spill)
  static constexpr int kUnrollKS = HD > 128 ? 4 : HD / 16;
  static constexpr size_t kSmem =
      sizeof(bf16) * (size_t)(2 * BK * LD + 2 * STAGES * BQ * LD) +
      sizeof(float) * (size_t)(2 * STAGES * BQ);
};

// The dQ kernel's shape: 4 warps of 16 query rows; BK keys a ring stage,
// STAGES stages, PK keys a piece, kMinBlocks resident on an SM.
template <int HD_>
struct QShape {
  static constexpr int HD = HD_;
  static constexpr int BK = HD > 128 ? 32 : 64;
  static constexpr int STAGES = 2;
  static constexpr int PK = 16;
  static constexpr int kMinBlocks = HD <= 128 ? 2 : 1;
  static constexpr int BQ = 16 * kThreads / 32;  // query rows a block
  static constexpr int LD = HD + 8;
  // Q's and dO's A fragments held in registers across the key tiles (at hd
  // 256, where the dQ accumulators take 128 registers, they are re-read
  // from shared memory)
  static constexpr bool kQInRegs = HD <= 128;
  static constexpr int kUnrollKS = HD > 128 ? 4 : HD / 16;
  static constexpr size_t kSmem =
      sizeof(bf16) * (size_t)(2 * BQ * LD + 2 * STAGES * BK * LD);
};

// threads a row of D's kernel: the power of two at or above HD / 8
__host__ __device__ constexpr int dot_threads(int HD) {
  return HD <= 16 ? 2 : HD <= 32 ? 4 : HD <= 64 ? 8 : HD <= 128 ? 16 : 32;
}

// D_i = sum_d dO_i,d O_i,d of bf16 rows: dot_threads(HD) threads a row, 8
// elements a thread, one 16-byte load of o and of dO where the rows start
// on 16 bytes (vec)
template <int HD>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dot_vec(const bf16* __restrict__ o, const bf16* __restrict__ dO,
                      Problem P, int vec) {
  constexpr int TPR = dot_threads(HD);
  const int row = blockIdx.x * (kThreads / TPR) + threadIdx.x / TPR;
  const int c = (threadIdx.x % TPR) * 8;
  const int h = blockIdx.y, b = blockIdx.z;
  float acc = 0.0f;
  if (row < P.Sq && c < HD) {
    const long long off = b * P.q.b + h * P.q.h + row * P.q.s + c;
    uint32_t ov[4], dv[4];
    if (vec) {
      const uint4 o4 = *reinterpret_cast<const uint4*>(o + off);
      const uint4 d4 = *reinterpret_cast<const uint4*>(dO + off);
      ov[0] = o4.x, ov[1] = o4.y, ov[2] = o4.z, ov[3] = o4.w;
      dv[0] = d4.x, dv[1] = d4.y, dv[2] = d4.z, dv[3] = d4.w;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ov[i] = ld_pair(o + off + 2 * i, false);
        dv[i] = ld_pair(dO + off + 2 * i, false);
      }
    }
    // a bf16 pair as two floats: its low half, then its high half
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc += __uint_as_float(ov[i] << 16) * __uint_as_float(dv[i] << 16);
      acc += __uint_as_float(ov[i] & 0xffff0000u) *
             __uint_as_float(dv[i] & 0xffff0000u);
    }
  }
#pragma unroll
  for (int w = TPR / 2; w > 0; w >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, w);
  if (row < P.Sq && threadIdx.x % TPR == 0)
    P.D[((long long)b * P.H + h) * P.Sq + row] = acc;
}

// 4 bytes global -> shared (a shared-window address), asynchronously;
// zeros when !in
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

// The piece of query rows [q_lo, q_lo + nq) and keys [k_lo, k_lo + nk):
// whether a pair of it may be visible (false: every pair is masked), and
// whether every pair is (no mask needed).
__device__ __forceinline__ bool any_visible(const Problem& P, int q_lo,
                                            int nq, int k_lo, int nk) {
  return q_lo < P.Sq && k_lo < P.Sk && (!P.causal || k_lo <= q_lo + nq - 1)
         && k_lo + nk - 1 > q_lo - P.window;
}
__device__ __forceinline__ bool all_visible(const Problem& P, int q_lo,
                                            int nq, int k_lo, int nk) {
  return P.all_keyed && q_lo + nq - 1 < P.Sq && k_lo + nk - 1 < P.Sk &&
         (!P.causal || k_lo + nk - 1 <= q_lo) &&
         k_lo > q_lo + nq - 1 - P.window;
}

// the score of query qi and key kj (s: their Q.K product) made into P and
// dS in place: p = exp(scale s (softcapped) - lse), ds = p (dp - D) (times
// 1 - tanh^2); lse2 is lse in base-2 units.  `full`: the pair is visible.
template <bool kCap>
__device__ __forceinline__ void p_ds(const Problem& P, float& s, float& dp,
                                     float lse2, float Dq, int qi, int kj,
                                     bool full) {
  constexpr float kLog2e = 1.4426950408889634f;
  float x, deriv = 1.0f;
  if (kCap) {
    const float th = tanhf(s * (P.scale / P.cap));
    x = (P.cap * kLog2e) * th;
    deriv = 1.0f - th * th;
  } else {
    x = s * (P.scale * kLog2e);
  }
  float p = exp2_approx(x - lse2);
  float ds = p * (dp - Dq);
  if (kCap) ds *= deriv;
  if (!full) {
    bool ok = qi < P.Sq && kj < P.Sk && kj > qi - P.window;
    if (P.causal) ok = ok && kj <= qi;
    if (!ok) {
      p = !P.all_keyed && qi < P.Sq && kj < P.Sk && keyless(P, qi)
              ? 1.0f / (float)P.Sk
              : 0.0f;
      ds = 0.0f;
    }
  }
  s = p;
  dp = ds;
}

// the accumulator fragments (rows g, g + 8; columns 2t, 2t + 1) of two
// neighbouring 16 x 8 tiles, c0 and c1, as the hi and lo A fragments of a
// 16 x 16 operand
__device__ __forceinline__ void split_a(const float (&c0)[4],
                                        const float (&c1)[4],
                                        uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split(c0[0], c0[1], hi[0], lo[0]);
  split(c0[2], c0[3], hi[1], lo[1]);
  split(c1[0], c1[1], hi[2], lo[2]);
  split(c1[2], c1[3], hi[3], lo[3]);
}

template <class Cf, bool kCap>
__global__ void __launch_bounds__(kThreads, Cf::kMinBlocks)
    flash_bwd_dkdv_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v,
                       const bf16* __restrict__ dO, bf16* __restrict__ dk,
                       bf16* __restrict__ dv, Problem P, int vec) {
  constexpr int HD = Cf::HD, BK = Cf::BK, BQ = Cf::BQ, LD = Cf::LD;
  constexpr int STAGES = Cf::STAGES, HDW = Cf::HDW, PQ = Cf::PQ;
  constexpr int KS = HD / 16;   // depth steps of K.Q^T
  constexpr int NJ = PQ / 8;    // 8-row query tiles of a piece
  constexpr int NW = HDW / 8;   // 8-wide column tiles of a warp's dK, dV
  static_assert(HDW % 16 == 0 && PQ % 16 == 0 && BQ % PQ == 0,
                "tile shapes");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // BK x LD
  bf16* Vs = Ks + BK * LD;                       // BK x LD
  bf16* Qs = Vs + BK * LD;                       // STAGES x BQ x LD
  bf16* dOs = Qs + STAGES * BQ * LD;             // STAGES x BQ x LD
  // STAGES x (lse of BQ rows in base-2 units, then their D)
  float* stat = reinterpret_cast<float*>(dOs + STAGES * BQ * LD);

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;  // fragment row group, column pair
  const int kvh = blockIdx.x, b = blockIdx.y, k0 = blockIdx.z * BK;
  const int kw = (warp / Cf::SPLIT) * 16;  // this warp's keys: k0 + kw ..
  const int c0 = (warp % Cf::SPLIT) * HDW;  // ... and dK/dV columns
  const int k_lo = k0 + kw;
  const long long koff = b * P.k.b + kvh * P.k.h;

  // the query rows that can see a key of this tile (all of them when some
  // row sees no key); the loop runs over (query head, query tile) pairs
  int q_begin = 0, q_end = P.Sq;
  if (P.all_keyed) {
    const long long k_last = (k0 + BK < P.Sk ? k0 + BK : P.Sk) - 1;
    if (P.causal) q_begin = k0;
    const long long last = k_last + (long long)P.window - 1;
    if (last + 1 < q_end) q_end = (int)(last + 1);
    q_begin = (q_begin / BQ) * BQ;
  }
  const int n_q = q_end > q_begin ? (q_end - q_begin + BQ - 1) / BQ : 0;
  const int n_it = P.group * n_q;

  // the ring: K and V, then (Q, dO, lse, D) tiles 0 .. STAGES - 2, a group
  // each
  const Chunks<Cf, BQ> qrows;
  {
    const Chunks<Cf, BK> krows;
    krows.load(Ks, k + koff, P.k.s, k0, P.Sk, vec);
    krows.load(Vs, v + koff, P.k.s, k0, P.Sk, vec);
    cp_async_commit();
  }
  auto issue = [&](int it) {
    if (it < n_it) {
      const int st = it % STAGES;
      const int h = kvh * P.group + it / n_q;
      const int q0 = q_begin + (it % n_q) * BQ;
      const long long qoff = b * P.q.b + h * P.q.h;
      qrows.load(Qs + st * BQ * LD, q + qoff, P.q.s, q0, P.Sq, vec);
      qrows.load(dOs + st * BQ * LD, dO + qoff, P.q.s, q0, P.Sq, vec);
      const long long row0 = ((long long)b * P.H + h) * P.Sq;
      for (int r = threadIdx.x; r < 2 * BQ; r += kThreads) {
        const int row = q0 + r % BQ;
        const bool in = row < P.Sq;
        cp_async4(smem_u32(stat + st * 2 * BQ + r),
                  (r < BQ ? P.lse : P.D) + row0 + (in ? row : 0), in);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) issue(i);

  // ldmatrix addresses of this lane: A (K, V) and B transposed (Q, dO):
  // rows lane % 16, columns (lane / 16) * 8; B (Q, dO): rows
  // (lane / 16) * 8 + lane % 8, columns ((lane / 8) % 2) * 8
  const int a_lane = (lane % 16) * LD + (lane / 16) * 8;
  const int b_lane = ((lane / 16) * 8 + lane % 8) * LD + ((lane / 8) % 2) * 8;

  // K's and V's A fragments: this warp's keys, columns 16 ks ..
  uint32_t kf[Cf::kKVInRegs ? KS : 1][4], vf[Cf::kKVInRegs ? KS : 1][4];
  if constexpr (Cf::kKVInRegs) {
    cp_async_wait<STAGES - 1>();  // K and V have landed
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      ldmatrix_x4(kf[ks], Ks + kw * LD + a_lane + ks * 16);
      ldmatrix_x4(vf[ks], Vs + kw * LD + a_lane + ks * 16);
    }
  }

  constexpr float kLog2e = 1.4426950408889634f;
  float acc_k[NW][4], acc_v[NW][4];
#pragma unroll
  for (int n = 0; n < NW; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.0f;

  for (int it = 0; it < n_it; ++it) {
    cp_async_wait<STAGES - 2>();  // tile it has landed
    __syncthreads();              // ... for every thread; tile it - 1 is free
    issue(it + STAGES - 1);
    const int st = it % STAGES;
    const int q0 = q_begin + (it % n_q) * BQ;
    const bf16* Qt = Qs + st * BQ * LD;
    const bf16* dOt = dOs + st * BQ * LD;
    const float* lse_t = stat + st * 2 * BQ;
    const float* D_t = lse_t + BQ;

#pragma unroll 1
    for (int c = 0; c < BQ; c += PQ) {  // PQ query rows at a time
      const int q_lo = q0 + c;
      // every pair masked: nothing to add (a row that sees no key still
      // adds dO / Sk to every dV)
      if (P.all_keyed ? !any_visible(P, q_lo, PQ, k_lo, 16)
                      : q_lo >= P.Sq || k_lo >= P.Sk)
        continue;
      const bool full = all_visible(P, q_lo, PQ, k_lo, 16);
      // S^T = K Q^T and dP^T = V dO^T: keys (g, g + 8), query rows
      // 8j + 2t + {0, 1} of the piece
      float s[NJ][4], dp[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.0f;
#pragma unroll (Cf::kUnrollKS)
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t ak[4], av[4], bq[4], bo[4];
        if constexpr (Cf::kKVInRegs) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            ak[e] = kf[ks][e];
            av[e] = vf[ks][e];
          }
        } else {
          ldmatrix_x4(ak, Ks + kw * LD + a_lane + ks * 16);
          ldmatrix_x4(av, Vs + kw * LD + a_lane + ks * 16);
        }
#pragma unroll
        for (int j = 0; j < NJ; j += 2) {
          ldmatrix_x4(bq, Qt + (c + 8 * j) * LD + b_lane + ks * 16);
          ldmatrix_x4(bo, dOt + (c + 8 * j) * LD + b_lane + ks * 16);
          mma(s[j], ak, bq[0], bq[1]);
          mma(s[j + 1], ak, bq[2], bq[3]);
          mma(dp[j], av, bo[0], bo[1]);
          mma(dp[j + 1], av, bo[2], bo[3]);
        }
      }
      // P^T and dS^T in place; lse and D by column (query row)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int r = c + 8 * j + 2 * t;
        const float2 l2 = *reinterpret_cast<const float2*>(lse_t + r);
        const float2 d2 = *reinterpret_cast<const float2*>(D_t + r);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          p_ds<kCap>(P, s[j][e], dp[j][e],
                     ((e & 1) ? l2.y : l2.x) * kLog2e,
                     (e & 1) ? d2.y : d2.x, q0 + r + (e & 1),
                     k_lo + g + 8 * (e / 2), full);
      }
      // dV += P^T dO, dK += dS^T Q, 16 query rows a step, each as hi + lo
      // bf16 halves
#pragma unroll
      for (int j = 0; j < NJ; j += 2) {
        uint32_t ph[4], pl[4], sh[4], sl[4];
        split_a(s[j], s[j + 1], ph, pl);
        split_a(dp[j], dp[j + 1], sh, sl);
        const int row = (c + 8 * j) * LD + a_lane + c0;
#pragma unroll
        for (int n = 0; n < NW / 2; ++n) {
          uint32_t bo[4], bq[4];
          ldmatrix_x4_trans(bo, dOt + row + n * 16);
          ldmatrix_x4_trans(bq, Qt + row + n * 16);
          mma(acc_v[2 * n], ph, bo[0], bo[1]);
          mma(acc_v[2 * n + 1], ph, bo[2], bo[3]);
          mma(acc_k[2 * n], sh, bq[0], bq[1]);
          mma(acc_k[2 * n + 1], sh, bq[2], bq[3]);
          mma(acc_v[2 * n], pl, bo[0], bo[1]);
          mma(acc_v[2 * n + 1], pl, bo[2], bo[3]);
          mma(acc_k[2 * n], sl, bq[0], bq[1]);
          mma(acc_k[2 * n + 1], sl, bq[2], bq[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  bf16* dkp = dk + koff;
  bf16* dvp = dv + koff;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k_lo + g + 8 * r;
    if (key >= P.Sk) continue;
#pragma unroll
    for (int n = 0; n < NW; ++n) {
      const long long at = key * P.k.s + c0 + n * 8 + 2 * t;
      dkp[at] = __float2bfloat16(acc_k[n][2 * r] * P.scale);
      dkp[at + 1] = __float2bfloat16(acc_k[n][2 * r + 1] * P.scale);
      dvp[at] = __float2bfloat16(acc_v[n][2 * r]);
      dvp[at + 1] = __float2bfloat16(acc_v[n][2 * r + 1]);
    }
  }
}

template <class Cf, bool kCap>
__global__ void __launch_bounds__(kThreads, Cf::kMinBlocks)
    flash_bwd_dq_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dO,
                     bf16* __restrict__ dq, Problem P, int vec) {
  constexpr int HD = Cf::HD, BK = Cf::BK, BQ = Cf::BQ, LD = Cf::LD;
  constexpr int STAGES = Cf::STAGES, PK = Cf::PK;
  constexpr int KS = HD / 16;  // depth steps of Q.K^T
  constexpr int NJ = PK / 8;   // 8-key tiles of a piece
  constexpr int ND = HD / 8;   // 8-wide column tiles of dQ
  static_assert(ND % 2 == 0 && PK % 16 == 0 && BK % PK == 0, "tile shapes");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // BQ x LD
  bf16* dOs = Qs + BQ * LD;                      // BQ x LD
  bf16* Ks = dOs + BQ * LD;                      // STAGES x BK x LD
  bf16* Vs = Ks + STAGES * BK * LD;              // STAGES x BK x LD

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int nq = (P.Sq + BQ - 1) / BQ;
  const int h = blockIdx.x, b = blockIdx.y, kvh = h / P.group;
  const int q0 = (nq - 1 - (int)blockIdx.z) * BQ;  // longest rows first
  const int q_lo = q0 + warp * 16;                 // this warp's rows
  const long long qoff = b * P.q.b + h * P.q.h;
  const long long koff = b * P.k.b + kvh * P.k.h;

  // the keys this tile's rows may see (dS is 0 on every other key)
  const int q_last = (q0 + BQ < P.Sq ? q0 + BQ : P.Sq) - 1;
  int k_begin = q0 - P.window + 1;
  if (k_begin < 0) k_begin = 0;
  k_begin = (k_begin / BK) * BK;
  int k_end = P.Sk;
  if (P.causal && q_last + 1 < k_end) k_end = q_last + 1;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;

  // the ring: Q and dO with K/V tile 0, then tiles 1 .. STAGES - 2
  {
    const Chunks<Cf, BQ> qrows;
    qrows.load(Qs, q + qoff, P.q.s, q0, P.Sq, vec);
    qrows.load(dOs, dO + qoff, P.q.s, q0, P.Sq, vec);
  }
  const Chunks<Cf, BK> krows;
  auto issue = [&](int it) {
    if (it < n_tiles) {
      const int st = it % STAGES;
      krows.load(Ks + st * BK * LD, k + koff, P.k.s, k_begin + it * BK, P.Sk,
                 vec);
      krows.load(Vs + st * BK * LD, v + koff, P.k.s, k_begin + it * BK, P.Sk,
                 vec);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) issue(i);

  // this thread's rows g and g + 8 of the warp's 16: lse (base-2) and D
  constexpr float kLog2e = 1.4426950408889634f;
  const int rows[2] = {q_lo + g, q_lo + g + 8};
  float lse2[2], Dr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long at = ((long long)b * P.H + h) * P.Sq + rows[r];
    lse2[r] = rows[r] < P.Sq ? P.lse[at] * kLog2e : 0.0f;
    Dr[r] = rows[r] < P.Sq ? P.D[at] : 0.0f;
  }

  const int a_lane = (lane % 16) * LD + (lane / 16) * 8;
  const int b_lane = ((lane / 16) * 8 + lane % 8) * LD + ((lane / 8) % 2) * 8;
  const bf16* q_warp = Qs + warp * 16 * LD + a_lane;
  const bf16* o_warp = dOs + warp * 16 * LD + a_lane;

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  uint32_t qf[Cf::kQInRegs ? KS : 1][4], of[Cf::kQInRegs ? KS : 1][4];

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = k_begin + it * BK;
    cp_async_wait<STAGES - 2>();  // tile it (and Q, dO) has landed
    __syncthreads();              // ... for every thread; tile it - 1 is free
    issue(it + STAGES - 1);
    if constexpr (Cf::kQInRegs) {
      if (it == 0) {
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          ldmatrix_x4(qf[ks], q_warp + ks * 16);
          ldmatrix_x4(of[ks], o_warp + ks * 16);
        }
      }
    }
    const bf16* Kt = Ks + (it % STAGES) * BK * LD;
    const bf16* Vt = Vs + (it % STAGES) * BK * LD;

#pragma unroll 1
    for (int c = 0; c < BK; c += PK) {  // PK keys at a time
      const int k_lo = k0 + c;
      // every pair masked (rows without a key have dS = 0)
      if (!any_visible(P, q_lo, 16, k_lo, PK)) continue;
      const bool full = all_visible(P, q_lo, 16, k_lo, PK);
      // S = Q K^T and dP = dO V^T: rows (g, g + 8), keys 8j + 2t + {0, 1}
      // of the piece
      float s[NJ][4], dp[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.0f;
#pragma unroll (Cf::kUnrollKS)
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t aq[4], ao[4], bk[4], bv[4];
        if constexpr (Cf::kQInRegs) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            aq[e] = qf[ks][e];
            ao[e] = of[ks][e];
          }
        } else {
          ldmatrix_x4(aq, q_warp + ks * 16);
          ldmatrix_x4(ao, o_warp + ks * 16);
        }
#pragma unroll
        for (int j = 0; j < NJ; j += 2) {
          ldmatrix_x4(bk, Kt + (c + 8 * j) * LD + b_lane + ks * 16);
          ldmatrix_x4(bv, Vt + (c + 8 * j) * LD + b_lane + ks * 16);
          mma(s[j], aq, bk[0], bk[1]);
          mma(s[j + 1], aq, bk[2], bk[3]);
          mma(dp[j], ao, bv[0], bv[1]);
          mma(dp[j + 1], ao, bv[2], bv[3]);
        }
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          p_ds<kCap>(P, s[j][e], dp[j][e], lse2[e / 2], Dr[e / 2],
                     rows[e / 2], k_lo + 8 * j + 2 * t + (e & 1), full);
      // dQ += dS K, 16 keys a step, dS as hi + lo bf16 halves
#pragma unroll
      for (int j = 0; j < NJ; j += 2) {
        uint32_t sh[4], sl[4];
        split_a(dp[j], dp[j + 1], sh, sl);
#pragma unroll
        for (int n = 0; n < ND / 2; ++n) {
          uint32_t bk[4];
          ldmatrix_x4_trans(bk, Kt + (c + 8 * j) * LD + a_lane + n * 16);
          mma(acc[2 * n], sh, bk[0], bk[1]);
          mma(acc[2 * n + 1], sh, bk[2], bk[3]);
          mma(acc[2 * n], sl, bk[0], bk[1]);
          mma(acc[2 * n + 1], sl, bk[2], bk[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  bf16* dqp = dq + qoff;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= P.Sq) continue;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const long long at = rows[r] * P.q.s + n * 8 + 2 * t;
      dqp[at] = __float2bfloat16(acc[n][2 * r] * P.scale);
      dqp[at + 1] = __float2bfloat16(acc[n][2 * r + 1] * P.scale);
    }
  }
}

}  // namespace tc

// `kern` on `stream`, its dynamic shared memory raised to `bytes`
template <typename Kernel, typename... Args>
int launch_kernel(Kernel kern, dim3 grid, size_t bytes, cudaStream_t stream,
                  Args... args) {
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, kThreads, bytes, stream>>>(args...);
  return (int)cudaGetLastError();
}

// D, then dK/dV, then dQ: FP32 FMAs for float32, the tensor cores for
// bfloat16
template <int HD>
int launch_hd(int dtype, const void* q, const void* k, const void* v,
              const void* o, const void* dO, void* dq, void* dk, void* dv,
              int B, const Problem& P, int vec, cudaStream_t stream) {
  if (dtype == 0) {
    using Tl = Tile<HD>;
    const auto q_ = static_cast<const float*>(q);
    const auto k_ = static_cast<const float*>(k);
    const auto v_ = static_cast<const float*>(v);
    const auto dO_ = static_cast<const float*>(dO);
    int rc = launch_kernel(flash_bwd_dot,
                           dim3((P.Sq + 3) / 4, P.H, B), 0, stream,
                           static_cast<const float*>(o), dO_, HD, P);
    if (!rc)
      rc = launch_kernel(flash_bwd_dkdv<HD>,
                         dim3((P.Sk + Tl::BK - 1) / Tl::BK, P.H / P.group, B),
                         Tl::kSmem, stream, q_, k_, v_, dO_,
                         static_cast<float*>(dk), static_cast<float*>(dv), P);
    if (!rc)
      rc = launch_kernel(flash_bwd_dq<HD>,
                         dim3((P.Sq + Tl::BQ - 1) / Tl::BQ, P.H, B),
                         Tl::kSmem, stream, q_, k_, v_, dO_,
                         static_cast<float*>(dq), P);
    return rc;
  }
  using KC = tc::KvShape<HD>;
  using QC = tc::QShape<HD>;
  const auto q_ = static_cast<const tc::bf16*>(q);
  const auto k_ = static_cast<const tc::bf16*>(k);
  const auto v_ = static_cast<const tc::bf16*>(v);
  const auto dO_ = static_cast<const tc::bf16*>(dO);
  const bool cap = P.cap > 0.0f;
  constexpr int dot_rows = kThreads / tc::dot_threads(HD);
  int rc = launch_kernel(tc::flash_bwd_dot_vec<HD>,
                         dim3((P.Sq + dot_rows - 1) / dot_rows, P.H, B), 0,
                         stream, static_cast<const tc::bf16*>(o), dO_, P, vec);
  // key tiles (z) slowest: the first, with the most visible query rows
  // under the causal mask, go out first
  if (!rc)
    rc = launch_kernel(cap ? tc::flash_bwd_dkdv_mma<KC, true>
                           : tc::flash_bwd_dkdv_mma<KC, false>,
                       dim3(P.H / P.group, B, (P.Sk + KC::BK - 1) / KC::BK),
                       KC::kSmem, stream, q_, k_, v_, dO_,
                       static_cast<tc::bf16*>(dk), static_cast<tc::bf16*>(dv),
                       P, vec);
  if (!rc)
    rc = launch_kernel(cap ? tc::flash_bwd_dq_mma<QC, true>
                           : tc::flash_bwd_dq_mma<QC, false>,
                       dim3(P.H, B, (P.Sq + QC::BQ - 1) / QC::BQ), QC::kSmem,
                       stream, q_, k_, v_, dO_, static_cast<tc::bf16*>(dq), P,
                       vec);
  return rc;
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
  // bf16 rows of q, o, dO, k and v all start on 16 bytes: 16-byte loads
  // and cp.async chunks
  const int vec = ((uintptr_t)q | (uintptr_t)o | (uintptr_t)dO |
                   (uintptr_t)k | (uintptr_t)v) % 16 == 0 &&
                  (qb | qh | qs | kb | kh | ks) % 8 == 0;
  switch (hd) {
    case 16: return launch_hd<16>(dtype, q, k, v, o, dO, dq, dk, dv, B, P, vec, stream);
    case 32: return launch_hd<32>(dtype, q, k, v, o, dO, dq, dk, dv, B, P, vec, stream);
    case 64: return launch_hd<64>(dtype, q, k, v, o, dO, dq, dk, dv, B, P, vec, stream);
    case 80: return launch_hd<80>(dtype, q, k, v, o, dO, dq, dk, dv, B, P, vec, stream);
    case 128: return launch_hd<128>(dtype, q, k, v, o, dO, dq, dk, dv, B, P, vec, stream);
    case 256: return launch_hd<256>(dtype, q, k, v, o, dO, dq, dk, dv, B, P, vec, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
