// flash attention: online-softmax attention with GQA, causal mask, sliding
// window, logit softcap and kv_len masking; float32 or bfloat16 in, float32
// accumulation, output in the input's dtype.
//
// Replaces src/repro/kernels/flash_attention.py:flash_attention (Pallas body
// _flash_kernel), and with it the JAX models' blockwise_attention, which
// computes the same function.  Bound on the card: at the model's prefill
// shapes (S 256..1536, head_dim 64..80) the work is 4·S²·H·hd/2 operations
// on 4·S·H·hd·2 bytes, far above the H100's bytes-to-operations balance, so
// it is bounded by operations: the bf16 path runs both products on the
// tensor cores (989 TFLOP/s bf16), the float32 path as FP32 FMAs on the CUDA
// cores (67 TFLOP/s; TF32 would not hold its 3e-4 tolerance).
//
// Both paths: one block of 128 threads per (batch, head, tile of query
// rows), looping over tiles of keys; the TPU kernel carried the accumulators
// across sequential grid steps in VMEM, here the key loop lives inside the
// block.  The kv head is h / (H / KV).  q/k/v/o are addressed through
// (batch, head, sequence) strides with a contiguous head dim, so the model's
// (B, S, H, hd) layout needs no transposed copy.
//
// - bfloat16 (the models' path), the FlashAttention-2 shape: 64 query rows
//   a block, 16 a warp.  Q, K and V stay bf16 in shared memory, in rows
//   padded to hd + 8 elements (an odd number of 16-byte chunks, so the eight
//   rows an ldmatrix reads fall in eight different bank groups).  K/V tiles
//   come through a cp.async ring of three stages (two above hd 80): the
//   next two tiles load while one is multiplied, one barrier a tile.  Q's
//   fragments are read once from global memory straight into registers, so
//   Q takes no shared memory (at hd 256, where the output accumulators alone
//   take 128 registers, Q stays in shared memory).  S = Q·Kᵀ is
//   mma.sync m16n8k16 bf16 into float32 registers; scale, softcap (a
//   template parameter, so the common path computes no tanh) and masks
//   (only on tiles where a key may be masked) are applied there, and each
//   row's max and sum are reduced across the 4 threads that hold it with
//   shuffles, so scores never touch shared memory; the softmax is taken in
//   base 2 (ex2.approx).  The S accumulators are the A fragments of P·V (V
//   through ldmatrix.trans).  P stays float32-accurate: the TPU kernel
//   multiplies P·V in float32, and one bf16 rounding of P (8 bits) would
//   leave rows where V cancels outside one bf16 step of the result, so P is
//   split into hi = bf16(P) and lo = bf16(P - hi) and both products are
//   issued (P to ~16 bits, for 1.5x the tensor work of one bf16 P).
// - float32: the score tile through shared memory, FP32 FMAs, each thread an
//   (RQ x CK) piece of the scores and an (RQ x HD/16) piece of the output.
//
// Masking follows the TPU kernel exactly: a masked score is NEG_INF = -2^30
// (not -inf), so a row whose every key is masked averages V over the Sk keys
// (as the dense reference does), and the final divide is by max(l, 1e-30).
// Keys past Sk (the ragged last tile) are excluded outright.  When every
// query row of the tile has at least one key it may attend to, key tiles
// that are masked for every row (above the causal diagonal, before the
// window, past kv_len) add exactly 0 after the rescale and are skipped;
// heavier causal tiles are scheduled first.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_mma.cuh"

namespace {

constexpr float kNegInf = -1073741824.0f;  // -2^30, the TPU kernel's NEG_INF

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }

struct Strides {
  long long b, h, s;
};

struct Problem {
  int H, group, Sq, Sk;
  Strides q, k, v, o;
  float scale, cap;
  int causal, window, kv_len;
  // optional (B, H, Sq) float32 output: each row's log-sum-exp of its
  // scaled (and capped, masked) scores, natural log; null when not wanted
  float* lse;
};

// The keys [k_begin, k_end) a tile of `rows` query rows from q0 must visit.
// When every row of the tile has at least one key it may attend to, tiles
// masked for every row add exactly 0 after the rescale and are skipped;
// otherwise (a fully masked row averages V over every key) all Sk keys are
// visited.  Called by every thread of the block: it is a barrier.
__device__ __forceinline__ void key_range(const Problem& P, int q0, int rows,
                                          int& k_begin, int& k_end) {
  const int kv_end = P.kv_len < P.Sk ? P.kv_len : P.Sk;
  const int row = q0 + (int)threadIdx.x;
  bool has_key = true;
  if ((int)threadIdx.x < rows && row < P.Sq) {
    int hi = kv_end - 1;
    if (P.causal && row < hi) hi = row;
    int lo = row - P.window + 1;
    if (lo < 0) lo = 0;
    has_key = lo <= hi;
  }
  k_begin = 0;
  k_end = P.Sk;
  if (__syncthreads_and(has_key)) {
    int last = (q0 + rows < P.Sq ? q0 + rows : P.Sq) - 1;
    k_end = kv_end;
    if (P.causal && last + 1 < k_end) k_end = last + 1;
    k_begin = q0 - P.window + 1;
    if (k_begin < 0) k_begin = 0;
  }
}

// ---- float32: CUDA cores ---------------------------------------------------

// query rows = key rows per tile
template <int HD>
struct Tile {
  static constexpr int kRows = HD > 128 ? 32 : 64;
};

template <int HD>
constexpr size_t smem_bytes() {
  constexpr int BQ = Tile<HD>::kRows;
  return sizeof(float) *
         (size_t)(3 * BQ * (HD + 1) + BQ * (BQ + 1) + 3 * BQ);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, Problem P) {
  constexpr int BQ = Tile<HD>::kRows;
  constexpr int BK = BQ;
  constexpr int LD = HD + 1;          // padded row of Q/K/V in shared memory
  constexpr int LP = BK + 1;          // padded row of the score tile
  constexpr int RQ = BQ / 8;          // query rows per thread (8 row groups)
  constexpr int CK = BK / 16;         // score columns per thread
  constexpr int CD = HD / 16;         // output columns per thread
  constexpr int TPR = kThreads / BQ;  // threads per row in the softmax
  constexpr int CPT = BK / TPR;       // score columns per such thread
  static_assert(HD % 16 == 0, "head_dim must be a multiple of 16");

  extern __shared__ float smem[];
  float* Qs = smem;                   // BQ x LD
  float* Ks = Qs + BQ * LD;           // BK x LD
  float* Vs = Ks + BK * LD;           // BK x LD
  float* Ps = Vs + BK * LD;           // BQ x LP scores, then probabilities
  float* m_s = Ps + BQ * LP;          // running max of each row
  float* l_s = m_s + BQ;              // running sum of each row
  float* c_s = l_s + BQ;              // this step's rescale of each row

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int nq = (P.Sq + BQ - 1) / BQ;
  const int q0 = (nq - 1 - (int)blockIdx.x) * BQ;  // longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / P.group;
  const T* qp = q + b * P.q.b + h * P.q.h;
  const T* kp = k + b * P.k.b + kvh * P.k.h;
  const T* vp = v + b * P.v.b + kvh * P.v.h;
  T* op = o + b * P.o.b + h * P.o.h;

  for (int i = tid; i < BQ * HD; i += kThreads) {
    int r = i / HD, d = i % HD, row = q0 + r;
    Qs[r * LD + d] = row < P.Sq ? to_f32(qp[row * P.q.s + d]) : 0.0f;
  }
  if (tid < BQ) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.0f;
  }
  int k_begin, k_end;
  key_range(P, q0, BQ, k_begin, k_end);  // also the barrier after the stores

  float acc[RQ][CD];
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int j = 0; j < CD; ++j) acc[i][j] = 0.0f;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();  // the last step's readers of Ks / Vs / Ps are done
    for (int i = tid; i < BK * HD; i += kThreads) {
      int r = i / HD, d = i % HD, key = k0 + r;
      bool in = key < P.Sk;
      Ks[r * LD + d] = in ? to_f32(kp[key * P.k.s + d]) : 0.0f;
      Vs[r * LD + d] = in ? to_f32(vp[key * P.v.s + d]) : 0.0f;
    }
    __syncthreads();

    // scores: rows ty*RQ + i, columns tx + 16*j
    float s[RQ][CK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < CK; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[RQ], kv[CK];
#pragma unroll
      for (int i = 0; i < RQ; ++i) qv[i] = Qs[(ty * RQ + i) * LD + d];
#pragma unroll
      for (int j = 0; j < CK; ++j) kv[j] = Ks[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < CK; ++j) s[i][j] += qv[i] * kv[j];
    }
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      int qi = q0 + ty * RQ + i;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        int kj = k0 + tx + 16 * j;
        float val = s[i][j] * P.scale;
        if (P.cap > 0.0f) val = P.cap * tanhf(val / P.cap);
        bool ok = kj < P.kv_len && kj > qi - P.window;
        if (P.causal) ok = ok && kj <= qi;
        val = ok ? val : kNegInf;
        if (kj >= P.Sk) val = -INFINITY;  // past the keys: weight exactly 0
        Ps[(ty * RQ + i) * LP + tx + 16 * j] = val;
      }
    }
    __syncthreads();

    // online softmax: TPR threads per row, CPT columns each
    {
      const int r = tid / TPR, part = tid % TPR;
      float* row = Ps + r * LP + part * CPT;
      float mx = kNegInf;
#pragma unroll 8
      for (int c = 0; c < CPT; ++c) mx = fmaxf(mx, row[c]);
#pragma unroll
      for (int off = 1; off < TPR; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.0f;
#pragma unroll 8
      for (int c = 0; c < CPT; ++c) {
        float p = expf(row[c] - m_new);
        row[c] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 1; off < TPR; off <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (part == 0) {
        const float corr = expf(m_prev - m_new);
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
        c_s[r] = corr;
      }
    }
    __syncthreads();

    // acc = acc * corr + P V
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      float corr = c_s[ty * RQ + i];
#pragma unroll
      for (int j = 0; j < CD; ++j) acc[i][j] *= corr;
    }
    const int nk = P.Sk - k0 < BK ? P.Sk - k0 : BK;
#pragma unroll 4
    for (int kk = 0; kk < nk; ++kk) {
      float pv[RQ], vv[CD];
#pragma unroll
      for (int i = 0; i < RQ; ++i) pv[i] = Ps[(ty * RQ + i) * LP + kk];
#pragma unroll
      for (int j = 0; j < CD; ++j) vv[j] = Vs[kk * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < CD; ++j) acc[i][j] += pv[i] * vv[j];
    }
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    int r = ty * RQ + i, row = q0 + r;
    if (row >= P.Sq) continue;
    float denom = fmaxf(l_s[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < CD; ++j)
      store(op + row * P.o.s + tx + 16 * j, acc[i][j] / denom);
    if (P.lse != nullptr && tx == 0)
      P.lse[((long long)b * P.H + h) * P.Sq + row] = m_s[r] + logf(denom);
  }
}

// ---- bfloat16: tensor cores (the pieces in flash_mma.cuh) -------------------

namespace tc {

// 4 warps of 16 query rows; BK keys a tile; STAGES K/V tiles in the
// cp.async ring; rows padded to LD elements; MIN_BLOCKS resident on an SM
// (caps the registers)
template <int HD_, int BK_, int STAGES_, int MIN_BLOCKS_>
struct Shape {
  static constexpr int HD = HD_, BK = BK_, STAGES = STAGES_;
  static constexpr int kMinBlocks = MIN_BLOCKS_;
  static constexpr int BQ = 16 * kThreads / 32;  // query rows a block
  static constexpr int LD = HD + 8;
  // Q's fragments in registers, read straight from global memory; at hd
  // 256 (the accumulators alone take 128 registers) Q stays in shared
  // memory and is re-read for each tile
  static constexpr bool kQInRegs = HD <= 128;
  static constexpr size_t kSmem =
      sizeof(bf16) * (size_t)((kQInRegs ? 0 : BQ * LD) + 2 * STAGES * BK * LD);
};

// At head_dim <= 80: 64-key tiles, 3 stages, 2 blocks an SM (at most 255
// registers: at 3 blocks an SM, 170, the kernel spills and is slower);
// chip_kernel_shapes.py times the alternatives.  At 256, 16-key tiles keep
// the scores few enough that the 128 accumulators do not spill.
template <int HD>
using Cfg = Shape<HD, (HD > 128 ? 16 : 64), (HD <= 80 ? 3 : 2),
                  (HD <= 80 ? 2 : 1)>;


// kCap: a softcap is applied (the launch chooses, by P.cap > 0)
template <class Cf, bool kCap>
__global__ void __launch_bounds__(kThreads, Cf::kMinBlocks)
    flash_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     Problem P, int vec) {
  constexpr int HD = Cf::HD;
  constexpr int BQ = Cf::BQ, BK = Cf::BK, LD = Cf::LD;
  constexpr int STAGES = Cf::STAGES;
  constexpr int KS = HD / 16;  // depth steps of Q.K^T
  constexpr int NS = BK / 8;   // 8-key column tiles of S
  constexpr int ND = HD / 8;   // 8-wide column tiles of the output
  static_assert(HD % 16 == 0 && ND % 2 == 0 && NS % 2 == 0, "tile shapes");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // BQ x LD, at hd 256
  bf16* Ks = Qs + (Cf::kQInRegs ? 0 : BQ * LD);  // STAGES x BK x LD
  bf16* Vs = Ks + STAGES * BK * LD;             // STAGES x BK x LD

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;  // fragment row group, column pair
  const int nq = (P.Sq + BQ - 1) / BQ;
  const int q0 = (nq - 1 - (int)blockIdx.x) * BQ;  // longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / P.group;
  const bf16* qp = q + b * P.q.b + h * P.q.h;
  const bf16* kp = k + b * P.k.b + kvh * P.k.h;
  const bf16* vp = v + b * P.v.b + kvh * P.v.h;
  bf16* op = o + b * P.o.b + h * P.o.h;

  int k_begin, k_end;
  key_range(P, q0, BQ, k_begin, k_end);
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;

  // this thread's rows: g and g + 8 of the warp's 16 from warp_q0
  const int warp_q0 = q0 + warp * 16;
  const int rows[2] = {warp_q0 + g, warp_q0 + g + 8};
  // Q's A fragments: rows (g, g + 8), columns 16 ks + 2t (+ 8), pairs
  uint32_t qf[Cf::kQInRegs ? KS : 1][4];
  if constexpr (Cf::kQInRegs) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = rows[e % 2];
        qf[ks][e] = row < P.Sq ? ld_pair(qp + row * P.q.s + ks * 16 + 2 * t +
                                             8 * (e / 2), vec)
                               : 0u;
      }
  }

  // the ring: Q (at hd 256) with tile 0, then tiles 1 .. STAGES - 2, a
  // group each
  if constexpr (!Cf::kQInRegs)
    Chunks<Cf, BQ>().load(Qs, qp, P.q.s, q0, P.Sq, vec);
  const Chunks<Cf, BK> tile;
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < n_tiles) {
      tile.load(Ks + i * BK * LD, kp, P.k.s, k_begin + i * BK, P.Sk, vec);
      tile.load(Vs + i * BK * LD, vp, P.v.s, k_begin + i * BK, P.Sk, vec);
    }
    cp_async_commit();
  }

  // scores in base-2 units: scale (or the softcap) times log2(e)
  constexpr float kLog2e = 1.4426950408889634f;
  const float scale2 = P.scale * kLog2e;
  const float cap2 = P.cap * kLog2e, inv_cap = P.scale / P.cap;
  float m_r[2] = {kNegInf, kNegInf};  // running max of each row
  float l_r[2] = {0.0f, 0.0f};        // this thread's part of its row sums
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  // ldmatrix addresses of this lane: A (Q) rows lane % 16, columns
  // (lane / 16) * 8; B (K) keys (lane / 16) * 8 + lane % 8, columns
  // ((lane / 8) % 2) * 8; B (V, transposed) keys lane % 16, columns
  // (lane / 16) * 8
  const bf16* q_lane = Qs + (warp * 16 + lane % 16) * LD + (lane / 16) * 8;
  const int k_lane = ((lane / 16) * 8 + lane % 8) * LD + ((lane / 8) % 2) * 8;
  const int v_lane = (lane % 16) * LD + (lane / 16) * 8;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = k_begin + it * BK;
    cp_async_wait<STAGES - 2>();  // tile it has landed
    __syncthreads();              // ... for every thread; tile it - 1 is free
    {
      const int nxt = it + STAGES - 1, st = nxt % STAGES;
      if (nxt < n_tiles) {
        tile.load(Ks + st * BK * LD, kp, P.k.s, k_begin + nxt * BK, P.Sk, vec);
        tile.load(Vs + st * BK * LD, vp, P.v.s, k_begin + nxt * BK, P.Sk, vec);
      }
      cp_async_commit();
    }
    const bf16* Kt = Ks + (it % STAGES) * BK * LD;
    const bf16* Vt = Vs + (it % STAGES) * BK * LD;

    // S = Q K^T: rows (g, g + 8), keys 8j + 2t + {0, 1}
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t a[4];
      if constexpr (Cf::kQInRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qf[ks][e];
      } else {
        ldmatrix_x4(a, q_lane + ks * 16);
      }
#pragma unroll
      for (int j = 0; j < NS / 2; ++j) {
        uint32_t bk[4];
        ldmatrix_x4(bk, Kt + j * 16 * LD + k_lane + ks * 16);
        mma(s[2 * j], a, bk[0], bk[1]);
        mma(s[2 * j + 1], a, bk[2], bk[3]);
      }
    }

    // scale and softcap, in base-2 units (the softmax is taken with exp2)
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[j][e] = kCap ? cap2 * tanhf(s[j][e] * inv_cap) : s[j][e] * scale2;
    // the masks, only where this warp's rows may meet a masked key
    if (k0 + BK > P.Sk || k0 + BK > P.kv_len ||
        (P.causal && k0 + BK - 1 > warp_q0) ||
        k0 <= warp_q0 + 15 - P.window) {
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = rows[e / 2], kj = k0 + j * 8 + 2 * t + (e & 1);
          bool ok = kj < P.kv_len && kj > qi - P.window;
          if (P.causal) ok = ok && kj <= qi;
          float val = ok ? s[j][e] : kNegInf;
          if (kj >= P.Sk) val = -INFINITY;  // past the keys: weight 0
          s[j][e] = val;
        }
    }
    // the online softmax in registers: each row's max across its quad
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e / 2] = fmaxf(mx[e / 2], s[j][e]);
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = exp2_approx(m_r[r] - mx[r]);
      m_r[r] = mx[r];
      l_r[r] *= corr[r];
    }
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2_approx(s[j][e] - m_r[e / 2]);
        l_r[e / 2] += s[j][e];
      }

    // acc += P V, with P as hi + lo bf16 halves
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t ph[4], pl[4];
      split(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      split(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      split(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      split(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int n = 0; n < ND / 2; ++n) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, Vt + kk * 16 * LD + v_lane + n * 16);
        mma(acc[2 * n], ph, bv[0], bv[1]);
        mma(acc[2 * n + 1], ph, bv[2], bv[3]);
        mma(acc[2 * n], pl, bv[0], bv[1]);
        mma(acc[2 * n + 1], pl, bv[2], bv[3]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_r[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    if (rows[r] >= P.Sq) continue;
    const float denom = fmaxf(l, 1e-30f);
    // m and the scores are in base-2 units: lse = ln 2 * (m + log2 l)
    if (P.lse != nullptr && t == 0)
      P.lse[((long long)b * P.H + h) * P.Sq + rows[r]] =
          0.69314718055994531f * (m_r[r] + log2f(denom));
    bf16* orow = op + rows[r] * P.o.s + 2 * t;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      orow[n * 8] = __float2bfloat16(acc[n][2 * r] / denom);
      orow[n * 8 + 1] = __float2bfloat16(acc[n][2 * r + 1] / denom);
    }
  }
}

}  // namespace tc

template <int HD>
int launch_hd(int dtype, const void* q, const void* k, const void* v,
              void* o, int B, const Problem& P, int vec,
              cudaStream_t stream) {
  cudaError_t err;
  if (dtype == 0) {
    constexpr int BQ = Tile<HD>::kRows;
    constexpr size_t bytes = smem_bytes<HD>();
    auto kern = flash_kernel<float, HD>;
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((P.Sq + BQ - 1) / BQ, P.H, B);
    kern<<<grid, kThreads, bytes, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), P);
  } else {
    using Cf = tc::Cfg<HD>;
    constexpr size_t bytes = Cf::kSmem;
    auto kern = P.cap > 0.0f ? tc::flash_mma_kernel<Cf, true>
                             : tc::flash_mma_kernel<Cf, false>;
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((P.Sq + Cf::BQ - 1) / Cf::BQ, P.H, B);
    kern<<<grid, kThreads, bytes, stream>>>(
        static_cast<const tc::bf16*>(q), static_cast<const tc::bf16*>(k),
        static_cast<const tc::bf16*>(v), static_cast<tc::bf16*>(o), P, vec);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  Strides are in elements.  window: keys
// k > q - window are kept (pass 2^30 for none).  lse: null, or a contiguous
// (B, H, Sq) float32 output of each row's log-sum-exp (the backward's input).
extern "C" int flash_attention_fwd_lse(
    const void* q, const void* k, const void* v, void* o, float* lse,
    int dtype, int B, int H, int KV, int Sq, int Sk, int hd, long long qb,
    long long qh, long long qs, long long kb, long long kh, long long ks,
    long long vb, long long vh, long long vs, long long ob, long long oh,
    long long os, float scale, float cap, int causal, int window, int kv_len,
    int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || H <= 0 || Sq <= 0) return 0;
  if (KV <= 0 || H % KV || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  Problem P;
  P.H = H;
  P.group = H / KV;
  P.Sq = Sq;
  P.Sk = Sk;
  P.q = {qb, qh, qs};
  P.k = {kb, kh, ks};
  P.v = {vb, vh, vs};
  P.o = {ob, oh, os};
  P.scale = scale;
  P.cap = cap;
  P.causal = causal;
  P.window = window;
  P.kv_len = kv_len;
  P.lse = lse;
  // bf16 rows of q, k and v all start on 16 bytes: cp.async chunks
  const int vec =
      ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16 == 0 &&
      (qb | qh | qs | kb | kh | ks | vb | vh | vs) % 8 == 0;
  switch (hd) {
    case 16: return launch_hd<16>(dtype, q, k, v, o, B, P, vec, stream);
    case 32: return launch_hd<32>(dtype, q, k, v, o, B, P, vec, stream);
    case 64: return launch_hd<64>(dtype, q, k, v, o, B, P, vec, stream);
    case 80: return launch_hd<80>(dtype, q, k, v, o, B, P, vec, stream);
    case 128: return launch_hd<128>(dtype, q, k, v, o, B, P, vec, stream);
    case 256: return launch_hd<256>(dtype, q, k, v, o, B, P, vec, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The forward without the log-sum-exp (serving).
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int H, int KV, int Sq, int Sk, int hd, long long qb, long long qh,
    long long qs, long long kb, long long kh, long long ks, long long vb,
    long long vh, long long vs, long long ob, long long oh, long long os,
    float scale, float cap, int causal, int window, int kv_len, int device,
    cudaStream_t stream) {
  return flash_attention_fwd_lse(q, k, v, o, nullptr, dtype, B, H, KV, Sq,
                                 Sk, hd, qb, qh, qs, kb, kh, ks, vb, vh, vs,
                                 ob, oh, os, scale, cap, causal, window,
                                 kv_len, device, stream);
}
