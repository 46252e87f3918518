// flash attention: online-softmax attention with GQA, causal mask, sliding
// window, logit softcap and kv_len masking; float32 or bfloat16 in, float32
// accumulation, output in the input's dtype.
//
// Replaces src/repro/kernels/flash_attention.py:flash_attention (Pallas body
// _flash_kernel), and with it the JAX models' blockwise_attention, which
// computes the same function.  Bound on the card: at the model's prefill
// shapes (S 256..1536, head_dim 80) the work is 4·S²·H·hd/2 operations on
// 4·S·H·hd·2 bytes, far above the H100's bytes-to-operations balance, so it
// is bounded by operations; this kernel does them as FP32 FMAs on the CUDA
// cores (67 TFLOP/s peak), not on the tensor cores (989 TFLOP/s bf16): a
// first, simple version, with wgmma left to a later change.
//
// Design.  One block of 128 threads per (batch, head, tile of BQ query
// rows); its Q tile stays in shared memory (float32) while it loops over
// tiles of BK keys, staging each K and V tile in shared memory.  Each
// thread computes an (RQ x CK) piece of the score tile, then two or four
// threads per row run the online softmax (running max / sum in shared
// memory, float32), then each thread accumulates an (RQ x HD/16) piece of
// the output in registers.  The TPU kernel carried the accumulators across
// sequential grid steps in VMEM; here the key loop lives inside the block.
// The kv head is h / (H / KV).  q/k/v/o are addressed through (batch, head,
// sequence) strides with a contiguous head dim, so the model's (B, S, H, hd)
// layout needs no transposed copy.
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

namespace {

constexpr float kNegInf = -1073741824.0f;  // -2^30, the TPU kernel's NEG_INF
constexpr int kThreads = 128;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

struct Strides {
  long long b, h, s;
};

struct Problem {
  int H, group, Sq, Sk;
  Strides q, k, v, o;
  float scale, cap;
  int causal, window, kv_len;
};

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
  __shared__ int all_rows_valid;

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
  if (tid == 0) all_rows_valid = 1;
  if (tid < BQ) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.0f;
  }
  __syncthreads();
  const int kv_end = P.kv_len < P.Sk ? P.kv_len : P.Sk;
  if (tid < BQ && q0 + tid < P.Sq) {
    int row = q0 + tid;
    int hi = kv_end - 1;
    if (P.causal && row < hi) hi = row;
    int lo = row - P.window + 1;
    if (lo < 0) lo = 0;
    if (lo > hi) all_rows_valid = 0;  // a row with no key: keep every tile
  }
  __syncthreads();
  int k_begin = 0, k_end = P.Sk;
  if (all_rows_valid) {
    int last = (q0 + BQ < P.Sq ? q0 + BQ : P.Sq) - 1;
    k_end = kv_end;
    if (P.causal && last + 1 < k_end) k_end = last + 1;
    k_begin = q0 - P.window + 1;
    if (k_begin < 0) k_begin = 0;
  }

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
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           const Problem& P, cudaStream_t stream) {
  constexpr int BQ = Tile<HD>::kRows;
  constexpr size_t bytes = smem_bytes<HD>();
  auto kern = flash_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((P.Sq + BQ - 1) / BQ, P.H, B);
  kern<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), P);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int hd, const void* q, const void* k, const void* v, void* o,
             int B, const Problem& P, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, o, B, P, stream);
    case 32: return launch<T, 32>(q, k, v, o, B, P, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, P, stream);
    case 80: return launch<T, 80>(q, k, v, o, B, P, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, P, stream);
    case 256: return launch<T, 256>(q, k, v, o, B, P, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  Strides are in elements.  window: keys
// k > q - window are kept (pass 2^30 for none).
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int H, int KV, int Sq, int Sk, int hd, long long qb, long long qh,
    long long qs, long long kb, long long kh, long long ks, long long vb,
    long long vh, long long vs, long long ob, long long oh, long long os,
    float scale, float cap, int causal, int window, int kv_len, int device,
    cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || H <= 0 || Sq <= 0) return 0;
  if (KV <= 0 || H % KV) return (int)cudaErrorInvalidValue;
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
  if (dtype == 0) return dispatch<float>(hd, q, k, v, o, B, P, stream);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(hd, q, k, v, o, B, P, stream);
  return (int)cudaErrorInvalidValue;
}
