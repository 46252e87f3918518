// Decode attention: one query a slot and head over the layer's cache, read
// in place in its own dtype, split over the cache's rows (flash-decoding).
//
// Replaces no TPU kernel: the JAX engine jits its whole decode step
// (src/repro/runtime/serve.py:83-84) and XLA fuses decode_attention
// (src/repro/models/attention.py:217): the scores' einsum, scale, softcap,
// mask, softmax and the weighted sum.  Eagerly, the port ran ~16 device
// operations a layer and read the cache three times (bf16 once, float32
// copies of K and V blocks twice).  Plain version: kernels/ref.py
// decode_attention_ref.
//
// Masks: row j of a cache of S rows is valid where j <= pos and, when the
// cache is longer than a window W, j > pos - W, exactly as the plain
// version masks it (the valid rows are one range).  Rows outside the range
// are skipped, which is exact: the plain version gives them weight
// exp(-2^30 - m) = 0 in float32.  A position below 0 leaves no valid row;
// the plain version's softmax is then uniform over every row, and so is
// this kernel's.
//
// Design: B * KV is 16-128 at 4 slots, far from 132 SMs, so the rows are
// cut into splits of `rows` rows (enough blocks to fill the card eight
// times over, kernels/decode_step.py split_plan), one block a (split,
// slot, kv head),
// which takes all G query heads of its group.  A block: q of the group
// into shared memory; each thread a row at a time, its G scores over the
// head dim (scale, then softcap, in float32); each warp a head: the
// split's max m and p = exp(s - m) in place, their sum l; then the
// weighted sum of V rows by (row group, columns) threads, 8 columns a
// load where G <= 4, 4 where G <= 8, 2 otherwise (so that the G x columns
// sums stay in registers), rows unrolled by 4 so that loads overlap,
// summed over the row groups in a fixed order.  A second kernel merges the
// splits in order: o = sum_s exp(m_s - M) o_s / sum_s exp(m_s - M) l_s.
// No atomics: a replay is deterministic.  With one split the first kernel
// writes o itself, the merge's arithmetic at one split (o_s / l_s).
//
// Bound on the card: bytes (the valid rows of K and V read once, q read
// and o written), ~4 operations an element of K and V per query head of
// the group.
#include "decode_step.cuh"

namespace {

constexpr int kAttnThreads = 128;
constexpr int kAttnWarps = kAttnThreads / 32;
constexpr int kMaxG = 16;        // query heads a kv head
constexpr int kMaxRows = 256;    // rows a split
constexpr int kMaxHd = 256;      // head dim (even)

// kCols neighbouring elements of a row as float32: 8 or 4 (the row
// 16-byte aligned) or 2
template <int kCols>
__device__ __forceinline__ void load_cols(const float* p, float* out) {
  if constexpr (kCols == 8) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
    out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
  } else if constexpr (kCols == 4) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  } else {
    const float2 a = *reinterpret_cast<const float2*>(p);
    out[0] = a.x; out[1] = a.y;
  }
}
template <int kCols>
__device__ __forceinline__ void load_cols(const bf16* p, float* out) {
  if constexpr (kCols == 8) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {  // element 2k in the low half
      out[2 * k] = __uint_as_float(w[k] << 16);
      out[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  } else if constexpr (kCols == 4) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    out[0] = __uint_as_float(raw.x << 16);
    out[1] = __uint_as_float(raw.x & 0xffff0000u);
    out[2] = __uint_as_float(raw.y << 16);
    out[3] = __uint_as_float(raw.y & 0xffff0000u);
  } else {
    const float2 a =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    out[0] = a.x; out[1] = a.y;
  }
}

struct Range {
  int lo, hi;      // valid rows lo..hi (inclusive)
  bool uniform;    // no valid row: every row, weight 1
};

__device__ __forceinline__ Range valid_rows(long long pos, int S,
                                            int window) {
  long long lo = 0, hi = pos < S - 1 ? pos : S - 1;
  if (window > 0) {
    const long long w_lo = pos - window + 1;
    if (w_lo > lo) lo = w_lo;
  }
  if (hi < lo) return Range{0, S - 1, true};
  return Range{(int)lo, (int)hi, false};
}

// Columns a thread loads at once, so that the G x columns sums stay in
// registers: 8 with at most 4 query heads a kv head, 4 with at most 8,
// else 2.
template <int kG>
__host__ __device__ constexpr int cols_of() {
  return kG <= 4 ? 8 : kG <= 8 ? 4 : 2;
}

// The floats of a split block's shared memory: q (G x hd), the scores (G x
// rows) whose space then takes the row groups' sums (G x 128 x columns),
// and each head's max and sum.
template <int kG>
int split_smem_floats(int G, int hd, int rows) {
  const int sums = kAttnThreads * cols_of<kG>();
  return G * hd + G * (rows > sums ? rows : sums) + 2 * G;
}

template <typename T, typename C, int kG>
__global__ void __launch_bounds__(kAttnThreads)
    attn_split(const T* __restrict__ q, const C* __restrict__ k_cache,
               const C* __restrict__ v_cache, T* __restrict__ o,
               float* __restrict__ part_o, float* __restrict__ part_ml,
               const long long* __restrict__ pos_ptr, long long pos_arg,
               int B, int KV, int G, int S, int hd, int rows, int window,
               float scale, float cap) {
  constexpr int kCols = cols_of<kG>();
  extern __shared__ float smem[];
  const int split = blockIdx.x, bk = blockIdx.y;
  const int b = bk / KV, kvh = bk % KV;
  const int H = KV * G, BH = B * H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int sums = kAttnThreads * kCols;
  float* qs = smem;                                // G x hd
  float* sc = smem + G * hd;                       // G x rows, then sums
  float* ml = sc + G * (rows > sums ? rows : sums);
  const Range range = valid_rows(position(pos_ptr, pos_arg), S, window);
  const int a = max(split * rows, range.lo);
  const int e = min(split * rows + rows - 1, range.hi);
  const int n = e - a + 1;
  const int head0 = kvh * G;
  if (n <= 0) {  // no valid row here: the merge skips the split (l = 0)
    for (int g = threadIdx.x; g < G; g += kAttnThreads) {
      float* out = part_ml + ((long long)split * BH + b * H + head0 + g) * 2;
      out[0] = -INFINITY;
      out[1] = 0.0f;
    }
    return;
  }
  const T* qg = q + ((long long)b * H + head0) * hd;
  for (int i = threadIdx.x; i < G * hd; i += kAttnThreads)
    qs[i] = to_f32(qg[i]);
  __syncthreads();

  // the scores: one row a thread, its G dots over the head dim
  const long long row_stride = (long long)KV * hd;
  const C* kbase = k_cache + ((long long)b * S * KV + kvh) * hd;
  for (int r = threadIdx.x; r < n; r += kAttnThreads) {
    float dots[kG];
#pragma unroll
    for (int g = 0; g < kG; ++g) dots[g] = 0.0f;
    if (!range.uniform) {
      const C* kr = kbase + (long long)(a + r) * row_stride;
#pragma unroll 4
      for (int c = 0; c < hd; c += kCols) {
        float kv[kCols];
        load_cols<kCols>(kr + c, kv);
#pragma unroll
        for (int g = 0; g < kG; ++g)
          if (g < G) {
#pragma unroll
            for (int j = 0; j < kCols; ++j)
              dots[g] += qs[g * hd + c + j] * kv[j];
          }
      }
    }
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      if (g < G) {
        float s = 0.0f;
        if (!range.uniform) {
          s = __fmul_rn(dots[g], scale);
          if (cap > 0.0f) s = __fmul_rn(cap, tanhf(__fdiv_rn(s, cap)));
        }
        sc[g * rows + r] = s;
      }
    }
  }
  __syncthreads();

  // each warp a head: the split's max, the weights in place, their sum
  for (int g = warp; g < G; g += kAttnWarps) {
    float* s = sc + g * rows;
    float m = -INFINITY;
    for (int r = lane; r < n; r += 32) m = fmaxf(m, s[r]);
    m = warp_max(m);
    float l = 0.0f;
    for (int r = lane; r < n; r += 32) {
      const float p = expf(__fsub_rn(s[r], m));
      s[r] = p;
      l += p;
    }
    l = warp_sum(l);
    if (lane == 0) {
      ml[g] = m;
      ml[G + g] = l;
    }
  }
  __syncthreads();

  // the weighted sum of V: (row group, kCols columns) threads
  const int cols = hd / kCols;
  const int groups = kAttnThreads / cols;
  const int grp = threadIdx.x / cols, cc = (threadIdx.x % cols) * kCols;
  float acc[kG][kCols];
#pragma unroll
  for (int g = 0; g < kG; ++g)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[g][j] = 0.0f;
  const C* vbase = v_cache + ((long long)b * S * KV + kvh) * hd + cc;
  if (grp < groups) {
#pragma unroll 4
    for (int r = grp; r < n; r += groups) {
      float vv[kCols];
      load_cols<kCols>(vbase + (long long)(a + r) * row_stride, vv);
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        if (g < G) {
          const float w = sc[g * rows + r];
#pragma unroll
          for (int j = 0; j < kCols; ++j) acc[g][j] += w * vv[j];
        }
      }
    }
  }
  __syncthreads();  // the weights are read: their space takes the sums
  float* red = sc;  // groups x G x hd
  if (grp < groups) {
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      if (g < G) {
#pragma unroll
        for (int j = 0; j < kCols; ++j)
          red[(grp * G + g) * hd + cc + j] = acc[g][j];
      }
    }
  }
  __syncthreads();
  const bool single = gridDim.x == 1;
  for (int i = threadIdx.x; i < G * hd; i += kAttnThreads) {
    const int g = i / hd, col = i % hd;
    float sum = 0.0f;
    for (int j = 0; j < groups; ++j) sum += red[(j * G + g) * hd + col];
    const long long bh = (long long)b * H + head0 + g;
    if (single)
      o[bh * hd + col] = from_f32<T>(__fdiv_rn(sum, ml[G + g]));
    else
      part_o[((long long)split * BH + bh) * hd + col] = sum;
  }
  if (!single) {
    for (int g = threadIdx.x; g < G; g += kAttnThreads) {
      float* out = part_ml + ((long long)split * BH + b * H + head0 + g) * 2;
      out[0] = ml[g];
      out[1] = ml[G + g];
    }
  }
}

// The splits of each (slot, head) merged in order: one block a (slot,
// head), one thread a column.
template <typename T>
__global__ void __launch_bounds__(kMaxHd)
    attn_merge(const float* __restrict__ part_o,
               const float* __restrict__ part_ml, T* __restrict__ o,
               int BH, int hd, int splits) {
  const long long bh = blockIdx.x;
  const int col = threadIdx.x;
  if (col >= hd) return;
  float M = -INFINITY;
  for (int s = 0; s < splits; ++s) {
    const float* ml = part_ml + ((long long)s * BH + bh) * 2;
    if (ml[1] > 0.0f) M = fmaxf(M, ml[0]);
  }
  float num = 0.0f, den = 0.0f;
  for (int s = 0; s < splits; ++s) {
    const float* ml = part_ml + ((long long)s * BH + bh) * 2;
    if (ml[1] > 0.0f) {
      const float w = expf(__fsub_rn(ml[0], M));
      den = __fadd_rn(den, __fmul_rn(w, ml[1]));
      num = __fadd_rn(num, __fmul_rn(w, part_o[((long long)s * BH + bh) * hd
                                                + col]));
    }
  }
  o[bh * hd + col] = from_f32<T>(__fdiv_rn(num, den));
}

template <typename T, typename C, int kG>
int launch(const void* q, const void* k_cache, const void* v_cache, void* o,
           float* part_o, float* part_ml, const long long* pos_ptr,
           long long pos, int B, int H, int KV, int S, int hd, int rows,
           int splits, int window, float scale, float cap,
           cudaStream_t stream) {
  const int G = H / KV;
  const size_t smem = sizeof(float) * split_smem_floats<kG>(G, hd, rows);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  attn_split<T, C, kG><<<dim3(splits, B * KV), kAttnThreads, smem,
                         stream>>>(
      static_cast<const T*>(q), static_cast<const C*>(k_cache),
      static_cast<const C*>(v_cache), static_cast<T*>(o), part_o, part_ml,
      pos_ptr, pos, B, KV, G, S, hd, rows, window, scale, cap);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  attn_merge<T><<<B * H, kMaxHd, 0, stream>>>(part_o, part_ml,
                                               static_cast<T*>(o), B * H, hd,
                                               splits);
  return (int)cudaGetLastError();
}

// The widest loads the group, the head dim and the caches' alignment
// allow: 8 columns (G <= 4, hd a multiple of 8), 4 (G <= 8, hd a multiple
// of 4), both with the caches on 16 bytes; 2 otherwise.
template <typename T, typename C>
int dispatch(const void* q, const void* k_cache, const void* v_cache,
             void* o, float* part_o, float* part_ml,
             const long long* pos_ptr, long long pos, int B, int H, int KV,
             int S, int hd, int rows, int splits, int window, float scale,
             float cap, cudaStream_t stream) {
  const int G = H / KV;
  const bool aligned = ((uintptr_t)k_cache & 15) == 0 &&
                       ((uintptr_t)v_cache & 15) == 0;
  if (aligned && G <= 4 && hd % 8 == 0)
    return launch<T, C, 4>(q, k_cache, v_cache, o, part_o, part_ml, pos_ptr,
                           pos, B, H, KV, S, hd, rows, splits, window, scale,
                           cap, stream);
  if (aligned && G <= 8 && hd % 4 == 0)
    return launch<T, C, 8>(q, k_cache, v_cache, o, part_o, part_ml, pos_ptr,
                           pos, B, H, KV, S, hd, rows, splits, window, scale,
                           cap, stream);
  return launch<T, C, kMaxG>(q, k_cache, v_cache, o, part_o, part_ml,
                             pos_ptr, pos, B, H, KV, S, hd, rows, splits,
                             window, scale, cap, stream);
}

}  // namespace

// q (B, H, hd) over the caches (B, S, KV, hd) -> o (B, H, hd), at the
// position *pos_ptr (an int64 on the device) or, with pos_ptr NULL, `pos`;
// `window` 0 for none (the caller passes it only when S > W).  The rows go
// in `splits` splits of `rows` rows; part_o (splits, B, H, hd) and part_ml
// (splits, B, H, 2) are the float32 scratch of more than one split.
// dtype is q's and o's, cache_dtype the caches' (0 float32, 1 bf16).
extern "C" int decode_attention_fwd(
    const void* q, const void* k_cache, const void* v_cache, void* o,
    float* part_o, float* part_ml, const long long* pos_ptr, long long pos,
    int dtype, int cache_dtype, int B, int H, int KV, int S, int hd,
    int rows, int splits, int window, float scale, float cap, int device,
    cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B < 0 || KV <= 0 || H % KV || H / KV > kMaxG || S <= 0 || hd <= 0 ||
      hd % 2 || hd > kMaxHd || rows <= 0 || rows > kMaxRows ||
      splits != (S + rows - 1) / rows || window < 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  if (dtype == kF32 && cache_dtype == kF32)
    return dispatch<float, float>(q, k_cache, v_cache, o, part_o, part_ml,
                                pos_ptr, pos, B, H, KV, S, hd, rows, splits,
                                window, scale, cap, stream);
  if (dtype == kF32 && cache_dtype == kBf16)
    return dispatch<float, bf16>(q, k_cache, v_cache, o, part_o, part_ml,
                               pos_ptr, pos, B, H, KV, S, hd, rows, splits,
                               window, scale, cap, stream);
  if (dtype == kBf16 && cache_dtype == kF32)
    return dispatch<bf16, float>(q, k_cache, v_cache, o, part_o, part_ml,
                               pos_ptr, pos, B, H, KV, S, hd, rows, splits,
                               window, scale, cap, stream);
  if (dtype == kBf16 && cache_dtype == kBf16)
    return dispatch<bf16, bf16>(q, k_cache, v_cache, o, part_o, part_ml,
                              pos_ptr, pos, B, H, KV, S, hd, rows, splits,
                              window, scale, cap, stream);
  return (int)cudaErrorInvalidValue;
}
