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
// Bound on the card: bytes.  The valid rows of K and V are read once, q
// read and o written: at command-r-plus's 4 slots, 8 kv heads and 1553
// valid rows of 128, 25.4 MB, 7.6 us at 3.35 TB/s.  The work, ~4
// operations an element of K and V per query head of the group, is at
// most ~24 operations a byte, far below the ~295 a byte at which the
// tensor cores would bound it.
//
// bf16 q over bf16 caches (the served dtypes) at the head dims of
// tc::mma_head_dim: a kv head's query group on the tensor cores.  One block
// of 4 warps a (split, slot, kv head); the G <= 16 query heads are the 16
// rows of an mma.sync m16n8k16 A operand (zero rows past G), read from
// shared memory by ldmatrix.  The split's rows come in tiles of 64 whole
// cache rows through a cp.async ring of 2 stages (3 at head dim 256),
// 16-byte copies with neighbouring threads on neighbouring bytes of a row,
// so every valid row is read once, coalesced, while the tiles before it
// are used; rows past the split read as zeros and are not fetched.  Each
// warp takes 16 rows of a tile: S = Q.K^T (16 x 16) in float32; scale,
// softcap and the split's rows in float32, in base-2 units; an online
// softmax of its own in registers (ex2.approx); P.V with P split into bf16
// hi + lo halves, both products summed in float32 (one bf16 rounding of P
// breaks the one-bf16-step bound where V cancels, as in the flash kernel,
// tests/test_torch_flash_split.py), V read as the B operand by
// ldmatrix.trans.  The warps' (max, sum, output) are merged in warp order
// in shared memory.  The splits of a (slot, kv head) are one thread block
// cluster (1, 2, 4 or 8 blocks, kernels/decode_step.py split_plan): each
// block keeps its partial in its own shared memory, and after a cluster
// barrier every block merges a share of the group's outputs over the
// splits in split order through distributed shared memory, o = sum_s 2^(m_s
// - M) o_s / sum_s 2^(m_s - M) l_s.  No partial reaches device memory, no
// second kernel, no counter and no atomic: a replay starts from nothing
// and gives the same bits.  The valid rows, known only on the device when
// the position is a CUDA graph's buffer, are spread evenly over the
// splits (a multiple of 16 rows each), so every split works at any
// position.  It replaces the earlier CUDA-core design for these operands (a
// cache row a thread, its loads KV x hd elements from its neighbours',
// G x hd float32 FMAs in turn; 2-8 columns a thread in the V sum; nothing
// asynchronous; up to 32 splits merged by a second kernel through float32
// partials): 0.0225-0.0817 ms where G >= 3, 1.6-4.4x SDPA; now
// 0.0087-0.0149 ms there, 1.2-1.6x faster than SDPA (H100 80GB HBM3 at
// 700 W, 50 calls in a CUDA graph, chip_kernel_turns.py decode).
//
// Every other pairing (float32 q or caches) and head dim keeps the
// CUDA-core design, its own split plan (kernels/decode_step.py
// fma_split_plan) and its merge kernel: q of the group into shared memory;
// each thread a row at a time, its G scores over the head dim (scale,
// then softcap, in float32); each warp a head: the split's max m and p =
// exp(s - m) in place, their sum l; then the weighted sum of V rows by
// (row group, columns) threads, 8 columns a load where G <= 4, 4 where G
// <= 8, 2 otherwise (so that the G x columns sums stay in registers), rows
// unrolled by 4 so that loads overlap, summed over the row groups in a
// fixed order; a second kernel merges the splits in order.  With one
// split the first kernel writes o itself (o_s / l_s).
#include <cooperative_groups.h>

#include "decode_step.cuh"
#include "flash_mma.cuh"

namespace cg = cooperative_groups;

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

// ---- bf16 on the tensor cores (the pieces in flash_mma.cuh) ----------------

namespace tc {

constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;  // splits of a (slot, kv head): a portable cluster

// the head dims the kernel is built for (kernels/decode_step.py
// MMA_HEAD_DIMS)
constexpr bool mma_head_dim(int hd) {
  return hd == 64 || hd == 80 || hd == 128 || hd == 256;
}

// HD columns; 64-row tiles, 16 a warp; STAGES tiles in the cp.async ring
// (up to head dim 128 the next tile loads while one is used, so that 3
// blocks fit an SM: 74 KB each at 128; a third stage left 2 and ran
// 1.1-1.5x slower where G >= 3; at 256, one block an SM either way, 3
// stages: 211 KB; chip_kernel_shapes.py decode); rows padded to LD
// elements (an odd number of 16-byte chunks: the eight rows an ldmatrix
// reads fall in eight bank groups); kMinBlocks resident on an SM
template <int HD_>
struct Cfg {
  static constexpr int HD = HD_, BK = 64, LD = HD + 8;
  static constexpr int STAGES = HD > 128 ? 3 : 2;
  static constexpr int kMinBlocks = HD > 128 ? 1 : 3;
  static constexpr int PART = HD + 2;  // a row's (output, max, sum)
  static constexpr size_t kRing = sizeof(bf16) * 2 * STAGES * BK * LD;
  // after the loop the ring holds each warp's partial, the block's and
  // the warps' weights
  static constexpr size_t kParts =
      sizeof(float) * ((kWarps + 1) * kMaxG * PART + kMaxG * kWarps);
  static_assert(kParts <= kRing, "the partials fit in the ring");
  static constexpr size_t kSmem = sizeof(bf16) * 16 * LD + kRing;
};

// kCap: a softcap is applied (the launch chooses, by cap > 0)
template <class Cf, bool kCap>
__global__ void __launch_bounds__(kThreads, Cf::kMinBlocks)
    attn_mma(const bf16* __restrict__ q, const bf16* __restrict__ k_cache,
             const bf16* __restrict__ v_cache, bf16* __restrict__ o,
             const long long* __restrict__ pos_ptr, long long pos_arg,
             int KV, int G, int S, int window, float scale, float cap) {
  constexpr int HD = Cf::HD, BK = Cf::BK, LD = Cf::LD, PART = Cf::PART;
  constexpr int STAGES = Cf::STAGES;
  constexpr int KS = HD / 16;  // depth steps of Q.K^T
  constexpr int ND = HD / 8;   // 8-wide column tiles of the output
  static_assert(HD % 16 == 0, "tile shapes");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // 16 x LD
  bf16* Ks = Qs + 16 * LD;                       // STAGES x BK x LD
  bf16* Vs = Ks + STAGES * BK * LD;              // STAGES x BK x LD
  float* parts = reinterpret_cast<float*>(Ks);   // kWarps x G x PART, then
  float* blockp = parts + kWarps * G * PART;     // the block's G x PART and
  float* wts = blockp + G * PART;                // the warps' weights

  const int sp = blockIdx.x, splits = gridDim.x;  // one cluster
  const int bk = blockIdx.y, b = bk / KV, kvh = bk % KV;
  const int H = KV * G;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int gq = lane / 4, t = lane % 4;  // fragment row group, column pair

  // q of the group (rows past G zero), element by element (q need not be
  // 16-byte aligned), loaded while the position is read
  constexpr int kQ = 16 * HD / kThreads;  // elements of q a thread
  const bf16* qg = q + ((long long)b * H + (long long)kvh * G) * HD;
  bf16 qv[kQ];
#pragma unroll
  for (int u = 0; u < kQ; ++u) {
    const int i = threadIdx.x + u * kThreads, r = i / HD;
    qv[u] = r < G ? qg[i] : __float2bfloat16(0.0f);
  }

  // this split's rows a .. a + rows - 1: the valid range spread evenly
  // over the splits, a multiple of 16 rows each (rows <= 0: none)
  const Range range = valid_rows(position(pos_ptr, pos_arg), S, window);
  const int n = range.hi - range.lo + 1;
  const int per = ((n + splits - 1) / splits + 15) / 16 * 16;
  const int a = range.lo + sp * per;
  const int rows = min(a + per - 1, range.hi) - a + 1;
  const int n_tiles = rows > 0 ? (rows + BK - 1) / BK : 0;
  const long long stride = (long long)KV * HD;
  const long long first = ((long long)b * S + (rows > 0 ? a : 0)) * stride +
                          (long long)kvh * HD;
  const bf16* kp = k_cache + first;
  const bf16* vp = v_cache + first;

  // the ring: tiles 0 .. STAGES - 2, a group each; then q into shared
  // memory (the first barrier of the loop orders it)
  const Chunks<Cf, BK> tile;
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < n_tiles) {
      tile.load(Ks + i * BK * LD, kp, stride, i * BK, rows, true);
      tile.load(Vs + i * BK * LD, vp, stride, i * BK, rows, true);
    }
    cp_async_commit();
  }
#pragma unroll
  for (int u = 0; u < kQ; ++u) {
    const int i = threadIdx.x + u * kThreads;
    Qs[(i / HD) * LD + i % HD] = qv[u];
  }

  // scores in base-2 units: scale (or the softcap) times log2(e)
  constexpr float kLog2e = 1.4426950408889634f;
  const float scale2 = scale * kLog2e;
  const float cap2 = cap * kLog2e, inv_cap = scale / cap;
  float m_r[2] = {-INFINITY, -INFINITY};  // running max of rows gq, gq + 8
  float l_r[2] = {0.0f, 0.0f};            // this thread's part of their sums
  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  // ldmatrix addresses of this lane: A (Q) rows lane % 16, columns
  // (lane / 16) * 8; B (K) rows (lane / 16) * 8 + lane % 8, columns
  // ((lane / 8) % 2) * 8; B (V, transposed) rows lane % 16, columns
  // (lane / 16) * 8
  const bf16* q_lane = Qs + (lane % 16) * LD + (lane / 16) * 8;
  const int k_lane = ((lane / 16) * 8 + lane % 8) * LD + ((lane / 8) % 2) * 8;
  const int v_lane = (lane % 16) * LD + (lane / 16) * 8;

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<STAGES - 2>();  // tile it has landed
    __syncthreads();              // ... for every thread; tile it - 1 is free
    {
      const int nxt = it + STAGES - 1, st = nxt % STAGES;
      if (nxt < n_tiles) {
        tile.load(Ks + st * BK * LD, kp, stride, nxt * BK, rows, true);
        tile.load(Vs + st * BK * LD, vp, stride, nxt * BK, rows, true);
      }
      cp_async_commit();
    }
    const int r0 = it * BK + warp * 16;  // the warp's first row in the split
    if (r0 >= rows) continue;            // none of this tile's rows is its
    const bf16* Kw = Ks + ((it % STAGES) * BK + warp * 16) * LD;
    const bf16* Vw = Vs + ((it % STAGES) * BK + warp * 16) * LD;

    // S = Q K^T: query rows (gq, gq + 8), cache rows 8j + 2t + {0, 1};
    // the even and odd depth steps in two chains, then summed
    float s[2][4], s2[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = s2[j][e] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t qa[4], kb[4];
      ldmatrix_x4(qa, q_lane + ks * 16);
      ldmatrix_x4(kb, Kw + k_lane + ks * 16);
      mma(ks % 2 ? s2[0] : s[0], qa, kb[0], kb[1]);
      mma(ks % 2 ? s2[1] : s[1], qa, kb[2], kb[3]);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] += s2[j][e];
    // scale and softcap in base-2 units (every score 0 where no row is
    // valid: uniform weights); rows past the split -inf
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float v = kCap ? cap2 * tanhf(s[j][e] * inv_cap) : s[j][e] * scale2;
        if (range.uniform) v = 0.0f;
        if (r0 + 8 * j + 2 * t + (e & 1) >= rows) v = -INFINITY;
        s[j][e] = v;
      }
    // the online softmax in registers: each row's max across its quad;
    // a row with no valid score yet keeps max -inf and weights 0
    float base[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = fmaxf(m_r[r], fmaxf(fmaxf(s[0][2 * r], s[0][2 * r + 1]),
                                     fmaxf(s[1][2 * r], s[1][2 * r + 1])));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      base[r] = mx == -INFINITY ? 0.0f : mx;
      const float corr = exp2_approx(m_r[r] - base[r]);
      m_r[r] = mx;
      l_r[r] *= corr;
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        acc[j][2 * r] *= corr;
        acc[j][2 * r + 1] *= corr;
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2_approx(s[j][e] - base[e / 2]);
        l_r[e / 2] += s[j][e];
      }

    // acc += P V, with P as hi + lo bf16 halves (the A fragments of the
    // 16 x 16 P are the S accumulators' pairs)
    uint32_t ph[4], pl[4];
    split(s[0][0], s[0][1], ph[0], pl[0]);
    split(s[0][2], s[0][3], ph[1], pl[1]);
    split(s[1][0], s[1][1], ph[2], pl[2]);
    split(s[1][2], s[1][3], ph[3], pl[3]);
#pragma unroll
    for (int j = 0; j < ND / 2; ++j) {
      uint32_t vb[4];
      ldmatrix_x4_trans(vb, Vw + v_lane + j * 16);
      mma(acc[2 * j], ph, vb[0], vb[1]);
      mma(acc[2 * j + 1], ph, vb[2], vb[3]);
      mma(acc[2 * j], pl, vb[0], vb[1]);
      mma(acc[2 * j + 1], pl, vb[2], vb[3]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: it takes the partials

  // each warp's (output, max, sum) of the group's rows
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_r[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int g = gq + 8 * r;
    if (g >= G) continue;
    float* pr = parts + (warp * G + g) * PART;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      pr[j * 8 + 2 * t] = acc[j][2 * r];
      pr[j * 8 + 2 * t + 1] = acc[j][2 * r + 1];
    }
    if (t == 0) {
      pr[HD] = m_r[r];
      pr[HD + 1] = l;
    }
  }
  __syncthreads();
  // the block's partial: the warps merged in order (a warp without a
  // valid row has sum 0 and weight 0; a split without one keeps sum 0),
  // each row's max, weights and sum first, then its outputs
  if (threadIdx.x < G) {
    const int g = threadIdx.x;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* pr = parts + (w * G + g) * PART;
      if (pr[HD + 1] > 0.0f) M = fmaxf(M, pr[HD]);
    }
    float den = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* pr = parts + (w * G + g) * PART;
      const float wt = pr[HD + 1] > 0.0f ? exp2_approx(pr[HD] - M) : 0.0f;
      wts[g * kWarps + w] = wt;
      den += wt * pr[HD + 1];
    }
    blockp[g * PART + HD] = M;
    blockp[g * PART + HD + 1] = den;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G * HD; i += kThreads) {
    const int g = i / HD, c = i % HD;
    float num = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      num += wts[g * kWarps + w] * parts[(w * G + g) * PART + c];
    blockp[g * PART + c] = num;
  }
  // the splits merged in order: every block of the cluster a share of the
  // group's outputs, read from each block's shared memory
  cg::cluster_group cluster = cg::this_cluster();
  if (splits > 1) cluster.sync();
  else __syncthreads();
  bf16* og = o + ((long long)b * H + (long long)kvh * G) * HD;
  for (int i = sp * kThreads + threadIdx.x; i < G * HD;
       i += splits * kThreads) {
    const int g = i / HD, c = i % HD;
    float m[kMaxCluster], l[kMaxCluster], v[kMaxCluster];
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) {  // every rank's, at once
      m[r] = l[r] = v[r] = 0.0f;
      if (r < splits) {
        const float* bp = cluster.map_shared_rank(blockp, r) + g * PART;
        m[r] = bp[HD];
        l[r] = bp[HD + 1];
        v[r] = bp[c];
      }
    }
    float M = -INFINITY;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      if (r < splits && l[r] > 0.0f) M = fmaxf(M, m[r]);
    float num = 0.0f, den = 0.0f;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) {
      if (r < splits && l[r] > 0.0f) {
        const float w = exp2_approx(m[r] - M);
        den += w * l[r];
        num += w * v[r];
      }
    }
    og[i] = __float2bfloat16(num / den);
  }
  if (splits > 1) cluster.sync();  // no block leaves while it is read
}

template <int HD>
int launch_mma(const void* q, const void* k_cache, const void* v_cache,
               void* o, const long long* pos_ptr, long long pos, int B,
               int KV, int G, int S, int splits, int window, float scale,
               float cap, cudaStream_t stream) {
  using Cf = Cfg<HD>;
  auto kern = cap > 0.0f ? attn_mma<Cf, true> : attn_mma<Cf, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Cf::kSmem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, B * KV);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = Cf::kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, static_cast<const bf16*>(q),
                           static_cast<const bf16*>(k_cache),
                           static_cast<const bf16*>(v_cache),
                           static_cast<bf16*>(o), pos_ptr, pos, KV, G, S,
                           window, scale, cap);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace tc

}  // namespace

// q (B, H, hd) over the caches (B, S, KV, hd) -> o (B, H, hd), at the
// position *pos_ptr (an int64 on the device) or, with pos_ptr NULL, `pos`;
// `window` 0 for none (the caller passes it only when S > W).  dtype is
// q's and o's, cache_dtype the caches' (0 float32, 1 bf16).  bf16 over
// bf16 at a head dim of tc::mma_head_dim (the caches on 16 bytes) runs on the
// tensor cores: `splits` (1, 2, 4 or 8) blocks a (slot, kv head), one
// cluster, the valid rows spread over them; rows must be 0 and part_o,
// part_ml NULL.  Otherwise the CUDA-core kernel takes `splits` splits of
// `rows` rows; part_o (splits, B, H, hd) and part_ml (splits, B, H, 2) are
// the float32 scratch of more than one split.
extern "C" int decode_attention_fwd(
    const void* q, const void* k_cache, const void* v_cache, void* o,
    float* part_o, float* part_ml, const long long* pos_ptr, long long pos,
    int dtype, int cache_dtype, int B, int H, int KV, int S, int hd,
    int rows, int splits, int window, float scale, float cap, int device,
    cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B < 0 || KV <= 0 || H % KV || H / KV > kMaxG || S <= 0 || hd <= 0 ||
      hd % 2 || hd > kMaxHd || window < 0 || splits <= 0)
    return (int)cudaErrorInvalidValue;
  const int G = H / KV;
  if (dtype == kBf16 && cache_dtype == kBf16 && tc::mma_head_dim(hd)) {
    if (rows != 0 || part_o != nullptr || part_ml != nullptr ||
        splits > tc::kMaxCluster || (splits & (splits - 1)) ||
        ((uintptr_t)k_cache | (uintptr_t)v_cache) % 16)
      return (int)cudaErrorInvalidValue;
    if (B == 0) return 0;
    switch (hd) {
      case 64: return tc::launch_mma<64>(q, k_cache, v_cache, o, pos_ptr,
                                         pos, B, KV, G, S, splits, window,
                                         scale, cap, stream);
      case 80: return tc::launch_mma<80>(q, k_cache, v_cache, o, pos_ptr,
                                         pos, B, KV, G, S, splits, window,
                                         scale, cap, stream);
      case 128: return tc::launch_mma<128>(q, k_cache, v_cache, o, pos_ptr,
                                           pos, B, KV, G, S, splits, window,
                                           scale, cap, stream);
      default: return tc::launch_mma<256>(q, k_cache, v_cache, o, pos_ptr,
                                          pos, B, KV, G, S, splits, window,
                                          scale, cap, stream);
    }
  }
  if (rows <= 0 || rows > kMaxRows || splits != (S + rows - 1) / rows)
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
