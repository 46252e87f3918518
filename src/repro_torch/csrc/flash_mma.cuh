// The bf16 tensor-core pieces shared by the flash attention kernels
// (csrc/flash_attention.cu's forward and csrc/flash_attention_bwd.cu's
// backward): cp.async copies, ldmatrix, mma.sync m16n8k16 bf16 -> float32,
// the hi/lo split of float32 pairs, and the chunked loads of a row tile.
// Device code only, in an unnamed namespace: each source that includes it
// keeps its own copy.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // threads a block, in every flash kernel

namespace tc {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// 16 bytes global -> shared (a shared-window address), asynchronously;
// zeros when !in
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// two neighbouring bf16 values as one 32-bit fragment register (one load
// when the pair is 4-byte aligned)
__device__ __forceinline__ uint32_t ld_pair(const bf16* p, bool aligned) {
  if (aligned) return *reinterpret_cast<const uint32_t*>(p);
  return as_u32(__halves2bfloat162(p[0], p[1]));
}

// 2^x (ex2.approx: about 2^-22 relative error; 2^-inf = 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// c (16 x 8, float32) += a (16 x 16, bf16, row) . b (16 x 8, bf16, col)
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (p0, p1) -> hi = bf16(p), lo = bf16(p - hi), packed as A-fragment pairs
__device__ __forceinline__ void split(float p0, float p1, uint32_t& hi,
                                      uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(p0 - hf.x, p1 - hf.y));
}

// This thread's 16-byte chunks of a tile of ROWS rows of HD elements:
// chunk u is row(u) (none where row(u) >= ROWS), column col(u); worked out
// once, before the key loop.  Where a row's chunk count divides the block
// (every head_dim but 80) a thread keeps one column and steps rows evenly,
// so two registers hold it all.
template <class Cf, int ROWS>
struct Chunks {
  static constexpr int CH = Cf::HD / 8;
  static constexpr int N = (ROWS * CH + kThreads - 1) / kThreads;
  static constexpr bool kWhole = ROWS * CH % kThreads == 0;
  static constexpr bool kEven = kThreads % CH == 0;
  int r[kEven ? 1 : N], c[kEven ? 1 : N];

  __device__ __forceinline__ Chunks() {
#pragma unroll
    for (int u = 0; u < (kEven ? 1 : N); ++u) {
      const int i = threadIdx.x + u * kThreads;
      r[u] = i / CH;
      c[u] = (i % CH) * 8;
    }
  }
  __device__ __forceinline__ int row(int u) const {
    return kEven ? r[0] + u * (kThreads / CH) : r[u];
  }
  __device__ __forceinline__ int col(int u) const {
    return kEven ? c[0] : c[u];
  }

  // rows row0 .. row0 + ROWS - 1 of src (row stride `stride`) into the
  // shared tile at dst (rows of Cf::LD elements); rows at or past `nrows`
  // read as zeros.  16-byte cp.async chunks when every row starts on 16
  // bytes (vec), else element by element (before the caller's barrier).
  __device__ __forceinline__ void load(bf16* dst, const bf16* src,
                                       long long stride, int row0, int nrows,
                                       bool vec) const {
    if (vec) {
      const uint32_t base = smem_u32(dst);
#pragma unroll
      for (int u = 0; u < N; ++u) {
        if (!kWhole && row(u) >= ROWS) break;
        const int at = row0 + row(u);
        const bool in = at < nrows;
        cp_async16(base + 2 * (row(u) * Cf::LD + col(u)),
                   src + (in ? (long long)at * stride : 0) + col(u), in);
      }
    } else {
#pragma unroll
      for (int u = 0; u < N; ++u) {
        if (!kWhole && row(u) >= ROWS) break;
        const int at = row0 + row(u);
        const bool in = at < nrows;
        const bf16* s = src + (in ? (long long)at * stride : 0) + col(u);
        bf16* d = dst + row(u) * Cf::LD + col(u);
#pragma unroll
        for (int t = 0; t < 8; ++t) d[t] = in ? s[t] : __float2bfloat16(0.0f);
      }
    }
  }
};

}  // namespace tc

}  // namespace
