// The split-TF32 tensor-core pieces shared by the SSD scan's kernels
// (csrc/ssd_scan.cu's forward and csrc/ssd_scan_bwd.cu's backward):
// mma.sync m16n8k8 TF32 -> float32, the hi/lo split of float32 operands as
// they are staged in shared memory, and the staging of a 64-row piece.  One
// TF32 rounding keeps 11 bits, which the float32 bounds do not survive, so
// each operand is split into hi = tf32(v) (cvt.rna) and lo = tf32(v - hi)
// and each product is issued as lo.hi + hi.lo + hi.hi (about 22 bits; lo.lo
// is below float32's own rounding).  Device code only, in an unnamed
// namespace: each source that includes it keeps its own copy.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kTile = 64;  // rows of every staged piece

__device__ __forceinline__ float4 zero4() {
  return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}
__device__ __forceinline__ float4 scale4(float s, float4 v) {
  return make_float4(s * v.x, s * v.y, s * v.z, s * v.w);
}

// v rounded to TF32 (10 mantissa bits, to nearest, ties away), as a float
__device__ __forceinline__ float split_hi(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return __uint_as_float(r);
}
// four values v -> hi[i..] = tf32(v), lo[i..] = tf32(v - hi), as their bit
// patterns (16-byte stores: i is a multiple of 4)
__device__ __forceinline__ void put_split4(float* hi, float* lo, int i,
                                           float4 v) {
  const float4 h = make_float4(split_hi(v.x), split_hi(v.y), split_hi(v.z),
                               split_hi(v.w));
  *reinterpret_cast<float4*>(hi + i) = h;
  *reinterpret_cast<float4*>(lo + i) =
      make_float4(split_hi(v.x - h.x), split_hi(v.y - h.y),
                  split_hi(v.z - h.z), split_hi(v.w - h.w));
}

// A piece of kTile rows x W columns on its way from device memory to
// shared memory, staged by the kThreads threads of a block: fetch() issues
// each thread's 16-byte loads into registers, and put() later splits the
// values (after a transform) into hi / lo at pitch ld.  Between the two the
// block runs the last piece's products, so the loads are in flight while
// the tensor cores work.
template <int W, int kThreads>
struct Piece {
  static constexpr int Q4 = W / 4, N = kTile * Q4 / kThreads;
  static_assert(kTile * Q4 % kThreads == 0, "whole float4s a thread");
  float4 v[N];

  __device__ __forceinline__ static int row(int u) {
    return ((int)threadIdx.x + u * kThreads) / Q4;
  }
  __device__ __forceinline__ static int col(int u) {
    return (((int)threadIdx.x + u * kThreads) % Q4) * 4;
  }
  // v = f(row, first column) for each of this thread's four columns
  template <class F>
  __device__ __forceinline__ void fetch(F f) {
#pragma unroll
    for (int u = 0; u < N; ++u) v[u] = f(row(u), col(u));
  }
  // hi / lo [row * ld + column ..] = split(f(row, column, v))
  template <class F>
  __device__ __forceinline__ void put(float* hi, float* lo, int ld,
                                     F f) const {
#pragma unroll
    for (int u = 0; u < N; ++u)
      put_split4(hi, lo, row(u) * ld + col(u), f(row(u), col(u), v[u]));
  }
};

struct Same {
  __device__ __forceinline__ float4 operator()(int, int, float4 v) const {
    return v;
  }
};

// c (16 x 8, float32) += a (16 x 8, tf32, row) . b (8 x 8, tf32, col)
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc (16 x 8 NT) += A (rows m0 .. m0 + 15, depth 0 .. kmax) . B (depth x
// 8 NT), both split: lo.hi + hi.lo + hi.hi.  A is stored [m][k] with pitch
// lda (kAKM: [k][m]); B is stored [k][n] with pitch ldb (kBNK: [n][k]).
// kmax is a multiple of 8 (and at most kUnroll, when that is not 0: the
// depth loop is then unrolled, so that the next step's loads are issued
// while this step's products run).  Lane (g, t) = (lane / 4, lane % 4)
// holds acc[n] = rows m0 + g and m0 + g + 8, columns 8 n + 2 t and
// 8 n + 2 t + 1.
template <int NT, bool kAKM, bool kBNK, int kUnroll = 0>
__device__ __forceinline__ void warp_product(
    float (&acc)[NT][4], const float* __restrict__ Ah,
    const float* __restrict__ Al, int lda, int m0,
    const float* __restrict__ Bh, const float* __restrict__ Bl, int ldb,
    int kmax) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  auto step = [&](int k) {
    uint32_t ah[4], al[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = m0 + g + 8 * (e & 1), kk = k + t + 4 * (e >> 1);
      const int i = kAKM ? kk * lda + m : m * lda + kk;
      ah[e] = __float_as_uint(Ah[i]);
      al[e] = __float_as_uint(Al[i]);
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int col = 8 * n + g;
      const int i0 = kBNK ? col * ldb + k + t : (k + t) * ldb + col;
      const int i1 = kBNK ? i0 + 4 : i0 + 4 * ldb;
      const uint32_t bh0 = __float_as_uint(Bh[i0]);
      const uint32_t bh1 = __float_as_uint(Bh[i1]);
      const uint32_t bl0 = __float_as_uint(Bl[i0]);
      const uint32_t bl1 = __float_as_uint(Bl[i1]);
      mma_tf32(acc[n], al, bh0, bh1);
      mma_tf32(acc[n], ah, bl0, bl1);
      mma_tf32(acc[n], ah, bh0, bh1);
    }
  };
  if constexpr (kUnroll > 0) {
#pragma unroll
    for (int k = 0; k < kUnroll; k += 8)
      if (k < kmax) step(k);
  } else {
    for (int k = 0; k < kmax; k += 8) step(k);
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[NT][4]) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
}

__device__ __forceinline__ int round8(int n) { return (n + 7) & ~7; }

// the dynamic shared memory a kernel needs, allowed once per device
template <auto kKernel>
cudaError_t allow_smem(size_t bytes, int device) {
  static std::atomic<unsigned long long> done{0};
  const unsigned long long bit = 1ull << (device & 63);
  if (done.load() & bit) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

}  // namespace
