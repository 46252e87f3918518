// The device table of a multi-tensor launch and its helpers, shared by
// csrc/adamw.cu (AdamW's norm and update) and csrc/grad_accum.cu (the
// microbatch gradient accumulation).  A launch takes any number of
// tensors as a table in device memory, one row of kRow 64-bit words a
// tensor (kernels/adamw.py `_table` builds it on the host each call and
// copies it from pinned memory without waiting):
//   [0]-[3] addresses (each source says which it reads), [4] elements,
//   [5] flags (kPBf16, kGBf16, kDecay), [6] the tensor's first chunk in
//   the launch's numbering, [7] unused.
// Every tensor is cut into chunks of `chunk` elements (a multiple of
// kVec); one block takes one chunk and finds its tensor by a binary
// search over column 6 (tensor_of).  A thread moves kVec elements a step
// with 16-byte loads where the tensor's pointers are 16-byte aligned, one
// at a time otherwise (and for a ragged tail).  In an unnamed namespace:
// each source that includes it keeps its own copy.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // threads a block, every kernel
constexpr int kVec = 8;        // elements a thread a step
constexpr int kRow = 8;        // 64-bit words a table row
constexpr int kPBf16 = 1, kGBf16 = 2, kDecay = 4;
using bf16 = __nv_bfloat16;

// The tensor that chunk c belongs to: the last row whose first chunk is
// at most c (a tensor of no elements shares its first chunk with the next
// one, which comes later in the table).
__device__ __forceinline__ int tensor_of(const long long* table, int n,
                                         long long c) {
  int lo = 0, hi = n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (table[(long long)mid * kRow + 6] <= c) lo = mid; else hi = mid - 1;
  }
  return lo;
}

__device__ __forceinline__ bool aligned16(const void* a) {
  return ((uintptr_t)a & 15) == 0;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f32(float x, float* out) { *out = x; }
__device__ __forceinline__ void from_f32(float x, bf16* out) {
  *out = __float2bfloat16_rn(x);
}

// kVec elements at i (16-byte aligned) as float32.
__device__ __forceinline__ void load8(const float* src, long long i,
                                      float out[kVec]) {
  const float4 a = *reinterpret_cast<const float4*>(src + i);
  const float4 b = *reinterpret_cast<const float4*>(src + i + 4);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}
__device__ __forceinline__ void load8(const bf16* src, long long i,
                                      float out[kVec]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src + i);
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {  // element 2k in the low half
    out[2 * k] = __uint_as_float(w[k] << 16);
    out[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}
__device__ __forceinline__ void store8(float* dst, long long i,
                                       const float in[kVec]) {
  *reinterpret_cast<float4*>(dst + i) = make_float4(in[0], in[1], in[2],
                                                    in[3]);
  *reinterpret_cast<float4*>(dst + i + 4) = make_float4(in[4], in[5], in[6],
                                                        in[7]);
}
__device__ __forceinline__ uint32_t bf16_bits(float x) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(x));
}
__device__ __forceinline__ void store8(bf16* dst, long long i,
                                       const float in[kVec]) {
  uint4 raw;
  raw.x = bf16_bits(in[0]) | (bf16_bits(in[1]) << 16);
  raw.y = bf16_bits(in[2]) | (bf16_bits(in[3]) << 16);
  raw.z = bf16_bits(in[4]) | (bf16_bits(in[5]) << 16);
  raw.w = bf16_bits(in[6]) | (bf16_bits(in[7]) << 16);
  *reinterpret_cast<uint4*>(dst + i) = raw;
}

// The launch's plan, checked on the host.
int check_plan(int n, long long chunk, long long chunks) {
  if (n < 0 || chunk <= 0 || chunk % kVec || chunks < 0 ||
      chunks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace
