// Helpers shared by the decode step's kernels (csrc/rmsnorm.cu,
// csrc/rope_cache.cu, csrc/decode_attention.cu, csrc/ssd_decode.cu):
// element types, explicit float32 rounding, the step's position and warp
// sums.  Every product and sum that the plain version (kernels/ref.py)
// rounds on its own is written with a round-to-nearest intrinsic, so that
// nvcc contracts nothing into an FMA the plain version does not have.  In
// an unnamed namespace: each source that includes it keeps its own copy.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

// the dtype codes of kernels/_build.py DTYPE_CODES
constexpr int kF32 = 0, kBf16 = 1;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T and read back as float32 (the plain version's `.to(T)`).
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// The step's position: read from device memory where the caller gave a
// 0-d int64 tensor (a CUDA graph's position buffer), else the launch's
// argument.  Both then go through the same arithmetic.
__device__ __forceinline__ long long position(const long long* pos_ptr,
                                              long long pos) {
  return pos_ptr != nullptr ? *pos_ptr : pos;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// silu as PyTorch computes it on the card: x / (1 + exp(-x)) in float32.
__device__ __forceinline__ float silu(float x) {
  return __fdiv_rn(x, __fadd_rn(1.0f, expf(-x)));
}

}  // namespace
