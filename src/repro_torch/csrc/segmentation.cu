// segmentation: v < lo -> 0, v > hi -> 255, else 128 — the paper's 3-D Map.
//
// Replaces src/repro/kernels/segmentation.py:segmentation (Pallas body
// _seg_kernel).  Bound on the card: bytes (4 read + 4 written per element,
// two comparisons).  The TPU kernel walked one D3 plane per grid step;
// here the volume is any contiguous tensor, treated as a flat array, so
// each slot's slice of whole planes (partitioned along dim 0) is one
// stream of float4 loads and stores in a grid-stride loop, with a scalar
// loop for misaligned views and the ragged tail.  The comparisons are the
// reference's, in its order, so NaN (false under both) yields 128 exactly
// as jnp.where does.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

__device__ __forceinline__ float classify(float v, float lo, float hi) {
  return v < lo ? 0.0f : (v > hi ? 255.0f : 128.0f);
}

__global__ void seg_vec4(const float4* __restrict__ in,
                         float4* __restrict__ out, long long n4, float lo,
                         float hi) {
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n4; i += stride) {
    float4 v = in[i];
    float4 r;
    r.x = classify(v.x, lo, hi);
    r.y = classify(v.y, lo, hi);
    r.z = classify(v.z, lo, hi);
    r.w = classify(v.w, lo, hi);
    out[i] = r;
  }
}

__global__ void seg_scalar(const float* __restrict__ in,
                           float* __restrict__ out, long long begin,
                           long long n, float lo, float hi) {
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = begin + (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    out[i] = classify(in[i], lo, hi);
  }
}

int blocks_for(long long work) {
  long long b = (work + kThreads - 1) / kThreads;
  if (b < 1) b = 1;
  return (int)(b < kMaxBlocks ? b : kMaxBlocks);
}

}  // namespace

extern "C" int segmentation_f32(const float* in, float* out, long long n,
                                float lo, float hi, int device,
                                cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return 0;
  bool aligned = ((uintptr_t)in % 16 == 0) && ((uintptr_t)out % 16 == 0);
  long long n4 = aligned ? n / 4 : 0;
  if (n4 > 0) {
    seg_vec4<<<blocks_for(n4), kThreads, 0, stream>>>(
        reinterpret_cast<const float4*>(in), reinterpret_cast<float4*>(out),
        n4, lo, hi);
  }
  long long begin = n4 * 4;
  if (begin < n) {
    seg_scalar<<<blocks_for(n - begin), kThreads, 0, stream>>>(
        in, out, begin, n, lo, hi);
  }
  return (int)cudaGetLastError();
}
