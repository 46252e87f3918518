// saxpy: z = a*x + y over float32 vectors — the paper's Map benchmark.
//
// Replaces src/repro/kernels/saxpy.py:saxpy (Pallas body _saxpy_kernel).
// Bound on the card: bytes.  Each element reads 8 bytes and writes 4 and
// does 2 flops, far below the H100's ~20 flops per byte, so the kernel can
// only approach the HBM rate.  Design: a grid-stride loop over 16-byte
// float4 loads and stores (the widest a thread issues in one instruction),
// with neighbouring threads on neighbouring addresses.  The float4 path
// needs 16-byte aligned pointers; a view that starts at an odd offset, and
// the ragged tail of N, take the scalar loop instead.  The TPU version's
// padding of x and y to a whole block is gone: nothing is copied.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

__global__ void saxpy_vec4(float a, const float4* __restrict__ x,
                           const float4* __restrict__ y,
                           float4* __restrict__ z, long long n4) {
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n4; i += stride) {
    float4 xv = x[i];
    float4 yv = y[i];
    float4 r;
    r.x = a * xv.x + yv.x;
    r.y = a * xv.y + yv.y;
    r.z = a * xv.z + yv.z;
    r.w = a * xv.w + yv.w;
    z[i] = r;
  }
}

__global__ void saxpy_scalar(float a, const float* __restrict__ x,
                             const float* __restrict__ y,
                             float* __restrict__ z, long long begin,
                             long long n) {
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = begin + (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    z[i] = a * x[i] + y[i];
  }
}

int blocks_for(long long work) {
  long long b = (work + kThreads - 1) / kThreads;
  if (b < 1) b = 1;
  return (int)(b < kMaxBlocks ? b : kMaxBlocks);
}

}  // namespace

extern "C" int saxpy_f32(const float* x, const float* y, float* z, float a,
                         long long n, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return 0;
  bool aligned = ((uintptr_t)x % 16 == 0) && ((uintptr_t)y % 16 == 0) &&
                 ((uintptr_t)z % 16 == 0);
  long long n4 = aligned ? n / 4 : 0;
  if (n4 > 0) {
    saxpy_vec4<<<blocks_for(n4), kThreads, 0, stream>>>(
        a, reinterpret_cast<const float4*>(x),
        reinterpret_cast<const float4*>(y), reinterpret_cast<float4*>(z), n4);
  }
  long long begin = n4 * 4;
  if (begin < n) {
    saxpy_scalar<<<blocks_for(n - begin), kThreads, 0, stream>>>(
        a, x, y, z, begin, n);
  }
  return (int)cudaGetLastError();
}
