// filter_pipeline: hash noise -> clip [0,255] -> solarize -> mirror each row,
// fused — the paper's Pipeline benchmark.
//
// Replaces src/repro/kernels/filter_pipeline.py:filter_pipeline (Pallas
// body _filter_kernel).  Bound on the card: bytes.  Each pixel reads 4
// bytes and writes 4; the two integer hashes cost ~20 integer operations,
// well under the H100's operations-per-byte balance.  Design: one thread
// per output pixel; output (r, c) is input (r, W-1-c) after noise, clip
// and solarize, so the mirror costs nothing but a reversed read address
// (a warp still reads one contiguous span).  Rows are whole, as the
// paper's elementary unit (one image line) guarantees; row ids are local
// to the array passed in, as in the TPU kernel.
//
// Exactness: the hash relies on int32 wrap-around and arithmetic right
// shifts.  Signed overflow is undefined in C++, so products and sums are
// taken in uint32 (which wraps) and the shifts on the int32 bit pattern
// (arithmetic on this compiler).  The float steps use the _rn intrinsics
// so the compiler cannot contract them into fused multiply-adds, and
// /65535 is a true IEEE division: each step is rounded once, in the
// reference's order.  (PyTorch's CUDA division by a scalar multiplies by
// the reciprocal, so its plain version on the card can differ by one
// rounding.)  Clipping uses comparisons, so NaN passes through as
// jnp.clip and torch.clamp let it.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRowsPerLaunch = 65535;   // gridDim.y limit

__device__ __forceinline__ float hash01(int row, int col, int seed,
                                        int salt) {
  uint32_t h = (uint32_t)row * (uint32_t)(-1640531535) +
               (uint32_t)col * 40503u + (uint32_t)seed * 69069u +
               (uint32_t)salt * 1013904223u;
  int32_t s = (int32_t)h;
  s ^= s >> 13;
  s = (int32_t)((uint32_t)s * 1274126177u);
  s ^= s >> 16;
  return __fdiv_rn((float)(s & 0xFFFF), 65535.0f);
}

__global__ void filter_kernel(const float* __restrict__ img,
                              float* __restrict__ out, int H, int W,
                              int seed, float noise_scale, float threshold) {
  int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= W) return;
  int src_c = W - 1 - c;
  for (int r = blockIdx.y; r < H; r += gridDim.y) {
    long long row_base = (long long)r * W;
    float n = __fsub_rn(__fadd_rn(hash01(r, src_c, seed, 1),
                                  hash01(r, src_c, seed, 2)), 1.0f);
    float v = __fadd_rn(img[row_base + src_c], __fmul_rn(n, noise_scale));
    v = v < 0.0f ? 0.0f : v;
    v = v > 255.0f ? 255.0f : v;
    v = v > threshold ? __fsub_rn(255.0f, v) : v;
    out[row_base + c] = v;
  }
}

}  // namespace

extern "C" int filter_pipeline_f32(const float* img, float* out, int H, int W,
                                   int seed, float noise_scale,
                                   float threshold, int device,
                                   cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (H <= 0 || W <= 0) return 0;
  dim3 grid((W + kThreads - 1) / kThreads,
            H < kMaxRowsPerLaunch ? H : kMaxRowsPerLaunch);
  filter_kernel<<<grid, kThreads, 0, stream>>>(img, out, H, W, seed,
                                               noise_scale, threshold);
  return (int)cudaGetLastError();
}
