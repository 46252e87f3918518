// RMSNorm of the decode step's rows, optionally after a residual add:
// y = (x * rsqrt(mean(x^2) + eps)) * scale over the last dim, float32
// inside, in x's dtype out; with a residual r, s = x + r (rounded to x's
// dtype, as the eager `x + r` rounds it) is written too and normed.
//
// Replaces no TPU kernel: the JAX engine jits its whole decode step
// (src/repro/runtime/serve.py:83-84) and XLA fuses each rmsnorm
// (src/repro/models/layers.py:90) and the residual add before it into a
// fusion or two.  Eagerly, the port ran ~9 device operations a norm (cast,
// square, mean, add, rsqrt, two products, a cast) and one more for the
// add, 2-3 norms a layer a step.  Plain version: kernels/ref.py
// rmsnorm_ref.
//
// Bound on the card: bytes (x, r and scale read, y and s written once;
// ~4 operations an element) and, at decode's few rows, the launch itself.
// One block a row: the sum of squares by warp sums and one pass over the
// warps' partials (a fixed order), then the row normed from L1/L2.
#include "decode_step.cuh"

namespace {

constexpr int kNormThreads = 256;
constexpr int kNormWarps = kNormThreads / 32;

template <typename T, typename S>
__global__ void __launch_bounds__(kNormThreads)
    rmsnorm_rows(const T* __restrict__ x, const T* __restrict__ res,
                 const S* __restrict__ scale, T* __restrict__ y,
                 T* __restrict__ sum_out, int d, float eps) {
  __shared__ float part[kNormWarps];
  const long long base = (long long)blockIdx.x * d;
  const T* xr = x + base;
  T* yr = y + base;
  float ss = 0.0f;
  for (int i = threadIdx.x; i < d; i += kNormThreads) {
    float v = to_f32(xr[i]);
    if (res != nullptr) {
      v = round_to<T>(__fadd_rn(v, to_f32(res[base + i])));
      sum_out[base + i] = from_f32<T>(v);
    }
    ss = __fadd_rn(ss, __fmul_rn(v, v));
  }
  ss = warp_sum(ss);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) part[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float t = lane < kNormWarps ? part[lane] : 0.0f;
    t = warp_sum(t);
    if (lane == 0) part[0] = t;
  }
  __syncthreads();
  const float r = rsqrtf(__fadd_rn(__fdiv_rn(part[0], (float)d), eps));
  // each thread reads back the elements it wrote: no barrier needed
  const T* src = res != nullptr ? sum_out + base : xr;
  for (int i = threadIdx.x; i < d; i += kNormThreads)
    yr[i] = from_f32<T>(__fmul_rn(__fmul_rn(to_f32(src[i]), r),
                                  to_f32(scale[i])));
}

template <typename T, typename S>
int launch(const void* x, const void* res, const void* scale, void* y,
           void* sum_out, int rows, int d, float eps, cudaStream_t stream) {
  rmsnorm_rows<T, S><<<rows, kNormThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(res),
      static_cast<const S*>(scale), static_cast<T*>(y),
      static_cast<T*>(sum_out), d, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// `rows` rows of `d` elements of x (dtype: 0 float32, 1 bf16; scale's
// scale_dtype likewise) normed into y; with a residual (else NULL), the
// sum x + residual into sum_out first.
extern "C" int rmsnorm_fwd(const void* x, const void* residual,
                           const void* scale, void* y, void* sum_out,
                           int dtype, int scale_dtype, int rows, int d,
                           float eps, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (rows < 0 || d <= 0 || (residual != nullptr) != (sum_out != nullptr))
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  if (dtype == kF32 && scale_dtype == kF32)
    return launch<float, float>(x, residual, scale, y, sum_out, rows, d, eps,
                                stream);
  if (dtype == kF32 && scale_dtype == kBf16)
    return launch<float, bf16>(x, residual, scale, y, sum_out, rows, d, eps,
                               stream);
  if (dtype == kBf16 && scale_dtype == kF32)
    return launch<bf16, float>(x, residual, scale, y, sum_out, rows, d, eps,
                               stream);
  if (dtype == kBf16 && scale_dtype == kBf16)
    return launch<bf16, bf16>(x, residual, scale, y, sum_out, rows, d, eps,
                              stream);
  return (int)cudaErrorInvalidValue;
}
