// The microbatch gradient accumulation over every gradient tensor of a
// training step, one launch a microbatch.
//
// Replaces no TPU kernel: the JAX package's step (jitted whole) carries
// float32 accumulators through a jax.lax.scan over the microbatches
// (src/repro/runtime/train.py:96 _accumulate_grads), adding
// `a + b.astype(jnp.float32)` at :134 and scaling by `x * inv` at :142,
// and XLA fuses that work into a few passes over memory.  Eagerly, the
// port ran zeros, a cast and an add a tensor a microbatch and a scaled copy
// at the end: ~10 launches a tensor and, at four microbatches of bf16
// gradients, 84 bytes an element.  These launches move 36.
//
// Bound on the card: bytes.  A call reads each gradient once and reads
// and writes its float32 accumulator once (the first call only writes):
// 6 bytes an element for the first call with bf16 gradients and 10 for
// the others (8 and 12 with float32 gradients), for one float32 addition
// an element (two in the last call).
//
// The tensors come as csrc/multi_tensor.cuh's table: columns [0] the
// accumulator (float32), [1] the gradient (float32 or bf16, flag kGBf16),
// all contiguous, one shape a row; one block a chunk.  Three modes, each
// rounding explicit (no contraction), so the accumulators come out
// bit-identical to the eager loop (kernels/ref.py grad_accumulate_ref):
//   first:  acc = 0.0f + g      (not a copy: the eager zeros + g and the
//                                reference's scan from zeros turn -0.0
//                                into +0.0; acc is not read);
//   middle: acc = acc + g;
//   last:   acc = (acc + g) * s, s the float32 the host makes of 1.0 / M
//           (what PyTorch's v * inv and the reference's weakly typed
//           x * inv multiply by).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "multi_tensor.cuh"

namespace {

constexpr int kFirst = 0, kMiddle = 1, kLast = 2;

template <int kMode>
__device__ __forceinline__ float accumulate(float acc, float g, float s) {
  if (kMode == kFirst) return __fadd_rn(0.0f, g);
  const float sum = __fadd_rn(acc, g);
  return kMode == kLast ? __fmul_rn(sum, s) : sum;
}

template <int kMode, typename G>
__device__ void accumulate_range(float* __restrict__ acc,
                                 const G* __restrict__ g, long long lo,
                                 long long hi, float s) {
  if (aligned16(acc) && aligned16(g)) {  // lo is a multiple of kVec
    const long long end = lo + (hi - lo) / kVec * kVec;
    for (long long i = lo + (long long)threadIdx.x * kVec; i < end;
         i += (long long)kThreads * kVec) {
      float gf[kVec], af[kVec] = {};
      load8(g, i, gf);
      if (kMode != kFirst) load8(acc, i, af);
#pragma unroll
      for (int k = 0; k < kVec; ++k)
        af[k] = accumulate<kMode>(af[k], gf[k], s);
      store8(acc, i, af);
    }
    lo = end;
  }
  for (long long i = lo + threadIdx.x; i < hi; i += kThreads)
    acc[i] = accumulate<kMode>(kMode == kFirst ? 0.0f : acc[i],
                               to_f32(g[i]), s);
}

template <int kMode>
__global__ void __launch_bounds__(kThreads)
    accumulate_chunks(const long long* __restrict__ table, int n,
                      long long chunk, float s) {
  const long long c = blockIdx.x;
  const long long* row = table + (long long)tensor_of(table, n, c) * kRow;
  const long long lo = (c - row[6]) * chunk;
  const long long hi = lo + chunk < row[4] ? lo + chunk : row[4];
  float* acc = reinterpret_cast<float*>(row[0]);
  if (row[5] & kGBf16)
    accumulate_range<kMode>(acc, reinterpret_cast<const bf16*>(row[1]), lo,
                            hi, s);
  else
    accumulate_range<kMode>(acc, reinterpret_cast<const float*>(row[1]), lo,
                            hi, s);
}

}  // namespace

// One microbatch's gradients into every accumulator of the table in
// `mode` (0 first, 1 middle, 2 last; `scale` is read by the last alone).
extern "C" int grad_accum(const long long* table, int n, long long chunk,
                          long long chunks, int mode, float scale,
                          int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (int bad = check_plan(n, chunk, chunks)) return bad;
  if (mode < kFirst || mode > kLast) return (int)cudaErrorInvalidValue;
  if (chunks == 0) return 0;
  const unsigned blocks = (unsigned)chunks;
  if (mode == kFirst)
    accumulate_chunks<kFirst><<<blocks, kThreads, 0, stream>>>(table, n,
                                                               chunk, scale);
  else if (mode == kMiddle)
    accumulate_chunks<kMiddle><<<blocks, kThreads, 0, stream>>>(table, n,
                                                                chunk, scale);
  else
    accumulate_chunks<kLast><<<blocks, kThreads, 0, stream>>>(table, n,
                                                              chunk, scale);
  return (int)cudaGetLastError();
}
