// AdamW's gradient norm and update over every parameter tensor of a
// training step, in a few launches.
//
// Replaces no TPU kernel: the JAX package's train step (jitted whole,
// src/repro/launch/train.py) leaves src/repro/optim/adamw.py's
// global_norm and per-leaf update to XLA, which fuses them into a few
// passes over memory.  Eagerly, the port's loop ran ~20 elementwise
// launches a tensor and moved ~172 bytes an element (bf16 parameter and
// gradient, float32 moments); these kernels move ~24.
//
// Bound on the card: bytes.  The update reads p, g, m, v and writes p, m,
// v once (22 bytes an element for bf16 p and g) for ~17 float32
// operations; the sum of squares reads g once (2 bytes) for 2.
//
// The tensors come as csrc/multi_tensor.cuh's table: columns [0] p, [1]
// g, [2] m, [3] v (the sum of squares reads g only), flags kPBf16, kGBf16,
// kDecay; one block a chunk.  p and g are float32 or bf16 in any pairing,
// m and v float32, all contiguous.
//
// The sum of squares is deterministic: each chunk's float32 sum goes to
// its own slot of a partials buffer (a fixed tree in the block), each
// tensor's sum is its chunks' in a fixed order (adamw_sumsq), and the
// total is the tensors' in a fixed order (adamw_sum), so the same
// gradients give the same bits, and a caller that all-reduces the
// per-tensor sums between the two launches (the sharded norm) reduces in
// the same order as one that does not.
//
// The update repeats the eager loop's float32 arithmetic on the card op
// for op, each rounding explicit (no contraction but where PyTorch's own
// CUDA op contracts: add(self, other, alpha) is self + alpha * other,
// one FMA), so m, v and p come out bit-identical to the plain version:
//   g = g * scale; m = m * b1 + (1 - b1) g; v = v * b2 + (1 - b2) (g g);
//   delta = (m * (1 / b1c)) / (sqrt(v * (1 / b2c)) + eps)   [a division
//   by a host scalar is a multiply by its float32 reciprocal on CUDA];
//   delta = delta + wd p where decayed; p = p - lr delta, rounded to p's
//   dtype (round to nearest even for bf16).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "multi_tensor.cuh"

namespace {

// The block's sum of one value a thread, in a fixed order: a shuffle tree
// in each warp, then the warps' sums by the same tree in warp 0.  The
// result is valid in thread 0.
__device__ __forceinline__ float block_sum(float x) {
  __shared__ float warp_sums[kThreads / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = __fadd_rn(x, __shfl_down_sync(0xffffffffu, x, off));
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = x;
  __syncthreads();
  if (threadIdx.x < 32) {
    x = threadIdx.x < kThreads / 32 ? warp_sums[threadIdx.x] : 0.0f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      x = __fadd_rn(x, __shfl_down_sync(0xffffffffu, x, off));
  }
  return x;
}

// ---------------------------------------------------------------------------
// sum of squares
// ---------------------------------------------------------------------------

template <typename G>
__device__ float sumsq_range(const G* g, long long lo, long long hi) {
  float acc = 0.0f;
  if (aligned16(g)) {  // lo is a multiple of kVec
    const long long end = lo + (hi - lo) / kVec * kVec;
    for (long long i = lo + (long long)threadIdx.x * kVec; i < end;
         i += (long long)kThreads * kVec) {
      float x[kVec];
      load8(g, i, x);
#pragma unroll
      for (int k = 0; k < kVec; ++k) acc = fmaf(x[k], x[k], acc);
    }
    lo = end;
  }
  for (long long i = lo + threadIdx.x; i < hi; i += kThreads) {
    const float x = to_f32(g[i]);
    acc = fmaf(x, x, acc);
  }
  return acc;
}

// One block a chunk: the chunk's sum of squares into partials[chunk].
__global__ void __launch_bounds__(kThreads)
    sumsq_chunks(const long long* __restrict__ table, int n, long long chunk,
                 float* __restrict__ partials) {
  const long long c = blockIdx.x;
  const long long* row = table + (long long)tensor_of(table, n, c) * kRow;
  const long long lo = (c - row[6]) * chunk;
  const long long hi = lo + chunk < row[4] ? lo + chunk : row[4];
  const float s = (row[5] & kGBf16)
                      ? sumsq_range(reinterpret_cast<const bf16*>(row[1]), lo,
                                    hi)
                      : sumsq_range(reinterpret_cast<const float*>(row[1]),
                                    lo, hi);
  const float total = block_sum(s);
  if (threadIdx.x == 0) partials[c] = total;
}

// A block's fixed-order sum of x[lo:hi] (thread t takes t, t + kThreads,
// ... in order, then block_sum).
__device__ __forceinline__ float ordered_sum(const float* x, long long lo,
                                             long long hi) {
  float acc = 0.0f;
  for (long long i = lo + threadIdx.x; i < hi; i += kThreads)
    acc = __fadd_rn(acc, x[i]);
  return block_sum(acc);
}

// One block a tensor: the sum of its chunks' partials into out[t].
__global__ void __launch_bounds__(kThreads)
    sumsq_tensors(const long long* __restrict__ table, int n,
                  long long chunks, const float* __restrict__ partials,
                  float* __restrict__ out) {
  const int t = blockIdx.x;
  const long long lo = table[(long long)t * kRow + 6];
  const long long hi = t + 1 < n ? table[(long long)(t + 1) * kRow + 6]
                                 : chunks;
  const float s = ordered_sum(partials, lo, hi);
  if (threadIdx.x == 0) out[t] = s;
}

__global__ void __launch_bounds__(kThreads)
    sum_vector(const float* __restrict__ x, int n, float* __restrict__ out) {
  const float s = ordered_sum(x, 0, n);
  if (threadIdx.x == 0) *out = s;
}

// ---------------------------------------------------------------------------
// the update
// ---------------------------------------------------------------------------

struct Hyper {
  float lr, b1, a1, b2, a2, inv_b1c, inv_b2c, eps, wd;
};

// PyTorch's CUDA add(self, other, alpha): self + alpha * other, which its
// compiler contracts into one FMA (a multiply and an add round twice and
// break the bit-identity that tests/test_torch_cuda.py and chip_smoke.py
// hold).
__device__ __forceinline__ float add_alpha(float self, float alpha,
                                           float other) {
  return fmaf(alpha, other, self);
}

// One element: the new float32 p; m and v updated in place.
__device__ __forceinline__ float adamw_element(float p, float g, float& m,
                                               float& v, float scale,
                                               const Hyper& h, bool decay) {
  const float gs = __fmul_rn(g, scale);
  m = add_alpha(__fmul_rn(m, h.b1), h.a1, gs);
  v = add_alpha(__fmul_rn(v, h.b2), h.a2, __fmul_rn(gs, gs));
  const float denom = __fadd_rn(__fsqrt_rn(__fmul_rn(v, h.inv_b2c)), h.eps);
  float delta = __fdiv_rn(__fmul_rn(m, h.inv_b1c), denom);
  if (decay) delta = add_alpha(delta, h.wd, p);
  return __fsub_rn(p, __fmul_rn(h.lr, delta));
}

template <typename P, typename G>
__device__ void update_range(P* __restrict__ p, const G* __restrict__ g,
                             float* __restrict__ m, float* __restrict__ v,
                             long long lo, long long hi, float scale,
                             const Hyper& h, bool decay) {
  if (aligned16(p) && aligned16(g) && aligned16(m) && aligned16(v)) {
    const long long end = lo + (hi - lo) / kVec * kVec;
    for (long long i = lo + (long long)threadIdx.x * kVec; i < end;
         i += (long long)kThreads * kVec) {
      float pf[kVec], gf[kVec], mf[kVec], vf[kVec];
      load8(p, i, pf);
      load8(g, i, gf);
      load8(m, i, mf);
      load8(v, i, vf);
#pragma unroll
      for (int k = 0; k < kVec; ++k)
        pf[k] = adamw_element(pf[k], gf[k], mf[k], vf[k], scale, h, decay);
      store8(p, i, pf);
      store8(m, i, mf);
      store8(v, i, vf);
    }
    lo = end;
  }
  for (long long i = lo + threadIdx.x; i < hi; i += kThreads) {
    float mi = m[i], vi = v[i];
    const float pi = adamw_element(to_f32(p[i]), to_f32(g[i]), mi, vi, scale,
                                   h, decay);
    from_f32(pi, p + i);
    m[i] = mi;
    v[i] = vi;
  }
}

__global__ void __launch_bounds__(kThreads)
    adamw_chunks(const long long* __restrict__ table, int n, long long chunk,
                 const float* __restrict__ scale_ptr, Hyper h) {
  const long long c = blockIdx.x;
  const long long* row = table + (long long)tensor_of(table, n, c) * kRow;
  const long long lo = (c - row[6]) * chunk;
  const long long hi = lo + chunk < row[4] ? lo + chunk : row[4];
  const int flags = (int)row[5];
  const bool decay = flags & kDecay;
  const float scale = *scale_ptr;
  float* m = reinterpret_cast<float*>(row[2]);
  float* v = reinterpret_cast<float*>(row[3]);
  switch (flags & (kPBf16 | kGBf16)) {
    case 0:
      update_range(reinterpret_cast<float*>(row[0]),
                   reinterpret_cast<const float*>(row[1]), m, v, lo, hi,
                   scale, h, decay);
      break;
    case kPBf16:
      update_range(reinterpret_cast<bf16*>(row[0]),
                   reinterpret_cast<const float*>(row[1]), m, v, lo, hi,
                   scale, h, decay);
      break;
    case kGBf16:
      update_range(reinterpret_cast<float*>(row[0]),
                   reinterpret_cast<const bf16*>(row[1]), m, v, lo, hi,
                   scale, h, decay);
      break;
    default:
      update_range(reinterpret_cast<bf16*>(row[0]),
                   reinterpret_cast<const bf16*>(row[1]), m, v, lo, hi,
                   scale, h, decay);
  }
}

}  // namespace

// Each tensor's float32 sum of squares of g into out[0:n]: one block a
// chunk into partials[0:chunks], then one block a tensor.
extern "C" int adamw_sumsq(const long long* table, int n, long long chunk,
                           long long chunks, float* partials, float* out,
                           int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (int bad = check_plan(n, chunk, chunks)) return bad;
  if (n == 0) return 0;
  if (chunks > 0)
    sumsq_chunks<<<(unsigned)chunks, kThreads, 0, stream>>>(table, n, chunk,
                                                            partials);
  sumsq_tensors<<<(unsigned)n, kThreads, 0, stream>>>(table, n, chunks,
                                                      partials, out);
  return (int)cudaGetLastError();
}

// out = x[0] + ... + x[n-1] in float32, in a fixed order.
extern "C" int adamw_sum(const float* x, int n, float* out, int device,
                         cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n < 0) return (int)cudaErrorInvalidValue;
  sum_vector<<<1, kThreads, 0, stream>>>(x, n, out);
  return (int)cudaGetLastError();
}

// The update of every tensor of the table in place, the gradients scaled
// by *scale (read on the device).  a1 and a2 are the caller's 1 - b1 and
// 1 - b2 (rounded to float32 from the caller's own arithmetic, as
// PyTorch rounds an alpha); b1c and b2c the bias corrections.
extern "C" int adamw_update(const long long* table, int n, long long chunk,
                            long long chunks, const float* scale, float lr,
                            float b1, float a1, float b2, float a2, float b1c,
                            float b2c, float eps, float wd, int device,
                            cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (int bad = check_plan(n, chunk, chunks)) return bad;
  if (chunks == 0) return 0;
  // a division by a host scalar on CUDA multiplies by its reciprocal,
  // 1.0f / (float)b, taken on the host in float32
  const Hyper h{lr, b1, a1, b2, a2, 1.0f / b1c, 1.0f / b2c, eps, wd};
  adamw_chunks<<<(unsigned)chunks, kThreads, 0, stream>>>(table, n, chunk,
                                                          scale, h);
  return (int)cudaGetLastError();
}
