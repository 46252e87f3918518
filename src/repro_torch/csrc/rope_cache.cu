// Rotary embedding of one decode step's q and k at the step's position,
// and the cache write of the rotated k and of v, in one launch a layer.
//
// Replaces no TPU kernel: the JAX engine jits its whole decode step
// (src/repro/runtime/serve.py:83-84) and XLA fuses apply_rope
// (src/repro/models/layers.py:141) on q and k and update_cache's
// dynamic_update_slice (src/repro/models/attention.py:246).  Eagerly, the
// port rebuilt the frequency table at every call and ran ~34 device
// operations a layer for the rotations and 3 for the write.  Plain
// version: kernels/ref.py rope_cache_ref.
//
// The angles are pos * freqs[i] with freqs the float32 table the model
// computed once with rope_frequencies (models/layers.py), so they are the
// plain expression's bits; cosf and sinf without fast math; each product
// and sum of the rotation rounded on its own, as the plain version's
// tensors round them.  The cache row is pos modulo the rows of a rolling
// cache, then clamped into the rows, as update_cache and the reference's
// dynamic_update_slice clamp it.  Without a table (a model without rope)
// the launch only writes the cache.
//
// Bound on the card: the launch (a few KB at decode); bytes beyond that.
// One block a (q or kv head, slot).
#include "decode_step.cuh"

namespace {

constexpr int kRopeThreads = 128;

// x[i], x[i + half] rotated by the angle of frequency i.
__device__ __forceinline__ void rotate(float x1, float x2, float posf,
                                       float freq, float* o1, float* o2) {
  const float a = __fmul_rn(posf, freq);
  const float c = cosf(a), s = sinf(a);
  *o1 = __fsub_rn(__fmul_rn(x1, c), __fmul_rn(x2, s));
  *o2 = __fadd_rn(__fmul_rn(x1, s), __fmul_rn(x2, c));
}

template <typename T, typename C>
__global__ void __launch_bounds__(kRopeThreads)
    rope_cache_write_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, T* __restrict__ q_out,
                            C* __restrict__ k_cache, C* __restrict__ v_cache,
                            const float* __restrict__ freqs,
                            const long long* __restrict__ pos_ptr,
                            long long pos_arg, int H, int KV, int S, int hd,
                            int rolling) {
  const long long pos = position(pos_ptr, pos_arg);
  const float posf = __ll2float_rn(pos);
  const int b = blockIdx.y, half = hd / 2;
  const int q_heads = freqs != nullptr ? H : 0;
  if ((int)blockIdx.x < q_heads) {
    const long long at = ((long long)b * H + blockIdx.x) * hd;
    for (int i = threadIdx.x; i < half; i += kRopeThreads) {
      float o1, o2;
      rotate(to_f32(q[at + i]), to_f32(q[at + i + half]), posf, freqs[i],
             &o1, &o2);
      q_out[at + i] = from_f32<T>(o1);
      q_out[at + i + half] = from_f32<T>(o2);
    }
    return;
  }
  const int kvh = blockIdx.x - q_heads;
  long long row = rolling ? pos % S : pos;
  if (row < 0) row = rolling ? row + S : 0;
  if (row > S - 1) row = S - 1;
  const long long src = ((long long)b * KV + kvh) * hd;
  const long long dst = (((long long)b * S + row) * KV + kvh) * hd;
  if (freqs != nullptr) {
    for (int i = threadIdx.x; i < half; i += kRopeThreads) {
      float o1, o2;
      rotate(to_f32(k[src + i]), to_f32(k[src + i + half]), posf, freqs[i],
             &o1, &o2);
      // rounded to k's dtype first, as apply_rope returns it
      k_cache[dst + i] = from_f32<C>(round_to<T>(o1));
      k_cache[dst + i + half] = from_f32<C>(round_to<T>(o2));
    }
  } else {
    for (int i = threadIdx.x; i < hd; i += kRopeThreads)
      k_cache[dst + i] = from_f32<C>(to_f32(k[src + i]));
  }
  for (int i = threadIdx.x; i < hd; i += kRopeThreads)
    v_cache[dst + i] = from_f32<C>(to_f32(v[src + i]));
}

template <typename T, typename C>
int launch(const void* q, const void* k, const void* v, void* q_out,
           void* k_cache, void* v_cache, const float* freqs,
           const long long* pos_ptr, long long pos, int B, int H, int KV,
           int S, int hd, int rolling, cudaStream_t stream) {
  const dim3 grid((freqs != nullptr ? H : 0) + KV, B);
  rope_cache_write_kernel<T, C><<<grid, kRopeThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(q_out),
      static_cast<C*>(k_cache), static_cast<C*>(v_cache), freqs, pos_ptr,
      pos, H, KV, S, hd, rolling);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, H, hd) rotated into q_out and k (B, KV, hd) rotated into row
// `pos` of k_cache (B, S, KV, hd), v into v_cache's row, at the position
// *pos_ptr (an int64 on the device) or, with pos_ptr NULL, `pos`; the row
// is pos mod S where `rolling`, clamped into [0, S).  freqs (hd/2 float32)
// NULL: no rotation, q_out untouched.  dtype is q's, k's and v's,
// cache_dtype the caches' (0 float32, 1 bf16).
extern "C" int rope_cache_write(const void* q, const void* k, const void* v,
                                void* q_out, void* k_cache, void* v_cache,
                                const float* freqs, const long long* pos_ptr,
                                long long pos, int dtype, int cache_dtype,
                                int B, int H, int KV, int S, int hd,
                                int rolling, int device,
                                cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B < 0 || H <= 0 || KV <= 0 || S <= 0 || hd <= 0 || hd % 2)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  if (dtype == kF32 && cache_dtype == kF32)
    return launch<float, float>(q, k, v, q_out, k_cache, v_cache, freqs,
                                pos_ptr, pos, B, H, KV, S, hd, rolling,
                                stream);
  if (dtype == kF32 && cache_dtype == kBf16)
    return launch<float, bf16>(q, k, v, q_out, k_cache, v_cache, freqs,
                               pos_ptr, pos, B, H, KV, S, hd, rolling, stream);
  if (dtype == kBf16 && cache_dtype == kF32)
    return launch<bf16, float>(q, k, v, q_out, k_cache, v_cache, freqs,
                               pos_ptr, pos, B, H, KV, S, hd, rolling, stream);
  if (dtype == kBf16 && cache_dtype == kBf16)
    return launch<bf16, bf16>(q, k, v, q_out, k_cache, v_cache, freqs,
                              pos_ptr, pos, B, H, KV, S, hd, rolling, stream);
  return (int)cudaErrorInvalidValue;
}
