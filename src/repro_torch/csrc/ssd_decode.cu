// The Mamba2 recurrent step of one decode token, between the layer's
// projections and its gated norm, in one launch a layer.
//
// Replaces no TPU kernel: the JAX engine jits its whole decode step
// (src/repro/runtime/serve.py:83-84) and XLA fuses ssd_decode
// (src/repro/models/ssm.py:163) past its projections.  Eagerly, the port
// ran ~32 device operations a layer there and four cache copies after it.
// Plain version: kernels/ref.py ssd_decode_step_ref, whose every rounding
// this kernel repeats:
//   dt = softplus(dt_raw + dt_bias), PyTorch's threshold of 20;
//   the depth-K causal convolutions of x, B and C over the bf16 conv
//     buffers (window = buffer rows then the new value, each in the
//     activations' dtype), summed k = 0 .. K-1 in float32 one rounded
//     product and sum at a time, rounded to the activations' dtype, silu,
//     rounded again; the buffers shifted one row in place;
//   a = exp(dt * -exp(A_log)); h = h * a + B (dt x) on the float32 state
//     in place (the cache's own tensor: no copy);
//   y = C . h + D x, rounded, times silu(z) rounded, rounded.
// Only the convolutions' outputs are rounded to bf16 before they reach
// the float32 state, so they are computed in the plain version's order
// and come out the same bits; the rest differs from it by float32
// rounding order alone.
//
// Bound on the card: bytes, the float32 state read and written once (the
// rest is a few KB a slot); ~5 operations a state element.
//
// Design: a cluster of kCluster blocks a slot, each taking a contiguous
// run of the heads: the x channels of its heads (convolved and shifted by
// their own block), and every B and C channel, which each block convolves
// for itself.  The B and C buffers are shared by all heads, so they are
// shifted by the cluster's first block after a cluster barrier, once every
// block of the slot has read them.  A block walks its heads two at a
// time, 256 threads a head as (4 columns of hd, a group of state rows),
// each thread's state rows loaded before any is updated (the loads
// overlap), y summed over the groups in a fixed order.
#include <cooperative_groups.h>

#include "decode_step.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kHeadThreads = 256;                // threads a head
constexpr int kSsdThreads = 2 * kHeadThreads;     // two heads at a time
constexpr int kRows = 8;     // state rows a thread loads before using them
constexpr int kCluster = 8;
constexpr int kMaxK = 8;     // conv depth

template <typename T, typename TB>
struct Step {
  const T *z, *x, *Bv, *Cv, *dt, *dt_bias, *A_log, *D, *wx, *wB, *wC;
  TB *buf_x, *buf_B, *buf_C;
  float* h;
  T* y;
  int nh, hd, ds, K;
};

// Channel c of one slot's depth-K conv: window = the buffer's K-1 rows
// (taken to T) then the new value; silu of the rounded sum, rounded.
template <typename T, typename TB>
__device__ __forceinline__ float conv_channel(const TB* buf, const T* val,
                                              const T* w, int C, int K,
                                              int c) {
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < kMaxK; ++k) {
    if (k < K) {
      const float v = k < K - 1
                          ? round_to<T>(to_f32(buf[(long long)k * C + c]))
                          : to_f32(val[c]);
      const float prod = __fmul_rn(v, to_f32(w[(long long)k * C + c]));
      acc = k == 0 ? prod : __fadd_rn(acc, prod);
    }
  }
  return round_to<T>(silu(round_to<T>(acc)));
}

// The buffer's rows shifted up by one in place, the new value last, each
// row as the plain version's window holds it (taken to T, then back).
template <typename T, typename TB>
__device__ __forceinline__ void shift_channel(TB* buf, const T* val, int C,
                                              int K, int c) {
  for (int k = 0; k + 1 < K - 1; ++k)
    buf[(long long)k * C + c] =
        from_f32<TB>(round_to<T>(to_f32(buf[(long long)(k + 1) * C + c])));
  buf[(long long)(K - 2) * C + c] = from_f32<TB>(to_f32(val[c]));
}

template <typename T, typename TB>
__global__ void __cluster_dims__(kCluster, 1, 1)
    __launch_bounds__(kSsdThreads) ssd_decode_kernel(Step<T, TB> st) {
  extern __shared__ float smem[];
  const int rank = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int nh = st.nh, hd = st.hd, ds = st.ds, K = st.K;
  const int di = nh * hd;
  const int per = (nh + kCluster - 1) / kCluster;
  const int h0 = min(rank * per, nh), h1 = min(h0 + per, nh);
  float* Bs = smem;                    // ds
  float* Cs = Bs + ds;                 // ds
  float* xs = Cs + ds;                 // per x hd
  float* dts = xs + per * hd;          // per
  float* as = dts + per;               // per
  float* red = as + per;               // 2 x groups x hd

  // this slot's rows of the inputs and buffers
  const T* Bv = st.Bv + (long long)b * ds;
  const T* Cv = st.Cv + (long long)b * ds;
  const T* xv = st.x + (long long)b * di;
  TB* bB = st.buf_B + (long long)b * (K - 1) * ds;
  TB* bC = st.buf_C + (long long)b * (K - 1) * ds;
  TB* bx = st.buf_x + (long long)b * (K - 1) * di;
  for (int c = tid; c < ds; c += kSsdThreads) {
    Bs[c] = conv_channel(bB, Bv, st.wB, ds, K, c);
    Cs[c] = conv_channel(bC, Cv, st.wC, ds, K, c);
  }
  for (int i = tid; i < (h1 - h0) * hd; i += kSsdThreads) {
    const int c = h0 * hd + i;
    xs[i] = conv_channel(bx, xv, st.wx, di, K, c);
    shift_channel(bx, xv, di, K, c);     // this block's channels alone
  }
  for (int j = tid; j < h1 - h0; j += kSsdThreads) {
    const int hh = h0 + j;
    const float raw = __fadd_rn(to_f32(st.dt[(long long)b * nh + hh]),
                                to_f32(st.dt_bias[hh]));
    const float dt = raw > 20.0f ? raw : log1pf(expf(raw));
    const float A = -expf(to_f32(st.A_log[hh]));
    dts[j] = dt;
    as[j] = expf(__fmul_rn(dt, A));
  }
  __syncthreads();

  // two heads at a time, kHeadThreads threads each: (4 columns of hd, a
  // group of state rows), a thread's rows loaded before any is used
  const int pair = tid / kHeadThreads, t = tid % kHeadThreads;
  const int quads = hd / 4, groups = kHeadThreads / quads;
  const int q4 = t % quads, grp = t / quads;
  float* red_h = red + pair * groups * hd;
  for (int hp = h0; hp < h1; hp += 2) {
    const int hh = hp + pair, j = hh - h0;
    if (hh < h1 && grp < groups) {
      const float dt = dts[j], a = as[j];
      float xdt[4], yp[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        xdt[e] = __fmul_rn(dt, xs[j * hd + 4 * q4 + e]);
      float* hrow = st.h + (((long long)b * nh + hh) * ds) * hd + 4 * q4;
      for (int s0 = grp; s0 < ds; s0 += kRows * groups) {
        float4 hv[kRows];
#pragma unroll
        for (int k = 0; k < kRows; ++k) {
          const int s = s0 + k * groups;
          if (s < ds)
            hv[k] = *reinterpret_cast<float4*>(hrow + (long long)s * hd);
        }
#pragma unroll
        for (int k = 0; k < kRows; ++k) {
          const int s = s0 + k * groups;
          if (s < ds) {
            const float Bs_ = Bs[s], Cs_ = Cs[s];
            float* hq = &hv[k].x;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              hq[e] = __fadd_rn(__fmul_rn(hq[e], a), __fmul_rn(Bs_, xdt[e]));
              yp[e] = __fadd_rn(yp[e], __fmul_rn(Cs_, hq[e]));
            }
            *reinterpret_cast<float4*>(hrow + (long long)s * hd) = hv[k];
          }
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) red_h[grp * hd + 4 * q4 + e] = yp[e];
    }
    __syncthreads();
    for (int i = tid; i < 2 * hd; i += kSsdThreads) {
      const int hh2 = hp + i / hd, e = i % hd, j2 = hh2 - h0;
      if (hh2 >= h1) continue;
      const float* rr = red + (i / hd) * groups * hd;
      float sum = 0.0f;
      for (int g = 0; g < groups; ++g) sum = __fadd_rn(sum, rr[g * hd + e]);
      const long long c = (long long)b * di + (long long)hh2 * hd + e;
      const float yv = round_to<T>(__fadd_rn(
          sum, __fmul_rn(xs[j2 * hd + e], to_f32(st.D[hh2]))));
      const float zs = round_to<T>(silu(to_f32(st.z[c])));
      st.y[c] = from_f32<T>(__fmul_rn(yv, zs));
    }
    __syncthreads();  // red is taken again by the next pair of heads
  }

  // every block of the slot has read the B and C buffers: shift them
  cg::this_cluster().sync();
  if (rank == 0) {
    for (int c = tid; c < ds; c += kSsdThreads) {
      shift_channel(bB, Bv, ds, K, c);
      shift_channel(bC, Cv, ds, K, c);
    }
  }
}

int smem_floats(int nh, int hd, int ds) {
  const int per = (nh + kCluster - 1) / kCluster;
  return 2 * ds + per * hd + 2 * per + 2 * (kHeadThreads / (hd / 4)) * hd;
}

template <typename T, typename TB>
int launch(const void* const* in, void* buf_x, void* buf_B, void* buf_C,
           float* h, void* y, int B, int nh, int hd, int ds, int K,
           cudaStream_t stream) {
  Step<T, TB> st;
  st.z = static_cast<const T*>(in[0]);
  st.x = static_cast<const T*>(in[1]);
  st.Bv = static_cast<const T*>(in[2]);
  st.Cv = static_cast<const T*>(in[3]);
  st.dt = static_cast<const T*>(in[4]);
  st.dt_bias = static_cast<const T*>(in[5]);
  st.A_log = static_cast<const T*>(in[6]);
  st.D = static_cast<const T*>(in[7]);
  st.wx = static_cast<const T*>(in[8]);
  st.wB = static_cast<const T*>(in[9]);
  st.wC = static_cast<const T*>(in[10]);
  st.buf_x = static_cast<TB*>(buf_x);
  st.buf_B = static_cast<TB*>(buf_B);
  st.buf_C = static_cast<TB*>(buf_C);
  st.h = h;
  st.y = static_cast<T*>(y);
  st.nh = nh;
  st.hd = hd;
  st.ds = ds;
  st.K = K;
  const size_t smem = sizeof(float) * smem_floats(nh, hd, ds);
  ssd_decode_kernel<T, TB><<<dim3(kCluster, B), kSsdThreads, smem,
                              stream>>>(st);
  return (int)cudaGetLastError();
}

}  // namespace

// One decode token of a Mamba2 layer for B slots.  z, x (B, nh*hd), B, C
// (B, ds), dt (B, nh) in `dtype` (0 float32, 1 bf16), and the layer's
// dt_bias, A_log, D (nh) and conv weights (K, nh*hd), (K, ds), (K, ds) in
// the same dtype; the conv buffers (B, K-1, nh*hd), (B, K-1, ds) x 2 in
// buf_dtype, shifted in place; the float32 state h (B, nh, ds, hd) updated
// in place; y (B, nh*hd) written, y = (C . h + D x) * silu(z).
extern "C" int ssd_decode_step(const void* z, const void* x, const void* Bv,
                               const void* Cv, const void* dt,
                               const void* dt_bias, const void* A_log,
                               const void* D, const void* conv_x,
                               const void* conv_B, const void* conv_C,
                               void* buf_x, void* buf_B, void* buf_C,
                               float* h, void* y, int dtype, int buf_dtype,
                               int B, int nh, int hd, int ds, int K,
                               int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B < 0 || nh <= 0 || hd <= 0 || hd % 4 || hd / 4 > kHeadThreads ||
      ds <= 0 || K < 2 || K > kMaxK ||
      sizeof(float) * smem_floats(nh, hd, ds) > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const void* in[11] = {z, x, Bv, Cv, dt, dt_bias, A_log, D, conv_x, conv_B,
                        conv_C};
  if (dtype == kF32 && buf_dtype == kF32)
    return launch<float, float>(in, buf_x, buf_B, buf_C, h, y, B, nh, hd, ds,
                                K, stream);
  if (dtype == kF32 && buf_dtype == kBf16)
    return launch<float, bf16>(in, buf_x, buf_B, buf_C, h, y, B, nh, hd, ds,
                               K, stream);
  if (dtype == kBf16 && buf_dtype == kF32)
    return launch<bf16, float>(in, buf_x, buf_B, buf_C, h, y, B, nh, hd, ds,
                               K, stream);
  if (dtype == kBf16 && buf_dtype == kBf16)
    return launch<bf16, bf16>(in, buf_x, buf_B, buf_C, h, y, B, nh, hd, ds,
                              K, stream);
  return (int)cudaErrorInvalidValue;
}
