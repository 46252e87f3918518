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
// rest is a few KB a slot): at 4 slots zamba2's (4, 80, 64, 64) and
// mamba2's (4, 64, 128, 64), 10.5 and 16.8 MB, 3.1 and 5.0 us at 3.35
// TB/s; ~5 operations a state element.
//
// Design: the state in flight at once.  One block of 256 threads a
// (slot, group of heads), a group as many heads as make kRows = 4 float4s
// of state a thread (at least 1, at most kMaxGroup): a head a block at
// zamba2 and mamba2, 320 and 256 blocks at 4 slots (4 float4s ran
// 1.07-1.2x faster than 8, chip_kernel_shapes.py decode).  Each thread
// issues its first float4s of the group's state (4 columns of hd, rows a
// group stride apart) before anything else, so that they are in flight
// while the convolutions are read (mamba2's d_state 128 takes two such
// rounds).  y is summed over each thread's rows in order, then over the
// row groups in a fixed order in shared memory.  A block convolves its
// heads' x channels and shifts their buffer rows itself, and convolves
// every B and C channel for itself.  The B and C buffers are every
// head's, so the slot's last block to have read them shifts them: each
// block, once it has read them, adds one to its slot's counter; the block
// that brings it to the slot's block count writes the shifted rows (kept
// in its shared memory) and sets the counter back to 0, so that the next
// call (or a CUDA graph's next replay) starts from zero.  The counters
// (one an int a slot, zero before the first call) belong to one device
// and one stream of calls: two calls at once on two streams must not
// share them.  It replaces a cluster of 8 blocks a slot (32 blocks
// at 4 slots, each walking its 8-10 heads two at a time, a barrier round
// trip a pair): 0.0162 and 0.0161 ms at zamba2 and mamba2, 20-32% of the
// bound; now 0.0069-0.0092 ms, 38-58% (H100 80GB HBM3 at 700 W, 50 calls
// in a CUDA graph, chip_kernel_turns.py and chip_smoke.py).
#include "decode_step.cuh"

namespace {

constexpr int kSsdThreads = 256;
constexpr int kRows = 4;      // float4s of state a thread loads at once
constexpr int kMaxGroup = 8;  // heads a block
constexpr int kMaxK = 8;      // conv depth

template <typename T, typename TB>
struct Step {
  const T *z, *x, *Bv, *Cv, *dt, *dt_bias, *A_log, *D, *wx, *wB, *wC;
  TB *buf_x, *buf_B, *buf_C;
  float* h;
  T* y;
  int* counters;
  int nh, hd, ds, K, per;  // per: heads a block
};

// Channel c of one slot's depth-K conv: window = the buffer's K-1 rows
// (taken to T) then the new value; silu of the rounded sum, rounded.  The
// window stays in win: its rows 1 .. K-1 are the buffer's rows shifted up
// by one, each as the plain version's window holds it, the new value last.
template <typename T, typename TB>
__device__ __forceinline__ float conv_channel(const TB* buf, const T* val,
                                              const T* w, int C, int K,
                                              int c, float (&win)[kMaxK]) {
  float wk[kMaxK];
#pragma unroll
  for (int k = 0; k < kMaxK; ++k) {  // every load first
    if (k < K) {
      win[k] = k < K - 1 ? round_to<T>(to_f32(buf[(long long)k * C + c]))
                         : to_f32(val[c]);
      wk[k] = to_f32(w[(long long)k * C + c]);
    }
  }
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < kMaxK; ++k) {
    if (k < K) {
      const float prod = __fmul_rn(win[k], wk[k]);
      acc = k == 0 ? prod : __fadd_rn(acc, prod);
    }
  }
  return round_to<T>(silu(round_to<T>(acc)));
}

template <typename T, typename TB>
__global__ void __launch_bounds__(kSsdThreads)
    ssd_decode_kernel(Step<T, TB> st) {
  extern __shared__ float smem[];
  const int b = blockIdx.y, tid = threadIdx.x;
  const int nh = st.nh, hd = st.hd, ds = st.ds, K = st.K, per = st.per;
  const int di = nh * hd;
  const int h0 = blockIdx.x * per, n = min(per, nh - h0);  // this block's
  const int quads = hd / 4, groups = kSsdThreads / quads;
  float* Bs = smem;                    // ds, then C's ds
  float* Cs = Bs + ds;
  float* xs = Cs + ds;                 // per x hd
  float* dts = xs + per * hd;          // per
  float* as = dts + per;               // per
  float* red = as + per;               // per x groups x hd
  float* win = red + per * groups * hd;  // (K - 1) x 2 ds: B's, C's rows
  __shared__ int last;

  // the group's state as rows R = j ds + s (head j, state row s): this
  // thread 4 columns of hd and the rows R = grp + k groups.  Its first
  // kRows float4s, and z and D of its first output, are loaded before
  // anything else, so that they are in flight while the convolutions are
  // read
  const int q4 = tid % quads, grp = tid / quads;
  const int rows = grp < groups ? n * ds : 0;  // none past the groups
  float* hbase = st.h + ((long long)b * nh + h0) * ds * hd + 4 * q4;
  float4 hv[kRows];
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int R = grp + k * groups;
    if (R < rows)
      hv[k] = *reinterpret_cast<const float4*>(hbase + (long long)R * hd);
  }
  const long long out0 = (long long)b * di + (long long)h0 * hd + tid;
  float z0 = 0.0f, D0 = 0.0f;
  if (tid < n * hd) {
    z0 = to_f32(st.z[out0]);
    D0 = to_f32(st.D[h0 + tid / hd]);
  }

  // the prologue, one item a thread where it can: B's and C's channels
  // (convolved; their shifted rows kept for the slot's last block), this
  // block's x channels (convolved and shifted: no other block reads them),
  // its heads' dt and decay
  const T* xv = st.x + (long long)b * di;
  TB* bx = st.buf_x + (long long)b * (K - 1) * di;
  for (int i = tid; i < 2 * ds + n * hd + n; i += kSsdThreads) {
    float w[kMaxK];
    if (i < 2 * ds) {
      const bool isB = i < ds;
      const TB* buf = (isB ? st.buf_B : st.buf_C) + (long long)b * (K - 1) * ds;
      const T* val = (isB ? st.Bv : st.Cv) + (long long)b * ds;
      Bs[i] = conv_channel(buf, val, isB ? st.wB : st.wC, ds, K, i % ds, w);
#pragma unroll
      for (int k = 1; k < kMaxK; ++k)
        if (k < K) win[(k - 1) * 2 * ds + i] = w[k];
    } else if (i < 2 * ds + n * hd) {
      const int j = i - 2 * ds, c = h0 * hd + j;
      xs[j] = conv_channel(bx, xv, st.wx, di, K, c, w);
#pragma unroll
      for (int k = 1; k < kMaxK; ++k)
        if (k < K) bx[(long long)(k - 1) * di + c] = from_f32<TB>(w[k]);
    } else {
      const int j = i - 2 * ds - n * hd, hh = h0 + j;
      const float raw = __fadd_rn(to_f32(st.dt[(long long)b * nh + hh]),
                                  to_f32(st.dt_bias[hh]));
      const float dt = raw > 20.0f ? raw : log1pf(expf(raw));
      const float A = -expf(to_f32(st.A_log[hh]));
      dts[j] = dt;
      as[j] = expf(__fmul_rn(dt, A));
    }
  }
  for (int i = tid; i < n * groups * hd; i += kSsdThreads) red[i] = 0.0f;
  __syncthreads();
  // the B and C buffers are read: count this block in; the slot's last
  // block shifts them at its end (the count's answer is waited for there)
  int done = 0;
  if (tid == 0) {
    __threadfence();
    done = atomicAdd(st.counters + b, 1);
  }

  // h = h a + B (dt x) and the y sums, kept per head in row order, the
  // next kRows float4s loaded before any of them is used
  float yp[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  int jy = rows > 0 ? grp / ds : 0;   // the head yp sums
  for (int R0 = grp; R0 < rows; R0 += kRows * groups) {
    if (R0 > grp) {
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        const int R = R0 + k * groups;
        if (R < rows)
          hv[k] = *reinterpret_cast<const float4*>(hbase + (long long)R * hd);
      }
    }
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const int R = R0 + k * groups;
      if (R < rows) {
        const int j = R / ds, s = R - j * ds;
        if (j != jy) {  // the sums of head jy are whole
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            red[(jy * groups + grp) * hd + 4 * q4 + e] = yp[e];
            yp[e] = 0.0f;
          }
          jy = j;
        }
        const float dt = dts[j], a = as[j], Bs_ = Bs[s], Cs_ = Cs[s];
        const float* xq = xs + j * hd + 4 * q4;
        float4 hq = hv[k];
        float* he = &hq.x;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          he[e] = __fadd_rn(__fmul_rn(he[e], a),
                            __fmul_rn(Bs_, __fmul_rn(dt, xq[e])));
          yp[e] = __fadd_rn(yp[e], __fmul_rn(Cs_, he[e]));
        }
        *reinterpret_cast<float4*>(hbase + (long long)R * hd) = hq;
      }
    }
  }
  if (rows > 0) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      red[(jy * groups + grp) * hd + 4 * q4 + e] = yp[e];
  }
  if (tid == 0) last = done == gridDim.x - 1;
  __syncthreads();
  for (int i = tid; i < n * hd; i += kSsdThreads) {
    const int j = i / hd, e = i % hd, hh = h0 + j;
    float sum = 0.0f;
    for (int g = 0; g < groups; ++g)
      sum = __fadd_rn(sum, red[(j * groups + g) * hd + e]);
    const long long c = out0 - tid + i;
    const float z = i == tid ? z0 : to_f32(st.z[c]);
    const float D = i == tid ? D0 : to_f32(st.D[hh]);
    const float yv = round_to<T>(__fadd_rn(sum, __fmul_rn(xs[i], D)));
    const float zs = round_to<T>(silu(z));
    st.y[c] = from_f32<T>(__fmul_rn(yv, zs));
  }
  if (last) {  // every block of the slot has read the B and C buffers
    TB* bB = st.buf_B + (long long)b * (K - 1) * ds;
    TB* bC = st.buf_C + (long long)b * (K - 1) * ds;
    for (int i = tid; i < (K - 1) * 2 * ds; i += kSsdThreads) {
      const int k = i / (2 * ds), c = i % (2 * ds);
      (c < ds ? bB : bC)[(long long)k * ds + c % ds] =
          from_f32<TB>(win[k * 2 * ds + c]);
    }
    if (tid == 0) st.counters[b] = 0;
  }
}

// heads a block: enough for kRows float4s of state a thread
int heads_a_block(int nh, int hd, int ds) {
  const int fit = kRows * kSsdThreads * 4 / (ds * hd);
  return max(1, min(min(fit, kMaxGroup), nh));
}

int smem_floats(int nh, int hd, int ds, int K) {
  const int per = heads_a_block(nh, hd, ds);
  return 2 * ds + per * hd + 2 * per + per * (kSsdThreads / (hd / 4)) * hd +
         (K - 1) * 2 * ds;
}

template <typename T, typename TB>
int launch(const void* const* in, void* buf_x, void* buf_B, void* buf_C,
           float* h, void* y, int* counters, int B, int nh, int hd, int ds,
           int K, cudaStream_t stream) {
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
  st.counters = counters;
  st.nh = nh;
  st.hd = hd;
  st.ds = ds;
  st.K = K;
  st.per = heads_a_block(nh, hd, ds);
  const size_t smem = sizeof(float) * smem_floats(nh, hd, ds, K);
  const int blocks = (nh + st.per - 1) / st.per;
  ssd_decode_kernel<T, TB><<<dim3(blocks, B), kSsdThreads, smem, stream>>>(
      st);
  return (int)cudaGetLastError();
}

}  // namespace

// One decode token of a Mamba2 layer for B slots.  z, x (B, nh*hd), B, C
// (B, ds), dt (B, nh) in `dtype` (0 float32, 1 bf16), and the layer's
// dt_bias, A_log, D (nh) and conv weights (K, nh*hd), (K, ds), (K, ds) in
// the same dtype; the conv buffers (B, K-1, nh*hd), (B, K-1, ds) x 2 in
// buf_dtype, shifted in place; the float32 state h (B, nh, ds, hd) updated
// in place; y (B, nh*hd) written, y = (C . h + D x) * silu(z).  counters:
// B ints, 0 before the call and after it (the kernel sets them back).
extern "C" int ssd_decode_step(const void* z, const void* x, const void* Bv,
                               const void* Cv, const void* dt,
                               const void* dt_bias, const void* A_log,
                               const void* D, const void* conv_x,
                               const void* conv_B, const void* conv_C,
                               void* buf_x, void* buf_B, void* buf_C,
                               float* h, void* y, int* counters,
                               int dtype, int buf_dtype,
                               int B, int nh, int hd, int ds, int K,
                               int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B < 0 || nh <= 0 || hd <= 0 || hd % 4 || hd / 4 > kSsdThreads ||
      ds <= 0 || K < 2 || K > kMaxK || counters == nullptr ||
      sizeof(float) * smem_floats(nh, hd, ds, K) > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const void* in[11] = {z, x, Bv, Cv, dt, dt_bias, A_log, D, conv_x, conv_B,
                        conv_C};
  if (dtype == kF32 && buf_dtype == kF32)
    return launch<float, float>(in, buf_x, buf_B, buf_C, h, y, counters,
                                B, nh, hd, ds, K, stream);
  if (dtype == kF32 && buf_dtype == kBf16)
    return launch<float, bf16>(in, buf_x, buf_B, buf_C, h, y, counters,
                               B, nh, hd, ds, K, stream);
  if (dtype == kBf16 && buf_dtype == kF32)
    return launch<bf16, float>(in, buf_x, buf_B, buf_C, h, y, counters,
                               B, nh, hd, ds, K, stream);
  if (dtype == kBf16 && buf_dtype == kBf16)
    return launch<bf16, bf16>(in, buf_x, buf_B, buf_C, h, y, counters,
                              B, nh, hd, ds, K, stream);
  return (int)cudaErrorInvalidValue;
}
