// ssd_scan: the Mamba2 chunked SSD (state-space duality) recurrence.  For
// each chunk of Q positions, with cum = cumsum(dt * A) over the chunk:
//   y[q]  = sum_{k<=q} (C[q].B[k]) exp(cum[q]-cum[k]) dt[k] x[k]
//           + exp(cum[q]) C[q].h
//   h    <- exp(cum[Q-1]) h + sum_k B[k] (x) exp(cum[Q-1]-cum[k]) dt[k] x[k]
// x / B / C float32 or bfloat16, dt / A / h float32; float32 arithmetic;
// y in x's dtype.
//
// Replaces src/repro/kernels/ssd_scan.py:ssd_scan (Pallas body _ssd_kernel),
// and with it the chunk loop of the JAX models' ssd_prefill, which computes
// the same function.  Bound on the card: per chunk and head the work is
// about Q*Q*(ds + hd) + 2*Q*ds*hd FMAs (C.B^T is recomputed by every head's
// block) on Q*(hd + 2*ds + 1) inputs: a few hundred FLOP per byte at Q 256,
// so it is bounded by operations, done here as FP32 FMAs on the CUDA cores.
//
// Design.  Heads are independent: one block of 256 threads per (batch,
// head).  The head's (ds x hd) float32 state lives in shared memory across
// a sequential loop over the chunks — the Marrow Loop with device-resident
// state that the TPU kernel's docstring describes, whose sequential grid
// dimension becomes the loop inside the block.  Within a chunk: a warp scan
// gives cum; then for each tile of 64 query rows the block stages C, starts
// the output from the carried-state term, and for each tile of 64 key rows
// at or below it stages B and dt*x, forms the masked-decay tile
// (C.B^T)*exp(cum_q - cum_k) in shared memory and accumulates it times
// dt*x in registers; last, the state update runs over the key tiles with
// dt*x scaled by the decay to the chunk's end.  Above the diagonal
// exp(cum_q - cum_k) overflows, so those entries are selected to 0, never
// multiplied by a mask.  Any chunk from 1 to 256 works (the ragged tail of
// a prompt is a chunk of its own); tiles past the chunk are zero-filled.
// One block per head leaves SMs idle at batch 1 (80 heads on 132 SMs) and
// recomputes C.B^T once per head: costs for a later change.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;        // query rows and key rows per tile
constexpr int kMaxChunk = 256;   // = kThreads: one position per thread
constexpr int kMaxDim = 128;     // head_dim and d_state, multiples of 16
constexpr int kMaxCols = kMaxDim / 16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

size_t smem_bytes(int hd, int ds) {
  return sizeof(float) *
         (size_t)(ds * (hd + 1) + 2 * kTile * (ds + 1) + kTile * (hd + 1) +
                  kTile * (kTile + 1) + kMaxChunk + kThreads / 32);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
               const T* __restrict__ Bm, const T* __restrict__ Cm,
               const float* __restrict__ A, const float* __restrict__ h0,
               T* __restrict__ y, float* __restrict__ h_out, int S, int nh,
               int hd, int ds, int chunk) {
  const int LH = hd + 1, LS = ds + 1, LX = hd + 1, LP = kTile + 1;
  extern __shared__ float smem[];
  float* Hs = smem;                  // ds x LH   state at the chunk's start
  float* Cs = Hs + ds * LH;          // kTile x LS  C rows of the query tile
  float* Bs = Cs + kTile * LS;       // kTile x LS  B rows of the key tile
  float* Xs = Bs + kTile * LS;       // kTile x LX  dt*x rows of the key tile
  float* Ps = Xs + kTile * LX;       // kTile x LP  masked-decay tile
  float* cum = Ps + kTile * LP;      // kMaxChunk
  float* warp_sum = cum + kMaxChunk; // kThreads / 32

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;   // 16 x 16 thread grid
  const int h = blockIdx.x, b = blockIdx.y;
  const int dih = nh * hd;
  const int nj = hd / 16;                   // output columns per thread
  const int ni = ds / 16;                   // state rows per thread
  const float a = A[h];
  const long long row0 = (long long)b * S;  // first row of this batch

  for (int i = tid; i < ds * hd; i += kThreads) {
    int s = i / hd, e = i % hd;
    Hs[s * LH + e] =
        h0 ? h0[(((long long)b * nh + h) * ds + s) * hd + e] : 0.0f;
  }

  for (int t0 = 0; t0 < S; t0 += chunk) {
    __syncthreads();  // Hs written; the last chunk is done with cum
    // cum: inclusive scan of dt * A over the chunk (one position a thread)
    {
      float la = tid < chunk ? dt[(row0 + t0 + tid) * nh + h] * a : 0.0f;
      const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        float n = __shfl_up_sync(0xffffffffu, la, off);
        if (lane >= off) la += n;
      }
      if (lane == 31) warp_sum[warp] = la;
      __syncthreads();
      for (int w = 0; w < warp; ++w) la += warp_sum[w];
      cum[tid] = la;
      __syncthreads();
    }
    const float cum_last = cum[chunk - 1];

    // ---- outputs, one tile of query rows at a time ----------------------
    for (int q0 = 0; q0 < chunk; q0 += kTile) {
      for (int i = tid; i < kTile * ds; i += kThreads) {
        int r = i / ds, s = i % ds;
        Cs[r * LS + s] = q0 + r < chunk
                             ? to_f32(Cm[(row0 + t0 + q0 + r) * ds + s])
                             : 0.0f;
      }
      __syncthreads();
      // carried-state term: exp(cum_q) * C[q] . h
      float acc[4][kMaxCols];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kMaxCols; ++j) acc[i][j] = 0.0f;
      for (int s = 0; s < ds; ++s) {
        float cv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = Cs[(ty * 4 + i) * LS + s];
#pragma unroll
        for (int j = 0; j < kMaxCols; ++j) {
          if (j < nj) {
            float hv = Hs[s * LH + tx + 16 * j];
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[i][j] += cv[i] * hv;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float eq = expf(cum[q0 + ty * 4 + i]);
#pragma unroll
        for (int j = 0; j < kMaxCols; ++j) acc[i][j] *= eq;
      }
      // within-chunk term, key tiles at or below the query tile
      for (int k0 = 0; k0 <= q0; k0 += kTile) {
        __syncthreads();  // the last tile's readers of Bs / Xs / Ps are done
        for (int i = tid; i < kTile * ds; i += kThreads) {
          int r = i / ds, s = i % ds;
          Bs[r * LS + s] = k0 + r < chunk
                               ? to_f32(Bm[(row0 + t0 + k0 + r) * ds + s])
                               : 0.0f;
        }
        for (int i = tid; i < kTile * hd; i += kThreads) {
          int r = i / hd, e = i % hd;
          float val = 0.0f;
          if (k0 + r < chunk) {
            long long row = row0 + t0 + k0 + r;
            val = to_f32(x[row * dih + (long long)h * hd + e]) *
                  dt[row * nh + h];
          }
          Xs[r * LX + e] = val;
        }
        __syncthreads();
        // Ps[q][k] = C[q].B[k] * exp(cum_q - cum_k), k <= q; else 0
        {
          float g[4][4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) g[i][j] = 0.0f;
          for (int s = 0; s < ds; ++s) {
            float cv[4], bv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) cv[i] = Cs[(ty * 4 + i) * LS + s];
#pragma unroll
            for (int j = 0; j < 4; ++j) bv[j] = Bs[(tx + 16 * j) * LS + s];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j) g[i][j] += cv[i] * bv[j];
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            int qg = q0 + ty * 4 + i;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              int kg = k0 + tx + 16 * j;
              Ps[(ty * 4 + i) * LP + tx + 16 * j] =
                  (kg <= qg && qg < chunk)
                      ? g[i][j] * expf(cum[qg] - cum[kg])
                      : 0.0f;
            }
          }
        }
        __syncthreads();
        // acc += Ps . Xs
        for (int kk = 0; kk < kTile; ++kk) {
          float pv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty * 4 + i) * LP + kk];
#pragma unroll
          for (int j = 0; j < kMaxCols; ++j) {
            if (j < nj) {
              float xv = Xs[kk * LX + tx + 16 * j];
#pragma unroll
              for (int i = 0; i < 4; ++i) acc[i][j] += pv[i] * xv;
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        int q = q0 + ty * 4 + i;
        if (q >= chunk) continue;
        T* yrow = y + (row0 + t0 + q) * dih + (long long)h * hd;
#pragma unroll
        for (int j = 0; j < kMaxCols; ++j)
          if (j < nj) store(yrow + tx + 16 * j, acc[i][j]);
      }
    }

    // ---- state update ----------------------------------------------------
    float hn[kMaxCols][kMaxCols];  // rows ty + 16*i of ds, cols tx + 16*j
#pragma unroll
    for (int i = 0; i < kMaxCols; ++i)
#pragma unroll
      for (int j = 0; j < kMaxCols; ++j) hn[i][j] = 0.0f;
    for (int k0 = 0; k0 < chunk; k0 += kTile) {
      __syncthreads();
      for (int i = tid; i < kTile * ds; i += kThreads) {
        int r = i / ds, s = i % ds;
        Bs[r * LS + s] = k0 + r < chunk
                             ? to_f32(Bm[(row0 + t0 + k0 + r) * ds + s])
                             : 0.0f;
      }
      for (int i = tid; i < kTile * hd; i += kThreads) {
        int r = i / hd, e = i % hd;
        float val = 0.0f;
        if (k0 + r < chunk) {
          long long row = row0 + t0 + k0 + r;
          val = to_f32(x[row * dih + (long long)h * hd + e]) *
                dt[row * nh + h] * expf(cum_last - cum[k0 + r]);
        }
        Xs[r * LX + e] = val;
      }
      __syncthreads();
      for (int kk = 0; kk < kTile; ++kk) {
        float xv[kMaxCols];
#pragma unroll
        for (int j = 0; j < kMaxCols; ++j)
          xv[j] = j < nj ? Xs[kk * LX + tx + 16 * j] : 0.0f;
#pragma unroll
        for (int i = 0; i < kMaxCols; ++i) {
          if (i < ni) {
            float bv = Bs[kk * LS + ty + 16 * i];
#pragma unroll
            for (int j = 0; j < kMaxCols; ++j) hn[i][j] += bv * xv[j];
          }
        }
      }
    }
    __syncthreads();  // every reader of the chunk's starting state is done
    const float decay = expf(cum_last);
#pragma unroll
    for (int i = 0; i < kMaxCols; ++i) {
      if (i >= ni) continue;
      int s = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < kMaxCols; ++j) {
        if (j >= nj) continue;
        int e = tx + 16 * j;
        Hs[s * LH + e] = Hs[s * LH + e] * decay + hn[i][j];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < ds * hd; i += kThreads) {
    int s = i / hd, e = i % hd;
    h_out[(((long long)b * nh + h) * ds + s) * hd + e] = Hs[s * LH + e];
  }
}

template <typename T>
int launch(const void* x, const float* dt, const void* Bm, const void* Cm,
           const float* A, const float* h0, void* y, float* h_out, int batch,
           int S, int nh, int hd, int ds, int chunk, cudaStream_t stream) {
  const size_t bytes = smem_bytes(hd, ds);
  auto kern = ssd_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(nh, batch);
  kern<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), dt, static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), A, h0, static_cast<T*>(y), h_out, S, nh, hd,
      ds, chunk);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype (of x, B, C and y): 0 float32, 1 bfloat16.  h0 may be NULL (zero
// initial state).  S must be a multiple of chunk, 1 <= chunk <= 256;
// head_dim and d_state multiples of 16 up to 128.
extern "C" int ssd_scan_fwd(const void* x, const float* dt, const void* Bm,
                            const void* Cm, const float* A, const float* h0,
                            void* y, float* h_out, int dtype, int batch, int S,
                            int nh, int hd, int ds, int chunk, int device,
                            cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (chunk < 1 || chunk > kMaxChunk || S % chunk || hd % 16 || ds % 16 ||
      hd < 16 || ds < 16 || hd > kMaxDim || ds > kMaxDim)
    return (int)cudaErrorInvalidValue;
  if (batch <= 0 || nh <= 0) return 0;
  if (dtype == 0)
    return launch<float>(x, dt, Bm, Cm, A, h0, y, h_out, batch, S, nh, hd, ds,
                         chunk, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dt, Bm, Cm, A, h0, y, h_out, batch, S, nh,
                                 hd, ds, chunk, stream);
  return (int)cudaErrorInvalidValue;
}
