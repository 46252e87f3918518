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
// the same function.  Bound on the card: per chunk the work is
// Q*Q*ds/2 multiply-adds for C.B^T (shared by the heads: one B/C group) and
// per head about Q*Q*hd/2 + 2*Q*ds*hd more, on Q*(hd + 2*ds + 1) inputs: a
// few hundred operations per byte at Q 256, so it is bounded by operations.
//
// Design: the SSD decomposition of Mamba2 (Dao & Gu 2024, sec. 6), four
// launches on one stream.  The TPU kernel walks the chunks in order on one
// core with the state in VMEM; here only the state passing is sequential.
//   1. ssd_cb: C.B^T of each chunk, once per (batch, chunk), into scratch
//      (64 x 64 tiles at or below the diagonal).
//   2. ssd_chunk_state, per (batch, chunk, head, 64 rows of d_state): cum by
//      a block scan (written to scratch), and the chunk's own end state
//      S_c = B^T . (exp(cum_last - cum) dt x), into the states scratch.
//   3. ssd_state_pass, per (batch, head, element of the state): over the
//      chunks in order, h_c = exp(cum_last) h_{c-1} + S_c; each chunk's
//      starting state overwrites its S_c, and the last h is h_final.
//   4. ssd_output, per (batch, chunk, head, 64 query rows), the heaviest
//      row tiles first: y = exp(cum_q) C.h_start + (C.B^T o L) (dt x), where
//      L = exp(cum_q - cum_k) for k <= q, selected to 0 above the diagonal
//      (where the exponent overflows), never multiplied by a mask.
// At a 1536-token prompt and 80 heads that is 480 (chunk, head) cells, each
// split further by row tiles, against the 80 blocks of one block per head.
//
// The three large products (C.B^T, the decay tile times dt x, and the
// state terms B^T.(w x) and C.h) run on the tensor cores as mma.sync
// m16n8k8 TF32 into float32.  One TF32 rounding keeps 11 bits, which the
// float32 path's 3e-4 tolerance does not survive, so each operand is split
// into hi = tf32(v) (cvt.rna) and lo = tf32(v - hi) when it is staged in
// shared memory, and each product is issued as lo.hi + hi.lo + hi.hi (about
// 22 bits; lo.lo is below float32's own rounding).  The bf16 path stages its
// inputs to float32 and takes the same products.  Every staged piece has 64
// rows; the 4 warps of a block take 16 rows of the output each.  Shared
// rows are padded so that the fragment loads hit 32 different banks.
// Staging, not the products, is what the first version of this design
// waited on (PERF.md): each thread now issues the next piece's
// 16-byte loads into registers before the block multiplies the current
// one, and splits them into shared memory after (Piece; the split, the
// staging and the products are shared with the backward through
// csrc/ssd_mma.cuh).  Above a head_dim of 80 a block takes half the
// columns, so that the accumulators and those loads fit the registers.
// Chunks of any length 1..256 work: rows past the chunk (or past d_state)
// are staged as zeros and never stored.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ssd_mma.cuh"

namespace {

constexpr int kThreads = 128;   // 4 warps of 16 output rows
constexpr int kMaxChunk = 256;
constexpr int kMaxDim = 128;    // head_dim and d_state, multiples of 16
constexpr int kPassThreads = 256;
// row pitch of a piece read as [row][k] by the fragments (m x k of A, or
// n x k of B): 68 = 4 mod 32; read as [k][column]: columns + 8 = 8 or 24
// mod 32
constexpr int kLdRowK = kTile + 4;
constexpr int kLdA = kTile + 8;  // room for either pitch of a 64-wide piece
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// 2^x (ex2.approx: about 2^-22 relative error; large negative x gives 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}


__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
// The columns of head_dim one block of ssd_chunk_state and ssd_output
// computes: all of them up to 80, half above (the accumulators and the next
// piece's loads must fit the registers without spilling).
template <int HD>
__host__ __device__ constexpr int cols() {
  return HD > 80 ? HD / 2 : HD;
}
// row pitch of a [k][column] piece NC columns wide: 8 or 24 mod 32, so the
// B fragments' loads hit 32 different banks
__host__ __device__ constexpr int pitch(int nc) {
  return (nc + 8) % 16 ? nc + 8 : nc + 16;
}
// blocks an SM ssd_output is built for
template <int NC>
__host__ __device__ constexpr int min_blocks() {
  return NC <= 64 ? 3 : 2;
}

// ---- 1. C.B^T once per (batch, chunk) ---------------------------------------

constexpr size_t cb_smem() { return sizeof(float) * 4 * kTile * kLdRowK; }

// blockIdx.x: batch * nc + chunk; blockIdx.y: the tile (qi, kj), kj <= qi,
// of the (chunk x chunk) product, written whole (zeros past the chunk) at
// cb[(bc * qp + q) * qp + k], qp = the chunk rounded up to whole tiles.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    ssd_cb(const T* __restrict__ Bm, const T* __restrict__ Cm,
           float* __restrict__ cb, int S, int ds, int chunk) {
  extern __shared__ __align__(16) float smem[];
  float* Ah = smem;                 // C rows [q][s]
  float* Al = Ah + kTile * kLdRowK;
  float* Bh = Al + kTile * kLdRowK; // B rows [k][s]: B^T read as [n][k]
  float* Bl = Bh + kTile * kLdRowK;
  const int tid = threadIdx.x, warp = tid >> 5;
  int qi = 0, kj = blockIdx.y;
  while (kj > qi) kj -= ++qi;
  const int bc = blockIdx.x, nc = S / chunk;
  const int b = bc / nc, c = bc % nc;
  const long long row0 = (long long)b * S + (long long)c * chunk;
  const int q0 = qi * kTile, k0 = kj * kTile;
  const int nq = min(kTile, chunk - q0), nk = min(kTile, chunk - k0);
  const T* Cq = Cm + (row0 + q0) * ds;
  const T* Bk = Bm + (row0 + k0) * ds;

  // pieces: 64 columns of d_state each
  Piece<kTile, kThreads> pa, pb;
  auto fetch = [&](int s0) {
    const int ns = min(kTile, ds - s0);
    pa.fetch([&](int r, int s) {
      return r < nq && s < ns ? load4(Cq + r * ds + s0 + s) : zero4();
    });
    pb.fetch([&](int r, int s) {
      return r < nk && s < ns ? load4(Bk + r * ds + s0 + s) : zero4();
    });
  };
  float acc[8][4];
  zero(acc);
  fetch(0);
  for (int s0 = 0; s0 < ds; s0 += kTile) {
    __syncthreads();  // the last piece's products are done
    pa.put(Ah, Al, kLdRowK, Same());
    pb.put(Bh, Bl, kLdRowK, Same());
    __syncthreads();
    if (s0 + kTile < ds) fetch(s0 + kTile);
    warp_product<8, false, true>(acc, Ah, Al, kLdRowK, warp * 16, Bh, Bl,
                                 kLdRowK, min(kTile, ds - s0));
  }
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int qp = ((chunk + kTile - 1) / kTile) * kTile;
  float* out = cb + ((long long)bc * qp + q0 + warp * 16 + g) * qp + k0;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    store2(out + 8 * n + 2 * t, acc[n][0], acc[n][1]);
    store2(out + 8 * qp + 8 * n + 2 * t, acc[n][2], acc[n][3]);
  }
}

// ---- 2. cum and the chunk's own end state -----------------------------------

// cum[0 .. chunk) = inclusive cumsum of dt * a over the chunk's positions
// (two a thread); a barrier on exit
__device__ __forceinline__ void chunk_cumsum(float* cum, float* warp_tot,
                                             const float* __restrict__ dt,
                                             long long row0, int nh, int h,
                                             float a, int chunk) {
  const int tid = threadIdx.x, p = 2 * tid;
  const int lane = tid & 31, warp = tid >> 5;
  const float v0 = p < chunk ? dt[(row0 + p) * nh + h] * a : 0.0f;
  const float v1 = v0 + (p + 1 < chunk ? dt[(row0 + p + 1) * nh + h] * a
                                       : 0.0f);
  float s = v1;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float n = __shfl_up_sync(0xffffffffu, s, off);
    if (lane >= off) s += n;
  }
  if (lane == 31) warp_tot[warp] = s;
  __syncthreads();
  float base = s - v1;
  for (int w = 0; w < warp; ++w) base += warp_tot[w];
  cum[p] = base + v0;
  cum[p + 1] = base + v1;
  __syncthreads();
}

template <int HD>
constexpr size_t state_smem() {
  return sizeof(float) * (2 * kTile * kLdA + 2 * kTile * pitch(cols<HD>()) +
                          2 * kMaxChunk + 4);
}

// blockIdx.x: batch * nc + chunk; y: head; z: (64 rows of d_state, NC
// columns of head_dim).  Writes S_c (rows s, columns e) to
// states[((bc * nh + h) * ds + s) * HD + e] and, from the first block of
// the head, cum to cum_out[(b * nh + h) * S + position].
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 2)
    ssd_chunk_state(const T* __restrict__ x, const float* __restrict__ dt,
                    const T* __restrict__ Bm, const float* __restrict__ A,
                    float* __restrict__ states, float* __restrict__ cum_out,
                    int S, int nh, int ds, int chunk) {
  constexpr int NC = cols<HD>(), NT = NC / 8, LDB = pitch(NC);
  extern __shared__ __align__(16) float smem[];
  float* Ah = smem;                 // B rows [k][s]: B^T read as [k][m]
  float* Al = Ah + kTile * kLdA;
  float* Bh = Al + kTile * kLdA;    // w x rows [k][e]
  float* Bl = Bh + kTile * LDB;
  float* cum = Bl + kTile * LDB;    // kMaxChunk
  float* w = cum + kMaxChunk;       // kMaxChunk: exp(cum_last - cum_k) dt_k
  float* warp_tot = w + kMaxChunk;  // 4

  const int tid = threadIdx.x, warp = tid >> 5, m0 = warp * 16;
  const int bc = blockIdx.x, h = blockIdx.y;
  const int s0 = blockIdx.z / (HD / NC) * kTile;
  const int e0 = blockIdx.z % (HD / NC) * NC;
  const int nc = S / chunk, b = bc / nc, c = bc % nc;
  const long long row0 = (long long)b * S + (long long)c * chunk;
  const int dih = nh * HD;
  const T* xh = x + row0 * dih + (long long)h * HD + e0;
  const T* Bs = Bm + row0 * ds + s0;

  // pieces: 64 positions each
  Piece<kTile, kThreads> pa;
  Piece<NC, kThreads> pb;
  auto fetch = [&](int k0) {
    const int nk = min(kTile, chunk - k0);
    pa.fetch([&](int r, int s) {
      return r < nk && s0 + s < ds ? load4(Bs + (k0 + r) * ds + s)
                                   : zero4();
    });
    pb.fetch([&](int r, int e) {
      return r < nk ? load4(xh + (k0 + r) * dih + e) : zero4();
    });
  };
  fetch(0);  // in flight during the scan
  chunk_cumsum(cum, warp_tot, dt, row0, nh, h, A[h], chunk);
  if (blockIdx.z == 0)
    for (int q = tid; q < chunk; q += kThreads)
      cum_out[((long long)b * nh + h) * S + (long long)c * chunk + q] = cum[q];
  const float last = cum[chunk - 1];
  for (int q = tid; q < chunk; q += kThreads)
    w[q] = expf(last - cum[q]) * dt[(row0 + q) * nh + h];
  const bool active = s0 + m0 < ds;

  float acc[NT][4];
  zero(acc);
  for (int k0 = 0; k0 < chunk; k0 += kTile) {
    const int nk = min(kTile, chunk - k0);
    __syncthreads();  // the last piece's products are done; w written
    pa.put(Ah, Al, kLdA, Same());
    pb.put(Bh, Bl, LDB, [&](int r, int, float4 v) {
      return r < nk ? scale4(w[k0 + r], v) : zero4();
    });
    __syncthreads();
    if (k0 + kTile < chunk) fetch(k0 + kTile);
    if (active)
      warp_product<NT, true, false>(acc, Ah, Al, kLdA, m0, Bh, Bl, LDB,
                                    round8(nk));
  }
  if (!active) return;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  float* out = states + ((long long)bc * nh + h) * ds * HD + e0;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int col = 8 * n + 2 * t, r = s0 + m0 + g;
    store2(out + (long long)r * HD + col, acc[n][0], acc[n][1]);
    store2(out + (long long)(r + 8) * HD + col, acc[n][2], acc[n][3]);
  }
}

// ---- 3. state passing, sequential over the chunks only ----------------------

// blockIdx.x: batch * nh + head; y, threads: four elements of its state
// each.  The next chunk's S_c is loaded before this chunk's is replaced.
__global__ void __launch_bounds__(kPassThreads)
    ssd_state_pass(float* __restrict__ states, const float* __restrict__ cum,
                   const float* __restrict__ h0, float* __restrict__ h_out,
                   int S, int nh, int state_size, int chunk) {
  const int i = (blockIdx.y * kPassThreads + threadIdx.x) * 4;
  if (i >= state_size) return;
  const int bh = blockIdx.x, b = bh / nh, h = bh % nh;
  const int nc = S / chunk;
  const long long at = (long long)bh * state_size + i;
  float4 hv = h0 ? load4(h0 + at) : zero4();
  const float* last = cum + (long long)bh * S + chunk - 1;
  const long long step = (long long)nh * state_size;  // one chunk further
  float* p = states + ((long long)b * nc * nh + h) * state_size + i;
  float4 next = nc > 0 ? load4(p) : zero4();
  for (int c = 0; c < nc; ++c, p += step) {
    const float4 sc = next;
    if (c + 1 < nc) next = load4(p + step);
    *reinterpret_cast<float4*>(p) = hv;
    const float d = expf(last[(long long)c * chunk]);
    hv = make_float4(hv.x * d + sc.x, hv.y * d + sc.y, hv.z * d + sc.z,
                     hv.w * d + sc.w);
  }
  *reinterpret_cast<float4*>(h_out + at) = hv;
}

// ---- 4. outputs -------------------------------------------------------------

template <int HD>
constexpr size_t output_smem() {
  return sizeof(float) *
         (2 * kTile * kLdA + 2 * kTile * pitch(cols<HD>()) + 2 * kMaxChunk);
}

// blockIdx.x: batch * nc + chunk; y: head; z: (64 query rows, the last (the
// most key tiles) first; NC columns of head_dim).  carried: 0 when every
// starting state is zero.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, min_blocks<cols<HD>()>())
    ssd_output(const T* __restrict__ x, const float* __restrict__ dt,
               const T* __restrict__ Cm, const float* __restrict__ states,
               const float* __restrict__ cb, const float* __restrict__ cum,
               T* __restrict__ y, int S, int nh, int ds, int chunk,
               int carried) {
  constexpr int NC = cols<HD>(), NT = NC / 8, LDB = pitch(NC);
  extern __shared__ __align__(16) float smem[];
  float* Ah = smem;                 // C rows [q][s], then P [q][k]
  float* Al = Ah + kTile * kLdA;
  float* Bh = Al + kTile * kLdA;    // h rows [s][e], then dt x rows [k][e]
  float* Bl = Bh + kTile * LDB;
  float* cumc = Bl + kTile * LDB;   // kMaxChunk: cum over the chunk
  float* dtc = cumc + kMaxChunk;    // kMaxChunk: dt over the chunk

  const int tid = threadIdx.x, warp = tid >> 5, m0 = warp * 16;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int bc = blockIdx.x, h = blockIdx.y;
  const int nc = S / chunk, b = bc / nc, c = bc % nc;
  const int n_qt = (chunk + kTile - 1) / kTile, qp = n_qt * kTile;
  const int q0 = (n_qt - 1 - (int)blockIdx.z / (HD / NC)) * kTile;
  const int e0 = blockIdx.z % (HD / NC) * NC;
  const int nq = min(kTile, chunk - q0);
  const long long row0 = (long long)b * S + (long long)c * chunk;
  const int dih = nh * HD;
  const T* xh = x + row0 * dih + (long long)h * HD + e0;
  const T* Cq = Cm + (row0 + q0) * ds;
  const float* hs = states + ((long long)bc * nh + h) * ds * HD + e0;
  const float* cb_q = cb + ((long long)bc * qp + q0) * qp;
  const bool active = m0 < nq;

  // pieces: the carried ones first (64 columns of d_state each: C rows
  // times the chunk's starting state), then the key tiles at or below the
  // query tile
  const int n_car = carried ? (ds + kTile - 1) / kTile : 0;
  const int n_pieces = n_car + q0 / kTile + 1;
  Piece<kTile, kThreads> pa;
  Piece<NC, kThreads> pb;
  auto fetch = [&](int p) {
    if (p < n_car) {
      const int s0 = p * kTile, ns = min(kTile, ds - s0);
      pa.fetch([&](int r, int s) {
        return r < nq && s < ns ? load4(Cq + r * ds + s0 + s) : zero4();
      });
      pb.fetch([&](int r, int e) {
        return r < ns ? load4(hs + (s0 + r) * HD + e) : zero4();
      });
    } else {
      const int k0 = (p - n_car) * kTile, nk = min(kTile, chunk - k0);
      pa.fetch([&](int r, int k) {
        return r < nq && k0 + k <= q0 + r ? load4(cb_q + r * qp + k0 + k)
                                          : zero4();
      });
      pb.fetch([&](int r, int e) {
        return r < nk ? load4(xh + (k0 + r) * dih + e) : zero4();
      });
    }
  };
  fetch(0);
  {
    const float* cum_c =
        cum + ((long long)b * nh + h) * S + (long long)c * chunk;
    for (int i = tid; i < chunk; i += kThreads) {
      cumc[i] = cum_c[i];
      dtc[i] = dt[(row0 + i) * nh + h];
    }
  }

  float acc[NT][4];
  zero(acc);
  for (int p = 0; p < n_pieces; ++p) {
    const int k0 = (p - n_car) * kTile;
    __syncthreads();  // the last piece's products are done; cumc written
    if (p < n_car) {
      pa.put(Ah, Al, kLdRowK, Same());
      pb.put(Bh, Bl, LDB, Same());
    } else {
      // the decay tile, selected, not masked: above the diagonal the
      // exponent overflows
      pa.put(Ah, Al, kLdRowK, [&](int r, int k, float4 v) {
        const int qg = q0 + r, kg = k0 + k;
        if (r >= nq || kg > qg) return zero4();
        const float q = cumc[qg];
        return make_float4(
            v.x * exp2_approx((q - cumc[kg]) * kLog2e),
            kg + 1 <= qg ? v.y * exp2_approx((q - cumc[kg + 1]) * kLog2e)
                         : 0.0f,
            kg + 2 <= qg ? v.z * exp2_approx((q - cumc[kg + 2]) * kLog2e)
                         : 0.0f,
            kg + 3 <= qg ? v.w * exp2_approx((q - cumc[kg + 3]) * kLog2e)
                         : 0.0f);
      });
      pb.put(Bh, Bl, LDB, [&](int r, int, float4 v) {
        return k0 + r < chunk ? scale4(dtc[k0 + r], v) : zero4();
      });
    }
    __syncthreads();
    if (p + 1 < n_pieces) fetch(p + 1);
    if (active) {
      if (p < n_car) {
        warp_product<NT, false, false>(acc, Ah, Al, kLdRowK, m0, Bh, Bl, LDB,
                                       min(kTile, ds - p * kTile));
      } else {
        // on the diagonal tile a warp needs keys up to its last row only
        const int nk8 = round8(min(kTile, chunk - k0));
        warp_product<NT, false, false>(acc, Ah, Al, kLdRowK, m0, Bh, Bl, LDB,
                                       k0 == q0 ? min(nk8, m0 + 16) : nk8);
      }
    }
    if (p == n_car - 1) {
      // the carried-state term is exp(cum_q) C[q] . h_start
      const float e0 = m0 + g < nq ? expf(cumc[q0 + m0 + g]) : 0.0f;
      const float e1 = m0 + g + 8 < nq ? expf(cumc[q0 + m0 + g + 8]) : 0.0f;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        acc[n][0] *= e0;
        acc[n][1] *= e0;
        acc[n][2] *= e1;
        acc[n][3] *= e1;
      }
    }
  }

  if (!active) return;
  T* yq = y + (row0 + q0) * dih + (long long)h * HD + e0;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int col = 8 * n + 2 * t, r = m0 + g;
    if (r < nq) store2(yq + r * dih + col, acc[n][0], acc[n][1]);
    if (r + 8 < nq) store2(yq + (r + 8) * dih + col, acc[n][2], acc[n][3]);
  }
}

template <typename T, int HD>
int launch(const void* xv, const float* dt, const void* Bv, const void* Cv,
           const float* A, const float* h0, void* yv, float* h_out,
           float* states, float* cb, float* cum, int batch, int S, int nh,
           int ds, int chunk, int device, cudaStream_t stream) {
  const T* x = static_cast<const T*>(xv);
  const T* Bm = static_cast<const T*>(Bv);
  const T* Cm = static_cast<const T*>(Cv);
  T* y = static_cast<T*>(yv);
  const int nc = S / chunk, n_qt = (chunk + kTile - 1) / kTile;
  const int bnc = batch * nc;
  cudaError_t err;

  if (nc > 0) {  // S = 0: no chunk; h_final = h0 (or zeros)
    if ((err = allow_smem<ssd_cb<T>>(cb_smem(), device)) != cudaSuccess)
      return err;
    ssd_cb<T><<<dim3(bnc, n_qt * (n_qt + 1) / 2), kThreads, cb_smem(),
                stream>>>(Bm, Cm, cb, S, ds, chunk);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;

    if ((err = allow_smem<ssd_chunk_state<T, HD>>(state_smem<HD>(),
                                                  device)) != cudaSuccess)
      return err;
    ssd_chunk_state<T, HD>
        <<<dim3(bnc, nh, (ds + kTile - 1) / kTile * (HD / cols<HD>())),
           kThreads, state_smem<HD>(), stream>>>(x, dt, Bm, A, states, cum, S,
                                                 nh, ds, chunk);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }

  const int state_size = ds * HD;
  ssd_state_pass<<<dim3(batch * nh,
                        (state_size / 4 + kPassThreads - 1) / kPassThreads),
                   kPassThreads, 0, stream>>>(states, cum, h0, h_out, S, nh,
                                              state_size, chunk);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  if (nc == 0) return (int)cudaGetLastError();
  if ((err = allow_smem<ssd_output<T, HD>>(output_smem<HD>(), device)) !=
      cudaSuccess)
    return err;
  ssd_output<T, HD><<<dim3(bnc, nh, n_qt * (HD / cols<HD>())), kThreads,
                      output_smem<HD>(), stream>>>(
      x, dt, Cm, states, cb, cum, y, S, nh, ds, chunk,
      nc > 1 || h0 != nullptr);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_hd(int hd, const void* x, const float* dt, const void* Bm,
              const void* Cm, const float* A, const float* h0, void* y,
              float* h_out, float* states, float* cb, float* cum, int batch,
              int S, int nh, int ds, int chunk, int device,
              cudaStream_t stream) {
#define SSD_HD(N)                                                            \
  case N:                                                                    \
    return launch<T, N>(x, dt, Bm, Cm, A, h0, y, h_out, states, cb, cum,     \
                        batch, S, nh, ds, chunk, device, stream);
  switch (hd) {
    SSD_HD(16) SSD_HD(32) SSD_HD(48) SSD_HD(64)
    SSD_HD(80) SSD_HD(96) SSD_HD(112) SSD_HD(128)
  }
#undef SSD_HD
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype (of x, B, C and y): 0 float32, 1 bfloat16.  h0 may be NULL (zero
// initial state).  S must be a multiple of chunk, 1 <= chunk <= 256;
// head_dim and d_state multiples of 16 up to 128.  x, B, C and h0 start
// on 16 bytes (they are read 4 elements at a time).  Scratch, float32, from
// the caller: states (batch, S / chunk, nh, ds, hd), cb (batch, S / chunk,
// qp, qp) with qp the chunk rounded up to a multiple of 64, cum (batch, nh,
// S).  Four launches on `stream`.
extern "C" int ssd_scan_fwd(const void* x, const float* dt, const void* Bm,
                            const void* Cm, const float* A, const float* h0,
                            void* y, float* h_out, float* states, float* cb,
                            float* cum, int dtype, int batch, int S, int nh,
                            int hd, int ds, int chunk, int device,
                            cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (chunk < 1 || chunk > kMaxChunk || S % chunk || hd % 16 || ds % 16 ||
      hd < 16 || ds < 16 || hd > kMaxDim || ds > kMaxDim || batch < 0 ||
      nh < 0)
    return (int)cudaErrorInvalidValue;
  if (batch == 0 || nh == 0) return 0;
  if (S > 0 && (!states || !cb || !cum)) return (int)cudaErrorInvalidValue;
  if ((uintptr_t)x % 16 || (uintptr_t)Bm % 16 || (uintptr_t)Cm % 16 ||
      (uintptr_t)h0 % 16)
    return (int)cudaErrorMisalignedAddress;
  if (dtype == 0)
    return launch_hd<float>(hd, x, dt, Bm, Cm, A, h0, y, h_out, states, cb,
                            cum, batch, S, nh, ds, chunk, device, stream);
  if (dtype == 1)
    return launch_hd<__nv_bfloat16>(hd, x, dt, Bm, Cm, A, h0, y, h_out, states,
                                    cb, cum, batch, S, nh, ds, chunk, device,
                                    stream);
  return (int)cudaErrorInvalidValue;
}
