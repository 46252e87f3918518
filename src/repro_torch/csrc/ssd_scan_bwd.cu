// ssd_scan_bwd: the gradient of the Mamba2 chunked SSD scan (ssd_scan.cu).
// Given dy (batch, S, nh*hd) and the gradient of the final state dh_final
// (batch, nh, ds, hd, or none), it computes dx, ddt, dB, dC, dA and, when
// the forward had an h0, dh0 — float32 in, float32 out.  It reads the
// forward's chunk-start states and its within-chunk cumsum of dt * A, which
// the forward writes anyway (its scratch, kept for the backward): the
// states as they are, the cumsum for each chunk's decay exp(cum_last) in
// the state pass.  Within a chunk the kernels sum the cumsum again in
// double precision (load_chunk), so that exp(cum_q - cum_k) stays exact to
// float32 however strong the decay.
//
// Per chunk and head write a = cum, e_q = exp(a_q), r_k = exp(a_last - a_k),
// u_k = dt_k x_k, L[q,k] = exp(a_q - a_k) for k <= q (else 0), G = (C B^T) o
// L, h_c the chunk's starting state and g the gradient of its end state:
//   g_{c-1} = e_last g_c + sum_q e_q C_q (x) dy_q   (from dh_final; -> dh0)
//   du_k  = sum_{q>=k} G[q,k] dy_q + r_k (B_k . g);  dx = dt du,
//           ddt += <x, du>
//   dG    = dy u^T (k <= q),  dCB = sum_heads dG o L
//   dC_q  = sum_k dCB[q,k] B_k + sum_heads e_q (h_c . dy_q)
//   dB_k  = sum_q dCB[q,k] C_q + sum_heads r_k (g . u_k)
//   d cum: with M = dG o G and T_k = r_k <B_k (x) u_k, g>,
//     dla_j = sum_{q>=j} (sum_{k<q} M[q,k] - sum_{q'>q} M[q',q]
//                         + e_q <dy_q, C_q h_c>)
//             + sum_{k<j} T_k + e_last <h_c, g>
//   (the reverse cumsum of d cum, with M's diagonal and T's tail summed in
//   the form where they cancel exactly: under strong decay the diagonal
//   dominates M and the reverse cumsum would otherwise subtract it away);
//   ddt += A dla, dA = sum_{batch, positions} dla dt.
//
// Replaces the gradient of src/repro/kernels/ssd_scan.py:ssd_scan's
// function (Pallas body _ssd_kernel).  The JAX package has no backward
// kernel: it differentiates its jnp chunk loop (models/ssm.py ssd_prefill).
// Bound on the card: per (batch, chunk, head) about Q*Q*hd (du and dG over
// the triangle) + 4*Q*ds*hd (the state terms) multiply-adds, a few hundred
// operations per byte at Q 256: operations, at the FP32 rate.
//
// Design: seven launches on one stream, every product on FP32 FMAs in 64 x
// (64 .. 128) register tiles (256 threads, 4 rows x W/16 columns a thread)
// from shared memory; all float32.  No float atomics: every sum over heads,
// chunks or batch is a second pass in a fixed order, so a call gives the
// same bits every time.
//   0. ssd_bwd_cb: C.B^T of each chunk, once per (batch, chunk), 64 x 64
//      tiles at or below the diagonal, whole (zeros past the chunk).
//   1. ssd_bwd_dstate, per (batch, chunk, head, 64 rows of d_state): the
//      chunk's own D_c = sum_q e_q C_q (x) dy_q.
//   2. ssd_bwd_state_pass, per (batch, head, four elements of the state):
//      over the chunks in reverse, the chunk's g replaces its D_c and
//      g <- e_last g + D_c; what reaches chunk 0 is dh0.
//   3. ssd_bwd_keys, per (batch, chunk, head, 64-key tile): du (dx, and
//      ddt's <x, du>), this head's share of dB, M's column sums and T_k.
//   4. ssd_bwd_queries, per (batch, chunk, head, 64-query tile): this
//      head's share of dC, M's row sums, e_q <dy_q, C_q h_c>; on the
//      chunk's last tile e_last <h_c, g>.
//   5. ssd_bwd_dcum, per (batch, chunk, head): dla by the formula above
//      (one thread walks the chunk in order), ddt += A dla, the chunk's
//      share of dA.
//   6. ssd_bwd_reduce: dB and dC summed over the heads in order
//      0..nh-1, dA over batch and chunks in order.
// L is selected to 0 above the diagonal, never multiplied by a mask: there
// the exponent is positive and overflows, and 0 * inf is NaN.  Chunks of
// any length 1..256 work: rows past the chunk (or past hd / ds) are staged
// as zeros and never stored.  The scratch (C.B^T, the g states, the per-head
// dB / dC shares, d cum's parts) is the caller's.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;   // 16 x 16: 4 rows x W/16 columns a thread
constexpr int kT = 64;          // rows of a tile (positions or state rows)
constexpr int kMaxChunk = 256;
constexpr int kMaxDim = 128;    // head_dim and d_state, multiples of 16
constexpr int kLd = kT + 4;     // pitch of a [depth][64] piece
constexpr int kRed = kT * 17;   // a row reduction's scratch: 64 rows x 16
constexpr int kPassThreads = 256;

// pitch of a [depth][W] piece
__host__ __device__ constexpr int ldw(int w) { return w + 4; }

// acc[i][j] += sum_{k < K} a[k * lda + m0 + i] * b[k * ldb + n0 + 16 j],
// m0 = 4 (tid / 16), n0 = tid % 16: a 64 x 16 NJ tile of a . b with both
// operands stored depth-major in shared memory (lda a multiple of 4)
template <int NJ>
__device__ __forceinline__ void fma_tile(float (&acc)[4][NJ],
                                         const float* __restrict__ a, int lda,
                                         const float* __restrict__ b, int ldb,
                                         int K) {
  const int m0 = (threadIdx.x >> 4) * 4, n0 = threadIdx.x & 15;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float4 av = *reinterpret_cast<const float4*>(a + k * lda + m0);
    float bv[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) bv[j] = b[k * ldb + n0 + 16 * j];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      acc[0][j] = fmaf(av.x, bv[j], acc[0][j]);
      acc[1][j] = fmaf(av.y, bv[j], acc[1][j]);
      acc[2][j] = fmaf(av.z, bv[j], acc[2][j]);
      acc[3][j] = fmaf(av.w, bv[j], acc[3][j]);
    }
  }
}

template <int NJ>
__device__ __forceinline__ void zero(float (&acc)[4][NJ]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.0f;
}

// dst[r * ld + c] = f(r, c) for r < R, c < NC (f gives 0 out of range)
template <class F>
__device__ __forceinline__ void fill(float* dst, int ld, int R, int NC, F f) {
  for (int i = threadIdx.x; i < R * NC; i += kThreads) {
    const int r = i / NC, c = i % NC;
    dst[r * ld + c] = f(r, c);
  }
}

// the transpose: dst[c * ld + r] = f(r, c), read along c
template <class F>
__device__ __forceinline__ void fill_t(float* dst, int ld, int R, int NC,
                                       F f) {
  for (int i = threadIdx.x; i < R * NC; i += kThreads) {
    const int r = i / NC, c = i % NC;
    dst[c * ld + r] = f(r, c);
  }
}

// The sum over the 16 threads of a tile row of each thread's p[i] (its row
// m0 + i), in thread order; returns red + kRed, where entry m is row m's
// sum (read after the barrier this ends with).
__device__ __forceinline__ const float* row_sum(float* red,
                                                const float (&p)[4]) {
  const int tid = threadIdx.x, m0 = (tid >> 4) * 4, n0 = tid & 15;
#pragma unroll
  for (int i = 0; i < 4; ++i) red[(m0 + i) * 17 + n0] = p[i];
  __syncthreads();
  if (tid < kT) {
    float s = 0.0f;
    for (int t = 0; t < 16; ++t) s += red[tid * 17 + t];
    red[kRed + tid] = s;
  }
  __syncthreads();
  return red + kRed;
}

// The chunk's dt for head h, and its cum = cumsum(dt * a) summed again in
// double precision (one thread, in order) into shared memory; a barrier on
// exit.  Every exponent here is a difference of two cums: in float32 a cum
// of -3000 (strong decay) carries 2e-4 of absolute error into each
// exp(cum_q - cum_k), and the gradient of dA, made of such terms alone
// there, would lose its 1e-4 bound.
__device__ __forceinline__ void load_chunk(double* cumc, float* dtc,
                                           const float* __restrict__ dt,
                                           float a, int b, int c, int h,
                                           int S, int nh, int chunk) {
  const long long row0 = (long long)b * S + (long long)c * chunk;
  for (int i = threadIdx.x; i < chunk; i += kThreads)
    dtc[i] = dt[(row0 + i) * nh + h];
  __syncthreads();
  if (threadIdx.x == 0) {
    double s = 0.0;
    for (int i = 0; i < chunk; ++i) {
      s += (double)dtc[i] * a;
      cumc[i] = s;
    }
  }
  __syncthreads();
}

// exp(x) of a difference of cums, rounded to float32 once
__device__ __forceinline__ float exp_of(double x) { return expf((float)x); }

// L[q, k] of chunk positions q, k: exp(cum_q - cum_k) where k <= q < chunk,
// selected (not multiplied) to 0 elsewhere
__device__ __forceinline__ float decay(const double* cumc, int q, int k,
                                       int chunk) {
  return k <= q && q < chunk ? exp_of(cumc[q] - cumc[k]) : 0.0f;
}

// ---- 0. C.B^T once per (batch, chunk) --------------------------------------

// blockIdx.x: batch * nc + chunk; y: the tile (qi, kj), kj <= qi, written
// whole at cb[(bc * qp + q) * qp + k], qp = the chunk rounded up to 64.
__global__ void __launch_bounds__(kThreads)
    ssd_bwd_cb(const float* __restrict__ Bm, const float* __restrict__ Cm,
               float* __restrict__ cb, int S, int ds, int chunk) {
  __shared__ __align__(16) float Ct[kT * kLd];  // C^T [s][q]
  __shared__ __align__(16) float Bt[kT * kLd];  // B^T [s][k]
  int qi = 0, kj = blockIdx.y;
  while (kj > qi) kj -= ++qi;
  const int bc = blockIdx.x, nc = S / chunk, b = bc / nc, c = bc % nc;
  const long long row0 = (long long)b * S + (long long)c * chunk;
  const int q0 = qi * kT, k0 = kj * kT;
  const int nq = min(kT, chunk - q0), nk = min(kT, chunk - k0);
  float acc[4][4];
  zero(acc);
  for (int s0 = 0; s0 < ds; s0 += kT) {
    const int ns = min(kT, ds - s0);
    __syncthreads();
    fill_t(Ct, kLd, kT, kT, [&](int q, int s) {
      return q < nq && s < ns ? Cm[(row0 + q0 + q) * ds + s0 + s] : 0.0f;
    });
    fill_t(Bt, kLd, kT, kT, [&](int k, int s) {
      return k < nk && s < ns ? Bm[(row0 + k0 + k) * ds + s0 + s] : 0.0f;
    });
    __syncthreads();
    fma_tile<4>(acc, Ct, kLd, Bt, kLd, ns);
  }
  const int qp = (chunk + kT - 1) / kT * kT;
  const int m0 = (threadIdx.x >> 4) * 4, n0 = threadIdx.x & 15;
  float* out = cb + ((long long)bc * qp + q0) * qp + k0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      out[(long long)(m0 + i) * qp + n0 + 16 * j] = acc[i][j];
}

// ---- 1. each chunk's own D_c -----------------------------------------------

template <int W>
constexpr size_t dstate_smem() {
  return sizeof(float) * (3 * kMaxChunk + kT * kLd + kT * ldw(W));
}

// blockIdx.x: batch * nc + chunk; y: head; z: 64 rows of d_state.  Writes
// D_c[s][e] = sum_q e_q C_q[s] dy_q[e] to g[((bc * nh + h) * ds + s) * hd
// + e].
template <int W>
__global__ void __launch_bounds__(kThreads)
    ssd_bwd_dstate(const float* __restrict__ Cm, const float* __restrict__ dt,
                   const float* __restrict__ A, const float* __restrict__ dy,
                   float* __restrict__ gst, int S, int nh, int hd, int ds,
                   int chunk) {
  constexpr int NJ = W / 16;
  extern __shared__ __align__(16) float smem[];
  double* cumc = reinterpret_cast<double*>(smem);  // kMaxChunk
  float* dtc = smem + 2 * kMaxChunk;  // kMaxChunk
  float* ca = dtc + kMaxChunk;        // e_q C_q [q][s]
  float* dyq = ca + kT * kLd;         // dy_q [q][e]
  const int bc = blockIdx.x, h = blockIdx.y, s0 = blockIdx.z * kT;
  const int nc = S / chunk, b = bc / nc, c = bc % nc;
  const long long row0 = (long long)b * S + (long long)c * chunk;
  const int dih = nh * hd;
  load_chunk(cumc, dtc, dt, A[h], b, c, h, S, nh, chunk);
  float acc[4][NJ];
  zero(acc);
  for (int q0 = 0; q0 < chunk; q0 += kT) {
    const int nq = min(kT, chunk - q0);
    __syncthreads();
    fill(ca, kLd, kT, kT, [&](int q, int s) {
      return q < nq && s0 + s < ds
                 ? exp_of(cumc[q0 + q]) * Cm[(row0 + q0 + q) * ds + s0 + s]
                 : 0.0f;
    });
    fill(dyq, ldw(W), kT, W, [&](int q, int e) {
      return q < nq && e < hd ? dy[(row0 + q0 + q) * dih + h * hd + e]
                              : 0.0f;
    });
    __syncthreads();
    fma_tile<NJ>(acc, ca, kLd, dyq, ldw(W), nq);
  }
  const int m0 = (threadIdx.x >> 4) * 4, n0 = threadIdx.x & 15;
  float* out = gst + ((long long)bc * nh + h) * ds * hd;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int s = s0 + m0 + i, e = n0 + 16 * j;
      if (s < ds && e < hd) out[(long long)s * hd + e] = acc[i][j];
    }
}

// ---- 2. the reverse state pass ---------------------------------------------

// blockIdx.x: batch * nh + head; y, threads: four elements of its state
// each.  Over the chunks from the last: the chunk's D_c is read, its g
// written in its place, g <- exp(cum_last) g + D_c.
__global__ void __launch_bounds__(kPassThreads)
    ssd_bwd_state_pass(float* __restrict__ gst, const float* __restrict__ cum,
                       const float* __restrict__ dh_final,
                       float* __restrict__ dh0, int S, int nh, int state_size,
                       int chunk) {
  const int i = (blockIdx.y * kPassThreads + threadIdx.x) * 4;
  if (i >= state_size) return;
  const int bh = blockIdx.x, b = bh / nh, h = bh % nh;
  const int nc = S / chunk;
  const long long at = (long long)bh * state_size + i;
  float4 g = dh_final ? *reinterpret_cast<const float4*>(dh_final + at)
                      : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const float* last = cum + (long long)bh * S + chunk - 1;
  const long long step = (long long)nh * state_size;  // one chunk further
  for (int c = nc - 1; c >= 0; --c) {
    float* p = gst + ((long long)b * nc * nh + h) * state_size + i + c * step;
    const float4 d = *reinterpret_cast<const float4*>(p);
    *reinterpret_cast<float4*>(p) = g;
    const float e = expf(last[(long long)c * chunk]);
    g = make_float4(fmaf(e, g.x, d.x), fmaf(e, g.y, d.y), fmaf(e, g.z, d.z),
                    fmaf(e, g.w, d.w));
  }
  if (dh0) *reinterpret_cast<float4*>(dh0 + at) = g;
}

// ---- 3. key tiles: dx, ddt's <x, du>, this head's dB, M's column sums, T --

template <int W>
constexpr size_t keys_smem() {
  return sizeof(float) *
         (3 * kMaxChunk + 2 * W * kLd + (W > kT ? W : kT) * kLd +
          (W * ldw(W) > kT * kLd ? W * ldw(W) : kT * kLd) + kT * ldw(W) +
          kRed + kT);
}

// blockIdx.x: batch * nc + chunk; y: head; z: the key tile (the first, with
// the most query tiles, first).
template <int W>
__global__ void __launch_bounds__(kThreads)
    ssd_bwd_keys(const float* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ Bm, const float* __restrict__ Cm,
                 const float* __restrict__ A, const float* __restrict__ cb,
                 const float* __restrict__ gst, const float* __restrict__ dy,
                 float* __restrict__ dx, float* __restrict__ ddt,
                 float* __restrict__ dBh, float* __restrict__ daK,
                 float* __restrict__ Tk, int S, int nh, int hd, int ds,
                 int chunk) {
  constexpr int NJ = W / 16;
  extern __shared__ __align__(16) float smem[];
  double* cumc = reinterpret_cast<double*>(smem);  // kMaxChunk
  float* dtc = smem + 2 * kMaxChunk;     // kMaxChunk
  float* uT = dtc + kMaxChunk;           // u^T [e][k]
  float* dyT = uT + W * kLd;             // dy_q^T [e][q]
  float* opA = dyT + W * kLd;            // B_k^T [s][k]; G, dCB [q][k]
  float* opB = opA + (W > kT ? W : kT) * kLd;  // g [s][e], g^T; C.B^T [q][k]
  float* dyq = opB + (W * ldw(W) > kT * kLd ? W * ldw(W) : kT * kLd);
                                         // dy_q [q][e]; C_q [q][s]
  float* red = dyq + kT * ldw(W);        // kRed + kT

  const int tid = threadIdx.x, m0 = (tid >> 4) * 4, n0 = tid & 15;
  const int bc = blockIdx.x, h = blockIdx.y, kt = blockIdx.z;
  const int nc = S / chunk, b = bc / nc, c = bc % nc;
  const int n_t = (chunk + kT - 1) / kT, qp = n_t * kT;
  const int k0 = kt * kT, nk = min(kT, chunk - k0);
  const long long row0 = (long long)b * S + (long long)c * chunk;
  const int dih = nh * hd;
  const float* xh = x + row0 * dih + (long long)h * hd;
  const float* dyh = dy + row0 * dih + (long long)h * hd;
  const float* gh = gst + ((long long)bc * nh + h) * ds * hd;
  load_chunk(cumc, dtc, dt, A[h], b, c, h, S, nh, chunk);
  const double last = cumc[chunk - 1];
  float r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    r[i] = m0 + i < nk ? exp_of(last - cumc[k0 + m0 + i]) : 0.0f;

  fill_t(uT, kLd, kT, W, [&](int k, int e) {
    return k < nk && e < hd ? dtc[k0 + k] * xh[(long long)(k0 + k) * dih + e]
                            : 0.0f;
  });
  fill_t(opA, kLd, kT, W, [&](int k, int s) {
    return k < nk && s < ds ? Bm[(row0 + k0 + k) * ds + s] : 0.0f;
  });
  fill(opB, ldw(W), W, W, [&](int s, int e) {
    return s < ds && e < hd ? gh[s * hd + e] : 0.0f;
  });
  __syncthreads();
  // du = r_k (B_k . g), then the query tiles' G^T dy
  float du[4][NJ];
  zero(du);
  fma_tile<NJ>(du, opA, kLd, opB, ldw(W), ds);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) du[i][j] *= r[i];
  __syncthreads();
  fill_t(opB, ldw(W), W, W, [&](int s, int e) {
    return s < ds && e < hd ? gh[s * hd + e] : 0.0f;
  });
  __syncthreads();
  // this head's dB_k = r_k (g . u_k), then the query tiles' dCB^T C
  float dBk[4][NJ];
  zero(dBk);
  fma_tile<NJ>(dBk, uT, kLd, opB, ldw(W), hd);
  float p[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    p[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      dBk[i][j] *= r[i];
      p[i] = fmaf(opA[(n0 + 16 * j) * kLd + m0 + i], dBk[i][j], p[i]);
    }
  }
  const float T = row_sum(red, p)[tid < kT ? tid : 0];

  float col[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int qt = kt; qt < n_t; ++qt) {
    const int q0 = qt * kT, nq = min(kT, chunk - q0);
    const float* cbt = cb + ((long long)bc * qp + q0) * qp + k0;
    __syncthreads();  // the last tile's products are done
    fill(opA, kLd, kT, kT, [&](int q, int k) {
      const float l = decay(cumc, q0 + q, k0 + k, chunk);
      return l != 0.0f ? cbt[(long long)q * qp + k] * l : 0.0f;
    });
    fill(opB, kLd, kT, kT,
         [&](int q, int k) { return cbt[(long long)q * qp + k]; });
    fill(dyq, ldw(W), kT, W, [&](int q, int e) {
      return q < nq && e < hd ? dyh[(long long)(q0 + q) * dih + e] : 0.0f;
    });
    fill_t(dyT, kLd, kT, W, [&](int q, int e) {
      return q < nq && e < hd ? dyh[(long long)(q0 + q) * dih + e] : 0.0f;
    });
    __syncthreads();
    fma_tile<NJ>(du, opA, kLd, dyq, ldw(W), nq);
    // dG^T [k][q] = u_k . dy_q, then dCB = dG o L, M = dCB o C.B^T
    float dg[4][4];
    zero(dg);
    fma_tile<4>(dg, uT, kLd, dyT, kLd, hd);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = k0 + m0 + i, q = q0 + n0 + 16 * j;
        dg[i][j] *= decay(cumc, q, k, chunk);
        if (k < q)
          col[i] = fmaf(dg[i][j], opB[(n0 + 16 * j) * kLd + m0 + i], col[i]);
      }
    __syncthreads();  // opA and dyq are read
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(opA + (n0 + 16 * j) * kLd + m0) =
          make_float4(dg[0][j], dg[1][j], dg[2][j], dg[3][j]);
    fill(dyq, ldw(W), kT, W, [&](int q, int s) {
      return q < nq && s < ds ? Cm[(row0 + q0 + q) * ds + s] : 0.0f;
    });
    __syncthreads();
    fma_tile<NJ>(dBk, opA, kLd, dyq, ldw(W), nq);
  }

  // dx = dt du and ddt's <x, du>
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = m0 + i;
    p[i] = 0.0f;
    if (k >= nk) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int e = n0 + 16 * j;
      if (e < hd) {
        const long long at = (long long)(k0 + k) * dih + e;
        p[i] = fmaf(xh[at], du[i][j], p[i]);
        dx[row0 * dih + (long long)h * hd + at] = dtc[k0 + k] * du[i][j];
      }
    }
  }
  const float* xdu = row_sum(red, p);
  if (tid < nk) ddt[(row0 + k0 + tid) * nh + h] = xdu[tid];
  const float* cs = row_sum(red, col);
  if (tid < nk) {
    const long long at = ((long long)b * nh + h) * S + (long long)c * chunk +
                         k0 + tid;
    daK[at] = -cs[tid];
    Tk[at] = T;
  }
  float* out = dBh + (((long long)bc * nh + h) * chunk + k0) * ds;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int k = m0 + i, s = n0 + 16 * j;
      if (k < nk && s < ds) out[(long long)k * ds + s] = dBk[i][j];
    }
}

// ---- 4. query tiles: this head's dC, M's row sums, the state terms ---------

template <int W>
constexpr size_t queries_smem() {
  return sizeof(float) *
         (3 * kMaxChunk + 2 * W * kLd + (W > kT ? W : kT) * ldw(W) +
          2 * kT * kLd + kRed + kT);
}

// blockIdx.x: batch * nc + chunk; y: head; z: the query tile, the last
// (with the most key tiles) first.
template <int W>
__global__ void __launch_bounds__(kThreads)
    ssd_bwd_queries(const float* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ Bm, const float* __restrict__ Cm,
                    const float* __restrict__ A, const float* __restrict__ cb,
                    const float* __restrict__ states,
                    const float* __restrict__ gst, const float* __restrict__ dy,
                    float* __restrict__ dCh, float* __restrict__ daQ,
                    float* __restrict__ hg, int S, int nh, int hd, int ds,
                    int chunk) {
  constexpr int NJ = W / 16;
  extern __shared__ __align__(16) float smem[];
  double* cumc = reinterpret_cast<double*>(smem);  // kMaxChunk
  float* dtc = smem + 2 * kMaxChunk;     // kMaxChunk
  float* dyT = dtc + kMaxChunk;          // dy_q^T [e][q]
  float* uT = dyT + W * kLd;             // u_k^T [e][k]
  float* opB = uT + W * kLd;             // h_c^T [e][s]; B_k [k][s]
  float* opA = opB + (W > kT ? W : kT) * ldw(W);  // dCB^T [k][q]
  float* cbt = opA + kT * kLd;           // C.B^T [q][k]
  float* red = cbt + kT * kLd;           // kRed + kT

  const int tid = threadIdx.x, m0 = (tid >> 4) * 4, n0 = tid & 15;
  const int bc = blockIdx.x, h = blockIdx.y;
  const int nc = S / chunk, b = bc / nc, c = bc % nc;
  const int n_t = (chunk + kT - 1) / kT, qp = n_t * kT;
  const int qt = n_t - 1 - (int)blockIdx.z;
  const int q0 = qt * kT, nq = min(kT, chunk - q0);
  const long long row0 = (long long)b * S + (long long)c * chunk;
  const int dih = nh * hd;
  const float* xh = x + row0 * dih + (long long)h * hd;
  const float* dyh = dy + row0 * dih + (long long)h * hd;
  const float* hc = states + ((long long)bc * nh + h) * ds * hd;
  load_chunk(cumc, dtc, dt, A[h], b, c, h, S, nh, chunk);

  fill_t(dyT, kLd, kT, W, [&](int q, int e) {
    return q < nq && e < hd ? dyh[(long long)(q0 + q) * dih + e] : 0.0f;
  });
  fill_t(opB, ldw(W), W, W, [&](int s, int e) {
    return s < ds && e < hd ? hc[s * hd + e] : 0.0f;
  });
  __syncthreads();
  // this head's dC_q = e_q (h_c . dy_q), then the key tiles' dCB B
  float dCq[4][NJ];
  zero(dCq);
  fma_tile<NJ>(dCq, dyT, kLd, opB, ldw(W), hd);
  float p[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = m0 + i;
    const float e = q < nq ? exp_of(cumc[q0 + q]) : 0.0f;
    p[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int s = n0 + 16 * j;
      dCq[i][j] *= e;
      if (q < nq && s < ds)
        p[i] = fmaf(Cm[(row0 + q0 + q) * ds + s], dCq[i][j], p[i]);
    }
  }
  const float R = row_sum(red, p)[tid < kT ? tid : 0];

  float row[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * kT, nk = min(kT, chunk - k0);
    const float* cbg = cb + ((long long)bc * qp + q0) * qp + k0;
    __syncthreads();  // the last tile's products are done
    fill_t(uT, kLd, kT, W, [&](int k, int e) {
      return k < nk && e < hd
                 ? dtc[k0 + k] * xh[(long long)(k0 + k) * dih + e]
                 : 0.0f;
    });
    fill(opB, ldw(W), kT, W, [&](int k, int s) {
      return k < nk && s < ds ? Bm[(row0 + k0 + k) * ds + s] : 0.0f;
    });
    fill(cbt, kLd, kT, kT,
         [&](int q, int k) { return cbg[(long long)q * qp + k]; });
    __syncthreads();
    // dG [q][k] = dy_q . u_k, then dCB = dG o L, M = dCB o C.B^T
    float dg[4][4];
    zero(dg);
    fma_tile<4>(dg, dyT, kLd, uT, kLd, hd);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int q = q0 + m0 + i, k = k0 + n0 + 16 * j;
        dg[i][j] *= decay(cumc, q, k, chunk);
        if (k < q)
          row[i] = fmaf(dg[i][j], cbt[(m0 + i) * kLd + n0 + 16 * j], row[i]);
      }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(opA + (n0 + 16 * j) * kLd + m0) =
          make_float4(dg[0][j], dg[1][j], dg[2][j], dg[3][j]);
    __syncthreads();
    fma_tile<NJ>(dCq, opA, kLd, opB, ldw(W), nk);
  }

  const float* rs = row_sum(red, row);
  if (tid < nq)
    daQ[((long long)b * nh + h) * S + (long long)c * chunk + q0 + tid] =
        rs[tid] + R;
  float* out = dCh + (((long long)bc * nh + h) * chunk + q0) * ds;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int q = m0 + i, s = n0 + 16 * j;
      if (q < nq && s < ds) out[(long long)q * ds + s] = dCq[i][j];
    }
  if (q0 + kT >= chunk) {
    // the chunk's last tile: e_last <h_c, g>, summed in thread order
    const float* gh = gst + ((long long)bc * nh + h) * ds * hd;
    float s = 0.0f;
    for (int i = tid; i < ds * hd; i += kThreads) s = fmaf(hc[i], gh[i], s);
    __syncthreads();
    red[tid] = s;
    __syncthreads();
    if (tid == 0) {
      float t = 0.0f;
      for (int i = 0; i < kThreads; ++i) t += red[i];
      hg[(long long)bc * nh + h] = exp_of(cumc[chunk - 1]) * t;
    }
  }
}

// ---- 5. d cum, its reverse cumsum, ddt and dA's share ----------------------

// blockIdx.x: batch * nc + chunk; y: head.  One thread walks the chunk.
__global__ void __launch_bounds__(kThreads)
    ssd_bwd_dcum(const float* __restrict__ dt, const float* __restrict__ A,
                 const float* __restrict__ daK, const float* __restrict__ daQ,
                 const float* __restrict__ Tk, const float* __restrict__ hg,
                 float* __restrict__ ddt, float* __restrict__ dAp, int S,
                 int nh, int chunk) {
  __shared__ float dla[kMaxChunk];
  const int tid = threadIdx.x, bc = blockIdx.x, h = blockIdx.y;
  const int nc = S / chunk, b = bc / nc, c = bc % nc;
  const long long at = ((long long)b * nh + h) * S + (long long)c * chunk;
  const long long row0 = (long long)b * S + (long long)c * chunk;
  if (tid == 0) {
    // dla_j = sum_{q >= j} (daK + daQ)_q + sum_{k < j} T_k + e_last <h, g>
    const float base = hg[(long long)bc * nh + h];
    float t = 0.0f;
    for (int j = 0; j < chunk; ++j) {
      dla[j] = t + base;
      t += Tk[at + j];
    }
    float s = 0.0f;
    for (int j = chunk - 1; j >= 0; --j) {
      s += daK[at + j] + daQ[at + j];
      dla[j] += s;
    }
    float d = 0.0f;
    for (int j = 0; j < chunk; ++j)
      d = fmaf(dla[j], dt[(row0 + j) * nh + h], d);
    dAp[(long long)bc * nh + h] = d;
  }
  __syncthreads();
  const float a = A[h];
  for (int j = tid; j < chunk; j += kThreads)
    ddt[(row0 + j) * nh + h] = fmaf(a, dla[j], ddt[(row0 + j) * nh + h]);
}

// ---- 6. the fixed-order sums over heads, batch and chunks ------------------

// threads over (batch, position, state row): dB and dC summed over the
// heads in order; the first block also sums dA over (batch, chunk) in order
__global__ void __launch_bounds__(kThreads)
    ssd_bwd_reduce(const float* __restrict__ dBh, const float* __restrict__ dCh,
                   const float* __restrict__ dAp, float* __restrict__ dB,
                   float* __restrict__ dC, float* __restrict__ dA, int batch,
                   int S, int nh, int ds, int chunk) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  const int nc = S / chunk;
  if (blockIdx.x == 0)
    for (int h = threadIdx.x; h < nh; h += kThreads) {
      float s = 0.0f;
      for (int bc = 0; bc < batch * nc; ++bc) s += dAp[(long long)bc * nh + h];
      dA[h] = s;
    }
  if (i >= (long long)batch * S * ds) return;
  const int s = (int)(i % ds);
  const long long bp = i / ds;        // batch * S + position
  const long long bc = bp / chunk;    // batch * nc + chunk
  const int q = (int)(bp % chunk);
  const long long stride = (long long)chunk * ds;  // one head further
  const long long at = bc * nh * stride + (long long)q * ds + s;
  float sb = 0.0f, sc = 0.0f;
  for (int h = 0; h < nh; ++h) {
    sb += dBh[at + h * stride];
    sc += dCh[at + h * stride];
  }
  dB[i] = sb;
  dC[i] = sc;
}

// the dynamic shared memory a kernel needs, allowed once per device
template <auto kKernel>
cudaError_t allow_smem(size_t bytes, int device) {
  static std::atomic<unsigned long long> done{0};
  const unsigned long long bit = 1ull << (device & 63);
  if (done.load() & bit) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

struct Args {
  const float *x, *dt, *Bm, *Cm, *A, *states, *cum, *dy, *dh_final;
  float *dx, *ddt, *dB, *dC, *dA, *dh0;
  float *cb, *gst, *dBh, *dCh, *daK, *daQ, *Tk, *hg, *dAp;
  int batch, S, nh, hd, ds, chunk, device;
  cudaStream_t stream;
};

template <int W>
int launch(const Args& a) {
  const int nc = a.S / a.chunk, n_t = (a.chunk + kT - 1) / kT;
  const int bnc = a.batch * nc;
  cudaError_t err;
  if (nc > 0) {
    ssd_bwd_cb<<<dim3(bnc, n_t * (n_t + 1) / 2), kThreads, 0, a.stream>>>(
        a.Bm, a.Cm, a.cb, a.S, a.ds, a.chunk);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    if ((err = allow_smem<ssd_bwd_dstate<W>>(dstate_smem<W>(),
                                             a.device)) != cudaSuccess)
      return err;
    ssd_bwd_dstate<W><<<dim3(bnc, a.nh, (a.ds + kT - 1) / kT), kThreads,
                    dstate_smem<W>(), a.stream>>>(
        a.Cm, a.dt, a.A, a.dy, a.gst, a.S, a.nh, a.hd, a.ds, a.chunk);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  const int state_size = a.ds * a.hd;
  ssd_bwd_state_pass<<<dim3(a.batch * a.nh,
                        (state_size / 4 + kPassThreads - 1) / kPassThreads),
                   kPassThreads, 0, a.stream>>>(a.gst, a.cum, a.dh_final,
                                                a.dh0, a.S, a.nh, state_size,
                                                a.chunk);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (nc > 0) {
    if ((err = allow_smem<ssd_bwd_keys<W>>(keys_smem<W>(), a.device)) !=
        cudaSuccess)
      return err;
    ssd_bwd_keys<W><<<dim3(bnc, a.nh, n_t), kThreads, keys_smem<W>(),
                  a.stream>>>(a.x, a.dt, a.Bm, a.Cm, a.A, a.cb, a.gst, a.dy,
                              a.dx, a.ddt, a.dBh, a.daK, a.Tk, a.S, a.nh,
                              a.hd, a.ds, a.chunk);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    if ((err = allow_smem<ssd_bwd_queries<W>>(queries_smem<W>(),
                                              a.device)) != cudaSuccess)
      return err;
    ssd_bwd_queries<W><<<dim3(bnc, a.nh, n_t), kThreads, queries_smem<W>(),
                     a.stream>>>(a.x, a.dt, a.Bm, a.Cm, a.A, a.cb,
                                 a.states, a.gst, a.dy, a.dCh, a.daQ, a.hg,
                                 a.S, a.nh, a.hd, a.ds, a.chunk);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    ssd_bwd_dcum<<<dim3(bnc, a.nh), kThreads, 0, a.stream>>>(
        a.dt, a.A, a.daK, a.daQ, a.Tk, a.hg, a.ddt, a.dAp, a.S, a.nh,
        a.chunk);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  const long long n = (long long)a.batch * a.S * a.ds;
  ssd_bwd_reduce<<<(unsigned)(n > 0 ? (n + kThreads - 1) / kThreads : 1),
               kThreads, 0, a.stream>>>(a.dBh, a.dCh, a.dAp, a.dB, a.dC,
                                        a.dA, a.batch, a.S, a.nh, a.ds,
                                        a.chunk);
  return (int)cudaGetLastError();
}

}  // namespace

// Every tensor float32 and contiguous: x and dy (batch, S, nh*hd), dt
// (batch, S, nh), B and C (batch, S, ds), A (nh), the forward's chunk-start
// states (batch, S/chunk, nh, ds, hd) and cum (batch, nh, S); dh_final
// (batch, nh, ds, hd) or NULL (zero).  Outputs: dx, ddt, dB, dC, dA (nh)
// and dh0 (or NULL when the forward had no h0).  Scratch, float32, from the
// caller: cb (batch, S/chunk, qp, qp), qp the chunk rounded up to 64; g
// (batch, S/chunk, nh, ds, hd); dBh and dCh (batch, S/chunk, nh, chunk,
// ds); daK, daQ and Tk (batch, nh, S); hg and dAp (batch, S/chunk, nh).
// dh_final, dh0 and the g scratch start on 16 bytes.  S must be a multiple
// of chunk, 1 <= chunk <= 256; head_dim and d_state multiples of 16 up to
// 128.  Seven launches on `stream` (three when S is 0).
extern "C" int ssd_scan_bwd(
    const float* x, const float* dt, const float* Bm, const float* Cm,
    const float* A, const float* states, const float* cum, const float* dy,
    const float* dh_final, float* dx, float* ddt, float* dB, float* dC,
    float* dA, float* dh0, float* cb, float* gst, float* dBh, float* dCh,
    float* daK, float* daQ, float* Tk, float* hg, float* dAp, int batch,
    int S, int nh, int hd, int ds, int chunk, int device,
    cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (chunk < 1 || chunk > kMaxChunk || S < 0 || S % chunk || hd % 16 ||
      ds % 16 || hd < 16 || ds < 16 || hd > kMaxDim || ds > kMaxDim ||
      batch < 0 || nh < 0)
    return (int)cudaErrorInvalidValue;
  if (batch == 0 || nh == 0) return 0;
  if ((uintptr_t)dh_final % 16 || (uintptr_t)dh0 % 16 || (uintptr_t)gst % 16)
    return (int)cudaErrorMisalignedAddress;
  const Args a{x,  dt,  Bm,  Cm,  A,   states, cum, dy, dh_final, dx,
               ddt, dB, dC,  dA,  dh0, cb,     gst, dBh, dCh,     daK,
               daQ, Tk, hg,  dAp, batch, S,    nh,  hd, ds,       chunk,
               device, stream};
  const int w = hd > ds ? hd : ds;
  if (w <= 32) return launch<32>(a);
  if (w <= 64) return launch<64>(a);
  return launch<128>(a);
}
