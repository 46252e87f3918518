// ssd_scan_bwd: the gradient of the Mamba2 chunked SSD scan (ssd_scan.cu).
// Given dy (batch, S, nh*hd) and the gradient of the final state dh_final
// (batch, nh, ds, hd, or none), it computes dx, ddt, dB, dC, dA and, when
// the forward had an h0, dh0 — float32 in, float32 out.  It reads the
// forward's chunk-start states and its within-chunk cumsum of dt * A, which
// the forward writes anyway (its scratch, kept for the backward): the
// states as they are, the cumsum for each chunk's decay exp(cum_last) in
// the state pass.  Within a chunk the first kernel sums the cumsum again in
// double precision, once per (batch, chunk, head), so that exp(cum_q -
// cum_k) stays exact to float32 however strong the decay.
//
// Per chunk and head write a = cum, e_q = exp(a_q), r_k = exp(a_last - a_k),
// u_k = dt_k x_k, L[q,k] = exp(a_q - a_k) for k <= q (else 0), G = (C B^T) o
// L, h_c the chunk's starting state and g the gradient of its end state:
//   g_{c-1} = e_last g_c + sum_q e_q C_q (x) dy_q   (from dh_final; -> dh0)
//   du_k  = sum_{q>=k} G[q,k] dy_q + r_k (B_k . g);  dx = dt du,
//           ddt += <x, du>
//   dG    = dy u^T (k <= q),  dCB = sum_heads dG o L
//   dC_q  = sum_k dCB[q,k] B_k + sum_(heads, e) e_q dy_q[e] h_c[., e]
//   dB_k  = sum_q dCB[q,k] C_q + sum_(heads, e) r_k u_k[e] g[., e]
//   d cum: with M = (dG o L) o (C B^T) and T_k = r_k <u_k, B_k . g>,
//     dla_j = sum_{q>=j} (sum_{k<q} M[q,k] - sum_{q'>q} M[q',q]
//                         + e_q <dy_q, C_q h_c>)
//             + sum_{k<j} T_k + e_last <h_c, g>
//   (the reverse cumsum of d cum, with M's diagonal and T's tail summed in
//   the form where they cancel exactly: under strong decay the diagonal
//   dominates M and the reverse cumsum would otherwise subtract it away.
//   M's row sums and column sums are taken from the same bits of each
//   entry, so that the entries both hold cancel in the reverse cumsum; from
//   two products rounded apart, dA loses its bound under strong decay);
//   ddt += A dla, dA = sum_{batch, positions} dla dt.
//
// Replaces the gradient of src/repro/kernels/ssd_scan.py:ssd_scan's
// function (Pallas body _ssd_kernel).  The JAX package has no backward
// kernel: it differentiates its jnp chunk loop (models/ssm.py ssd_prefill).
// Bound on the card: per (batch, chunk, head) four state products of
// Q*ds*hd multiply-adds and two over the (Q, Q) triangle of hd, per (batch,
// chunk) three triangle products of ds (C.B^T and dCB's with B and C): a
// few hundred operations per byte at Q 256, so operations bound it.
//
// Design: every product on the tensor cores, mma.sync m16n8k8 TF32 into
// float32 with each operand split into hi and lo as it is staged in shared
// memory (csrc/ssd_mma.cuh, shared with the forward): 64 x 64 output tiles,
// 8 warps a block, each warp 16 rows x 32 columns (C.B^T, D_c, dB and dC)
// or, in the query and key kernels, two groups of 4 warps on two products
// at once, each warp a 32 x 32 quarter.  No float atomics: every sum
// over heads, groups of heads, tiles, chunks or batch is taken in a fixed
// order, so a call gives the same bits every time.  Eight launches on one
// stream:
//   0. ssd_bwd_cum, a warp per (batch, chunk, head): the within-chunk
//      cumsum of dt * A in double, into scratch, read by every later block.
//   1. ssd_bwd_cb: C.B^T of each chunk, once per (batch, chunk), 64 x 64
//      tiles at or below the diagonal, whole (zeros past the chunk).
//   2. ssd_bwd_dstate, per (batch, chunk, head, 64 x 64 of the state): the
//      chunk's own D_c = sum_q e_q C_q (x) dy_q.
//   3. ssd_bwd_state_pass, per (batch, head, four elements of the state):
//      over the chunks in reverse, the chunk's g replaces its D_c and
//      g <- e_last g + D_c, with each warp's share of <h_c, g>; what
//      reaches chunk 0 is dh0.
//   4. ssd_bwd_queries, per (batch, chunk, query tile, group of heads),
//      the heads in order: e_q <dy_q, C_q h_c> (from C_q . h_c), and dC's
//      state term summed over (head, e) into the group's share.
//   5. ssd_bwd_keys, per (batch, chunk, group of heads, key tile; a chunk's
//      key tiles launched together), the heads in
//      order: du from r (B . g) and each query tile's G^T dy (dx, ddt's
//      <x, du>), T; dB's state term summed over (head, e); and dG = dy u^T
//      formed once per (head, query tile), from which dCB_h = dG o L is
//      summed over the group's heads into shared memory and M = dCB_h o
//      C.B^T gives both its row sums (by key tile) and its column sums.
//   6. ssd_bwd_dcum, per (batch, chunk, head), a position a thread:
//      e_last <h_c, g> from the state pass's shares, dla by the formula
//      above (scans over the lanes, then the warps), ddt += A dla, the
//      chunk's share of dA; and its dCB tiles summed over the groups in
//      order (a tile a head).
//   7. ssd_bwd_dbdc, per (batch, chunk, tile, dB or dC, 64 columns of
//      d_state): dCB's products with C (dB) and B (dC), plus the groups'
//      state terms in order; the first block also sums dA over batch and
//      chunks in order.
// Groups of heads: the caller picks how many (kernels/ssd_scan.py takes 4
// heads a group, the last ragged: at zamba2's training shape 20 groups, 1280
// blocks of the key kernel; 8 measured within a few percent of it, 16
// slower, PERF.md); each group keeps its dCB tiles in
// shared memory while it walks its heads, so dB and dC are products once
// per (batch, chunk) and not once per head.  The key kernel stages three
// split pieces at a time (u, then B and g, or dy and G with L) and holds
// up to four dCB tiles: 206 KB of shared memory, one block of 8 warps an
// SM, its two warp groups working side by side.
// L is selected to 0 above the diagonal, never multiplied by a mask: there
// the exponent is positive and overflows, and 0 * inf is NaN.  The mapping
// from an accumulator fragment (rows g and g + 8, columns 2t and 2t + 1) to
// (q, k) is the same on ragged chunks: rows past the chunk (or past hd /
// ds) are staged as zeros and never stored.  The scratch is the caller's.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

#include "ssd_mma.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps: 4 of 16 rows x 2 of 32 columns
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChunk = 256;
constexpr int kMaxDim = 128;   // head_dim and d_state, multiples of 16
constexpr int kPassThreads = 256;
// row pitch of a piece read as [row][k] by the fragments (m x k of A, or
// n x k of B): 68 = 4 mod 32; read as [k][column]: 72 = 8 mod 32
constexpr int kLdK = kTile + 4;
constexpr int kLdN = kTile + 8;
constexpr int kSlot = 2 * kTile * kLdN;  // floats of a split piece (hi, lo)
using Tile = Piece<kTile, kThreads>;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// a split piece in shared memory: hi, then lo, kTile rows at pitch ld
struct Slot {
  float* hi;
  float* lo;
  int ld;
};
__device__ __forceinline__ Slot slot(float* at, int ld) {
  return {at, at + kTile * ld, ld};
}
template <class P, class F>
__device__ __forceinline__ void put(const P& p, const Slot& s, F f) {
  p.put(s.hi, s.lo, s.ld, f);
}

// This thread's place in a 64 x 64 output: its warp's first row m0 and
// column n0, and its lane's (g, t)
struct Frag {
  int m0, n0, g, t;
  // the row and column of accumulator value acc[n][e]
  __device__ __forceinline__ int row(int e) const {
    return m0 + g + 8 * (e >> 1);
  }
  __device__ __forceinline__ int col(int n, int e) const {
    return n0 + 8 * n + 2 * t + (e & 1);
  }
};
__device__ __forceinline__ Frag frag() {
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  return {16 * (w & 3), 32 * (w >> 2), lane >> 2, lane & 3};
}

// acc (this warp's 16 x 32 of a 64 x 64 output) += A . B over kmax of
// depth (a multiple of 8); A stored [m][k] (kAKM: [k][m]), B [k][n] (kBNK:
// [n][k])
template <bool kAKM, bool kBNK>
__device__ __forceinline__ void product(float (&acc)[4][4], const Slot& a,
                                        const Slot& b, int kmax,
                                        const Frag& f) {
  const int off = kBNK ? f.n0 * b.ld : f.n0;
  warp_product<4, kAKM, kBNK, kTile>(acc, a.hi, a.lo, a.ld, f.m0,
                                     b.hi + off, b.lo + off, b.ld, kmax);
}

// a warp's sum of v over its lanes; every lane gets the same bits
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// A warp's 32 x 32 quarter of a 64 x 64 output: rows m0 .. m0 + 31 in two
// 16-row fragments, columns n0 .. n0 + 31, and its lane's (g, t)
struct Quarter {
  int m0, n0, g, t;
  // the row and column of accumulator value acc[mi][n][e]
  __device__ __forceinline__ int row(int mi, int e) const {
    return m0 + 16 * mi + g + 8 * (e >> 1);
  }
  __device__ __forceinline__ int col(int n, int e) const {
    return n0 + 8 * n + 2 * t + (e & 1);
  }
};
__device__ __forceinline__ Quarter quarter() {
  const int w = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  return {32 * (w & 1), 32 * (w >> 1), lane >> 2, lane & 3};
}

__device__ __forceinline__ void zero(float (&acc)[2][4][4]) {
  zero(acc[0]);
  zero(acc[1]);
}

// acc (this warp's 32 x 32) += A . B over kmax of depth (a multiple of 8),
// split and ordered as warp_product takes it; each B fragment is loaded
// once for both 16-row fragments of A (kOneM: for one fragment at a time,
// in fewer registers).  kU of the 8-deep steps unrolled.
template <bool kAKM, bool kBNK, int kU = kTile / 8, bool kOneM = false>
__device__ __forceinline__ void product32(float (&acc)[2][4][4],
                                          const Slot& a, const Slot& b,
                                          int kmax, const Quarter& q) {
  constexpr int MT = kOneM ? 1 : 2;  // 16-row fragments a pass
  const int off = kBNK ? q.n0 * b.ld : q.n0;
  const float* __restrict__ Bh = b.hi + off;
  const float* __restrict__ Bl = b.lo + off;
#pragma unroll
  for (int m_pass = 0; m_pass < 2 / MT; ++m_pass) {
#pragma unroll kU
    for (int k = 0; k < kTile; k += 8) {
      if (k < kmax) {
        uint32_t ah[MT][4], al[MT][4];
#pragma unroll
        for (int j = 0; j < MT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int mi = m_pass * MT + j;
            const int m = q.m0 + 16 * mi + q.g + 8 * (e & 1);
            const int kk = k + q.t + 4 * (e >> 1);
            const int i = kAKM ? kk * a.ld + m : m * a.ld + kk;
            ah[j][e] = __float_as_uint(a.hi[i]);
            al[j][e] = __float_as_uint(a.lo[i]);
          }
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int col = 8 * n + q.g;
          const int i0 =
              kBNK ? col * b.ld + k + q.t : (k + q.t) * b.ld + col;
          const int i1 = kBNK ? i0 + 4 : i0 + 4 * b.ld;
          const uint32_t bh0 = __float_as_uint(Bh[i0]);
          const uint32_t bh1 = __float_as_uint(Bh[i1]);
          const uint32_t bl0 = __float_as_uint(Bl[i0]);
          const uint32_t bl1 = __float_as_uint(Bl[i1]);
#pragma unroll
          for (int j = 0; j < MT; ++j) {
            float(&c)[4] = acc[m_pass * MT + j][n];
            mma_tf32(c, al[j], bh0, bh1);
            mma_tf32(c, ah[j], bl0, bl1);
            mma_tf32(c, ah[j], bh0, bh1);
          }
        }
      }
    }
  }
}

// the sums over the four lanes of a row of p (rows q.row(mi, 2 i)), into
// red[column half * 64 + row] by the lanes with t = 0
__device__ __forceinline__ void quad_rows(float* red, float (&p)[2][2],
                                          const Quarter& q) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float v = p[mi][i];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      if (q.t == 0) red[q.n0 * 2 + q.row(mi, 2 * i)] = v;
      p[mi][i] = 0.0f;
    }
}

// ---- 0. the within-chunk cumsum, in double ----------------------------------

// blockIdx.x: batch * nc + chunk; y, warps: a head each.  cum64[(b * nh +
// h) * S + position] = sum of dt * A over the chunk up to the position, in
// double: eight positions a lane in order, then a scan over the lanes.
__global__ void __launch_bounds__(kThreads)
    ssd_bwd_cum(const float* __restrict__ dt, const float* __restrict__ A,
                double* __restrict__ cum64, int S, int nh, int chunk) {
  const int lane = threadIdx.x & 31;
  const int h = blockIdx.y * kWarps + (threadIdx.x >> 5);
  if (h >= nh) return;
  const int bc = blockIdx.x, nc = S / chunk, b = bc / nc, c = bc % nc;
  const long long row0 = (long long)b * S + (long long)c * chunk;
  const float a = A[h];
  double v[8], s = 0.0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int p = 8 * lane + i;
    if (p < chunk) s += (double)dt[(row0 + p) * nh + h] * a;
    v[i] = s;
  }
  double inc = s;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double n = __shfl_up_sync(0xffffffffu, inc, off);
    if (lane >= off) inc += n;
  }
  const double up = __shfl_up_sync(0xffffffffu, inc, 1);
  const double base = lane ? up : 0.0;
  double* out = cum64 + ((long long)b * nh + h) * S + (long long)c * chunk;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int p = 8 * lane + i;
    if (p < chunk) out[p] = base + v[i];
  }
}

// ---- 1. C.B^T once per (batch, chunk) --------------------------------------

constexpr size_t cb_smem() { return sizeof(float) * 2 * kSlot; }

// blockIdx.x: batch * nc + chunk; y: the tile (qi, kj), kj <= qi, written
// whole at cb[(bc * qp + q) * qp + k], qp = the chunk rounded up to 64.
__global__ void __launch_bounds__(kThreads, 2)
    ssd_bwd_cb(const float* __restrict__ Bm, const float* __restrict__ Cm,
               float* __restrict__ cb, int S, int ds, int chunk) {
  extern __shared__ __align__(16) float smem[];
  const Slot sc = slot(smem, kLdK);           // C rows [q][s]
  const Slot sb = slot(smem + kSlot, kLdK);   // B rows [k][s]: B^T as [n][k]
  int qi = 0, kj = blockIdx.y;
  while (kj > qi) kj -= ++qi;
  const int bc = blockIdx.x, nc = S / chunk, b = bc / nc, c = bc % nc;
  const long long row0 = (long long)b * S + (long long)c * chunk;
  const int q0 = qi * kTile, k0 = kj * kTile;
  const int nq = min(kTile, chunk - q0), nk = min(kTile, chunk - k0);
  const float* Cq = Cm + (row0 + q0) * ds;
  const float* Bk = Bm + (row0 + k0) * ds;
  const Frag f = frag();
  Tile pa, pb;
  auto fetch = [&](int s0) {
    pa.fetch([&](int r, int s) {
      return r < nq && s0 + s < ds ? load4(Cq + (long long)r * ds + s0 + s)
                                   : zero4();
    });
    pb.fetch([&](int r, int s) {
      return r < nk && s0 + s < ds ? load4(Bk + (long long)r * ds + s0 + s)
                                   : zero4();
    });
  };
  float acc[4][4];
  zero(acc);
  fetch(0);
  for (int s0 = 0; s0 < ds; s0 += kTile) {
    __syncthreads();  // the last piece's products are done
    put(pa, sc, Same());
    put(pb, sb, Same());
    __syncthreads();
    if (s0 + kTile < ds) fetch(s0 + kTile);
    product<false, true>(acc, sc, sb, min(kTile, ds - s0), f);
  }
  const int qp = (chunk + kTile - 1) / kTile * kTile;
  float* out = cb + ((long long)bc * qp + q0) * qp + k0;
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; e += 2)
      store2(out + (long long)f.row(e) * qp + f.col(n, e), acc[n][e],
             acc[n][e + 1]);
}

// ---- 2. each chunk's own D_c -----------------------------------------------

constexpr size_t dstate_smem() {
  return sizeof(double) * kMaxChunk + sizeof(float) * 2 * kSlot;
}

// blockIdx.x: batch * nc + chunk; y: head; z: (64 rows of d_state, 64
// columns of head_dim).  Writes D_c[s][e] = sum_q e_q C_q[s] dy_q[e] to
// g[((bc * nh + h) * ds + s) * hd + e].
__global__ void __launch_bounds__(kThreads, 2)
    ssd_bwd_dstate(const float* __restrict__ Cm,
                   const double* __restrict__ cum64,
                   const float* __restrict__ dy, float* __restrict__ gst,
                   int S, int nh, int hd, int ds, int chunk) {
  extern __shared__ __align__(16) float smem[];
  double* cumc = reinterpret_cast<double*>(smem);  // kMaxChunk
  float* base = smem + 2 * kMaxChunk;
  const Slot sa = slot(base, kLdN);           // e_q C_q [q][s]: A as [k][m]
  const Slot sb = slot(base + kSlot, kLdN);   // dy_q [q][e]
  const int bc = blockIdx.x, h = blockIdx.y;
  const int ne = (hd + kTile - 1) / kTile;
  const int s0 = blockIdx.z / ne * kTile, e0 = blockIdx.z % ne * kTile;
  const int nc = S / chunk, b = bc / nc, c = bc % nc;
  const long long row0 = (long long)b * S + (long long)c * chunk;
  const int dih = nh * hd;
  const Frag f = frag();
  const double* cc = cum64 + ((long long)b * nh + h) * S + (long long)c * chunk;
  for (int i = threadIdx.x; i < chunk; i += kThreads) cumc[i] = cc[i];
  Tile pa, pb;
  auto fetch = [&](int q0) {
    const int nq = min(kTile, chunk - q0);
    pa.fetch([&](int r, int s) {
      return r < nq && s0 + s < ds
                 ? load4(Cm + (row0 + q0 + r) * ds + s0 + s)
                 : zero4();
    });
    pb.fetch([&](int r, int e) {
      return r < nq && e0 + e < hd
                 ? load4(dy + (row0 + q0 + r) * dih + (long long)h * hd +
                         e0 + e)
                 : zero4();
    });
  };
  float acc[4][4];
  zero(acc);
  fetch(0);
  for (int q0 = 0; q0 < chunk; q0 += kTile) {
    __syncthreads();  // the last piece's products are done; cumc written
    put(pa, sa, [&](int r, int, float4 v) {
      return q0 + r < chunk ? scale4(expf((float)cumc[q0 + r]), v) : zero4();
    });
    put(pb, sb, Same());
    __syncthreads();
    if (q0 + kTile < chunk) fetch(q0 + kTile);
    product<true, false>(acc, sa, sb, round8(min(kTile, chunk - q0)), f);
  }
  float* out = gst + ((long long)bc * nh + h) * ds * hd;
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; e += 2) {
      const int s = s0 + f.row(e), col = e0 + f.col(n, e);
      if (s < ds && col < hd)
        store2(out + (long long)s * hd + col, acc[n][e], acc[n][e + 1]);
    }
}

// ---- 3. the reverse state pass ---------------------------------------------

// blockIdx.x: batch * nh + head; y, threads: four elements of its state
// each.  Over the chunks from the last: the chunk's D_c is read (the next
// one's before this one's is replaced), its g written in its place,
// g <- exp(cum_last) g + D_c; and each warp's share of <h_c, g> (h_c the
// forward's chunk-start state) to hgp[((b * nc + c) * nh + h) * W + warp],
// W = the state's warps (state_size / 128).
__global__ void __launch_bounds__(kPassThreads)
    ssd_bwd_state_pass(float* __restrict__ gst, const float* __restrict__ cum,
                       const float* __restrict__ states,
                       const float* __restrict__ dh_final,
                       float* __restrict__ dh0, float* __restrict__ hgp,
                       int S, int nh, int state_size, int chunk) {
  const int i = (blockIdx.y * kPassThreads + threadIdx.x) * 4;
  if (i >= state_size) return;  // whole warps: state_size is a multiple of 256
  const int bh = blockIdx.x, b = bh / nh, h = bh % nh;
  const int nc = S / chunk, n_w = state_size / 128, wi = i / 128;
  const long long at = (long long)bh * state_size + i;
  float4 g = dh_final ? load4(dh_final + at) : zero4();
  const float* last = cum + (long long)bh * S + chunk - 1;
  const long long step = (long long)nh * state_size;  // one chunk further
  const long long first = ((long long)b * nc * nh + h) * state_size + i;
  float* p = gst + first + (nc - 1) * step;
  const float* hs = states + first + (nc - 1) * step;
  float4 d = nc > 0 ? load4(p) : zero4();
  for (int c = nc - 1; c >= 0; --c, p -= step, hs -= step) {
    const float4 next = c > 0 ? load4(p - step) : zero4();
    const float4 hc = load4(hs);
    *reinterpret_cast<float4*>(p) = g;
    float s = fmaf(hc.x, g.x, fmaf(hc.y, g.y, fmaf(hc.z, g.z, hc.w * g.w)));
    s = warp_sum(s);
    if ((threadIdx.x & 31) == 0)
      hgp[(((long long)b * nc + c) * nh + h) * n_w + wi] = s;
    const float e = expf(last[(long long)c * chunk]);
    g = make_float4(fmaf(e, g.x, d.x), fmaf(e, g.y, d.y), fmaf(e, g.z, d.z),
                    fmaf(e, g.w, d.w));
    d = next;
  }
  if (dh0) *reinterpret_cast<float4*>(dh0 + at) = g;
}

// the heads [begin, end) of group grp of groups
struct Heads {
  int begin, end;
};
__device__ __forceinline__ Heads heads_of(int grp, int groups, int nh) {
  const int per = (nh + groups - 1) / groups;
  const int begin = min(nh, grp * per);
  return {begin, min(nh, begin + per)};
}

// ---- 4. query tiles: e_q <dy_q, C_q h_c>, dC's state term by group ---------

template <int NS>
constexpr size_t queries_smem() {
  return sizeof(float) * (2 * NS + 1) * kSlot;
}

// blockIdx.x: the query tile; y: batch * nc + chunk; z: the group of heads.
// daQ[((b * nh + h) * 2 + half) * S + position] = e_q <dy_q, C_q h_c> over
// one half of each 64 columns of head_dim; the group's share of dC's state
// term, sum over its heads (in order) and e of e_q dy_q[e] h_c[s, e], to
// dCsp[((bc * groups + grp) * qp + q) * ds + s].  Warps 0-3 take C_q . h_c
// and e_q <dy_q, .>, warps 4-7 dy_q . h_c^T, each warp a 32 x 32 quarter.
template <int NS>
__global__ void __launch_bounds__(kThreads, 1)
    ssd_bwd_queries(const float* __restrict__ Cm,
                    const float* __restrict__ states,
                    const double* __restrict__ cum64,
                    const float* __restrict__ dy, float* __restrict__ daQ,
                    float* __restrict__ dCsp, int S, int nh, int hd, int ds,
                    int chunk, int groups) {
  extern __shared__ __align__(16) float smem[];
  Slot cs[NS], hs[NS];
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    cs[i] = slot(smem + i * kSlot, kLdK);         // C_q [q][s]
    hs[i] = slot(smem + (NS + i) * kSlot, kLdN);  // h_c [s][e]
  }
  const Slot ys = slot(smem + 2 * NS * kSlot, kLdK);  // dy_q [q][e]
  const int tid = threadIdx.x;
  const bool cw = tid < kThreads / 2;  // a warp of C_q . h_c, else of dC's
  const int qt = blockIdx.x, bc = blockIdx.y, grp = blockIdx.z;
  const int nc = S / chunk, b = bc / nc, c = bc % nc;
  const int qp = (chunk + kTile - 1) / kTile * kTile;
  const int q0 = qt * kTile, nq = min(kTile, chunk - q0);
  const long long row0 = (long long)b * S + (long long)c * chunk;
  const int dih = nh * hd, ne = (hd + kTile - 1) / kTile;
  const Heads hh = heads_of(grp, groups, nh);
  const int n_steps = (hh.end - hh.begin) * ne;
  const Quarter f = quarter();
  {
    Tile pc;
    for (int sc = 0; sc < NS; ++sc) {
      pc.fetch([&](int r, int s) {
        return r < nq && sc * kTile + s < ds
                   ? load4(Cm + (row0 + q0 + r) * ds + sc * kTile + s)
                   : zero4();
      });
      put(pc, cs[sc], Same());
    }
  }
  Tile py, ph[NS];
  auto fetch = [&](int step) {
    const int h = hh.begin + step / ne, e0 = step % ne * kTile;
    py.fetch([&](int r, int e) {
      return r < nq && e0 + e < hd
                 ? load4(dy + (row0 + q0 + r) * dih + (long long)h * hd +
                         e0 + e)
                 : zero4();
    });
    const float* hc = states + ((long long)bc * nh + h) * ds * hd;
#pragma unroll
    for (int sc = 0; sc < NS; ++sc)
      ph[sc].fetch([&](int r, int e) {
        const int s = sc * kTile + r;
        return s < ds && e0 + e < hd ? load4(hc + (long long)s * hd + e0 + e)
                                     : zero4();
      });
  };
  // warps 0-3: reg[0] C_q . h_c over 64 columns of head_dim, reg[1] dy_q
  // at their places, rp their share of <dy_q, C_q h_c>; warps 4-7: reg[NS
  // + s] dy_q . h_c^T of a head, reg[s] the group's dC state term
  float reg[2 * NS][2][4][4], rp[2][2] = {};
#pragma unroll
  for (int i = 0; i < 2 * NS; ++i) zero(reg[i]);
  // the next step's pieces are loaded while this one's products run, where
  // the registers allow (one piece of d_state)
  constexpr bool kAhead = NS == 1;
  if (kAhead && n_steps > 0) fetch(0);
  for (int step = 0; step < n_steps; ++step) {
    const int h = hh.begin + step / ne, ec = step % ne, e0 = ec * kTile;
    __syncthreads();  // the last step's products are done
    if (!kAhead) fetch(step);
    put(py, ys, Same());
#pragma unroll
    for (int sc = 0; sc < NS; ++sc) put(ph[sc], hs[sc], Same());
    __syncthreads();
    if (kAhead && step + 1 < n_steps) fetch(step + 1);
    // cum at this thread's rows, for e_q after the products
    double cqv[2][2] = {};
    if (ec == ne - 1) {
      const double* cq =
          cum64 + ((long long)b * nh + h) * S + (long long)c * chunk + q0;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = f.row(mi, 2 * i);
          if (r < nq) cqv[mi][i] = cq[r];
        }
    }
    if (cw) {
      // C_q . h_c, then <dy_q, .> (dy loaded while the product runs)
      float(&ch)[2][4][4] = reg[0];
      float(&dyv)[2][4][4] = reg[1];
      const float* dyq = dy + (row0 + q0) * dih + (long long)h * hd + e0;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 4; e += 2) {
            const int r = f.row(mi, e), col = f.col(n, e);
            const float2 v = r < nq && e0 + col < hd
                                 ? load2(dyq + (long long)r * dih + col)
                                 : make_float2(0.0f, 0.0f);
            dyv[mi][n][e] = v.x;
            dyv[mi][n][e + 1] = v.y;
          }
      zero(ch);
#pragma unroll
      for (int sc = 0; sc < NS; ++sc)
        product32<false, false, 2>(ch, cs[sc], hs[sc],
                                   min(kTile, ds - sc * kTile), f);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            rp[mi][e >> 1] = fmaf(dyv[mi][n][e], ch[mi][n][e], rp[mi][e >> 1]);
      if (ec == ne - 1)
        // e_q times it, by query and 32 columns of head_dim
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            float v = rp[mi][i];
            v += __shfl_xor_sync(0xffffffffu, v, 1);
            v += __shfl_xor_sync(0xffffffffu, v, 2);
            const int r = f.row(mi, 2 * i);
            if (f.t == 0 && r < nq)
              daQ[(((long long)b * nh + h) * 2 + f.n0 / 32) * S +
                  (long long)c * chunk + q0 + r] =
                  expf((float)cqv[mi][i]) * v;
            rp[mi][i] = 0.0f;
          }
    } else {
      // dy_q . h_c^T, this head's share of dC's state term before e_q
#pragma unroll
      for (int sc = 0; sc < NS; ++sc)
        product32<false, true, 2>(reg[NS + sc], ys, hs[sc],
                                  min(kTile, hd - e0), f);
      if (ec == ne - 1) {
        float eq[2][2];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int i = 0; i < 2; ++i)
            eq[mi][i] = f.row(mi, 2 * i) < nq ? expf((float)cqv[mi][i]) : 0.0f;
#pragma unroll
        for (int sc = 0; sc < NS; ++sc)
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int n = 0; n < 4; ++n)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                float& dtmp = reg[NS + sc][mi][n][e];
                reg[sc][mi][n][e] =
                    fmaf(eq[mi][e >> 1], dtmp, reg[sc][mi][n][e]);
                dtmp = 0.0f;
              }
      }
    }
  }
  if (cw) return;
  float* out = dCsp + (((long long)bc * groups + grp) * qp + q0) * ds;
#pragma unroll
  for (int sc = 0; sc < NS; ++sc)
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          const int col = sc * kTile + f.col(n, e);
          if (col < ds)
            store2(out + (long long)f.row(mi, e) * ds + col,
                   reg[sc][mi][n][e], reg[sc][mi][n][e + 1]);
        }
}

// ---- 5. key tiles: du, dx, ddt, T, dB's state term, dG once, dCB, M --------

__host__ __device__ constexpr int keys_head() {  // floats before slots
  return 2 * kMaxChunk + 2 * kTile + 4 * kTile;
}
// warps 0-3's second piece of dB's state term, where d_state takes two
constexpr int kDbs2 = 32 * (kThreads / 2);
inline size_t keys_smem(int n_t, int ns) {
  return sizeof(float) * (keys_head() + 3 * kSlot +
                          (n_t + 1) * kTile * kLdN + (ns > 1 ? kDbs2 : 0));
}

// blockIdx.x: the key tile; y: batch * nc + chunk; z: the group of heads
// (a chunk's key tiles launched together, so that they share dy, g and
// C.B^T in the L2 cache).  Per head of the group, in order, the steps: NE x
// NS of the state terms (u, B and g staged), then per query tile NE (dy
// and, with the first, G = C.B^T o L and L itself staged; u again where
// head_dim takes two pieces, else it stays).  Warps 0-3 take dG (in the
// state steps r (u . g^T), dB's state term) and M; warps 4-7 take du (B.g,
// then G^T dy), T, dx and ddt: each warp a 32 x 32 quarter, so the two
// products of a step run side by side and M's sums overlap du's product.
template <int NE, int NS>
__global__ void __launch_bounds__(kThreads, 1)
    ssd_bwd_keys(const float* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ Bm, const float* __restrict__ cb,
                 const double* __restrict__ cum64,
                 const float* __restrict__ gst, const float* __restrict__ dy,
                 float* __restrict__ dx, float* __restrict__ ddt,
                 float* __restrict__ daK, float* __restrict__ Tk,
                 float* __restrict__ rowp, float* __restrict__ dCBp,
                 float* __restrict__ dBsp, int S, int nh, int hd, int ds,
                 int chunk, int groups) {
  constexpr int KN = NE > NS ? NE : NS;
  // depth steps of the products unrolled, and A's fragments a pass: all 8
  // and both where the registers allow (one piece of head_dim and d_state)
  constexpr int kUn = NE * NS > 1 ? 1 : kTile / 8;
  constexpr bool kOneM = NE * NS > 1;
  extern __shared__ __align__(16) float smem[];
  double* cumc = reinterpret_cast<double*>(smem);  // kMaxChunk
  float* rk = smem + 2 * kMaxChunk;   // r_k of the key tile
  float* dtk = rk + kTile;            // dt_k of the key tile
  float* red_c = dtk + kTile;         // M's column sums by row half
  float* red_r = red_c + 2 * kTile;   // T's and ddt's rows by column half
  float* slots = smem + keys_head();
  float* Ls = slots + 3 * kSlot;      // L of the query tile [q][k]
  float* dcb = Ls + kTile * kLdN;     // the group's dCB tiles [q][k]

  const int tid = threadIdx.x;
  const bool dw = tid < kThreads / 2;  // a warp of dG and M, else of du
  const int n_t = (chunk + kTile - 1) / kTile;
  // where d_state takes two pieces, warps 0-3 keep the second piece of
  // dB's state term here, a value a thread in turn
  float* dbs2 = dcb + n_t * kTile * kLdN;
  const int kt = blockIdx.x, bc = blockIdx.y, grp = blockIdx.z;
  const int nc = S / chunk, b = bc / nc, c = bc % nc;
  const int qp = n_t * kTile;
  const int k0 = kt * kTile, nk = min(kTile, chunk - k0);
  const long long row0 = (long long)b * S + (long long)c * chunk;
  const int dih = nh * hd;
  const Heads hh = heads_of(grp, groups, nh);
  const int n_start = NE * NS, n_qt = n_t - kt;
  const int per_head = n_start + n_qt * NE;
  const int n_steps = (hh.end - hh.begin) * per_head;
  const Quarter f = quarter();

  for (int i = tid; i < n_qt * kTile * kLdN; i += kThreads) dcb[i] = 0.0f;
  if (NS > 1)
    for (int i = tid; i < kDbs2; i += kThreads) dbs2[i] = 0.0f;
  Tile p0, p1, p2;
  auto fetch = [&](int step) {
    const int h = hh.begin + step / per_head, j = step % per_head;
    const float* xk = x + (row0 + k0) * dih + (long long)h * hd;
    if (j < n_start) {
      const int e0 = j / NS * kTile, s0 = j % NS * kTile;
      const float* gh = gst + ((long long)bc * nh + h) * ds * hd;
      p0.fetch([&](int r, int e) {
        return r < nk && e0 + e < hd ? load4(xk + (long long)r * dih + e0 + e)
                                     : zero4();
      });
      p1.fetch([&](int r, int s) {
        return r < nk && s0 + s < ds
                   ? load4(Bm + (row0 + k0 + r) * ds + s0 + s)
                   : zero4();
      });
      p2.fetch([&](int r, int e) {
        return s0 + r < ds && e0 + e < hd
                   ? load4(gh + (long long)(s0 + r) * hd + e0 + e)
                   : zero4();
      });
    } else {
      const int jj = j - n_start, e0 = jj % NE * kTile;
      const int q0 = (kt + jj / NE) * kTile, nq = min(kTile, chunk - q0);
      if (NE > 1)
        p0.fetch([&](int r, int e) {
          return r < nk && e0 + e < hd
                     ? load4(xk + (long long)r * dih + e0 + e)
                     : zero4();
        });
      p1.fetch([&](int r, int e) {
        return r < nq && e0 + e < hd
                   ? load4(dy + (row0 + q0 + r) * dih + (long long)h * hd +
                           e0 + e)
                   : zero4();
      });
      if (jj % NE == 0)
        p2.fetch([&](int r, int k) {
          return load4(cb + ((long long)bc * qp + q0 + r) * qp + k0 + k);
        });
    }
  };
  // u = dt x, its rows past the chunk zero
  auto scale_u = [&](int r, int, float4 v) { return scale4(dtk[r], v); };

  // warps 0-3: dacc is dG over a query tile (r (u . g^T) in the state
  // steps), side C.B^T at their places (read at M's sums instead where the
  // registers do not allow), keep[s] dB's state term over the
  // group's heads, cs their share of M's column sums (over their rows and
  // the query tiles); warps 4-7: keep[e] du, side x at their places (for
  // ddt; NE = 1), tp their share of T
  float acc[2][4][4], side[2][4][4], keep[KN][2][4][4];
  float cs[4][2] = {}, tp[2][2] = {};
  // warps 0-3 hold NSR pieces of dB's state term in keep (the second, if
  // any, in dbs2); where that leaves the last of keep free, dG takes it
  constexpr int NSR = NS > 1 ? 1 : NS;
  float(&dacc)[2][4][4] = NSR < KN ? keep[KN - 1] : acc;
#pragma unroll
  for (int i = 0; i < KN; ++i) zero(keep[i]);
  // a head's cum over the chunk (a position a thread) and dt of the key
  // tile, loaded a head ahead
  double cum_next = 0.0;
  float dt_next = 0.0f;
  auto fetch_head = [&](int h) {
    if (tid < chunk)
      cum_next = cum64[((long long)b * nh + h) * S + (long long)c * chunk +
                       tid];
    if (tid < nk) dt_next = dt[(row0 + k0 + tid) * nh + h];
  };
  // the next step's pieces are loaded while this one's products run, where
  // the registers allow (one piece of head_dim and of d_state)
  constexpr bool kAhead = NE * NS == 1;
  if (n_steps > 0) {
    fetch_head(hh.begin);
    if (kAhead) fetch(0);
  }
  for (int step = 0; step < n_steps; ++step) {
    const int h = hh.begin + step / per_head, j = step % per_head;
    const float* xk = x + (row0 + k0) * dih + (long long)h * hd;
    __syncthreads();  // the last step's products and cumc's readers are done
    if (!kAhead) fetch(step);
    if (j == 0) {
      // the head's cum, dt and r of the key tile
      if (tid < chunk) cumc[tid] = cum_next;
      if (tid < kTile) dtk[tid] = dt_next;
      __syncthreads();
      if (tid < kTile)
        rk[tid] = tid < nk ? expf((float)(cumc[chunk - 1] - cumc[k0 + tid]))
                           : 0.0f;
      if (h + 1 < hh.end) fetch_head(h + 1);
      if (!dw)
#pragma unroll
        for (int i = 0; i < NE; ++i) zero(keep[i]);
    }
    if (j < n_start) {
      const int ec = j / NS, sc = j % NS;
      const Slot U = slot(slots, kLdK);           // u_k [k][e]
      const Slot Bk = slot(slots + kSlot, kLdK);  // B_k [k][s]
      const Slot Gs = slot(slots + 2 * kSlot, kLdN);  // g [s][e]
      put(p0, U, scale_u);
      put(p1, Bk, Same());
      put(p2, Gs, Same());
      __syncthreads();
      if (kAhead && step + 1 < n_steps) fetch(step + 1);
      if (dw) {
        // r_k (u_k . g^T) into dB's state term
        zero(dacc);
        product32<false, true, kUn, kOneM>(dacc, U, Gs,
                                    min(kTile, hd - ec * kTile), f);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int n = 0; n < 4; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float r = rk[f.row(mi, e)];
              if (sc < NSR) {
                float& s = keep[0][mi][n][e];
                s = fmaf(r, dacc[mi][n][e], s);
              } else {
                float& s = dbs2[((mi * 4 + n) * 4 + e) * (kThreads / 2) + tid];
                s = fmaf(r, dacc[mi][n][e], s);
              }
            }
      } else {
        // du's state term B_k . g; complete over these 64 columns of
        // head_dim at the last piece of d_state: r_k times it, and T_k =
        // <u_k, du_k>'s share, u as staged (hi + lo: u to about 2^-22 of
        // itself)
#pragma unroll
        for (int i = 0; i < NE; ++i)
          if (i == ec) {
            product32<false, false, kUn, kOneM>(keep[i], Bk, Gs,
                                         min(kTile, ds - sc * kTile), f);
            if (sc == NS - 1)
#pragma unroll
              for (int mi = 0; mi < 2; ++mi)
#pragma unroll
                for (int n = 0; n < 4; ++n)
#pragma unroll
                  for (int e = 0; e < 4; e += 2) {
                    const int r = f.row(mi, e), at = r * U.ld + f.col(n, e);
                    const float2 hi = load2(U.hi + at), lo = load2(U.lo + at);
                    float* d = keep[i][mi][n];
                    d[e] *= rk[r];
                    d[e + 1] *= rk[r];
                    tp[mi][e >> 1] = fmaf(hi.x + lo.x, d[e], tp[mi][e >> 1]);
                    tp[mi][e >> 1] =
                        fmaf(hi.y + lo.y, d[e + 1], tp[mi][e >> 1]);
                  }
          }
      }
      if (j == n_start - 1) {
        if (!dw) quad_rows(red_r, tp, f);
        __syncthreads();
        if (tid < nk)
          Tk[((long long)b * nh + h) * S + (long long)c * chunk + k0 + tid] =
              red_r[tid] + red_r[kTile + tid];
      }
      continue;
    }
    const int jj = j - n_start, qt = kt + jj / NE, ec = jj % NE;
    const int q0 = qt * kTile, nq = min(kTile, chunk - q0);
    const Slot U = slot(slots, kLdK);               // u_k [k][e]
    const Slot D = slot(slots + kSlot, kLdN);       // dy_q [q][e]
    const Slot Gt = slot(slots + 2 * kSlot, kLdN);  // G [q][k]: A as [k][m]
    if (NE > 1) put(p0, U, scale_u);
    put(p1, D, Same());
    if (ec == 0)
      put(p2, Gt, [&](int r, int k, float4 v) {
        // L selected, not masked: above the diagonal it overflows; kept
        // for dCB = dG o L
        const int q = q0 + r, kg = k0 + k;
        float l[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        if (q < chunk) {
          const double a = cumc[q];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (kg + i <= q) l[i] = expf((float)(a - cumc[kg + i]));
        }
        *reinterpret_cast<float4*>(Ls + r * kLdN + k) =
            make_float4(l[0], l[1], l[2], l[3]);
        return make_float4(v.x * l[0], v.y * l[1], v.z * l[2], v.w * l[3]);
      });
    __syncthreads();
    if (kAhead && step + 1 < n_steps) fetch(step + 1);
    const float* cbt = cb + ((long long)bc * qp + q0) * qp + k0;
    if (dw) {
      if (ec == 0) {
        zero(dacc);
        if (kAhead)
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int n = 0; n < 4; ++n)
#pragma unroll
              for (int e = 0; e < 4; e += 2) {
                const float2 v =
                    load2(cbt + (long long)f.row(mi, e) * qp + f.col(n, e));
                side[mi][n][e] = v.x;
                side[mi][n][e + 1] = v.y;
              }
      }
      // dG = dy_q . u_k^T over these 64 columns of head_dim
      product32<false, true, kUn, kOneM>(dacc, D, U,
                                         min(kTile, hd - ec * kTile), f);
      if (ec == NE - 1) {
        // dCB_h = dG o L into the group's tile; M = dCB_h o C.B^T, whose
        // row sums (this key tile's share, by query and 32 columns) and
        // column sums are taken from the same bits of each entry, k < q
        float* tile_cb = dcb + (qt - kt) * kTile * kLdN;
        float rs[2][2] = {};
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int n = 0; n < 4; ++n)
#pragma unroll
            for (int e = 0; e < 4; e += 2) {
              const int at = f.row(mi, e) * kLdN + f.col(n, e);
              const int q = q0 + f.row(mi, e), k = k0 + f.col(n, e);
              const float2 l = load2(Ls + at), a = load2(tile_cb + at);
              const float2 w =
                  kAhead ? make_float2(side[mi][n][e], side[mi][n][e + 1])
                         : load2(cbt + (long long)f.row(mi, e) * qp +
                                 f.col(n, e));
              const float d0 = dacc[mi][n][e] * l.x;
              const float d1 = dacc[mi][n][e + 1] * l.y;
              store2(tile_cb + at, a.x + d0, a.y + d1);
              const float m0 = k < q ? d0 * w.x : 0.0f;
              const float m1 = k + 1 < q ? d1 * w.y : 0.0f;
              rs[mi][e >> 1] += m0;
              rs[mi][e >> 1] += m1;
              cs[n][0] += m0;
              cs[n][1] += m1;
            }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            float v = rs[mi][i];
            v += __shfl_xor_sync(0xffffffffu, v, 1);
            v += __shfl_xor_sync(0xffffffffu, v, 2);
            const int r = f.row(mi, 2 * i);
            if (f.t == 0 && q0 + r < chunk)
              rowp[((((long long)b * nh + h) * n_t + kt) * 2 + f.n0 / 32) *
                       S +
                   (long long)c * chunk + q0 + r] = v;
          }
      }
    } else {
      if (NE == 1 && qt == n_t - 1)
        // x at this warp's places for ddt, loaded while du's product runs
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int n = 0; n < 4; ++n)
#pragma unroll
            for (int e = 0; e < 4; e += 2) {
              const int r = f.row(mi, e), col = f.col(n, e);
              const float2 v = r < nk && col < hd
                                   ? load2(xk + (long long)r * dih + col)
                                   : make_float2(0.0f, 0.0f);
              side[mi][n][e] = v.x;
              side[mi][n][e + 1] = v.y;
            }
      // du += G^T dy_q
#pragma unroll
      for (int i = 0; i < NE; ++i)
        if (i == ec)
          product32<true, false, kUn, kOneM>(keep[i], Gt, D, round8(nq),
                                             f);
    }
    if (qt < n_t - 1 || ec < NE - 1) continue;
    // the head's last step: M's column sums over the lanes of a column and
    // the two warps of its rows, in order; dx = dt du, ddt's <x, du>
    if (dw) {
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float v = cs[n][i];
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          v += __shfl_xor_sync(0xffffffffu, v, 8);
          v += __shfl_xor_sync(0xffffffffu, v, 16);
          if (f.g == 0) red_c[f.m0 * 2 + f.col(n, i)] = v;
          cs[n][i] = 0.0f;
        }
    } else {
      float* dxk = dx + (row0 + k0) * dih + (long long)h * hd;
#pragma unroll
      for (int i = 0; i < NE; ++i)
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int n = 0; n < 4; ++n)
#pragma unroll
            for (int e = 0; e < 4; e += 2) {
              const int r = f.row(mi, e), col = i * kTile + f.col(n, e);
              const bool in = r < nk && col < hd;
              float2 v = make_float2(side[mi][n][e], side[mi][n][e + 1]);
              if (NE > 1)
                v = in ? load2(xk + (long long)r * dih + col)
                       : make_float2(0.0f, 0.0f);
              const float* d = keep[i][mi][n];
              tp[mi][e >> 1] = fmaf(v.x, d[e], tp[mi][e >> 1]);
              tp[mi][e >> 1] = fmaf(v.y, d[e + 1], tp[mi][e >> 1]);
              if (in)
                store2(dxk + (long long)r * dih + col, dtk[r] * d[e],
                       dtk[r] * d[e + 1]);
            }
      quad_rows(red_r, tp, f);
    }
    __syncthreads();
    if (tid < nk) {
      ddt[(row0 + k0 + tid) * nh + h] = red_r[tid] + red_r[kTile + tid];
      daK[((long long)b * nh + h) * S + (long long)c * chunk + k0 + tid] =
          -(red_c[tid] + red_c[kTile + tid]);
    }
  }
  __syncthreads();
  // the group's dCB tiles, whole, and its share of dB's state term
  const int n_pairs = n_t * (n_t + 1) / 2;
  for (int j = 0; j < n_qt; ++j) {
    const int qt = kt + j;
    float* out = dCBp + (((long long)bc * groups + grp) * n_pairs +
                         qt * (qt + 1) / 2 + kt) * kTile * kTile;
    const float* tile_cb = dcb + j * kTile * kLdN;
    for (int i = tid; i < kTile * kTile / 4; i += kThreads) {
      const int r = i / (kTile / 4), c4 = i % (kTile / 4) * 4;
      *reinterpret_cast<float4*>(out + r * kTile + c4) =
          load4(tile_cb + r * kLdN + c4);
    }
  }
  if (!dw) return;
  float* out = dBsp + (((long long)bc * groups + grp) * qp + k0) * ds;
#pragma unroll
  for (int i = 0; i < NS; ++i)
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          const int col = i * kTile + f.col(n, e);
          const int at = ((mi * 4 + n) * 4 + e) * (kThreads / 2) + tid;
          const float v0 = i < NSR ? keep[0][mi][n][e] : dbs2[at];
          const float v1 =
              i < NSR ? keep[0][mi][n][e + 1] : dbs2[at + kThreads / 2];
          if (col < ds)
            store2(out + (long long)f.row(mi, e) * ds + col, v0, v1);
        }
}

// ---- 6. d cum, its scans, ddt and dA's share --------------------------------

// blockIdx.x: batch * nc + chunk; y: head.  Thread j takes position j; the
// scans run over the lanes of each warp, then over the warps in order.
__global__ void __launch_bounds__(kThreads)
    ssd_bwd_dcum(const float* __restrict__ dt, const float* __restrict__ A,
                 const double* __restrict__ cum64,
                 const float* __restrict__ hgp, const float* __restrict__ daK,
                 const float* __restrict__ daQ, const float* __restrict__ Tk,
                 const float* __restrict__ rowp, float* __restrict__ ddt,
                 float* __restrict__ dAp, float* __restrict__ dCBp, int S,
                 int nh, int hd, int ds, int chunk, int groups) {
  __shared__ float t_w[kWarps], da_w[kWarps], dA_w[kWarps];
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int bc = blockIdx.x, h = blockIdx.y;
  const int nc = S / chunk, b = bc / nc, c = bc % nc;
  const int n_t = (chunk + kTile - 1) / kTile;
  const long long row0 = (long long)b * S + (long long)c * chunk;
  const long long at = ((long long)b * nh + h) * S + (long long)c * chunk;
  // <h_c, g>: the state pass's shares by warp, summed in order
  __shared__ float hg_s;
  if (tid == 0) {
    const int n_w = ds * hd / 128;
    const float* part = hgp + ((long long)bc * nh + h) * n_w;
    float s = 0.0f;
    for (int i = 0; i < n_w; ++i) s += part[i];
    hg_s = s;
  }
  // d cum at position tid (the columns' part, the queries' state term by
  // half, the rows' parts by key tile and half, in order) and T
  const int p = tid;
  float da = 0.0f, T = 0.0f;
  if (p < chunk) {
    const float* qs = daQ + ((long long)b * nh + h) * 2 * S +
                      (long long)c * chunk;
    const float* rows = rowp + ((long long)b * nh + h) * n_t * 2 * S +
                        (long long)c * chunk;
    da = daK[at + p] + (qs[p] + qs[S + p]);
    for (int kt = 0; kt <= p / kTile; ++kt)
      da += rows[2 * kt * S + p] + rows[(2 * kt + 1) * S + p];
    T = Tk[at + p];
  }
  // T summed over the lanes up to this one, da over the lanes from it on
  float ti = T, di = da;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float tn = __shfl_up_sync(0xffffffffu, ti, off);
    const float dn = __shfl_down_sync(0xffffffffu, di, off);
    if (lane >= off) ti += tn;
    if (lane + off < 32) di += dn;
  }
  const float tu = __shfl_up_sync(0xffffffffu, ti, 1);
  if (lane == 0) da_w[w] = di;
  if (lane == 31) t_w[w] = ti;
  __syncthreads();
  float tb = 0.0f, db = 0.0f;
  for (int i = 0; i < w; ++i) tb += t_w[i];
  for (int i = kWarps - 1; i > w; --i) db += da_w[i];
  const float hg = expf((float)cum64[at + chunk - 1]) * hg_s;
  // dla_j = sum_{k < j} T_k + e_last <h_c, g> + sum_{q >= j} da_q
  const float dla = ((tb + (lane ? tu : 0.0f)) + hg) + (db + di);
  float d = 0.0f;
  if (p < chunk) {
    const long long at_dt = (row0 + p) * nh + h;
    ddt[at_dt] = fmaf(A[h], dla, ddt[at_dt]);
    d = dla * dt[at_dt];
  }
  d = warp_sum(d);
  if (lane == 0) dA_w[w] = d;
  __syncthreads();
  if (tid == 0) {
    float sum = 0.0f;
    for (int i = 0; i < kWarps; ++i) sum += dA_w[i];
    dAp[(long long)bc * nh + h] = sum;
  }
  // the chunk's dCB tiles p = h, h + nh, ..., each summed over the groups
  // in order into the first group's
  const int n_pairs = n_t * (n_t + 1) / 2;
  const long long tile = kTile * kTile, gstride = n_pairs * tile;
  for (int pr = h; pr < n_pairs && groups > 1; pr += nh) {
    float* part = dCBp + ((long long)bc * groups * n_pairs + pr) * tile;
    for (int i = 4 * tid; i < tile; i += 4 * kThreads) {
      float4 v = load4(part + i);
      for (int grp = 1; grp < groups; ++grp)
        v = add4(v, load4(part + grp * gstride + i));
      *reinterpret_cast<float4*>(part + i) = v;
    }
  }
}

// ---- 7. dB and dC from dCB summed over the groups; dA ----------------------

constexpr size_t dbdc_smem() { return sizeof(float) * 2 * kSlot; }

// blockIdx.x: batch * nc + chunk; y: the tile; z: (dB or dC, 64 columns of
// d_state).  dB_k = sum_{qt >= kt} dCB(qt, kt)^T C_q + the groups' state
// terms; dC_q = sum_{kt <= qt} dCB(qt, kt) B_k + theirs (dCB: the first
// group's tiles, which the d cum pass summed over the groups).  The first
// block also sums dA over (batch, chunk) in order.
__global__ void __launch_bounds__(kThreads, 2)
    ssd_bwd_dbdc(const float* __restrict__ Bm, const float* __restrict__ Cm,
                 const float* __restrict__ dCBp,
                 const float* __restrict__ dBsp,
                 const float* __restrict__ dCsp,
                 const float* __restrict__ dAp, float* __restrict__ dB,
                 float* __restrict__ dC, float* __restrict__ dA, int batch,
                 int S, int nh, int ds, int chunk, int groups) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int nc = S / chunk;
  if (blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0)
    for (int h = tid; h < nh; h += kThreads) {
      float s = 0.0f;
      for (int bc = 0; bc < batch * nc; ++bc) s += dAp[(long long)bc * nh + h];
      dA[h] = s;
    }
  if (nc == 0) return;
  const int ns = (ds + kTile - 1) / kTile;
  const bool dc = blockIdx.z >= ns;  // dC of a query tile, else dB of a key
  const int s0 = blockIdx.z % ns * kTile;
  const int bc = blockIdx.x, b = bc / nc, c = bc % nc;
  const int n_t = (chunk + kTile - 1) / kTile, qp = n_t * kTile;
  const int n_pairs = n_t * (n_t + 1) / 2;
  const int t = blockIdx.y, t0 = t * kTile, nt = min(kTile, chunk - t0);
  const long long row0 = (long long)b * S + (long long)c * chunk;
  const Slot sa = slot(smem, dc ? kLdK : kLdN);  // dCB [q][k]
  const Slot sb = slot(smem + kSlot, kLdN);      // C_q or B_k [.][s]
  const Frag f = frag();
  Tile pa, pb;
  auto fetch = [&](int o) {
    const int qt = dc ? t : o, kt = dc ? o : t;
    const float* part =
        dCBp + ((long long)bc * groups * n_pairs + qt * (qt + 1) / 2 + kt) *
                   kTile * kTile;
    pa.fetch([&](int r, int k) { return load4(part + r * kTile + k); });
    const int o0 = o * kTile, no = min(kTile, chunk - o0);
    const float* src = dc ? Bm : Cm;
    pb.fetch([&](int r, int s) {
      return r < no && s0 + s < ds ? load4(src + (row0 + o0 + r) * ds + s0 + s)
                                   : zero4();
    });
  };
  const int first = dc ? 0 : t, last = dc ? t : n_t - 1;
  float acc[4][4];
  zero(acc);
  fetch(first);
  for (int o = first; o <= last; ++o) {
    __syncthreads();  // the last piece's products are done
    put(pa, sa, Same());
    put(pb, sb, Same());
    __syncthreads();
    if (o < last) fetch(o + 1);
    const int depth = round8(min(kTile, chunk - o * kTile));
    if (dc)
      product<false, false>(acc, sa, sb, depth, f);
    else
      product<true, false>(acc, sa, sb, depth, f);
  }
  const float* st =
      (dc ? dCsp : dBsp) + ((long long)bc * groups * qp + t0) * ds;
  const long long sstride = (long long)qp * ds;
  float* out = (dc ? dC : dB) + (row0 + t0) * ds;
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; e += 2) {
      const int r = f.row(e), col = s0 + f.col(n, e);
      if (r >= nt || col >= ds) continue;
      float2 v = load2(st + (long long)r * ds + col);
      for (int grp = 1; grp < groups; ++grp) {
        const float2 w = load2(st + grp * sstride + (long long)r * ds + col);
        v.x += w.x;
        v.y += w.y;
      }
      store2(out + (long long)r * ds + col, acc[n][e] + v.x,
             acc[n][e + 1] + v.y);
    }
}

struct Args {
  const float *x, *dt, *Bm, *Cm, *A, *states, *cum, *dy, *dh_final;
  float *dx, *ddt, *dB, *dC, *dA, *dh0;
  float* cb;
  float* gst;
  double* cum64;
  float *dCBp, *dBsp, *dCsp, *daK, *daQ, *Tk, *rowp, *hgp, *dAp;
  int batch, S, nh, hd, ds, chunk, groups, device;
  cudaStream_t stream;
};

template <int NE, int NS>
int launch(const Args& a) {
  const int nc = a.S / a.chunk, n_t = (a.chunk + kTile - 1) / kTile;
  const int bnc = a.batch * nc, warps = (a.nh + kWarps - 1) / kWarps;
  cudaError_t err;
  if (nc > 0) {
    ssd_bwd_cum<<<dim3(bnc, warps), kThreads, 0, a.stream>>>(
        a.dt, a.A, a.cum64, a.S, a.nh, a.chunk);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    if ((err = allow_smem<ssd_bwd_cb>(cb_smem(), a.device)) != cudaSuccess)
      return err;
    ssd_bwd_cb<<<dim3(bnc, n_t * (n_t + 1) / 2), kThreads, cb_smem(),
                 a.stream>>>(a.Bm, a.Cm, a.cb, a.S, a.ds, a.chunk);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    if ((err = allow_smem<ssd_bwd_dstate>(dstate_smem(), a.device)) !=
        cudaSuccess)
      return err;
    ssd_bwd_dstate<<<dim3(bnc, a.nh, NE * NS), kThreads, dstate_smem(),
                     a.stream>>>(a.Cm, a.cum64, a.dy, a.gst, a.S, a.nh, a.hd,
                                 a.ds, a.chunk);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  const int state_size = a.ds * a.hd;
  ssd_bwd_state_pass<<<dim3(a.batch * a.nh,
                        (state_size / 4 + kPassThreads - 1) / kPassThreads),
                   kPassThreads, 0, a.stream>>>(a.gst, a.cum, a.states,
                                                a.dh_final, a.dh0, a.hgp,
                                                a.S, a.nh, state_size,
                                                a.chunk);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (nc > 0) {
    if ((err = allow_smem<ssd_bwd_queries<NS>>(queries_smem<NS>(),
                                               a.device)) != cudaSuccess)
      return err;
    ssd_bwd_queries<NS><<<dim3(n_t, bnc, a.groups), kThreads,
                          queries_smem<NS>(), a.stream>>>(
        a.Cm, a.states, a.cum64, a.dy, a.daQ, a.dCsp, a.S, a.nh, a.hd, a.ds,
        a.chunk, a.groups);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    // sized for the longest chunk once, so the attribute is set once
    if ((err = allow_smem<ssd_bwd_keys<NE, NS>>(
             keys_smem((kMaxChunk + kTile - 1) / kTile, NS), a.device)) !=
        cudaSuccess)
      return err;
    ssd_bwd_keys<NE, NS><<<dim3(n_t, bnc, a.groups), kThreads,
                           keys_smem(n_t, NS), a.stream>>>(
        a.x, a.dt, a.Bm, a.cb, a.cum64, a.gst, a.dy, a.dx, a.ddt, a.daK,
        a.Tk, a.rowp, a.dCBp, a.dBsp, a.S, a.nh, a.hd, a.ds, a.chunk,
        a.groups);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    ssd_bwd_dcum<<<dim3(bnc, a.nh), kThreads, 0, a.stream>>>(
        a.dt, a.A, a.cum64, a.hgp, a.daK, a.daQ, a.Tk, a.rowp,
        a.ddt, a.dAp, a.dCBp, a.S, a.nh, a.hd, a.ds, a.chunk, a.groups);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if ((err = allow_smem<ssd_bwd_dbdc>(dbdc_smem(), a.device)) != cudaSuccess)
    return err;
  ssd_bwd_dbdc<<<dim3(bnc > 0 ? bnc : 1, n_t, 2 * NS), kThreads, dbdc_smem(),
                 a.stream>>>(a.Bm, a.Cm, a.dCBp, a.dBsp, a.dCsp, a.dAp, a.dB,
                             a.dC, a.dA, a.batch, a.S, a.nh, a.ds, a.chunk,
                             a.groups);
  return (int)cudaGetLastError();
}

}  // namespace

// Every tensor float32 and contiguous: x and dy (batch, S, nh*hd), dt
// (batch, S, nh), B and C (batch, S, ds), A (nh), the forward's chunk-start
// states (batch, S/chunk, nh, ds, hd) and cum (batch, nh, S); dh_final
// (batch, nh, ds, hd) or NULL (zero).  Outputs: dx, ddt, dB, dC, dA (nh)
// and dh0 (or NULL when the forward had no h0).  Scratch from the caller,
// with qp the chunk rounded up to 64, n_t = qp / 64 and P = n_t (n_t + 1) /
// 2: cb (batch, S/chunk, qp, qp) float32; g (batch, S/chunk, nh, ds, hd)
// float32; cum64 (batch, nh, S) double; dCBp (batch, S/chunk, groups, P,
// 64, 64), dBsp and dCsp (batch, S/chunk, groups, qp, ds); daK and T
// (batch, nh, S); daQ (batch, nh, 2, S); rowp (batch, nh, n_t, 2, S); hgp
// (batch, S/chunk, nh, ds * hd / 128); dAp (batch, S/chunk, nh), all
// float32.  x, dy, B, C, states, dh_final, dh0 and the scratch start on 16
// bytes.  S must be a multiple of chunk, 1 <= chunk <= 256; head_dim and
// d_state multiples of 16 up to 128; 1 <= groups <= nh (the heads are taken
// in groups of ceil(nh / groups)).  Eight launches on `stream` (two when S
// is 0).
extern "C" int ssd_scan_bwd(
    const float* x, const float* dt, const float* Bm, const float* Cm,
    const float* A, const float* states, const float* cum, const float* dy,
    const float* dh_final, float* dx, float* ddt, float* dB, float* dC,
    float* dA, float* dh0, float* cb, float* gst, double* cum64,
    float* dCBp, float* dBsp, float* dCsp, float* daK, float* daQ,
    float* Tk, float* rowp, float* hgp, float* dAp, int batch, int S, int nh,
    int hd,
    int ds, int chunk, int groups, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (chunk < 1 || chunk > kMaxChunk || S < 0 || S % chunk || hd % 16 ||
      ds % 16 || hd < 16 || ds < 16 || hd > kMaxDim || ds > kMaxDim ||
      batch < 0 || nh < 0 || groups < 1 || groups > (nh > 0 ? nh : 1))
    return (int)cudaErrorInvalidValue;
  if (batch == 0 || nh == 0) return 0;
  for (const void* p : {(const void*)x, (const void*)dy, (const void*)Bm,
                        (const void*)Cm, (const void*)states,
                        (const void*)dh_final, (const void*)dh0,
                        (const void*)cb, (const void*)gst,
                        (const void*)cum64, (const void*)dCBp,
                        (const void*)dBsp, (const void*)dCsp})
    if ((uintptr_t)p % 16) return (int)cudaErrorMisalignedAddress;
  const Args a{x,     dt,     Bm,   Cm,   A,    states, cum,   dy,
               dh_final, dx,  ddt,  dB,   dC,   dA,     dh0,   cb,
               gst,   cum64,  dCBp, dBsp, dCsp, daK,    daQ,   Tk,
               rowp,  hgp,    dAp,  batch, S,  nh,   hd,     ds,    chunk,
               groups, device, stream};
  const bool wide_hd = hd > kTile, wide_ds = ds > kTile;
  if (!wide_hd) return wide_ds ? launch<1, 2>(a) : launch<1, 1>(a);
  return wide_ds ? launch<2, 2>(a) : launch<2, 1>(a);
}
