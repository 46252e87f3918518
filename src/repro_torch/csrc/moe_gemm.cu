// grouped GEMM for the MoE expert FFNs: y[e] = x[e] @ w[e] for every expert
// e, x (E, C, d), w (E, d, f), y (E, C, f); float32 or bfloat16 in, float32
// accumulation, output in the input's dtype.
//
// Replaces src/repro/kernels/moe_gemm.py:grouped_matmul (Pallas body
// _gemm_kernel), and with it the three einsum products of the JAX package's
// _moe_ffn_local.  Bound on the card: at granite-moe-3b's prefill shapes
// (E 40, C 384, d 1536, f 512, bf16) one call is 2.4e10 operations on 126 MB,
// about 190 operations a byte, below the H100's ~295 for bf16 on the tensor
// cores, so the bytes bound it (0.038 ms); at decode (C 8) the expert
// weights alone are 63 MB and bound it harder.
//
// Two paths, one block per (expert, 64 x 64 tile of y) in both.  The TPU
// kernel padded C, d and f to its block sizes with copies and sliced the
// result; here every load and store guards its edge instead (rows past C,
// columns past f, depth past d read as 0), so any shape works without a
// padded copy, and warps or threads whose rows all lie past C (the decode
// shape has C = 8) skip the products but still help load.
//
// - bfloat16, the model's path: tensor cores through WMMA (16 x 16 x 16 bf16
//   fragments, float32 accumulators).  128 threads, each warp a 32 x 32
//   quarter of the tile; the contraction advances 64 at a time, the x and w
//   tiles staged in shared memory as bf16 with 16-byte loads where the rows
//   are aligned; the float32 tile goes through shared memory (over the
//   staging buffers) to be rounded once and stored.  No asynchronous copies
//   and no double buffering: the loads of a step wait for the products of
//   the last (cp.async/TMA pipelines and wgmma are a later change).
// - float32: FP32 FMAs on the CUDA cores.  256 threads, each a 4 x 4 piece
//   of the tile in registers; the contraction advances 16 at a time, the x
//   tile staged transposed.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

namespace wmma = nvcuda::wmma;

constexpr int BM = 64;      // rows of x / y per block
constexpr int BN = 64;      // columns of w / y per block

// ---- bfloat16: tensor cores ------------------------------------------------

constexpr int kTcThreads = 128;
constexpr int TBK = 64;             // depth of one staged step
constexpr int LDA = TBK + 8;        // bf16 row of the x tile, As[row][k]
constexpr int LDB = BN + 8;         // bf16 row of the w tile, Bs[k][col]
constexpr int LDC = BN + 4;         // float row of the output tile
constexpr int kTcStage = (BM * LDA + TBK * LDB) * 2;
constexpr int kTcOut = BM * LDC * 4;
constexpr int kTcSmem = kTcStage > kTcOut ? kTcStage : kTcOut;

// one 8-element (16-byte) chunk of a bf16 row into shared memory: a vector
// load when the chunk is whole and aligned, else element by element with
// zeros past the row's end or past the last row
__device__ __forceinline__ void stage8(__nv_bfloat16* dst,
                                       const __nv_bfloat16* src, bool row_ok,
                                       int col, int ncols, bool vec) {
  if (row_ok && vec && col + 8 <= ncols) {
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    return;
  }
#pragma unroll
  for (int t = 0; t < 8; ++t)
    dst[t] = (row_ok && col + t < ncols) ? src[t] : __float2bfloat16(0.0f);
}

__global__ void __launch_bounds__(kTcThreads)
    gmm_tc_kernel(const __nv_bfloat16* __restrict__ x,
                  const __nv_bfloat16* __restrict__ w,
                  __nv_bfloat16* __restrict__ y, int C, int d, int f,
                  int vec) {
  __shared__ __align__(128) unsigned char smem[kTcSmem];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Bs = As + BM * LDA;
  float* Cs = reinterpret_cast<float*>(smem);   // after the last step

  const int e = blockIdx.z;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const __nv_bfloat16* xe = x + (long long)e * C * d;
  const __nv_bfloat16* we = w + (long long)e * d * f;
  __nv_bfloat16* ye = y + (long long)e * C * f;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wr = warp / 2, wc = warp % 2;      // 32 x 32 quarter of the tile
  const bool busy = m0 + wr * 32 < C;          // uniform across the warp

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = 0; k0 < d; k0 += TBK) {
    // x tile: 64 rows of 8 chunks; w tile: 64 depths of 8 chunks
#pragma unroll
    for (int r = 0; r < BM * TBK / 8 / kTcThreads; ++r) {
      const int i = tid + r * kTcThreads;
      const int m = i / (TBK / 8), c = (i % (TBK / 8)) * 8;
      const int row = m0 + m;
      stage8(As + m * LDA + c, xe + (long long)row * d + k0 + c, row < C,
             k0 + c, d, vec);
    }
#pragma unroll
    for (int r = 0; r < TBK * BN / 8 / kTcThreads; ++r) {
      const int i = tid + r * kTcThreads;
      const int kk = i / (BN / 8), c = (i % (BN / 8)) * 8;
      const int row = k0 + kk;
      stage8(Bs + kk * LDB + c, we + (long long)row * f + n0 + c, row < d,
             n0 + c, f, vec);
    }
    __syncthreads();
    if (busy) {
#pragma unroll
      for (int kk = 0; kk < TBK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> a[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> b[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(a[i], As + (wr * 32 + i * 16) * LDA + kk,
                                 LDA);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(b[j], Bs + kk * LDB + wc * 32 + j * 16,
                                 LDB);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wr * 32 + i * 16) * LDC + wc * 32 + j * 16,
                              acc[i][j], LDC, wmma::mem_row_major);
  __syncthreads();
#pragma unroll 4
  for (int i = tid; i < BM * BN; i += kTcThreads) {
    const int row = m0 + i / BN, col = n0 + i % BN;
    if (row < C && col < f)
      ye[(long long)row * f + col] = __float2bfloat16(Cs[(i / BN) * LDC +
                                                         i % BN]);
  }
}

// ---- float32: CUDA cores ---------------------------------------------------

constexpr int kThreads = 256;
constexpr int BK = 16;              // depth of one staged step
constexpr int LDT = BM + 4;         // padded row of the transposed x tile

__global__ void __launch_bounds__(kThreads)
    gmm_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   float* __restrict__ y, int C, int d, int f) {
  __shared__ __align__(16) float As[BK][LDT];   // x tile, As[k][row]
  __shared__ __align__(16) float Bs[BK][BN];    // w tile, Bs[k][col]

  const int e = blockIdx.z;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const float* xe = x + (long long)e * C * d;
  const float* we = w + (long long)e * d * f;
  float* ye = y + (long long)e * C * f;

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const bool busy = m0 + ty * 4 < C;   // some of this thread's rows exist

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < d; k0 += BK) {
    // x tile: element i -> row i / BK, depth i % BK (reads run along d)
#pragma unroll
    for (int r = 0; r < BM * BK / kThreads; ++r) {
      const int i = tid + r * kThreads;
      const int m = i / BK, kk = i % BK;
      const int row = m0 + m, col = k0 + kk;
      As[kk][m] = (row < C && col < d) ? xe[(long long)row * d + col] : 0.0f;
    }
    // w tile: element i -> depth i / BN, column i % BN (reads run along f)
#pragma unroll
    for (int r = 0; r < BK * BN / kThreads; ++r) {
      const int i = tid + r * kThreads;
      const int kk = i / BN, n = i % BN;
      const int row = k0 + kk, col = n0 + n;
      Bs[kk][n] = (row < d && col < f) ? we[(long long)row * f + col] : 0.0f;
    }
    __syncthreads();
    if (busy) {
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
        const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row >= C) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col < f) ye[(long long)row * f + col] = acc[i][j];
    }
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  x (E, C, d), w (E, d, f) and y (E, C, f)
// are contiguous.
extern "C" int grouped_matmul_fwd(const void* x, const void* w, void* y,
                                  int dtype, int E, int C, int d, int f,
                                  int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (E < 0 || C < 0 || d < 0 || f < 0 || E > 65535)
    return (int)cudaErrorInvalidValue;
  if (E == 0 || C == 0 || f == 0) return 0;
  dim3 grid((f + BN - 1) / BN, (C + BM - 1) / BM, E);
  if (dtype == 0) {
    gmm_f32_kernel<<<grid, kThreads, 0, stream>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(y), C, d, f);
  } else if (dtype == 1) {
    // 16-byte row chunks need rows that start on 16 bytes
    const int vec = d % 8 == 0 && f % 8 == 0 &&
                    ((uintptr_t)x | (uintptr_t)w) % 16 == 0;
    gmm_tc_kernel<<<grid, kTcThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w),
        static_cast<__nv_bfloat16*>(y), C, d, f, vec);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
