// grouped GEMM for the MoE expert FFNs: y[e] = x[e] @ w[e] for every expert
// e, x (E, C, d), w (E, d, f), y (E, C, f); float32 or bfloat16 in, float32
// accumulation, output in the input's dtype; and its two gradients.
//
// Replaces src/repro/kernels/moe_gemm.py:grouped_matmul (Pallas body
// _gemm_kernel), and with it the three einsum products of the JAX package's
// _moe_ffn_local and, in training, their gradients.  Bound on the card: at granite-moe-3b's prefill shapes
// (E 40, C 384, d 1536, f 512, bf16) one call is 2.4e10 operations on 126 MB,
// about 190 operations a byte, below the H100's ~295 for bf16 on the tensor
// cores, so the bytes bound it (0.038 ms); at decode (C 8) the expert
// weights alone are 63 MB and bound it harder.
//
// The TPU kernel padded C, d and f to its block sizes with copies and sliced
// the result; here no padded copy is made.  Four kernels:
//
// - bfloat16, the model's path (gmm_wgmma_kernel): Hopper's shape.  One
//   block per (expert, BM x BN tile of y).  One producer thread keeps TMA
//   loads (cp.async.bulk.tensor) of the x and w tiles in flight through a
//   ring of 4 stages in shared memory, with a full and an empty mbarrier per
//   stage; one consumer warpgroup per 64 rows runs wgmma m64nBNk16 from
//   shared memory into float32 registers, 128-byte swizzled (x K-major, w
//   MN-major: the transpose bit).  x is read through a 3-D tensor map over
//   (d, C, E), so rows past C and depths past d are zero-filled by the TMA
//   (no byte moved, nothing read from the next expert); the store is
//   guarded.  Prefill (C > 64): 128 x 128 tiles, two consumer warpgroups,
//   cutting the re-reads of x and w against 64 x 64 tiles by 2x.  Decode and
//   short prompts (C <= 64): 64 x 64 tiles, one consumer warpgroup, three
//   blocks an SM, so every block of the decode shape (40 experts x 8 column
//   tiles) is resident at once and keeps its 4 stages of expert weights in
//   flight.  The two tensor maps are encoded on the host at every call
//   (cuTensorMapEncodeTiled, reached through the runtime's driver entry
//   point) and passed as __grid_constant__ parameters.  TMA needs 16-byte
//   row strides and bases: d % 8 == 0, f % 8 == 0 and 16-byte aligned x, w
//   and y; the entry point refuses anything else.
// - bfloat16 gradients (grouped_matmul_dx, grouped_matmul_dw;
//   gmm_bwd_kernel): dx[e] = dy[e] w[e]^T and dw[e] = x[e]^T dy[e] with the
//   same TMA ring and wgmma, dy, w and x read where they lie: wgmma takes
//   each 16-bit operand K-major or MN-major from shared memory, so the
//   tensor maps and descriptors give it w's rows (K-major B of dx) and x's
//   rows (MN-major A of dw) as they are, with no transposed copy.  Bound:
//   at granite's training shapes (E 40, C 1024, d and f 512 and 1536) each
//   product alone is 6.4e10 operations on 231 MB, 0.065 ms at the bf16
//   peak and 0.069 ms at 3.35 TB/s.  Unlike the forward: 128 x 256 tiles
//   of 3 stages, persistent blocks (one an SM, walking their tiles, so a
//   tile's loads overlap the last one's store), one group of products in
//   flight (wait_group 1) rather than none, and the output tile stored
//   through shared memory by the TMA, not by scattered 4-byte stores (at
//   granite's w_in dx, which writes 126 MB, that store took the kernel
//   from 0.20 to 0.116 ms on an H100; chip_kernel_shapes.py gmm).
// - bfloat16 rows the TMA cannot take (grouped_matmul_wmma_fwd, chosen by
//   the wrapper by alignment, counted apart): tensor cores through WMMA
//   16 x 16 x 16 fragments, one block per (expert, 64 x 64 tile), every load
//   guarded and element by element, no asynchronous copies; warps whose
//   rows all lie past C skip the products.
// - float32: FP32 FMAs on the CUDA cores.  256 threads, each a 4 x 4 piece
//   of a 64 x 64 tile in registers; the contraction advances 16 at a time,
//   the x tile staged transposed.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <algorithm>
#include <climits>

namespace {

namespace wmma = nvcuda::wmma;

constexpr int BM = 64;      // rows of x / y per block
constexpr int BN = 64;      // columns of w / y per block

// ---- bfloat16 rows the TMA cannot take: WMMA ------------------------------

constexpr int kTcThreads = 128;
constexpr int TBK = 64;             // depth of one staged step
constexpr int LDA = TBK + 8;        // bf16 row of the x tile, As[row][k]
constexpr int LDB = BN + 8;         // bf16 row of the w tile, Bs[k][col]
constexpr int LDC = BN + 4;         // float row of the output tile
constexpr int kTcStage = (BM * LDA + TBK * LDB) * 2;
constexpr int kTcOut = BM * LDC * 4;
constexpr int kTcSmem = kTcStage > kTcOut ? kTcStage : kTcOut;

// one 8-element chunk of a bf16 row into shared memory, element by element
// (the rows this kernel takes need not start on 16 bytes), with zeros past
// the row's end or past the last row
__device__ __forceinline__ void stage8(__nv_bfloat16* dst,
                                       const __nv_bfloat16* src, bool row_ok,
                                       int col, int ncols) {
#pragma unroll
  for (int t = 0; t < 8; ++t)
    dst[t] = (row_ok && col + t < ncols) ? src[t] : __float2bfloat16(0.0f);
}

__global__ void __launch_bounds__(kTcThreads)
    gmm_tc_kernel(const __nv_bfloat16* __restrict__ x,
                  const __nv_bfloat16* __restrict__ w,
                  __nv_bfloat16* __restrict__ y, int C, int d, int f) {
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
             k0 + c, d);
    }
#pragma unroll
    for (int r = 0; r < TBK * BN / 8 / kTcThreads; ++r) {
      const int i = tid + r * kTcThreads;
      const int kk = i / (BN / 8), c = (i % (BN / 8)) * 8;
      const int row = k0 + kk;
      stage8(Bs + kk * LDB + c, we + (long long)row * f + n0 + c, row < d,
             n0 + c, f);
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

// ---- bfloat16: TMA + wgmma -------------------------------------------------

namespace hop {

using bf16 = __nv_bfloat16;
constexpr int TK = 64;  // depth of a stage: one 128-byte swizzle row of bf16

// BM x BN tiles of y, STAGES in flight, MIN_BLOCKS resident on an SM
template <int BM_, int BN_, int STAGES_, int MIN_BLOCKS_>
struct Cfg {
  static constexpr int BM = BM_, BN = BN_, STAGES = STAGES_;
  static constexpr int kMinBlocks = MIN_BLOCKS_;
  static constexpr int kConsumers = BM / 64;  // warpgroups, 64 rows each
  // the consumer warpgroups, then one producer warp
  static constexpr int kThreads = 128 * kConsumers + 32;
  static constexpr int A_BYTES = BM * TK * 2;   // x tile: BM rows of TK
  static constexpr int B_BYTES = TK * BN * 2;   // w tile: BN / 64 boxes
  static constexpr int BOX_BYTES = TK * 64 * 2; // one 64 x 64 w box
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  // 1024 bytes of slack: swizzled tiles start on 1024 bytes
  static constexpr size_t kSmem = 1024 + (size_t)STAGES * STAGE_BYTES +
                                  2 * STAGES * sizeof(uint64_t);
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// one box of a 3-D tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// one box of shared memory out to a 3-D tensor map (rows and columns past
// the map's bounds are not written), in the thread's bulk group
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// until the thread's committed stores have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// until the thread's committed stores are done
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// this thread's shared-memory writes, seen by the TMA (the async proxy)
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// the 128 threads of one warpgroup meet (barrier 1 + its index; 0 is
// __syncthreads')
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, all in 16-byte units
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit_and_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// until at most N committed groups of products are still running
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accumulator reads or writes across the
// asynchronous products
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// acc (64 x 64, float32, this thread's 32) += A . B, both from shared
// memory through their descriptors; TA, TB: A, B MN-major (the transpose
// bits, immediates)
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// acc (64 x 128, float32, this thread's 64) += A . B, as wgmma_n64
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// TA, TB: A, B MN-major (the transpose bits); the forward's x is K-major
// and its w MN-major
template <int BN, int TA = 0, int TB = 1>
__device__ __forceinline__ void wgmma(float (&d)[BN / 2], uint64_t da,
                                      uint64_t db) {
  static_assert(BN == 64 || BN == 128 || BN == 256, "wgmma width");
  if constexpr (BN == 64) wgmma_n64<TA, TB>(d, da, db);
  else if constexpr (BN == 128) wgmma_n128<TA, TB>(d, da, db);
  else wgmma_n256<TA, TB>(d, da, db);
}

template <class G>
__global__ void __launch_bounds__(G::kThreads, G::kMinBlocks)
    gmm_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                     const __grid_constant__ CUtensorMap wmap,
                     bf16* __restrict__ y, int C, int d, int f,
                     int n_tiles) {
  constexpr int STAGES = G::STAGES, BN = G::BN;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + STAGES * G::STAGE_BYTES;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (STAGES + s); };

  const int e = blockIdx.y;
  const int m0 = (blockIdx.x / n_tiles) * G::BM;
  const int n0 = (blockIdx.x % n_tiles) * BN;
  const int k_steps = (d + TK - 1) / TK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), G::kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == G::kConsumers) {  // the producer: one thread issues every load
    if (threadIdx.x == G::kConsumers * 128) {
      for (int ks = 0; ks < k_steps; ++ks) {
        const int s = ks % STAGES;
        if (ks >= STAGES) mbar_wait(empty(s), (ks / STAGES - 1) & 1);
        mbar_expect_tx(full(s), G::STAGE_BYTES);
        const uint32_t a = base + s * G::STAGE_BYTES;
        tma_load(a, &xmap, full(s), ks * TK, m0, e);
#pragma unroll
        for (int c = 0; c < BN / 64; ++c)
          tma_load(a + G::A_BYTES + c * G::BOX_BYTES, &wmap, full(s),
                   n0 + 64 * c, ks * TK, e);
      }
    }
    return;
  }

  // a consumer warpgroup: rows 64 wg .. 64 wg + 63 of the tile
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
  for (int ks = 0; ks < k_steps; ++ks) {
    const int s = ks % STAGES;
    mbar_wait(full(s), (ks / STAGES) & 1);
    const uint32_t a = base + s * G::STAGE_BYTES + wg * 64 * TK * 2;
    const uint32_t b = base + s * G::STAGE_BYTES + G::A_BYTES;
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) {
      // x: K-major rows of 128 bytes, 8-row groups 1024 bytes apart, the
      // 16-deep slice 32 bytes into the row.  w: MN-major, rows of 64
      // columns 128 bytes apart (8-row groups 1024), 64-column boxes
      // BOX_BYTES apart, the 16-deep slice 16 rows down.
      wgmma<BN>(acc, desc(a + kk * 32, 16, 1024),
                desc(b + kk * 16 * 128, G::BOX_BYTES, 1024));
    }
    wgmma_commit_and_wait();
    fence_acc(acc);
    if (threadIdx.x % 128 == 0) mbar_arrive(empty(s));
  }

  // accumulator (warp w of the group, lane): rows 16w + lane / 4 (+ 8),
  // columns 8j + 2 (lane % 4) (+ 1)
  const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
  const int row = m0 + wg * 64 + warp * 16 + lane / 4;
  const int col = n0 + 2 * (lane % 4);
  bf16* ye = y + (long long)e * C * f;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    if (col + 8 * j >= f) continue;  // f % 8 == 0: the pair is whole
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (row + 8 * h >= C) continue;
      *reinterpret_cast<__nv_bfloat162*>(
          ye + (long long)(row + 8 * h) * f + col + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

// decode and short prompts (C <= 64): all 320 blocks of the decode shape
// resident at once; prefill: 128 x 128 tiles, two blocks an SM.  On an H100
// (chip_kernel_shapes.py) 128 x 256 and 128 x 64 tiles, and 4 stages at one
// block an SM, were no faster at granite's prefill shapes.
using Decode = Cfg<64, 64, 4, 3>;
using Prefill = Cfg<128, 128, 3, 2>;

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, through the runtime (no -lcuda)
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// a bf16 (depth, rows, inner) array as a 3-D tensor map with 128-byte
// swizzled boxes of (1, box_rows, 64); out-of-bounds elements read as zero
bool encode(CUtensorMap* map, const void* ptr, uint64_t inner, uint64_t rows,
            uint64_t depth, uint32_t box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[3] = {inner, rows, depth};
  const cuuint64_t strides[2] = {inner * 2, inner * rows * 2};
  const cuuint32_t box[3] = {(cuuint32_t)TK, box_rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <class G>
int launch(const void* x, const void* w, void* y, int E, int C, int d, int f,
           cudaStream_t stream) {
  CUtensorMap xmap, wmap;
  if (!encode(&xmap, x, d, C, E, G::BM) || !encode(&wmap, w, f, d, E, TK))
    return (int)cudaErrorInvalidValue;
  auto kern = gmm_wgmma_kernel<G>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)G::kSmem);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (f + G::BN - 1) / G::BN;
  dim3 grid(((C + G::BM - 1) / G::BM) * n_tiles, E);
  kern<<<grid, G::kThreads, G::kSmem, stream>>>(
      xmap, wmap, static_cast<bf16*>(y), C, d, f, n_tiles);
  return (int)cudaGetLastError();
}

// ---- the backward: dx = dy w^T and dw = x^T dy, operands in place -------
//
// One expert's product out (M x N) = A (M x K) . B (K x N), every operand
// read where it lies.  A K-major operand is stored with K innermost (a row
// of M or N holds the depths): its tile is one TMA box of TK depths by BM
// (or BN) rows, 128-byte swizzled, and its descriptor walks 32 bytes along
// the row per 16 depths, 8-row groups 1024 bytes apart.  An MN-major
// operand is stored with M or N innermost (a row holds one depth): its
// tile is BM / 64 (or BN / 64) boxes of 64 columns by TK depths, each 64
// rows of 128 bytes, and its descriptor steps 16 rows (2048 bytes) per 16
// depths, 64-column boxes BOX_BYTES apart: the transpose bit.
//   dx[e] = dy[e] . w[e]^T: M = C, N = d, K = f; A = dy (C, f) K-major,
//     B[k][n] = w[e][n][k], w's rows of f: K-major too.
//   dw[e] = x[e]^T . dy[e]: M = d, N = f, K = C; A[m][k] = x[e][k][m],
//     x's rows of d: MN-major; B = dy (C, f): MN-major, as the forward's w.
// The maps are 3-D over E, so depths past K (dw: rows past C) and rows
// past M or N read as zeros and nothing of the next expert.
//
// What the forward does not: the blocks are persistent (one a resident
// slot, walking its tiles), so the producer loads the next tile while the
// consumers store the last; the consumers keep one group of products in
// flight (step it's wgmmas are issued before step it - 1's are waited for,
// and only then is it - 1's stage given back); the output tile goes out
// through shared memory and a TMA store.
template <class G, int TA, int TB>
__global__ void __launch_bounds__(G::kThreads, G::kMinBlocks)
    gmm_bwd_kernel(const __grid_constant__ CUtensorMap amap,
                   const __grid_constant__ CUtensorMap bmap,
                   const __grid_constant__ CUtensorMap omap, int K,
                   int m_tiles, int n_tiles, int tiles) {
  constexpr int STAGES = G::STAGES, BN = G::BN;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + STAGES * G::STAGE_BYTES;
  // the output tile's staging, after the barriers: BN / 64 swizzled boxes
  // of 64 x 64 per consumer warpgroup
  const uint32_t staged = bars + 1024;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (STAGES + s); };

  const int k_steps = (K + TK - 1) / TK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), G::kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the block's tiles: blockIdx.x, then every gridDim.x-th, each (expert,
  // BM x BN tile of out), the N tiles of a row of tiles in turn; `it`
  // counts the block's k-steps over all of them (stage it % STAGES, phase
  // it / STAGES)
  const int wg = threadIdx.x / 128;
  auto origin = [&](int t, int& e, int& m0, int& n0) {
    e = t / (m_tiles * n_tiles);
    const int r = t % (m_tiles * n_tiles);
    m0 = (r / n_tiles) * G::BM;
    n0 = (r % n_tiles) * BN;
  };
  if (wg == G::kConsumers) {  // the producer: one thread issues every load
    if (threadIdx.x == G::kConsumers * 128) {
      int it = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        int e, m0, n0;
        origin(t, e, m0, n0);
        for (int ks = 0; ks < k_steps; ++ks, ++it) {
          const int s = it % STAGES, k0 = ks * TK;
          if (it >= STAGES) mbar_wait(empty(s), (it / STAGES + 1) & 1);
          mbar_expect_tx(full(s), G::STAGE_BYTES);
          const uint32_t a = base + s * G::STAGE_BYTES;
          const uint32_t b = a + G::A_BYTES;
          if constexpr (TA) {
#pragma unroll
            for (int c = 0; c < G::BM / 64; ++c)
              tma_load(a + c * G::BOX_BYTES, &amap, full(s), m0 + 64 * c, k0,
                       e);
          } else {
            tma_load(a, &amap, full(s), k0, m0, e);
          }
          if constexpr (TB) {
#pragma unroll
            for (int c = 0; c < BN / 64; ++c)
              tma_load(b + c * G::BOX_BYTES, &bmap, full(s), n0 + 64 * c,
                       k0, e);
          } else {
            tma_load(b, &bmap, full(s), k0, n0, e);
          }
        }
      }
    }
  } else {
    // a consumer warpgroup: rows 64 wg .. 64 wg + 63 of each tile, which
    // start 64 wg rows of 128 bytes (K-major) or wg boxes (MN-major) into
    // the stage: the same offset
    const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
    const bool leader = threadIdx.x % 128 == 0;
    float acc[BN / 2];
    int it = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      int e, m0, n0;
      origin(t, e, m0, n0);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
      for (int ks = 0; ks < k_steps; ++ks, ++it) {
        const int s = it % STAGES;
        mbar_wait(full(s), (it / STAGES) & 1);
        const uint32_t a = base + s * G::STAGE_BYTES + wg * G::BOX_BYTES;
        const uint32_t b = base + s * G::STAGE_BYTES + G::A_BYTES;
        fence_acc(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < TK / 16; ++kk)
          wgmma<BN, TA, TB>(
              acc,
              TA ? desc(a + kk * 16 * 128, G::BOX_BYTES, 1024)
                 : desc(a + kk * 32, 16, 1024),
              TB ? desc(b + kk * 16 * 128, G::BOX_BYTES, 1024)
                 : desc(b + kk * 32, 16, 1024));
        wgmma_commit();
        wgmma_wait<1>();   // step it - 1's products are done: free its stage
        fence_acc(acc);
        if (ks > 0 && leader) mbar_arrive(empty((it - 1) % STAGES));
      }
      wgmma_wait<0>();
      fence_acc(acc);
      if (leader) mbar_arrive(empty((it - 1) % STAGES));

      // the epilogue: the accumulator (warp w of the group, lane: rows 16w
      // + lane / 4 (+ 8), columns 8j + 2 (lane % 4) (+ 1)) into this
      // warpgroup's staging in the TMA's 128-byte swizzle (16-byte chunk j %
      // 8 of a 128-byte row at chunk (j % 8) ^ (row % 8): no bank conflict),
      // then stored by the TMA, which clips rows and columns past M and N;
      // the next tile's products start while the store drains
      const uint32_t mine = staged + wg * (BN / 64) * G::BOX_BYTES;
      if (leader) bulk_wait_read();     // the last tile's store has read it
      warpgroup_sync(wg);
      const int r8 = lane / 4;          // the row's place in its 8-row group
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = warp * 16 + 8 * h + r8;
          const __nv_bfloat162 v = __floats2bfloat162_rn(
              acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
          const uint32_t dst = mine + (j / 8) * G::BOX_BYTES + row * 128 +
                               (((j % 8) ^ r8) << 4) + 4 * (lane % 4);
          asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(dst),
                       "r"(*reinterpret_cast<const uint32_t*>(&v))
                       : "memory");
        }
      }
      fence_async_shared();
      warpgroup_sync(wg);
      if (leader) {
#pragma unroll
        for (int c = 0; c < BN / 64; ++c)
          tma_store(&omap, mine + c * G::BOX_BYTES, n0 + 64 * c,
                    m0 + 64 * wg, e);
        bulk_commit();
      }
    }
    if (leader) bulk_wait();
  }
}

// granite's training products (C 1024; d, f 512 and 1536): dx is M = C,
// N = d, K = f; dw is M = d, N = f, K = C (chip_kernel_shapes.py gmm)
using Dx = Cfg<128, 256, 3, 1>;
using Dw = Cfg<128, 256, 3, 1>;

// out (E, M, N) = A . B per expert.  A is a bf16 (E, a_rows, a_inner)
// array, K-major (a_inner = K, a_rows = M) or MN-major (TA: a_inner = M,
// a_rows = K); B likewise with N.
template <class G, int TA, int TB>
int launch_bwd(const void* a, int a_inner, int a_rows, const void* b,
               int b_inner, int b_rows, void* out, int E, int M, int N,
               int K, cudaStream_t stream) {
  if (K == 0)   // no depth: the product is zero
    return (int)cudaMemsetAsync(out, 0, (size_t)E * M * N * sizeof(bf16),
                                stream);
  CUtensorMap amap, bmap;
  CUtensorMap omap;   // out: 64 x 64 boxes, one per warpgroup and 64 columns
  // a K-major box: TK depths of BM (BN) rows; an MN-major one: 64 columns
  // of TK depths
  if (!encode(&amap, a, a_inner, a_rows, E, TA ? TK : G::BM) ||
      !encode(&bmap, b, b_inner, b_rows, E, TB ? TK : G::BN) ||
      !encode(&omap, out, N, M, E, 64))
    return (int)cudaErrorInvalidValue;
  // the forward's ring and barriers (rounded up to 1024 bytes), then the
  // output tile's staging
  constexpr size_t smem = 2048 + (size_t)G::STAGES * G::STAGE_BYTES +
                          (size_t)G::BM * G::BN * sizeof(bf16);
  static_assert(smem <= 232448, "shared memory of one block");
  auto kern = gmm_bwd_kernel<G, TA, TB>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int m_tiles = (M + G::BM - 1) / G::BM;
  const int n_tiles = (N + G::BN - 1) / G::BN;
  const long long tiles = (long long)E * m_tiles * n_tiles;
  if (tiles > INT_MAX) return (int)cudaErrorInvalidValue;
  // persistent: as many blocks as are resident at once
  int device, sms;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess)
    return (int)err;
  const int blocks =
      (int)std::min<long long>(tiles, (long long)sms * G::kMinBlocks);
  kern<<<blocks, G::kThreads, smem, stream>>>(amap, bmap, omap, K, m_tiles,
                                              n_tiles, (int)tiles);
  return (int)cudaGetLastError();
}

}  // namespace hop

}  // namespace

// dtype: 0 float32, 1 bfloat16.  x (E, C, d), w (E, d, f) and y (E, C, f)
// are contiguous; bfloat16 needs d % 8 == 0, f % 8 == 0 and x, w, y on 16
// bytes (the TMA's rows), else cudaErrorInvalidValue.
extern "C" int grouped_matmul_fwd(const void* x, const void* w, void* y,
                                  int dtype, int E, int C, int d, int f,
                                  int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (E < 0 || C < 0 || d < 0 || f < 0 || E > 65535)
    return (int)cudaErrorInvalidValue;
  if (E == 0 || C == 0 || f == 0) return 0;
  if (dtype == 0) {
    dim3 grid((f + BN - 1) / BN, (C + BM - 1) / BM, E);
    gmm_f32_kernel<<<grid, kThreads, 0, stream>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(y), C, d, f);
    return (int)cudaGetLastError();
  }
  if (dtype != 1 || d == 0 || d % 8 || f % 8 ||
      ((uintptr_t)x | (uintptr_t)w | (uintptr_t)y) % 16)
    return (int)cudaErrorInvalidValue;
  if (C <= 64) return hop::launch<hop::Decode>(x, w, y, E, C, d, f, stream);
  return hop::launch<hop::Prefill>(x, w, y, E, C, d, f, stream);
}

// bfloat16 on the WMMA kernel: any d and f, any 2-byte-aligned x and w
// (the wrapper sends it only what the TMA cannot read)
extern "C" int grouped_matmul_wmma_fwd(const void* x, const void* w, void* y,
                                       int E, int C, int d, int f, int device,
                                       cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (E < 0 || C < 0 || d < 0 || f < 0 || E > 65535)
    return (int)cudaErrorInvalidValue;
  if (E == 0 || C == 0 || f == 0) return 0;
  dim3 grid((f + BN - 1) / BN, (C + BM - 1) / BM, E);
  gmm_tc_kernel<<<grid, kTcThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w), static_cast<__nv_bfloat16*>(y),
      C, d, f);
  return (int)cudaGetLastError();
}

// the two backward entry points take what the TMA can read: E <= 65535,
// d % 8 == 0, f % 8 == 0, every base on 16 bytes; else
// cudaErrorInvalidValue
static int backward_args(const void* p, const void* q, const void* r, int E,
                         int C, int d, int f) {
  if (E < 0 || C < 0 || d < 0 || f < 0 || E > 65535 || d % 8 || f % 8 ||
      ((uintptr_t)p | (uintptr_t)q | (uintptr_t)r) % 16)
    return (int)cudaErrorInvalidValue;
  return 0;
}

// dx (E, C, d) = dy (E, C, f) . w (E, d, f)^T per expert, bfloat16, all
// contiguous, w read in place
extern "C" int grouped_matmul_dx(const void* dy, const void* w, void* dx,
                                 int E, int C, int d, int f, int device,
                                 cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (int bad = backward_args(dy, w, dx, E, C, d, f)) return bad;
  if (E == 0 || C == 0 || d == 0) return 0;
  return hop::launch_bwd<hop::Dx, 0, 0>(dy, f, C, w, f, d, dx, E, C, d, f,
                                        stream);
}

// dw (E, d, f) = x (E, C, d)^T . dy (E, C, f) per expert, bfloat16, all
// contiguous, x read in place
extern "C" int grouped_matmul_dw(const void* x, const void* dy, void* dw,
                                 int E, int C, int d, int f, int device,
                                 cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (int bad = backward_args(x, dy, dw, E, C, d, f)) return bad;
  if (E == 0 || d == 0 || f == 0) return 0;
  return hop::launch_bwd<hop::Dw, 1, 1>(x, d, C, dy, f, C, dw, E, d, f, C,
                                        stream);
}
