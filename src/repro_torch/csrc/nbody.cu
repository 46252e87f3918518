// nbody: direct-sum accelerations acc_i = sum_j m_j d_ij rsqrt(r2)^3,
// r2 = |d_ij|^2 + softening — the paper's Loop benchmark body.
//
// Replaces src/repro/kernels/nbody.py:nbody_accelerations (Pallas body
// _nbody_kernel); nbody_step's leapfrog update stays plain tensor code
// around it, as it was jnp code around the Pallas call.  Bound on the card:
// FP32 issue.  An interaction is 12 FP32-pipe instructions (3 FADD and 3
// FFMA for r2, 3 FMUL for m rsqrt(r2)^3, 3 FFMA into the sums) and one
// MUFU rsqrt, on 16 bytes of a source that a whole block shares; bytes are
// far below that.
//
// Design, three launches on the caller's stream:
// 1. nbody_pack writes the sources once as float4 (x, y, z, m) into the
//    call's scratch, padded to a whole tile with (0, 0, 0, 0).  A padded
//    source has mass 0, so it adds exactly 0 (r2 >= softening, never a
//    NaN): the sweep needs no mask.
// 2. nbody_tiles runs a grid of (target tile, source split).  Each thread
//    holds kTargets targets, so one shared-memory read of a source feeds
//    kTargets independent chains, which hide the FMA and MUFU latency that
//    one target a thread leaves bare.  The splits (chosen on the host from
//    the SM count, kernels/nbody.py:launch_plan) give every size class
//    several blocks an SM.  Each thread loads the next tile into registers
//    (one 16-byte load a thread) while the block sweeps the current one
//    from a second shared buffer: one barrier a tile.
// 3. With more than one split, nbody_reduce adds each target's partial
//    sums in split order 0..S-1.  No float atomics: a call's result is the
//    same bits every time.  With one split the sweep writes acc itself.
// The TPU kernel carried its accumulator across sequential grid steps in
// VMEM; here blocks run in any order, each split's sum stays in registers
// and the fixed-order second pass takes the sequential grid's place.
// The sweep and the reduction are launched as programmatic dependents
// (Hopper's griddepcontrol): each may start while the launch before it
// drains, and waits for it in full before it reads what that one writes.
// The pack is launched in plain stream order, so a call never starts
// before the previous work on its stream has finished with the memory.
//
// rsqrt is the hardware approximation (rsqrt.approx, <= 2 ulp), taken in
// its flush-to-zero form: r2 >= softening is never subnormal, and the
// non-flushing form adds a subnormal test and two scaling multiplies to
// every interaction.  Results differ from a float64 reference by a
// relative error of order 1e-6 per term.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // threads a block
constexpr int kTargets = 4;    // targets a thread
constexpr int kTile = 128;     // sources a shared-memory tile
constexpr int kLoads = kTile / kThreads;  // 16-byte loads a thread a tile
constexpr int kMinBlocks = 4;  // blocks an SM the sweep is built for
constexpr int kReduceThreads = 64;
constexpr int kBatch = 16;     // partial sums a reducing thread loads at once
constexpr bool kOverlapLaunches = true;  // sweep and reduction as dependents
static_assert(kTile % kThreads == 0, "a tile is whole loads of the block");

// griddepcontrol: wait for the launch this one depends on (complete, its
// writes visible); let the launch that depends on this one start.  Both
// do nothing in a launch made in plain stream order.
__device__ __forceinline__ void wait_for_prerequisite() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}
__device__ __forceinline__ void let_dependent_start() {
  asm volatile("griddepcontrol.launch_dependents;" :::);
}

__device__ __forceinline__ float rsqrt_approx(float x) {
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__global__ void nbody_pack(const float* __restrict__ pos,
                           const float* __restrict__ mass, int n, int n_pad,
                           float4* __restrict__ out) {
  let_dependent_start();
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n_pad) return;
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (j < n) {
    v = make_float4(pos[3 * (long long)j], pos[3 * (long long)j + 1],
                    pos[3 * (long long)j + 2], mass[j]);
  }
  out[j] = v;
}

// Block (x, y): targets x * kThreads * kTargets + k * kThreads + thread
// (k < kTargets) against the tiles [y * split_tiles, (y + 1) * split_tiles)
// of src.  partial == nullptr: write acc (one split); else partial[y][i].
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    nbody_tiles(const float* __restrict__ pos_i, int n_i,
                const float4* __restrict__ src, int n_tiles, int split_tiles,
                float softening, float* __restrict__ acc,
                float4* __restrict__ partial) {
  __shared__ float4 tile[2][kTile];
  const int t = threadIdx.x;
  const long long i0 = (long long)blockIdx.x * (kThreads * kTargets) + t;
  float px[kTargets], py[kTargets], pz[kTargets];
  float ax[kTargets], ay[kTargets], az[kTargets];
#pragma unroll
  for (int k = 0; k < kTargets; ++k) {
    const long long i = i0 + k * kThreads;
    px[k] = py[k] = pz[k] = 0.0f;
    if (i < n_i) {
      px[k] = pos_i[3 * i];
      py[k] = pos_i[3 * i + 1];
      pz[k] = pos_i[3 * i + 2];
    }
    ax[k] = ay[k] = az[k] = 0.0f;
  }
  const int first = blockIdx.y * split_tiles;
  const int last = min(n_tiles, first + split_tiles);
  wait_for_prerequisite();  // the packed sources
  float4 next[kLoads];
#pragma unroll
  for (int u = 0; u < kLoads; ++u)
    next[u] = src[(long long)first * kTile + u * kThreads + t];
  int b = 0;
  for (int tt = first; tt < last; ++tt, b ^= 1) {
#pragma unroll
    for (int u = 0; u < kLoads; ++u) tile[b][u * kThreads + t] = next[u];
    // one barrier a tile: a thread writes buffer b again two tiles later,
    // after the barrier of the tile between, which every thread reaches
    // only once it has swept buffer b
    __syncthreads();
    if (tt + 1 < last) {
#pragma unroll
      for (int u = 0; u < kLoads; ++u)
        next[u] = src[(long long)(tt + 1) * kTile + u * kThreads + t];
    }
#pragma unroll 8
    for (int s = 0; s < kTile; ++s) {
      const float4 q = tile[b][s];
#pragma unroll
      for (int k = 0; k < kTargets; ++k) {
        const float dx = q.x - px[k], dy = q.y - py[k], dz = q.z - pz[k];
        float r2 = fmaf(dx, dx, softening);
        r2 = fmaf(dy, dy, r2);
        r2 = fmaf(dz, dz, r2);
        const float inv = rsqrt_approx(r2);
        const float w = q.w * (inv * inv * inv);
        ax[k] = fmaf(w, dx, ax[k]);
        ay[k] = fmaf(w, dy, ay[k]);
        az[k] = fmaf(w, dz, az[k]);
      }
    }
  }
  let_dependent_start();
#pragma unroll
  for (int k = 0; k < kTargets; ++k) {
    const long long i = i0 + k * kThreads;
    if (i >= n_i) continue;
    if (partial == nullptr) {
      acc[3 * i] = ax[k];
      acc[3 * i + 1] = ay[k];
      acc[3 * i + 2] = az[k];
    } else {
      partial[(long long)blockIdx.y * n_i + i] =
          make_float4(ax[k], ay[k], az[k], 0.0f);
    }
  }
}

// acc[i] = partial[0][i] + partial[1][i] + ... + partial[splits - 1][i],
// added in that order.  The loads do not depend on the sums: a thread
// issues kBatch of them before it adds any, so a call waits on the memory
// splits / kBatch times, not splits times.
__global__ void __launch_bounds__(kReduceThreads)
    nbody_reduce(const float4* __restrict__ partial, int n_i, int splits,
                 float* __restrict__ acc) {
  wait_for_prerequisite();  // every split's partial sums
  const long long i = (long long)blockIdx.x * kReduceThreads + threadIdx.x;
  if (i >= n_i) return;
  float sx = 0.0f, sy = 0.0f, sz = 0.0f;
  for (int p0 = 0; p0 < splits; p0 += kBatch) {
    float4 v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (p0 + u < splits) v[u] = partial[(long long)(p0 + u) * n_i + i];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (p0 + u < splits) {
        sx += v[u].x;
        sy += v[u].y;
        sz += v[u].z;
      }
    }
  }
  acc[3 * i] = sx;
  acc[3 * i + 1] = sy;
  acc[3 * i + 2] = sz;
}

// Launch kernel on stream; as a programmatic dependent of the launch
// before it when kOverlapLaunches.
template <typename... Params, typename... Args>
cudaError_t launch_dependent(void (*kernel)(Params...), dim3 grid,
                             dim3 block, cudaStream_t stream,
                             Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = kOverlapLaunches ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

}  // namespace

// scratch: float4s, the packed sources (n_j rounded up to kTile) and,
// with splits > 1, the partial sums (splits, n_i) after them.  Split s
// holds the sources [s * split_len, min(n_j, (s + 1) * split_len));
// split_len is a whole number of tiles and the splits cover n_j exactly.
extern "C" int nbody_acc_f32(const float* pos_i, int n_i, const float* pos_j,
                             const float* mass_j, int n_j, float* acc,
                             float softening, void* scratch, int splits,
                             int split_len, int device,
                             cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_i <= 0) return 0;
  if (n_j <= 0)
    return (int)cudaMemsetAsync(acc, 0, sizeof(float) * 3 * (size_t)n_i,
                                stream);
  if (scratch == nullptr || splits < 1 || splits > 65535 ||
      split_len <= 0 || split_len % kTile ||
      (long long)(splits - 1) * split_len >= n_j ||
      (long long)splits * split_len < n_j)
    return (int)cudaErrorInvalidValue;
  const int n_tiles = (n_j + kTile - 1) / kTile;
  const int n_pad = n_tiles * kTile;
  float4* packed = static_cast<float4*>(scratch);
  nbody_pack<<<(n_pad + 255) / 256, 256, 0, stream>>>(pos_j, mass_j, n_j,
                                                      n_pad, packed);
  const int rows = (n_i + kThreads * kTargets - 1) / (kThreads * kTargets);
  float4* partial = splits > 1 ? packed + n_pad : nullptr;
  err = launch_dependent(nbody_tiles, dim3(rows, splits), dim3(kThreads),
                         stream, pos_i, n_i, (const float4*)packed, n_tiles,
                         split_len / kTile, softening, acc, partial);
  if (err == cudaSuccess && splits > 1) {
    err = launch_dependent(
        nbody_reduce, dim3((n_i + kReduceThreads - 1) / kReduceThreads),
        dim3(kReduceThreads), stream, (const float4*)partial, n_i, splits,
        acc);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
