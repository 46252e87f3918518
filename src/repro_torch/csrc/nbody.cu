// nbody: direct-sum accelerations acc_i = sum_j m_j d_ij rsqrt(r2)/r2,
// r2 = |d_ij|^2 + softening — the paper's Loop benchmark body.
//
// Replaces src/repro/kernels/nbody.py:nbody_accelerations (Pallas body
// _nbody_kernel); nbody_step's leapfrog update stays plain tensor code
// around it, as it was jnp code around the Pallas call.  Bound on the card:
// FP32 operations (~20 per interaction, n_i * n_j interactions on 28
// bytes a body), far above the bytes bound.  Design: one thread per target
// body holds its position and an f32 accumulator in registers; the block
// stages a tile of source bodies (x, y, z, m) in shared memory and every
// thread sweeps it, so each source is read from device memory once per
// block.  The TPU kernel carried the accumulator across sequential grid
// steps in VMEM; here blocks run in any order and the j-loop lives inside
// the block, so nothing carries between blocks.  Targets and sources are
// separate operands: a slot holding a slice of the bodies plus the copy
// of all of them computes its own rows.  The ragged last tile is masked by
// its count, not padded.  rsqrtf is the hardware approximation (<= 2 ulp),
// and rsqrt(r2)/r2 is taken as rsqrt(r2)^3, so results differ from a
// float64 reference by a relative error of order 1e-6 per term.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__global__ void nbody_kernel(const float* __restrict__ pos_i, int n_i,
                             const float* __restrict__ pos_j,
                             const float* __restrict__ mass_j, int n_j,
                             float* __restrict__ acc, float softening) {
  __shared__ float4 tile[kThreads];
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  float px = 0.0f, py = 0.0f, pz = 0.0f;
  if (i < n_i) {
    px = pos_i[3 * (long long)i];
    py = pos_i[3 * (long long)i + 1];
    pz = pos_i[3 * (long long)i + 2];
  }
  float ax = 0.0f, ay = 0.0f, az = 0.0f;
  for (int base = 0; base < n_j; base += kThreads) {
    int j = base + threadIdx.x;
    if (j < n_j) {
      tile[threadIdx.x] = make_float4(pos_j[3 * (long long)j],
                                      pos_j[3 * (long long)j + 1],
                                      pos_j[3 * (long long)j + 2], mass_j[j]);
    }
    __syncthreads();
    int count = n_j - base < kThreads ? n_j - base : kThreads;
#pragma unroll 8
    for (int k = 0; k < count; ++k) {
      float4 s = tile[k];
      float dx = s.x - px, dy = s.y - py, dz = s.z - pz;
      float r2 = dx * dx + dy * dy + dz * dz + softening;
      float inv = rsqrtf(r2);
      float w = s.w * inv * inv * inv;
      ax += w * dx;
      ay += w * dy;
      az += w * dz;
    }
    __syncthreads();
  }
  if (i < n_i) {
    acc[3 * (long long)i] = ax;
    acc[3 * (long long)i + 1] = ay;
    acc[3 * (long long)i + 2] = az;
  }
}

}  // namespace

extern "C" int nbody_acc_f32(const float* pos_i, int n_i, const float* pos_j,
                             const float* mass_j, int n_j, float* acc,
                             float softening, int device,
                             cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_i <= 0) return 0;
  int blocks = (n_i + kThreads - 1) / kThreads;
  nbody_kernel<<<blocks, kThreads, 0, stream>>>(pos_i, n_i, pos_j, mass_j,
                                                n_j, acc, softening);
  return (int)cudaGetLastError();
}
