// Pieces shared by the direct-force kernels: the block and run sizes, the
// softening floor, the two target layouts, the fixed-order sum of
// per-range partials and the opt-in to more dynamic shared memory. The
// main-path kernels (direct_forces.cu, ring_forces.cu) run their own pair
// loop, direct_tiles.cuh; the ablation kernels K5a-K5i theirs,
// pair_step.cuh.
//
// Math, per target i over sources j < n_src:
//   dx = sx_j - x_i;  dy = sy_j - y_i
//   r2 = dx*dx + dy*dy + (r_i + 1e-18)        (add order of _pair_chunk)
//   f  = gm_j / (sqrt(r2) * r2)               (precise: IEEE sqrt, divide)
//   f  = gm_j * inv*inv*inv, inv = rsqrt(r2)  (default)
//   a_i = sum_j (dx, dy) * f, summed per run of sources, then over runs
// The floor keeps a zero-radius target on a gm = 0 padding row at its own
// position finite.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;           // threads per block of the main-path kernels
constexpr float kSofteningFloor = 1e-18f;
// Sources summed into fresh registers before joining a target's total, so
// a rounding error grows with kRun plus the number of runs, not with the
// source count (the TPU kernel's 128 column partials did the same).
constexpr int kRun = kBlock;

// Targets as (T, 2) positions and a (T,) radius, results as (T, 2) pairs.
struct PairTargets {
  const float2* pos;
  const float* radius;
  __device__ void load(int i, int, float& x, float& y, float& r) const {
    const float2 p = pos[i];
    x = p.x;
    y = p.y;
    r = radius[i];
  }
  static constexpr int kComp = 1;  // out stride from ax to ay
  static constexpr int kElem = 2;  // out stride from target i to i + 1
};

// Targets as (3, T) rows x; y; r, results as (2, T) rows ax; ay.
struct RowTargets {
  const float* rows;
  __device__ void load(int i, int n, float& x, float& y, float& r) const {
    x = rows[i];
    y = rows[n + i];
    r = rows[2 * n + i];
  }
  static constexpr int kComp = -1;  // n: the second row
  static constexpr int kElem = 1;
};

// out[c * comp + i * elem] = sum over k < n_part, in order of k, of
// part[k * 2 n + c * comp + i * elem], for c in {0, 1}: an n-target result
// from n_part partials of the same layout ((n, 2) pairs: comp 1, elem 2;
// (2, n) rows: comp n, elem 1), the same bits on every run (no atomics).
__global__ void __launch_bounds__(kBlock)
sum_partials_kernel(const float* __restrict__ part, int n, int n_part,
                    int comp, int elem, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const size_t at = static_cast<size_t>(i) * elem;
  float ax = 0.f, ay = 0.f;
  for (int k = 0; k < n_part; ++k) {
    const float* p = part + static_cast<size_t>(k) * 2 * n + at;
    ax += p[0];
    ay += p[comp];
  }
  out[at] = ax;
  out[at + comp] = ay;
}

inline cudaError_t launch_sum_partials(const float* part, int n, int n_part,
                                       int comp, int elem, float* out,
                                       cudaStream_t stream) {
  sum_partials_kernel<<<(n + kBlock - 1) / kBlock, kBlock, 0, stream>>>(
      part, n, n_part, comp, elem, out);
  return cudaGetLastError();
}

// Opt a kernel in to more than 48 KB of dynamic shared memory.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace
