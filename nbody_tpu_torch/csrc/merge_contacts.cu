// Contact search of the collision merge pass for NVIDIA Hopper (sm_90a).
//
// Replaces the XLA-fused tile pass `one_tile` of
// nbody_tpu/ops/collisions.py:75 (no Pallas kernel there: XLA fuses each
// 512-row tile into one pass with no (c, M) temporaries). For every live
// row i of the massive prefix (live[i] != 0) it finds the heaviest live row
// j in contact that beats i:
//
//   contact(i, j) = |p_i - p_j|^2 < (factor * (r_i + r_j))^2, j != i,
//                   live[i], live[j], beats(j, i)
//   beats(j, i)   = m_j > m_i  or  (m_j == m_i and j < i)
//
// and writes winner[i] = that j, the lowest index among the heaviest, or
// m where there is none (a dead row, or no contact). The fp32 expressions
// are JAX's, in its order: dx = x_i - x_j, d2 = dx*dx + dy*dy,
// reach = factor * (r_i + r_j), contact iff d2 < reach*reach. Each is
// rounded on its own (__fsub_rn/__fmul_rn/__fadd_rn), so nvcc cannot
// contract a pair into an FFMA and move a contact that lies on the
// boundary.
//
// Design: one thread a target row, 256 targets a block; the sources pass
// through shared memory 256 at a time (x, y, r, and m, with m = -inf for a
// dead source so that it beats nobody). Each thread keeps a running
// (best mass, lowest index) pair over its sources, replaced when a contact
// has m_j > best, or m_j == best and j < win: the same answer as JAX's
// key.max followed by the lowest index among the maxima, whatever order
// the sources come in. The sources may be split into n_split ranges
// (gridDim.y) so that a prefix of a few hundred blocks still fills the
// card; each range writes its pair as one 64-bit key, (order-preserving
// bits of the mass) << 32 | (0xffffffff - j), 0 for none, and a second
// kernel takes the largest key of each row, which is the same pair. No
// atomics, no order dependence: the result is exact and the same in
// every run.
//
// What bounds it on an H100: operations. M^2 pairs of ~12 fp32 operations
// (two subtracts, three multiplies and an add for d2, an add and two
// multiplies for reach^2, the compares); bytes are 16 M for the sources
// and 8 M for the output.
//
// The C entry point launches on the stream it is handed, does not
// synchronise, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;

// Bits of a float mapped so that unsigned order is float order (for every
// non-NaN value). The masses of live rows are never 0 and never NaN.
__device__ __forceinline__ uint32_t ordered_bits(float m) {
  const uint32_t b = __float_as_uint(m);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__global__ void __launch_bounds__(kBlock)
contacts_kernel(const float2* __restrict__ pos, const float* __restrict__ radius,
                const float* __restrict__ mass,
                const unsigned char* __restrict__ live, int m, float factor,
                int tiles_per_split, unsigned long long* __restrict__ keys) {
  __shared__ float sx[kBlock], sy[kBlock], sr[kBlock], sm[kBlock];
  const int i = blockIdx.x * kBlock + threadIdx.x;
  const bool mine = i < m && live[i] != 0;
  float xi = 0.f, yi = 0.f, ri = 0.f, mi = 0.f;
  if (mine) {
    const float2 p = pos[i];
    xi = p.x;
    yi = p.y;
    ri = radius[i];
    mi = mass[i];
  }
  float best = -CUDART_INF_F;
  int win = m;
  const int n_tiles = (m + kBlock - 1) / kBlock;
  const int t0 = blockIdx.y * tiles_per_split;
  const int t1 = min(t0 + tiles_per_split, n_tiles);
  for (int t = t0; t < t1; ++t) {
    const int base = t * kBlock;
    const int j = base + threadIdx.x;
    __syncthreads();
    if (j < m) {
      const float2 p = pos[j];
      sx[threadIdx.x] = p.x;
      sy[threadIdx.x] = p.y;
      sr[threadIdx.x] = radius[j];
      sm[threadIdx.x] = live[j] != 0 ? mass[j] : -CUDART_INF_F;
    } else {
      sx[threadIdx.x] = 0.f;
      sy[threadIdx.x] = 0.f;
      sr[threadIdx.x] = 0.f;
      sm[threadIdx.x] = -CUDART_INF_F;  // past the prefix: beats nobody
    }
    __syncthreads();
    if (!mine) continue;
#pragma unroll 8
    for (int k = 0; k < kBlock; ++k) {
      const int jg = base + k;
      const float dx = __fsub_rn(xi, sx[k]);
      const float dy = __fsub_rn(yi, sy[k]);
      const float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
      const float reach = __fmul_rn(factor, __fadd_rn(ri, sr[k]));
      const float mj = sm[k];
      const bool beats = mj > mi || (mj == mi && jg < i);
      if (beats && jg != i && d2 < __fmul_rn(reach, reach) &&
          (mj > best || (mj == best && jg < win))) {
        best = mj;
        win = jg;
      }
    }
  }
  if (i < m) {
    keys[static_cast<size_t>(blockIdx.y) * m + i] =
        win < m ? (static_cast<unsigned long long>(ordered_bits(best)) << 32) |
                      (0xffffffffu - static_cast<uint32_t>(win))
                : 0ull;
  }
}

__global__ void __launch_bounds__(kBlock)
winner_kernel(const unsigned long long* __restrict__ keys, int m, int n_split,
              long long* __restrict__ winner) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= m) return;
  unsigned long long key = 0;
  for (int s = 0; s < n_split; ++s) {
    const unsigned long long k = keys[static_cast<size_t>(s) * m + i];
    key = k > key ? k : key;
  }
  winner[i] = key ? static_cast<long long>(
                        0xffffffffu - static_cast<uint32_t>(key & 0xffffffffu))
                  : static_cast<long long>(m);
}

}  // namespace

// pos (m, 2), radius (m,), mass (m,) fp32; live (m,) bytes (0 or 1);
// keys (n_split, m) 64-bit scratch; winner (m,) int64 out, m where row i
// has no contact that beats it. m >= 1, 1 <= n_split <= 65535, and the
// n_split ranges of tiles_per_split tiles of 256 sources cover the prefix.
extern "C" int nbody_merge_contacts(const void* pos, const void* radius,
                                    const void* mass, const void* live, int m,
                                    float factor, int n_split,
                                    int tiles_per_split, void* keys,
                                    void* winner, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((m + kBlock - 1) / kBlock, n_split);
  contacts_kernel<<<grid, kBlock, 0, s>>>(
      static_cast<const float2*>(pos), static_cast<const float*>(radius),
      static_cast<const float*>(mass), static_cast<const unsigned char*>(live),
      m, factor, tiles_per_split, static_cast<unsigned long long*>(keys));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  winner_kernel<<<(m + kBlock - 1) / kBlock, kBlock, 0, s>>>(
      static_cast<const unsigned long long*>(keys), m, n_split,
      static_cast<long long*>(winner));
  return static_cast<int>(cudaGetLastError());
}
