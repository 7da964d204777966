// The source-tile loop shared by the direct kernel (direct_forces.cu) and
// the ring hop kernel (ring_forces.cu): one thread per target, sources
// staged through shared memory one tile at a time.
//
// Math, per target i over sources j < n_src:
//   dx = sx_j - x_i;  dy = sy_j - y_i
//   r2 = dx*dx + dy*dy + (r_i + 1e-18)        (add order of _pair_chunk)
//   f  = gm_j / (sqrt(r2) * r2)               (precise: IEEE sqrt, divide)
//   f  = gm_j * inv*inv*inv, inv = rsqrt(r2)  (default)
//   a_i = sum_j (dx, dy) * f, summed per tile of sources, then over tiles

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;           // threads per block = targets per block
constexpr int kTile = kBlock;         // sources staged per shared-memory tile
constexpr float kSofteningFloor = 1e-18f;

// Adds to (ax, ay) the force on the target at p from source tiles
// [tile_begin, tile_end) of kTile sources each, staged through `tile` by all
// threads of the block. Each tile sums into fresh registers and then into
// the total, so a rounding error grows with kTile + n_src / kTile terms, not
// n_src (the TPU kernel's 128 column partials did the same). Warps with no
// live target stage sources but skip the arithmetic.
template <bool kPrecise>
__device__ __forceinline__ void accumulate_tiles(
    float2 p, float soft, bool warp_live, const float2* __restrict__ src_pos,
    const float* __restrict__ src_gm, int n_src, int tile_begin,
    int tile_end, float4* tile, float& ax, float& ay) {
  for (int t = tile_begin; t < tile_end; ++t) {
    const int base = t * kTile;
    const int j = base + threadIdx.x;
    if (j < n_src) {
      const float2 s = src_pos[j];
      tile[threadIdx.x] = make_float4(s.x, s.y, src_gm[j], 0.f);
    }
    __syncthreads();
    if (warp_live) {
      // The ragged last tile stops at n_src: no padding source is computed.
      const int len = min(kTile, n_src - base);
      float tx = 0.f, ty = 0.f;
#pragma unroll 8
      for (int k = 0; k < len; ++k) {
        const float4 s = tile[k];
        const float dx = s.x - p.x;
        const float dy = s.y - p.y;
        const float r2 = dx * dx + dy * dy + soft;
        float f;
        if (kPrecise) {
          f = s.z / (sqrtf(r2) * r2);
        } else {
          const float inv = rsqrtf(r2);
          f = s.z * (inv * inv * inv);
        }
        tx += dx * f;
        ty += dy * f;
      }
      ax += tx;
      ay += ty;
    }
    __syncthreads();
  }
}

}  // namespace
