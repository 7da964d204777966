// The pair step of the ablation kernels redesigned for Hopper (K5a and K5b,
// v2_forces.cu; K5i, bcast_probe.cu): P targets a thread, each source value
// that reaches the thread serving all P of them, and an unguarded rsqrt.
//
// Per target q and source (sx, sy, gm), on chain c:
//   dx = sx - x_q;  dy = sy - y_q;  r2 = dx*dx + dy*dy + soft_q
//   f  = gm * inv*inv*inv, inv = rsqrt.approx.ftz(r2)   (default)
//   f  = gm / (sqrtf(r2) * r2)                         (kPrecise: IEEE
//        sqrt and divide, nvcc's defaults; no --use_fast_math)
//   tx[q][c] += dx * f;  ty[q][c] += dy * f
// rsqrt.approx.ftz.f32 is MUFU.RSQ alone; rsqrtf without fast math adds a
// denormal guard (FSETP and two predicated FMUL a pair). The two give the
// same bits wherever r2 is a normal float or r2 <= 0 or NaN (both +inf at
// 0, NaN below); they differ only for 0 < r2 < FLT_MIN, which the ftz form
// flushes to 0. v2_forces.cu's r2 >= 1e-18 is normal; bcast_probe.cu's r2
// takes the target's raw third row and counts such pairs on its inputs
// (none).
//
// A staged batch holds the x, y and gm rows of kBatch sources side by side
// (24 floats), read into registers as six 16-byte loads off one address.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kBatch = 8;  // sources read into registers together

__device__ __forceinline__ float rsqrt_ftz(float x) {
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The P targets of one thread and their chains: target q, chain c.
template <int P, int K, bool kPrecise = false>
struct Pairs {
  float x[P], y[P], soft[P];
  float tx[P][K], ty[P][K];

  __device__ __forceinline__ void add(float sx, float sy, float gm, int c) {
#pragma unroll
    for (int q = 0; q < P; ++q) {
      const float dx = sx - x[q];
      const float dy = sy - y[q];
      float f;
      if constexpr (kPrecise) {
        const float r2 = dx * dx + dy * dy + soft[q];
        f = gm / (sqrtf(r2) * r2);
      } else {
        const float inv = rsqrt_ftz(dx * dx + dy * dy + soft[q]);
        f = gm * (inv * inv * inv);
      }
      tx[q][c] += dx * f;
      ty[q][c] += dy * f;
    }
  }

  // The 8 sources of the staged batch at `batch` (x, y and gm rows of 8),
  // read into registers first, then their pairs in source order, source b
  // of the batch on chain b % K.
  __device__ __forceinline__ void add_batch(const float* batch) {
    const float4* v = reinterpret_cast<const float4*>(batch);
    float xs[kBatch], ys[kBatch], gs[kBatch];
#pragma unroll
    for (int h = 0; h < kBatch / 4; ++h) {
      const float4 a = v[h];
      const float4 b = v[2 + h];
      const float4 g = v[4 + h];
      xs[4 * h] = a.x; xs[4 * h + 1] = a.y; xs[4 * h + 2] = a.z; xs[4 * h + 3] = a.w;
      ys[4 * h] = b.x; ys[4 * h + 1] = b.y; ys[4 * h + 2] = b.z; ys[4 * h + 3] = b.w;
      gs[4 * h] = g.x; gs[4 * h + 1] = g.y; gs[4 * h + 2] = g.z; gs[4 * h + 3] = g.w;
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) add(xs[b], ys[b], gs[b], b % K);
  }
};

// Where source k of a staged range and row r (x, y, gm) lie: batch k / 8
// holds rows of 8.
__device__ __forceinline__ int stage_at(int k, int r) {
  return (k / kBatch) * (3 * kBatch) + r * kBatch + k % kBatch;
}

}  // namespace
