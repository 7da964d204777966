// The pair step of the ablation kernels redesigned for Hopper (K5a, K5b and
// K5c, v2_forces.cu; K5d, stationary_forces.cu; K5h, newton_forces.cu; K5i,
// bcast_probe.cu): P targets a thread, each source value that reaches the
// thread serving all P of them, and an unguarded rsqrt.
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
// flushes to 0. v2_forces.cu's, stationary_forces.cu's and
// newton_forces.cu's r2 >= 1e-18 is normal; bcast_probe.cu's r2 takes the
// target's raw third row and counts such pairs on its inputs (none).
//
// The math is a policy of Pairs (StepMath, the above, by default): the
// factor f, whether ty is summed, and whether only the first source of a
// staged range counts (K5c's op-cost probes, v2_forces.cu, change one of
// these at a time).
//
// A staged batch holds the x, y and gm rows of kBatch sources side by side
// (24 floats), read into registers as six 16-byte loads off one address.
// add_runs sums a staged range in runs of kRun sources (K5a, K5d; K5h's
// runs are its tile width), each into fresh registers before it joins the
// total. cp_async stages sources asynchronously (K5a-K5c, K5h).

#pragma once

#include <cuda_runtime.h>

#include <cstddef>

#include "source_tiles.cuh"  // kRun

namespace {

constexpr int kBatch = 8;      // sources read into registers together
constexpr int kRunUnroll = 4;  // batches a pass of add_runs' loop

template <int kBytes>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst),
               "l"(gmem), "n"(kBytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ float rsqrt_ftz(float x) {
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The default math: f = gm * inv^3 with the unguarded rsqrt, or (kPrecise)
// gm / (sqrtf(r2) * r2); both axes; every source.
template <bool kPrecise>
struct StepMath {
  static constexpr bool kY = true;           // ty is summed
  static constexpr bool kFirstOnly = false;  // only a range's first source
  static __device__ __forceinline__ float factor(float gm, float dx, float dy,
                                                 float soft) {
    if constexpr (kPrecise) {
      const float r2 = dx * dx + dy * dy + soft;
      return gm / (sqrtf(r2) * r2);
    } else {
      const float inv = rsqrt_ftz(dx * dx + dy * dy + soft);
      return gm * (inv * inv * inv);
    }
  }
};

// The P targets of one thread and their chains: target q, chain c.
template <int P, int K, bool kPrecise = false, class Math = StepMath<kPrecise>>
struct Pairs {
  float x[P], y[P], soft[P];
  float tx[P][K], ty[P][K];

  __device__ __forceinline__ void add(float sx, float sy, float gm, int c) {
#pragma unroll
    for (int q = 0; q < P; ++q) {
      const float dx = sx - x[q];
      const float dy = sy - y[q];
      const float f = Math::factor(gm, dx, dy, soft[q]);
      tx[q][c] += dx * f;
      if constexpr (Math::kY) ty[q][c] += dy * f;
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

// Issues the copies of sources [base, base + len) of the (3, n_src) rows at
// src into the stage st (stage_at's layout), one group, by the threads
// first, first + stride, ... vec16: 16-byte copies of whole groups of four
// (a row's last group may reach past len, never past n_src).
__device__ __forceinline__ void stage_rows(const float* __restrict__ src,
                                           int n_src, int base, int len,
                                           float* st, bool vec16, int first,
                                           int stride) {
  if (vec16) {
    const int n4 = (len + 3) / 4;
    for (int r = 0; r < 3; ++r) {
      const float* row = src + static_cast<size_t>(r) * n_src + base;
      for (int v = first; v < n4; v += stride)
        cp_async<16>(st + stage_at(4 * v, r), row + 4 * v);
    }
  } else {
    for (int r = 0; r < 3; ++r) {
      const float* row = src + static_cast<size_t>(r) * n_src + base;
      for (int k = first; k < len; k += stride)
        cp_async<4>(st + stage_at(k, r), row + k);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Adds the `len` sources staged at st (stage_at's layout, from a whole
// batch) to the totals (ax[q], ay[q]) of the thread's P targets run by run,
// kRunLen sources a run (the last run of a range may be shorter) summed into
// fresh registers, kRunUnroll batches a pass, each run then added to the
// total: the association of source_tiles.cuh's RunSum, which K5a and K5d
// had before they ran here. (One chain a chunk, v2_forces.cu's variant 0,
// drifts with the chunk: 5.5e-6 of the force's max against the direct sum
// at chunk 4096, PERF.md §6.) A ragged last batch (len not a multiple of
// 8) is read source by source.
template <int P, bool kPrecise, int kRunLen = kRun>
__device__ __forceinline__ void add_runs(const float* st, int len,
                                         Pairs<P, 1, kPrecise>& t, float* ax,
                                         float* ay) {
  static_assert(kRunLen % kBatch == 0, "a run is whole batches");
  constexpr int kPass = kBatch * kRunUnroll;
  constexpr int kStride = 3 * kBatch;  // floats of a staged batch
  for (int run = 0; run < len; run += kRunLen) {
    const int end = min(run + kRunLen, len);
#pragma unroll
    for (int q = 0; q < P; ++q) t.tx[q][0] = t.ty[q][0] = 0.f;
    int k = run;
    const float* batch = st + 3 * run;  // run is a whole number of batches
#pragma unroll 1
    for (; k + kPass <= end; k += kPass, batch += kRunUnroll * kStride) {
#pragma unroll
      for (int u = 0; u < kRunUnroll; ++u) t.add_batch(batch + u * kStride);
    }
#pragma unroll 1
    for (; k + kBatch <= end; k += kBatch, batch += kStride)
      t.add_batch(batch);
#pragma unroll
    for (int b = 0; b < kBatch - 1; ++b)
      if (k + b < end)
        t.add(batch[b], batch[kBatch + b], batch[2 * kBatch + b], 0);
#pragma unroll
    for (int q = 0; q < P; ++q) {
      ax[q] += t.tx[q][0];
      ay[q] += t.ty[q][0];
    }
  }
}

}  // namespace
