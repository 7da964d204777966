// Source-broadcast probe for NVIDIA Hopper (sm_90a): four ways of getting
// one source value to every thread of a warp, in the same direct sum.
//
// Replaces the TPU kernel scripts/ablations/tune_r4d_bcast_probe.py::kernel
// (K5i), which swept S = 4096 sources past T = 512 targets REPS = 2048
// times with (T, 128) lane partials, and compared four Mosaic layouts of
// the (1, 128) -> (T, 128) source broadcast (mixed, bcast, onesmul,
// arrslice). Those layouts have no Hopper form; the question they asked
// does: what it costs to hand each source to every thread. The function is
// the same for every variant:
//   ax_i, ay_i = REPS x sum_j (dx, dy) * gm_j * inv^3,
//   inv = rsqrt(dx*dx + dy*dy + r_i)
// with the target's third row r_i added to r2 as the script adds it (no
// softening floor; a negative r_i can make r2 < 0 and the sum NaN, as on
// the TPU). The variants differ only in where a source comes from:
//   0 smem:  staged once in shared memory as pair_step.cuh's batches (the
//            x, y and gm rows of 8 sources side by side, 12 bytes a
//            source), read by the whole warp at one address, six 16-byte
//            reads for 8 sources (K5b's way; K1 reads a float4 a source)
//   1 shfl:  lane l holds source base + l in registers; each source is
//            three __shfl_sync from its lane
//   2 ldg:   a packed float4 array in device memory, read by the whole
//            warp at one address through the read-only path (__ldg), one
//            16-byte read a source
//   3 const: the constant bank (x, y as float2 and gm; 48 KB of 64), read
//            by the whole warp at one address
// Each sweep sums runs of 256 sources into fresh registers (smem, ldg and
// const four batches of 8 a pass, shfl a warp's 32), then the runs in order; the sweeps of a block add up in order; the REPS sweeps are
// split over gridDim.y blocks and their (n_split, 2, T) partials summed in
// split order by a second kernel (no atomics, the same bits on every run).
// The targets are made opaque to the compiler at every sweep, so no sweep
// is hoisted out of the loop.
//
// What bounds it on an H100: one MUFU rsqrt per pair (16 per SM a clock):
// 4.295e9 pairs at the script's shape; the bytes are 56 KB. Short of that,
// the issue rate of the SM's pipes, so the pair step is pair_step.cuh's,
// as K5b's (v2_forces.cu):
//   * P = 2 targets a thread, strided by the block: every source value that
//     reaches a thread (one shared-memory, global or constant read, or
//     three shuffles) serves two pairs. T = 512 is one block of 256
//     threads; a thread whose second target lies past T takes a finite
//     stand-in (0, 0, r = 1) and still takes part in the shuffles;
//   * rsqrt.approx.ftz.f32, MUFU.RSQ alone, in place of rsqrtf's denormal
//     guard: the same bits unless 0 < r2 < FLT_MIN (ops/bcast_probe.py
//     counts such pairs);
// P and the rsqrt change no bits where that count is 0: each target keeps
// its own sums in the same order.
//
// The C entry point launches on the stream it is handed, does not
// synchronise, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>

#include "pair_step.cuh"     // kBatch, Pairs, stage_at
#include "source_tiles.cuh"  // allow_smem, launch_sum_partials

namespace {

constexpr int kThreads = 256;
constexpr int kP = 2;  // targets a thread
constexpr int kMaxSrc = 4096;
constexpr int kSweepRun = 256;
constexpr int kPass = 32;  // sources a pass of the pair loop: n_src % 32 == 0

__constant__ float2 c_xy[kMaxSrc];
__constant__ float c_gm[kMaxSrc];

template <int V>
__device__ __forceinline__ float4 fetch(const float4* __restrict__ packed,
                                        int j) {
  if constexpr (V == 2) return __ldg(&packed[j]);
  const float2 xy = c_xy[j];
  return make_float4(xy.x, xy.y, c_gm[j], 0.f);
}

// Block (x, y) holds kP * blockDim.x targets, kP a thread (i, i +
// blockDim.x), and adds the sweeps [y * reps_per_split, ...) of them into
// out + y * 2 n_tgt, (2, n_tgt) rows ax; ay.
template <int V>
__global__ void __launch_bounds__(kThreads)
bcast_kernel(const float* __restrict__ tgt, const float* __restrict__ src,
             const float4* __restrict__ packed, int n_tgt, int n_src,
             int reps, int reps_per_split, float* __restrict__ out) {
  extern __shared__ float4 bcast_smem[];
  float* const stage = reinterpret_cast<float*>(bcast_smem);
  const int first = blockIdx.x * (kP * blockDim.x) + threadIdx.x;
  Pairs<kP, 1> t;
#pragma unroll
  for (int q = 0; q < kP; ++q) {
    const int i = first + q * blockDim.x;
    const bool live = i < n_tgt;
    t.x[q] = live ? tgt[i] : 0.f;
    t.y[q] = live ? tgt[n_tgt + i] : 0.f;
    t.soft[q] = live ? tgt[2 * n_tgt + i] : 1.f;
  }
  if constexpr (V == 0) {
    for (int r = 0; r < 3; ++r)
      for (int k = threadIdx.x; k < n_src; k += blockDim.x)
        stage[stage_at(k, r)] = src[r * n_src + k];
    __syncthreads();
  }
  const int lane = threadIdx.x & 31;
  const int r0 = blockIdx.y * reps_per_split;
  const int r1 = min(r0 + reps_per_split, reps);
  float ax[kP], ay[kP];
#pragma unroll
  for (int q = 0; q < kP; ++q) ax[q] = ay[q] = 0.f;
#pragma unroll 1
  for (int r = r0; r < r1; ++r) {
    asm volatile("" : "+f"(t.x[0]), "+f"(t.y[0]), "+f"(t.soft[0]),
                      "+f"(t.x[1]), "+f"(t.y[1]), "+f"(t.soft[1]));
    float wx[kP], wy[kP];
#pragma unroll
    for (int q = 0; q < kP; ++q) wx[q] = wy[q] = 0.f;
    for (int run = 0; run < n_src; run += kSweepRun) {
      const int end = min(run + kSweepRun, n_src);
#pragma unroll
      for (int q = 0; q < kP; ++q) t.tx[q][0] = t.ty[q][0] = 0.f;
      if constexpr (V == 0) {
        for (int k = run; k < end; k += kPass) {
#pragma unroll
          for (int u = 0; u < kPass; u += kBatch)
            t.add_batch(stage + 3 * (k + u));
        }
      } else if constexpr (V == 1) {
        for (int base = run; base < end; base += 32) {
          const float lx = src[base + lane];
          const float ly = src[n_src + base + lane];
          const float lg = src[2 * n_src + base + lane];
#pragma unroll
          for (int j = 0; j < 32; ++j)
            t.add(__shfl_sync(0xffffffffu, lx, j),
                  __shfl_sync(0xffffffffu, ly, j),
                  __shfl_sync(0xffffffffu, lg, j), 0);
        }
      } else {
        for (int k = run; k < end; k += kPass) {
#pragma unroll
          for (int u = 0; u < kPass; u += kBatch) {
            float4 s[kBatch];
#pragma unroll
            for (int b = 0; b < kBatch; ++b) s[b] = fetch<V>(packed, k + u + b);
#pragma unroll
            for (int b = 0; b < kBatch; ++b) t.add(s[b].x, s[b].y, s[b].z, 0);
          }
        }
      }
#pragma unroll
      for (int q = 0; q < kP; ++q) {
        wx[q] += t.tx[q][0];
        wy[q] += t.ty[q][0];
      }
    }
#pragma unroll
    for (int q = 0; q < kP; ++q) {
      ax[q] += wx[q];
      ay[q] += wy[q];
    }
  }
  float* o = out + static_cast<size_t>(blockIdx.y) * 2 * n_tgt;
#pragma unroll
  for (int q = 0; q < kP; ++q) {
    const int i = first + q * blockDim.x;
    if (i < n_tgt) {
      o[i] = ax[q];
      o[n_tgt + i] = ay[q];
    }
  }
}

// packed[j] = (x_j, y_j, gm_j, 0) (as4) or xy[j] = (x_j, y_j) (!as4).
__global__ void pack_kernel(const float* __restrict__ src, int n_src,
                            bool as4, void* __restrict__ packed) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n_src) return;
  if (as4)
    static_cast<float4*>(packed)[j] =
        make_float4(src[j], src[n_src + j], src[2 * n_src + j], 0.f);
  else
    static_cast<float2*>(packed)[j] = make_float2(src[j], src[n_src + j]);
}

template <int V>
cudaError_t launch(const float* tgt, const float* src, float4* packed,
                   int n_tgt, int n_src, int reps, int n_split, float* part,
                   float* out, cudaStream_t st) {
  const size_t smem = V == 0 ? static_cast<size_t>(3) * n_src * sizeof(float) : 0;
  cudaError_t err = allow_smem(bcast_kernel<V>, smem);
  if (err != cudaSuccess) return err;
  const int per = (reps + n_split - 1) / n_split;
  const dim3 grid((n_tgt + kP * kThreads - 1) / (kP * kThreads), n_split);
  bcast_kernel<V><<<grid, kThreads, smem, st>>>(
      tgt, src, packed, n_tgt, n_src, reps, per, n_split > 1 ? part : out);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return err;
  return launch_sum_partials(part, n_tgt, n_split, n_tgt, 1, out, st);
}

}  // namespace

// out (2, n_tgt) = reps x the force of the (3, n_src) sources x; y; gm on
// the (3, n_tgt) targets x; y; r (r added to r2), by variant `variant`
// (0 smem, 1 shfl, 2 ldg, 3 const). n_src a multiple of 32 up to 4096;
// n_split >= 1 ranges of whole sweeps, whose (n_split, 2, n_tgt) partials
// go to `part` (unused when n_split = 1); `packed`: n_src float4 of
// scratch. The const variant overwrites the library's constant bank on
// `stream` before its launch. Device pointers to contiguous fp32 arrays.
// Returns the cudaError_t of the launches (0 on success).
extern "C" int nbody_bcast_probe(const void* tgt, const void* src, int n_tgt,
                                 int n_src, int variant, int reps,
                                 int n_split, void* packed, void* part,
                                 void* out, void* stream) {
  if (n_tgt <= 0) return static_cast<int>(cudaSuccess);
  if (n_src < 32 || n_src > kMaxSrc || n_src % 32 || reps < 0 ||
      n_split < 1 || n_split > 65535 || variant < 0 || variant > 3)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* t = static_cast<const float*>(tgt);
  const auto* s = static_cast<const float*>(src);
  auto* pk = static_cast<float4*>(packed);
  auto* pt = static_cast<float*>(part);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  if (variant >= 2) {
    pack_kernel<<<(n_src + kThreads - 1) / kThreads, kThreads, 0, st>>>(
        s, n_src, variant == 2, pk);
    err = cudaGetLastError();
  }
  if (err == cudaSuccess && variant == 3) {
    err = cudaMemcpyToSymbolAsync(c_xy, pk, n_src * sizeof(float2), 0,
                                  cudaMemcpyDeviceToDevice, st);
    if (err == cudaSuccess)
      err = cudaMemcpyToSymbolAsync(c_gm, s + 2 * n_src, n_src * sizeof(float),
                                    0, cudaMemcpyDeviceToDevice, st);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (variant) {
    case 0: err = launch<0>(t, s, pk, n_tgt, n_src, reps, n_split, pt, o, st); break;
    case 1: err = launch<1>(t, s, pk, n_tgt, n_src, reps, n_split, pt, o, st); break;
    case 2: err = launch<2>(t, s, pk, n_tgt, n_src, reps, n_split, pt, o, st); break;
    default: err = launch<3>(t, s, pk, n_tgt, n_src, reps, n_split, pt, o, st);
  }
  return static_cast<int>(err);
}
