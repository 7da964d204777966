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
// the TPU). One thread per target; the variants differ only in where the
// source comes from:
//   0 smem:  a float4 (x, y, gm, 0) staged in shared memory, read by the
//            whole warp at one address (K1's way)
//   1 shfl:  lane l holds source base + l in registers; each source is
//            three __shfl_sync from its lane
//   2 ldg:   a packed float4 array in device memory, read by the whole
//            warp at one address through the read-only path (__ldg)
//   3 const: the constant bank (x, y as float2 and gm; 48 KB of 64), read
//            by the whole warp at one address
// Each sweep sums runs of 256 sources into fresh registers, then the runs
// in order; the sweeps of a block add up in order. 512 targets fill only
// 2 blocks of 256, so the REPS sweeps are split over gridDim.y blocks and
// their (n_split, 2, T) partials summed in split order by a second kernel
// (no atomics, the same bits on every run). The targets are made opaque to
// the compiler at every sweep, so no sweep is hoisted out of the loop.
//
// What bounds it on an H100: one MUFU rsqrt per pair (16 per SM a clock):
// 4.295e9 pairs at the script's shape; the bytes are 56 KB.
//
// The C entry point launches on the stream it is handed, does not
// synchronise, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>

#include "source_tiles.cuh"  // allow_smem, launch_sum_partials

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSrc = 4096;
constexpr int kSweepRun = 256;
constexpr int kFetch = 8;  // sources read into registers before their pairs

__constant__ float2 c_xy[kMaxSrc];
__constant__ float c_gm[kMaxSrc];

__device__ __forceinline__ void add_pair(float sx, float sy, float gm,
                                         float px, float py, float pr,
                                         float& tx, float& ty) {
  const float dx = sx - px;
  const float dy = sy - py;
  const float inv = rsqrtf(dx * dx + dy * dy + pr);
  const float f = gm * (inv * inv * inv);
  tx += dx * f;
  ty += dy * f;
}

template <int V>
__device__ __forceinline__ float4 fetch(const float4* stage,
                                        const float4* __restrict__ packed,
                                        int j) {
  if constexpr (V == 0) return stage[j];
  if constexpr (V == 2) return __ldg(&packed[j]);
  if constexpr (V == 3) {
    const float2 xy = c_xy[j];
    return make_float4(xy.x, xy.y, c_gm[j], 0.f);
  }
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

template <int V>
__global__ void __launch_bounds__(kThreads)
bcast_kernel(const float* __restrict__ tgt, const float* __restrict__ src,
             const float4* __restrict__ packed, int n_tgt, int n_src,
             int reps, int reps_per_split, float* __restrict__ out) {
  extern __shared__ float4 stage[];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n_tgt;
  // Threads past the last target still take part in the warp's shuffles.
  float px = live ? tgt[i] : 0.f;
  float py = live ? tgt[n_tgt + i] : 0.f;
  float pr = live ? tgt[2 * n_tgt + i] : 1.f;
  if constexpr (V == 0) {
    for (int k = threadIdx.x; k < n_src; k += blockDim.x)
      stage[k] = make_float4(src[k], src[n_src + k], src[2 * n_src + k], 0.f);
    __syncthreads();
  }
  const int lane = threadIdx.x & 31;
  const int r0 = blockIdx.y * reps_per_split;
  const int r1 = min(r0 + reps_per_split, reps);
  float ax = 0.f, ay = 0.f;
#pragma unroll 1
  for (int r = r0; r < r1; ++r) {
    asm volatile("" : "+f"(px), "+f"(py), "+f"(pr));
    float wx = 0.f, wy = 0.f;
    for (int run = 0; run < n_src; run += kSweepRun) {
      const int end = min(run + kSweepRun, n_src);
      float tx = 0.f, ty = 0.f;
      if constexpr (V == 1) {
        for (int base = run; base < end; base += 32) {
          const float lx = src[base + lane];
          const float ly = src[n_src + base + lane];
          const float lg = src[2 * n_src + base + lane];
#pragma unroll
          for (int j = 0; j < 32; ++j)
            add_pair(__shfl_sync(0xffffffffu, lx, j),
                     __shfl_sync(0xffffffffu, ly, j),
                     __shfl_sync(0xffffffffu, lg, j), px, py, pr, tx, ty);
        }
      } else {
        for (int k = run; k < end; k += kFetch) {
          float4 s[kFetch];
#pragma unroll
          for (int b = 0; b < kFetch; ++b) s[b] = fetch<V>(stage, packed, k + b);
#pragma unroll
          for (int b = 0; b < kFetch; ++b)
            add_pair(s[b].x, s[b].y, s[b].z, px, py, pr, tx, ty);
        }
      }
      wx += tx;
      wy += ty;
    }
    ax += wx;
    ay += wy;
  }
  if (live) {
    float* o = out + static_cast<size_t>(blockIdx.y) * 2 * n_tgt;
    o[i] = ax;
    o[n_tgt + i] = ay;
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
  const size_t smem = V == 0 ? static_cast<size_t>(n_src) * sizeof(float4) : 0;
  cudaError_t err = allow_smem(bcast_kernel<V>, smem);
  if (err != cudaSuccess) return err;
  const int per = (reps + n_split - 1) / n_split;
  const dim3 grid((n_tgt + kThreads - 1) / kThreads, n_split);
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
