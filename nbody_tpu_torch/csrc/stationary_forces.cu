// Force only, source-stationary: each block keeps one chunk of sources in
// shared memory and walks tiles of targets, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel scripts/ablations/tune_r2d.py::make_k3 -> kernel
// (K5d): a sequential grid over source chunks, the source broadcasts
// hoisted out of an inner loop over target tiles, and one (2, T)
// accumulator revisited by every grid step. Hopper's blocks run at once
// and in no order, so nothing may be carried from one block to the next:
// block (c, g) stages source chunk c once, walks the target tiles of slab
// g, and writes its sums to a (2, T) partial of its own, (n_chunks, 2, T)
// in all. A second kernel sums the partials in chunk order (no atomics,
// the same bits on every run).
//
// The partials cost n_chunks * T * 8 bytes: 135 MB at N=65536 with chunk
// 128, 8.4 MB with chunk 2048, written once and read once. With few
// chunks the blocks cannot fill 132 SMs (chunk 2048 at S=32833 gives 17),
// so the target tiles are cut into gridDim.y slabs (one slab is the pure
// source-stationary form; the wrapper's plan, ops/stationary_forces.py,
// runs many short blocks in waves). The script's manual_reduce changes
// only how the TPU's lanes reduce a (tile, chunk) product; a thread's
// serial sum has no counterpart of it.
//
// The script pads S to a whole number of chunks with gm = 0 rows; the
// kernel takes that layout (n_src a multiple of chunk).
//
// What bounds it on an H100: the issue rate of the SM's pipes, as for K5a
// and K5b (v2_forces.cu), whose pair step this kernel runs
// (pair_step.cuh):
//   * the chunk is staged in pair_step.cuh's batch layout: x, y and gm of
//     8 sources side by side, 12 bytes a source, read as six 16-byte loads
//     a batch (a chunk that is not a multiple of 8 ends in a ragged batch,
//     read source by source);
//   * a thread holds P = 2 targets (P = 1 in tiles of 32), strided by the
//     block, so that a tile is P * blockDim.x targets and one shared-memory
//     read of a source serves both;
//   * the rsqrt is rsqrt.approx.ftz.f32, MUFU.RSQ alone: r2 >= 1e-18 is a
//     normal float, rsqrtf's denormal guard never fires, and the bits are
//     the same; the precise path keeps gm / (sqrtf(r2) * r2) (no
//     --use_fast_math);
//   * each target sums runs of kRun = 256 sources into fresh registers and
//     adds them in order (add_runs), the association it had before.
// P changes no bits: each target keeps its own sums in source order.
//
// The C entry point launches on the stream it is handed, does not
// synchronise, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstddef>

#include "pair_step.cuh"     // Pairs, stage_at, add_runs
#include "source_tiles.cuh"  // kSofteningFloor, allow_smem, launch_sum_partials

namespace {

constexpr int kMaxThreads = 512;

template <int P, bool kPrecise>
__global__ void __launch_bounds__(kMaxThreads)
stationary_kernel(const float* __restrict__ tgt, const float* __restrict__ src,
                  int n_tgt, int n_src, int chunk, int tiles_per_slab,
                  float* __restrict__ part) {
  extern __shared__ float4 stationary_smem[];
  float* const stage = reinterpret_cast<float*>(stationary_smem);
  const int base = blockIdx.x * chunk;
  for (int r = 0; r < 3; ++r) {
    const float* row = src + static_cast<size_t>(r) * n_src + base;
    for (int k = threadIdx.x; k < chunk; k += blockDim.x)
      stage[stage_at(k, r)] = row[k];
  }
  __syncthreads();
  const int tile = P * blockDim.x;
  const int n_tiles = (n_tgt + tile - 1) / tile;
  const int t_begin = min(static_cast<int>(blockIdx.y) * tiles_per_slab,
                          n_tiles);
  const int t_end = min(t_begin + tiles_per_slab, n_tiles);
  float* o = part + static_cast<size_t>(blockIdx.x) * 2 * n_tgt;
  for (int t = t_begin; t < t_end; ++t) {
    const int first = t * tile + threadIdx.x;
    if (first >= n_tgt) break;  // the ragged last tile; no barrier follows
    Pairs<P, 1, kPrecise> pairs;
    float ax[P], ay[P];
#pragma unroll
    for (int q = 0; q < P; ++q) {
      // A second target past the last takes a finite stand-in.
      const int i = first + q * blockDim.x;
      const bool live = i < n_tgt;
      pairs.x[q] = live ? tgt[i] : 0.f;
      pairs.y[q] = live ? tgt[n_tgt + i] : 0.f;
      pairs.soft[q] = live ? tgt[2 * n_tgt + i] + kSofteningFloor : 1.f;
      ax[q] = ay[q] = 0.f;
    }
    add_runs<P, kPrecise>(stage, chunk, pairs, ax, ay);
#pragma unroll
    for (int q = 0; q < P; ++q) {
      const int i = first + q * blockDim.x;
      if (i < n_tgt) {
        o[i] = ax[q];
        o[n_tgt + i] = ay[q];
      }
    }
  }
}

template <int P, bool kPrecise>
cudaError_t launch(const float* tgt, const float* src, int n_tgt, int n_src,
                   int threads, int chunk, int n_slabs, float* part,
                   float* out, cudaStream_t st) {
  // whole batches of 8 sources, three rows each
  const size_t smem = static_cast<size_t>(3) * ((chunk + 7) / 8 * 8) *
                      sizeof(float);
  cudaError_t err = allow_smem(stationary_kernel<P, kPrecise>, smem);
  if (err != cudaSuccess) return err;
  const int n_chunks = n_src / chunk;
  const int n_tiles = (n_tgt + P * threads - 1) / (P * threads);
  const int per = (n_tiles + n_slabs - 1) / n_slabs;
  if (n_chunks > 0) {
    stationary_kernel<P, kPrecise>
        <<<dim3(n_chunks, n_slabs), threads, smem, st>>>(
            tgt, src, n_tgt, n_src, chunk, per, part);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return launch_sum_partials(part, n_tgt, n_chunks, n_tgt, 1, out, st);
}

}  // namespace

// out (2, n_tgt) = (ax; ay) on the (3, n_tgt) targets x; y; r from the
// (3, n_src) sources x; y; gm, n_src a multiple of chunk. p: targets a
// thread, 1 or 2; threads: a multiple of 32 up to 512 (a tile is p *
// threads targets); chunk: sources per block, 1 to 12288; n_slabs: 1 to
// 65535 slabs of whole target tiles; part: (n_src / chunk, 2, n_tgt)
// scratch. Device pointers to contiguous fp32 arrays. Returns the
// cudaError_t of the launches (0 on success).
extern "C" int nbody_stationary_forces(const void* tgt, const void* src,
                                       int n_tgt, int n_src, int p,
                                       int threads, int chunk, int n_slabs,
                                       int precise, void* part, void* out,
                                       void* stream) {
  if (n_tgt <= 0) return static_cast<int>(cudaSuccess);
  if ((p != 1 && p != 2) || threads < 32 || threads > kMaxThreads ||
      threads % 32 || chunk < 1 || chunk > 12288 || n_src % chunk ||
      n_slabs < 1 || n_slabs > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* t = static_cast<const float*>(tgt);
  const auto* s = static_cast<const float*>(src);
  auto* pt = static_cast<float*>(part);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (p == 1)
    err = precise
              ? launch<1, true>(t, s, n_tgt, n_src, threads, chunk, n_slabs, pt, o, st)
              : launch<1, false>(t, s, n_tgt, n_src, threads, chunk, n_slabs, pt, o, st);
  else
    err = precise
              ? launch<2, true>(t, s, n_tgt, n_src, threads, chunk, n_slabs, pt, o, st)
              : launch<2, false>(t, s, n_tgt, n_src, threads, chunk, n_slabs, pt, o, st);
  return static_cast<int>(err);
}
