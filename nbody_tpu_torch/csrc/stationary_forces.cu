// Force only, source-stationary: each block keeps one chunk of sources in
// shared memory and walks tiles of targets, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel scripts/ablations/tune_r2d.py::make_k3 -> kernel
// (K5d): a sequential grid over source chunks, the source broadcasts
// hoisted out of an inner loop over target tiles, and one (2, T)
// accumulator revisited by every grid step. Hopper's blocks run at once
// and in no order, so nothing may be carried from one block to the next:
// block (c, g) stages source chunk c once, walks the target tiles of slab
// g (tile = block threads, one target per thread, runs of kRun sources
// summed into fresh registers), and writes its sums to a (2, T) partial of
// its own, (n_chunks, 2, T) in all. A second kernel sums the partials in
// chunk order (no atomics, the same bits on every run).
//
// The partials cost n_chunks * T * 8 bytes: 135 MB at N=65536 with chunk
// 128, 8.4 MB with chunk 2048, written once and read once. With few
// chunks the blocks cannot fill 132 SMs (chunk 2048 at S=32833 gives 17),
// so the target tiles are cut into gridDim.y slabs (one slab is the pure
// source-stationary form). The script's manual_reduce changes only how the
// TPU's lanes reduce a (tile, chunk) product; a thread's serial sum has no
// counterpart of it.
//
// The script pads S to a whole number of chunks with gm = 0 rows; the
// kernel takes that layout (n_src a multiple of chunk).
//
// What bounds it on an H100: per pair about ten fp32 instructions and one
// MUFU rsqrt (a sqrt and a divide when precise) and one shared-memory read;
// the partials add n_chunks * T * 16 bytes of traffic.
//
// The C entry point launches on the stream it is handed, does not
// synchronise, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>

#include "source_tiles.cuh"  // accumulate_staged, stage_sources, launch_sum_partials

namespace {

template <bool kPrecise>
__global__ void stationary_kernel(const float* __restrict__ tgt,
                                  const float* __restrict__ src, int n_tgt,
                                  int n_src, int chunk, int tiles_per_slab,
                                  float* __restrict__ part) {
  extern __shared__ float4 stage[];
  stage_sources(src, n_src, blockIdx.x * chunk, chunk, stage);
  __syncthreads();
  const int n_tiles = (n_tgt + blockDim.x - 1) / blockDim.x;
  const int t_begin = min(static_cast<int>(blockIdx.y) * tiles_per_slab,
                          n_tiles);
  const int t_end = min(t_begin + tiles_per_slab, n_tiles);
  float* o = part + static_cast<size_t>(blockIdx.x) * 2 * n_tgt;
  for (int t = t_begin; t < t_end; ++t) {
    const int i = t * blockDim.x + threadIdx.x;
    if (i >= n_tgt) break;  // the ragged last tile; no barrier follows
    const float px[1] = {tgt[i]}, py[1] = {tgt[n_tgt + i]};
    const float soft[1] = {tgt[2 * n_tgt + i] + kSofteningFloor};
    float ax[1] = {0.f}, ay[1] = {0.f};
    accumulate_staged<1, kPrecise>(stage, chunk, px, py, soft, ax, ay);
    o[i] = ax[0];
    o[n_tgt + i] = ay[0];
  }
}

template <bool kPrecise>
cudaError_t launch(const float* tgt, const float* src, int n_tgt, int n_src,
                   int block, int chunk, int n_slabs, float* part,
                   float* out, cudaStream_t st) {
  const size_t smem = static_cast<size_t>(chunk) * sizeof(float4);
  cudaError_t err = allow_smem(stationary_kernel<kPrecise>, smem);
  if (err != cudaSuccess) return err;
  const int n_chunks = n_src / chunk;
  const int n_tiles = (n_tgt + block - 1) / block;
  const int per = (n_tiles + n_slabs - 1) / n_slabs;
  if (n_chunks > 0) {
    stationary_kernel<kPrecise><<<dim3(n_chunks, n_slabs), block, smem, st>>>(
        tgt, src, n_tgt, n_src, chunk, per, part);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return launch_sum_partials(part, n_tgt, n_chunks, n_tgt, 1, out, st);
}

}  // namespace

// out (2, n_tgt) = (ax; ay) on the (3, n_tgt) targets x; y; r from the
// (3, n_src) sources x; y; gm, n_src a multiple of chunk. block: threads
// (targets) per tile, a multiple of 32 up to 1024; chunk: sources per
// block, 1 to 12288; n_slabs: 1 to 65535 slabs of whole target tiles;
// part: (n_src / chunk, 2, n_tgt) scratch. Device pointers to contiguous
// fp32 arrays. Returns the cudaError_t of the launches (0 on success).
extern "C" int nbody_stationary_forces(const void* tgt, const void* src,
                                       int n_tgt, int n_src, int block,
                                       int chunk, int n_slabs, int precise,
                                       void* part, void* out, void* stream) {
  if (n_tgt <= 0) return static_cast<int>(cudaSuccess);
  if (block < 32 || block > 1024 || block % 32 || chunk < 1 ||
      chunk > 12288 || n_src % chunk || n_slabs < 1 || n_slabs > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* t = static_cast<const float*>(tgt);
  const auto* s = static_cast<const float*>(src);
  auto* pt = static_cast<float*>(part);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      precise ? launch<true>(t, s, n_tgt, n_src, block, chunk, n_slabs, pt, o, st)
              : launch<false>(t, s, n_tgt, n_src, block, chunk, n_slabs, pt, o, st);
  return static_cast<int>(err);
}
