// Force only, P targets per thread against each source read, for NVIDIA
// Hopper (sm_90a).
//
// Replaces the TPU kernel scripts/ablations/tune_r2g.py::make_ptile ->
// kernel (K5g): each grid step ran P target sub-tiles of sub_t rows
// against one hoisted broadcast of a source chunk, to share the
// (1, chunk) -> (sub_t, chunk) broadcast among P consumers. The Hopper
// counterpart of that broadcast is the shared-memory read of a source:
// here each thread holds P targets (i, i + block, ..., strided so that
// loads stay coalesced) and their 2P accumulators in registers, and each
// 16-byte source read from shared memory serves P pairs instead of one.
// Sources are staged `chunk` at a time (the script's chunk); each thread
// sums runs of kRun sources into fresh registers. The kernel is
// source_tiles.cuh's chunk_kernel on (3, T) target rows.
//
// Occupancy: a block covers P * block targets, so at N=65536 with 256
// threads and P = 4 there are 64 blocks for 132 SMs. The launch therefore
// takes force_acc's source split (ops/direct_forces._split_plan, counted
// in chunks): gridDim.y = n_split blocks per target block, each over a
// contiguous range of whole chunks, writing a (2, T) partial; a second
// kernel sums the partials in split order (no atomics, the same bits on
// every run). n_split = 1 writes the result directly.
//
// What bounds it on an H100: per pair about ten fp32 instructions and one
// MUFU rsqrt; one shared-memory read per P pairs. The MUFU count (one per
// pair) is the floor that more targets per thread cannot lower.
//
// The C entry point launches on the stream it is handed, does not
// synchronise, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>

#include "source_tiles.cuh"  // RowTargets, launch_chunked

// out (2, n_tgt) = (ax; ay) on the (3, n_tgt) targets x; y; r from the
// (3, n_src) sources x; y; gm, rsqrt path. p: targets per thread, 1, 2, 4
// or 8; block: threads per block, a multiple of 32 up to 1024; chunk:
// sources staged per pass, 1 to 12288; n_split >= 1 source ranges of whole
// chunks, whose (n_split, 2, n_tgt) partials go to `part` (unused when
// n_split = 1). Device pointers to contiguous fp32 arrays. Returns the
// cudaError_t of the launches (0 on success).
extern "C" int nbody_ptile_forces(const void* tgt, const void* src,
                                  int n_tgt, int n_src, int p, int block,
                                  int chunk, int n_split, void* part,
                                  void* out, void* stream) {
  if (n_tgt <= 0) return static_cast<int>(cudaSuccess);
  if (block < 32 || block > 1024 || block % 32 || chunk < 1 ||
      chunk > 12288 || n_split < 1 || n_split > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const RowTargets t{static_cast<const float*>(tgt)};
  const auto* s = static_cast<const float*>(src);
  auto* pt = static_cast<float*>(part);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (p) {
    case 1: err = launch_chunked<1, false>(t, s, n_tgt, n_src, block, chunk, n_split, pt, o, st); break;
    case 2: err = launch_chunked<2, false>(t, s, n_tgt, n_src, block, chunk, n_split, pt, o, st); break;
    case 4: err = launch_chunked<4, false>(t, s, n_tgt, n_src, block, chunk, n_split, pt, o, st); break;
    case 8: err = launch_chunked<8, false>(t, s, n_tgt, n_src, block, chunk, n_split, pt, o, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
