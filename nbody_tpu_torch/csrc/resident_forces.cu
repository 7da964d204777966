// Force only, sources read through shared memory in chunks of a size the
// caller picks, one thread per target, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel scripts/ablations/tune_r2.py::_v2_kernel (K5a):
// a grid over tiles of tile_t targets, the whole (3, S) source row
// resident in VMEM, a fori_loop over chunks of `chunk` sources and a static
// tail chunk. Here a block of `block` threads holds block targets, one per
// thread, in registers; the block stages the (x, y, gm) rows through
// dynamic shared memory `chunk` sources at a time (the script's knob,
// 512-4096 sources, 8-64 KB as float4) and stops at the ragged last chunk
// (the script's tail). Within a chunk each thread sums runs of kRun
// sources into fresh registers. The kernel is source_tiles.cuh's
// chunk_kernel with one target per thread, no source split, and targets
// read as (T, 2) positions and a (T,) radius; K5g's kernel is the same
// body with P targets per thread on (3, T) rows.
//
// How it differs from direct_forces.cu's force_acc (K1): the same pair
// math and the same 16-byte broadcast read per pair; there the tile is
// fixed at 256 sources and 256 threads, the sources come from (S, 2)
// positions and an (S,) gm row, and a source split fills the card when
// targets are few. Here the block and the chunk are parameters, the
// sources come as the script's (3, S) rows, and there is no split: at
// N=65536 a block of 256 gives 256 blocks on 132 SMs, as K1's main path.
//
// What bounds it on an H100: per pair about ten fp32 instructions and one
// MUFU rsqrt (a sqrt and a divide when precise) and one shared-memory
// read, so the issue rate of the SM's pipes; the bytes (targets, sources,
// output once) are a few MB and sit in L2.
//
// The C entry point launches on the stream it is handed, does not
// synchronise, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>

#include "source_tiles.cuh"  // chunk_kernel, PairTargets, launch_chunked

// acc (n_tgt, 2) = force on n_tgt targets, tgt_pos (n_tgt, 2) and
// tgt_radius (n_tgt,), from the (3, n_src) source rows x; y; gm at src.
// block: threads (targets) per block, a multiple of 32 up to 1024; chunk:
// sources staged per pass, 1 to 12288. Device pointers to contiguous fp32
// arrays. Returns the cudaError_t of the launch (0 on success).
extern "C" int nbody_resident_forces(const void* tgt_pos,
                                     const void* tgt_radius, const void* src,
                                     int n_tgt, int n_src, int block,
                                     int chunk, int precise, void* acc,
                                     void* stream) {
  if (n_tgt <= 0) return static_cast<int>(cudaSuccess);
  if (block < 32 || block > 1024 || block % 32 || chunk < 1 || chunk > 12288)
    return static_cast<int>(cudaErrorInvalidValue);
  const PairTargets targets{static_cast<const float2*>(tgt_pos),
                            static_cast<const float*>(tgt_radius)};
  const auto* sp = static_cast<const float*>(src);
  auto* out = static_cast<float*>(acc);
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      precise ? launch_chunked<1, true>(targets, sp, n_tgt, n_src, block,
                                        chunk, 1, nullptr, out, st)
              : launch_chunked<1, false>(targets, sp, n_tgt, n_src, block,
                                         chunk, 1, nullptr, out, st);
  return static_cast<int>(err);
}
