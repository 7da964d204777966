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
// source read from shared memory serves P pairs instead of one. The kernel
// is pair_step.cuh's sweep_body on (3, T) target rows under the policy
// RunSweep: each chunk (the script's chunk) summed in runs of kRun = 256
// sources from its start, each run in fresh registers before it joins the
// total, as this kernel summed before it ran there.
//
// What bounds it on an H100: the issue rate of the SM's instruction pipes.
// A pair is ten fp32 instructions and one MUFU.RSQ; the design cuts the
// instructions a pair costs as K5a-K5d did on the same step:
//   * the rsqrt is PTX rsqrt.approx.ftz.f32 (pair_step.cuh's StepMath),
//     MUFU.RSQ alone; rsqrtf without fast math added a denormal guard
//     (FSETP and two predicated FMUL a pair). r2 >= 1e-18 is a normal
//     float, so the two give the same bits;
//   * sources are read 8 at a time as six 16-byte loads (Pairs::add_batch),
//     four batches a pass of the loop up to P = 2, one from P = 4;
//   * sources are staged `stage` at a time (the whole chunk up to 1024
//     sources, else a multiple of 256; ops/ptile_forces.stage), through
//     double-buffered cp.async copies, one barrier a stage. The stage is
//     not the chunk: two buffers of a 4096-source chunk (96 KB) would leave
//     two blocks an SM.
//
// Occupancy: a block covers P * block targets, so at N=65536 with 256
// threads and P = 4 there are 64 blocks for 132 SMs. The launch therefore
// takes a source split (ops/ptile_forces.split_plan, counted in chunks):
// gridDim.y = n_split blocks per target block, each over a contiguous range
// of whole chunks, writing a (2, T) partial; a second kernel sums the
// partials in split order (no atomics, the same bits on every run).
// n_split = 1 writes the result directly.
//
// The C entry point launches on the stream it is handed, does not
// synchronise, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>

#include "pair_step.cuh"  // sweep_body, RunSweep, StepMath, launch_sweep,
                          // sweep_stage_ok

namespace {

// No launch bound: any bound took P = 2 from 48 registers to 64 and 3% slower
// on an H100, and one of 1024 threads (64 registers) made P = 4 and 8 spill.
// Unbounded, P = 1, 2, 4, 8 take 37, 48, 72 and 128 registers, so a block
// launches up to 1024 threads at P <= 2, 896 at P = 4 and 512 at P = 8; a
// larger one fails at launch and the wrapper raises.
template <int P>
__global__ void ptile_kernel(RowTargets targets,
                             const float* __restrict__ src, int n_tgt,
                             int n_src, int chunk, int stage,
                             int chunks_per_split, int vec16,
                             float* __restrict__ out) {
  sweep_body<P, RunSweep, StepMath<false>>(targets, src, n_tgt, n_src, chunk,
                                           stage, chunks_per_split, vec16,
                                           out);
}

}  // namespace

// out (2, n_tgt) = (ax; ay) on the (3, n_tgt) targets x; y; r from the
// (3, n_src) sources x; y; gm, rsqrt path. p: targets per thread, 1, 2, 4
// or 8; block: threads per block, a multiple of 32 up to 1024; chunk:
// sources a range of the sum, 1 to 12288; stage: sources a shared-memory
// stage, the chunk or a multiple of 256 below it (sweep_stage_ok); n_split
// >= 1 source ranges of whole chunks, whose (n_split, 2, n_tgt) partials go
// to `part` (unused when n_split = 1). Device pointers to contiguous fp32
// arrays. Returns the cudaError_t of the launches (0 on success).
extern "C" int nbody_ptile_forces(const void* tgt, const void* src,
                                  int n_tgt, int n_src, int p, int block,
                                  int chunk, int stage, int n_split,
                                  void* part, void* out, void* stream) {
  if (n_tgt <= 0) return static_cast<int>(cudaSuccess);
  if (block < 32 || block > 1024 || block % 32 || chunk < 1 ||
      chunk > 12288 || !sweep_stage_ok(chunk, stage) || n_split < 1 ||
      n_split > 65535 || n_src < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* t = static_cast<const float*>(tgt);
  const auto* s = static_cast<const float*>(src);
  auto* pt = static_cast<float*>(part);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (p) {
    case 1: err = launch_sweep<1>(ptile_kernel<1>, t, s, n_tgt, n_src, block, chunk, stage, n_split, pt, o, st); break;
    case 2: err = launch_sweep<2>(ptile_kernel<2>, t, s, n_tgt, n_src, block, chunk, stage, n_split, pt, o, st); break;
    case 4: err = launch_sweep<4>(ptile_kernel<4>, t, s, n_tgt, n_src, block, chunk, stage, n_split, pt, o, st); break;
    case 8: err = launch_sweep<8>(ptile_kernel<8>, t, s, n_tgt, n_src, block, chunk, stage, n_split, pt, o, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
