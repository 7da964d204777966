// Force-only flavors of the chunked resident-source kernel, for NVIDIA
// Hopper (sm_90a): the build-time variants that a TPU script compares.
//
// Replaces the TPU kernel
//   scripts/ablations/tune_r2e.py::make_v3 -> kernel (K5e)
// It was K5a's kernel (a grid over target tiles, the (3, S) source row
// resident in VMEM, a fori_loop over source chunks and a static tail) with
// one thing changed: the reduction (a per-chunk sum, a (tile, 128)
// lane-partial carry, an FMA k-loop) or the association of f. Here each is
// pair_step.cuh's sweep_body (K5g's kernel, ptile_forces.cu) with a sum
// policy (SweepSum) and a pair math, P targets per thread, block threads
// per block: the script's tile_t is P * block. Its stages, its unguarded
// rsqrt (rsqrt.approx.ftz.f32, MUFU.RSQ alone) and its 8-source batches are
// K5g's; the chains of a chunk or a run are carried from stage to stage,
// so the stage does not change the sums. K5b (tune_r2b.py::make_v2) and
// K5c (tune_r2c.py::make_probe) run in a kernel of their own,
// v2_forces.cu.
//
// Variants (the Python wrapper ops/flavor_forces.py names them; 1 and 2
// were K5b's, 6-12 K5c's, and are gone; the others keep their numbers):
//   0 control: one run a chunk (the script's per-chunk jnp.sum), one chain
//   3 partial_jnp: K chains a chunk joined to K lane sums carried to the
//     end and folded there in lane order (the (tile, 128) carry; no thread
//     can hold 128 lanes)
//   4 fma_kloop: K chains fed straight by the pair's FFMAs, folded in chain
//     order into the total every kRun = 256 sources (one level; a chain of
//     S/K terms over the whole sweep rounds past 5e-6 at K <= 4)
//   5 f_assoc: 0 with f = (gm * inv) * (inv * inv)
// K = 8 chains at P <= 2, 4 at P = 4, 2 at P = 8 (the registers of 512
// threads). Targets are (3, T) rows. Every variant runs at P = 1, 2, 4 and
// 8. Source splits as K5g's.
//
// What bounds it on an H100: per pair about ten fp32 instructions and one
// MUFU rsqrt, a batch's six 16-byte shared-memory loads served to P
// targets, as K5g. __launch_bounds__(512): at most 128 registers a thread,
// so that 512-thread blocks launch at P = 8.
//
// The C entry point launches on the stream it is handed, does not
// synchronise, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>

#include "pair_step.cuh"  // sweep_body, SweepSum, StepMath, rsqrt_ftz,
                          // launch_sweep, sweep_stage_ok

namespace {

constexpr int kMaxBlock = 512;

// f = (gm * inv) * (inv * inv), the unguarded rsqrt
struct AssocMath : StepMath<false> {
  static __device__ __forceinline__ float factor(float gm, float dx, float dy,
                                                 float soft) {
    const float inv = rsqrt_ftz(dx * dx + dy * dy + soft);
    return (gm * inv) * (inv * inv);
  }
};

template <int P>
constexpr int chains() { return P <= 2 ? 8 : 16 / P; }

// Variant V's sum policy and pair math at P targets per thread.
template <int V, int P> struct Variant;
template <int P> struct Variant<0, P> { using Sum = SweepSum<0, 1, false>; using Math = StepMath<false>; };
template <int P> struct Variant<3, P> : Variant<0, P> { using Sum = SweepSum<0, chains<P>(), true>; };
template <int P> struct Variant<4, P> : Variant<0, P> { using Sum = SweepSum<kRun, chains<P>(), false>; };
template <int P> struct Variant<5, P> : Variant<0, P> { using Math = AssocMath; };

template <int P, int V>
__global__ void __launch_bounds__(kMaxBlock)
flavor_kernel(RowTargets targets, const float* __restrict__ src, int n_tgt,
              int n_src, int chunk, int stage, int chunks_per_split,
              int vec16, float* __restrict__ out) {
  using F = Variant<V, P>;
  sweep_body<P, typename F::Sum, typename F::Math>(
      targets, src, n_tgt, n_src, chunk, stage, chunks_per_split, vec16, out);
}

// Variant `variant` of the list V, Rest... (only those are instantiated).
template <int P, int V, int... Rest>
cudaError_t launch_variant(int variant, const float* t, const float* s,
                           int n_tgt, int n_src, int block, int chunk,
                           int stage, int n_split, float* part, float* out,
                           cudaStream_t st) {
  if (variant == V)
    return launch_sweep<P>(flavor_kernel<P, V>, t, s, n_tgt, n_src, block,
                           chunk, stage, n_split, part, out, st);
  if constexpr (sizeof...(Rest) > 0)
    return launch_variant<P, Rest...>(variant, t, s, n_tgt, n_src, block,
                                      chunk, stage, n_split, part, out, st);
  else
    return cudaErrorInvalidValue;
}

cudaError_t launch_p(int p, int variant, const float* t, const float* s,
                     int n_tgt, int n_src, int block, int chunk, int stage,
                     int n_split, float* part, float* out, cudaStream_t st) {
  switch (p) {
    case 1: return launch_variant<1, 0, 3, 4, 5>(variant, t, s, n_tgt, n_src, block, chunk, stage, n_split, part, out, st);
    case 2: return launch_variant<2, 0, 3, 4, 5>(variant, t, s, n_tgt, n_src, block, chunk, stage, n_split, part, out, st);
    case 4: return launch_variant<4, 0, 3, 4, 5>(variant, t, s, n_tgt, n_src, block, chunk, stage, n_split, part, out, st);
    case 8: return launch_variant<8, 0, 3, 4, 5>(variant, t, s, n_tgt, n_src, block, chunk, stage, n_split, part, out, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Force of the (3, n_src) sources x; y; gm at `src` on the (3, n_tgt)
// target rows x; y; r at `tgt`, by variant `variant` (above) at p targets
// per thread, into the (2, n_tgt) rows at `out`. block: a multiple of 32 up
// to 512; chunk: a multiple of 8 up to 12288; stage: sources a
// shared-memory stage, the chunk or a multiple of 256 below it
// (sweep_stage_ok); n_split >= 1 source ranges of whole chunks, whose
// (n_split, 2, n_tgt) partials go to `part` (unused when n_split = 1).
// Device pointers to contiguous fp32 arrays. Returns the cudaError_t of the
// launches (0 on success).
extern "C" int nbody_flavor_forces(const void* tgt, const void* src,
                                   int n_tgt, int n_src, int variant, int p,
                                   int block, int chunk, int stage,
                                   int n_split, void* part, void* out,
                                   void* stream) {
  if (n_tgt <= 0) return static_cast<int>(cudaSuccess);
  if (block < 32 || block > kMaxBlock || block % 32 || chunk < 8 ||
      chunk > 12288 || chunk % 8 || !sweep_stage_ok(chunk, stage) ||
      n_split < 1 || n_split > 65535 || n_src < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_p(
      p, variant, static_cast<const float*>(tgt),
      static_cast<const float*>(src), n_tgt, n_src, block, chunk, stage,
      n_split, static_cast<float*>(part), static_cast<float*>(out),
      static_cast<cudaStream_t>(stream)));
}
