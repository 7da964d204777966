// Force-only flavors of the chunked resident-source kernel, for NVIDIA
// Hopper (sm_90a): the build-time variants that three TPU scripts compare.
//
// Replaces the TPU kernels
//   scripts/ablations/tune_r2b.py::make_v2 -> kernel_cols, kernel_rows (K5b)
//   scripts/ablations/tune_r2e.py::make_v3 -> kernel (K5e)
//   scripts/ablations/tune_r2c.py::make_probe -> kernel (K5c)
// Each was K5a's kernel (a grid over target tiles, the (3, S) source row
// resident in VMEM, a fori_loop over source chunks and a static tail) with
// one thing changed: the target layout, the loop's unroll, the reduction
// (a per-chunk sum, a (tile, 128) lane-partial carry, an FMA k-loop), the
// association of f, or (K5c, a timing probe with wrong physics) one piece
// of the pair math left out. Here each is source_tiles.cuh's chunk_body
// with a pair policy, a sum policy and an unroll, P targets per thread,
// block threads per block: the script's tile_t is P * block.
//
// Variants (the Python wrapper ops/flavor_forces.py names them):
//   0 base: per-chunk run (the script's per-chunk jnp.sum), one chain
//   1 unroll2: base, two 8-source batches per pass of the pair loop
//   2 static: base, four batches per pass (the script unrolled its chunk
//     loop at trace time; a runtime chunk count cannot be, so the pair
//     loop is unrolled further instead)
//   3 partial: K chains per chunk folded into K lane sums carried to the
//     end (the (tile, 128) carry; no thread can hold 128 lanes)
//   4 fma_kloop: K chains fed straight by the pair's FFMAs, folded into
//     the total every kRun sources (one level; a chain of S/K terms over
//     the whole sweep rounds past 5e-6 at K <= 4)
//   5 f_assoc: base with f = (gm * inv) * (inv * inv)
//   6 unroll16: base, sixteen batches per pass
//   7 skeleton: ax += dx only, ay stays 0
//   8 no_rsqrt: f = r2          9 no_cube: f = inv     10 no_gm: f = inv^3
//   11 one_axis: base without ay
//   12 no_reduce: only the first source of each staged chunk counts
// K = 8 chains at P <= 2, 4 at P = 4, 2 at P = 8 (the registers of 512
// threads). Variants 0-5 take (3, T) rows at P = 1, 2, 4, 8; 0-3 also
// (T, 2) positions and a (T,) radius (the script's kernel_cols); 6-12 take
// rows at P = 1 (the script's TILE_T 512). Source splits as K5g's.
//
// What bounds it on an H100: per pair about ten fp32 instructions, one
// MUFU rsqrt and a shared-memory read served to P targets, as K5a; the
// probes drop one of those. __launch_bounds__(512): at most 128 registers
// a thread, so that 512-thread blocks launch at P = 8.
//
// The C entry point launches on the stream it is handed, does not
// synchronise, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>

#include "source_tiles.cuh"  // chunk_body, launch_chunks, DirectPair, SumPolicy

namespace {

constexpr int kMaxBlock = 512;

// f = (gm * inv) * (inv * inv)
struct AssocPair {
  static constexpr bool kY = true, kFirstOnly = false;
  static __device__ __forceinline__ float factor(float gm, float dx, float dy,
                                                 float soft) {
    const float inv = rsqrtf(dx * dx + dy * dy + soft);
    return (gm * inv) * (inv * inv);
  }
};

// The loop and the broadcasts only: ax += dx.
struct SkeletonPair {
  static constexpr bool kY = false, kFirstOnly = false;
  static __device__ __forceinline__ float factor(float, float, float, float) {
    return 1.f;
  }
};

struct NoRsqrtPair {
  static constexpr bool kY = true, kFirstOnly = false;
  static __device__ __forceinline__ float factor(float, float dx, float dy,
                                                 float soft) {
    return dx * dx + dy * dy + soft;
  }
};

struct NoCubePair {
  static constexpr bool kY = true, kFirstOnly = false;
  static __device__ __forceinline__ float factor(float, float dx, float dy,
                                                 float soft) {
    return rsqrtf(dx * dx + dy * dy + soft);
  }
};

struct NoGmPair {
  static constexpr bool kY = true, kFirstOnly = false;
  static __device__ __forceinline__ float factor(float, float dx, float dy,
                                                 float soft) {
    const float inv = rsqrtf(dx * dx + dy * dy + soft);
    return inv * inv * inv;
  }
};

struct OneAxisPair : DirectPair<false> {
  static constexpr bool kY = false;
};

struct FirstOnlyPair : DirectPair<false> {
  static constexpr bool kFirstOnly = true;
};

using ChunkSum = SumPolicy<0, 1, false>;

template <int P>
constexpr int chains() { return P <= 2 ? 8 : 16 / P; }

// Variant V's policies at P targets per thread.
template <int V, int P> struct Variant;
template <int P> struct Variant<0, P> { using Pair = DirectPair<false>; using Sum = ChunkSum; static constexpr int kUnroll = 1; };
template <int P> struct Variant<1, P> : Variant<0, P> { static constexpr int kUnroll = 2; };
template <int P> struct Variant<2, P> : Variant<0, P> { static constexpr int kUnroll = 4; };
template <int P> struct Variant<3, P> : Variant<0, P> { using Sum = SumPolicy<0, chains<P>(), true>; };
template <int P> struct Variant<4, P> : Variant<0, P> { using Sum = SumPolicy<kRun, chains<P>(), false>; };
template <int P> struct Variant<5, P> : Variant<0, P> { using Pair = AssocPair; };
template <int P> struct Variant<6, P> : Variant<0, P> { static constexpr int kUnroll = 16; };
template <int P> struct Variant<7, P> : Variant<0, P> { using Pair = SkeletonPair; };
template <int P> struct Variant<8, P> : Variant<0, P> { using Pair = NoRsqrtPair; };
template <int P> struct Variant<9, P> : Variant<0, P> { using Pair = NoCubePair; };
template <int P> struct Variant<10, P> : Variant<0, P> { using Pair = NoGmPair; };
template <int P> struct Variant<11, P> : Variant<0, P> { using Pair = OneAxisPair; };
template <int P> struct Variant<12, P> : Variant<0, P> { using Pair = FirstOnlyPair; };

constexpr int kVariants = 13;
constexpr int kRowVariants = 6;   // 0-5 at every P
constexpr int kColVariants = 4;   // 0-3 on (T, 2) targets

template <int P, class Targets, int V>
__global__ void __launch_bounds__(kMaxBlock)
flavor_kernel(Targets targets, const float* __restrict__ src, int n_tgt,
              int n_src, int chunk, int chunks_per_split,
              float* __restrict__ out) {
  using F = Variant<V, P>;
  chunk_body<P, false, Targets, typename F::Pair, typename F::Sum, F::kUnroll>(
      targets, src, n_tgt, n_src, chunk, chunks_per_split, out);
}

// Variant `variant` of the first N, by a chain of compile-time tests (only
// those N are instantiated).
template <int P, class Targets, int N, int V = 0>
cudaError_t launch_variant(int variant, Targets t, const float* s, int n_tgt,
                           int n_src, int block, int chunk, int n_split,
                           float* part, float* out, cudaStream_t st) {
  if constexpr (V >= N) {
    return cudaErrorInvalidValue;
  } else {
    if (variant == V)
      return launch_chunks<P>(flavor_kernel<P, Targets, V>, t, s, n_tgt,
                              n_src, block, chunk, n_split, part, out, st);
    return launch_variant<P, Targets, N, V + 1>(variant, t, s, n_tgt, n_src,
                                                block, chunk, n_split, part,
                                                out, st);
  }
}

// P = 1 takes the first N1 variants, wider P the first N.
template <class Targets, int N1, int N>
cudaError_t launch_p(int p, int variant, Targets t, const float* s,
                     int n_tgt, int n_src, int block, int chunk, int n_split,
                     float* part, float* out, cudaStream_t st) {
  switch (p) {
    case 1: return launch_variant<1, Targets, N1>(variant, t, s, n_tgt, n_src, block, chunk, n_split, part, out, st);
    case 2: return launch_variant<2, Targets, N>(variant, t, s, n_tgt, n_src, block, chunk, n_split, part, out, st);
    case 4: return launch_variant<4, Targets, N>(variant, t, s, n_tgt, n_src, block, chunk, n_split, part, out, st);
    case 8: return launch_variant<8, Targets, N>(variant, t, s, n_tgt, n_src, block, chunk, n_split, part, out, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Force of the (3, n_src) sources x; y; gm at `src` on n_tgt targets, by
// variant `variant` (above) at p targets per thread. rows = 1: tgt_a is
// the (3, n_tgt) rows x; y; r, tgt_b unused, out (2, n_tgt); rows = 0:
// tgt_a the (n_tgt, 2) positions, tgt_b the (n_tgt,) radius, out
// (n_tgt, 2). block: a multiple of 32 up to 512; chunk: a multiple of 8
// up to 12288; n_split >= 1 source ranges of whole chunks, whose
// (n_split, ...) partials go to `part` (unused when n_split = 1). Device
// pointers to contiguous fp32 arrays. Returns the cudaError_t of the
// launches (0 on success).
extern "C" int nbody_flavor_forces(const void* tgt_a, const void* tgt_b,
                                   const void* src, int n_tgt, int n_src,
                                   int rows, int variant, int p, int block,
                                   int chunk, int n_split, void* part,
                                   void* out, void* stream) {
  if (n_tgt <= 0) return static_cast<int>(cudaSuccess);
  if (block < 32 || block > kMaxBlock || block % 32 || chunk < 8 ||
      chunk > 12288 || chunk % 8 || n_split < 1 || n_split > 65535 ||
      variant < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* s = static_cast<const float*>(src);
  auto* pt = static_cast<float*>(part);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (rows) {
    const RowTargets t{static_cast<const float*>(tgt_a)};
    err = launch_p<RowTargets, kVariants, kRowVariants>(
        p, variant, t, s, n_tgt, n_src, block, chunk, n_split, pt, o, st);
  } else {
    const PairTargets t{static_cast<const float2*>(tgt_a),
                        static_cast<const float*>(tgt_b)};
    err = launch_p<PairTargets, kColVariants, kColVariants>(
        p, variant, t, s, n_tgt, n_src, block, chunk, n_split, pt, o, st);
  }
  return static_cast<int>(err);
}
