// K5a and K5b for NVIDIA Hopper (sm_90a): the resident-source force of
// tune_r2.py's v2_acc and of make_v2, its two target layouts and its
// sweep's flavors, in a kernel of their own.
//
// Replaces the TPU kernels
//   scripts/ablations/tune_r2.py::_v2_kernel (K5a: make_v2's kernel_cols
//     with a `precise` switch, gm / (sqrt(r2) * r2)): variants 4 and 5
//   scripts/ablations/tune_r2b.py::make_v2 -> kernel_cols (targets as (T, 1)
//     columns of x, y and r, result (T, 2))
//   scripts/ablations/tune_r2b.py::make_v2 -> kernel_rows (targets as a
//     (3, tile_t) row block, result two (1, T) rows)
// Both sweep the resident (3, S) sources x; y; gm in chunks, each chunk's
// terms summed (jnp.sum) before they join the target's total. Here the
// column layout takes (T, 2) positions and a (T,) radius and writes (T, 2)
// pairs; the row layout takes (3, T) rows and writes (2, T) rows. Per target
// i over sources j < n_src, as source_tiles.cuh states it:
//   dx = sx_j - x_i;  dy = sy_j - y_i;  r2 = dx*dx + dy*dy + (r_i + 1e-18)
//   f = gm_j * inv*inv*inv, inv = rsqrt(r2)   (pair_step.cuh)
// Variants (the Python wrapper ops/v2_forces.py names them):
//   0 base, rows: each chunk's terms in one chain, added to the total in
//     chunk order
//   1 unroll2: 0 with two 8-source batches a pass of the pair loop
//   2 static: 0 with four batches a pass (the script unrolled its chunk loop
//     at trace time; a runtime chunk count cannot be, so the pair loop is
//     unrolled further instead)
//   3 partial: kChains chains a chunk (source k of a chunk on chain
//     k % kChains) added to kChains lane sums, folded in lane order at the
//     end (the script's (tile, 128) lane-partial carry)
//   4, 5 K5a, rsqrt and precise (f = gm_j / (sqrtf(r2) * r2), IEEE sqrt
//     and divide), column layout only: runs of kRun = 256 sources summed
//     into fresh registers, each added to the total in order (add_runs),
//     static's four batches a pass
// The script's tile_t is P * block: P = 2 targets a thread from tile 256
// on, 1 below.
//
// What bounds it on an H100: the issue rate of the SM's instruction pipes.
// A pair is ten fp32 instructions and one MUFU.RSQ; the MUFU term of the
// bound (16 a clock per SM) stays out of reach while more than eight other
// instructions issue per pair. So the design cuts the instructions a pair
// costs, as K1's pair loop (direct_tiles.cuh) does, without sharing its code:
//   * the rsqrt is PTX rsqrt.approx.ftz.f32, MUFU.RSQ alone. rsqrtf without
//     fast math adds a denormal guard (FSETP and two predicated FMUL); r2 is
//     a normal float >= 1e-18, the guard never fires, and the bits are the
//     same. The build takes no --use_fast_math;
//   * a thread holds P = 2 targets, strided by the block so that loads stay
//     coalesced; one shared-memory read of a source serves both;
//   * the sources are staged `chunk` at a time through dynamic shared memory,
//     double-buffered: the next chunk's cp.async copies are issued before
//     the current chunk's pairs run, one barrier a chunk. A stage holds the
//     three rows batch by batch: batch b is x, y and gm of sources 8b to
//     8b + 7, 24 floats, so that the pair loop reads a batch into registers
//     as six 16-byte reads off one address, which moves 96 bytes a batch
//     (staged as three whole rows, the loop kept three addresses and
//     recomputed them each pass: 193 SASS instructions for 16 pairs at
//     P = 2 against 187, PERF.md §6). The copies are 16 bytes where the rows
//     and the chunk bases
//     are 16-byte aligned (src 16-byte aligned, n_src a multiple of 4:
//     S128), else 4 bytes; the launch chooses from the pointer and n_src.
// P changes no bits: each target keeps its own chains in source order.
// When the target blocks cannot fill the card, the source sum is split into
// n_split ranges of whole chunks (ops/ptile_forces.split_plan), whose
// partials a second kernel adds in range order (no atomics).
//
// The C entry point launches on the stream it is handed, does not
// synchronise, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "pair_step.cuh"     // kBatch, Pairs, stage_at
#include "source_tiles.cuh"  // kSofteningFloor, RowTargets, PairTargets,
                             // allow_smem, launch_sum_partials

namespace {

constexpr int kMaxBlock = 512;
constexpr int kChains = 8;      // chains (lane sums) of the partial variant
constexpr int kRunUnroll = 4;   // batches a pass of K5a's run loop (static's)
constexpr int kMaxSmem = 232448;  // dynamic shared memory a block can have

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

// Issues the copies of sources [base, base + len) of the (3, n_src) rows at
// src into the stage st, one group for the block. vec16: 16-byte copies of
// whole groups of four (a row's last group may reach past len, never past
// n_src).
__device__ __forceinline__ void stage_rows(const float* __restrict__ src,
                                           int n_src, int base, int len,
                                           float* st, bool vec16) {
  if (vec16) {
    const int n4 = (len + 3) / 4;
    for (int r = 0; r < 3; ++r) {
      const float* row = src + static_cast<size_t>(r) * n_src + base;
      for (int v = threadIdx.x; v < n4; v += blockDim.x)
        cp_async<16>(st + stage_at(4 * v, r), row + 4 * v);
    }
  } else {
    for (int r = 0; r < 3; ++r) {
      const float* row = src + static_cast<size_t>(r) * n_src + base;
      for (int k = threadIdx.x; k < len; k += blockDim.x)
        cp_async<4>(st + stage_at(k, r), row + k);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Adds the `len` sources staged at st to the L sums (ax[q * L + c],
// ay[q * L + c]) of the thread's P targets: the chunk's terms on K chains,
// kUnroll batches a pass, then each chain joins lane c (kLanes) or the
// chains join the one total in chain order.
template <int P, int kUnroll, bool kLanes, bool kPrecise>
__device__ __forceinline__ void add_chunk(const float* st, int len,
                                          Pairs<P, kLanes ? kChains : 1,
                                                kPrecise>& t,
                                          float* ax, float* ay) {
  constexpr int K = kLanes ? kChains : 1;
  constexpr int L = kLanes ? kChains : 1;
  constexpr int kPass = kBatch * kUnroll;
  constexpr int kStride = 3 * kBatch;  // floats of a staged batch
#pragma unroll
  for (int q = 0; q < P; ++q)
#pragma unroll
    for (int c = 0; c < K; ++c) t.tx[q][c] = t.ty[q][c] = 0.f;
  int k = 0;
  const float* batch = st;
#pragma unroll 1
  for (; k + kPass <= len; k += kPass, batch += kUnroll * kStride) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) t.add_batch(batch + u * kStride);
  }
  if constexpr (kUnroll > 1) {
#pragma unroll 1
    for (; k + kBatch <= len; k += kBatch, batch += kStride)
      t.add_batch(batch);
  }
  // the ragged end: k is a multiple of kBatch, source k + b on chain b % K
#pragma unroll
  for (int b = 0; b < kBatch - 1; ++b)
    if (k + b < len)
      t.add(batch[b], batch[kBatch + b], batch[2 * kBatch + b], b % K);
#pragma unroll
  for (int q = 0; q < P; ++q) {
#pragma unroll
    for (int c = 0; c < K; ++c) {
      ax[q * L + (kLanes ? c : 0)] += t.tx[q][c];
      ay[q * L + (kLanes ? c : 0)] += t.ty[q][c];
    }
  }
}

// K5a's sums: adds the `len` sources staged at st to the totals (ax[q],
// ay[q]) of the thread's P targets run by run, kRun sources a run (the last
// run of a chunk may be shorter) summed into fresh registers, kRunUnroll
// batches a pass, each run then added to the total: the association of
// source_tiles.cuh's RunSum, which K5a had before it ran here. (One chain a
// chunk, variant 0, drifts with the chunk: 5.5e-6 of the force's max
// against the direct sum at chunk 4096, PERF.md §6.)
template <int P, bool kPrecise>
__device__ __forceinline__ void add_runs(const float* st, int len,
                                         Pairs<P, 1, kPrecise>& t, float* ax,
                                         float* ay) {
  constexpr int kPass = kBatch * kRunUnroll;
  constexpr int kStride = 3 * kBatch;  // floats of a staged batch
  for (int run = 0; run < len; run += kRun) {
    const int end = min(run + kRun, len);
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

// Block (x, y) holds P * blockDim.x targets, P a thread (i, i + blockDim.x,
// ...), and sums the sources of the y-th of gridDim.y ranges of
// chunks_per_split whole chunks into out + y * 2 n_tgt, in the Targets'
// result layout. Dynamic shared memory: two stages of chunk sources (3 chunk
// floats each). The body of v2_kernel (add_chunk's sums) and of
// v2_resident_kernel (kRuns: add_runs').
template <int P, class Targets, int kUnroll, bool kLanes, bool kPrecise,
          bool kRuns>
__device__ __forceinline__ void v2_body(Targets targets,
                                        const float* __restrict__ src,
                                        int n_tgt, int n_src, int chunk,
                                        int chunks_per_split, int vec16,
                                        float* __restrict__ out) {
  constexpr int L = kLanes ? kChains : 1;
  extern __shared__ float4 v2_smem[];
  float* const stage = reinterpret_cast<float*>(v2_smem);
  const int first = blockIdx.x * (P * blockDim.x) + threadIdx.x;
  Pairs<P, kLanes ? kChains : 1, kPrecise> t;
  float ax[P * L], ay[P * L];
#pragma unroll
  for (int q = 0; q < P; ++q) {
    const int i = first + q * blockDim.x;
    // Threads past the last target take a finite stand-in and still stage.
    float r = 0.f;
    t.x[q] = t.y[q] = 0.f;
    if (i < n_tgt) targets.load(i, n_tgt, t.x[q], t.y[q], r);
    t.soft[q] = i < n_tgt ? r + kSofteningFloor : 1.f;
#pragma unroll
    for (int c = 0; c < L; ++c) ax[q * L + c] = ay[q * L + c] = 0.f;
  }
  const int n_chunks = (n_src + chunk - 1) / chunk;
  const int c_begin = min(static_cast<int>(blockIdx.y) * chunks_per_split,
                          n_chunks);
  const int c_end = min(c_begin + chunks_per_split, n_chunks);
  if (c_begin < c_end)
    stage_rows(src, n_src, c_begin * chunk,
               min(chunk, n_src - c_begin * chunk), stage, vec16);
  int at = 0;  // offset of the stage that holds chunk c
  for (int c = c_begin; c < c_end; ++c) {
    cp_async_wait_all();
    // chunk c is in; every thread is done with the other stage
    __syncthreads();
    const int next = (c + 1) * chunk;
    const int other = 3 * chunk - at;
    if (c + 1 < c_end)
      stage_rows(src, n_src, next, min(chunk, n_src - next), stage + other,
                 vec16);
    if constexpr (kRuns)
      add_runs<P, kPrecise>(stage + at, min(chunk, n_src - c * chunk), t, ax,
                            ay);
    else
      add_chunk<P, kUnroll, kLanes, kPrecise>(
          stage + at, min(chunk, n_src - c * chunk), t, ax, ay);
    at = other;
  }
  const int comp = Targets::kComp < 0 ? n_tgt : Targets::kComp;
  float* o = out + static_cast<size_t>(blockIdx.y) * 2 * n_tgt;
#pragma unroll
  for (int q = 0; q < P; ++q) {
    const int i = first + q * blockDim.x;
    float sx = ax[q * L], sy = ay[q * L];
#pragma unroll
    for (int c = 1; c < L; ++c) {
      sx += ax[q * L + c];
      sy += ay[q * L + c];
    }
    if (i < n_tgt) {
      o[static_cast<size_t>(i) * Targets::kElem] = sx;
      o[static_cast<size_t>(i) * Targets::kElem + comp] = sy;
    }
  }
}

// Variants 0-3: K5b's flavors.
template <int P, class Targets, int kUnroll, bool kLanes>
__global__ void __launch_bounds__(kMaxBlock)
v2_kernel(Targets targets, const float* __restrict__ src, int n_tgt,
          int n_src, int chunk, int chunks_per_split, int vec16,
          float* __restrict__ out) {
  v2_body<P, Targets, kUnroll, kLanes, false, false>(
      targets, src, n_tgt, n_src, chunk, chunks_per_split, vec16, out);
}

// Variants 4 and 5: K5a, rsqrt and precise, column layout.
template <int P, bool kPrecise>
__global__ void __launch_bounds__(kMaxBlock)
v2_resident_kernel(PairTargets targets, const float* __restrict__ src,
                   int n_tgt, int n_src, int chunk, int chunks_per_split,
                   int vec16, float* __restrict__ out) {
  v2_body<P, PairTargets, 1, false, kPrecise, true>(
      targets, src, n_tgt, n_src, chunk, chunks_per_split, vec16, out);
}

// What every launch of one call shares.
struct Launch {
  const float* src;
  int n_tgt, n_src, block, chunk, n_split, vec16;
  float* part;  // (n_split, 2 n_tgt) partials when n_split > 1
  float* out;
  cudaStream_t stream;
};

// The kernel over n_split ranges of whole chunks: straight into out when
// n_split = 1, else into the partials, summed in range order into out.
template <int P, class Targets, class Kernel>
cudaError_t launch(Kernel kernel, Targets targets, const Launch& a) {
  const size_t smem = static_cast<size_t>(6) * a.chunk * sizeof(float);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int n_chunks = (a.n_src + a.chunk - 1) / a.chunk;
  const int per = (n_chunks + a.n_split - 1) / a.n_split;
  const dim3 grid((a.n_tgt + P * a.block - 1) / (P * a.block), a.n_split);
  kernel<<<grid, a.block, smem, a.stream>>>(targets, a.src, a.n_tgt, a.n_src,
                                            a.chunk, per, a.vec16,
                                            a.n_split > 1 ? a.part : a.out);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.n_split == 1) return err;
  const int comp = Targets::kComp < 0 ? a.n_tgt : Targets::kComp;
  return launch_sum_partials(a.part, a.n_tgt, a.n_split, comp,
                             Targets::kElem, a.out, a.stream);
}

template <int P, class Targets>
cudaError_t launch_variant(int variant, Targets targets, const Launch& a) {
  switch (variant) {
    case 0: return launch<P>(v2_kernel<P, Targets, 1, false>, targets, a);
    case 1: return launch<P>(v2_kernel<P, Targets, 2, false>, targets, a);
    case 2: return launch<P>(v2_kernel<P, Targets, 4, false>, targets, a);
    case 3: return launch<P>(v2_kernel<P, Targets, 1, true>, targets, a);
    case 4:
    case 5:
      if constexpr (std::is_same_v<Targets, PairTargets>)
        return variant == 4
                   ? launch<P>(v2_resident_kernel<P, false>, targets, a)
                   : launch<P>(v2_resident_kernel<P, true>, targets, a);
      else
        return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

template <class Targets>
cudaError_t launch_p(int p, int variant, Targets targets, const Launch& a) {
  switch (p) {
    case 1: return launch_variant<1>(variant, targets, a);
    case 2: return launch_variant<2>(variant, targets, a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Force of the (3, n_src) sources x; y; gm at `src` on n_tgt targets, by
// variant `variant` (above; 4 and 5 with rows = 0 only) at p (1 or 2) targets per
// thread. rows = 1:
// tgt_a is the (3, n_tgt) rows x; y; r, tgt_b unused, out (2, n_tgt);
// rows = 0: tgt_a the (n_tgt, 2) positions, tgt_b the (n_tgt,) radius, out
// (n_tgt, 2). block: a multiple of 32 up to 512; chunk: a multiple of 8
// whose two stages (24 bytes a source) fit a block's shared memory;
// n_split >= 1 source ranges of whole chunks, whose (n_split, ...) partials
// go to `part` (unused when n_split = 1). Device pointers to contiguous
// fp32 arrays. Returns the cudaError_t of the launches (0 on success).
extern "C" int nbody_v2_forces(const void* tgt_a, const void* tgt_b,
                               const void* src, int n_tgt, int n_src,
                               int rows, int variant, int p, int block,
                               int chunk, int n_split, void* part, void* out,
                               void* stream) {
  if (n_tgt <= 0) return static_cast<int>(cudaSuccess);
  if (block < 32 || block > kMaxBlock || block % 32 || chunk < 8 ||
      chunk % 8 || 24LL * chunk > kMaxSmem || n_split < 1 ||
      n_split > 65535 || n_src < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* s = static_cast<const float*>(src);
  const bool vec16 = reinterpret_cast<uintptr_t>(s) % 16 == 0 && n_src % 4 == 0;
  const Launch a{s, n_tgt, n_src, block, chunk, n_split, vec16 ? 1 : 0,
                 static_cast<float*>(part), static_cast<float*>(out),
                 static_cast<cudaStream_t>(stream)};
  cudaError_t err;
  if (rows) {
    err = launch_p(p, variant, RowTargets{static_cast<const float*>(tgt_a)}, a);
  } else {
    err = launch_p(p, variant,
                   PairTargets{static_cast<const float2*>(tgt_a),
                               static_cast<const float*>(tgt_b)},
                   a);
  }
  return static_cast<int>(err);
}
