// Pieces shared by every direct-force kernel: the block and run sizes, the
// softening floor and the pair factor; the run loop over a staged source
// chunk and the chunked force kernel of the ablation path (ptile_forces.cu,
// stationary_forces.cu, newton_forces.cu, flavor_forces.cu); and the
// fixed-order sum of per-range partials. The main-path kernels
// (direct_forces.cu, ring_forces.cu) run their own pair loop,
// direct_tiles.cuh; K5a, K5b and K5i theirs, pair_step.cuh.
//
// Math, per target i over sources j < n_src:
//   dx = sx_j - x_i;  dy = sy_j - y_i
//   r2 = dx*dx + dy*dy + (r_i + 1e-18)        (add order of _pair_chunk)
//   f  = gm_j / (sqrt(r2) * r2)               (precise: IEEE sqrt, divide)
//   f  = gm_j * inv*inv*inv, inv = rsqrt(r2)  (default)
//   a_i = sum_j (dx, dy) * f, summed per run of sources, then over runs
// The floor keeps a zero-radius target on a gm = 0 padding row at its own
// position finite.
//
// The run loop and the chunked kernel take three policies, whose defaults
// are the kernels above: a pair policy (the factor f, whether ay is summed,
// whether only the first source of each staged range counts), a sum policy
// (where a run closes, how many independent chains a target keeps, and
// whether the chains carry over as lanes to the end), and the number of
// 8-source batches per pass of the pair loop. flavor_forces.cu
// instantiates the others.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;           // threads per block of the main-path kernels
constexpr float kSofteningFloor = 1e-18f;
// Sources summed into fresh registers before joining a target's total, so
// a rounding error grows with kRun plus the number of runs, not with the
// source count (the TPU kernel's 128 column partials did the same).
constexpr int kRun = kBlock;

template <bool kPrecise>
__device__ __forceinline__ float pair_factor(float gm, float r2) {
  if (kPrecise) return gm / (sqrtf(r2) * r2);
  const float inv = rsqrtf(r2);
  return gm * (inv * inv * inv);
}

// The default pair policy: f = pair_factor, both axes, every source.
template <bool kPrecise>
struct DirectPair {
  static constexpr bool kY = true;          // ay is summed
  static constexpr bool kFirstOnly = false;  // only the first source counts
  static __device__ __forceinline__ float factor(float gm, float dx, float dy,
                                                 float soft) {
    return pair_factor<kPrecise>(gm, dx * dx + dy * dy + soft);
  }
};

// A sum policy. kClose: sources per run (each run summed into fresh
// registers before it joins the target's total), or 0 for one run per
// staged range (a chunk). kChains: independent chains per run, source k of
// a run (k from the run's start) on chain k % kChains; kChains divides the
// batch of 8. kLanes: the chains join kChains lane sums, folded in order
// at the end, instead of one total at each close.
template <int kClose_, int kChains_, bool kLanes_>
struct SumPolicy {
  static constexpr int kClose = kClose_;
  static constexpr int kChains = kChains_;
  static constexpr bool kLanes = kLanes_;
  static constexpr int kLaneCount = kLanes_ ? kChains_ : 1;
};
using RunSum = SumPolicy<kRun, 1, false>;  // the default

// One batch of the run loop in accumulate_staged: kBatch sources from
// stage[at] into registers, then their pairs through add(source, chain),
// source at + b on chain b % K. A macro, not a function: as an inlined
// helper (a function template or a lambda) it gave K5g's kernels at P > 1
// and the flavor kernels other SASS on sm_90a, and as a macro every
// kernel's code is the same as with the body written out.
#define ADD_BATCH(at)                                 \
  do {                                                \
    float4 s_[kBatch];                                \
    _Pragma("unroll") for (int b = 0; b < kBatch; ++b) \
      s_[b] = stage[(at) + b];                        \
    _Pragma("unroll") for (int b = 0; b < kBatch; ++b) \
      add(s_[b], b % K);                              \
  } while (0)

// Adds to the L = Sum::kLaneCount sums (ax[q * L + c], ay[q * L + c]) of
// P targets (px, py, soft) the terms of the `len` sources (x, y, gm, .)
// staged at `stage`, run by run as the sum policy says. One shared-memory
// read serves the P targets. Sources are read kBatch at a time into
// registers before their pairs are computed, so the shared-memory reads of
// a batch are in flight together whatever schedule ptxas picks; the sums
// keep the source order. (Left to ptxas, the same loop ran 2-8% slower or
// faster from one kernel to the next on an H100; PERF.md.)
template <int P, bool kPrecise, class Pair = DirectPair<kPrecise>,
          class Sum = RunSum, int kUnroll = 1>
__device__ __forceinline__ void accumulate_staged(
    const float4* stage, int len, const float (&px)[P], const float (&py)[P],
    const float (&soft)[P], float (&ax)[P * Sum::kLaneCount],
    float (&ay)[P * Sum::kLaneCount]) {
  constexpr int kBatch = 8;
  constexpr int K = Sum::kChains;
  constexpr int L = Sum::kLaneCount;
  static_assert(kBatch % K == 0, "chains must divide the batch");
  const int step = Sum::kClose > 0 ? Sum::kClose : len;
  for (int run = 0; run < len; run += step) {
    const int end = min(run + step, len);
    float tx[P][K], ty[P][K];
#pragma unroll
    for (int q = 0; q < P; ++q)
#pragma unroll
      for (int c = 0; c < K; ++c) tx[q][c] = ty[q][c] = 0.f;
    auto add = [&](const float4& s, int c) {
#pragma unroll
      for (int q = 0; q < P; ++q) {
        const float dx = s.x - px[q];
        const float dy = s.y - py[q];
        const float f = Pair::factor(s.z, dx, dy, soft[q]);
        tx[q][c] += dx * f;
        if constexpr (Pair::kY) ty[q][c] += dy * f;
      }
    };
    if constexpr (Pair::kFirstOnly) {
      add(stage[run], 0);
    } else {
      int k = run;
      for (; k + kBatch * kUnroll <= end; k += kBatch * kUnroll) {
        // No pragma on a loop of one pass: nvcc would unroll the batch
        // loop around it instead (32 batches of a run), and the default
        // kernels' code would change.
        if constexpr (kUnroll == 1) {
          ADD_BATCH(k);
        } else {
#pragma unroll
          for (int u = 0; u < kUnroll; ++u)
            ADD_BATCH(k + u * kBatch);
        }
      }
      if constexpr (kUnroll > 1) {
        for (; k + kBatch <= end; k += kBatch)
          ADD_BATCH(k);
      }
      if constexpr (K == 1) {
        for (; k < end; ++k) add(stage[k], 0);
      } else {
        // k - run is a multiple of kBatch: source k + b is on chain b % K
#pragma unroll
        for (int b = 0; b < kBatch - 1; ++b)
          if (k + b < end) add(stage[k + b], b % K);
      }
    }
#pragma unroll
    for (int q = 0; q < P; ++q) {
      if constexpr (Sum::kLanes) {
#pragma unroll
        for (int c = 0; c < L; ++c) {
          ax[q * L + c] += tx[q][c];
          ay[q * L + c] += ty[q][c];
        }
      } else {
        float sx = tx[q][0], sy = ty[q][0];
#pragma unroll
        for (int c = 1; c < K; ++c) {
          sx += tx[q][c];
          sy += ty[q][c];
        }
        ax[q * L] += sx;
        ay[q * L] += sy;
      }
    }
  }
}

#undef ADD_BATCH

// stage[k] = (x, y, gm, 0) of sources [base, base + len) of the (3, n_src)
// rows at `src`, written by all threads of the block.
__device__ __forceinline__ void stage_sources(const float* __restrict__ src,
                                              int n_src, int base, int len,
                                              float4* stage) {
  for (int k = threadIdx.x; k < len; k += blockDim.x) {
    const int j = base + k;
    stage[k] = make_float4(src[j], src[n_src + j], src[2 * n_src + j], 0.f);
  }
}

// Targets as (T, 2) positions and a (T,) radius, results as (T, 2) pairs.
struct PairTargets {
  const float2* pos;
  const float* radius;
  __device__ void load(int i, int, float& x, float& y, float& r) const {
    const float2 p = pos[i];
    x = p.x;
    y = p.y;
    r = radius[i];
  }
  static constexpr int kComp = 1;  // out stride from ax to ay
  static constexpr int kElem = 2;  // out stride from target i to i + 1
};

// Targets as (3, T) rows x; y; r, results as (2, T) rows ax; ay.
struct RowTargets {
  const float* rows;
  __device__ void load(int i, int n, float& x, float& y, float& r) const {
    x = rows[i];
    y = rows[n + i];
    r = rows[2 * n + i];
  }
  static constexpr int kComp = -1;  // n: the second row
  static constexpr int kElem = 1;
};

// The chunked force: block (x, y) holds P * blockDim.x targets, P per
// thread (i, i + blockDim.x, ..., strided so that loads stay coalesced),
// stages the (3, n_src) sources `chunk` at a time through dynamic shared
// memory over the y-th of gridDim.y contiguous ranges of whole chunks, and
// writes the sums to out + y * 2 * n_tgt in the Targets' result layout.
// Lane sums (Sum::kLanes) are folded in lane order before the write.
template <int P, bool kPrecise, class Targets, class Pair = DirectPair<kPrecise>,
          class Sum = RunSum, int kUnroll = 1>
__device__ __forceinline__ void chunk_body(Targets targets,
                                           const float* __restrict__ src,
                                           int n_tgt, int n_src, int chunk,
                                           int chunks_per_split,
                                           float* __restrict__ out) {
  constexpr int L = Sum::kLaneCount;
  extern __shared__ float4 stage[];
  const int first = blockIdx.x * (P * blockDim.x) + threadIdx.x;
  float px[P], py[P], soft[P], ax[P * L], ay[P * L];
#pragma unroll
  for (int q = 0; q < P; ++q) {
    const int i = first + q * blockDim.x;
    // Threads past the last target still stage sources.
    float r = 0.f;
    px[q] = py[q] = 0.f;
    if (i < n_tgt) targets.load(i, n_tgt, px[q], py[q], r);
    soft[q] = i < n_tgt ? r + kSofteningFloor : 1.f;
#pragma unroll
    for (int c = 0; c < L; ++c) ax[q * L + c] = ay[q * L + c] = 0.f;
  }
  const int n_chunks = (n_src + chunk - 1) / chunk;
  const int c_begin = min(static_cast<int>(blockIdx.y) * chunks_per_split,
                          n_chunks);
  const int c_end = min(c_begin + chunks_per_split, n_chunks);
  for (int c = c_begin; c < c_end; ++c) {
    const int base = c * chunk;
    const int len = min(chunk, n_src - base);
    stage_sources(src, n_src, base, len, stage);
    __syncthreads();
    accumulate_staged<P, kPrecise, Pair, Sum, kUnroll>(stage, len, px, py,
                                                       soft, ax, ay);
    __syncthreads();
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
      o[i * Targets::kElem] = sx;
      o[i * Targets::kElem + comp] = sy;
    }
  }
}

// chunk_body with the default policies (K5g); flavor_forces.cu has a
// kernel of its own for the others.
template <int P, bool kPrecise, class Targets>
__global__ void chunk_kernel(Targets targets, const float* __restrict__ src,
                             int n_tgt, int n_src, int chunk,
                             int chunks_per_split, float* __restrict__ out) {
  chunk_body<P, kPrecise, Targets>(targets, src, n_tgt, n_src, chunk,
                                   chunks_per_split, out);
}

// out[c * comp + i * elem] = sum over k < n_part, in order of k, of
// part[k * 2 n + c * comp + i * elem], for c in {0, 1}: an n-target result
// from n_part partials of the same layout ((n, 2) pairs: comp 1, elem 2;
// (2, n) rows: comp n, elem 1), the same bits on every run (no atomics).
__global__ void __launch_bounds__(kBlock)
sum_partials_kernel(const float* __restrict__ part, int n, int n_part,
                    int comp, int elem, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const size_t at = static_cast<size_t>(i) * elem;
  float ax = 0.f, ay = 0.f;
  for (int k = 0; k < n_part; ++k) {
    const float* p = part + static_cast<size_t>(k) * 2 * n + at;
    ax += p[0];
    ay += p[comp];
  }
  out[at] = ax;
  out[at + comp] = ay;
}

inline cudaError_t launch_sum_partials(const float* part, int n, int n_part,
                                       int comp, int elem, float* out,
                                       cudaStream_t stream) {
  sum_partials_kernel<<<(n + kBlock - 1) / kBlock, kBlock, 0, stream>>>(
      part, n, n_part, comp, elem, out);
  return cudaGetLastError();
}

// Opt a kernel in to more than 48 KB of dynamic shared memory.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// Launches `kernel` (chunk_kernel or another kernel on chunk_body, P
// targets per thread) over n_split ranges of whole chunks: straight into
// out when n_split = 1, else into the (n_split, ...) partials at `part`,
// summed in split order into out.
template <int P, class Targets, class Kernel>
cudaError_t launch_chunks(Kernel kernel, Targets targets, const float* src,
                          int n_tgt, int n_src, int block, int chunk,
                          int n_split, float* part, float* out,
                          cudaStream_t st) {
  const size_t smem = static_cast<size_t>(chunk) * sizeof(float4);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int n_chunks = (n_src + chunk - 1) / chunk;
  const int per = (n_chunks + n_split - 1) / n_split;
  const dim3 grid((n_tgt + P * block - 1) / (P * block), n_split);
  kernel<<<grid, block, smem, st>>>(targets, src, n_tgt, n_src, chunk, per,
                                    n_split > 1 ? part : out);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return err;
  const int comp = Targets::kComp < 0 ? n_tgt : Targets::kComp;
  return launch_sum_partials(part, n_tgt, n_split, comp, Targets::kElem, out,
                             st);
}

// launch_chunks of chunk_kernel with the default policies.
template <int P, bool kPrecise, class Targets>
cudaError_t launch_chunked(Targets targets, const float* src, int n_tgt,
                           int n_src, int block, int chunk, int n_split,
                           float* part, float* out, cudaStream_t st) {
  return launch_chunks<P>(chunk_kernel<P, kPrecise, Targets>, targets, src,
                          n_tgt, n_src, block, chunk, n_split, part, out, st);
}

}  // namespace
