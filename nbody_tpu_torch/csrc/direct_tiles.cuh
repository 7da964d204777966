// The direct-sum pair loop of the main-path kernels, direct_forces.cu (K1/K2)
// and ring_forces.cu (K3), designed for NVIDIA Hopper (sm_90a).
//
// Math, per target i over sources j < n_src, as source_tiles.cuh states it:
//   dx = sx_j - x_i;  dy = sy_j - y_i;  r2 = dx*dx + dy*dy + (r_i + 1e-18)
//   f = gm_j / (sqrt(r2) * r2)                (precise: IEEE sqrt, divide)
//   f = gm_j * inv*inv*inv, inv = rsqrt(r2)   (default)
//   a_i = sum_j (dx, dy) * f, summed per run of kRun sources into fresh
//   registers, then run by run into the total, in source order.
// The n_split blocks of a target block each sum a contiguous range of whole
// runs; their partials are added in range order.
//
// What bounds it on an H100: the issue rate of the SM's instruction pipes.
// A pair is about ten fp32 instructions and one MUFU.RSQ; the MUFU term of
// the bound (16 a clock per SM) stays out of reach while more than eight
// other instructions issue per pair. So the design cuts the instructions a
// pair costs:
//   * the rsqrt is PTX rsqrt.approx.ftz.f32, MUFU.RSQ alone. rsqrtf without
//     fast math adds a denormal guard (FSETP and two predicated FMUL); r2 is
//     a normal float >= 1e-18, the guard never fires, and the bits are the
//     same;
//   * a thread holds P = 2 targets (1 when they fit one block), strided by
//     the block so that loads stay coalesced; one source read from shared
//     memory serves both (P = 4 issued 2% fewer instructions and ran 1-2%
//     slower on an H100, so it is not built);
//   * a batch of 8 sources is read into registers as four 16-byte position
//     reads and two 16-byte gm reads, four batches a pass of the loop;
//   * sources are staged kChunk = 2048 at a time (a multiple of kRun; 1024
//     and 4096 ran within 0.6%) through dynamic shared memory as two rows,
//     positions and gm, double-buffered:
//     the next chunk's cp.async copies are issued before the current
//     chunk's pairs run, one barrier a chunk.
// P changes no bits: each target keeps its own run sums in source order.
//
// Few target blocks cannot fill the card, so the plan
// (ops/direct_forces.cluster_plan) splits the source sum over n_split
// blocks per target block:
//   * n_split <= 8 (the portable cluster size): the n_split blocks are one
//     thread-block cluster. Each writes its partials to its own shared
//     memory; after a cluster barrier the rank-0 block reads the others'
//     through distributed shared memory, adds them in rank order and runs
//     the epilogue. One launch, no scratch, no atomics, the same bits on
//     every run;
//   * more ranges (force_acc's few-targets case): each block writes its
//     partials to a scratch that a second kernel sums in range order.
// launch_tiles starts a cluster launch with cudaLaunchKernelEx and returns
// its error: there is no launch without a cluster to fall back on.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <utility>

#include "source_tiles.cuh"  // kBlock, kRun, kSofteningFloor, allow_smem

namespace {

constexpr int kPairBatch = 8;        // sources read into registers together
constexpr int kBatchesPerPass = 4;   // batches a pass of the pair loop
constexpr int kMaxCluster = 8;       // the portable cluster size
constexpr int kChunk = 2048;         // sources staged per chunk
static_assert(kChunk % kRun == 0, "a chunk holds whole runs");

// How the n_split blocks of one target block combine their partial sums.
enum TileReduce : int {
  kReduceNone = 0,     // n_split = 1: the block holds the totals
  kReduceCluster = 1,  // through distributed shared memory, rank 0 holds them
  kReduceScratch = 2,  // each block writes its partials to a scratch
};

// What every block of a launch needs to know of its plan.
struct TilePlan {
  int n_split;         // blocks per target block
  int runs_per_split;  // whole runs of kRun sources per block (the last may
                       // have fewer)
  int chunk;           // kChunk, set by launch_tiles. Read from here, not
                       // from the constant: with the constant ptxas made the
                       // P = 2 pair loop 739 SASS instructions for 64 pairs
                       // instead of 736, and K1 ran slower (PERF.md §6).
  int reduce;          // TileReduce
};

__device__ __forceinline__ float rsqrt_ftz(float x) {
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <bool kPrecise>
__device__ __forceinline__ float tile_factor(float gm, float r2) {
  if (kPrecise) return gm / (sqrtf(r2) * r2);
  const float inv = rsqrt_ftz(r2);
  return gm * (inv * inv * inv);
}

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

// Issues the copies of sources [base, base + len) into the stage rows
// (spos, sgm), one group for the block.
__device__ __forceinline__ void stage_chunk(const float2* __restrict__ src_pos,
                                            const float* __restrict__ src_gm,
                                            int base, int len, float2* spos,
                                            float* sgm) {
  for (int k = threadIdx.x; k < len; k += kBlock) {
    cp_async<8>(spos + k, src_pos + base + k);
    cp_async<4>(sgm + k, src_gm + base + k);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// The P targets of one thread: target q is first + q * kBlock.
template <int P>
struct TileTargets {
  int first;
  bool warp_live;  // the warp's first target is real; else it skips the pairs
  float x[P], y[P], soft[P];
};

// Threads past the last target get a finite stand-in (0, 0, soft 1) and
// still help stage sources.
template <int P>
__device__ __forceinline__ TileTargets<P> load_targets(
    const float2* __restrict__ tgt_pos, const float* __restrict__ tgt_radius,
    int n_tgt, int tblock) {
  TileTargets<P> t;
  const int base = tblock * (P * kBlock);
  t.first = base + threadIdx.x;
  t.warp_live = base + static_cast<int>(threadIdx.x & ~31u) < n_tgt;
#pragma unroll
  for (int q = 0; q < P; ++q) {
    const int i = t.first + q * kBlock;
    const bool live = i < n_tgt;
    const float2 p = live ? tgt_pos[i] : make_float2(0.f, 0.f);
    t.x[q] = p.x;
    t.y[q] = p.y;
    t.soft[q] = live ? tgt_radius[i] + kSofteningFloor : 1.f;
  }
  return t;
}

// One source against the P targets, into their run sums.
template <int P, bool kPrecise>
__device__ __forceinline__ void add_source(float sx, float sy, float gm,
                                           const TileTargets<P>& t,
                                           float (&tx)[P], float (&ty)[P]) {
#pragma unroll
  for (int q = 0; q < P; ++q) {
    const float dx = sx - t.x[q];
    const float dy = sy - t.y[q];
    const float f = tile_factor<kPrecise>(gm, dx * dx + dy * dy + t.soft[q]);
    tx[q] += dx * f;
    ty[q] += dy * f;
  }
}

// Sources at, ..., at + 7 of the stage (at a multiple of 8), read into
// registers first, then their pairs in source order.
template <int P, bool kPrecise>
__device__ __forceinline__ void add_batch(const float2* spos, const float* sgm,
                                          int at, const TileTargets<P>& t,
                                          float (&tx)[P], float (&ty)[P]) {
  const float4* p4 = reinterpret_cast<const float4*>(spos + at);
  const float4* g4 = reinterpret_cast<const float4*>(sgm + at);
  const float4 a = p4[0], b = p4[1], c = p4[2], d = p4[3];
  const float4 g = g4[0], h = g4[1];
  add_source<P, kPrecise>(a.x, a.y, g.x, t, tx, ty);
  add_source<P, kPrecise>(a.z, a.w, g.y, t, tx, ty);
  add_source<P, kPrecise>(b.x, b.y, g.z, t, tx, ty);
  add_source<P, kPrecise>(b.z, b.w, g.w, t, tx, ty);
  add_source<P, kPrecise>(c.x, c.y, h.x, t, tx, ty);
  add_source<P, kPrecise>(c.z, c.w, h.y, t, tx, ty);
  add_source<P, kPrecise>(d.x, d.y, h.z, t, tx, ty);
  add_source<P, kPrecise>(d.z, d.w, h.w, t, tx, ty);
}

// Adds the `len` staged sources (a chunk that starts on a run boundary) to
// the totals (ax, ay), run by run.
template <int P, bool kPrecise>
__device__ __forceinline__ void add_chunk(const float2* spos, const float* sgm,
                                          int len, const TileTargets<P>& t,
                                          float (&ax)[P], float (&ay)[P]) {
  constexpr int kPass = kPairBatch * kBatchesPerPass;
#pragma unroll 1
  for (int run = 0; run < len; run += kRun) {
    const int end = min(run + kRun, len);
    float tx[P], ty[P];
#pragma unroll
    for (int q = 0; q < P; ++q) tx[q] = ty[q] = 0.f;
    int k = run;
#pragma unroll 1
    for (; k + kPass <= end; k += kPass) {
#pragma unroll
      for (int u = 0; u < kBatchesPerPass; ++u)
        add_batch<P, kPrecise>(spos, sgm, k + u * kPairBatch, t, tx, ty);
    }
    // the ragged end of the last run
#pragma unroll 1
    for (; k + kPairBatch <= end; k += kPairBatch)
      add_batch<P, kPrecise>(spos, sgm, k, t, tx, ty);
#pragma unroll 1
    for (; k < end; ++k) {
      const float2 s = spos[k];
      add_source<P, kPrecise>(s.x, s.y, sgm[k], t, tx, ty);
    }
#pragma unroll
    for (int q = 0; q < P; ++q) {
      ax[q] += tx[q];
      ay[q] += ty[q];
    }
  }
}

// The force on this thread's P targets from the sources of its block's
// range, split `split` of plan.n_split, into (ax, ay). With a cluster
// reduce, the rank-0 block ends with the totals of the whole cluster.
// Returns whether this block holds the totals (with a scratch reduce every
// block holds its own partials). Every thread of the block must call it.
template <int P, bool kPrecise>
__device__ __forceinline__ bool tile_sums(const TilePlan& plan,
                                          const float2* __restrict__ src_pos,
                                          const float* __restrict__ src_gm,
                                          int n_src, int split,
                                          const TileTargets<P>& t,
                                          float (&ax)[P], float (&ay)[P]) {
  extern __shared__ float4 tiles_smem[];
  // two stages, each plan.chunk positions and then plan.chunk gm
  float2* const spos = reinterpret_cast<float2*>(tiles_smem);
  float* const sgm = reinterpret_cast<float*>(spos + 2 * plan.chunk);
  const int span = plan.runs_per_split * kRun;
  const int begin = min(split * span, n_src);
  const int end = min(begin + span, n_src);
#pragma unroll
  for (int q = 0; q < P; ++q) ax[q] = ay[q] = 0.f;
  if (begin < end)
    stage_chunk(src_pos, src_gm, begin, min(plan.chunk, end - begin), spos,
                sgm);
  int at = 0;  // the stage the current chunk is in, times plan.chunk
  for (int base = begin; base < end; base += plan.chunk) {
    cp_async_wait_all();
    // this chunk is in; every thread is done with the other stage
    __syncthreads();
    const int next = base + plan.chunk;
    const int other = plan.chunk - at;
    if (next < end)
      stage_chunk(src_pos, src_gm, next, min(plan.chunk, end - next),
                  spos + other, sgm + other);
    if (t.warp_live)
      add_chunk<P, kPrecise>(spos + at, sgm + at, min(plan.chunk, end - base),
                             t, ax, ay);
    at = other;
  }
  if (plan.reduce != kReduceCluster) return true;

  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  float2* const part = reinterpret_cast<float2*>(tiles_smem);
  __syncthreads();  // the last chunk's reads are done before it is overwritten
#pragma unroll
  for (int q = 0; q < P; ++q)
    part[q * kBlock + threadIdx.x] = make_float2(ax[q], ay[q]);
  cluster.sync();  // every block's partials are written
  const bool holder = split == 0;
  if (holder) {
    for (int r = 1; r < plan.n_split; ++r) {
      const float2* theirs = cluster.map_shared_rank(part, r);
#pragma unroll
      for (int q = 0; q < P; ++q) {
        const float2 o = theirs[q * kBlock + threadIdx.x];
        ax[q] += o.x;
        ay[q] += o.y;
      }
    }
  }
  cluster.sync();  // no block leaves while rank 0 may still read it
  return holder;
}

// Dynamic shared memory of a launch: two stages of kChunk sources, or the
// cluster's partials if they need more.
inline size_t tile_smem(int p) {
  const size_t stages = 2 * static_cast<size_t>(kChunk) *
                        (sizeof(float2) + sizeof(float));
  const size_t partials = static_cast<size_t>(p) * kBlock * sizeof(float2);
  return stages > partials ? stages : partials;
}

// Launches kernel(plan, args...) over the target blocks of n_tgt targets,
// P per thread, times n_split source ranges: as clusters of n_split blocks
// (1 < n_split, !scratch), or with a scratch reduce. The block of target
// block b and range r is b * n_split + r, its cluster rank r. Returns the
// launch's error; a refused cluster launch is not retried without one.
template <int P, typename... KArgs, typename... Args>
cudaError_t launch_tiles(void (*kernel)(TilePlan, KArgs...), int n_tgt,
                         int n_src, int n_split, bool scratch,
                         cudaStream_t stream, Args&&... args) {
  if (n_split < 1) return cudaErrorInvalidValue;
  const int runs = (n_src + kRun - 1) / kRun;
  TilePlan plan;
  plan.n_split = n_split;
  plan.runs_per_split = (runs + n_split - 1) / n_split;
  plan.chunk = kChunk;
  plan.reduce = n_split == 1 ? kReduceNone
                : scratch   ? kReduceScratch
                            : kReduceCluster;
  const long long blocks =
      static_cast<long long>((n_tgt + P * kBlock - 1) / (P * kBlock)) * n_split;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const size_t smem = tile_smem(P);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(kBlock);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  if (plan.reduce == kReduceCluster) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = static_cast<unsigned>(n_split);
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  err = cudaLaunchKernelEx(&cfg, kernel, plan, std::forward<Args>(args)...);
  const cudaError_t last = cudaGetLastError();  // clears a refused launch
  return err != cudaSuccess ? err : last;
}

}  // namespace
