// The pair step of the ablation kernels redesigned for Hopper (K5a, K5b and
// K5c, v2_forces.cu; K5d, stationary_forces.cu; K5h, newton_forces.cu; K5i,
// bcast_probe.cu): P targets a thread, each source value that reaches the
// thread serving all P of them, and an unguarded rsqrt.
//
// Per target q and source (sx, sy, gm), on chain c:
//   dx = sx - x_q;  dy = sy - y_q;  r2 = dx*dx + dy*dy + soft_q
//   f  = gm * inv*inv*inv, inv = rsqrt.approx.ftz(r2)   (default)
//   f  = gm / (sqrtf(r2) * r2)                         (kPrecise: IEEE
//        sqrt and divide, nvcc's defaults; no --use_fast_math)
//   tx[q][c] += dx * f;  ty[q][c] += dy * f
// rsqrt.approx.ftz.f32 is MUFU.RSQ alone; rsqrtf without fast math adds a
// denormal guard (FSETP and two predicated FMUL a pair). The two give the
// same bits wherever r2 is a normal float or r2 <= 0 or NaN (both +inf at
// 0, NaN below); they differ only for 0 < r2 < FLT_MIN, which the ftz form
// flushes to 0. v2_forces.cu's, stationary_forces.cu's and
// newton_forces.cu's r2 >= 1e-18 is normal; bcast_probe.cu's r2 takes the
// target's raw third row and counts such pairs on its inputs (none).
//
// The math is a policy of Pairs (StepMath, the above, by default): the
// factor f, whether ty is summed, and whether only the first source of a
// staged range counts (K5c's op-cost probes, v2_forces.cu, change one of
// these at a time).
//
// A staged batch holds the x, y and gm rows of kBatch sources side by side
// (24 floats), read into registers as six 16-byte loads off one address.
// add_runs sums a staged range in runs of kRun sources (K5a, K5d; K5h's
// runs are its tile width), each into fresh registers before it joins the
// total. cp_async stages sources asynchronously (K5a-K5c, K5g, K5e, K5h).
// sweep_body is the chunked force of K5g (ptile_forces.cu) and K5e
// (flavor_forces.cu) under a sum policy, SweepSum.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "source_tiles.cuh"  // kRun, RowTargets, allow_smem,
                             // launch_sum_partials

namespace {

constexpr int kBatch = 8;      // sources read into registers together
constexpr int kRunUnroll = 4;  // batches a pass of add_runs' loop

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

__device__ __forceinline__ float rsqrt_ftz(float x) {
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The default math: f = gm * inv^3 with the unguarded rsqrt, or (kPrecise)
// gm / (sqrtf(r2) * r2); both axes; every source.
template <bool kPrecise>
struct StepMath {
  static constexpr bool kY = true;           // ty is summed
  static constexpr bool kFirstOnly = false;  // only a range's first source
  static __device__ __forceinline__ float factor(float gm, float dx, float dy,
                                                 float soft) {
    if constexpr (kPrecise) {
      const float r2 = dx * dx + dy * dy + soft;
      return gm / (sqrtf(r2) * r2);
    } else {
      const float inv = rsqrt_ftz(dx * dx + dy * dy + soft);
      return gm * (inv * inv * inv);
    }
  }
};

// The P targets of one thread and their chains: target q, chain c.
template <int P, int K, bool kPrecise = false, class Math = StepMath<kPrecise>>
struct Pairs {
  float x[P], y[P], soft[P];
  float tx[P][K], ty[P][K];

  __device__ __forceinline__ void add(float sx, float sy, float gm, int c) {
#pragma unroll
    for (int q = 0; q < P; ++q) {
      const float dx = sx - x[q];
      const float dy = sy - y[q];
      const float f = Math::factor(gm, dx, dy, soft[q]);
      tx[q][c] += dx * f;
      if constexpr (Math::kY) ty[q][c] += dy * f;
    }
  }

  // The 8 sources of the staged batch at `batch` (x, y and gm rows of 8),
  // read into registers first, then their pairs in source order, source b
  // of the batch on chain b % K.
  __device__ __forceinline__ void add_batch(const float* batch) {
    const float4* v = reinterpret_cast<const float4*>(batch);
    float xs[kBatch], ys[kBatch], gs[kBatch];
#pragma unroll
    for (int h = 0; h < kBatch / 4; ++h) {
      const float4 a = v[h];
      const float4 b = v[2 + h];
      const float4 g = v[4 + h];
      xs[4 * h] = a.x; xs[4 * h + 1] = a.y; xs[4 * h + 2] = a.z; xs[4 * h + 3] = a.w;
      ys[4 * h] = b.x; ys[4 * h + 1] = b.y; ys[4 * h + 2] = b.z; ys[4 * h + 3] = b.w;
      gs[4 * h] = g.x; gs[4 * h + 1] = g.y; gs[4 * h + 2] = g.z; gs[4 * h + 3] = g.w;
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) add(xs[b], ys[b], gs[b], b % K);
  }
};

// Where source k of a staged range and row r (x, y, gm) lie: batch k / 8
// holds rows of 8.
__device__ __forceinline__ int stage_at(int k, int r) {
  return (k / kBatch) * (3 * kBatch) + r * kBatch + k % kBatch;
}

// Issues the copies of sources [base, base + len) of the (3, n_src) rows at
// src into the stage st (stage_at's layout), one group, by the threads
// first, first + stride, ... vec16: 16-byte copies of whole groups of four
// (a row's last group may reach past len, never past n_src).
__device__ __forceinline__ void stage_rows(const float* __restrict__ src,
                                           int n_src, int base, int len,
                                           float* st, bool vec16, int first,
                                           int stride) {
  if (vec16) {
    const int n4 = (len + 3) / 4;
    for (int r = 0; r < 3; ++r) {
      const float* row = src + static_cast<size_t>(r) * n_src + base;
      for (int v = first; v < n4; v += stride)
        cp_async<16>(st + stage_at(4 * v, r), row + 4 * v);
    }
  } else {
    for (int r = 0; r < 3; ++r) {
      const float* row = src + static_cast<size_t>(r) * n_src + base;
      for (int k = first; k < len; k += stride)
        cp_async<4>(st + stage_at(k, r), row + k);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Adds the `len` sources staged at st (stage_at's layout, from a whole
// batch) to the totals (ax[q], ay[q]) of the thread's P targets run by run,
// kRunLen sources a run (the last run of a range may be shorter) summed into
// fresh registers, kRunUnroll batches a pass, each run then added to the
// total: the association that K5a and K5d had before they ran here, and
// K5g's (RunSweep, below). (One chain a chunk, v2_forces.cu's variant 0,
// drifts with the chunk: 5.5e-6 of the force's max against the direct sum
// at chunk 4096, PERF.md §6.) A ragged last batch (len not a multiple of
// 8) is read source by source.
template <int P, bool kPrecise, int kRunLen = kRun>
__device__ __forceinline__ void add_runs(const float* st, int len,
                                         Pairs<P, 1, kPrecise>& t, float* ax,
                                         float* ay) {
  static_assert(kRunLen % kBatch == 0, "a run is whole batches");
  constexpr int kPass = kBatch * kRunUnroll;
  constexpr int kStride = 3 * kBatch;  // floats of a staged batch
  for (int run = 0; run < len; run += kRunLen) {
    const int end = min(run + kRunLen, len);
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

// --- The chunked sweep of K5g and K5e ---
//
// A sum policy of sweep_body. kClose: sources a run, each run summed into
// fresh chains before it joins the target's sums, or 0 for one run a chunk.
// kChains: chains a run, source k of the run (k from its start) on chain
// k % kChains. kLanes: chain c joins lane sum c and the lanes are folded in
// lane order at the end; else the chains are folded in chain order and the
// fold joins the one total, at each close.
template <int kClose_, int kChains_, bool kLanes_>
struct SweepSum {
  static constexpr int kClose = kClose_;
  static constexpr int kChains = kChains_;
  static constexpr bool kLanes = kLanes_;
  static constexpr int kSums = kLanes_ ? kChains_ : 1;  // sums a target
  static_assert(kBatch % kChains_ == 0, "chains must divide the batch");
  static_assert(kClose_ % kBatch == 0, "a run is whole batches");
};
// Runs of kRun, one chain each: add_runs' association (K5g).
using RunSweep = SweepSum<kRun, 1, false>;

// Adds sources [from, end) of the stage at st (from a whole number of
// batches) to t's chains, source from + k on chain k % K: kUnroll batches a
// pass, then batch by batch, then a ragged end source by source. kUnroll is
// kRunUnroll up to P = 2 and one from P = 4: 32 or more pairs a pass either
// way (four batches in flight took P = 4 to 167 registers).
template <int P, int K, class Math>
__device__ __forceinline__ void add_span(const float* st, int from, int end,
                                         Pairs<P, K, false, Math>& t) {
  constexpr int kUnroll = P <= 2 ? kRunUnroll : 1;
  constexpr int kPass = kBatch * kUnroll;
  constexpr int kStride = 3 * kBatch;  // floats of a staged batch
  int k = from;
  const float* batch = st + 3 * from;
#pragma unroll 1
  for (; k + kPass <= end; k += kPass, batch += kUnroll * kStride) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) t.add_batch(batch + u * kStride);
  }
  if constexpr (kUnroll > 1) {
#pragma unroll 1
    for (; k + kBatch <= end; k += kBatch, batch += kStride)
      t.add_batch(batch);
  }
#pragma unroll
  for (int b = 0; b < kBatch - 1; ++b)
    if (k + b < end)
      t.add(batch[b], batch[kBatch + b], batch[2 * kBatch + b], b % K);
}

// Closes a run: t's chains join the sums (ax[q * L + c], ay[q * L + c])
// as the policy says, and start again from 0.
template <class Sum, int P, class Math>
__device__ __forceinline__ void close_run(Pairs<P, Sum::kChains, false, Math>& t,
                                          float* ax, float* ay) {
  constexpr int K = Sum::kChains;
  constexpr int L = Sum::kSums;
#pragma unroll
  for (int q = 0; q < P; ++q) {
    if constexpr (Sum::kLanes) {
#pragma unroll
      for (int c = 0; c < K; ++c) {
        ax[q * L + c] += t.tx[q][c];
        ay[q * L + c] += t.ty[q][c];
      }
    } else {
      float sx = t.tx[q][0], sy = t.ty[q][0];
#pragma unroll
      for (int c = 1; c < K; ++c) {
        sx += t.tx[q][c];
        sy += t.ty[q][c];
      }
      ax[q * L] += sx;
      ay[q * L] += sy;
    }
#pragma unroll
    for (int c = 0; c < K; ++c) t.tx[q][c] = t.ty[q][c] = 0.f;
  }
}

// The sources [base, base + len) of stage g of a block's range of whole
// chunks from c_begin: chunk c_begin + g / per (per stages a chunk), its
// (g % per)-th stage of `stage` sources (its last may be shorter).
__device__ __forceinline__ int2 stage_span(int g, int per, int c_begin,
                                           int chunk, int stage, int n_src) {
  const int j = g % per;
  const int base = (c_begin + g / per) * chunk + j * stage;
  return make_int2(base, min(min(stage, chunk - j * stage), n_src - base));
}

// Whether `stage` sources a stage keep the sums of a chunk of `chunk`: the
// whole chunk, or a multiple of kRun below it (each chunk's stages start at
// its start, so a run of kRun and a batch of 8 lie in one stage, and a
// chain's source k stays on chain k % K), whose two buffers fit a block's
// shared memory.
inline bool sweep_stage_ok(int chunk, int stage) {
  constexpr long long kMaxSmem = 232448;
  return stage >= 1 && stage <= chunk && (stage == chunk || stage % kRun == 0) &&
         24LL * ((stage + kBatch - 1) / kBatch * kBatch) <= kMaxSmem;
}

// The chunked force: block (x, y) holds P * blockDim.x targets, P a thread
// (i, i + blockDim.x, ..., strided so that loads stay coalesced), and sums
// the sources of the y-th of gridDim.y ranges of chunks_per_split whole
// chunks of `chunk` into out + y * 2 n_tgt ((2, n_tgt) rows), by the sum
// policy Sum and the pair math Math. Each chunk is staged `stage` sources
// at a time (sweep_stage_ok) into two buffers of dynamic shared memory
// (stage_at's layout), double-buffered: the next stage's cp.async copies
// are issued before the current stage's pairs run, one barrier a stage. A
// run's and a chunk's chains are carried from stage to stage, so the sums
// are the policy's whatever the stage. Lane sums are folded in lane order
// before the write.
template <int P, class Sum, class Math>
__device__ __forceinline__ void sweep_body(RowTargets targets,
                                           const float* __restrict__ src,
                                           int n_tgt, int n_src, int chunk,
                                           int stage, int chunks_per_split,
                                           int vec16, float* __restrict__ out) {
  constexpr int L = Sum::kSums;
  extern __shared__ float4 sweep_smem[];
  float* const buf = reinterpret_cast<float*>(sweep_smem);
  const int first = blockIdx.x * (P * blockDim.x) + threadIdx.x;
  Pairs<P, Sum::kChains, false, Math> t;
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
    for (int c = 0; c < Sum::kChains; ++c) t.tx[q][c] = t.ty[q][c] = 0.f;
#pragma unroll
    for (int c = 0; c < L; ++c) ax[q * L + c] = ay[q * L + c] = 0.f;
  }
  const int n_chunks = (n_src + chunk - 1) / chunk;
  const int c_begin = min(static_cast<int>(blockIdx.y) * chunks_per_split,
                          n_chunks);
  const int c_end = min(c_begin + chunks_per_split, n_chunks);
  const int per = (chunk + stage - 1) / stage;
  // the range's stages: per a whole chunk, fewer in a short last chunk
  const int n_stages =
      c_begin < c_end
          ? (c_end - 1 - c_begin) * per +
                (min(chunk, n_src - (c_end - 1) * chunk) + stage - 1) / stage
          : 0;
  const int span = 3 * ((stage + kBatch - 1) / kBatch * kBatch);  // a buffer
  if (n_stages > 0) {
    const int2 s = stage_span(0, per, c_begin, chunk, stage, n_src);
    stage_rows(src, n_src, s.x, s.y, buf, vec16, threadIdx.x, blockDim.x);
  }
  int at = 0;  // offset of the buffer that holds stage g
  for (int g = 0; g < n_stages; ++g) {
    cp_async_wait_all();
    // stage g is in; every thread is done with the other buffer
    __syncthreads();
    const int other = span - at;
    if (g + 1 < n_stages) {
      const int2 s = stage_span(g + 1, per, c_begin, chunk, stage, n_src);
      stage_rows(src, n_src, s.x, s.y, buf + other, vec16, threadIdx.x,
                 blockDim.x);
    }
    const int len = stage_span(g, per, c_begin, chunk, stage, n_src).y;
    if constexpr (Sum::kClose > 0) {
      for (int run = 0; run < len; run += Sum::kClose) {
        add_span(buf + at, run, min(run + Sum::kClose, len), t);
        close_run<Sum>(t, ax, ay);
      }
    } else {
      add_span(buf + at, 0, len, t);
      if (g % per == per - 1 || g + 1 == n_stages) close_run<Sum>(t, ax, ay);
    }
    at = other;
  }
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
      o[i] = sx;
      o[n_tgt + i] = sy;
    }
  }
}

// Launches `kernel` (a kernel on sweep_body, P targets a thread, `block`
// threads a block) over n_split ranges of whole chunks: straight into out
// when n_split = 1, else into the (n_split, 2, n_tgt) partials at `part`,
// summed in range order into out. The copies are 16 bytes where every
// stage's first source is 16-byte aligned (src 16-byte aligned, n_src and
// chunk multiples of 4), else 4 bytes.
template <int P, class Kernel>
cudaError_t launch_sweep(Kernel kernel, const float* tgt, const float* src,
                         int n_tgt, int n_src, int block, int chunk, int stage,
                         int n_split, float* part, float* out,
                         cudaStream_t st) {
  const size_t smem =
      static_cast<size_t>(6) * ((stage + kBatch - 1) / kBatch * kBatch) *
      sizeof(float);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int vec16 = reinterpret_cast<uintptr_t>(src) % 16 == 0 &&
                    n_src % 4 == 0 && chunk % 4 == 0;
  const int n_chunks = (n_src + chunk - 1) / chunk;
  const int per = (n_chunks + n_split - 1) / n_split;
  const dim3 grid((n_tgt + P * block - 1) / (P * block), n_split);
  kernel<<<grid, block, smem, st>>>(RowTargets{tgt}, src, n_tgt, n_src, chunk,
                                    stage, per, vec16,
                                    n_split > 1 ? part : out);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return err;
  return launch_sum_partials(part, n_tgt, n_split, n_tgt, 1, out, st);
}

}  // namespace
