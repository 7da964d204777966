// Direct-sum softened gravity with an optional fused integration epilogue,
// for NVIDIA Hopper (sm_90a).
//
// Replaces two TPU kernels of nbody_tpu/ops/pallas_forces.py:
//   * _substep_kernel (sources resident in VMEM, S <= 131072), and
//   * _stream_kernel  (sources streamed block by block, S > 131072).
// Their split is a VMEM budget rule. Here one kernel serves every source
// count: each block stages the sources through shared memory a chunk at a
// time, so the source count only sets the trip count of the chunk loop.
//
// Math, per target i over sources j < n_src (the massive prefix): the pair
// loop of direct_tiles.cuh.
// Epilogue when integrating (_finalize): v' = v + dt*a; x' = x + (pos_dt*dt)*v'
// with pos_dt*dt formed in fp32. pos_dt = 1 is semi-implicit Euler; 0.5 is
// the kick and half-drift of a DKD stage whose first half-drift the caller
// applied to the positions it passes in.
//
// What bounds it on an H100: the MUFU rsqrt, one a pair at 16 a clock per
// SM, is the bound's largest term; the state is small (N=65536 is about
// 2 MB) and sits in L2. What the kernel reaches is the issue rate of the
// SM's pipes: a pair is about ten fp32 instructions besides the MUFU. The
// design (direct_tiles.cuh) cuts the instructions a pair costs: rsqrt as
// rsqrt.approx.ftz.f32 with no denormal guard; P targets a thread, so that
// one shared-memory read serves P pairs; sources staged 2048 at a time,
// double-buffered with cp.async; an unrolled batch loop. When the target
// blocks alone cannot fill the card, the n_split blocks of a target block
// split the source sum as one thread-block cluster, and the rank-0 block
// adds the partials through distributed shared memory and integrates: one
// launch. The plan (P, n_split) is the wrapper's
// (ops/direct_forces.cluster_plan).
//
// Jacobi semantics: the kernel reads pos/vel and writes acc/pos/vel into
// separate buffers. Updating positions in place while other blocks still
// read them as sources would be a race.
//
// Source split into more ranges than a cluster holds (force_acc's few
// targets against many sources: P3M's 64 exact-core rows against
// S = 524,704, about 260 ranges): each block writes its partial sums to a
// scratch the wrapper allocates, and a second kernel sums them in range
// order, so the result is the same on every run.
//
// The C entry point launches on the stream it is handed, does not
// synchronise, allocates nothing, and returns the launches' cudaError_t.

#include <cuda_runtime.h>

#include "direct_tiles.cuh"  // launch_tiles, load_targets, tile_sums
#include "source_tiles.cuh"  // kBlock, launch_sum_partials

namespace {

template <int P, bool kPrecise, bool kIntegrate>
__global__ void __launch_bounds__(kBlock, 2)
direct_forces_kernel(TilePlan plan, const float2* __restrict__ tgt_pos,
                     const float2* __restrict__ tgt_vel,
                     const float* __restrict__ tgt_radius,
                     const float2* __restrict__ src_pos,
                     const float* __restrict__ src_gm, int n_tgt, int n_src,
                     float dt, float pos_dt, float2* __restrict__ acc_out,
                     float2* __restrict__ pos_out,
                     float2* __restrict__ vel_out,
                     float2* __restrict__ partial) {
  const int split = blockIdx.x % plan.n_split;
  const TileTargets<P> t =
      load_targets<P>(tgt_pos, tgt_radius, n_tgt, blockIdx.x / plan.n_split);
  float ax[P], ay[P];
  if (!tile_sums<P, kPrecise>(plan, src_pos, src_gm, n_src, split, t, ax, ay))
    return;
#pragma unroll
  for (int q = 0; q < P; ++q) {
    const int i = t.first + q * kBlock;
    if (i >= n_tgt) break;
    if (plan.reduce == kReduceScratch) {
      partial[static_cast<size_t>(split) * n_tgt + i] = make_float2(ax[q], ay[q]);
      continue;
    }
    acc_out[i] = make_float2(ax[q], ay[q]);
    if (kIntegrate) {
      const float2 v = tgt_vel[i];
      const float nvx = v.x + dt * ax[q];
      const float nvy = v.y + dt * ay[q];
      const float pdt = pos_dt * dt;
      vel_out[i] = make_float2(nvx, nvy);
      pos_out[i] = make_float2(t.x[q] + pdt * nvx, t.y[q] + pdt * nvy);
    }
  }
}

template <int P, bool kPrecise, bool kIntegrate>
cudaError_t launch(const float2* tp, const float2* tv, const float* tr,
                   const float2* sp, const float* sg, int n_tgt, int n_src,
                   float dt, float pos_dt, int n_split, float2* partial,
                   float2* ao, float2* po, float2* vo, cudaStream_t st) {
  return launch_tiles<P>(direct_forces_kernel<P, kPrecise, kIntegrate>, n_tgt,
                         n_src, n_split, partial != nullptr, st, tp, tv, tr,
                         sp, sg, n_tgt, n_src, dt, pos_dt, ao, po, vo,
                         partial);
}

template <int P>
cudaError_t launch_p(bool precise, bool integrate, const float2* tp,
                     const float2* tv, const float* tr, const float2* sp,
                     const float* sg, int n_tgt, int n_src, float dt,
                     float pos_dt, int n_split, float2* partial, float2* ao,
                     float2* po, float2* vo, cudaStream_t st) {
  if (precise && integrate)
    return launch<P, true, true>(tp, tv, tr, sp, sg, n_tgt, n_src, dt, pos_dt,
                                 n_split, partial, ao, po, vo, st);
  if (precise)
    return launch<P, true, false>(tp, tv, tr, sp, sg, n_tgt, n_src, dt, pos_dt,
                                  n_split, partial, ao, po, vo, st);
  if (integrate)
    return launch<P, false, true>(tp, tv, tr, sp, sg, n_tgt, n_src, dt, pos_dt,
                                  n_split, partial, ao, po, vo, st);
  return launch<P, false, false>(tp, tv, tr, sp, sg, n_tgt, n_src, dt, pos_dt,
                                 n_split, partial, ao, po, vo, st);
}

}  // namespace

// Force on n_tgt targets from the first n_src sources; with integrate != 0
// also the integrated pos and vel. Pointers are device pointers to
// contiguous fp32 arrays: tgt_pos/tgt_vel/outputs (n_tgt, 2), tgt_radius
// (n_tgt,), src_gm (n_src,), and src_pos with at least n_src rows of 2.
// tgt_vel, pos_out and vel_out are read only when integrating.
// The plan: p (1 or 2) targets a thread; n_split source ranges of whole
// 256-source runs per target block. With partial == NULL and n_split > 1
// the ranges of a target block are one cluster of n_split blocks (a launch
// of more than the card's cluster size is refused, and its error
// returned). With partial != NULL (force only) they write (n_split, n_tgt,
// 2) partials there, summed in range order into acc_out by a second
// launch. Returns the launches' cudaError_t (0 on success).
extern "C" int nbody_direct_forces(const void* tgt_pos, const void* tgt_vel,
                                   const void* tgt_radius,
                                   const void* src_pos, const void* src_gm,
                                   int n_tgt, int n_src, float dt,
                                   float pos_dt, int precise, int integrate,
                                   int p, int n_split, void* partial,
                                   void* acc_out, void* pos_out,
                                   void* vel_out,
                                   void* stream) {
  if (n_tgt <= 0) return static_cast<int>(cudaSuccess);
  if (partial != nullptr && integrate)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* tp = static_cast<const float2*>(tgt_pos);
  const auto* tv = static_cast<const float2*>(tgt_vel);
  const auto* tr = static_cast<const float*>(tgt_radius);
  const auto* sp = static_cast<const float2*>(src_pos);
  const auto* sg = static_cast<const float*>(src_gm);
  auto* part = static_cast<float2*>(partial);
  auto* ao = static_cast<float2*>(acc_out);
  auto* po = static_cast<float2*>(pos_out);
  auto* vo = static_cast<float2*>(vel_out);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (p == 1)
    err = launch_p<1>(precise, integrate, tp, tv, tr, sp, sg, n_tgt, n_src, dt,
                      pos_dt, n_split, part, ao, po, vo, st);
  else if (p == 2)
    err = launch_p<2>(precise, integrate, tp, tv, tr, sp, sg, n_tgt, n_src, dt,
                      pos_dt, n_split, part, ao, po, vo, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  if (err != cudaSuccess || part == nullptr || n_split == 1)
    return static_cast<int>(err);
  // (n_split, n_tgt, 2) partials summed in range order into (n_tgt, 2).
  return static_cast<int>(launch_sum_partials(
      static_cast<const float*>(partial), n_tgt, n_split, 1, 2,
      static_cast<float*>(acc_out), st));
}

// The number of SMs of the current device into *out; returns the
// cudaError_t of the query.
extern "C" int nbody_sm_count(int* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      cudaDeviceGetAttribute(out, cudaDevAttrMultiProcessorCount, dev));
}
