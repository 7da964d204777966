// Direct-sum softened gravity with an optional fused integration epilogue,
// for NVIDIA Hopper (sm_90a).
//
// Replaces two TPU kernels of nbody_tpu/ops/pallas_forces.py:
//   * _substep_kernel (sources resident in VMEM, S <= 131072), and
//   * _stream_kernel  (sources streamed block by block, S > 131072).
// Their split is a VMEM budget rule. Here one kernel serves every source
// count: each block stages the sources through shared memory one tile at a
// time, so the source count only sets the trip count of the tile loop.
//
// Math, per target i over sources j < n_src (the massive prefix): the
// tile loop of source_tiles.cuh.
// Epilogue when integrating (_finalize): v' = v + dt*a; x' = x + (pos_dt*dt)*v'
// with pos_dt*dt formed in fp32. pos_dt = 1 is semi-implicit Euler; 0.5 is
// the kick and half-drift of a DKD stage whose first half-drift the caller
// applied to the positions it passes in.
//
// What bounds it on an H100: per pair about nine fp32 operations, one MUFU
// rsqrt (or a sqrt and a divide when precise) and one shared-memory
// broadcast read; the state is small (N=65536 is about 2 MB) and sits in
// L2. So the limit is the issue rate of the SM's instruction pipes, not
// device memory. The design keeps the per-pair work to the arithmetic
// itself: one thread per target keeps its target and both accumulators in
// registers for the whole source loop; each (x, y, gm) source is read from
// device memory once per block and from shared memory as a single 16-byte
// broadcast per pair; the tile loop is unrolled so loop overhead is
// amortised. Reusing each shared-memory read across several targets per
// thread is left for later tuning.
//
// Jacobi semantics: the kernel reads pos/vel and writes acc/pos/vel into
// separate buffers. Updating positions in place while other blocks still
// read them as sources would be a race.
//
// Source split (nbody_direct_forces_split): a few targets against many
// sources (P3M's 64 exact-core rows against S = 524,704) give too few
// target blocks to fill 132 SMs; one block ran the whole sum alone. The
// split form gives each of n_split blocks per target block a contiguous
// range of whole source tiles, writes per-split partial sums to a scratch
// the wrapper allocates, and a second kernel sums them in split order, so
// the result is the same on every run. The wrapper picks n_split
// (ops/direct_forces._split_plan).
//
// The C entry points launch on the stream they are handed, do not
// synchronise, allocate nothing, and return cudaGetLastError() of the
// launches.

#include <cuda_runtime.h>

#include "source_tiles.cuh"  // kBlock, kTile, kSofteningFloor, accumulate_tiles,
                             // launch_sum_partials

namespace {

template <bool kPrecise, bool kIntegrate>
__global__ void __launch_bounds__(kBlock)
direct_forces_kernel(const float2* __restrict__ tgt_pos,
                     const float2* __restrict__ tgt_vel,
                     const float* __restrict__ tgt_radius,
                     const float2* __restrict__ src_pos,
                     const float* __restrict__ src_gm,
                     int n_tgt, int n_src, float dt, float pos_dt,
                     float2* __restrict__ acc_out,
                     float2* __restrict__ pos_out,
                     float2* __restrict__ vel_out) {
  __shared__ float4 tile[kTile];  // x, y, gm, unused

  const int i = blockIdx.x * kBlock + threadIdx.x;
  const bool live = i < n_tgt;
  const bool warp_live =
      static_cast<int>(blockIdx.x * kBlock + (threadIdx.x & ~31u)) < n_tgt;
  // Threads past the last target still help stage sources.
  const float2 p = live ? tgt_pos[i] : make_float2(0.f, 0.f);
  const float soft = live ? tgt_radius[i] + kSofteningFloor : 1.f;

  float ax = 0.f, ay = 0.f;
  accumulate_tiles<kPrecise>(p, soft, warp_live, src_pos, src_gm, n_src, 0,
                             (n_src + kTile - 1) / kTile, tile, ax, ay);

  if (!live) return;
  acc_out[i] = make_float2(ax, ay);
  if (kIntegrate) {
    const float2 v = tgt_vel[i];
    const float nvx = v.x + dt * ax;
    const float nvy = v.y + dt * ay;
    const float pdt = pos_dt * dt;
    vel_out[i] = make_float2(nvx, nvy);
    pos_out[i] = make_float2(p.x + pdt * nvx, p.y + pdt * nvy);
  }
}

// Source-split force: block (x, y) sums the force on its kBlock targets
// from the y-th of n_split contiguous ranges of whole source tiles into
// partial[y * n_tgt + i]. Used when the target blocks alone cannot fill the
// card (a few rows against many sources: P3M's exact-core rows).
template <bool kPrecise>
__global__ void __launch_bounds__(kBlock)
direct_forces_split_kernel(const float2* __restrict__ tgt_pos,
                           const float* __restrict__ tgt_radius,
                           const float2* __restrict__ src_pos,
                           const float* __restrict__ src_gm,
                           int n_tgt, int n_src, int n_split,
                           float2* __restrict__ partial) {
  __shared__ float4 tile[kTile];

  const int i = blockIdx.x * kBlock + threadIdx.x;
  const bool live = i < n_tgt;
  const bool warp_live =
      static_cast<int>(blockIdx.x * kBlock + (threadIdx.x & ~31u)) < n_tgt;
  const float2 p = live ? tgt_pos[i] : make_float2(0.f, 0.f);
  const float soft = live ? tgt_radius[i] + kSofteningFloor : 1.f;

  const int n_tiles = (n_src + kTile - 1) / kTile;
  const int per = (n_tiles + n_split - 1) / n_split;
  const int begin = min(static_cast<int>(blockIdx.y) * per, n_tiles);
  const int end = min(begin + per, n_tiles);
  float ax = 0.f, ay = 0.f;
  accumulate_tiles<kPrecise>(p, soft, warp_live, src_pos, src_gm, n_src,
                             begin, end, tile, ax, ay);
  if (live) partial[static_cast<size_t>(blockIdx.y) * n_tgt + i] =
      make_float2(ax, ay);
}

template <bool kPrecise, bool kIntegrate>
void launch(const float2* tgt_pos, const float2* tgt_vel,
            const float* tgt_radius, const float2* src_pos,
            const float* src_gm, int n_tgt, int n_src, float dt,
            float pos_dt, float2* acc_out, float2* pos_out, float2* vel_out,
            cudaStream_t stream) {
  const int grid = (n_tgt + kBlock - 1) / kBlock;
  direct_forces_kernel<kPrecise, kIntegrate><<<grid, kBlock, 0, stream>>>(
      tgt_pos, tgt_vel, tgt_radius, src_pos, src_gm, n_tgt, n_src, dt,
      pos_dt, acc_out, pos_out, vel_out);
}

}  // namespace

// Force on n_tgt targets from the first n_src sources; with integrate != 0
// also the integrated pos and vel. Pointers are device pointers to
// contiguous fp32 arrays: tgt_pos/tgt_vel/outputs (n_tgt, 2), tgt_radius
// (n_tgt,), src_gm (n_src,), and src_pos with at least n_src rows of 2.
// tgt_vel, pos_out and vel_out are read only when integrating. Returns the
// launch's cudaError_t (0 on success).
extern "C" int nbody_direct_forces(const void* tgt_pos, const void* tgt_vel,
                                   const void* tgt_radius,
                                   const void* src_pos, const void* src_gm,
                                   int n_tgt, int n_src, float dt,
                                   float pos_dt, int precise, int integrate,
                                   void* acc_out, void* pos_out,
                                   void* vel_out, void* stream) {
  if (n_tgt <= 0) return static_cast<int>(cudaSuccess);
  const auto* tp = static_cast<const float2*>(tgt_pos);
  const auto* tv = static_cast<const float2*>(tgt_vel);
  const auto* tr = static_cast<const float*>(tgt_radius);
  const auto* sp = static_cast<const float2*>(src_pos);
  const auto* sg = static_cast<const float*>(src_gm);
  auto* ao = static_cast<float2*>(acc_out);
  auto* po = static_cast<float2*>(pos_out);
  auto* vo = static_cast<float2*>(vel_out);
  auto st = static_cast<cudaStream_t>(stream);
  if (precise) {
    if (integrate)
      launch<true, true>(tp, tv, tr, sp, sg, n_tgt, n_src, dt, pos_dt, ao, po, vo, st);
    else
      launch<true, false>(tp, tv, tr, sp, sg, n_tgt, n_src, dt, pos_dt, ao, po, vo, st);
  } else {
    if (integrate)
      launch<false, true>(tp, tv, tr, sp, sg, n_tgt, n_src, dt, pos_dt, ao, po, vo, st);
    else
      launch<false, false>(tp, tv, tr, sp, sg, n_tgt, n_src, dt, pos_dt, ao, po, vo, st);
  }
  return static_cast<int>(cudaGetLastError());
}

// Force on n_tgt targets from the first n_src sources, with the sources cut
// into n_split contiguous ranges of whole tiles summed by separate blocks
// into `partial` (n_split, n_tgt, 2) fp32 scratch, then summed in split
// order into acc_out (n_tgt, 2). Two launches on `stream`; returns the
// cudaError_t of the launches (0 on success).
extern "C" int nbody_direct_forces_split(const void* tgt_pos,
                                         const void* tgt_radius,
                                         const void* src_pos,
                                         const void* src_gm, int n_tgt,
                                         int n_src, int n_split, int precise,
                                         void* partial, void* acc_out,
                                         void* stream) {
  if (n_tgt <= 0) return static_cast<int>(cudaSuccess);
  if (n_split < 1 || n_split > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* tp = static_cast<const float2*>(tgt_pos);
  const auto* tr = static_cast<const float*>(tgt_radius);
  const auto* sp = static_cast<const float2*>(src_pos);
  const auto* sg = static_cast<const float*>(src_gm);
  auto* part = static_cast<float2*>(partial);
  auto st = static_cast<cudaStream_t>(stream);
  const dim3 grid((n_tgt + kBlock - 1) / kBlock, n_split);
  if (precise)
    direct_forces_split_kernel<true><<<grid, kBlock, 0, st>>>(
        tp, tr, sp, sg, n_tgt, n_src, n_split, part);
  else
    direct_forces_split_kernel<false><<<grid, kBlock, 0, st>>>(
        tp, tr, sp, sg, n_tgt, n_src, n_split, part);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // (n_split, n_tgt, 2) partials summed in split order into (n_tgt, 2).
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
