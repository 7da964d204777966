// One hop of the ring of a sharded direct-sum substep, for NVIDIA Hopper
// (sm_90a).
//
// Replaces the TPU kernel nbody_tpu/ops/ring_forces.py::_make_kernel ->
// kernel (K3). There one Pallas kernel per device ran a whole substep: D
// hops of the visiting (x, y, gm) source tile round the ring of devices by
// remote DMA into a double-buffered slot, with a "slot freed" semaphore for
// backpressure, the acceleration summed over the hops in VMEM, then an
// integration pass. Here the ring's copies, their order and their
// backpressure live outside the kernel, in the schedule of
// ops/ring_forces.py (a copy stream and a compute stream per shard, CUDA
// events for the semaphores), and the kernel is one hop: launch (d, h) adds
// the force of the slot visiting shard d at hop h to d's targets. A shard
// makes D launches per substep, the world D^2.
//
// Per target i, with `hop` the force of the slot's first n_src sources
// (the pair loop of direct_tiles.cuh, per-run partial sums; n_src is the
// visiting shard's real source count, so its gm = 0 rows cost nothing):
//   not last:  acc_run_i = hop                 (first hop)
//              acc_run_i = acc_run_i + hop     (later hops; JAX's acc + local)
//   last:      a = (acc_run_i + hop) * valid_i (hop alone when D = 1)
//              v' = v + dt*a;  x' = x + (pos_dt*dt)*v', pos_dt*dt in fp32
//              a, x', v' into fresh buffers (Jacobi: other shards' slots
//              were gathered from the pre-step positions).
// pos_dt = 1 is semi-implicit Euler; 0.5 is the kick and half-drift of a
// DKD stage whose first half-drift the caller applied.
//
// Layout of a slot: (s_loc, 2) positions followed by (s_loc,) gm in one
// buffer, so one copy moves a slot and the kernel reads float2 and float
// rows as the direct kernel does. K3's 3->4 source-row padding (a Mosaic
// tiling rule) and its VMEM guards have no counterpart.
//
// What bounds it on an H100: as for direct_forces.cu, the issue rate of
// the SM's pipes, and the same pair loop (direct_tiles.cuh) cuts it: the
// rsqrt without its denormal guard, P targets a thread against each
// shared-memory read, sources staged 2048 at a time with cp.async, an
// unrolled batch loop. The plan (ops/direct_forces.cluster_plan) counts the
// shard's own real targets: the D shards of one card enqueue their hops on
// their own streams, but the host enqueues them slowly enough that they
// often run one at a time. At N=65536 on four shards a hop's 16384 targets
// are 32 blocks of P = 2, and the plan splits its source sum over a
// cluster of 5 blocks, whose rank-0 block adds the partials through
// distributed shared memory and runs the epilogue below. With D = 1 the
// plan is World's, and so are the bits. Fusing the D hops into one
// persistent launch per shard is later work.
//
// The C entry point launches on the stream it is handed, does not
// synchronise, allocates nothing, and returns the launch's cudaError_t.

#include <cuda_runtime.h>

#include "direct_tiles.cuh"  // launch_tiles, load_targets, tile_sums
#include "source_tiles.cuh"  // kBlock

namespace {

template <int P, bool kPrecise>
__global__ void __launch_bounds__(kBlock, 2)
ring_hop_kernel(TilePlan plan, const float2* __restrict__ tgt_pos,
                const float* __restrict__ tgt_radius,
                const float2* __restrict__ src_pos,
                const float* __restrict__ src_gm, int n_tgt, int n_src,
                float2* acc_run, int accumulate, int last,
                const float2* __restrict__ tgt_vel,
                const float* __restrict__ valid, float dt, float pos_dt,
                float2* __restrict__ acc_out, float2* __restrict__ pos_out,
                float2* __restrict__ vel_out) {
  const TileTargets<P> t =
      load_targets<P>(tgt_pos, tgt_radius, n_tgt, blockIdx.x / plan.n_split);
  float hx[P], hy[P];
  if (!tile_sums<P, kPrecise>(plan, src_pos, src_gm, n_src,
                              blockIdx.x % plan.n_split, t, hx, hy))
    return;
#pragma unroll
  for (int q = 0; q < P; ++q) {
    const int i = t.first + q * kBlock;
    if (i >= n_tgt) break;
    float ax = hx[q], ay = hy[q];
    if (accumulate) {
      const float2 r = acc_run[i];
      ax = r.x + hx[q];
      ay = r.y + hy[q];
    }
    if (!last) {
      acc_run[i] = make_float2(ax, ay);
      continue;
    }
    const float w = valid[i];
    ax *= w;
    ay *= w;
    const float2 v = tgt_vel[i];
    const float nvx = v.x + dt * ax;
    const float nvy = v.y + dt * ay;
    const float pdt = pos_dt * dt;
    acc_out[i] = make_float2(ax, ay);
    vel_out[i] = make_float2(nvx, nvy);
    pos_out[i] = make_float2(t.x[q] + pdt * nvx, t.y[q] + pdt * nvy);
  }
}

template <int P>
cudaError_t launch_p(bool precise, const float2* tp, const float* tr,
                     const float2* sp, const float* sg, int n_tgt, int n_src,
                     float2* run, int accumulate, int last, const float2* tv,
                     const float* va, float dt, float pos_dt, int n_split,
                     float2* ao, float2* po, float2* vo, cudaStream_t st) {
  if (precise)
    return launch_tiles<P>(ring_hop_kernel<P, true>, n_tgt, n_src, n_split,
                           false, st, tp, tr, sp, sg, n_tgt, n_src, run,
                           accumulate, last, tv, va, dt, pos_dt, ao, po, vo);
  return launch_tiles<P>(ring_hop_kernel<P, false>, n_tgt, n_src, n_split,
                         false, st, tp, tr, sp, sg, n_tgt, n_src, run,
                         accumulate, last, tv, va, dt, pos_dt, ao, po, vo);
}

}  // namespace

// One hop on one shard: the force on n_tgt targets of the first n_src
// sources of a slot. Device pointers to contiguous fp32 arrays: tgt_pos
// (n_tgt, 2), tgt_radius (n_tgt,), src_pos with at least n_src rows of 2,
// src_gm with at least n_src, acc_run (n_tgt, 2). accumulate != 0 adds the
// hop to acc_run instead of starting from zero. last == 0 writes the sum
// to acc_run; last != 0 reads tgt_vel (n_tgt, 2) and valid (n_tgt,) and
// writes acc_out, pos_out and vel_out (n_tgt, 2), leaving acc_run as it
// was. The plan: p (1 or 2) targets a thread, n_split source ranges per
// target block as one cluster of n_split blocks (a launch of more than the
// card's cluster size is refused, and its error returned). Returns the
// launch's cudaError_t (0 on success).
extern "C" int nbody_ring_hop(const void* tgt_pos, const void* tgt_radius,
                              const void* src_pos, const void* src_gm,
                              int n_tgt, int n_src, void* acc_run,
                              int accumulate, int last, const void* tgt_vel,
                              const void* valid, float dt, float pos_dt,
                              int precise, int p, int n_split, void* acc_out,
                              void* pos_out, void* vel_out, void* stream) {
  if (n_tgt <= 0) return static_cast<int>(cudaSuccess);
  const auto* tp = static_cast<const float2*>(tgt_pos);
  const auto* tr = static_cast<const float*>(tgt_radius);
  const auto* sp = static_cast<const float2*>(src_pos);
  const auto* sg = static_cast<const float*>(src_gm);
  auto* run = static_cast<float2*>(acc_run);
  const auto* tv = static_cast<const float2*>(tgt_vel);
  const auto* va = static_cast<const float*>(valid);
  auto* ao = static_cast<float2*>(acc_out);
  auto* po = static_cast<float2*>(pos_out);
  auto* vo = static_cast<float2*>(vel_out);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (p == 1)
    err = launch_p<1>(precise, tp, tr, sp, sg, n_tgt, n_src, run, accumulate,
                      last, tv, va, dt, pos_dt, n_split, ao, po, vo, st);
  else if (p == 2)
    err = launch_p<2>(precise, tp, tr, sp, sg, n_tgt, n_src, run, accumulate,
                      last, tv, va, dt, pos_dt, n_split, ao, po, vo, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
