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
// (the tile loop of source_tiles.cuh, per-tile partial sums; n_src is the
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
// the SM's pipes (about nine fp32 operations, one MUFU rsqrt and one
// shared-memory broadcast per pair). One hop of N=65536 on four shards is
// 16384 targets, 64 blocks; the four shards' launches of a hop run at once
// on their streams, about 256 blocks in flight, as for the direct kernel.
// Fusing the D hops into one persistent launch per shard is later work.
//
// The C entry point launches on the stream it is handed, does not
// synchronise, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>

#include "source_tiles.cuh"  // kBlock, kTile, kSofteningFloor, accumulate_tiles

namespace {

template <bool kPrecise>
__global__ void __launch_bounds__(kBlock)
ring_hop_kernel(const float2* __restrict__ tgt_pos,
                const float* __restrict__ tgt_radius,
                const float2* __restrict__ src_pos,
                const float* __restrict__ src_gm, int n_tgt, int n_src,
                float2* acc_run, int accumulate, int last,
                const float2* __restrict__ tgt_vel,
                const float* __restrict__ valid, float dt, float pos_dt,
                float2* __restrict__ acc_out, float2* __restrict__ pos_out,
                float2* __restrict__ vel_out) {
  __shared__ float4 tile[kTile];  // x, y, gm, unused

  const int i = blockIdx.x * kBlock + threadIdx.x;
  const bool live = i < n_tgt;
  const bool warp_live =
      static_cast<int>(blockIdx.x * kBlock + (threadIdx.x & ~31u)) < n_tgt;
  // Threads past the last target still help stage sources.
  const float2 p = live ? tgt_pos[i] : make_float2(0.f, 0.f);
  const float soft = live ? tgt_radius[i] + kSofteningFloor : 1.f;

  float hx = 0.f, hy = 0.f;
  accumulate_tiles<kPrecise>(p, soft, warp_live, src_pos, src_gm, n_src, 0,
                             (n_src + kTile - 1) / kTile, tile, hx, hy);

  if (!live) return;
  float ax = hx, ay = hy;
  if (accumulate) {
    const float2 r = acc_run[i];
    ax = r.x + hx;
    ay = r.y + hy;
  }
  if (!last) {
    acc_run[i] = make_float2(ax, ay);
    return;
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
  pos_out[i] = make_float2(p.x + pdt * nvx, p.y + pdt * nvy);
}

}  // namespace

// One hop on one shard: the force on n_tgt targets of the first n_src
// sources of a slot. Device pointers to contiguous fp32 arrays: tgt_pos
// (n_tgt, 2), tgt_radius (n_tgt,), src_pos with at least n_src rows of 2,
// src_gm with at least n_src, acc_run (n_tgt, 2). accumulate != 0 adds the
// hop to acc_run instead of starting from zero. last == 0 writes the sum
// to acc_run; last != 0 reads tgt_vel (n_tgt, 2) and valid (n_tgt,) and
// writes acc_out, pos_out and vel_out (n_tgt, 2), leaving acc_run as it
// was. Returns the launch's cudaError_t (0 on success).
extern "C" int nbody_ring_hop(const void* tgt_pos, const void* tgt_radius,
                              const void* src_pos, const void* src_gm,
                              int n_tgt, int n_src, void* acc_run,
                              int accumulate, int last, const void* tgt_vel,
                              const void* valid, float dt, float pos_dt,
                              int precise, void* acc_out, void* pos_out,
                              void* vel_out, void* stream) {
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
  const int grid = (n_tgt + kBlock - 1) / kBlock;
  if (precise)
    ring_hop_kernel<true><<<grid, kBlock, 0, st>>>(
        tp, tr, sp, sg, n_tgt, n_src, run, accumulate, last, tv, va, dt,
        pos_dt, ao, po, vo);
  else
    ring_hop_kernel<false><<<grid, kBlock, 0, st>>>(
        tp, tr, sp, sg, n_tgt, n_src, run, accumulate, last, tv, va, dt,
        pos_dt, ao, po, vo);
  return static_cast<int>(cudaGetLastError());
}
