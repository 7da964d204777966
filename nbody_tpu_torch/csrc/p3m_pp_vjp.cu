// The VJP of the P3M short-range pair correction over cell-sorted particles
// (p3m_pp.cu, K4), for NVIDIA Hopper (sm_90a).
//
// Replaces the backward of nbody_tpu/ops/p3m_pallas.py's pp_blocks
// (_make_pp_blocks), which re-derives the adjoint of the jnp formulation
// _pp_blocks_jnp at backward time and leaves it to XLA: the backward of K4
// (_pp_kernel) on the "p3m" rollout's path. The forward stays p3m_pp.cu.
//
// Inputs are K4's: the rows in cell order (trows x, y, r + 1e-18, unused;
// srows x, y, gm, unused), each cell's run (start, count) on both sides,
// of which only the first cap rows take part, and (rc, eps2, 1/rc) on the
// device; plus the cotangent g (n_t, 2) of K4's result. For the pair
// (target i, source j) of neighbour cells with d2 < rc^2:
//   d = (dx, dy) = s_j - t_i;  d2 = dx*dx + dy*dy
//   exact3 = (d2 + tr)^(-3/2), smooth3 = (d2 + eps2)^(-3/2) as in K4
//   su = sqrt(d2 + 1e-12);  u = min(su * inv_rc, 1)
//   taper = u^3 (10 + u (6u - 15)),  taper' = 30 u^2 (1 - u)^2 (0 at u = 1)
//   h = exact3 - taper * smooth3;  w = gm * h
//   s = g_i . d;  ps = s * gm
//   te = -1.5 * exact3 * ps / (d2 + tr);  ts = -1.5 * smooth3 * ps / (d2 + eps2)
//   tt = taper' * (0.5 / su) * inv_rc * smooth3 * ps
//   c = w * g_i + 2 (te - tt - taper * ts) * d
//   d_trow_i = (-sum_j c, sum_j te);  d_srow_j = (sum_i c, sum_i s * h)
// the VJP of _pp_blocks_jnp (the 1e-12 bias keeps taper' finite at d2 = 0,
// a self pair). Products with ps come before a division by r2, so a pair
// with s = 0 adds 0 and not 0 * inf.
//
// Two kernels, each K4's walk (p3m_pp.cu: one warp a tile of up to 32 rows
// of one cell, a task list numbered cell by cell from a device-side prefix
// sum, the 3x3 neighbour runs staged 128 rows at a time through the warp's
// own shared memory, pairs at d2 >= rc^2 skipped before any transcendental):
//   * the target pass: a lane a target of a cell's first cap_t, over the
//     neighbour cells' first cap_s sources; writes d_trows;
//   * the source pass: a lane a source of a cell's first cap_s, over the
//     neighbour cells' first cap_t targets (the 3x3 neighbourhood is
//     symmetric, so each pair is seen once on each side); writes d_srows.
// Rows past a cell's cap are not written: the caller hands in zeroed
// outputs. Each lane sums its pairs in neighbour order, then row order:
// the same bits on every run, no atomics.
//
// What bounds it on an H100: per pair inside rc 55 fp32 operations (an
// FMA as two) and, with rsqrt, 3 MUFU operations: the rsqrt of r2, of q2
// and of d2 + 1e-12 (1/r2 and 1/q2 are the squares of the first two; su
// and 0.5/su both come from the third); the bytes are O(N). So the bound
// is the operations over the pairs inside rc (chip_smoke.py counts them).
// This kernel spends 6 MUFU there (the taper's sqrt and the three
// divisions are IEEE operations, each with its refinement), computes each
// pair twice (once a pass) and keeps K4's idle lanes. Taking those from
// the three rsqrt, merging the passes and filling the lanes are left for
// later work.
//
// The C entry points launch on the stream they are handed, do not
// synchronise, allocate nothing, and return cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;    // warps a block; each runs tasks of its own
constexpr int kStage = 128;  // rows of the other side a warp stages a pass

__device__ __forceinline__ float rsqrt_ftz(float x) {
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// K4's search: the first cell c with tile_end[c] > task.
__device__ __forceinline__ int find_cell(const int* __restrict__ tile_end,
                                         int n_cells, int task, int lane) {
  int lo = 0, hi = n_cells;
  while (hi - lo > 1) {
    const int step = (hi - lo + 31) / 32;
    const int p = lo + lane * step;
    const bool below = p < hi && tile_end[p] <= task;
    const int m = __popc(__ballot_sync(0xffffffffu, below));
    const int new_lo = m ? lo + (m - 1) * step + 1 : lo;
    hi = min(lo + m * step + 1, hi);
    lo = new_lo;
  }
  return lo;
}

struct Scalars {
  float rc2, eps2, inv_rc;
};

// The VJP terms of one pair with d2 < rc^2 (see the header) into the sums:
// (cx, cy) += c, and e += te (kTargets) or e += s * h (sources).
template <bool kPrecise, bool kTargets>
__device__ __forceinline__ void add_pair(float dx, float dy, float d2,
                                         float tr, float gm, float gx,
                                         float gy, const Scalars& k,
                                         float& cx, float& cy, float& e) {
  const float r2 = d2 + tr;
  const float q2 = d2 + k.eps2;
  float exact3, smooth3;
  if (kPrecise) {
    exact3 = 1.f / (sqrtf(r2) * r2);
    smooth3 = 1.f / (sqrtf(q2) * q2);
  } else {
    const float inv = rsqrt_ftz(r2);
    exact3 = inv * inv * inv;
    const float invq = rsqrt_ftz(q2);
    smooth3 = invq * invq * invq;
  }
  const float su = sqrtf(d2 + 1e-12f);
  const float u = fminf(su * k.inv_rc, 1.f);
  const float taper = u * u * u * (10.f + u * (6.f * u - 15.f));
  const float one_u = 1.f - u;
  const float dtaper =
      u < 1.f ? 30.f * u * u * one_u * one_u * (0.5f / su) * k.inv_rc : 0.f;
  const float h = exact3 - taper * smooth3;
  const float s = gx * dx + gy * dy;
  const float ps = s * gm;
  const float te = -1.5f * exact3 * ps / r2;
  const float ts = -1.5f * smooth3 * ps / q2;
  const float tt = dtaper * smooth3 * ps;
  const float k2 = 2.f * (te - tt - taper * ts);
  const float w = gm * h;
  cx += w * gx + k2 * dx;
  cy += w * gy + k2 * dy;
  e += kTargets ? te : s * h;
}

// The rows of one lane: the tile of its task in its cell's first
// min(counts[cell], cap) rows of its side. Returns false for a task past
// the list (the whole warp exits).
struct LaneRow {
  int cell, row;
  bool live;
};

__device__ __forceinline__ bool lane_row(const int* __restrict__ tile_end,
                                         const int* __restrict__ start,
                                         const int* __restrict__ counts,
                                         int n_cells, int cap, int n_rows,
                                         int task, int lane, LaneRow& out) {
  if (task >= tile_end[n_cells - 1]) return false;  // warp-uniform
  out.cell = find_cell(tile_end, n_cells, task, lane);
  const int n = min(counts[out.cell], cap);
  const int first = tile_end[out.cell] - (n + 31) / 32;
  const int t = (task - first) * 32 + lane;
  out.row = start[out.cell] + t;
  out.live = t < n && out.row < n_rows;
  return true;
}

template <bool kPrecise>
__global__ void __launch_bounds__(kWarps * 32)
vjp_targets_kernel(const float4* __restrict__ trows, int n_t,
                   const float4* __restrict__ srows, int n_s,
                   const int* __restrict__ start_t,
                   const int* __restrict__ counts_t,
                   const int* __restrict__ start_s,
                   const int* __restrict__ counts_s, int gc, int cap_t,
                   int cap_s, const float* __restrict__ scal,
                   const float2* __restrict__ g,
                   const int* __restrict__ tile_end,
                   float4* __restrict__ out) {
  __shared__ float4 stage_all[kWarps][kStage];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  LaneRow me;
  if (!lane_row(tile_end, start_t, counts_t, gc * gc, cap_t, n_t,
                blockIdx.x * kWarps + warp, lane, me))
    return;
  float4* stage = stage_all[warp];
  const float4 p = me.live ? trows[me.row] : make_float4(0.f, 0.f, 1.f, 0.f);
  const float2 gi = me.live ? g[me.row] : make_float2(0.f, 0.f);
  const Scalars k{scal[0] * scal[0], scal[1], scal[2]};
  const int ci = me.cell / gc;
  const int cj = me.cell - ci * gc;
  float ax = 0.f, ay = 0.f, ar = 0.f;
  for (int di = -1; di <= 1; ++di) {
    const int ni = ci + di;
    if (ni < 0 || ni >= gc) continue;  // warp-uniform
    for (int dj = -1; dj <= 1; ++dj) {
      const int nj = cj + dj;
      if (nj < 0 || nj >= gc) continue;
      const int nc = ni * gc + nj;
      const int first = start_s[nc];
      const int ns = min(min(counts_s[nc], cap_s), n_s - first);
      for (int s0 = 0; s0 < ns; s0 += kStage) {
        const int len = min(kStage, ns - s0);
        for (int q = lane; q < len; q += 32) stage[q] = srows[first + s0 + q];
        __syncwarp();
        if (me.live) {
          for (int q = 0; q < len; ++q) {
            const float4 s = stage[q];
            const float dx = s.x - p.x;
            const float dy = s.y - p.y;
            const float d2 = dx * dx + dy * dy;
            if (!(d2 < k.rc2)) continue;
            add_pair<kPrecise, true>(dx, dy, d2, p.z, s.z, gi.x, gi.y, k, ax,
                                     ay, ar);
          }
        }
        __syncwarp();
      }
    }
  }
  if (me.live) out[me.row] = make_float4(-ax, -ay, ar, 0.f);
}

template <bool kPrecise>
__global__ void __launch_bounds__(kWarps * 32)
vjp_sources_kernel(const float4* __restrict__ trows, int n_t,
                   const float4* __restrict__ srows, int n_s,
                   const int* __restrict__ start_t,
                   const int* __restrict__ counts_t,
                   const int* __restrict__ start_s,
                   const int* __restrict__ counts_s, int gc, int cap_t,
                   int cap_s, const float* __restrict__ scal,
                   const float2* __restrict__ g,
                   const int* __restrict__ tile_end,
                   float4* __restrict__ out) {
  __shared__ float4 stage_all[kWarps][kStage];   // target rows
  __shared__ float2 stage_g_all[kWarps][kStage];  // their cotangents
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  LaneRow me;
  if (!lane_row(tile_end, start_s, counts_s, gc * gc, cap_s, n_s,
                blockIdx.x * kWarps + warp, lane, me))
    return;
  float4* stage = stage_all[warp];
  float2* stage_g = stage_g_all[warp];
  const float4 p = me.live ? srows[me.row] : make_float4(0.f, 0.f, 0.f, 0.f);
  const Scalars k{scal[0] * scal[0], scal[1], scal[2]};
  const int ci = me.cell / gc;
  const int cj = me.cell - ci * gc;
  float ax = 0.f, ay = 0.f, ag = 0.f;
  for (int di = -1; di <= 1; ++di) {
    const int ni = ci + di;
    if (ni < 0 || ni >= gc) continue;  // warp-uniform
    for (int dj = -1; dj <= 1; ++dj) {
      const int nj = cj + dj;
      if (nj < 0 || nj >= gc) continue;
      const int nc = ni * gc + nj;
      const int first = start_t[nc];
      const int nt = min(min(counts_t[nc], cap_t), n_t - first);
      for (int t0 = 0; t0 < nt; t0 += kStage) {
        const int len = min(kStage, nt - t0);
        for (int q = lane; q < len; q += 32) {
          stage[q] = trows[first + t0 + q];
          stage_g[q] = g[first + t0 + q];
        }
        __syncwarp();
        if (me.live) {
          for (int q = 0; q < len; ++q) {
            const float4 t = stage[q];
            const float dx = p.x - t.x;
            const float dy = p.y - t.y;
            const float d2 = dx * dx + dy * dy;
            if (!(d2 < k.rc2)) continue;
            const float2 gt = stage_g[q];
            add_pair<kPrecise, false>(dx, dy, d2, t.z, p.z, gt.x, gt.y, k,
                                      ax, ay, ag);
          }
        }
        __syncwarp();
      }
    }
  }
  if (me.live) out[me.row] = make_float4(ax, ay, ag, 0.f);
}

using PassKernel = void (*)(const float4*, int, const float4*, int,
                            const int*, const int*, const int*, const int*,
                            int, int, int, const float*, const float2*,
                            const int*, float4*);

int launch_pass(PassKernel kernel, const void* trows, int n_t,
                const void* srows, int n_s, const void* start_t,
                const void* counts_t, const void* start_s,
                const void* counts_s, int gc, int cap_t, int cap_s,
                const void* scal, const void* g, const void* tile_end,
                int max_tasks, void* out, void* stream) {
  if (gc <= 0 || max_tasks <= 0) return static_cast<int>(cudaSuccess);
  auto i = [](const void* q) { return static_cast<const int*>(q); };
  const int grid = (max_tasks + kWarps - 1) / kWarps;
  kernel<<<grid, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(trows), n_t,
      static_cast<const float4*>(srows), n_s, i(start_t), i(counts_t),
      i(start_s), i(counts_s), gc, cap_t, cap_s,
      static_cast<const float*>(scal), static_cast<const float2*>(g),
      i(tile_end), static_cast<float4*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The target pass: out (n_t, 4) gets (d x, d y, d (r + floor), 0) for the
// first min(counts_t[c], cap_t) target rows of every cell c and must hold
// zeros elsewhere. tile_end (gc*gc int32) is the inclusive prefix sum of
// ceil(min(counts_t, cap_t) / 32); max_tasks bounds its last entry. The
// other arguments are K4's (nbody_p3m_pp) and g (n_t, 2), the cotangent of
// K4's result. Returns the launch's cudaError_t (0 on success).
extern "C" int nbody_p3m_pp_vjp_targets(
    const void* trows, int n_t, const void* srows, int n_s,
    const void* start_t, const void* counts_t, const void* start_s,
    const void* counts_s, int gc, int cap_t, int cap_s, const void* scal,
    int precise, const void* g, const void* tile_end, int max_tasks,
    void* out, void* stream) {
  return launch_pass(precise ? vjp_targets_kernel<true>
                             : vjp_targets_kernel<false>,
                     trows, n_t, srows, n_s, start_t, counts_t, start_s,
                     counts_s, gc, cap_t, cap_s, scal, g, tile_end, max_tasks,
                     out, stream);
}

// The source pass: out (n_s, 4) gets (d x, d y, d gm, 0) for the first
// min(counts_s[c], cap_s) source rows of every cell c and must hold zeros
// elsewhere; tile_end is the prefix sum of ceil(min(counts_s, cap_s) / 32).
extern "C" int nbody_p3m_pp_vjp_sources(
    const void* trows, int n_t, const void* srows, int n_s,
    const void* start_t, const void* counts_t, const void* start_s,
    const void* counts_s, int gc, int cap_t, int cap_s, const void* scal,
    int precise, const void* g, const void* tile_end, int max_tasks,
    void* out, void* stream) {
  return launch_pass(precise ? vjp_sources_kernel<true>
                             : vjp_sources_kernel<false>,
                     trows, n_t, srows, n_s, start_t, counts_t, start_s,
                     counts_s, gc, cap_t, cap_s, scal, g, tile_end, max_tasks,
                     out, stream);
}
