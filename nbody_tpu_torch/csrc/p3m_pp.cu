// P3M short-range pair correction over cell-sorted particles, for NVIDIA
// Hopper (sm_90a).
//
// Replaces the TPU kernel nbody_tpu/ops/p3m_pallas.py::_pp_kernel (grid over
// rows of cells, nine VMEM-resident (cap_t, cap_s) tiles per cell). Inputs
// are the particles in cell order, as the bins sort them:
//   trows (n_t, 4) fp32: x, y, radius + 1e-18, unused;
//   srows (n_s, 4) fp32: x, y, gm, unused (heaviest first within a cell);
//   start_t, counts_t, start_s, counts_s (gc*gc int32): cell c's run is rows
//   start[c] .. start[c] + counts[c] - 1 of its side.
// Only a run's first cap rows take part: rows start[c] .. start[c] +
// min(counts[c], cap) - 1, exactly the slots of the JAX package's
// (gc, gc, cap) blocks. Each such target of cell (i, j) meets those sources
// of the 3x3 neighbour cells (i+di, j+dj), di, dj in {-1, 0, 1} (row offset
// outer), cells outside the grid contributing nothing:
//   dx = sx - tx;  dy = sy - ty;  d2 = dx*dx + dy*dy
//   exact3  = (d2 + tr)^(-3/2),  smooth3 = (d2 + eps2)^(-3/2)
//             (rsqrt cubed, or 1 / (sqrt(r2) * r2) when precise)
//   u = min(sqrt(d2 + 1e-12) * inv_rc, 1);  taper = u^3 (10 + u (6u - 15))
//   w = gm * (exact3 - taper * smooth3)  if d2 < rc*rc, else 0
//   out[row] = sum (w*dx, w*dy)          -> (n_t, 2), row in sorted order
// Rows past a cell's cap (the targets the blocks drop) are not written: the
// caller hands in a zeroed output. The scalars (rc, eps2, 1/rc) arrive in a
// 3-float device array, as the TPU kernel reads them from SMEM, so the
// caller never waits for the host; 1/rc is formed in fp32 as the TPU
// kernel's caller forms it (p3m_pallas.py:126-127).
//
// What bounds it on an H100: per pair inside rc about 14 fp32 operations and
// 3 MUFU operations (two rsqrt and a sqrt), per candidate pair 5 (dx, dy,
// d2 and the compare); in galaxy scenes about 38% of the candidates lie
// inside rc. The bytes are small: each live row read once, one (x, y) a
// target. So the bound is the MUFU term over the pairs inside rc, and what
// keeps a kernel from it is idle lanes: most cells hold a dozen targets.
// The design: a task is a tile of up to 32 targets of one cell, run by one
// warp with one target per lane, so an empty cell costs nothing and a cell
// of 12 targets keeps 12 lanes busy instead of 12 of a 128-thread block.
// The tasks are numbered cell by cell: tile_end (gc*gc int32) is the
// inclusive prefix sum of ceil(min(counts_t, cap_t) / 32), and a warp finds
// its cell by a 32-way search over it (four rounds at gc = 512). The grid
// has one warp for every task that the host-known bound allows; surplus
// warps exit at once. A warp walks the 3x3 neighbour runs in order and
// stages each run through its own slice of shared memory, 128 rows of 16
// bytes at a time (lanes load consecutive rows), so that every lane reads
// the same row (a broadcast). Pairs at d2 >= rc^2 are skipped before any
// transcendental, and the rsqrt is MUFU.RSQ alone (as in direct_tiles.cuh).
// Each target sums its pairs in the order of the parent kernel (one block
// a cell over packed blocks): neighbour order, then row order, one fp32
// accumulator a component, with the same expressions, so it gives that
// kernel's bits. The tail of the densest cells (24 tiles of ~5400 sources
// each at the N=1M slice) and the idle lanes of small cells are left for
// later work.
//
// The C entry point launches on the stream it is handed, does not
// synchronise, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;       // warps a block; each runs tasks of its own
constexpr int kStage = 128;     // source rows a warp stages per pass (2 KB)

// MUFU.RSQ alone: rsqrtf without its denormal guard, the same bits on a
// normal argument (d2 + radius + 1e-18, and d2 + eps2 for eps2 > 0).
__device__ __forceinline__ float rsqrt_ftz(float x) {
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The cell that holds task `task`: the first c with tile_end[c] > task,
// found by the warp's 32 lanes probing evenly spaced entries each round.
// Requires task < tile_end[n_cells - 1]; tile_end is non-decreasing.
__device__ __forceinline__ int find_cell(const int* __restrict__ tile_end,
                                         int n_cells, int task, int lane) {
  int lo = 0, hi = n_cells;    // the answer lies in [lo, hi)
  while (hi - lo > 1) {
    const int step = (hi - lo + 31) / 32;
    const int p = lo + lane * step;
    const bool below = p < hi && tile_end[p] <= task;
    // below holds on a prefix of the lanes: probes 0 .. m-1
    const int m = __popc(__ballot_sync(0xffffffffu, below));
    const int new_lo = m ? lo + (m - 1) * step + 1 : lo;
    hi = min(lo + m * step + 1, hi);
    lo = new_lo;
  }
  return lo;
}

template <bool kPrecise>
__global__ void __launch_bounds__(kWarps * 32)
p3m_pp_kernel(const float4* __restrict__ trows, int n_t,
              const float4* __restrict__ srows, int n_s,
              const int* __restrict__ start_t, const int* __restrict__ counts_t,
              const int* __restrict__ start_s, const int* __restrict__ counts_s,
              const int* __restrict__ tile_end, int gc, int cap_t, int cap_s,
              const float* __restrict__ scal, float2* __restrict__ out) {
  __shared__ float4 stage_all[kWarps][kStage];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int task = blockIdx.x * kWarps + warp;
  const int n_cells = gc * gc;
  if (task >= tile_end[n_cells - 1]) return;     // warp-uniform
  float4* stage = stage_all[warp];

  const int cell = find_cell(tile_end, n_cells, task, lane);
  const int nt = min(counts_t[cell], cap_t);
  const int first = tile_end[cell] - (nt + 31) / 32;   // the cell's first task
  const int t = (task - first) * 32 + lane;
  const int row = start_t[cell] + t;
  const bool live = t < nt && row < n_t;
  const float4 p = live ? trows[row] : make_float4(0.f, 0.f, 1.f, 0.f);
  const float px = p.x, py = p.y, pr = p.z;

  const float rc = scal[0], eps2 = scal[1], inv_rc = scal[2];
  const float rc2 = rc * rc;
  const int ci = cell / gc;
  const int cj = cell - ci * gc;
  float ax = 0.f, ay = 0.f;
  for (int di = -1; di <= 1; ++di) {
    const int ni = ci + di;
    if (ni < 0 || ni >= gc) continue;         // warp-uniform
    for (int dj = -1; dj <= 1; ++dj) {
      const int nj = cj + dj;
      if (nj < 0 || nj >= gc) continue;       // warp-uniform
      const int nc = ni * gc + nj;
      const int s_first = start_s[nc];
      const int ns = min(min(counts_s[nc], cap_s), n_s - s_first);
      for (int s0 = 0; s0 < ns; s0 += kStage) {
        const int len = min(kStage, ns - s0);
        for (int k = lane; k < len; k += 32) stage[k] = srows[s_first + s0 + k];
        __syncwarp();
        if (live) {
          for (int k = 0; k < len; ++k) {
            const float4 s = stage[k];
            const float dx = s.x - px;
            const float dy = s.y - py;
            const float d2 = dx * dx + dy * dy;
            if (!(d2 < rc2)) continue;
            float exact3, smooth3;
            if (kPrecise) {
              const float r2 = d2 + pr;
              exact3 = 1.f / (sqrtf(r2) * r2);
              const float q2 = d2 + eps2;
              smooth3 = 1.f / (sqrtf(q2) * q2);
            } else {
              const float inv = rsqrt_ftz(d2 + pr);
              exact3 = inv * inv * inv;
              const float invq = rsqrt_ftz(d2 + eps2);
              smooth3 = invq * invq * invq;
            }
            const float u = fminf(sqrtf(d2 + 1e-12f) * inv_rc, 1.f);
            const float taper = u * u * u * (10.f + u * (6.f * u - 15.f));
            const float w = s.z * (exact3 - taper * smooth3);
            ax += w * dx;
            ay += w * dy;
          }
        }
        __syncwarp();
      }
    }
  }
  if (live) out[row] = make_float2(ax, ay);
}

}  // namespace

// Pair correction of the first min(counts_t[c], cap_t) target rows of every
// cell c against the first min(counts_s[n], cap_s) source rows of its 3x3
// neighbour cells n; out (n_t, 2) fp32 gets one row per such target and
// must hold zeros elsewhere. tile_end (gc*gc int32) is the inclusive prefix
// sum of ceil(min(counts_t, cap_t) / 32); max_tasks bounds its last entry
// (one warp is launched per possible task). scal holds (rc, eps2, 1/rc)
// fp32. Row arrays are 16-byte aligned; every pointer is a device pointer
// to a contiguous array. Returns the launch's cudaError_t (0 on success).
extern "C" int nbody_p3m_pp(const void* trows, int n_t, const void* srows,
                            int n_s, const void* start_t,
                            const void* counts_t, const void* start_s,
                            const void* counts_s, const void* tile_end,
                            int gc, int cap_t, int cap_s, int max_tasks,
                            const void* scal, int precise, void* out,
                            void* stream) {
  if (gc <= 0 || max_tasks <= 0) return static_cast<int>(cudaSuccess);
  auto i = [](const void* q) { return static_cast<const int*>(q); };
  const auto* tr = static_cast<const float4*>(trows);
  const auto* sr = static_cast<const float4*>(srows);
  const auto* sc = static_cast<const float*>(scal);
  auto* o = static_cast<float2*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const int grid = (max_tasks + kWarps - 1) / kWarps;
  if (precise)
    p3m_pp_kernel<true><<<grid, kWarps * 32, 0, st>>>(
        tr, n_t, sr, n_s, i(start_t), i(counts_t), i(start_s), i(counts_s),
        i(tile_end), gc, cap_t, cap_s, sc, o);
  else
    p3m_pp_kernel<false><<<grid, kWarps * 32, 0, st>>>(
        tr, n_t, sr, n_s, i(start_t), i(counts_t), i(start_s), i(counts_s),
        i(tile_end), gc, cap_t, cap_s, sc, o);
  return static_cast<int>(cudaGetLastError());
}
