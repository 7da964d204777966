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
//   r2 = d2 + tr, q2 = d2 + eps2, exact3 = r2^(-3/2), smooth3 = q2^(-3/2)
//   su = sqrt(d2 + 1e-12);  u = min(su * inv_rc, 1)
//   taper = u^3 (10 + u (6u - 15)),  taper' = 30 u^2 (1 - u)^2 (0 at u = 1)
//   h = exact3 - taper * smooth3;  w = gm * h
//   s = g_i . d;  ps = s * gm
//   te = -1.5 * exact3 * ps / r2;  ts = -1.5 * smooth3 * ps / q2
//   tt = taper' * (0.5 / su) * inv_rc * smooth3 * ps
//   c = w * g_i + 2 (te - tt - taper * ts) * d
//   d_trow_i = (-sum_j c, sum_j te);  d_srow_j = (sum_i c, sum_i s * h)
// the VJP of _pp_blocks_jnp (the 1e-12 bias keeps taper' finite at d2 = 0,
// a self pair). In rsqrt mode that is three MUFU operations a pair: the
// rsqrt of r2, q2 and d2 + 1e-12, with 1/r2 and 1/q2 their squares and su
// and 0.5/su from the third. Precise mode takes exact3 and smooth3 from an
// IEEE sqrt and reciprocal each (1/r2 = exact3 * sqrt(r2), as in
// direct_vjp.cu), and su and 0.5/su from an IEEE sqrt and reciprocal.
// The products with ps come before any large factor, so a pair with s = 0
// (a self pair, or a zero-radius target on a gm = 0 source) adds 0 and
// not 0 * inf.
//
// What bounds it on an H100: per pair inside rc 55 fp32 operations (an
// FMA as two) and 3 MUFU operations; per candidate pair 5; the bytes are
// O(N). So the bound is the operations (chip_smoke.py counts them). In
// the galaxy cores a cell holds up to cap_t = 768 targets whose 3x3
// neighbourhood holds ~5400 sources: a warp a tile of 32 targets walking
// it (K4's form) makes one long task. The design:
//   * each pair once. A task is one range of at most R rows of a target
//     cell's neighbourhood (the 3x3 cells' first cap_s sources,
//     concatenated in neighbour order), run by one block of 4 warps. The
//     block stages the range once in shared memory, then walks the cell's
//     tiles of 32 targets in order, a target a lane in registers; the
//     warps take the range's batches of 8 rows in turn (warp w batches w,
//     w + 4, ...);
//   * each target sums its terms over its warp's batches in row order,
//     then the 4 warps' sums in warp order, into one partial a (target,
//     range); range 0 writes d_trows, range r > 0 slot r - 1 of part_t;
//   * each staged row's terms are summed over the warp's lanes by the
//     reduce-scatter of direct_vjp.cu (warp_reduce.cuh: 27 shuffles a
//     batch of 8 rows), then over the tiles in order in shared memory, into
//     one partial a (source row, target cell): slot d of part_s, d the
//     target cell's place among the source cell's 3x3 neighbours;
//   * a second kernel, a warp a tile of 32 rows of a cell, sums each
//     source row's slots in slot order (the target cells in order) and
//     each target row's ranges in order. No atomics on floats: the same
//     bits on every run;
//   * the ranges cut the long tasks (a block walks at most tiles * R rows
//     over its 4 warps). The plan (ops/p3m_pp.vjp_plan: each cell's
//     ranges, and one prefix sum over four lists of the cells: the ranges
//     of the cells of at least 4 tiles, those of the others, the source
//     tiles, the target tiles of the cells of more than one range) is
//     built on the device from the counts, caps and R alone; the pass's
//     blocks take tasks from a counter, the heavy cells first, so the
//     longest tasks start early. The scratch sizes come from n_t, n_s,
//     cap_s and R alone: no host sync, and a recomputed backward repeats
//     its bits.
// Stand-in rows (past a range's end, or a dead lane's target) sit at NaN,
// so no pair with them is inside rc. On an H100 the batch loop is 79.2
// SASS a warp iteration in rsqrt mode, 3 of them MUFU a pair: 1.73-1.77 ms
// a call at the N=1M slice, where the two passes of K4's form took 5.09,
// and R = 512 the fastest of 128 to 1536 (PERF.md §6).
//
// The C entry point launches on the stream it is handed, does not
// synchronise, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstddef>

#include "warp_reduce.cuh"  // kBatch, kFull, reduce_scatter, scattered_row

namespace {

constexpr int kWarps = 4;            // warps a block, sharing one task
constexpr int kThreads = kWarps * 32;
constexpr int kHood = 9;             // cells of a 3x3 neighbourhood
constexpr int kMaxRange = 1536;      // most staged rows a task (smem)

__device__ __forceinline__ float rsqrt_ftz(float x) {
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// IEEE round-to-nearest sqrt and reciprocal without the subnormal paths:
// r2 >= 1e-18, q2 >= eps2, d2 + 1e-12 and their roots and products are
// normal floats, where these give sqrtf's and 1.f / x's bits.
__device__ __forceinline__ float sqrt_rn_ftz(float x) {
  float y;
  asm("sqrt.rn.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float rcp_rn_ftz(float x) {
  float y;
  asm("rcp.rn.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// K4's search: the first cell c with ends[c] > task (ends non-decreasing,
// task < ends[n_cells - 1]): the cell of task in one list of the plan.
__device__ __forceinline__ int find_cell(const int* __restrict__ ends,
                                         int n_cells, int task, int lane) {
  int lo = 0, hi = n_cells;
  while (hi - lo > 1) {
    const int step = (hi - lo + 31) / 32;
    const int p = lo + lane * step;
    const bool below = p < hi && ends[p] <= task;
    const int m = __popc(__ballot_sync(kFull, below));
    const int new_lo = m ? lo + (m - 1) * step + 1 : lo;
    hi = min(lo + m * step + 1, hi);
    lo = new_lo;
  }
  return lo;
}

struct Args {
  const float4* trows;
  int n_t;
  const float4* srows;
  int n_s;
  const int* start_t;
  const int* counts_t;
  const int* start_s;
  const int* counts_s;
  int gc, cap_t, cap_s;
  const float* scal;     // rc, eps2, 1/rc
  const float2* g;       // (n_t, 2) cotangent
  const int* ranges;     // (gc*gc) ranges of each target cell
  const int* ends;       // (4, gc*gc) one prefix sum over the plan's lists
  int range_rows;        // R
  int* next_task;        // the task counter, 0 at launch
  float* part_t;         // (k_max - 1, 3, n_t) target partials of ranges > 0
  float* part_s;         // (3, 9, n_s) source partials a target cell
  float4* d_t;           // (n_t, 4) out, zeros at launch
  float4* d_s;           // (n_s, 4) out, zeros at launch
};

struct Scalars {
  float rc2, eps2, inv_rc;
};

// The terms of one pair with d2 < rc^2 (see the header): c = (cx, cy),
// te and s * h.
struct PairTerms {
  float cx, cy, te, sh;
};

template <bool kPrecise>
__device__ __forceinline__ PairTerms pair_terms(float dx, float dy, float d2,
                                                float tr, float gm, float gx,
                                                float gy, const Scalars& k) {
  const float r2 = d2 + tr;
  const float q2 = d2 + k.eps2;
  const float b2 = d2 + 1e-12f;
  float exact3, inv_r2, smooth3, inv_q2, su, half_inv_su;
  if (kPrecise) {
    const float root = sqrt_rn_ftz(r2);
    exact3 = rcp_rn_ftz(root * r2);
    inv_r2 = exact3 * root;
    const float root_q = sqrt_rn_ftz(q2);
    smooth3 = rcp_rn_ftz(root_q * q2);
    inv_q2 = smooth3 * root_q;
    su = sqrt_rn_ftz(b2);
    half_inv_su = 0.5f * rcp_rn_ftz(su);
  } else {
    const float inv = rsqrt_ftz(r2);
    inv_r2 = inv * inv;
    exact3 = inv_r2 * inv;
    const float inv_q = rsqrt_ftz(q2);
    inv_q2 = inv_q * inv_q;
    smooth3 = inv_q2 * inv_q;
    const float inv_b = rsqrt_ftz(b2);
    su = b2 * inv_b;
    half_inv_su = 0.5f * inv_b;
  }
  const float u = fminf(su * k.inv_rc, 1.f);
  const float taper = u * u * u * (10.f + u * (6.f * u - 15.f));
  const float one_u = 1.f - u;
  const float dtaper =
      u < 1.f ? 30.f * u * u * one_u * one_u * half_inv_su * k.inv_rc : 0.f;
  const float h = exact3 - taper * smooth3;
  const float s = gx * dx + gy * dy;
  const float ps = s * gm;
  const float te = -1.5f * (exact3 * ps) * inv_r2;
  const float ts = -1.5f * (smooth3 * ps) * inv_q2;
  const float tt = dtaper * (smooth3 * ps);
  const float k2 = 2.f * (te - tt - taper * ts);
  const float w = gm * h;
  PairTerms q;
  q.cx = w * gx + k2 * dx;
  q.cy = w * gy + k2 * dy;
  q.te = te;
  q.sh = s * h;
  return q;
}

// One task's set-up, shared by its block: the range, the target cell's
// live rows, and its 3x3 neighbour runs as one list (neighbour k's rows
// are positions off[k] .. off[k+1] - 1 of the cell's neighbourhood).
struct Task {
  int range, live_t, first_t, len;
  int start[kHood], off[kHood + 1], slot[kHood];
};

template <bool kPrecise>
__global__ void __launch_bounds__(kThreads, 4)
vjp_kernel(const Args a) {
  extern __shared__ float4 smem[];
  const int R = a.range_rows;
  float4* stage = smem;                      // R rows: x, y, gm, slot key
  float* acc = reinterpret_cast<float*>(smem + R);   // (3, R) row sums
  float4* red = reinterpret_cast<float4*>(acc + 3 * R);  // (kWarps, 32)
  __shared__ Task tk;
  __shared__ int task_id;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_cells = a.gc * a.gc;
  const int heavy = a.ends[n_cells - 1];
  const int total = a.ends[2 * n_cells - 1];
  const Scalars k{a.scal[0] * a.scal[0], a.scal[1], a.scal[2]};
  const float nan = __int_as_float(0x7fc00000);

  for (;;) {
    if (threadIdx.x == 0) task_id = atomicAdd(a.next_task, 1);
    __syncthreads();
    const int task = task_id;
    if (task >= total) return;  // block-uniform
    if (warp == 0) {
      const int* ends = task < heavy ? a.ends : a.ends + n_cells;
      const int cell = find_cell(ends, n_cells, task, lane);
      const int nr = a.ranges[cell];
      const int ci = cell / a.gc, cj = cell - ci * a.gc;
      const int ni = ci + lane / 3 - 1, nj = cj + lane % 3 - 1;
      int ns = 0, first = 0;
      if (lane < kHood && ni >= 0 && ni < a.gc && nj >= 0 && nj < a.gc) {
        const int nc = ni * a.gc + nj;
        ns = min(a.counts_s[nc], a.cap_s);
        first = a.start_s[nc];
      }
      int off = ns;  // inclusive prefix sum over the neighbours
#pragma unroll
      for (int d = 1; d < 16; d *= 2) {
        const int up = __shfl_up_sync(kFull, off, d);
        if (lane >= d) off += up;
      }
      if (lane < kHood) {
        tk.start[lane] = first;
        tk.off[lane + 1] = off;
        // the target cell's place among the source cell's neighbours
        tk.slot[lane] = (kHood - 1 - lane) * a.n_s;
      }
      const int hood = __shfl_sync(kFull, off, kHood - 1);
      if (lane == 0) {
        const int r = task - (ends[cell] - nr);
        tk.range = r;
        tk.live_t = min(a.counts_t[cell], a.cap_t);
        tk.first_t = a.start_t[cell];
        tk.len = min(R, hood - r * R);
        tk.off[0] = 0;
      }
    }
    __syncthreads();

    // stage the range's rows, and zero their sums
    const int len = tk.len;
    const int batches = (len + kBatch - 1) / kBatch;
    for (int p = threadIdx.x; p < batches * kBatch; p += kThreads) {
      float4 v = make_float4(nan, nan, 0.f, __int_as_float(-1));
      if (p < len) {
        const int i = tk.range * R + p;
        int n = 0;
        while (i >= tk.off[n + 1]) ++n;
        const int row = tk.start[n] + (i - tk.off[n]);
        if (row < a.n_s) {
          const float4 s = a.srows[row];
          v = make_float4(s.x, s.y, s.z, __int_as_float(tk.slot[n] + row));
        }
      }
      stage[p] = v;
      acc[p] = acc[R + p] = acc[2 * R + p] = 0.f;
    }
    __syncthreads();

    const int tiles = (tk.live_t + 31) / 32;
    for (int tile = 0; tile < tiles; ++tile) {
      const int tq = tile * 32 + lane;
      const int row_t = tk.first_t + tq;
      const bool live = tq < tk.live_t && row_t < a.n_t;
      float px = nan, py = nan, tr = 1.f, gx = 0.f, gy = 0.f;
      if (live) {
        const float4 t = a.trows[row_t];
        const float2 gi = a.g[row_t];
        px = t.x;
        py = t.y;
        tr = t.z;
        gx = gi.x;
        gy = gi.y;
      }
      float tx = 0.f, ty = 0.f, te = 0.f;
#pragma unroll 1
      for (int b = warp; b < batches; b += kWarps) {
        const float4* rows = stage + b * kBatch;
        float v[3 * kBatch];
        bool any = false;
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const float4 s = rows[u];
          const float dx = s.x - px;
          const float dy = s.y - py;
          const float d2 = dx * dx + dy * dy;
          v[3 * u] = v[3 * u + 1] = v[3 * u + 2] = 0.f;
          if (d2 < k.rc2) {
            const PairTerms q =
                pair_terms<kPrecise>(dx, dy, d2, tr, s.z, gx, gy, k);
            any = true;
            v[3 * u] = q.cx;
            v[3 * u + 1] = q.cy;
            v[3 * u + 2] = q.sh;
            tx += q.cx;
            ty += q.cy;
            te += q.te;
          }
        }
        if (__any_sync(kFull, any)) {  // else every sum of the batch is 0
          float sums[3];
          reduce_scatter(v, lane, sums);
          if ((lane & 3) == 0) {
            const int p = b * kBatch + scattered_row(lane);
            acc[p] += sums[0];
            acc[R + p] += sums[1];
            acc[2 * R + p] += sums[2];
          }
        }
      }
      red[warp * 32 + lane] = make_float4(tx, ty, te, 0.f);
      __syncthreads();
      if (warp == 0 && live) {
        float4 s = red[lane];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) {
          const float4 o = red[w * 32 + lane];
          s.x += o.x;
          s.y += o.y;
          s.z += o.z;
        }
        if (tk.range == 0) {
          a.d_t[row_t] = make_float4(-s.x, -s.y, s.z, 0.f);
        } else {
          float* o = a.part_t +
                     static_cast<size_t>(tk.range - 1) * 3 * a.n_t + row_t;
          o[0] = -s.x;
          o[a.n_t] = -s.y;
          o[2 * static_cast<size_t>(a.n_t)] = s.z;
        }
      }
      __syncthreads();  // red and the tile's sums are read
    }

    // one partial a (staged row, this target cell)
    const size_t plane = static_cast<size_t>(kHood) * a.n_s;
    for (int p = threadIdx.x; p < len; p += kThreads) {
      const int key = __float_as_int(stage[p].w);
      if (key < 0) continue;
      a.part_s[key] = acc[p];
      a.part_s[plane + key] = acc[R + p];
      a.part_s[2 * plane + key] = acc[2 * R + p];
    }
    __syncthreads();  // the stage is read before the next task's
  }
}

// The fixed-order sums of the partials, a warp a tile of 32 rows of one
// cell, warps taking tiles w, w + (the grid's warps), ...: list 2 of the
// plan numbers the source cells' tiles, list 3 the target tiles of the
// cells of more than one range. Source row q < min(counts_s, cap_s) of a
// cell gets the sum of its slots d = 0..8 in order, over the neighbour
// target cells in the grid that hold targets (the others' slots are not
// written); a target row gets range 0's partial (in d_t) plus ranges 1..
// in order.
__global__ void __launch_bounds__(kThreads)
sum_kernel(const Args a) {
  const int lane = threadIdx.x & 31;
  const int n_cells = a.gc * a.gc;
  const int first = a.ends[2 * n_cells - 1];
  const int mid = a.ends[3 * n_cells - 1];
  const int total = a.ends[4 * n_cells - 1];
  const size_t plane = static_cast<size_t>(kHood) * a.n_s;
  for (int tile = first + blockIdx.x * kWarps + (threadIdx.x >> 5);
       tile < total; tile += gridDim.x * kWarps) {  // warp-uniform
    const bool sources = tile < mid;
    const int* ends = a.ends + (sources ? 2 : 3) * n_cells;
    const int c = find_cell(ends, n_cells, tile, lane);
    const int live = sources ? min(a.counts_s[c], a.cap_s)
                             : min(a.counts_t[c], a.cap_t);
    const int q = (tile - (ends[c] - (live + 31) / 32)) * 32 + lane;
    if (sources) {
      const int ci = c / a.gc, cj = c - ci * a.gc;
      const int ti = ci + lane / 3 - 1, tj = cj + lane % 3 - 1;
      const bool read = lane < kHood && ti >= 0 && ti < a.gc && tj >= 0 &&
                        tj < a.gc && a.counts_t[ti * a.gc + tj] > 0;
      const unsigned mask = __ballot_sync(kFull, read);
      const int row = a.start_s[c] + q;
      if (q >= live || row >= a.n_s) continue;
      float x = 0.f, y = 0.f, z = 0.f;
#pragma unroll
      for (int d = 0; d < kHood; ++d) {
        if (!(mask >> d & 1)) continue;
        const float* p = a.part_s + static_cast<size_t>(d) * a.n_s + row;
        x += p[0];
        y += p[plane];
        z += p[2 * plane];
      }
      a.d_s[row] = make_float4(x, y, z, 0.f);
    } else {
      const int row = a.start_t[c] + q;
      if (q >= live || row >= a.n_t) continue;
      float4 s = a.d_t[row];
      const int nr = a.ranges[c];
      for (int r = 1; r < nr; ++r) {
        const float* p =
            a.part_t + static_cast<size_t>(r - 1) * 3 * a.n_t + row;
        s.x += p[0];
        s.y += p[a.n_t];
        s.z += p[2 * static_cast<size_t>(a.n_t)];
      }
      a.d_t[row] = s;
    }
  }
}

}  // namespace

// The VJP of K4 on runs of rows with cotangent g (n_t, 2): d_t (n_t, 4)
// gets (d x, d y, d (r + floor), 0) for the first min(counts_t[c], cap_t)
// target rows of every cell c, d_s (n_s, 4) (d x, d y, d gm, 0) for the
// first min(counts_s[c], cap_s) source rows; both must hold zeros at the
// call (other rows stay so). The plan (ops/p3m_pp.vjp_plan): ranges
// (gc*gc int32), each target cell's ranges of at most range_rows rows of
// its neighbourhood (0 without live targets); ends (4 * gc*gc int32), the
// inclusive prefix sum over four lists of the cells: ranges of the heavy
// cells, ranges of the others, ceil(min(counts_s, cap_s) / 32), and
// ceil(min(counts_t, cap_t) / 32) where ranges > 1. next_task: one int32
// holding 0. Scratch: part_t ((k_max - 1) * 3 * n_t floats, k_max the most
// ranges a cell can have), part_s (27 * n_s floats). The other arguments
// are K4's (nbody_p3m_pp). Returns the launches' cudaError_t (0 on
// success).
extern "C" int nbody_p3m_pp_vjp(
    const void* trows, int n_t, const void* srows, int n_s,
    const void* start_t, const void* counts_t, const void* start_s,
    const void* counts_s, int gc, int cap_t, int cap_s, const void* scal,
    int precise, const void* g, const void* ranges, const void* ends,
    int range_rows, void* next_task, void* part_t, void* part_s, void* d_t,
    void* d_s, void* stream) {
  if (gc <= 0 || n_t <= 0 || n_s <= 0) return 0;  // outputs stay zero
  if (range_rows < kBatch || range_rows % kBatch || range_rows > kMaxRange)
    return static_cast<int>(cudaErrorInvalidValue);
  auto i = [](const void* q) { return static_cast<const int*>(q); };
  const Args a{static_cast<const float4*>(trows), n_t,
               static_cast<const float4*>(srows), n_s, i(start_t),
               i(counts_t), i(start_s), i(counts_s), gc, cap_t, cap_s,
               static_cast<const float*>(scal), static_cast<const float2*>(g),
               i(ranges), i(ends), range_rows, static_cast<int*>(next_task),
               static_cast<float*>(part_t), static_cast<float*>(part_s),
               static_cast<float4*>(d_t), static_cast<float4*>(d_s)};
  auto kernel = precise ? vjp_kernel<true> : vjp_kernel<false>;
  const size_t smem = static_cast<size_t>(range_rows) * (16 + 12) +
                      kThreads * 16;
  int dev = 0, sms = 0, per_sm = 0, sum_per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&sum_per_sm,
                                                        sum_kernel, kThreads,
                                                        0);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto st = static_cast<cudaStream_t>(stream);
  kernel<<<max(1, sms * per_sm), kThreads, smem, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_kernel<<<max(1, sms * sum_per_sm), kThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}
