// Force only with Newton's third law over the massive prefix, for NVIDIA
// Hopper (sm_90a).
//
// Replaces the TPU kernel scripts/ablations/tune_r2h.py::make_newton ->
// kernel (K5h). Targets are (4, T) rows x; y; r; gm, sources (4, S) rows
// x; y; gm; r, and the first M = mass_len target rows are the first M
// source rows (the massive prefix). With W the tile width and
// m_full = M / W whole massive tiles, every (target, source) pair is
// counted exactly once. The work of a target tile is a list of items:
//   * massive tile I < m_full: item 0 forward over its own tile
//     [IW, (I+1)W); item e in [1, m_full - I) the dual block of tiles I
//     and J = I + e, whose dx, dy and d2 give both the forward force on I
//     (target radius, source gm) and the reverse force on J (source
//     radius, target gm); then the tail [m_full W, S) (the ragged massive
//     remainder and the gm = 0 rows) forward, W sources an item;
//   * every other tile (rows from m_full W to T, the ragged massive rows
//     among them): item e forward over the run [eW, (e+1)W) of [0, S).
// The TPU kernel carried the reverse sums from one sequential grid step
// to the next in VMEM, and it assumed that the massive tiles fill whole
// source chunks: at other shapes it counts part of the massive sources
// twice and others never (ROADMAP).
//
// The schedule is a task list made from shapes alone
// (ops/newton_forces.newton_plan): a task is `group` consecutive items of
// one tile, run by a block of 256 threads, the heaviest tasks first; the
// plan gives a task's tile and first item, the rest follows from them. The
// block is 512 / W teams of W / 2 threads; a team holds the tile's W
// targets, two a thread (strided by W / 2), and walks items e0 + team,
// e0 + team + teams, ... on a double-buffered cp.async stage of its own.
// Nothing is carried from block to block, and no sum is made by atomics:
//   * a dual item's reverse sums go to R[I, j] (the (m_full, m_full W)
//     float2 scratch row of tile I), one write per source;
//   * a massive task sums its forward terms per team (each item in fresh
//     registers, then added to the team's total) and the teams in team
//     order into a slot of its own, F[first item / group, i];
//   * a forward-only item writes its run's sum to P[e, i].
// A second kernel adds, for each massive row i of tile I, F[0..] in slot
// order and then R[0..I-1, i] in order of I; for each other row, P[0..]
// in run order from 0: runs of W sources, each summed into fresh registers
// in source order, then added to the total, the association the rows had
// before the task list, so their bits are unchanged. The same bits on
// every run.
//
// The dual step, with no cross-lane butterfly: a warp holds 64 targets
// and walks the tile's sources in batches of 32. At step k of a batch,
// lane l pairs its two targets with source (l + k) mod 32 (the stage
// holds each batch twice, so that read is one 16-byte load at a constant
// offset) and adds both reverse terms to the running sum of that source,
// which it then hands on to lane l - 1 (__shfl_sync): after 32 steps lane
// l holds the warp's sum for source l - 1, added in a fixed order. The
// team's warps then add their sums in warp order through shared memory.
// Both rsqrt of a dual pair and the forward pairs are pair_step.cuh's
// unguarded rsqrt_ftz (r2 >= 1e-18 is normal: the source radius or the
// target radius plus 1e-18); the forward items run pair_step.cuh's
// add_runs at runs of W on its 8-source batch layout.
//
// What bounds it on an H100: the issue rate. A dual pair costs about
// sixteen fp32 instructions and two MUFU.RSQ for two interactions, plus
// one SHFL a pair (two a source step of two targets); a forward pair ten
// fp32 and one MUFU. The MUFU work is that of the plain direct sum (one
// rsqrt an interaction); the reverse force is softened by the source's
// radius, so it cannot share the forward rsqrt. The scratch (R, F and
// P) is written once and read once by the second kernel.
//
// The C entry point launches on the stream it is handed, does not
// synchronise, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstddef>

#include "pair_step.cuh"     // Pairs, rsqrt_ftz, stage_rows, add_runs,
                             // cp_async
#include "source_tiles.cuh"  // kSofteningFloor, allow_smem

namespace {

constexpr int kThreads = 256;  // a block: 512 / W teams of W / 2 threads

// Shapes that both kernels read.
struct Shape {
  int n_tgt, n_src;
  int m_full;  // whole massive tiles
  int n_tail;  // forward items of a massive tile past its dual blocks
  int n_runs;  // forward items of another tile: runs of W over [0, S)
  int group;   // items a task
};

// An item of tile `tile`: forward (dual false) over [lo, lo + len), or the
// dual block with source tile [lo, lo + W).
struct Item {
  bool dual;
  int lo, len;
};

template <int W>
__device__ __forceinline__ Item item_of(int tile, int e, const Shape& sh) {
  if (tile < sh.m_full) {
    const int n_dual = sh.m_full - 1 - tile;
    if (e == 0) return {false, tile * W, W};
    if (e <= n_dual) return {true, (tile + e) * W, W};
    const int lo = (sh.m_full + e - 1 - n_dual) * W;
    return {false, lo, min(W, sh.n_src - lo)};
  }
  return {false, e * W, min(W, sh.n_src - e * W)};
}

// Where copy d (0, 1) of source j of a dual stage lies: batch j / 32 holds
// (x, y, gm, r + 1e-18) of its 32 sources, then the same again.
__device__ __forceinline__ int dual_at(int j, int d) {
  return ((j / 32) * 64 + d * 32 + j % 32) * 4;
}

// The team's thread u issues the copies of sources u and u + W / 2 of the
// dual tile at `base`, both copies, one group.
template <int W>
__device__ __forceinline__ void stage_dual(const float* __restrict__ src,
                                           int n_src, int base, float* st,
                                           int u) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = u + h * (W / 2);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float* g = src + static_cast<size_t>(r) * n_src + base + j;
      cp_async<4>(st + dual_at(j, 0) + r, g);
      cp_async<4>(st + dual_at(j, 1) + r, g);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// After its copies have landed, thread u adds the softening floor to the
// radii it copied.
template <int W>
__device__ __forceinline__ void soften_dual(float* st, int u) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = u + h * (W / 2);
    st[dual_at(j, 0) + 3] += kSofteningFloor;
    st[dual_at(j, 1) + 3] += kSofteningFloor;
  }
}

template <int W>
__device__ __forceinline__ void stage_item(const Item& it,
                                           const float* __restrict__ src,
                                           int n_src, float* st, bool vec16,
                                           int u) {
  if (it.dual)
    stage_dual<W>(src, n_src, it.lo, st, u);
  else
    stage_rows(src, n_src, it.lo, it.len, st, vec16, u, W / 2);
}

// A bar.sync of the team's W / 2 threads (barrier 1 + team; __syncthreads
// is barrier 0).
__device__ __forceinline__ void team_sync(int team, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(team + 1), "r"(threads) : "memory");
}

// The dual block of the warp's 64 targets (t, their gm) with the W sources
// staged at st: the forward sums added to (fx, fy) once the tile is done,
// the warp's reverse sum of each source to rev_w[j].
template <int W>
__device__ __forceinline__ void dual_tile(const float* st,
                                          const Pairs<2, 1, false>& t,
                                          const float (&gm)[2], float (&fx)[2],
                                          float (&fy)[2], float2* rev_w,
                                          int lane) {
  const int from = (lane + 1) & 31;
  const float4* batch = reinterpret_cast<const float4*>(st) + lane;
  float tx[2] = {0.f, 0.f}, ty[2] = {0.f, 0.f};
#pragma unroll 1
  for (int b = 0; b < W / 32; ++b, batch += 64) {
    float rx = 0.f, ry = 0.f;  // the running sum of source (lane + k) % 32
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      const float4 s = batch[k];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float dx = s.x - t.x[q];
        const float dy = s.y - t.y[q];
        const float d2 = dx * dx + dy * dy;
        const float inv = rsqrt_ftz(d2 + t.soft[q]);
        const float f = s.z * (inv * inv * inv);
        tx[q] += dx * f;
        ty[q] += dy * f;
        const float invr = rsqrt_ftz(d2 + s.w);
        const float fr = gm[q] * (invr * invr * invr);
        rx -= dx * fr;
        ry -= dy * fr;
      }
      if (k < 31) {
        rx = __shfl_sync(0xffffffffu, rx, from);
        ry = __shfl_sync(0xffffffffu, ry, from);
      }
    }
    rev_w[b * 32 + ((lane + 31) & 31)] = make_float2(rx, ry);
  }
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    fx[q] += tx[q];
    fy[q] += ty[q];
  }
}

template <int W>
__global__ void __launch_bounds__(kThreads, W == 512 ? 3 : 4)
newton_kernel(const float* __restrict__ tgt, const float* __restrict__ src,
              const int2* __restrict__ plan, Shape sh, int vec16,
              float2* __restrict__ rev_sums, float2* __restrict__ part_m,
              float2* __restrict__ part_f) {
  constexpr int kTeamThreads = W / 2;
  constexpr int kTeams = kThreads / kTeamThreads;
  constexpr int kStage = 8 * W;  // floats: a dual tile (W float4, twice)
  extern __shared__ float4 newton_smem[];
  float* const smem = reinterpret_cast<float*>(newton_smem);
  const int team = threadIdx.x / kTeamThreads;
  const int u = threadIdx.x % kTeamThreads;
  const int lane = threadIdx.x & 31;
  float* const stage = smem + team * 2 * kStage;
  // (kTeamThreads / 32, W) warp sums of a dual item, a team's
  float2* const rev = reinterpret_cast<float2*>(smem + kTeams * 2 * kStage) +
                      team * (kTeamThreads / 32) * W;
  const int2 task = plan[blockIdx.x];
  const int tile = task.x, e0 = task.y;
  const bool massive = tile < sh.m_full;
  const int e1 = min(e0 + sh.group,
                     massive ? sh.m_full - tile + sh.n_tail : sh.n_runs);
  const int n = sh.n_tgt;
  const int mw = sh.m_full * W;
  Pairs<2, 1, false> t;
  float gm[2], fx[2] = {0.f, 0.f}, fy[2] = {0.f, 0.f};
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    // A target past the last takes a finite stand-in.
    const int i = tile * W + u + q * kTeamThreads;
    const bool live = i < n;
    t.x[q] = live ? tgt[i] : 0.f;
    t.y[q] = live ? tgt[n + i] : 0.f;
    t.soft[q] = live ? tgt[2 * n + i] + kSofteningFloor : 1.f;
    gm[q] = live ? tgt[3 * n + i] : 0.f;
  }
  int e = e0 + team;
  if (e < e1)
    stage_item<W>(item_of<W>(tile, e, sh), src, sh.n_src, stage, vec16, u);
  int at = 0;  // offset of the stage that holds item e
  for (; e < e1; e += kTeams) {
    const Item it = item_of<W>(tile, e, sh);
    cp_async_wait_all();
    if (it.dual) soften_dual<W>(stage + at, u);
    // item e is in; the team is done with the other stage and with rev
    team_sync(team, kTeamThreads);
    if (e + kTeams < e1)
      stage_item<W>(item_of<W>(tile, e + kTeams, sh), src, sh.n_src,
                    stage + kStage - at, vec16, u);
    if (it.dual) {
      dual_tile<W>(stage + at, t, gm, fx, fy, rev + (u / 32) * W, lane);
      team_sync(team, kTeamThreads);
      float2* row = rev_sums + static_cast<size_t>(tile) * mw + it.lo;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = u + h * kTeamThreads;
        float2 r = rev[j];
#pragma unroll
        for (int w = 1; w < kTeamThreads / 32; ++w) {
          const float2 o = rev[w * W + j];
          r.x += o.x;
          r.y += o.y;
        }
        row[j] = r;
      }
    } else if (massive) {
      add_runs<2, false, W>(stage + at, it.len, t, fx, fy);
    } else {
      float ax[2] = {0.f, 0.f}, ay[2] = {0.f, 0.f};
      add_runs<2, false, W>(stage + at, it.len, t, ax, ay);
      float2* run = part_f + static_cast<size_t>(e) * (n - mw);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int i = tile * W + u + q * kTeamThreads;
        if (i < n) run[i - mw] = make_float2(ax[q], ay[q]);
      }
    }
    at = kStage - at;
  }
  if (!massive) return;
  float2* out = part_m + static_cast<size_t>(e0 / sh.group) * mw + tile * W + u;
  if constexpr (kTeams > 1) {
    // the teams' forward sums, added in team order
    float4* const sums = reinterpret_cast<float4*>(smem + kTeams * 2 * kStage);
    __syncthreads();
    sums[threadIdx.x] = make_float4(fx[0], fy[0], fx[1], fy[1]);
    __syncthreads();
    if (team != 0) return;
#pragma unroll
    for (int k = 1; k < kTeams; ++k) {
      const float4 o = sums[k * kTeamThreads + u];
      fx[0] += o.x;
      fy[0] += o.y;
      fx[1] += o.z;
      fy[1] += o.w;
    }
  }
  out[0] = make_float2(fx[0], fy[0]);
  out[kTeamThreads] = make_float2(fx[1], fy[1]);
}

// out (2, T): for a massive row i of tile I, F[0..] in slot order, then
// R[0..I-1, i] in order of I; for another row, P[0..] in run order.
__global__ void __launch_bounds__(256)
newton_reduce_kernel(const float2* __restrict__ rev_sums,
                     const float2* __restrict__ part_m,
                     const float2* __restrict__ part_f, Shape sh, int w,
                     float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= sh.n_tgt) return;
  const int mw = sh.m_full * w;
  float ax = 0.f, ay = 0.f;
  if (i < mw) {
    const int tile = i / w;
    const int slots = (sh.m_full - tile + sh.n_tail + sh.group - 1) / sh.group;
    for (int k = 0; k < slots; ++k) {
      const float2 p = part_m[static_cast<size_t>(k) * mw + i];
      ax += p.x;
      ay += p.y;
    }
    for (int k = 0; k < tile; ++k) {
      const float2 r = rev_sums[static_cast<size_t>(k) * mw + i];
      ax += r.x;
      ay += r.y;
    }
  } else {
    const int rows = sh.n_tgt - mw;
    for (int k = 0; k < sh.n_runs; ++k) {
      const float2 p = part_f[static_cast<size_t>(k) * rows + i - mw];
      ax += p.x;
      ay += p.y;
    }
  }
  out[i] = ax;
  out[sh.n_tgt + i] = ay;
}

template <int W>
cudaError_t launch(const float* tgt, const float* src, const int2* plan,
                   int n_tasks, const Shape& sh, float2* rev_sums,
                   float2* part_m, float2* part_f, float* out,
                   cudaStream_t st) {
  constexpr int kTeams = kThreads / (W / 2);
  // two stages a team, then the teams' warp sums
  const size_t smem =
      static_cast<size_t>(kTeams) * (2 * 8 * W + (W / 64) * W * 2) *
      sizeof(float);
  cudaError_t err = allow_smem(newton_kernel<W>, smem);
  if (err != cudaSuccess) return err;
  const int vec16 = sh.n_src % 4 == 0 &&
                    reinterpret_cast<size_t>(src) % 16 == 0;
  if (n_tasks > 0) {
    newton_kernel<W><<<n_tasks, kThreads, smem, st>>>(
        tgt, src, plan, sh, vec16, rev_sums, part_m, part_f);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  newton_reduce_kernel<<<(sh.n_tgt + 255) / 256, 256, 0, st>>>(
      rev_sums, part_m, part_f, sh, W, out);
  return cudaGetLastError();
}

}  // namespace

// out (2, n_tgt) = (ax; ay) on the (4, n_tgt) targets x; y; r; gm from the
// (4, n_src) sources x; y; gm; r, rsqrt path, where the first mass_len
// rows of both are the same particles (mass_len <= n_src, mass_len <=
// n_tgt). tile: 128, 256 or 512; plan: n_tasks int2 (tile, first item, a
// multiple of group), each task `group` items or the tile's last ones, as
// ops/newton_forces.newton_plan makes them. scratch: scratch_len float2,
// at least R (m_full, m_full tile) when m_full >= 2, then F
// (ceil((m_full + n_tail) / group), m_full tile), then P (n_runs, n_tgt -
// m_full tile), with m_full = mass_len / tile, n_tail = ceil((n_src -
// m_full tile) / tile) and n_runs = ceil(n_src / tile). Device pointers to
// contiguous arrays. Returns the cudaError_t of the launches (0 on
// success).
extern "C" int nbody_newton_forces(const void* tgt, const void* src,
                                   int n_tgt, int n_src, int mass_len,
                                   int tile, const void* plan, int n_tasks,
                                   int group, void* scratch,
                                   long long scratch_len, void* out,
                                   void* stream) {
  if (n_tgt <= 0) return static_cast<int>(cudaSuccess);
  if (mass_len < 0 || mass_len > n_src || mass_len > n_tgt || n_tasks < 0 ||
      group < 1 || (tile != 128 && tile != 256 && tile != 512))
    return static_cast<int>(cudaErrorInvalidValue);
  Shape sh;
  sh.n_tgt = n_tgt;
  sh.n_src = n_src;
  sh.m_full = mass_len / tile;
  const long long mw = static_cast<long long>(sh.m_full) * tile;
  sh.n_tail = static_cast<int>((n_src - mw + tile - 1) / tile);
  sh.n_runs = (n_src + tile - 1) / tile;
  sh.group = group;
  const long long n_rev = sh.m_full >= 2 ? sh.m_full * mw : 0;
  const long long n_part_m =
      sh.m_full > 0 ? (sh.m_full + sh.n_tail + group - 1) / group * mw : 0;
  const long long n_part_f = static_cast<long long>(sh.n_runs) * (n_tgt - mw);
  if (scratch_len < n_rev + n_part_m + n_part_f)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* t = static_cast<const float*>(tgt);
  const auto* s = static_cast<const float*>(src);
  const auto* p = static_cast<const int2*>(plan);
  auto* rev = static_cast<float2*>(scratch);
  float2* part_m = rev + n_rev;
  float2* part_f = part_m + n_part_m;
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (tile) {
    case 128: err = launch<128>(t, s, p, n_tasks, sh, rev, part_m, part_f, o, st); break;
    case 256: err = launch<256>(t, s, p, n_tasks, sh, rev, part_m, part_f, o, st); break;
    default: err = launch<512>(t, s, p, n_tasks, sh, rev, part_m, part_f, o, st); break;
  }
  return static_cast<int>(err);
}
