// The VJP of the direct-sum force (force_acc), for NVIDIA Hopper (sm_90a).
//
// Replaces the backward of nbody_tpu/ops/pallas_forces.py's
// make_differentiable_acc, which re-derives the adjoint of the jnp direct
// sum at backward time (jax.vjp of forces.direct_sum_acc) and leaves it to
// XLA: the backward of K1/K2 (_substep_kernel, _stream_kernel) on the
// rollout's path. The forward stays direct_forces.cu.
//
// Math, for the pair (target i, source j) with the cotangent g_i of a_i:
//   d = (dx, dy) = p_j - p_i;  r2 = dx*dx + dy*dy + (r_i + 1e-18)
//   k = 1 / (sqrt(r2) * r2), 1/r2 = k * sqrt(r2)  (precise: IEEE sqrt and
//       one IEEE reciprocal)
//   k = inv*inv*inv, 1/r2 = inv*inv, inv = rsqrt(r2)  (default)
//   f = gm_j * k;  s = g_i . d;  e = -1.5 * (f * s) / r2
//   c = f * g_i + 2e * d
//   d_tgt_pos_i = -sum_j c;  d_tgt_radius_i = sum_j e
//   d_src_pos_j = +sum_i c;  d_src_gm_j = sum_i k * s
// The product f * s comes before the factor 1/r2, so a zero-radius target
// on a gm = 0 source at its own position (r2 = 1e-18, k = 1e27, s = 0)
// gives 0 and not 0 * inf: the softening floor keeps r2 > 0 as in the
// forward.
//
// What bounds it on an H100: the issue rate. The function needs 29 fp32
// operations a pair (an FMA as two) and one MUFU (rsqrt) or two (precise);
// its bytes are O(T + S). Two passes (one thread a target, then one
// thread a source) would compute each pair's terms twice. This design
// computes each pair once:
//   * one "own" side sits in registers, P rows a thread (P = 4 past one
//     tile of 512 rows, strided by the block), and the other side is
//     staged through shared memory one run of kRun = 256 rows at a time;
//     the own side is the larger one (the targets at N=65536, the sources
//     for the P3M exact-core rows: 64 targets against 524,704 sources);
//   * each own row sums its three terms run by run in the other side's
//     order, as K1 does;
//   * each other row's three terms are summed over the block's own rows in
//     a fixed order: a thread's P rows, then over the warp by a
//     reduce-scatter of __shfl_xor_sync for a batch of 8 rows (27
//     shuffles; an all-reduce of each row's sums took 120, and on sm_90 a
//     shuffle issues at a quarter of the fp32 rate: that form bound the
//     kernel at 5.77 ms precise, 3.76 rsqrt), then the warps in warp order
//     through shared memory. Each block writes one partial a row of the
//     other side for its tile of own rows;
//   * a second kernel adds the tiles' partials in a fixed tree (32 groups
//     of consecutive tiles, each in tile order, then the groups in order),
//     and likewise the own side's partials when its other side is split
//     into n_split ranges (ops/direct_forces.vjp_plan, from shapes alone,
//     so a recomputed backward under remat repeats its bits).
// No atomics: the same bits on every run. Scratch: (tiles, 3, other rows)
// fp32, 25 MB at T=65536, S=32833 (64 tiles). On an H100 the pair loop is
// 29.8 SASS instructions a pair in rsqrt mode and 55.7 precise (the IEEE
// sqrt and reciprocal, in their .ftz forms, which give the same bits
// here), P = 4: 2.52 ms and 4.70 ms at N=65536 (PERF.md §6).
//
// The C entry point launches on the stream it is handed, does not
// synchronise, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>

#include "source_tiles.cuh"  // kBlock, kRun, kSofteningFloor
#include "warp_reduce.cuh"   // kBatch, reduce_scatter

namespace {

constexpr int kWarps = kBlock / 32;
constexpr int kStage = kRun;  // other rows staged at a time: one run
static_assert(kStage == kBlock, "a thread stages one row");
static_assert(kStage % kBatch == 0, "a stage holds whole batches");
constexpr int kGroups = 32;   // tile groups of the partials' reduction

// MUFU.RSQ alone (as in direct_tiles.cuh): r2 >= 1e-18 is a normal float.
__device__ __forceinline__ float rsqrt_ftz(float x) {
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// IEEE round-to-nearest sqrt and reciprocal without the subnormal paths:
// r2 >= 1e-18, sqrt(r2) >= 1e-9, their product >= 1e-27 and its
// reciprocal <= 1e27 are all normal floats, where these give sqrtf's and
// 1.f / x's bits (a correctly rounded result is unique).
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

// The terms of one pair: c = (cx, cy), e, and k * s (see the header).
struct PairTerms {
  float cx, cy, e, ks;
};

template <bool kPrecise>
__device__ __forceinline__ PairTerms pair_terms(float dx, float dy, float soft,
                                                float gm, float gx, float gy) {
  const float r2 = dx * dx + dy * dy + soft;
  float k, inv_r2;
  if (kPrecise) {
    const float root = sqrt_rn_ftz(r2);
    k = rcp_rn_ftz(root * r2);
    inv_r2 = k * root;
  } else {
    const float inv = rsqrt_ftz(r2);
    inv_r2 = inv * inv;
    k = inv_r2 * inv;
  }
  const float f = gm * k;
  const float s = gx * dx + gy * dy;
  const float e = (f * s) * (-1.5f * inv_r2);
  const float e2 = e + e;
  PairTerms q;
  q.cx = f * gx + e2 * dx;
  q.cy = f * gy + e2 * dy;
  q.e = e;
  q.ks = k * s;
  return q;
}

// One pass over the pairs of a tile of own rows and one range of the
// other side's rows. kOwnTargets: the own rows are targets (x, y, soft,
// g) and the staged rows sources (x, y, gm); else the reverse. A block
// (tile, split) is blockIdx.x = tile * n_split + split.
template <bool kOwnTargets, int P, bool kPrecise>
__global__ void __launch_bounds__(kBlock, 2)
vjp_kernel(const float2* __restrict__ tgt_pos,
           const float* __restrict__ tgt_radius,
           const float2* __restrict__ src_pos,
           const float* __restrict__ src_gm, const float2* __restrict__ g,
           int n_tgt, int n_src, int n_split, int runs_per_split,
           float* __restrict__ own_part, float* __restrict__ other_part,
           float2* __restrict__ own_out2, float* __restrict__ own_out1) {
  __shared__ float4 st4[kStage];  // other rows: (x, y, gm, 0) or
  __shared__ float st1[kStage];   // (x, y, soft, gx) and gy
  __shared__ float wsum[3][kWarps][kStage];
  const int n_own = kOwnTargets ? n_tgt : n_src;
  const int n_other = kOwnTargets ? n_src : n_tgt;
  const int split = blockIdx.x % n_split;
  const int tile = blockIdx.x / n_split;
  const int first = tile * (P * kBlock);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // warps with a real row form a prefix of the block (row q of a thread is
  // first + q * kBlock + threadIdx.x)
  const int live_warps = min(kWarps, (n_own - first + 31) / 32);
  const bool warp_live = warp < live_warps;

  // own rows; past the end a stand-in whose terms are all zero (a target
  // with g = 0 and soft 1, a source with gm = 0)
  float ox[P], oy[P], oa[P], ogx[P], ogy[P];
#pragma unroll
  for (int q = 0; q < P; ++q) {
    const int i = first + q * kBlock + threadIdx.x;
    const bool in = i < n_own;
    if (kOwnTargets) {
      const float2 p = in ? tgt_pos[i] : make_float2(0.f, 0.f);
      const float2 gi = in ? g[i] : make_float2(0.f, 0.f);
      ox[q] = p.x;
      oy[q] = p.y;
      oa[q] = in ? tgt_radius[i] + kSofteningFloor : 1.f;
      ogx[q] = gi.x;
      ogy[q] = gi.y;
    } else {
      const float2 p = in ? src_pos[i] : make_float2(0.f, 0.f);
      ox[q] = p.x;
      oy[q] = p.y;
      oa[q] = in ? src_gm[i] : 0.f;
      ogx[q] = ogy[q] = 0.f;
    }
  }

  const int span = runs_per_split * kRun;
  const int begin = min(split * span, n_other);
  const int end = min(begin + span, n_other);
  float tot[P][3];
#pragma unroll
  for (int q = 0; q < P; ++q) tot[q][0] = tot[q][1] = tot[q][2] = 0.f;

  for (int base = begin; base < end; base += kStage) {
    const int len = min(kStage, end - base);
    __syncthreads();  // the last stage and its sums are read
    {
      const int j = base + threadIdx.x;
      const bool in = threadIdx.x < len;
      if (kOwnTargets) {
        const float2 p = in ? src_pos[j] : make_float2(0.f, 0.f);
        st4[threadIdx.x] = make_float4(p.x, p.y, in ? src_gm[j] : 0.f, 0.f);
      } else {
        const float2 p = in ? tgt_pos[j] : make_float2(0.f, 0.f);
        const float2 gj = in ? g[j] : make_float2(0.f, 0.f);
        st4[threadIdx.x] = make_float4(
            p.x, p.y, in ? tgt_radius[j] + kSofteningFloor : 1.f, gj.x);
        st1[threadIdx.x] = gj.y;
      }
    }
    __syncthreads();
    if (warp_live) {
      float run[P][3];
#pragma unroll
      for (int q = 0; q < P; ++q) run[q][0] = run[q][1] = run[q][2] = 0.f;
#pragma unroll 1
      for (int at = 0; at < len; at += kBatch) {
        float v[3 * kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const float4 r = st4[at + u];
          const float ry = kOwnTargets ? 0.f : st1[at + u];
          v[3 * u] = v[3 * u + 1] = v[3 * u + 2] = 0.f;
#pragma unroll
          for (int q = 0; q < P; ++q) {
            if (kOwnTargets) {
              const PairTerms t = pair_terms<kPrecise>(
                  r.x - ox[q], r.y - oy[q], oa[q], r.z, ogx[q], ogy[q]);
              run[q][0] += t.cx;
              run[q][1] += t.cy;
              run[q][2] += t.e;
              v[3 * u] += t.cx;
              v[3 * u + 1] += t.cy;
              v[3 * u + 2] += t.ks;
            } else {
              const PairTerms t = pair_terms<kPrecise>(
                  ox[q] - r.x, oy[q] - r.y, r.z, oa[q], r.w, ry);
              run[q][0] += t.cx;
              run[q][1] += t.cy;
              run[q][2] += t.ks;
              v[3 * u] += t.cx;
              v[3 * u + 1] += t.cy;
              v[3 * u + 2] += t.e;
            }
          }
        }
        float sums[3];
        reduce_scatter(v, lane, sums);
        if ((lane & 3) == 0) {
          const int u = scattered_row(lane);
          wsum[0][warp][at + u] = sums[0];
          wsum[1][warp][at + u] = sums[1];
          wsum[2][warp][at + u] = sums[2];
        }
      }
#pragma unroll
      for (int q = 0; q < P; ++q) {
        tot[q][0] += run[q][0];
        tot[q][1] += run[q][1];
        tot[q][2] += run[q][2];
      }
    }
    __syncthreads();  // every warp's sums of this stage are written
    if (threadIdx.x < len) {
      float a = 0.f, b = 0.f, c = 0.f;
      for (int w = 0; w < live_warps; ++w) {
        a += wsum[0][w][threadIdx.x];
        b += wsum[1][w][threadIdx.x];
        c += wsum[2][w][threadIdx.x];
      }
      float* o = other_part + static_cast<size_t>(tile) * 3 * n_other + base +
                 threadIdx.x;
      o[0] = a;
      o[n_other] = b;
      o[2 * static_cast<size_t>(n_other)] = c;
    }
  }

  const float sign = kOwnTargets ? -1.f : 1.f;
#pragma unroll
  for (int q = 0; q < P; ++q) {
    const int i = first + q * kBlock + threadIdx.x;
    if (i >= n_own) continue;
    if (n_split == 1) {
      own_out2[i] = make_float2(sign * tot[q][0], sign * tot[q][1]);
      own_out1[i] = tot[q][2];
    } else {
      float* o = own_part + static_cast<size_t>(split) * 3 * n_own + i;
      o[0] = tot[q][0];
      o[n_own] = tot[q][1];
      o[2 * static_cast<size_t>(n_own)] = tot[q][2];
    }
  }
}

// out2[r] = sign * (a, b), out1[r] = c, with (a, b, c) the sums of the
// n_parts partials (n_parts, 3, n_rows) of row r: kGroups groups of
// consecutive parts, each summed in part order, then the groups in order.
// A block is 32 rows (threadIdx.x) by kGroups groups (threadIdx.y).
__global__ void __launch_bounds__(32 * kGroups)
sum_partials(const float* __restrict__ part, int n_parts, int n_rows,
             float sign, float2* __restrict__ out2, float* __restrict__ out1) {
  __shared__ float red[3][kGroups][33];
  const int r = blockIdx.x * 32 + threadIdx.x;
  const int grp = threadIdx.y;
  const int per = (n_parts + kGroups - 1) / kGroups;
  const int p0 = min(grp * per, n_parts);
  const int p1 = min(p0 + per, n_parts);
  float a = 0.f, b = 0.f, c = 0.f;
  if (r < n_rows) {
    for (int p = p0; p < p1; ++p) {
      const float* x = part + static_cast<size_t>(p) * 3 * n_rows + r;
      a += x[0];
      b += x[n_rows];
      c += x[2 * static_cast<size_t>(n_rows)];
    }
  }
  red[0][grp][threadIdx.x] = a;
  red[1][grp][threadIdx.x] = b;
  red[2][grp][threadIdx.x] = c;
  __syncthreads();
  if (grp != 0 || r >= n_rows) return;
  a = b = c = 0.f;
  for (int k = 0; k < kGroups; ++k) {
    a += red[0][k][threadIdx.x];
    b += red[1][k][threadIdx.x];
    c += red[2][k][threadIdx.x];
  }
  out2[r] = make_float2(sign * a, sign * b);
  out1[r] = c;
}

using PassKernel = void (*)(const float2*, const float*, const float2*,
                            const float*, const float2*, int, int, int, int,
                            float*, float*, float2*, float*);

template <bool kOwnTargets>
PassKernel pick(int p, bool precise) {
  if (p == 1)
    return precise ? vjp_kernel<kOwnTargets, 1, true>
                   : vjp_kernel<kOwnTargets, 1, false>;
  if (p == 2)
    return precise ? vjp_kernel<kOwnTargets, 2, true>
                   : vjp_kernel<kOwnTargets, 2, false>;
  return precise ? vjp_kernel<kOwnTargets, 4, true>
                 : vjp_kernel<kOwnTargets, 4, false>;
}

cudaError_t launch_sum(const float* part, int n_parts, int n_rows, float sign,
                       void* out2, void* out1, cudaStream_t st) {
  sum_partials<<<(n_rows + 31) / 32, dim3(32, kGroups), 0, st>>>(
      part, n_parts, n_rows, sign, static_cast<float2*>(out2),
      static_cast<float*>(out1));
  return cudaGetLastError();
}

}  // namespace

// The VJP of the force on n_tgt targets from n_src sources with cotangent
// g (n_tgt, 2): d_tgt_pos (n_tgt, 2), d_tgt_radius (n_tgt,), d_src_pos
// (n_src, 2), d_src_gm (n_src,). Device pointers to contiguous fp32
// arrays: tgt_pos (n_tgt, 2), tgt_radius (n_tgt,), src_pos (n_src, 2),
// src_gm (n_src,). The plan: own_targets (the own side, in registers, is
// the targets, else the sources), p (1, 2 or 4) own rows a thread, n_split
// ranges of whole 256-row runs of the other side. Scratch: other_part
// (tiles, 3, n_other) floats, tiles = ceil(n_own / (256 p)); own_part
// (n_split, 3, n_own) floats when n_split > 1, else NULL. The outputs must
// hold zeros when n_tgt or n_src is 0 (nothing is launched then). Returns
// the launches' cudaError_t (0 on success).
extern "C" int nbody_direct_vjp(const void* tgt_pos, const void* tgt_radius,
                                const void* src_pos, const void* src_gm,
                                const void* g, int n_tgt, int n_src,
                                int precise, int own_targets, int p,
                                int n_split, void* own_part, void* other_part,
                                void* d_tgt_pos, void* d_tgt_radius,
                                void* d_src_pos, void* d_src_gm,
                                void* stream) {
  if (n_tgt <= 0 || n_src <= 0) return 0;  // outputs stay zero
  const int n_own = own_targets ? n_tgt : n_src;
  const int n_other = own_targets ? n_src : n_tgt;
  if ((p != 1 && p != 2 && p != 4) || n_split < 1 || other_part == nullptr ||
      (n_split > 1 && own_part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (n_own + p * kBlock - 1) / (p * kBlock);
  const long long blocks = static_cast<long long>(tiles) * n_split;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const int runs = (n_other + kRun - 1) / kRun;
  const int runs_per_split = (runs + n_split - 1) / n_split;
  auto st = static_cast<cudaStream_t>(stream);
  void* own2 = own_targets ? d_tgt_pos : d_src_pos;
  void* own1 = own_targets ? d_tgt_radius : d_src_gm;
  void* oth2 = own_targets ? d_src_pos : d_tgt_pos;
  void* oth1 = own_targets ? d_src_gm : d_tgt_radius;
  PassKernel kernel = own_targets ? pick<true>(p, precise != 0)
                                  : pick<false>(p, precise != 0);
  auto* opart = static_cast<float*>(own_part);
  auto* xpart = static_cast<float*>(other_part);
  kernel<<<static_cast<unsigned>(blocks), kBlock, 0, st>>>(
      static_cast<const float2*>(tgt_pos),
      static_cast<const float*>(tgt_radius),
      static_cast<const float2*>(src_pos), static_cast<const float*>(src_gm),
      static_cast<const float2*>(g), n_tgt, n_src, n_split, runs_per_split,
      opart, xpart, static_cast<float2*>(own2), static_cast<float*>(own1));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_sum(xpart, tiles, n_other, own_targets ? 1.f : -1.f, oth2,
                   oth1, st);
  if (err != cudaSuccess || n_split == 1) return static_cast<int>(err);
  return static_cast<int>(launch_sum(opart, n_split, n_own,
                                     own_targets ? -1.f : 1.f, own2, own1,
                                     st));
}
