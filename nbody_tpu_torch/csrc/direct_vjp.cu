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
//   k = 1 / (sqrt(r2) * r2)  (precise: IEEE sqrt, divide)
//   k = inv*inv*inv, inv = rsqrt(r2)  (default)
//   f = gm_j * k;  s = g_i . d;  e = -1.5 * f * s / r2
//   c = f * g_i + 2e * d
//   d_tgt_pos_i = -sum_j c;  d_tgt_radius_i = sum_j e
//   d_src_pos_j = +sum_i c;  d_src_gm_j = sum_i k * s
// The products with s come before the division by r2, so a zero-radius
// target on a gm = 0 source at its own position (r2 = 1e-18, k = 1e27,
// s = 0) gives 0 and not 0 * inf: the softening floor keeps r2 > 0 here
// as in the forward.
//
// Two kernels, each one thread a row of its own side with the other side
// staged through shared memory, kStage rows at a time:
//   * the target pass: one thread a target, over the sources; writes
//     d_tgt_pos and d_tgt_radius;
//   * the source pass: one thread a source, over the targets; writes
//     d_src_pos and d_src_gm.
// Each thread sums its pairs in the other side's row order, a run of kRun
// (256) rows into fresh registers, then run by run into its total, as K1
// does. Few rows of one side (the P3M exact-core rows: 64 targets against
// 524,704 sources) cannot fill the card, so the wrapper's plan
// (ops/direct_forces.vjp_splits, shapes only) splits the other side into
// n_split contiguous ranges of whole runs; each block then writes its
// partial sums to a scratch, and a second kernel adds them in range order.
// No atomics: the same bits on every run.
//
// What bounds it on an H100: per pair 29 fp32 operations (an FMA as two)
// and one MUFU operation, the rsqrt (1/r2 is its square), or two when
// precise (a sqrt and a reciprocal); the bytes are O(T + S). So the bound
// is the operations (chip_smoke.py counts them). This kernel computes
// every pair twice (once a pass) and divides by r2 with an IEEE division,
// one more MUFU and its refinement. Merging the passes, more rows a
// thread, and taking 1/r2 from the rsqrt are left for later work: this is
// the simple kernel that is right.
//
// The C entry points launch on the stream they are handed, do not
// synchronise, allocate nothing, and return cudaGetLastError().

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>

#include "source_tiles.cuh"  // kBlock, kRun, kSofteningFloor

namespace {

constexpr int kStage = 1024;  // rows of the other side staged at a time
static_assert(kStage % kRun == 0, "a stage holds whole runs");

// MUFU.RSQ alone (as in direct_tiles.cuh): r2 >= 1e-18 is a normal float.
__device__ __forceinline__ float rsqrt_ftz(float x) {
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <bool kPrecise>
__device__ __forceinline__ float inv_cube(float r2) {
  if (kPrecise) return 1.f / (sqrtf(r2) * r2);
  const float inv = rsqrt_ftz(r2);
  return inv * inv * inv;
}

// The terms of one pair: c = (cx, cy), e, and k * s (see the header).
struct PairTerms {
  float cx, cy, e, ks;
};

template <bool kPrecise>
__device__ __forceinline__ PairTerms pair_terms(float dx, float dy, float soft,
                                                float gm, float gx, float gy) {
  const float r2 = dx * dx + dy * dy + soft;
  const float k = inv_cube<kPrecise>(r2);
  const float f = gm * k;
  const float s = gx * dx + gy * dy;
  const float e = -1.5f * f * s / r2;
  const float e2 = 2.f * e;
  PairTerms q;
  q.cx = f * gx + e2 * dx;
  q.cy = f * gy + e2 * dy;
  q.e = e;
  q.ks = k * s;
  return q;
}

// The range [begin, end) of the other side's n_other rows that split
// `split` of a launch sums: whole runs, runs_per_split of them.
__device__ __forceinline__ void split_range(int split, int runs_per_split,
                                            int n_other, int& begin,
                                            int& end) {
  const int span = runs_per_split * kRun;
  begin = min(split * span, n_other);
  end = min(begin + span, n_other);
}

// Writes one row's three sums: (sign * a, sign * b) and c straight to the
// outputs when the launch has one range, else to its range's partials.
__device__ __forceinline__ void write_row(int i, int n, int split, int n_split,
                                          float sign, float a, float b,
                                          float c, float2* __restrict__ out2,
                                          float* __restrict__ out1,
                                          float* __restrict__ part) {
  if (n_split == 1) {
    out2[i] = make_float2(sign * a, sign * b);
    out1[i] = c;
    return;
  }
  float* o = part + (static_cast<size_t>(split) * n + i) * 3;
  o[0] = a;
  o[1] = b;
  o[2] = c;
}

template <bool kPrecise>
__global__ void __launch_bounds__(kBlock)
vjp_targets_kernel(const float2* __restrict__ tgt_pos,
                   const float* __restrict__ tgt_radius,
                   const float2* __restrict__ src_pos,
                   const float* __restrict__ src_gm,
                   const float2* __restrict__ g, int n_tgt, int n_src,
                   int n_split, int runs_per_split,
                   float2* __restrict__ d_pos, float* __restrict__ d_radius,
                   float* __restrict__ part) {
  __shared__ float2 spos[kStage];
  __shared__ float sgm[kStage];
  const int split = blockIdx.x % n_split;
  const int first = (blockIdx.x / n_split) * kBlock;
  const int i = first + threadIdx.x;
  const bool live = i < n_tgt;
  // a warp with no real target stages sources but skips the pairs
  const bool warp_live = first + static_cast<int>(threadIdx.x & ~31u) < n_tgt;
  const float2 p = live ? tgt_pos[i] : make_float2(0.f, 0.f);
  const float soft = live ? tgt_radius[i] + kSofteningFloor : 1.f;
  const float2 gi = live ? g[i] : make_float2(0.f, 0.f);
  int begin, end;
  split_range(split, runs_per_split, n_src, begin, end);
  float ax = 0.f, ay = 0.f, ar = 0.f;
  for (int base = begin; base < end; base += kStage) {
    const int len = min(kStage, end - base);
    __syncthreads();  // every thread is done with the last stage
    for (int k = threadIdx.x; k < len; k += kBlock) {
      spos[k] = src_pos[base + k];
      sgm[k] = src_gm[base + k];
    }
    __syncthreads();
    if (!warp_live) continue;
    for (int run = 0; run < len; run += kRun) {
      const int stop = min(run + kRun, len);
      float tx = 0.f, ty = 0.f, tr = 0.f;
      for (int k = run; k < stop; ++k) {
        const float2 s = spos[k];
        const PairTerms q = pair_terms<kPrecise>(s.x - p.x, s.y - p.y, soft,
                                                 sgm[k], gi.x, gi.y);
        tx += q.cx;
        ty += q.cy;
        tr += q.e;
      }
      ax += tx;
      ay += ty;
      ar += tr;
    }
  }
  if (live)
    write_row(i, n_tgt, split, n_split, -1.f, ax, ay, ar, d_pos, d_radius,
              part);
}

template <bool kPrecise>
__global__ void __launch_bounds__(kBlock)
vjp_sources_kernel(const float2* __restrict__ tgt_pos,
                   const float* __restrict__ tgt_radius,
                   const float2* __restrict__ src_pos,
                   const float* __restrict__ src_gm,
                   const float2* __restrict__ g, int n_tgt, int n_src,
                   int n_split, int runs_per_split,
                   float2* __restrict__ d_pos, float* __restrict__ d_gm,
                   float* __restrict__ part) {
  __shared__ float4 stgt[kStage];  // x, y, r + floor, g.x
  __shared__ float sgy[kStage];    // g.y
  const int split = blockIdx.x % n_split;
  const int first = (blockIdx.x / n_split) * kBlock;
  const int j = first + threadIdx.x;
  const bool live = j < n_src;
  const bool warp_live = first + static_cast<int>(threadIdx.x & ~31u) < n_src;
  const float2 sp = live ? src_pos[j] : make_float2(0.f, 0.f);
  const float gm = live ? src_gm[j] : 0.f;
  int begin, end;
  split_range(split, runs_per_split, n_tgt, begin, end);
  float ax = 0.f, ay = 0.f, ag = 0.f;
  for (int base = begin; base < end; base += kStage) {
    const int len = min(kStage, end - base);
    __syncthreads();
    for (int k = threadIdx.x; k < len; k += kBlock) {
      const int i = base + k;
      const float2 tp = tgt_pos[i];
      const float2 gi = g[i];
      stgt[k] = make_float4(tp.x, tp.y, tgt_radius[i] + kSofteningFloor, gi.x);
      sgy[k] = gi.y;
    }
    __syncthreads();
    if (!warp_live) continue;
    for (int run = 0; run < len; run += kRun) {
      const int stop = min(run + kRun, len);
      float tx = 0.f, ty = 0.f, tg = 0.f;
      for (int k = run; k < stop; ++k) {
        const float4 t = stgt[k];
        const PairTerms q = pair_terms<kPrecise>(sp.x - t.x, sp.y - t.y, t.z,
                                                 gm, t.w, sgy[k]);
        tx += q.cx;
        ty += q.cy;
        tg += q.ks;
      }
      ax += tx;
      ay += ty;
      ag += tg;
    }
  }
  if (live)
    write_row(j, n_src, split, n_split, 1.f, ax, ay, ag, d_pos, d_gm, part);
}

// out2[i] = sign * (sum of the partials' a, sum of b), out1[i] = sum of c,
// the partials of the n_split ranges added in range order.
__global__ void __launch_bounds__(kBlock)
sum_vjp_partials(const float* __restrict__ part, int n, int n_split,
                 float sign, float2* __restrict__ out2,
                 float* __restrict__ out1) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float a = 0.f, b = 0.f, c = 0.f;
  for (int k = 0; k < n_split; ++k) {
    const float* p = part + (static_cast<size_t>(k) * n + i) * 3;
    a += p[0];
    b += p[1];
    c += p[2];
  }
  out2[i] = make_float2(sign * a, sign * b);
  out1[i] = c;
}

using PassKernel = void (*)(const float2*, const float*, const float2*,
                            const float*, const float2*, int, int, int, int,
                            float2*, float*, float*);

// One pass over n_own rows of its own side against n_other rows, split into
// n_split ranges of the other side; then, if split, the in-order sum.
cudaError_t launch_pass(PassKernel kernel, int n_own, int n_other,
                        const void* tgt_pos, const void* tgt_radius,
                        const void* src_pos, const void* src_gm,
                        const void* g, int n_tgt, int n_src, int n_split,
                        void* partial, float sign, void* out2, void* out1,
                        void* stream) {
  if (n_tgt <= 0 || n_src <= 0) return cudaSuccess;  // outputs stay zero
  if (n_split < 1 || (n_split > 1 && partial == nullptr))
    return cudaErrorInvalidValue;
  const long long blocks =
      static_cast<long long>((n_own + kBlock - 1) / kBlock) * n_split;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  const int runs = (n_other + kRun - 1) / kRun;
  const int runs_per_split = (runs + n_split - 1) / n_split;
  auto st = static_cast<cudaStream_t>(stream);
  auto* o2 = static_cast<float2*>(out2);
  auto* o1 = static_cast<float*>(out1);
  auto* part = static_cast<float*>(partial);
  kernel<<<static_cast<unsigned>(blocks), kBlock, 0, st>>>(
      static_cast<const float2*>(tgt_pos),
      static_cast<const float*>(tgt_radius),
      static_cast<const float2*>(src_pos), static_cast<const float*>(src_gm),
      static_cast<const float2*>(g), n_tgt, n_src, n_split, runs_per_split,
      o2, o1, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return err;
  sum_vjp_partials<<<(n_own + kBlock - 1) / kBlock, kBlock, 0, st>>>(
      part, n_own, n_split, sign, o2, o1);
  return cudaGetLastError();
}

}  // namespace

// The target pass: d_tgt_pos (n_tgt, 2) and d_tgt_radius (n_tgt,) of the
// VJP of the force on n_tgt targets from n_src sources with cotangent g
// (n_tgt, 2). Device pointers to contiguous fp32 arrays: tgt_pos (n_tgt, 2),
// tgt_radius (n_tgt,), src_pos (n_src, 2), src_gm (n_src,). n_split source
// ranges of whole 256-source runs; with n_split > 1, partial holds
// (n_split, n_tgt, 3) floats of scratch. The outputs must hold zeros when
// n_tgt or n_src is 0 (nothing is launched then). Returns the launches'
// cudaError_t (0 on success).
extern "C" int nbody_direct_vjp_targets(const void* tgt_pos,
                                        const void* tgt_radius,
                                        const void* src_pos,
                                        const void* src_gm, const void* g,
                                        int n_tgt, int n_src, int precise,
                                        int n_split, void* partial,
                                        void* d_tgt_pos, void* d_tgt_radius,
                                        void* stream) {
  return static_cast<int>(launch_pass(
      precise ? vjp_targets_kernel<true> : vjp_targets_kernel<false>, n_tgt,
      n_src, tgt_pos, tgt_radius, src_pos, src_gm, g, n_tgt, n_src, n_split,
      partial, -1.f, d_tgt_pos, d_tgt_radius, stream));
}

// The source pass: d_src_pos (n_src, 2) and d_src_gm (n_src,), with the
// inputs of the target pass; n_split target ranges, partial (n_split,
// n_src, 3) floats when n_split > 1.
extern "C" int nbody_direct_vjp_sources(const void* tgt_pos,
                                        const void* tgt_radius,
                                        const void* src_pos,
                                        const void* src_gm, const void* g,
                                        int n_tgt, int n_src, int precise,
                                        int n_split, void* partial,
                                        void* d_src_pos, void* d_src_gm,
                                        void* stream) {
  return static_cast<int>(launch_pass(
      precise ? vjp_sources_kernel<true> : vjp_sources_kernel<false>, n_src,
      n_tgt, tgt_pos, tgt_radius, src_pos, src_gm, g, n_tgt, n_src, n_split,
      partial, 1.f, d_src_pos, d_src_gm, stream));
}
