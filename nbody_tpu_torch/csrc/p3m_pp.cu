// P3M short-range pair correction over packed cell blocks, for NVIDIA
// Hopper (sm_90a).
//
// Replaces the TPU kernel nbody_tpu/ops/p3m_pallas.py::_pp_kernel (grid over
// rows of cells, nine VMEM-resident (cap_t, cap_s) tiles per cell). Inputs
// are cell blocks: targets tx, ty, tr (gc, gc, cap_t) and sources sx, sy,
// sg (gc, gc, cap_s), fp32, contiguous. tr already holds radius + 1e-18.
// For each target slot of cell (i, j) and each source slot of the 3x3
// neighbour cells (i+di, j+dj), di, dj in {-1, 0, 1}, cells outside the grid
// contributing nothing:
//   dx = sx - tx;  dy = sy - ty;  d2 = dx*dx + dy*dy
//   exact3  = (d2 + tr)^(-3/2),  smooth3 = (d2 + eps2)^(-3/2)
//             (rsqrt cubed, or 1 / (sqrt(r2) * r2) when precise)
//   u = min(sqrt(d2 + 1e-12) * inv_rc, 1);  taper = u^3 (10 + u (6u - 15))
//   w = gm * (exact3 - taper * smooth3)  if d2 < rc*rc, else 0
//   out = sum (w*dx, w*dy)           -> (gc*gc, cap_t, 2)
// The scalars (rc, eps2, 1/rc) arrive in a 3-float device array, as the
// TPU kernel reads them from SMEM, so the caller never waits for the host;
// 1/rc is formed in fp32 as the TPU kernel's caller forms it
// (p3m_pallas.py:126-127).
//
// Occupancy: with counts_t, a cell with no targets writes zeros and
// returns, and target slots at or beyond the cell's count write zero. With
// counts_s, only a neighbour cell's first counts_s slots are read (the
// rest hold gm = 0 and would add exactly zero). Without them every slot is
// computed: the semantics of the JAX pp_blocks.
//
// What bounds it on an H100: per live pair (d2 < rc^2) about 14 fp32
// operations and 3 MUFU operations (two rsqrt and a sqrt; p3m_pallas.py
// counts the same). Galaxy scenes leave most slots empty, so at the main
// path's occupancy the live pairs' arithmetic weighs less than the bytes:
// the live slots read once and the dense (gc^2, cap_t, 2) output, which
// every slot writes. The design is the simple one: one block per target
// cell, the nine neighbour cells staged one at a time through shared
// memory as (x, y, gm) triples, threads striding over the target slots with
// fp32 accumulators in registers. Pairs at d2 >= rc^2 are skipped before
// any transcendental. wgmma, TMA, occupancy tuning, and a layout that does
// not pack dense blocks at all are later work.
//
// The C entry point launches on the stream it is handed, does not
// synchronise, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;   // threads per block (target slots in flight)
constexpr int kStage = 1024;    // source slots staged per pass (12 KB)

template <bool kPrecise>
__global__ void __launch_bounds__(kThreads)
p3m_pp_kernel(const float* __restrict__ tx, const float* __restrict__ ty,
              const float* __restrict__ tr, const float* __restrict__ sx,
              const float* __restrict__ sy, const float* __restrict__ sg,
              const int* __restrict__ counts_t,
              const int* __restrict__ counts_s, int gc, int cap_t,
              int cap_s, const float* __restrict__ scal,
              float2* __restrict__ out) {
  __shared__ float3 stage[kStage];

  const int cell = blockIdx.x;
  const int ci = cell / gc;
  const int cj = cell - ci * gc;
  const size_t tbase = static_cast<size_t>(cell) * cap_t;
  const int nt = counts_t ? min(counts_t[cell], cap_t) : cap_t;
  // Slots past the count (all of them in an empty cell) are zero.
  for (int t = nt + threadIdx.x; t < cap_t; t += kThreads)
    out[tbase + t] = make_float2(0.f, 0.f);
  if (nt == 0) return;

  const float rc = scal[0], eps2 = scal[1], inv_rc = scal[2];
  const float rc2 = rc * rc;
  for (int t0 = 0; t0 < nt; t0 += kThreads) {
    const int t = t0 + threadIdx.x;
    const bool live = t < nt;
    const float px = live ? tx[tbase + t] : 0.f;
    const float py = live ? ty[tbase + t] : 0.f;
    const float pr = live ? tr[tbase + t] : 1.f;
    float ax = 0.f, ay = 0.f;
    for (int di = -1; di <= 1; ++di) {
      const int ni = ci + di;
      if (ni < 0 || ni >= gc) continue;       // block-uniform
      for (int dj = -1; dj <= 1; ++dj) {
        const int nj = cj + dj;
        if (nj < 0 || nj >= gc) continue;     // block-uniform
        const int nc = ni * gc + nj;
        const size_t sbase = static_cast<size_t>(nc) * cap_s;
        const int ns = counts_s ? min(counts_s[nc], cap_s) : cap_s;
        for (int s0 = 0; s0 < ns; s0 += kStage) {
          const int len = min(kStage, ns - s0);
          for (int k = threadIdx.x; k < len; k += kThreads)
            stage[k] = make_float3(sx[sbase + s0 + k], sy[sbase + s0 + k],
                                   sg[sbase + s0 + k]);
          __syncthreads();
          if (live) {
            for (int k = 0; k < len; ++k) {
              const float3 s = stage[k];
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
                const float inv = rsqrtf(d2 + pr);
                exact3 = inv * inv * inv;
                const float invq = rsqrtf(d2 + eps2);
                smooth3 = invq * invq * invq;
              }
              const float u = fminf(sqrtf(d2 + 1e-12f) * inv_rc, 1.f);
              const float taper = u * u * u * (10.f + u * (6.f * u - 15.f));
              const float w = s.z * (exact3 - taper * smooth3);
              ax += w * dx;
              ay += w * dy;
            }
          }
          __syncthreads();
        }
      }
    }
    if (live) out[tbase + t] = make_float2(ax, ay);
  }
}

}  // namespace

// Pair correction of every target slot of the (gc, gc, cap_t) blocks
// against the sources of its 3x3 neighbour cells in the (gc, gc, cap_s)
// blocks; out is (gc*gc, cap_t, 2). scal holds (rc, eps2, 1/rc) fp32.
// counts_t and counts_s (gc*gc int32 each) may be NULL. Pointers are
// device pointers to contiguous arrays. Returns the launch's cudaError_t
// (0 on success).
extern "C" int nbody_p3m_pp(const void* tx, const void* ty, const void* tr,
                            const void* sx, const void* sy, const void* sg,
                            const void* counts_t, const void* counts_s,
                            int gc, int cap_t, int cap_s, const void* scal,
                            int precise, void* out, void* stream) {
  if (gc <= 0 || cap_t <= 0) return static_cast<int>(cudaSuccess);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  const auto* ct = static_cast<const int*>(counts_t);
  const auto* cs = static_cast<const int*>(counts_s);
  auto* o = static_cast<float2*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const int grid = gc * gc;
  if (precise)
    p3m_pp_kernel<true><<<grid, kThreads, 0, st>>>(
        f(tx), f(ty), f(tr), f(sx), f(sy), f(sg), ct, cs, gc, cap_t, cap_s,
        f(scal), o);
  else
    p3m_pp_kernel<false><<<grid, kThreads, 0, st>>>(
        f(tx), f(ty), f(tr), f(sx), f(sy), f(sg), ct, cs, gc, cap_t, cap_s,
        f(scal), o);
  return static_cast<int>(cudaGetLastError());
}
