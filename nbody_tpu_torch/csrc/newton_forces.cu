// Force only with Newton's third law over the massive prefix, for NVIDIA
// Hopper (sm_90a).
//
// Replaces the TPU kernel scripts/ablations/tune_r2h.py::make_newton ->
// kernel (K5h). Targets are (4, T) rows x; y; r; gm, sources (4, S) rows
// x; y; gm; r, and the first M = mass_len target rows are the first M
// source rows (the massive prefix). With W the tile width and
// m_full = M / W whole massive tiles, every (target, source) pair is
// counted exactly once:
//   * massive tile I < m_full: forward over its own tile [IW, (I+1)W);
//     for every J in (I, m_full) the dual block of tiles I and J, whose
//     dx, dy and d2 give both the forward force on I (target radius,
//     source gm) and the reverse force on J (source radius, target gm);
//     forward over the tail [m_full W, S) (the ragged massive remainder
//     and the gm = 0 rows); plus the reverse sums that tiles I' < I left
//     for it;
//   * every other tile (rows from m_full W to T, the ragged massive rows
//     among them): forward over [0, S).
// The TPU kernel carried the reverse sums from one sequential grid step
// to the next in VMEM, and it assumed that the massive tiles fill whole
// source chunks: at other shapes it counts part of the massive sources
// twice and others never (ROADMAP). Here blocks run at once, so the
// reverse sums of tile I land in a scratch row of their own,
// R[I, j] for j in tiles J > I ((m_full, m_full W) float2, 33.5 MB at
// N=65536 with W = 256), and a second kernel adds R[0..I-1, i] to target
// i in order of I. No atomics: the same bits on every run.
//
// Inside a dual block a thread holds its target and walks the staged
// source tile J in batches of 32. For each batch it keeps the 32 reverse
// terms it made (one per source) in registers; a butterfly reduce-scatter
// over the warp's lanes (31 shuffles and adds per component) leaves lane
// l with the warp's sum for source l; the warps' sums go to shared memory
// and are added in warp order.
//
// Load balance: the dual work is triangular (tile 0 meets m_full - 1
// tiles, the last none), so block b < ceil(m_full / 2) runs the heavy
// tile b and then the light tile m_full - 1 - b: each such block does
// m_full - 1 dual blocks. Those blocks come first in the grid, the
// forward-only tiles after them.
//
// What bounds it on an H100: a dual pair costs about sixteen fp32
// instructions and two MUFU rsqrt for two interactions, against ten and
// one for a forward pair; the reverse force is softened by the source's
// radius, so it cannot share the forward rsqrt. The MUFU work stays that
// of the plain direct sum (one rsqrt per interaction); only about a fifth
// of the fp32 work of the dual pairs, a tenth of the whole at M = T / 2,
// is saved.
//
// The C entry point launches on the stream it is handed, does not
// synchronise, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>

#include "source_tiles.cuh"  // kSofteningFloor, pair_factor, allow_smem

namespace {

// One step of the reduce-scatter: the lane keeps the half of v[0, 2 kOff)
// that its bit kOff selects, adds the partner lane's copy of that half, and
// moves it to v[0, kOff). Template parameters keep every index static, so
// v stays in registers.
template <int kOff>
__device__ __forceinline__ void reduce_scatter_step(float (&v)[32], int lane) {
  const bool upper = lane & kOff;
#pragma unroll
  for (int k = 0; k < kOff; ++k) {
    const float send = upper ? v[k] : v[k + kOff];
    const float keep = upper ? v[k + kOff] : v[k];
    v[k] = keep + __shfl_xor_sync(0xffffffffu, send, kOff);
  }
}

// Lane l of the warp returns the sum over the warp's lanes of their v[l]
// (a butterfly reduce-scatter; the order of the adds is fixed).
__device__ __forceinline__ float reduce_scatter32(float (&v)[32]) {
  const int lane = threadIdx.x & 31;
  reduce_scatter_step<16>(v, lane);
  reduce_scatter_step<8>(v, lane);
  reduce_scatter_step<4>(v, lane);
  reduce_scatter_step<2>(v, lane);
  reduce_scatter_step<1>(v, lane);
  return v[0];
}

// Adds to (ax, ay) the forward force on the target at p from sources
// [lo, hi) of the (4, n_src) rows, staged W at a time by the whole block.
template <int W>
__device__ void forward_range(float2 p, float soft,
                              const float* __restrict__ src, int n_src,
                              int lo, int hi, float4* stage, float& ax,
                              float& ay) {
  for (int base = lo; base < hi; base += W) {
    const int len = min(W, hi - base);
    if (static_cast<int>(threadIdx.x) < len) {
      const int j = base + threadIdx.x;
      stage[threadIdx.x] =
          make_float4(src[j], src[n_src + j], src[2 * n_src + j], 0.f);
    }
    __syncthreads();
    float tx = 0.f, ty = 0.f;
#pragma unroll 8
    for (int k = 0; k < len; ++k) {
      const float4 s = stage[k];
      const float dx = s.x - p.x;
      const float dy = s.y - p.y;
      const float f = pair_factor<false>(s.z, dx * dx + dy * dy + soft);
      tx += dx * f;
      ty += dy * f;
    }
    ax += tx;
    ay += ty;
    __syncthreads();
  }
}

// Massive tile I: its own tile and the tail forward, the dual blocks with
// tiles J > I (reverse sums to scratch row I), the forward sum to out.
template <int W>
__device__ void newton_tile(int I, int m_full, const float* __restrict__ tgt,
                            const float* __restrict__ src, int n_tgt,
                            int n_src, float4* stage, float2* rev,
                            float2* __restrict__ scratch,
                            float* __restrict__ out) {
  const int i = I * W + threadIdx.x;  // < m_full W <= M <= T
  const float2 p = make_float2(tgt[i], tgt[n_tgt + i]);
  const float soft = tgt[2 * n_tgt + i] + kSofteningFloor;
  const float tgm = tgt[3 * n_tgt + i];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int width = m_full * W;
  float2* row = scratch + static_cast<size_t>(I) * width;
  float ax = 0.f, ay = 0.f;
  forward_range<W>(p, soft, src, n_src, I * W, (I + 1) * W, stage, ax, ay);
  for (int J = I + 1; J < m_full; ++J) {
    const int j = J * W + threadIdx.x;
    stage[threadIdx.x] = make_float4(src[j], src[n_src + j],
                                     src[2 * n_src + j],
                                     src[3 * n_src + j] + kSofteningFloor);
    __syncthreads();
    float tx = 0.f, ty = 0.f;
    for (int b = 0; b < W / 32; ++b) {
      float rx[32], ry[32];
#pragma unroll
      for (int k = 0; k < 32; ++k) {
        const float4 s = stage[b * 32 + k];
        const float dx = s.x - p.x;
        const float dy = s.y - p.y;
        const float d2 = dx * dx + dy * dy;
        const float f = pair_factor<false>(s.z, d2 + soft);
        tx += dx * f;
        ty += dy * f;
        const float fr = pair_factor<false>(tgm, d2 + s.w);
        rx[k] = -dx * fr;
        ry[k] = -dy * fr;
      }
      const float sx = reduce_scatter32(rx);
      const float sy = reduce_scatter32(ry);
      rev[warp * W + b * 32 + lane] = make_float2(sx, sy);
    }
    ax += tx;
    ay += ty;
    __syncthreads();
    float2 r = rev[threadIdx.x];
#pragma unroll
    for (int w = 1; w < W / 32; ++w) {
      const float2 q = rev[w * W + threadIdx.x];
      r.x += q.x;
      r.y += q.y;
    }
    row[j] = r;
  }
  forward_range<W>(p, soft, src, n_src, width, n_src, stage, ax, ay);
  out[i] = ax;
  out[n_tgt + i] = ay;
}

template <int W>
__global__ void __launch_bounds__(W)
newton_kernel(const float* __restrict__ tgt, const float* __restrict__ src,
              int n_tgt, int n_src, int m_full, int n_pair,
              float2* __restrict__ scratch, float* __restrict__ out) {
  __shared__ float4 stage[W];
  extern __shared__ float2 rev[];  // (W / 32, W) warp sums of one dual block
  const int b = blockIdx.x;
  if (b < n_pair) {
    newton_tile<W>(b, m_full, tgt, src, n_tgt, n_src, stage, rev, scratch,
                   out);
    if (m_full - 1 - b != b)
      newton_tile<W>(m_full - 1 - b, m_full, tgt, src, n_tgt, n_src, stage,
                     rev, scratch, out);
    return;
  }
  const int i = (m_full + b - n_pair) * W + threadIdx.x;
  const bool live = i < n_tgt;
  // Threads past the last target still stage sources.
  const float2 p = live ? make_float2(tgt[i], tgt[n_tgt + i])
                        : make_float2(0.f, 0.f);
  const float soft = live ? tgt[2 * n_tgt + i] + kSofteningFloor : 1.f;
  float ax = 0.f, ay = 0.f;
  forward_range<W>(p, soft, src, n_src, 0, n_src, stage, ax, ay);
  if (live) {
    out[i] = ax;
    out[n_tgt + i] = ay;
  }
}

// out[., i] += sum over I' < I of scratch[I', i], in order of I', for the
// rows i of massive tile I = i / W.
__global__ void __launch_bounds__(256)
newton_reduce_kernel(const float2* __restrict__ scratch, int m_full, int w,
                     int n_tgt, float* __restrict__ out) {
  const int width = m_full * w;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= width) return;
  float ax = out[i], ay = out[n_tgt + i];
  for (int I = 0; I < i / w; ++I) {
    const float2 r = scratch[static_cast<size_t>(I) * width + i];
    ax += r.x;
    ay += r.y;
  }
  out[i] = ax;
  out[n_tgt + i] = ay;
}

template <int W>
cudaError_t launch(const float* tgt, const float* src, int n_tgt, int n_src,
                   int m_full, float2* scratch, float* out,
                   cudaStream_t st) {
  const size_t smem = static_cast<size_t>(W / 32) * W * sizeof(float2);
  cudaError_t err = allow_smem(newton_kernel<W>, smem);
  if (err != cudaSuccess) return err;
  const int n_pair = (m_full + 1) / 2;
  const int n_tiles = (n_tgt + W - 1) / W;
  newton_kernel<W><<<n_pair + n_tiles - m_full, W, smem, st>>>(
      tgt, src, n_tgt, n_src, m_full, n_pair, scratch, out);
  err = cudaGetLastError();
  if (err != cudaSuccess || m_full < 2) return err;
  newton_reduce_kernel<<<(m_full * W + 255) / 256, 256, 0, st>>>(
      scratch, m_full, W, n_tgt, out);
  return cudaGetLastError();
}

}  // namespace

// out (2, n_tgt) = (ax; ay) on the (4, n_tgt) targets x; y; r; gm from the
// (4, n_src) sources x; y; gm; r, rsqrt path, where the first mass_len
// rows of both are the same particles (mass_len <= n_src, mass_len <=
// n_tgt). tile: 128, 256 or 512. scratch: (m_full, m_full * tile) float2
// with m_full = mass_len / tile (unused when m_full < 2). Device pointers
// to contiguous fp32 arrays. Returns the cudaError_t of the launches (0 on
// success).
extern "C" int nbody_newton_forces(const void* tgt, const void* src,
                                   int n_tgt, int n_src, int mass_len,
                                   int tile, void* scratch, void* out,
                                   void* stream) {
  if (n_tgt <= 0) return static_cast<int>(cudaSuccess);
  if (mass_len < 0 || mass_len > n_src || mass_len > n_tgt)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* t = static_cast<const float*>(tgt);
  const auto* s = static_cast<const float*>(src);
  auto* sc = static_cast<float2*>(scratch);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const int m_full = tile > 0 ? mass_len / tile : 0;
  cudaError_t err;
  switch (tile) {
    case 128: err = launch<128>(t, s, n_tgt, n_src, m_full, sc, o, st); break;
    case 256: err = launch<256>(t, s, n_tgt, n_src, m_full, sc, o, st); break;
    case 512: err = launch<512>(t, s, n_tgt, n_src, m_full, sc, o, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
