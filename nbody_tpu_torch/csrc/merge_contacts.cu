// Contact search of the collision merge pass for NVIDIA Hopper (sm_90a).
//
// Replaces the XLA-fused tile pass `one_tile` of
// nbody_tpu/ops/collisions.py:75 (no Pallas kernel there: XLA fuses each
// 512-row tile into one O(M^2) mask pass). For every live row i of the
// massive prefix it finds the heaviest live row j in contact that beats i:
//
//   contact(i, j) = |p_i - p_j|^2 < (factor * (r_i + r_j))^2, j != i,
//                   live[i], live[j], beats(j, i)
//   beats(j, i)   = m_j > m_i  or  (m_j == m_i and j < i)
//
// and writes winner[i] = that j, the lowest index among the heaviest, or
// m where there is none (a dead row, or no contact). The fp32 expressions
// are JAX's, in its order: dx = x_i - x_j, d2 = dx*dx + dy*dy,
// reach = factor * (r_i + r_j), contact iff d2 < reach*reach. Each is
// rounded on its own (__fsub_rn/__fmul_rn/__fadd_rn), so nvcc cannot
// contract a pair into an FFMA and move a contact that lies on the
// boundary. The geometric half of the test is symmetric bit for bit:
// fl(x_i - x_j) = -fl(x_j - x_i) and fl(r_i + r_j) = fl(r_j + r_i).
//
// Each row keeps a running (best mass, lowest index) pair over the
// candidates it is shown, replaced when a contact has m_j > best, or
// m_j == best and j < win: JAX's key.max followed by the lowest index
// among the maxima, whatever the order of the candidates. So any search
// that shows each row a superset of its contacts gives the same answer,
// bit for bit. This one shows each row the pairs of a cell grid, the one
// that ops/collisions.contact_grid defines in plain PyTorch (the set-up
// below forms it bit for bit):
//   * the big rows: with r_cut the K-th largest size (|radius| of a live
//     row), the fewer than K rows above it. Every pair with a big row is
//     examined once, by the thread of the other row, for both directions:
//     the big row as its candidate, and the thread's row as the big row's
//     candidate (a warp's best goes to the big row's 64-bit key by
//     atomicMax, which is exact and the same in any order);
//   * every other live row at a finite position sits in a cell of width
//     w, key (cy << 32) | cx, sorted; a row is shown the rows of the 3x3
//     cells around its own, three runs of the sorted keys, each found by
//     a binary search.
//
// Why the grid misses no contact. |r_i|, |r_j| <= r_cut for two rows on
// the grid; let R = fl(fl(|factor|) * 2 r_cut). Rounding is monotone, so
// the kernel's
// |reach| = |fl(factor * fl(r_i + r_j))| <= R and reach^2 <= fl(R * R).
// If |x_i - x_j| >= R (exactly, in reals), then |dx| = fl(|x_i - x_j|)
// >= R, fl(dx * dx) >= fl(R * R), and d2 >= fl(dx * dx) (adding a square
// cannot lower a rounded sum): d2 < reach^2 fails. The same holds in y.
// Cells two or more apart in x hold rows at least w (1 - 2^-19) apart:
// the cell index is floor of u = fl(fl(x - x0) / w) in float64, whose
// error is under 2^-52 u, and u <= 2^30 before the clamp (which only
// merges cells). With w = R (1 + 2^-8) that distance exceeds R. This holds
// in the subnormal range and at overflow (inf < inf fails), and for
// pairs exactly at reach, rows on cell edges, and coordinates near 1e6 or
// more. A scene all in one cell is still right, at O(M^2).
//
// Two C entry points, one launch between them: the set-up,
// nbody_contact_grid (select_kernel, one block: the K-th largest size by
// a radix select of its ordered bits, 8 bits a pass, the origin and the
// width; keys_kernel: each row's key and the big rows' list), then the
// caller's stable sort of the keys (torch.sort), then the search,
// nbody_merge_contacts (pack_kernel copies each row in key order as
// (x, y, r, live ? m : NaN), a NaN mass neither beating nor beaten;
// search_kernel, one thread a row in key order, so that a warp's binary
// searches and candidates share cache lines; big_kernel turns each big
// row's key into its winner). No host sync: counts and scalars stay in
// device memory, where the kernels read them.
//
// What bounds it on an H100: latency and the host, not the pairs. The
// search's work is ~12 fp32 operations a candidate pair (the big rows
// against every row and the neighbourhood pairs: 1.74e7 at N=1M, against
// the M^2 = 2.75e11 of an all-pairs search) and ~60 dependent
// loads a row for the binary searches; the bytes are 17 M in, 8 M out
// (0.0039 ms at N=1M). At N=65536 the call takes 0.16 ms, the sort 0.07
// of it and the one-block select 0.03; a set-up of ~30 PyTorch ops took
// 0.6 ms to enqueue there (PERF.md §6).
//
// The C entry points launch on the stream they are handed, do not
// synchronise, allocate nothing, and return cudaGetLastError().

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;
constexpr int kSelect = 1024;  // threads of the one block of select_kernel
constexpr int kMaxBig = 64;
constexpr long long kOffGrid = 0x7fffffffffffffffLL;
constexpr double kCellMax = 1073741824.0;  // 2^30 (collisions.CELL_MAX)
constexpr double kCellMargin = 1.0 + 1.0 / 256;  // collisions.CELL_MARGIN
constexpr unsigned kFull = 0xffffffffu;

// Bits of a float mapped so that unsigned order is float order (for every
// non-NaN value); never 0 for a non-NaN value.
__device__ __forceinline__ uint32_t ordered_bits(float m) {
  const uint32_t b = __float_as_uint(m);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float from_ordered(uint32_t u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

// A row's size: |r| if live (and r is not NaN), else -inf; as ordered bits.
__device__ __forceinline__ uint32_t size_bits(float r, unsigned char live) {
  return ordered_bits(live && r == r ? fabsf(r) : -CUDART_INF_F);
}

// A candidate (m_j, j) as a key whose unsigned order is "beats": heavier,
// then lower index. 0 is none.
__device__ __forceinline__ unsigned long long pair_key(float m, int j) {
  return (static_cast<unsigned long long>(ordered_bits(m)) << 32) |
         (0xffffffffu - static_cast<uint32_t>(j));
}

__device__ __forceinline__ long long key_winner(unsigned long long key,
                                                int m) {
  return key ? static_cast<long long>(0xffffffffu -
                                      static_cast<uint32_t>(key & 0xffffffffu))
             : static_cast<long long>(m);
}

// The geometric half of the contact test, JAX's expressions rounded alone.
__device__ __forceinline__ bool touch(float4 a, float4 b, float factor) {
  const float dx = __fsub_rn(a.x, b.x);
  const float dy = __fsub_rn(a.y, b.y);
  const float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
  const float reach = __fmul_rn(factor, __fadd_rn(a.z, b.z));
  return d2 < __fmul_rn(reach, reach);
}

// Does (mj, j) beat (mi, i)? False when either mass is NaN (a dead row).
__device__ __forceinline__ bool beats(float mj, int j, float mi, int i) {
  return mj > mi || (mj == mi && j < i);
}

__device__ __forceinline__ void take(float mj, int j, float& best, int& win) {
  if (mj > best || (mj == best && j < win)) {
    best = mj;
    win = j;
  }
}

// The first position in keys[0, m) whose key is >= v.
__device__ __forceinline__ int lower_bound(const long long* __restrict__ keys,
                                           int m, long long v) {
  int lo = 0, hi = m;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(keys + mid) < v)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

__device__ __forceinline__ float4 row_of(const float2* __restrict__ pos,
                                         const float* __restrict__ radius,
                                         const float* __restrict__ mass,
                                         const unsigned char* __restrict__ live,
                                         long long i) {
  const float2 p = pos[i];
  return make_float4(p.x, p.y, radius[i], live[i] ? mass[i] : CUDART_NAN_F);
}

// The grid's scalars, in one block: the K-th largest size (a radix
// select over its ordered bits, 8 bits a pass), the origin (the least x
// and y of the live rows at finite positions) and the cell width, as
// collisions.contact_grid forms them; clears the big rows' list.
__global__ void __launch_bounds__(kSelect)
select_kernel(const float2* __restrict__ pos, const float* __restrict__ radius,
              const unsigned char* __restrict__ live, int m, int k,
              float factor, long long* __restrict__ big,
              int* __restrict__ counts, double* __restrict__ scalars) {
  __shared__ unsigned hist[256];
  __shared__ unsigned s_prefix, s_need;
  __shared__ unsigned s_min[2][kSelect / 32];
  const int tid = threadIdx.x;
  if (tid < kMaxBig) big[tid] = -1;
  if (tid == 0) {
    s_prefix = 0;
    s_need = static_cast<unsigned>(k);
  }
  unsigned mx = 0xffffffffu, my = 0xffffffffu;
  for (int i = tid; i < m; i += kSelect) {
    const float2 p = pos[i];
    if (live[i] && isfinite(p.x) && isfinite(p.y)) {
      mx = min(mx, ordered_bits(p.x));
      my = min(my, ordered_bits(p.y));
    }
  }
  mx = __reduce_min_sync(kFull, mx);
  my = __reduce_min_sync(kFull, my);
  if ((tid & 31) == 0) {
    s_min[0][tid >> 5] = mx;
    s_min[1][tid >> 5] = my;
  }
  unsigned mask = 0;
  for (int shift = 24; shift >= 0; shift -= 8) {
    if (tid < 256) hist[tid] = 0;
    __syncthreads();
    const unsigned prefix = s_prefix;
    for (int i = tid; i < m; i += kSelect) {
      const unsigned u = size_bits(radius[i], live[i]);
      if ((u & mask) == prefix) atomicAdd(hist + ((u >> shift) & 255u), 1u);
    }
    __syncthreads();
    if (tid == 0) {
      unsigned need = s_need;
      int d = 255;
      for (; d > 0 && hist[d] < need; --d) need -= hist[d];
      s_prefix = prefix | (static_cast<unsigned>(d) << shift);
      s_need = need;
    }
    mask |= 255u << shift;
    __syncthreads();
  }
  if (tid != 0) return;
  counts[0] = 0;
  counts[1] = static_cast<int>(s_prefix);
  const float r_cut = fmaxf(from_ordered(s_prefix), 0.f);
  const float reach = __fmul_rn(__fadd_rn(r_cut, r_cut), fabsf(factor));
  double w = __dmul_rn(static_cast<double>(reach), kCellMargin);
  scalars[0] = w == 0.0 ? 1.0 : w;
  for (int a = 0; a < 2; ++a) {
    unsigned least = 0xffffffffu;
    for (int q = 0; q < kSelect / 32; ++q) least = min(least, s_min[a][q]);
    scalars[1 + a] =
        least == 0xffffffffu ? 0.0 : static_cast<double>(from_ordered(least));
  }
}

// Each row's key (kOffGrid off the grid), and the big rows' list.
__global__ void __launch_bounds__(kBlock)
keys_kernel(const float2* __restrict__ pos, const float* __restrict__ radius,
            const unsigned char* __restrict__ live, int m,
            const double* __restrict__ scalars, long long* __restrict__ keys,
            long long* __restrict__ big, int* __restrict__ counts) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= m) return;
  const float2 p = pos[i];
  const bool is_big = size_bits(radius[i], live[i]) >
                      static_cast<unsigned>(counts[1]);
  if (is_big) {
    const int slot = atomicAdd(counts, 1);
    if (slot < kMaxBig) big[slot] = i;
  }
  long long key = kOffGrid;
  if (live[i] && !is_big && isfinite(p.x) && isfinite(p.y)) {
    const double w = scalars[0];
    const double cx = fmin(fmax(floor(__ddiv_rn(
        __dsub_rn(static_cast<double>(p.x), scalars[1]), w)), 0.0), kCellMax);
    const double cy = fmin(fmax(floor(__ddiv_rn(
        __dsub_rn(static_cast<double>(p.y), scalars[2]), w)), 0.0), kCellMax);
    key = (static_cast<long long>(cy) << 32) | static_cast<long long>(cx);
  }
  keys[i] = key;
}

__global__ void __launch_bounds__(kBlock)
pack_kernel(const float2* __restrict__ pos, const float* __restrict__ radius,
            const float* __restrict__ mass,
            const unsigned char* __restrict__ live,
            const long long* __restrict__ order, int m,
            float4* __restrict__ packed,
            unsigned long long* __restrict__ big_keys) {
  const int t = blockIdx.x * kBlock + threadIdx.x;
  if (t < kMaxBig) big_keys[t] = 0ull;
  if (t < m) packed[t] = row_of(pos, radius, mass, live, order[t]);
}

__global__ void __launch_bounds__(kBlock)
search_kernel(const float4* __restrict__ packed,
              const long long* __restrict__ order,
              const long long* __restrict__ keys,
              const long long* __restrict__ big,
              const int* __restrict__ counts,
              const float2* __restrict__ pos, const float* __restrict__ radius,
              const float* __restrict__ mass,
              const unsigned char* __restrict__ live, int m, float factor,
              unsigned long long* __restrict__ big_keys,
              long long* __restrict__ winner) {
  __shared__ float4 sbig[kMaxBig];
  __shared__ int sbig_row[kMaxBig];
  const int n_big = min(counts[0], kMaxBig);
  for (int q = threadIdx.x; q < n_big; q += kBlock) {
    sbig[q] = row_of(pos, radius, mass, live, big[q]);
    sbig_row[q] = static_cast<int>(big[q]);
  }
  __syncthreads();
  const int t = blockIdx.x * kBlock + threadIdx.x;
  const bool valid = t < m;
  const float4 me =
      valid ? packed[t] : make_float4(0.f, 0.f, 0.f, CUDART_NAN_F);
  const int i = valid ? static_cast<int>(order[t]) : -1;
  const bool mine = me.w == me.w;  // a live row (dead rows carry NaN)
  float best = -CUDART_INF_F;
  int win = m;
  // every pair with a big row, once, for both directions (all lanes run
  // this loop: the warp votes on each big row)
  for (int q = 0; q < n_big; ++q) {
    const float4 b = sbig[q];
    const int k = sbig_row[q];
    const bool near = mine && k != i && touch(me, b, factor);
    if (near && beats(b.w, k, me.w, i)) take(b.w, k, best, win);
    const bool gives = near && beats(me.w, i, b.w, k);
    if (__any_sync(kFull, gives)) {
      unsigned long long key = gives ? pair_key(me.w, i) : 0ull;
#pragma unroll
      for (int off = 16; off; off >>= 1) {
        const unsigned long long o = __shfl_xor_sync(kFull, key, off);
        key = o > key ? o : key;
      }
      if ((threadIdx.x & 31) == 0) atomicMax(big_keys + q, key);
    }
  }
  const long long key = valid ? keys[t] : kOffGrid;
  if (mine && key != kOffGrid) {
    const long long cy = key >> 32;
    const long long cx = key & 0xffffffffLL;
    const long long x0 = cx > 0 ? cx - 1 : 0;
    for (long long y = cy > 0 ? cy - 1 : 0; y <= cy + 1; ++y) {
      const long long last = (y << 32) | (cx + 1);
      for (int s = lower_bound(keys, m, (y << 32) | x0);
           s < m && __ldg(keys + s) <= last; ++s) {
        const float4 c = packed[s];
        const int j = static_cast<int>(order[s]);
        if (j != i && touch(me, c, factor) && beats(c.w, j, me.w, i))
          take(c.w, j, best, win);
      }
    }
  }
  if (valid) winner[i] = win;  // a big row's is replaced by big_kernel
}

__global__ void big_kernel(const long long* __restrict__ big,
                           const int* __restrict__ counts,
                           const unsigned long long* __restrict__ big_keys,
                           int m, long long* __restrict__ winner) {
  const int q = threadIdx.x;
  if (q < min(counts[0], kMaxBig)) winner[big[q]] = key_winner(big_keys[q], m);
}

}  // namespace

// The grid's set-up: pos (m, 2), radius (m,) fp32, live (m,) bytes;
// 1 <= k <= min(m, 64). Writes keys (m,) int64, unsorted; big (64,) int64:
// the rows whose size exceeds the k-th largest, -1 past their count;
// counts (2,) int32: that count and the k-th largest size's ordered bits;
// scalars (3,) float64: the cell width and the origin's x and y.
extern "C" int nbody_contact_grid(const void* pos, const void* radius,
                                  const void* live, int m, float factor,
                                  int k, void* keys, void* big, void* counts,
                                  void* scalars, void* stream) {
  if (m < 1 || k < 1 || k > m || k > kMaxBig)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* p = static_cast<const float2*>(pos);
  const auto* r = static_cast<const float*>(radius);
  const auto* lv = static_cast<const unsigned char*>(live);
  auto* bg = static_cast<long long*>(big);
  auto* ct = static_cast<int*>(counts);
  auto* sc = static_cast<double*>(scalars);
  select_kernel<<<1, kSelect, 0, s>>>(p, r, lv, m, k, factor, bg, ct, sc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  keys_kernel<<<(m + kBlock - 1) / kBlock, kBlock, 0, s>>>(
      p, r, lv, m, sc, static_cast<long long*>(keys), bg, ct);
  return static_cast<int>(cudaGetLastError());
}

// The search: pos (m, 2), radius (m,), mass (m,) fp32; live (m,) bytes
// (0 or 1); the grid of nbody_contact_grid: order (m,) int64 rows in key
// order, keys (m,) int64 sorted (kOffGrid off the grid), big (64,) int64
// and counts (2,) int32 as that entry point left them; scratch packed
// (m, 4) fp32 and big_keys (64,) 64-bit; winner (m,) int64 out, m where
// row i has no contact that beats it. 1 <= m < 2^31 - 1.
extern "C" int nbody_merge_contacts(const void* pos, const void* radius,
                                    const void* mass, const void* live, int m,
                                    float factor, const void* order,
                                    const void* keys, const void* big,
                                    const void* counts, void* packed,
                                    void* big_keys, void* winner,
                                    void* stream) {
  if (m < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (m + kBlock - 1) / kBlock;
  const auto* p = static_cast<const float2*>(pos);
  const auto* r = static_cast<const float*>(radius);
  const auto* ms = static_cast<const float*>(mass);
  const auto* lv = static_cast<const unsigned char*>(live);
  const auto* ord = static_cast<const long long*>(order);
  const auto* bg = static_cast<const long long*>(big);
  const auto* ct = static_cast<const int*>(counts);
  auto* pk = static_cast<float4*>(packed);
  auto* bk = static_cast<unsigned long long*>(big_keys);
  auto* w = static_cast<long long*>(winner);
  pack_kernel<<<blocks, kBlock, 0, s>>>(p, r, ms, lv, ord, m, pk, bk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  search_kernel<<<blocks, kBlock, 0, s>>>(
      pk, ord, static_cast<const long long*>(keys), bg, ct, p, r, ms, lv, m,
      factor, bk, w);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  big_kernel<<<1, kMaxBig, 0, s>>>(bg, ct, bk, m, w);
  return static_cast<int>(cudaGetLastError());
}
