// The warp's fixed-order reduce-scatter of a batch of 8 rows' three sums,
// shared by the VJP kernels (direct_vjp.cu, p3m_pp_vjp.cu): each reduces
// the sums of the rows of the side that is not in its registers over the
// warp's lanes, 8 rows at a time.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kBatch = 8;     // other rows whose sums are reduced together
constexpr unsigned kFull = 0xffffffffu;

// The warp's sums of a batch's 8 other rows, v[3u + c] for row u and term
// c, reduced over the 32 lanes and scattered: lane l ends with the three
// sums of row 4 b4 + 2 b3 + b2 (b_k bit k of l), the same bits in the
// four lanes that hold it. Three halving rounds (xor 16, 8, 4: a lane
// keeps half its values and adds its partner's copy of them), then an
// all-reduce over xor 2 and 1: 27 shuffles and 42 selects, against 120
// shuffles for an all-reduce of every value (on sm_90 a shuffle issues at a
// quarter of the fp32 rate, so that form bounded the kernel).
__device__ __forceinline__ void reduce_scatter(const float (&v)[24], int lane,
                                               float (&out)[3]) {
  float w[12], x[6];
  const bool h16 = lane & 16, h8 = lane & 8, h4 = lane & 4;
#pragma unroll
  for (int k = 0; k < 12; ++k) {
    const float send = h16 ? v[k] : v[k + 12];
    const float keep = h16 ? v[k + 12] : v[k];
    w[k] = keep + __shfl_xor_sync(kFull, send, 16);
  }
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const float send = h8 ? w[k] : w[k + 6];
    const float keep = h8 ? w[k + 6] : w[k];
    x[k] = keep + __shfl_xor_sync(kFull, send, 8);
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float send = h4 ? x[k] : x[k + 3];
    const float keep = h4 ? x[k + 3] : x[k];
    out[k] = keep + __shfl_xor_sync(kFull, send, 4);
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) out[k] += __shfl_xor_sync(kFull, out[k], 2);
#pragma unroll
  for (int k = 0; k < 3; ++k) out[k] += __shfl_xor_sync(kFull, out[k], 1);
}

// The batch row whose sums lane l holds after reduce_scatter.
__device__ __forceinline__ int scattered_row(int lane) {
  return ((lane >> 4) & 1) * 4 + ((lane >> 3) & 1) * 2 + ((lane >> 2) & 1);
}

}  // namespace
