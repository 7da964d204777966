// Per-instruction cost probes for NVIDIA Hopper (sm_90a): a self-chained
// elementwise expression run `loops` times per element.
//
// Replaces the TPU kernel scripts/ablations/tune_r2f.py::make_probe ->
// kernel (K5f), which ran acc = expr(acc, y) in a fori_loop over a
// VMEM-resident (256, 2048) block and took the marginal time between two
// loop counts as the vector unit's cost of one expression. Here each
// thread holds one element in registers and runs the same chain; `loops`
// is a runtime argument, so nothing folds, and every iteration depends on
// the last, so nothing is hoisted. The loop runs 8 expressions per pass
// (a pass of 8 is what the SASS reading divides), then the remainder one
// at a time.
//
// Expressions (tune_r2f.py:55-65), a the chained value, b = y:
//   0 add: a + b            1 mul: a * 1.0000001   2 fma_pat: a * 0.9999 + 1e-4
//   3 rsqrt: rsqrt(a) + 0.5 (MUFU.RSQ)             4 sqrt: sqrt(a) + 0.1 (IEEE)
//   5 recip_apx: rcp.approx.ftz(a) + 0.5 (PTX, inline asm)
//   6 rsqrt3: i*i*i + 0.5   7 full_f: b * (i*i*i) + 0.5, i = rsqrt(a)
//   8 sq_chain: (a*a + b*b + 0.5) * 0.3
// Built without fast math: sqrtf is the correctly rounded sequence and
// the compiler contracts a * c + d into an FFMA.
//
// What bounds it on an H100: the issue rate of the pipe each instruction
// uses (fp32: 128 lanes an SM a clock; MUFU: 16); the bytes are 6 MB.
//
// The C entry point launches on the stream it is handed, does not
// synchronise, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;
constexpr int kPass = 8;
constexpr int kExprs = 9;

__device__ __forceinline__ float rcp_approx(float a) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(a));
  return r;
}

template <int E>
__device__ __forceinline__ float expr(float a, float b) {
  if constexpr (E == 0) return a + b;
  if constexpr (E == 1) return a * 1.0000001f;
  if constexpr (E == 2) return a * 0.9999f + 1e-4f;
  if constexpr (E == 3) return rsqrtf(a) + 0.5f;
  if constexpr (E == 4) return sqrtf(a) + 0.1f;
  if constexpr (E == 5) return rcp_approx(a) + 0.5f;
  if constexpr (E == 6) {
    const float i = rsqrtf(a);
    return i * i * i + 0.5f;
  }
  if constexpr (E == 7) {
    const float i = rsqrtf(a);
    return b * (i * i * i) + 0.5f;
  }
  if constexpr (E == 8) return (a * a + b * b + 0.5f) * 0.3f;
}

template <int E>
__global__ void __launch_bounds__(kBlock)
probe_kernel(const float* __restrict__ x, const float* __restrict__ y,
             int n, int loops, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float a = x[i];
  const float b = y[i];
  int k = 0;
#pragma unroll 1
  for (; k + kPass <= loops; k += kPass) {
#pragma unroll
    for (int u = 0; u < kPass; ++u) a = expr<E>(a, b);
  }
#pragma unroll 1
  for (; k < loops; ++k) a = expr<E>(a, b);
  out[i] = a;
}

template <int E = 0>
cudaError_t launch(int e, const float* x, const float* y, int n, int loops,
                   float* out, cudaStream_t st) {
  if constexpr (E >= kExprs) {
    return cudaErrorInvalidValue;
  } else {
    if (e != E) return launch<E + 1>(e, x, y, n, loops, out, st);
    probe_kernel<E><<<(n + kBlock - 1) / kBlock, kBlock, 0, st>>>(x, y, n,
                                                                loops, out);
    return cudaGetLastError();
  }
}

}  // namespace

// out[i] = expression `expr` (above) applied `loops` times to x[i], with
// b = y[i], for i < n. Device pointers to contiguous fp32 arrays. Returns
// the cudaError_t of the launch (0 on success).
extern "C" int nbody_op_probe(const void* x, const void* y, int n, int expr,
                              int loops, void* out, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  if (expr < 0 || loops < 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch(expr, static_cast<const float*>(x),
                                 static_cast<const float*>(y), n, loops,
                                 static_cast<float*>(out),
                                 static_cast<cudaStream_t>(stream)));
}
