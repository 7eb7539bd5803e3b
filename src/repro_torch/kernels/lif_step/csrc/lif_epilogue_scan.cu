// Bias + LIF epilogue over all T timesteps of a layer, CUDA C++ for sm_90a.
//
// Replaces the TPU kernel `lif_epilogue_fused` (src/repro/kernels/lif_step/
// lif_step.py, body `_lif_epilogue_kernel`) and the `lax.scan` that calls it
// T times per layer (src/repro/models/vgg9.py, `lif_scan_fused`). One launch
// per layer instead of T.
//
// What it computes, per element of [R, N], from u = s = 0:
//   u = beta*u + (I[t] + b) - s*theta ;  s = u > theta ;  spikes[t] = s
// Rounding: the JAX reference, as XLA compiles it for the CPU, contracts
// beta*u + (I + b) into one fused multiply-add, so that sum is rounded once.
// Here it is computed in double (beta*u is exact in double: 24 x 24 bits)
// and rounded to float once, exactly as the plain PyTorch version in
// ops.py does; the explicit-rounding intrinsics keep nvcc from fusing
// anything else, which makes the kernel bit-identical to the plain version
// on the card. s*theta is exact for s in {0, 1}.
//
// What bounds it on an H100: bytes. Each element reads T currents and
// writes T spikes (8*T bytes) for ~5 flops per step, far below the card's
// ~20 flops per byte. Design:
// - where N % 4 == 0 (every served width) a thread owns a group of 4
//   consecutive columns of a row and moves it as float4 (16-byte loads and
//   stores); any other N takes the same kernel on single floats;
// - a group's column comes from 32-bit counters (the thread's first group
//   modulo the groups per row once, then one add and one wrap per further
//   group), so no element pays a 64-bit division;
// - at T = 2 (every served configuration but rate coding) the steps are
//   unrolled and a thread issues every current load of its group before
//   the recurrence; any other T (25 for rate coding) loads step t + 1
//   before step t's arithmetic;
// - the spikes are stored with the streaming hint (`st.global.cs`): no step
//   of this kernel reads them back;
// - the grid comes from the wrapper's picker (`epilogue_geometry` in
//   ops.py): one group per thread, one block per 256 groups (past 2^20
//   blocks the threads loop over the rest). Two groups per thread won 5-14 %
//   at conv1 with its operands in L2 and tied with them in HBM (PERF.md),
//   so the kernel has one.
// u and s live in registers across the T steps, so the membrane never
// touches device memory; the bias (N floats) is read through the read-only
// cache.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void lif(float cur, float b, double beta_d, float theta,
                                    float& u, float& s) {
  const float ib = __fadd_rn(cur, b);
  const float decayed = __double2float_rn(
      __dadd_rn(__dmul_rn(beta_d, (double)u), (double)ib));
  u = __fsub_rn(decayed, __fmul_rn(s, theta));
  s = u > theta ? 1.f : 0.f;
}

__device__ __forceinline__ void lif(float4 cur, float4 b, double beta_d, float theta,
                                    float4& u, float4& s) {
  lif(cur.x, b.x, beta_d, theta, u.x, s.x);
  lif(cur.y, b.y, beta_d, theta, u.y, s.y);
  lif(cur.z, b.z, beta_d, theta, u.z, s.z);
  lif(cur.w, b.w, beta_d, theta, u.w, s.w);
}

template <typename V> __device__ __forceinline__ V zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ float4 zero<float4>() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

// V: float4 (the vector path, N % 4 == 0) or float (any N); a "group" is
// one V. kSteps: T where it is unrolled (2), 0 for any other T.
template <typename V, int kSteps>
__global__ void __launch_bounds__(kThreads)
lif_epilogue_kernel(const V* __restrict__ cur, const V* __restrict__ bias,
                    V* __restrict__ spikes, long long groups, unsigned row_groups,
                    int steps, float beta, float theta) {
  const double beta_d = (double)beta;
  const unsigned first = blockIdx.x * kThreads + threadIdx.x;
  const unsigned stride = gridDim.x * kThreads;
  const unsigned col_stride = stride % row_groups;
  unsigned col = first % row_groups;
  for (long long g = first; g < groups; g += stride) {
    const V b = __ldg(bias + col);
    col += col_stride;
    if (col >= row_groups) col -= row_groups;
    V u = zero<V>(), s = zero<V>();
    if constexpr (kSteps > 0) {
      V c[kSteps];
#pragma unroll
      for (int t = 0; t < kSteps; ++t) c[t] = __ldcs(cur + t * groups + g);
#pragma unroll
      for (int t = 0; t < kSteps; ++t) {
        lif(c[t], b, beta_d, theta, u, s);
        __stcs(spikes + t * groups + g, s);
      }
    } else {
      V next = __ldcs(cur + g);
      for (int t = 0; t < steps; ++t) {
        const V c = next;
        if (t + 1 < steps) next = __ldcs(cur + (t + 1) * groups + g);
        lif(c, b, beta_d, theta, u, s);
        __stcs(spikes + t * groups + g, s);
      }
    }
  }
}

template <typename V>
using Kernel = void (*)(const V*, const V*, V*, long long, unsigned, int, float, float);

template <typename V>
int launch(const float* cur, const float* bias, float* spikes, long long rows, int n,
           int steps, float beta, float theta, int blocks, cudaStream_t stream) {
  constexpr int lanes = sizeof(V) / sizeof(float);
  Kernel<V> kernel = nullptr;
  switch (steps) {
    case 2: kernel = &lif_epilogue_kernel<V, 2>; break;
    default: kernel = &lif_epilogue_kernel<V, 0>;
  }
  if (steps < 1 || rows < 1 || n < 1 || n % lanes || blocks < 1)
    return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
      reinterpret_cast<const V*>(cur), reinterpret_cast<const V*>(bias),
      reinterpret_cast<V*>(spikes), rows * (n / lanes), (unsigned)(n / lanes), steps, beta,
      theta);
  return (int)cudaGetLastError();
}

}  // namespace

// cur [steps, rows, n] fp32, bias [n] fp32 -> spikes [steps, rows, n] fp32,
// all 16-byte aligned. vector != 0 takes the float4 path (n % 4 == 0);
// blocks comes from `epilogue_geometry` in ops.py. Returns
// cudaErrorInvalidValue, launching nothing, for a combination the kernel
// does not take.
extern "C" int lif_epilogue_scan(const float* cur, const float* bias, float* spikes,
                                 long long rows, int n, int steps, float beta,
                                 float theta, int vector, int blocks, cudaStream_t stream) {
  return vector ? launch<float4>(cur, bias, spikes, rows, n, steps, beta, theta, blocks,
                                 stream)
                : launch<float>(cur, bias, spikes, rows, n, steps, beta, theta, blocks,
                                stream);
}
