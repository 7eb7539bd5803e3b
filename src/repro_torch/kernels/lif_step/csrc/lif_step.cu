// One LIF timestep over a flat tensor, CUDA C++ for sm_90a.
//
// Replaces the TPU kernel `lif_step_fused` (src/repro/kernels/lif_step/
// lif_step.py, body `_lif_step_kernel`), which the unfused pipeline
// (src/repro/models/vgg9.py, `vgg9_infer_hybrid_unfused`) launches once per
// timestep and layer through `lif_update`.
//
// What it computes, per element of the flat length n:
//   u' = beta*u + I - s_prev*theta ;  s = u' > theta
// Rounding: the JAX reference, as XLA compiles it for the CPU, contracts
// beta*u + I into one fused multiply-add, so that sum is rounded once. Here
// it is computed in double (beta*u is exact in double: 24 x 24 bits) and
// rounded to float once, exactly as `lif_update_plain` in ops.py does; the
// explicit-rounding intrinsics keep nvcc from fusing anything else, which
// makes the kernel bit-identical to the plain version on the card.
// s_prev*theta is exact for s_prev in {0, 1}.
//
// What bounds it on an H100: bytes. Each element reads u, I and s_prev and
// writes u' and s (20 bytes) for ~5 flops, far below the card's ~20 flops
// per byte. Design: no [R, 512] padding (a TPU layout); a grid-stride loop
// over float4 groups, so each thread moves 16 bytes per load and store and
// adjacent threads touch adjacent addresses, then a scalar tail for the
// last n % 4 elements. The wrapper guarantees 16-byte aligned operands.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 8192;

__device__ __forceinline__ void lif(float u, float cur, float s_prev,
                                    double beta_d, float theta, float& u_next,
                                    float& spike) {
  const float decayed = __double2float_rn(
      __dadd_rn(__dmul_rn(beta_d, (double)u), (double)cur));
  u_next = __fsub_rn(decayed, __fmul_rn(s_prev, theta));
  spike = u_next > theta ? 1.f : 0.f;
}

__global__ void __launch_bounds__(kThreads)
lif_step_kernel(const float* __restrict__ u, const float* __restrict__ cur,
                const float* __restrict__ s_prev, float* __restrict__ u_out,
                float* __restrict__ s_out, long long n, float beta,
                float theta) {
  const double beta_d = (double)beta;
  const long long groups = n / 4;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (long long g = first; g < groups; g += stride) {
    const float4 uv = reinterpret_cast<const float4*>(u)[g];
    const float4 cv = reinterpret_cast<const float4*>(cur)[g];
    const float4 sv = reinterpret_cast<const float4*>(s_prev)[g];
    float4 un, sn;
    lif(uv.x, cv.x, sv.x, beta_d, theta, un.x, sn.x);
    lif(uv.y, cv.y, sv.y, beta_d, theta, un.y, sn.y);
    lif(uv.z, cv.z, sv.z, beta_d, theta, un.z, sn.z);
    lif(uv.w, cv.w, sv.w, beta_d, theta, un.w, sn.w);
    reinterpret_cast<float4*>(u_out)[g] = un;
    reinterpret_cast<float4*>(s_out)[g] = sn;
  }
  for (long long e = groups * 4 + first; e < n; e += stride)
    lif(u[e], cur[e], s_prev[e], beta_d, theta, u_out[e], s_out[e]);
}

}  // namespace

// u, cur, s_prev, u_out, s_out: n contiguous fp32 values each, 16-byte
// aligned (the wrapper checks both).
extern "C" int lif_step(const float* u, const float* cur, const float* s_prev,
                        float* u_out, float* s_out, long long n, float beta,
                        float theta, cudaStream_t stream) {
  long long blocks = (n / 4 + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  lif_step_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
      u, cur, s_prev, u_out, s_out, n, beta, theta);
  return (int)cudaGetLastError();
}
