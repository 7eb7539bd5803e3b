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
// ~20 flops per byte. Design: one thread per element with a grid-stride
// loop; u and s live in registers across the T steps, so the membrane
// never touches device memory and the bias is read once per element
// (from L1/L2, it is only N floats). Adjacent threads touch adjacent
// addresses, so every load and store is coalesced.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 8192;

__global__ void __launch_bounds__(kThreads)
lif_epilogue_scan_kernel(const float* __restrict__ cur,
                         const float* __restrict__ bias,
                         float* __restrict__ spikes, long long elems, int n,
                         int steps, float beta, float theta) {
  const double beta_d = (double)beta;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < elems; e += (long long)gridDim.x * blockDim.x) {
    const float b = bias[e % n];
    float u = 0.f, s = 0.f;
    for (int t = 0; t < steps; ++t) {
      const float ib = __fadd_rn(cur[(size_t)t * elems + e], b);
      const float decayed = __double2float_rn(
          __dadd_rn(__dmul_rn(beta_d, (double)u), (double)ib));
      u = __fsub_rn(decayed, __fmul_rn(s, theta));
      s = u > theta ? 1.f : 0.f;
      spikes[(size_t)t * elems + e] = s;
    }
  }
}

}  // namespace

// cur [steps, rows, n] fp32, bias [n] fp32 -> spikes [steps, rows, n] fp32.
extern "C" int lif_epilogue_scan(const float* cur, const float* bias,
                                 float* spikes, long long rows, int n,
                                 int steps, float beta, float theta,
                                 cudaStream_t stream) {
  const long long elems = rows * n;
  long long blocks = (elems + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  lif_epilogue_scan_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
      cur, bias, spikes, elems, n, steps, beta, theta);
  return (int)cudaGetLastError();
}
