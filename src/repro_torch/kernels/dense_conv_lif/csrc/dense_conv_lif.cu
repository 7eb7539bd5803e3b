// Dense core: direct-coded input conv fused with T LIF steps, CUDA C++ for
// sm_90a.
//
// Replaces the TPU kernel `dense_conv_lif` (src/repro/kernels/dense_conv_lif/
// dense_conv_lif.py, body `_dense_conv_lif_kernel`).
//
// What it computes: current = patches [M, K] @ w [K, N] + b, once (direct
// coding repeats the image every timestep), then T LIF steps from u = s = 0:
//   u = beta*u + current - s*theta ;  s = u > theta ;  spikes[t] = s
// and the final u. The 27-deep dot sums k = 0..K-1 in order with separate
// roundings. As in the spiking-layer epilogue, beta*u + current is rounded
// once (computed in double, where beta*u is exact), which is how the JAX
// reference's fused multiply-add rounds it on the CPU; the explicit-rounding
// intrinsics keep nvcc from contracting anything else.
//
// What bounds it on an H100: bytes. At CIFAR10 with 8 images (M = 8192,
// K = 27, N = 64, T = 2) it reads 0.9 MB of patches and writes 6.3 MB of
// spikes and membranes for 28 MFLOP, about 4 flops per byte. Design: the
// TPU version pads K to 128 lanes; here K stays 27 and the weights and
// bias (K*N + N floats, 7 KB) sit in shared memory for the whole block.
// One thread per (row, out-channel): the threads of a row read the same
// patch values (broadcast from L1), adjacent channels write adjacent
// addresses, and u never leaves registers between the T steps.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1024;

__global__ void __launch_bounds__(kThreads)
dense_conv_lif_kernel(const float* __restrict__ x, const float* __restrict__ w,
                      const float* __restrict__ bias,
                      float* __restrict__ spikes, float* __restrict__ u_out,
                      int m, int k, int n, int steps, float beta,
                      float theta) {
  extern __shared__ float smem[];          // w [k*n], then bias [n]
  float* ws = smem;
  float* bs = smem + k * n;
  for (int i = threadIdx.x; i < k * n; i += blockDim.x) ws[i] = w[i];
  for (int i = threadIdx.x; i < n; i += blockDim.x) bs[i] = bias[i];
  __syncthreads();

  const double beta_d = (double)beta;
  const long long elems = (long long)m * n;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < elems; e += (long long)gridDim.x * blockDim.x) {
    const int row = (int)(e / n), col = (int)(e % n);
    const float* xr = x + (size_t)row * k;
    float acc = 0.f;
    for (int kk = 0; kk < k; ++kk)
      acc = __fadd_rn(acc, __fmul_rn(xr[kk], ws[kk * n + col]));
    const float current = __fadd_rn(acc, bs[col]);
    float u = 0.f, s = 0.f;
    for (int t = 0; t < steps; ++t) {
      const float decayed = __double2float_rn(
          __dadd_rn(__dmul_rn(beta_d, (double)u), (double)current));
      u = __fsub_rn(decayed, __fmul_rn(s, theta));
      s = u > theta ? 1.f : 0.f;
      spikes[(size_t)t * elems + e] = s;
    }
    u_out[e] = u;
  }
}

}  // namespace

// x [m, k], w [k, n], bias [n] fp32 -> spikes [steps, m, n], u [m, n] fp32.
// The caller guarantees (k*n + n)*4 bytes fit in 48 KB of shared memory.
extern "C" int dense_conv_lif(const float* x, const float* w, const float* bias,
                              float* spikes, float* u_out, int m, int k, int n,
                              int steps, float beta, float theta,
                              cudaStream_t stream) {
  const long long elems = (long long)m * n;
  long long blocks = (elems + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  const size_t smem = (size_t)(k * n + n) * sizeof(float);
  dense_conv_lif_kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      x, w, bias, spikes, u_out, m, k, n, steps, beta, theta);
  return (int)cudaGetLastError();
}
