// In-kernel-gated binary-spike matmul (the pre-fusion sparse core), CUDA
// C++ for sm_90a.
//
// Replaces the TPU kernel `spike_matmul` (src/repro/kernels/spike_conv/
// spike_conv.py, body `_spike_matmul_kernel`), which the unfused pipeline
// (src/repro/models/vgg9.py, `vgg9_infer_hybrid_unfused`) launches once per
// timestep and spiking layer through `spike_conv2d`.
//
// What it computes: patches [M, K] (0/1 spikes, fp32) @ w [K, N] -> [M, N]
// fp32. With `gate`, a (64-row x 32-deep) tile of patches that holds no
// nonzero skips its weight-tile load and its FMAs; the test is made inside
// the kernel, on the tile the block has just loaded (the baseline that the
// occupancy-mapped kernel improves on: every tile is read to find out it is
// empty). With `gate` off nothing is skipped.
//
// Sum order: every output element is accumulated in one register, k
// ascending, one multiply-add per k, starting from 0 — the same order as
// `spike_matmul_mapped.cu`. Inputs are 0/1, so each product is exact and an
// FMA rounds exactly like a multiply then an add; a skipped tile would only
// have added zeros. So a row's result does not depend on M, on the tiles
// around it, or on the gate, and the unfused pipeline (this kernel, T
// launches per layer) matches the fused one (one launch over T*B rows) bit
// for bit.
//
// What bounds it on an H100: fp32 FMA work on the CUDA cores (67 TFLOP/s)
// over the occupied tiles, against one read of the patches; at 8 images a
// timestep's M is 512..8192, so conv4-conv6 give only 64-80 output tiles.
// Design: one block of 256 threads per 64x64 output tile, so that small M
// still puts 64+ blocks on the 132 SMs; each thread keeps a 4x4 fp32
// accumulator in registers; the block walks the k tiles itself (the TPU's
// sequential k grid axis), staging 32-deep slices of patches (transposed)
// and weights through shared memory with 16-byte loads. The occupancy test
// is `__syncthreads_or` over the slice just loaded, which is also the
// barrier before the slice is read. wgmma/TMA pipelining is left for a
// later change.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileM = 64;    // output rows per block (and gate tile rows)
constexpr int kTileN = 64;    // output columns per block
constexpr int kTileK = 32;    // k depth per staged slice (and gate tile depth)

// grid (N/64, M/64). Thread (ty, tx) owns rows ty*4.. and columns tx*4.. of
// the block's 64x64 output tile.
__global__ void __launch_bounds__(kThreads)
spike_matmul_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    float* __restrict__ out, int k_pad, int n_pad, int gate) {
  __shared__ __align__(16) float xs[kTileK][kTileM + 4];   // transposed x
  __shared__ __align__(16) float ws[kTileK][kTileN];
  const int m0 = blockIdx.y * kTileM, n0 = blockIdx.x * kTileN;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < k_pad; k0 += kTileK) {
    // 64 rows x 32 columns = 512 float4, two per thread
    int hit = 0;
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int i = tid + p * kThreads;
      const int r = i / (kTileK / 4), c = (i % (kTileK / 4)) * 4;
      const float4 v = *reinterpret_cast<const float4*>(
          x + (size_t)(m0 + r) * k_pad + k0 + c);
      xs[c + 0][r] = v.x;
      xs[c + 1][r] = v.y;
      xs[c + 2][r] = v.z;
      xs[c + 3][r] = v.w;
      hit |= (v.x != 0.f) | (v.y != 0.f) | (v.z != 0.f) | (v.w != 0.f);
    }
    // barrier for xs, and the block-wide occupancy of this tile
    if (!__syncthreads_or(hit) && gate) continue;
    // 32 rows x 64 columns of w = 512 float4, two per thread
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int i = tid + p * kThreads;
      const int r = i / (kTileN / 4), c = (i % (kTileN / 4)) * 4;
      *reinterpret_cast<float4*>(&ws[r][c]) = *reinterpret_cast<const float4*>(
          w + (size_t)(k0 + r) * n_pad + n0 + c);
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kTileK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[k][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&ws[k][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * bv[j];
    }
    __syncthreads();   // before the next slice overwrites xs and ws
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
    *reinterpret_cast<float4*>(out + (size_t)(m0 + ty * 4 + i) * n_pad + n0 +
                               tx * 4) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
}

}  // namespace

// x [m_pad, k_pad], w [k_pad, n_pad], out [m_pad, n_pad] fp32. The caller
// guarantees m_pad % 64 == 0, k_pad % 32 == 0 and n_pad % 64 == 0.
extern "C" int spike_matmul(const float* x, const float* w, float* out,
                            int m_pad, int k_pad, int n_pad, int gate,
                            cudaStream_t stream) {
  spike_matmul_kernel<<<dim3(n_pad / kTileN, m_pad / kTileM), kThreads, 0,
                        stream>>>(x, w, out, k_pad, n_pad, gate);
  return (int)cudaGetLastError();
}
