// Occupancy-gated binary-spike matmul (the sparse core), CUDA C++ for sm_90a.
//
// Replaces the TPU kernel `spike_matmul_mapped` (src/repro/kernels/spike_conv/
// spike_conv.py, body `_spike_matmul_mapped_kernel`) together with its
// `occupancy_map` pre-pass (src/repro/kernels/spike_conv/ops.py).
//
// What it computes: patches [M, K] (0/1 spikes, fp32) @ w [K, N] -> [M, N]
// fp32, skipping every (bm x bk) tile of patches whose occupancy bit is 0,
// plus the occupancy stats at the plan's tile geometry:
//   row_occ int8  [M, K/bk]   1 iff the row has a spike inside the k tile
//   occ     int32 [M/bm, K/bk] OR of row_occ over each bm rows (all ones
//                              when gating is off)
//
// What bounds it on an H100: at the serving shapes (M 1024..16384, K
// 640..4608, N 128..640) the product is fp32 FMA work on the CUDA cores
// (67 TFLOP/s) over the occupied tiles, against one read of the patches
// (up to 42 MB) at 3.35 TB/s; the deep convs are bound by operations, conv1
// by bytes. Design: the pre-pass reads the patches once, a warp per row and
// k tile, vector loads of 16 bytes a lane. The product runs one block per
// (128-row tile, 128-column tile); a block reads the occupancy word of each
// k tile and skips an empty one whole (no load, no FMA), so silent spikes
// cost nothing but that word. Each thread keeps an 8x8 fp32 accumulator in
// registers over 16-deep k steps staged through shared memory. Inputs are
// 0/1, so every product is exact and only the order of the sum differs from
// the plain version. wgmma/TMA pipelining is left for a later change.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileM = 128;   // rows per product block (divides the plan's bm)
constexpr int kTileN = 128;   // output columns per product block
constexpr int kStepK = 16;    // k depth staged through shared memory per step

// grid (M/bm, K/bk): one block per occupancy tile. Warp w scans rows
// w, w+8, ...; lane l reads columns 4l.. of the k tile as float4.
__global__ void __launch_bounds__(kThreads)
occupancy_kernel(const float* __restrict__ x, int8_t* __restrict__ row_occ,
                 int32_t* __restrict__ occ, int k_pad, int bm, int bk, int nk,
                 int gate) {
  const int mt = blockIdx.x, kt = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int tile_hit = 0;
  for (int r = warp; r < bm; r += kThreads / 32) {
    const size_t row = (size_t)mt * bm + r;
    const float* p = x + row * k_pad + (size_t)kt * bk;
    int hit = 0;
    for (int c = lane * 4; c < bk; c += 128) {
      const float4 v = *reinterpret_cast<const float4*>(p + c);
      hit |= (v.x != 0.f) | (v.y != 0.f) | (v.z != 0.f) | (v.w != 0.f);
    }
    hit = __any_sync(0xffffffffu, hit);
    if (lane == 0) row_occ[row * nk + kt] = (int8_t)hit;
    tile_hit |= hit;
  }
  tile_hit = __syncthreads_or(tile_hit);
  if (threadIdx.x == 0) occ[(size_t)mt * nk + kt] = gate ? (tile_hit != 0) : 1;
}

// grid (N/128, M/128). Thread (ty, tx) owns rows ty*8.. and columns tx*8..
// of the block's 128x128 output tile.
__global__ void __launch_bounds__(kThreads)
gated_matmul_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    const int32_t* __restrict__ occ, float* __restrict__ out,
                    int k_pad, int n_pad, int bm, int bk, int nk) {
  __shared__ __align__(16) float xs[kStepK][kTileM + 4];   // transposed x
  __shared__ __align__(16) float ws[kStepK][kTileN];
  const int m0 = blockIdx.y * kTileM, n0 = blockIdx.x * kTileN;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int32_t* occ_row = occ + (size_t)(m0 / bm) * nk;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    if (occ_row[kt] == 0) continue;          // same word for the whole block
    for (int k0 = kt * bk; k0 < (kt + 1) * bk; k0 += kStepK) {
      for (int i = tid; i < kTileM * kStepK / 4; i += kThreads) {
        const int r = i / (kStepK / 4), c = (i % (kStepK / 4)) * 4;
        const float4 v = *reinterpret_cast<const float4*>(
            x + (size_t)(m0 + r) * k_pad + k0 + c);
        xs[c + 0][r] = v.x;
        xs[c + 1][r] = v.y;
        xs[c + 2][r] = v.z;
        xs[c + 3][r] = v.w;
      }
      for (int i = tid; i < kStepK * kTileN / 4; i += kThreads) {
        const int r = i / (kTileN / 4), c = (i % (kTileN / 4)) * 4;
        *reinterpret_cast<float4*>(&ws[r][c]) = *reinterpret_cast<const float4*>(
            w + (size_t)(k0 + r) * n_pad + n0 + c);
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kStepK; ++k) {
        const float4 a0 = *reinterpret_cast<const float4*>(&xs[k][ty * 8]);
        const float4 a1 = *reinterpret_cast<const float4*>(&xs[k][ty * 8 + 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&ws[k][tx * 8]);
        const float4 b1 = *reinterpret_cast<const float4*>(&ws[k][tx * 8 + 4]);
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] += a[i] * b[j];
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float* o = out + (size_t)(m0 + ty * 8 + i) * n_pad + n0 + tx * 8;
    *reinterpret_cast<float4*>(o) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(o + 4) =
        make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
}

}  // namespace

// x [m_pad, k_pad], w [k_pad, n_pad], out [m_pad, n_pad] fp32;
// row_occ int8 [m_pad, k_pad/bk]; occ int32 [m_pad/bm, k_pad/bk].
// The caller guarantees m_pad % bm == 0, bm % 128 == 0, k_pad % bk == 0,
// bk % 16 == 0 and n_pad % 128 == 0.
extern "C" int spike_matmul_mapped(const float* x, const float* w, float* out,
                                   int8_t* row_occ, int32_t* occ, int m_pad,
                                   int k_pad, int n_pad, int bm, int bk,
                                   int gate, cudaStream_t stream) {
  const int nk = k_pad / bk;
  occupancy_kernel<<<dim3(m_pad / bm, nk), kThreads, 0, stream>>>(
      x, row_occ, occ, k_pad, bm, bk, nk, gate);
  gated_matmul_kernel<<<dim3(n_pad / kTileN, m_pad / kTileM), kThreads, 0,
                        stream>>>(x, w, occ, out, k_pad, n_pad, bm, bk, nk);
  return (int)cudaGetLastError();
}
