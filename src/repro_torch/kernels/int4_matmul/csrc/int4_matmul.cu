// W4A16 matmul: activations times packed int4 weights, CUDA C++ for sm_90a.
//
// Replaces the TPU kernel `int4_matmul` (src/repro/kernels/int4_matmul/
// int4_matmul.py, body `_int4_matmul_kernel`), which `w4a16_linear` calls
// and examples/serve_lm_w4.py reaches.
//
// What it computes: x [M, K] (fp32 or bf16) @ w [K, N] -> [M, N] fp32,
// where w[k, 2j] is the sign-extended low nibble of packed[k, j] (int8) and
// w[k, 2j+1] the high one, then times scale[n] once, after the sum (the
// TPU kernel scales at its last k step). bf16 x is widened to fp32; the
// int4 values are exact in either type, so every product is the one the
// TPU kernel's f32-accumulating dot forms.
//
// What bounds it on an H100: at decode widths (M = 4 slots) the packed
// weights, K*N/2 bytes read once at 3.35 TB/s; at prefill widths (M = 512)
// the 2*M*K*N fp32 operations on the CUDA cores (67 TFLOP/s).
// Design: weights stay packed in device memory and are unpacked in
// registers, never staged as floats. A block owns 4 output rows and 256
// output columns; each lane owns 8 columns, so one 32-bit load per k brings
// its 8 nibbles and a warp reads 128 contiguous bytes of a packed row. The
// block's 8 warps split K into 8 contiguous ranges (enough loads in flight
// to stream the weights at M = 4, where the grid has only N / 256 blocks
// of columns), each sums its range k ascending in registers, and the
// partial sums are added in warp order through shared memory:
// deterministic, and a row's result does not depend on M. Ragged M, K and
// N are masked in the kernel (no padding); N must be even. No tensor
// cores: a wgmma path with in-register dequantization is left for a later
// change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 4;                  // output rows per block
constexpr int kLaneCols = 8;              // output columns per lane (one 32-bit word)
constexpr int kTileN = 32 * kLaneCols;    // output columns per block
static_assert(kThreads == kTileN, "the epilogue gives each thread one column");

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// grid (ceil(N/256), ceil(M/4)).
template <typename T>
__global__ void __launch_bounds__(kThreads)
int4_matmul_kernel(const T* __restrict__ x, const uint8_t* __restrict__ packed,
                   const float* __restrict__ scale, float* __restrict__ out,
                   int m, int k, int n) {
  __shared__ float part[kWarps][kRows][kTileN];      // 32 KB
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m0 = blockIdx.y * kRows, n0 = blockIdx.x * kTileN;
  const int col0 = n0 + lane * kLaneCols;
  const int half_n = n / 2;
  const int rows = min(kRows, m - m0);
  const int span = (k + kWarps - 1) / kWarps;
  const int k_begin = min(k, warp * span), k_end = min(k, k_begin + span);
  // one aligned 32-bit load per k where the lane's 8 columns lie inside N
  // and packed rows are word aligned; masked byte loads otherwise
  const bool word = (half_n % 4 == 0) && (col0 + kLaneCols <= n);
  const uint8_t* wp = packed + col0 / 2;

  float acc[kRows][kLaneCols];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int j = 0; j < kLaneCols; ++j) acc[r][j] = 0.f;

#pragma unroll 4
  for (int kk = k_begin; kk < k_end; ++kk) {
    const uint8_t* row = wp + (size_t)kk * half_n;
    uint32_t bits = 0;
    if (word) {
      bits = __ldg(reinterpret_cast<const uint32_t*>(row));
    } else {
#pragma unroll
      for (int b = 0; b < 4; ++b)
        if (col0 + 2 * b < n) bits |= (uint32_t)__ldg(row + b) << (8 * b);
    }
    // nibble j of the little-endian word is column col0 + j
    float w[kLaneCols];
#pragma unroll
    for (int j = 0; j < kLaneCols; ++j)
      w[j] = (float)((int)(((bits >> (4 * j)) & 0xFu) ^ 8u) - 8);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r < rows) {
        const float xv = to_float(x[(size_t)(m0 + r) * k + kk]);
#pragma unroll
        for (int j = 0; j < kLaneCols; ++j) acc[r][j] = fmaf(xv, w[j], acc[r][j]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int j = 0; j < kLaneCols; ++j) part[warp][r][lane * kLaneCols + j] = acc[r][j];
  __syncthreads();

  const int c = threadIdx.x, col = n0 + c;
  if (col >= n) return;
  const float s = scale[col];
  for (int r = 0; r < rows; ++r) {
    float sum = part[0][r][c];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) sum += part[w][r][c];
    out[(size_t)(m0 + r) * n + col] = sum * s;
  }
}

}  // namespace

// x [m, k] (fp32, or bf16 when x_bf16), packed [k, n/2] int8, scale [n]
// fp32, out [m, n] fp32, all contiguous. The caller guarantees m, n > 0,
// n even and ceil(m/4) <= 65535.
extern "C" int int4_matmul(const void* x, int x_bf16, const void* packed,
                           const float* scale, float* out, int m, int k, int n,
                           cudaStream_t stream) {
  const dim3 grid((n + kTileN - 1) / kTileN, (m + kRows - 1) / kRows);
  const uint8_t* wp = static_cast<const uint8_t*>(packed);
  if (x_bf16)
    int4_matmul_kernel<__nv_bfloat16><<<grid, kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(x), wp, scale, out, m, k, n);
  else
    int4_matmul_kernel<float><<<grid, kThreads, 0, stream>>>(
        static_cast<const float*>(x), wp, scale, out, m, k, n);
  return (int)cudaGetLastError();
}
