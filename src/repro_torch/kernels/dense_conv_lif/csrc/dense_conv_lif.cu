// Dense core: direct-coded input conv fused with T LIF steps, CUDA C++ for
// sm_90a.
//
// Replaces the TPU kernel `dense_conv_lif` (src/repro/kernels/dense_conv_lif/
// dense_conv_lif.py, body `_dense_conv_lif_kernel`).
//
// What it computes: current = patches [M, K] @ w [K, N] + b, once (direct
// coding repeats the image every timestep), then T LIF steps from u = s = 0:
//   u = beta*u + current - s*theta ;  s = u > theta ;  spikes[t] = s
// and the final u. The K-deep dot sums k = 0..K-1 in order with separate
// roundings (`dense_conv_lif_ordered_plain` in ops.py is the same sum in
// PyTorch). As in the spiking-layer epilogue, beta*u + current is rounded
// once (computed in double, where beta*u is exact), which is how the JAX
// reference's fused multiply-add rounds it on the CPU; the explicit-rounding
// intrinsics keep nvcc from contracting anything else.
//
// What bounds it on an H100: bytes. At CIFAR10 with 8 images (M = 8192,
// K = 27, N = 64, T = 2) it reads 0.9 MB of patches and writes 6.3 MB of
// spikes and membranes for 28 MFLOP, about 4 flops per byte. Tensor cores
// are no use: K = 27 in fp32, and TF32 would round the products. Design:
// - a block owns kRows rows x all N channels, so it stages the weights and
//   bias (7 KB at K = 27, N = 64) once for kRows * N outputs, and the grid
//   (M / kRows blocks) still fills the card at M = 8192;
// - the block's patch tile is one contiguous run of kRows * K floats (16-byte
//   aligned for kRows % 4 == 0); it, w and the bias reach shared memory as
//   16-byte loads that a thread issues all at once before its shared stores
//   (a loop of load-then-store paid one round trip per iteration);
// - each thread owns kRowsPerThread rows x 4 adjacent channels (float4
//   weight reads from shared memory, each patch value a broadcast), so its
//   rows x 4 sums are independent chains; its rows are kRows /
//   kRowsPerThread apart, so a warp's stores cover whole adjacent rows;
// - the T spike planes and u leave as float4 streaming stores
//   (`st.global.cs`): nothing in the kernel reads them back;
// - no 64-bit division: a thread finds its rows and channels with one
//   32-bit division per micro-tile, and output offsets are products.
// Any N % 4 != 0 takes the same kernel one channel per thread.
// Timed on an H100 and not kept (PERF.md): staging with cp.async.bulk on an
// mbarrier (no faster), TMA bulk stores of the planes staged in shared
// memory (slower), reading patches and weights through L1 with no staging
// (slower), and finishing one row at a time so that stores start earlier
// (slower).

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kStageLoads = 8;     // 16-byte loads a thread has in flight while staging

// kC adjacent channels as one value: float4 or float
template <int kC> struct Lanes;
template <> struct Lanes<4> {
  static __device__ __forceinline__ void load(const float* p, float* v) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  }
};
template <> struct Lanes<1> {
  static __device__ __forceinline__ void load(const float* p, float* v) { v[0] = *p; }
  static __device__ __forceinline__ void store(float* p, const float* v) { __stcs(p, v[0]); }
};

// Copy the block's patch tile (tile floats at xt) into xs and, where kC ==
// 4, w (k*n floats) and the bias (n) into ws and bs, as 16-byte loads: each
// thread issues its kStageLoads loads of a pass before any shared store,
// so a pass costs one round trip (one pass at the served shape). The
// tile's last tile % 4 floats, and w and the bias where kC == 1, go one
// float at a time.
template <int kC>
__device__ __forceinline__ void stage(float* xs, float* ws, float* bs, const float* xt,
                                      const float* w, const float* bias, int tile, int k,
                                      int n) {
  const int t4 = tile / 4;
  const int w4 = kC == 4 ? k * n / 4 : 0;
  const int total = t4 + w4 + (kC == 4 ? n / 4 : 0);
  for (int base = threadIdx.x; base < total; base += kStageLoads * blockDim.x) {
    float4 v[kStageLoads];
#pragma unroll
    for (int j = 0; j < kStageLoads; ++j) {
      const int i = base + j * blockDim.x;
      if (i < t4) v[j] = __ldcs(reinterpret_cast<const float4*>(xt) + i);
      else if (i < t4 + w4) v[j] = __ldg(reinterpret_cast<const float4*>(w) + (i - t4));
      else if (i < total) v[j] = __ldg(reinterpret_cast<const float4*>(bias) + (i - t4 - w4));
    }
#pragma unroll
    for (int j = 0; j < kStageLoads; ++j) {
      const int i = base + j * blockDim.x;
      float4* dst = i < t4        ? reinterpret_cast<float4*>(xs) + i
                    : i < t4 + w4 ? reinterpret_cast<float4*>(ws) + (i - t4)
                                  : reinterpret_cast<float4*>(bs) + (i - t4 - w4);
      if (i < total) *dst = v[j];
    }
  }
  for (int i = t4 * 4 + threadIdx.x; i < tile; i += blockDim.x) xs[i] = xt[i];
  if (kC == 1) {
    for (int i = threadIdx.x; i < k * n; i += blockDim.x) ws[i] = w[i];
    for (int i = threadIdx.x; i < n; i += blockDim.x) bs[i] = bias[i];
  }
}

// kRows output rows a block, kRowsPerThread of them a thread, kC (4 or 1)
// adjacent channels a thread.
template <int kRows, int kRowsPerThread, int kC>
__global__ void __launch_bounds__(kMaxThreads)
dense_conv_lif_kernel(const float* __restrict__ x, const float* __restrict__ w,
                      const float* __restrict__ bias, float* __restrict__ spikes,
                      float* __restrict__ u_out, int m, int k, int n, int steps,
                      float beta, float theta) {
  constexpr int kLanes = kRows / kRowsPerThread;   // a thread's rows are kLanes apart
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                // [kRows, k] patch tile
  float* ws = xs + kRows * k;      // [k, n] weights (16-byte aligned: kRows % 4 == 0)
  float* bs = ws + k * n;          // [n] bias

  const int row0 = blockIdx.x * kRows;
  const int tile_rows = min(kRows, m - row0);
  stage<kC>(xs, ws, bs, x + (size_t)row0 * k, w, bias, tile_rows * k, k, n);
  __syncthreads();

  const double beta_d = (double)beta;
  const size_t plane = (size_t)m * n;
  const int groups = n / kC;
  for (int item = threadIdx.x; item < kLanes * groups; item += blockDim.x) {
    const int lane = item / groups;
    const int c0 = (item - lane * groups) * kC;
    float acc[kRowsPerThread][kC];
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r)
#pragma unroll
      for (int c = 0; c < kC; ++c) acc[r][c] = 0.f;
    const float* xr = xs + lane * k;
#pragma unroll 3
    for (int kk = 0; kk < k; ++kk) {
      float wv[kC];
      Lanes<kC>::load(ws + kk * n + c0, wv);
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
        const float xv = xr[r * kLanes * k + kk];
#pragma unroll
        for (int c = 0; c < kC; ++c) acc[r][c] = __fadd_rn(acc[r][c], __fmul_rn(xv, wv[c]));
      }
    }
    float bv[kC];
    Lanes<kC>::load(bs + c0, bv);
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
      const int row = lane + r * kLanes;
      if (row >= tile_rows) break;
      double cur[kC];
      float u[kC], s[kC];
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        cur[c] = (double)__fadd_rn(acc[r][c], bv[c]);
        u[c] = 0.f;
        s[c] = 0.f;
      }
      const size_t at = (size_t)(row0 + row) * n + c0;
      for (int t = 0; t < steps; ++t) {
#pragma unroll
        for (int c = 0; c < kC; ++c) {
          const float decayed = __double2float_rn(
              __dadd_rn(__dmul_rn(beta_d, (double)u[c]), cur[c]));
          u[c] = __fsub_rn(decayed, __fmul_rn(s[c], theta));
          s[c] = u[c] > theta ? 1.f : 0.f;
        }
        Lanes<kC>::store(spikes + plane * t + at, s);
      }
      Lanes<kC>::store(u_out + at, u);
    }
  }
}

using Kernel = void (*)(const float*, const float*, const float*, float*, float*, int, int,
                        int, int, float, float);

// the (rows, rows per thread) of DENSE_GEOMETRY in ops.py
Kernel pick(int rows, int rows_per_thread, bool vector) {
#define GEOMETRY(R, P)                                                            \
  if (rows == R && rows_per_thread == P)                                          \
    return vector ? &dense_conv_lif_kernel<R, P, 4> : &dense_conv_lif_kernel<R, P, 1>;
  GEOMETRY(32, 4)
#undef GEOMETRY
  return nullptr;
}

}  // namespace

// x [m, k], w [k, n], bias [n] fp32 -> spikes [steps, m, n], u [m, n] fp32,
// all 16-byte aligned. rows, rows_per_thread and threads come from
// `dense_geometry` in ops.py, which keeps (rows*k + k*n + n)*4 bytes of
// shared memory within 48 KB. Returns cudaErrorInvalidValue, launching
// nothing, for a combination the kernel does not take.
extern "C" int dense_conv_lif(const float* x, const float* w, const float* bias,
                              float* spikes, float* u_out, int m, int k, int n,
                              int steps, float beta, float theta, int rows,
                              int rows_per_thread, int threads, cudaStream_t stream) {
  const Kernel kernel = pick(rows, rows_per_thread, n % 4 == 0);
  const size_t smem = (size_t)(rows * k + k * n + n) * sizeof(float);
  if (kernel == nullptr || m < 1 || k < 1 || n < 1 || steps < 1 || threads < 1 ||
      threads > kMaxThreads || smem > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)((m + rows - 1) / rows), threads, smem, stream>>>(
      x, w, bias, spikes, u_out, m, k, n, steps, beta, theta);
  return (int)cudaGetLastError();
}
