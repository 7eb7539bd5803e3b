// Causal flash attention (online softmax), CUDA C++ for sm_90a.
//
// Replaces the TPU kernel `flash_attention_fwd` (src/repro/kernels/
// flash_attention/flash_attention.py, body `_flash_kernel`), which the GQA
// wrapper `flash_attention` calls. It computes the same function as the
// model's own prefill attention (`models/attention.py`,
// `chunked_causal_attention`).
//
// What it computes: q, k, v [BH, S, hd] (fp32 or bf16, widened to fp32 on
// load) -> o [BH, S, hd] in q's dtype, causal softmax(q k^T / sqrt(hd)) v,
// with the TPU kernel's numerics: q is scaled first, masked scores are
// -1e30 (not -inf, so exp(m_prev - m_new) never forms inf - inf), each KV
// tile rescales the running sum and accumulator by alpha = exp(m_prev -
// m_new), and the output is acc / max(l, 1e-30).
//
// What bounds it on an H100: the two products, 4 * S^2/2 * hd operations per
// head (causal half), on the CUDA cores in fp32 (67 TFLOP/s); q, k, v and o
// are read and written once. The score matrix never leaves the SM.
// Design: one block of 256 threads per (head, 64-row q tile). The block
// keeps its q tile (pre-scaled, transposed) in shared memory and walks the
// KV tiles from 0 to the diagonal: tiles wholly in the future are never
// loaded (the TPU kernel's causal block skip). Per tile it stages K
// (transposed), forms a 64x64 score tile (4x4 per thread, d ascending),
// reduces each row's max and sum over the 16 threads that share the row
// with warp shuffles, writes P (transposed) to shared memory, then stages V
// in K's buffer and adds P V (4 rows x hd/16 columns per thread, in
// registers, with m and l). Shared memory: q 34 KB + K/V 34 KB + P 17 KB
// at hd = 128, so two blocks fit on an SM. No tensor cores and no
// asynchronous copies yet: a wgmma / TMA pipeline is a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kPad = 4;                     // keeps rows 16-byte aligned, spreads banks
constexpr float kNegInf = -1e30f;

constexpr int cmax(int a, int b) { return a > b ? a : b; }
template <int HD> struct Smem {
  static constexpr int q = HD * (kBlockQ + kPad);                        // q^T
  static constexpr int kv = cmax(HD * (kBlockK + kPad), kBlockK * (HD + kPad));
  static constexpr int p = kBlockK * (kBlockQ + kPad);                   // P^T
  static constexpr int bytes = (q + kv + p) * (int)sizeof(float);
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);                // round to nearest even, as torch casts
}

// grid (ceil(S/64), BH). Thread (ty, tx) = (tid / 16, tid % 16) owns q rows
// ty*4 .. ty*4+3 of the tile: score columns tx*4 .. tx*4+3 of each KV tile,
// and output columns tx*CPT .. tx*CPT+CPT-1.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int s, float scale) {
  constexpr int CPT = HD / 16;
  static_assert(CPT % 4 == 0, "hd must be a multiple of 64");
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;                        // [HD][kBlockQ + kPad]
  float* kv = qt + Smem<HD>::q;            // K^T [HD][kBlockK + kPad], then V [kBlockK][HD + kPad]
  float* pt = kv + Smem<HD>::kv;           // P^T [kBlockK][kBlockQ + kPad]

  const int tile = blockIdx.x, q0 = tile * kBlockQ;
  const size_t base = (size_t)blockIdx.y * s * HD;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  for (int i = tid; i < kBlockQ * HD; i += kThreads) {
    const int r = i / HD, c = i % HD, row = q0 + r;
    qt[c * (kBlockQ + kPad) + r] = row < s ? to_float(q[base + (size_t)row * HD + c]) * scale : 0.f;
  }

  float m_i[4], l_i[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = kNegInf;
    l_i[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  // KV tiles 0 .. tile: kBlockK == kBlockQ, so tile `tile` holds the diagonal
  for (int kt = 0; kt <= tile; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();                       // q loaded / last tile's V and P read
    for (int i = tid; i < kBlockK * HD; i += kThreads) {
      const int r = i / HD, c = i % HD, row = k0 + r;
      kv[c * (kBlockK + kPad) + r] = row < s ? to_float(k[base + (size_t)row * HD + c]) : 0.f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&qt[d * (kBlockQ + kPad) + ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&kv[d * (kBlockK + kPad) + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(av[i], bv[j], sc[i][j]);
    }

    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (k0 + tx * 4 + j > qpos) sc[i][j] = kNegInf;
        mx = fmaxf(mx, sc[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)   // the 16 threads of this row
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_i[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sc[i][j] = expf(sc[i][j] - m_new);
        sum += sc[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      alpha[i] = expf(m_i[i] - m_new);
      l_i[i] = l_i[i] * alpha[i] + sum;
      m_i[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&pt[(tx * 4 + j) * (kBlockQ + kPad) + ty * 4]) =
          make_float4(sc[0][j], sc[1][j], sc[2][j], sc[3][j]);
    __syncthreads();                       // K^T read by all: its buffer takes V

    for (int i = tid; i < kBlockK * HD; i += kThreads) {
      const int r = i / HD, c = i % HD, row = k0 + r;
      kv[r * (HD + kPad) + c] = row < s ? to_float(v[base + (size_t)row * HD + c]) : 0.f;
    }
    __syncthreads();

    float pv[4][CPT];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < CPT; ++c) pv[i][c] = 0.f;
#pragma unroll 4
    for (int j = 0; j < kBlockK; ++j) {
      const float4 a = *reinterpret_cast<const float4*>(&pt[j * (kBlockQ + kPad) + ty * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      float vv[CPT];
#pragma unroll
      for (int c = 0; c < CPT; c += 4) {
        const float4 b = *reinterpret_cast<const float4*>(&kv[j * (HD + kPad) + tx * CPT + c]);
        vv[c] = b.x;
        vv[c + 1] = b.y;
        vv[c + 2] = b.z;
        vv[c + 3] = b.w;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) pv[i][c] = fmaf(av[i], vv[c], pv[i][c]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] = acc[i][c] * alpha[i] + pv[i][c];
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= s) continue;
    const float denom = fmaxf(l_i[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < CPT; ++c)
      o[base + (size_t)row * HD + tx * CPT + c] = from_float<T>(acc[i][c] / denom);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int bh, int s,
           float scale, cudaStream_t stream) {
  auto kernel = flash_attention_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<HD>::bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3((s + kBlockQ - 1) / kBlockQ, bh), kThreads, Smem<HD>::bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), s, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, o [bh, s, hd] contiguous, fp32 (bf16 = 0) or bf16 (bf16 = 1).
// hd must be 64 or 128; the caller guarantees bh <= 65535 and s > 0.
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* o,
                               int bf16, int bh, int s, int hd, float scale,
                               cudaStream_t stream) {
  if (hd == 128)
    return bf16 ? launch<__nv_bfloat16, 128>(q, k, v, o, bh, s, scale, stream)
                : launch<float, 128>(q, k, v, o, bh, s, scale, stream);
  if (hd == 64)
    return bf16 ? launch<__nv_bfloat16, 64>(q, k, v, o, bh, s, scale, stream)
                : launch<float, 64>(q, k, v, o, bh, s, scale, stream);
  return (int)cudaErrorInvalidValue;
}
