// Causal flash attention (online softmax), CUDA C++ for sm_90a: one design
// per input type, behind one entry point.
//
// Replaces the TPU kernel `flash_attention_fwd` (src/repro/kernels/
// flash_attention/flash_attention.py, body `_flash_kernel`), which the GQA
// wrapper `flash_attention` calls. It computes the same function as the
// model's own prefill attention (`models/attention.py`,
// `chunked_causal_attention`).
//
// What it computes: q, k, v [BH, S, hd] (hd 64 or 128, fp32 or bf16) -> o
// [BH, S, hd] in q's dtype, causal softmax(q k^T / sqrt(hd)) v accumulated
// in fp32, with the TPU kernel's numerics: masked scores are -1e30 (not
// -inf, so exp(m_prev - m_new) never forms inf - inf), each KV tile
// rescales the running sum and accumulator by alpha = exp(m_prev - m_new),
// and the output is acc / max(l, 1e-30). KV tiles wholly in the future of
// a q tile are never loaded (the TPU kernel's causal block skip). A block
// owns one (head, q tile); the q tiles that see the most KV tiles are
// scheduled first (a 1-D grid, head fastest, q tile descending), so the
// light tiles fill the last wave. No atomics: two calls give the same bits.
//
// What bounds it on an H100: the two products, 4 * hd * S(S+1)/2
// operations per head over the causal pairs; q, k, v and o cross device
// memory once (the score matrix never leaves the SM). fp32 inputs run on
// the CUDA cores (67 TFLOP/s, no TF32); bf16 inputs on the tensor cores
// (989 TFLOP/s dense).
//
// fp32 (`flash_fp32_kernel`): a group of 128 threads walks 64-row KV
// tiles for a 64-row q tile. What bounds a SIMT product is shared-memory
// traffic: an SM reads 32 floats a clock and does 128 FMAs, so operands
// must come at 0.25 floats per FMA or less. Each thread keeps an 8 x 4
// score micro-tile (q rows ty*8.., keys tx + 16j; 12 float4 reads per 128
// FMAs, 0.375, the q reads shared by 16 lanes) and an 8 x hd/16 output
// micro-tile (P^T and V rows as float4, 0.25 at hd = 128). K and V have
// buffers of their own, filled by cp.async: V's copy overlaps Q K^T and
// the next K's copy overlaps P V. K and P^T are stored with their 16-byte
// chunks XOR-swizzled by row, so the column reads of K and the transposed
// writes of P are free of bank conflicts without padding: 112 KB of shared
// memory at hd = 128, two blocks an SM. Where two blocks an SM would not
// fill the card (S = 512 at 20 heads: 160 blocks), a block holds two such
// groups that take the even and the odd KV tiles, each with its own max,
// sum and accumulator, merged at the end in a fixed order (the same alpha
// rescale): the heaviest q tile's walk is halved. q is scaled when it is
// staged (the TPU kernel's order), and each output sums d and k ascending.
//
// bf16 (`flash_bf16_kernel`): q, k and v come by TMA, and both products
// run on `wgmma`. One producer thread issues the TMA loads: the block's q
// rows once, then K and V tiles of 128 rows into a 2-stage ring (a full
// barrier each for K and V, so Q K^T starts before V lands, and an empty
// barrier the consumers release). One or two consumer warpgroups own 64 q
// rows each: 128-row q tiles, or 64-row ones where 128-row tiles would give
// fewer blocks than SMs (S = 512 at 20 heads). `setmaxnreg` moves registers
// from the producer warpgroup to the consumers. S = Q K^T is `wgmma`
// m64n128k16 from shared memory (both operands K-major, 128-byte swizzle:
// the TMA maps and the wgmma descriptors use the same swizzle, each
// 64-column panel 1024-byte aligned), accumulated in fp32. The online
// softmax runs on the accumulator fragment (row max and sum over the 4
// lanes that share a row); the max is taken over unscaled scores, and the
// scale 1/sqrt(hd) is applied in fp32 registers inside the exponent,
// exp(scale (x - m)) = 2^(x sl - m sl) with sl = scale log2(e), one FFMA
// and one ex2 per score (pre-scaling bf16 q would add a rounding). P is
// rounded to bf16 in registers: for a 16-bit A operand the accumulator's
// fragment is the register fragment wgmma reads, so O += P V is the
// register-A form, with V from shared memory as an MN-major operand (the
// transpose bit). l sums the unrounded fp32 p. The output is rounded to
// bf16 once, to nearest even; rows past S are not written. TMA tensor maps
// are 3-D over [BH, S, hd]: a tile never reads into the next head, and rows
// at or past S read as zeros, which the causal mask keeps out of every real
// row (each such key lies in the future of each real query). The two
// consumer warpgroups overlap each other's softmax with their products,
// unscheduled; the mask's compares run only on tiles that need them. What
// is left between this kernel and the tensor-core bound is likely mostly the
// softmax's CUDA-core work (an ex2 and a bf16 conversion per score) that
// the products do not hide.
//
// Link: the tensor maps are encoded on the host by libcuda's
// `cuTensorMapEncodeTiled`, looked up with dlsym (kernels/common/csrc/
// tma.cuh), so the library links against neither libcuda nor a newer
// runtime entry point.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../common/csrc/tma.cuh"   // mbarriers, smem_u32, encode_tiled

namespace {

constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------------------
// fp32: CUDA cores, register-blocked, cp.async
// ---------------------------------------------------------------------------

namespace fp32_path {

constexpr int kGroupThreads = 128;       // threads of one KV group
constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;

// q [64][hd] (scaled), then per KV group: K [64][hd] (swizzled), V
// [64][hd], P^T [64 keys][64 rows] (swizzled)
template <int HD, int SPLIT> struct Smem {
  static constexpr int q = kBlockQ * HD;                          // floats
  static constexpr int group = (2 * HD + kBlockQ) * kBlockK;
  static constexpr int bytes = (q + SPLIT * group) * (int)sizeof(float);
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
// barrier of one KV group (ids 1 and 2; 0 is __syncthreads)
__device__ __forceinline__ void group_sync(int g) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(g + 1), "n"(kGroupThreads) : "memory");
}

// rows row0 .. row0+63 of one head's [S, HD] into dst [64][HD] by the 128
// threads of a group; rows at or past S are zero-filled. SWIZZLE stores
// chunk c of row r at c ^ (r % 8).
template <int HD, bool SWIZZLE>
__device__ __forceinline__ void load_tile(float* dst, const float* src, int row0, int s, int gt) {
  constexpr int C4 = HD / 4;
#pragma unroll
  for (int i = gt; i < kBlockK * C4; i += kGroupThreads) {
    const int r = i / C4, c = i % C4, row = row0 + r;
    const int pc = SWIZZLE ? (c ^ (r & 7)) : c;
    cp_async16(dst + r * HD + pc * 4, src + (size_t)(row < s ? row : 0) * HD + c * 4, row < s);
  }
}

// One block per (head, 64-row q tile). With SPLIT = 2 its two groups of
// 128 threads take the even and the odd KV tiles, each with its own
// running max, sum and accumulator, and merge them at the end in a fixed
// order; with SPLIT = 1 one group takes them all.
template <int HD, int SPLIT>
__global__ void __launch_bounds__(SPLIT * kGroupThreads, 3 - SPLIT)
flash_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o, int bh, int s,
                  float scale) {
  using SM = Smem<HD, SPLIT>;
  constexpr int C4 = HD / 4, CH = HD / 64, NACC = 8 * 4 * CH;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int g = SPLIT == 1 ? 0 : tid / kGroupThreads, gt = SPLIT == 1 ? tid : tid % kGroupThreads;
  float* qs = smem;                                     // [64][HD], scaled
  float* ks = qs + SM::q + g * SM::group;               // this group's K, swizzled
  float* vs = ks + kBlockK * HD;                        // V
  float* pt = vs + kBlockK * HD;                        // P^T, swizzled

  const int n_tiles = (s + kBlockQ - 1) / kBlockQ;
  const int head = blockIdx.x % bh, tile = n_tiles - 1 - blockIdx.x / bh;
  const int q0 = tile * kBlockQ;
  const size_t base = (size_t)head * s * HD;
  // thread (ty, tx) of a group: q rows ty*8 .. ty*8+7; keys tx + 16j (j < 4)
  // of each KV tile; output columns 64h + tx*4 .. +3 (h < HD/64)
  const int tx = gt & 15, ty = gt >> 4;

  if (g <= tile) {
    load_tile<HD, true>(ks, k + base, g * kBlockK, s, gt);
    cp_async_commit();
  }
  for (int i = tid; i < kBlockQ * C4; i += SPLIT * kGroupThreads) {
    const int r = i / C4, c = i % C4, row = q0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < s) {
      x = *reinterpret_cast<const float4*>(q + base + (size_t)row * HD + c * 4);
      x = make_float4(x.x * scale, x.y * scale, x.z * scale, x.w * scale);
    }
    *reinterpret_cast<float4*>(qs + r * HD + c * 4) = x;
  }
  __syncthreads();

  float m_i[8], l_i[8], acc[8][4 * CH];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m_i[i] = kNegInf;
    l_i[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * CH; ++c) acc[i][c] = 0.f;
  }

  // KV tiles g, g + SPLIT, .. <= tile: kBlockK == kBlockQ, so tile `tile`
  // holds the diagonal
  for (int kt = g; kt <= tile; kt += SPLIT) {
    const int k0 = kt * kBlockK;
    load_tile<HD, false>(vs, v + base, k0, s, gt);       // overlaps Q K^T
    cp_async_commit();
    cp_async_wait<1>();                                  // this tile's K
    group_sync(g);

    float sc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 2
    for (int c = 0; c < C4; ++c) {
      float4 kb[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)   // row tx + 16j; (tx + 16j) % 8 == tx % 8
        kb[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * HD + ((c ^ (tx & 7)) * 4));
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 a = *reinterpret_cast<const float4*>(qs + (ty * 8 + i) * HD + c * 4);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sc[i][j] = fmaf(a.x, kb[j].x, sc[i][j]);
          sc[i][j] = fmaf(a.y, kb[j].y, sc[i][j]);
          sc[i][j] = fmaf(a.z, kb[j].z, sc[i][j]);
          sc[i][j] = fmaf(a.w, kb[j].w, sc[i][j]);
        }
      }
    }

    const bool diag = kt == tile;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int qpos = q0 + ty * 8 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (diag && k0 + tx + 16 * j > qpos) sc[i][j] = kNegInf;
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
      const float alpha = expf(m_i[i] - m_new);
      l_i[i] = l_i[i] * alpha + sum;
      m_i[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * CH; ++c) acc[i][c] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {   // P^T row tx + 16j: chunks 2ty, 2ty+1, swizzled by tx % 8
      float* prow = pt + (tx + 16 * j) * kBlockQ;
      *reinterpret_cast<float4*>(prow + (((2 * ty) ^ (tx & 7)) * 4)) =
          make_float4(sc[0][j], sc[1][j], sc[2][j], sc[3][j]);
      *reinterpret_cast<float4*>(prow + (((2 * ty + 1) ^ (tx & 7)) * 4)) =
          make_float4(sc[4][j], sc[5][j], sc[6][j], sc[7][j]);
    }
    cp_async_wait<0>();                                  // this tile's V
    group_sync(g);                                       // K read by the group; P, V visible
    if (kt + SPLIT <= tile) {
      load_tile<HD, true>(ks, k + base, k0 + SPLIT * kBlockK, s, gt);   // overlaps P V
      cp_async_commit();
    }

#pragma unroll 4
    for (int kk = 0; kk < kBlockK; ++kk) {
      const float* prow = pt + kk * kBlockQ;
      const float4 p0 = *reinterpret_cast<const float4*>(prow + (((2 * ty) ^ (kk & 7)) * 4));
      const float4 p1 = *reinterpret_cast<const float4*>(prow + (((2 * ty + 1) ^ (kk & 7)) * 4));
      const float pv[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
#pragma unroll
      for (int h = 0; h < CH; ++h) {
        const float4 b = *reinterpret_cast<const float4*>(vs + kk * HD + 64 * h + tx * 4);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          acc[i][4 * h] = fmaf(pv[i], b.x, acc[i][4 * h]);
          acc[i][4 * h + 1] = fmaf(pv[i], b.y, acc[i][4 * h + 1]);
          acc[i][4 * h + 2] = fmaf(pv[i], b.z, acc[i][4 * h + 2]);
          acc[i][4 * h + 3] = fmaf(pv[i], b.w, acc[i][4 * h + 3]);
        }
      }
    }
    group_sync(g);                                       // V and P read by the group
  }

  if (SPLIT == 1) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = q0 + ty * 8 + i;
      if (row >= s) continue;
      const float denom = fmaxf(l_i[i], 1e-30f);
#pragma unroll
      for (int h = 0; h < CH; ++h)
        *reinterpret_cast<float4*>(o + base + (size_t)row * HD + 64 * h + tx * 4) =
            make_float4(acc[i][4 * h] / denom, acc[i][4 * h + 1] / denom,
                        acc[i][4 * h + 2] / denom, acc[i][4 * h + 3] / denom);
    }
    return;
  }
  // merge: the odd group leaves (acc, m, l) in its own buffers,
  // thread-major; the even group rescales both by alpha = exp(m_group - m)
  // and writes acc / max(l, 1e-30)
  float* st = qs + SM::q + SM::group;
  if (g == 1) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int c = 0; c < 4 * CH; ++c) st[(i * 4 * CH + c) * kGroupThreads + gt] = acc[i][c];
      st[(NACC + i) * kGroupThreads + gt] = m_i[i];
      st[(NACC + 8 + i) * kGroupThreads + gt] = l_i[i];
    }
  }
  __syncthreads();
  if (g == 1) return;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = q0 + ty * 8 + i;
    if (row >= s) continue;
    const float m1 = st[(NACC + i) * kGroupThreads + gt];
    const float m = fmaxf(m_i[i], m1);
    const float a0 = expf(m_i[i] - m), a1 = expf(m1 - m);
    const float l = l_i[i] * a0 + st[(NACC + 8 + i) * kGroupThreads + gt] * a1;
    const float denom = fmaxf(l, 1e-30f);
    float r[4 * CH];
#pragma unroll
    for (int c = 0; c < 4 * CH; ++c)
      r[c] = (acc[i][c] * a0 + st[(i * 4 * CH + c) * kGroupThreads + gt] * a1) / denom;
#pragma unroll
    for (int h = 0; h < CH; ++h)
      *reinterpret_cast<float4*>(o + base + (size_t)row * HD + 64 * h + tx * 4) =
          make_float4(r[4 * h], r[4 * h + 1], r[4 * h + 2], r[4 * h + 3]);
  }
}

template <int HD, int SPLIT>
int launch(const void* q, const void* k, const void* v, void* o, int bh, int s, float scale,
           long long blocks, cudaStream_t stream) {
  auto kernel = flash_fp32_kernel<HD, SPLIT>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Smem<HD, SPLIT>::bytes);
  if (err == cudaSuccess)   // the largest carveout: two 112 KB blocks, or one of 192 KB
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)blocks, SPLIT * kGroupThreads, Smem<HD, SPLIT>::bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), bh, s, scale);
  return (int)cudaGetLastError();
}

// one group per block where two blocks an SM fill the card; else two
// groups, so that the heaviest q tile's KV walk is split in half
template <int HD>
int launch_for_card(const void* q, const void* k, const void* v, void* o, int bh, int s,
                    float scale, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)((s + kBlockQ - 1) / kBlockQ) * bh;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  return blocks >= 2LL * sms ? launch<HD, 1>(q, k, v, o, bh, s, scale, blocks, stream)
                             : launch<HD, 2>(q, k, v, o, bh, s, scale, blocks, stream);
}

}  // namespace fp32_path

// ---------------------------------------------------------------------------
// bf16: tensor cores through wgmma, operands through TMA
// ---------------------------------------------------------------------------

namespace bf16_path {

constexpr int kBlockK = 128;            // KV rows per stage
constexpr int kStages = 2;
constexpr int kPanel = 64;              // bf16 columns per 128-byte swizzled panel
constexpr int kProducerRegs = 40, kConsumerRegs = 232;   // 128*40 + 256*232 <= 65536

// Shared memory, each part 1024-byte aligned (the 128-byte swizzle's
// period): q [hd/64 panels][BM rows][64], then K and V stages [hd/64
// panels][128 rows][64], then the barriers.
template <int HD, int NC> struct Layout {
  static constexpr int BM = 64 * NC;                     // q rows per block
  static constexpr int threads = 128 * (NC + 1);
  static constexpr int panels = HD / kPanel;
  static constexpr int q_panel = BM * 128;               // bytes
  static constexpr int kv_panel = kBlockK * 128;
  static constexpr int q_bytes = panels * q_panel;
  static constexpr int kv_bytes = panels * kv_panel;     // one K or V tile
  static constexpr int k_off = q_bytes;
  static constexpr int v_off = k_off + kStages * kv_bytes;
  static constexpr int bar_off = v_off + kStages * kv_bytes;
  static constexpr int bytes = bar_off + 64 + 1024;      // + slack to align the base
};

// box (64 columns, rows, 1 head) at (c0, c1, c2) of a 3-D map into dst
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)),
         "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// returns once every wgmma this warpgroup committed has completed
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// pins an accumulator at this point of the program: no read of it moves
// above a wgmma wait, no write below a wgmma issue
template <int N> __device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading byte offset (unused for K-major; for MN-major the
// stride between 64-column panels), stride byte offset 1024 (between
// 8-row groups), swizzle mode 1 (128 bytes)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo_bytes) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo_bytes >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);    // round to nearest even
  return *reinterpret_cast<uint32_t*>(&v);
}

// d[0..64) += A(shared, K-major) x B(shared, K-major): m64n128k16, fp32 += bf16 x bf16
__device__ __forceinline__ void wgmma_ss_m64n128(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d[0..64) += A(registers) x B(shared, MN-major): m64n128k16, fp32 += bf16 x bf16
__device__ __forceinline__ void wgmma_rs_m64n128(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d[0..32) += A(registers) x B(shared, MN-major): m64n64k16, fp32 += bf16 x bf16
__device__ __forceinline__ void wgmma_rs_m64n64(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int HD>
__device__ __forceinline__ void wgmma_pv(float (&d)[HD / 2], const uint32_t (&a)[4], uint64_t b);
template <> __device__ __forceinline__ void wgmma_pv<128>(float (&d)[64], const uint32_t (&a)[4],
                                                          uint64_t b) {
  wgmma_rs_m64n128(d, a, b);
}
template <> __device__ __forceinline__ void wgmma_pv<64>(float (&d)[32], const uint32_t (&a)[4],
                                                         uint64_t b) {
  wgmma_rs_m64n64(d, a, b);
}

// One block per (head, q tile of 64 * NC rows): warpgroup 0 is the
// producer (one thread issues every TMA load), warpgroups 1 .. NC the
// consumers, 64 q rows each.
template <int HD, int NC>
__global__ void __launch_bounds__(Layout<HD, NC>::threads, 1)
flash_bf16_kernel(const __grid_constant__ CUtensorMap q_map,
                  const __grid_constant__ CUtensorMap k_map,
                  const __grid_constant__ CUtensorMap v_map, __nv_bfloat16* __restrict__ o,
                  int bh, int s, float scale) {
  using L = Layout<HD, NC>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::bar_off);
  uint64_t* k_full = q_full + 1;            // [kStages]
  uint64_t* v_full = k_full + kStages;      // [kStages]
  uint64_t* empty = v_full + kStages;       // [kStages]

  const int n_tiles = (s + L::BM - 1) / L::BM;
  const int head = blockIdx.x % bh, tile = n_tiles - 1 - blockIdx.x / bh;
  const int q0 = tile * L::BM;
  const int n_kv = (min(q0 + L::BM, s) - 1) / kBlockK + 1;   // later tiles are in the future
  const int warp = threadIdx.x / 32;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(k_full + st, 1);
      mbar_init(v_full + st, 1);
      mbar_init(empty + st, NC);             // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp < 4) {
    // ---- producer warpgroup: one thread issues every load ----
    if constexpr (NC == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(kProducerRegs));
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, L::q_bytes);
      for (int w = 0; w < NC; ++w)
        for (int p = 0; p < L::panels; ++p)
          tma_load(smem + p * L::q_panel + w * 64 * 128, &q_map, q_full, p * kPanel,
                   q0 + 64 * w, head);
      for (int kt = 0; kt < n_kv; ++kt) {
        const int st = kt % kStages;
        mbar_wait(empty + st, ((kt / kStages) & 1) ^ 1);   // the first round passes
        uint8_t* kd = smem + L::k_off + st * L::kv_bytes;
        uint8_t* vd = smem + L::v_off + st * L::kv_bytes;
        mbar_expect_tx(k_full + st, L::kv_bytes);
        for (int p = 0; p < L::panels; ++p)
          tma_load(kd + p * L::kv_panel, &k_map, k_full + st, p * kPanel, kt * kBlockK, head);
        mbar_expect_tx(v_full + st, L::kv_bytes);
        for (int p = 0; p < L::panels; ++p)
          tma_load(vd + p * L::kv_panel, &v_map, v_full + st, p * kPanel, kt * kBlockK, head);
      }
    }
  } else {
    // ---- consumer warpgroup wg: q rows q0 + 64wg .. +63 ----
    if constexpr (NC == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(kConsumerRegs));
    const int wg = warp / 4 - 1, t = threadIdx.x % 128, lane = t % 32;
    // accumulator fragment: this thread holds rows r and r + 8 of the
    // warpgroup's 64, columns 8j + c and 8j + c + 1 (registers 4j .. 4j+3:
    // (r, c), (r, c+1), (r+8, c), (r+8, c+1))
    const int row0 = q0 + 64 * wg;
    const int qpos0 = row0 + 16 * (t / 32) + lane / 4, qpos1 = qpos0 + 8;
    const int c = 2 * (lane % 4);
    const uint32_t q_base = smem_u32(smem + wg * 64 * 128);

    float acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
    // the running max is kept over unscaled scores and the scale folded
    // into the exponent: exp(scale * (x - m)) = 2^(x * sl - m * sl), one
    // FFMA and one ex2 per score
    const float sl = scale * 1.4426950408889634f;

    mbar_wait(q_full, 0);
    for (int kt = 0; kt < n_kv; ++kt) {
      const int st = kt % kStages;
      const uint32_t parity = (kt / kStages) & 1;
      const uint32_t k_base = smem_u32(smem + L::k_off + st * L::kv_bytes);
      const uint32_t v_base = smem_u32(smem + L::v_off + st * L::kv_bytes);

      // S = Q K^T: hd/16 steps of k16; a step's 32 bytes lie inside a
      // 128-byte swizzled row of panel kk/4
      float sc[kBlockK / 2];
#pragma unroll
      for (int i = 0; i < kBlockK / 2; ++i) sc[i] = 0.f;
      mbar_wait(k_full + st, parity);
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss_m64n128(sc, sw128_desc(q_base + (kk / 4) * L::q_panel + (kk % 4) * 32, 16),
                         sw128_desc(k_base + (kk / 4) * L::kv_panel + (kk % 4) * 32, 16),
                         kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);

      // mask (only where the tile reaches past the warpgroup's first
      // row), then the online softmax over the 4 lanes of each row
      const int k0 = kt * kBlockK;
      const bool diag = k0 + kBlockK - 1 > row0;
      if (diag) {
#pragma unroll
        for (int j = 0; j < kBlockK / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = k0 + 8 * j + c + e;
            if (key > qpos0) sc[4 * j + e] = kNegInf;
            if (key > qpos1) sc[4 * j + 2 + e] = kNegInf;
          }
        }
      }
      float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
      for (int j = 0; j < kBlockK / 8; ++j) {
        mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float b0 = -mn0 * sl, b1 = -mn1 * sl;
      float sum0 = 0.f, sum1 = 0.f;
      // P as wgmma's A operand: k step kk takes columns 16kk .. 16kk+15,
      // i.e. accumulator groups j = 2kk (registers 0, 1) and 2kk+1 (2, 3)
      uint32_t pa[kBlockK / 16][4];
#pragma unroll
      for (int j = 0; j < kBlockK / 8; ++j) {
        const float p0 = ex2(fmaf(sc[4 * j], sl, b0)), p1 = ex2(fmaf(sc[4 * j + 1], sl, b0));
        const float p2 = ex2(fmaf(sc[4 * j + 2], sl, b1)), p3 = ex2(fmaf(sc[4 * j + 3], sl, b1));
        sum0 += p0 + p1;
        sum1 += p2 + p3;
        pa[j / 2][2 * (j % 2)] = pack_bf16(p0, p1);        // row r
        pa[j / 2][2 * (j % 2) + 1] = pack_bf16(p2, p3);    // row r + 8
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        sum0 += __shfl_xor_sync(0xffffffffu, sum0, off);
        sum1 += __shfl_xor_sync(0xffffffffu, sum1, off);
      }
      const float alpha0 = ex2((m0 - mn0) * sl), alpha1 = ex2((m1 - mn1) * sl);
      l0 = l0 * alpha0 + sum0;
      l1 = l1 * alpha1 + sum1;
      m0 = mn0;
      m1 = mn1;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        acc[4 * j] *= alpha0;
        acc[4 * j + 1] *= alpha0;
        acc[4 * j + 2] *= alpha1;
        acc[4 * j + 3] *= alpha1;
      }

      // O += P V: k step kk takes V rows 16kk .. 16kk+15, two 8-row groups
      // of 1024 bytes; V is MN-major, its 64-column panels kv_panel apart
      mbar_wait(v_full + st, parity);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBlockK / 16; ++kk)
        wgmma_pv<HD>(acc, pa[kk], sw128_desc(v_base + kk * 16 * 128, L::kv_panel));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      if (t == 0) mbar_arrive(empty + st);   // the warpgroup's reads of this stage are done
    }

    const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
    __nv_bfloat16* out = o + (size_t)head * s * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      if (qpos0 < s)
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)qpos0 * HD + 8 * j + c) =
            __floats2bfloat162_rn(acc[4 * j] / d0, acc[4 * j + 1] / d0);
      if (qpos1 < s)
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)qpos1 * HD + 8 * j + c) =
            __floats2bfloat162_rn(acc[4 * j + 2] / d1, acc[4 * j + 3] / d1);
    }
  }
}

// a 3-D map over [bh, s, hd] bf16 whose box is (64 columns, rows, 1 head),
// 128-byte swizzled; reads past S fill zeros
bool make_map(EncodeTiled encode, CUtensorMap* map, const void* base, int bh, int s, int hd,
              int rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)hd, (cuuint64_t)s, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)hd * 2, (cuuint64_t)s * hd * 2};
  const cuuint32_t box[3] = {(cuuint32_t)kPanel, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD, int NC>
int launch(const void* q, const void* k, const void* v, void* o, int bh, int s, float scale,
           cudaStream_t stream) {
  using L = Layout<HD, NC>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSharedObjectSymbolNotFound;
  CUtensorMap qm, km, vm;
  if (!make_map(encode, &qm, q, bh, s, HD, 64) || !make_map(encode, &km, k, bh, s, HD, kBlockK) ||
      !make_map(encode, &vm, v, bh, s, HD, kBlockK))
    return (int)cudaErrorInvalidValue;
  auto kernel = flash_bf16_kernel<HD, NC>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         L::bytes);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)((s + L::BM - 1) / L::BM) * bh;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, L::threads, L::bytes, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), bh, s, scale);
  return (int)cudaGetLastError();
}

// two consumer warpgroups (128-row q tiles) unless that leaves SMs idle
template <int HD>
int launch_for_card(const void* q, const void* k, const void* v, void* o, int bh, int s,
                    float scale, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  if ((long long)((s + 127) / 128) * bh < sms)
    return launch<HD, 1>(q, k, v, o, bh, s, scale, stream);
  return launch<HD, 2>(q, k, v, o, bh, s, scale, stream);
}

}  // namespace bf16_path

}  // namespace

// q, k, v, o [bh, s, hd] contiguous and 16-byte aligned, fp32 (bf16 = 0) or
// bf16 (bf16 = 1). hd must be 64 or 128; the caller guarantees bh >= 1 and
// s >= 1. scale is 1/sqrt(hd).
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* o,
                               int bf16, int bh, int s, int hd, float scale,
                               cudaStream_t stream) {
  if (hd == 128)
    return bf16 ? bf16_path::launch_for_card<128>(q, k, v, o, bh, s, scale, stream)
                : fp32_path::launch_for_card<128>(q, k, v, o, bh, s, scale, stream);
  if (hd == 64)
    return bf16 ? bf16_path::launch_for_card<64>(q, k, v, o, bh, s, scale, stream)
                : fp32_path::launch_for_card<64>(q, k, v, o, bh, s, scale, stream);
  return (int)cudaErrorInvalidValue;
}
