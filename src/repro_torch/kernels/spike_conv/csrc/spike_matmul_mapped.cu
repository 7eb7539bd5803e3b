// Occupancy-mapped binary-spike matmul as an event-driven sparse core, CUDA
// C++ for sm_90a.
//
// Replaces the TPU kernel `spike_matmul_mapped` (src/repro/kernels/spike_conv/
// spike_conv.py, body `_spike_matmul_mapped_kernel`) together with its
// `occupancy_map` pre-pass (src/repro/kernels/spike_conv/ops.py).
//
// What it computes: patches [M, K] (0/1 spikes, fp32) @ w [K, N] -> [M, N]
// fp32, plus the occupancy stats at the plan's tile geometry:
//   row_occ int8  [M, K/bk]   1 iff the row has a spike inside the k tile
//   occ     int32 [M/bm, K/bk] OR of row_occ over each bm rows (all ones
//                              when gating is off)
//
// Design. The inputs are binary, so a row of the product is the sum of the
// weight rows its spikes select: the paper's sparse core pops one spike per
// cycle and adds one weight row. Here:
//   1. The pre-pass (one block per occupancy tile, each warp four rows at a
//      time) reads the patches once, writes row_occ and occ, and packs the
//      spikes into a bitmask [M, K/32] of 32-bit words (bit j of word w is
//      k = 32w + j).
//   2. The product never reads the fp32 patches again. A block owns R rows
//      x NT output columns, with R/4 warps of 4 rows each. It lists the
//      32-deep k words in which any of its rows spikes (with gating on, an
//      empty occupancy tile has no spike, so its words are skipped too),
//      then walks the list in k order through a 3-stage cp.async ring; a
//      stage holds two words' 64 x NT weights and the R rows' mask words,
//      and the next two stages' copies are in flight while it is added. A
//      warp turns each of its rows' words into the list of the row's set
//      bits, lowest first (lane l writes its k at the rank of its bit), then
//      takes its rows one at a time and walks each list four spikes at a
//      time, so that four weight loads are in flight (a pop-one-bit loop,
//      __ffs then clear, would wait on each load in turn). Every lane sees
//      the same row, so nothing diverges; lane l adds its NT/32 columns of
//      each selected weight row from shared memory with __fadd_rn (never
//      contracted). A list is padded to a multiple of four with a row of
//      zeros: adding +0 is exact, because a sum from +0 is never -0.
//   3. The output is written once, 16 bytes a lane (at NT = 64 two lanes
//      trade halves of two rows first).
// The wrapper picks R and NT per shape so that the grid has at least as many
// blocks as the card has SMs (132 on an H100).
//
// Sum order, and with it bit identity: every output element is summed in
// one register, k ascending, from +0. That is the order of the in-kernel-
// gated kernel (`spike_matmul.cu`), which also adds a weight with
// __fadd_rn only where the spike is set, so the two kernels agree bit for
// bit and the fused pipeline stays bit-identical to the unfused one.
//
// What bounds it on an H100 (measured numbers in PERF.md):
//   - the adds: one shared-memory read of 4 bytes per add at 128 bytes per
//     clock per SM is 32 adds/clk/SM, a quarter of the fp32 rate; 9.16 G
//     real MACs over the six served convs, times the spike density, is
//     ~0.11 ms at density 0.1 and ~1.15 ms at density 1.0;
//   - staging the weights from L2: each block copies the weight rows of its
//     non-empty words once, sum (M/R) K N 4 bytes, ~1.2 GB at the served
//     shapes and density 0.1;
//   - the pre-pass read of the fp32 patches, ~133 MB, ~0.04 ms at 3.35 TB/s.
// At density 0.1 none of the three sets the pace: each warp's time per
// stage goes mostly to issuing its share of the stage's copies, to turning
// its words into lists and to the dependent load-add chains of a few spikes
// a row, with about 16 warps an SM to hide them (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPrepassThreads = 256;
constexpr int kPrepassRows = 4;           // rows a warp of the pre-pass loads at once
constexpr int kRowsPerWarp = 4;           // product block: R/4 warps of 4 rows
constexpr int kWordK = 32;                // k depth of one mask word
constexpr int kWordsPerStage = 2;         // mask words (k depth / 32) per ring stage
constexpr int kStages = 3;                // cp.async ring depth

// grid (M/bm, K/bk): one block per occupancy tile. Warp w takes rows
// w, w+8, ... four at a time (their loads in flight together); lane l reads
// columns base + 4l.. of the k tile as a float4, and lanes 8g..8g+7 pack
// their nibbles into mask word g of those 128 columns.
__global__ void __launch_bounds__(kPrepassThreads)
occupancy_kernel(const float* __restrict__ x, int8_t* __restrict__ row_occ,
                 int32_t* __restrict__ occ, uint32_t* __restrict__ mask,
                 int k_pad, int bm, int bk, int nk, int gate) {
  constexpr int kWarpsPre = kPrepassThreads / 32;
  const int mt = blockIdx.x, kt = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nw = k_pad / kWordK;
  int tile_hit = 0;
  for (int r0 = warp; r0 < bm; r0 += kWarpsPre * kPrepassRows) {
    int hit[kPrepassRows] = {};
    for (int base = 0; base < bk; base += 128) {   // uniform: every lane shuffles
      const int c = base + lane * 4;
      float4 v[kPrepassRows];
#pragma unroll
      for (int i = 0; i < kPrepassRows; ++i) {
        const int r = r0 + i * kWarpsPre;
        v[i] = c < bk && r < bm
                   ? *reinterpret_cast<const float4*>(
                         x + ((size_t)mt * bm + r) * k_pad + (size_t)kt * bk + c)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int i = 0; i < kPrepassRows; ++i) {
        const int r = r0 + i * kWarpsPre;
        uint32_t word = ((v[i].x != 0.f) | (v[i].y != 0.f) << 1 | (v[i].z != 0.f) << 2 |
                         (v[i].w != 0.f) << 3) << (4 * (lane % 8));
        word |= __shfl_xor_sync(0xffffffffu, word, 1);
        word |= __shfl_xor_sync(0xffffffffu, word, 2);
        word |= __shfl_xor_sync(0xffffffffu, word, 4);
        if (c < bk && r < bm && lane % 8 == 0)   // bk % 32 == 0: whole groups of 8
          mask[((size_t)mt * bm + r) * nw + ((size_t)kt * bk + c) / kWordK] = word;
        hit[i] |= word != 0;
      }
    }
#pragma unroll
    for (int i = 0; i < kPrepassRows; ++i) {
      const int r = r0 + i * kWarpsPre;
      const int any = __any_sync(0xffffffffu, hit[i]);
      if (r < bm && lane == 0) row_occ[((size_t)mt * bm + r) * nk + kt] = (int8_t)any;
      tile_hit |= r < bm && any;
    }
  }
  tile_hit = __syncthreads_or(tile_hit);
  if (threadIdx.x == 0) occ[(size_t)mt * nk + kt] = gate ? (tile_hit != 0) : 1;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// the wrapper's `event_smem_bytes` computes the same
size_t event_smem_bytes(int rows, int nt, int nw) {
  return ((size_t)kStages * kWordsPerStage * (kWordK * nt + rows) + nt +
          (size_t)rows * kWordsPerStage * 32 + 2 * (size_t)nw) * 4;
}

// grid (N/NT, M/R). Shared memory: the weight ring [kStages][KW*32][NT], a
// row of NT zeros, the mask ring [kStages][KW][R], each row's spike list
// [R][KW*32], the per-word hit flags [nw] and the list [nw] of words to
// visit. Warp w owns rows w, w + WARPS, ..., lane l columns l*CPL.. of the
// block's NT.
template <int NT, int WARPS>
__global__ void __launch_bounds__(WARPS * 32)
event_matmul_kernel(const uint32_t* __restrict__ mask, const float* __restrict__ w,
                    float* __restrict__ out, int k_pad, int n_pad) {
  constexpr int ROWS = kRowsPerWarp, R = ROWS * WARPS, THREADS = WARPS * 32;
  constexpr int CPL = NT / 32;            // columns per lane: 2 or 4
  static_assert(CPL == 2 || CPL == 4, "NT is 64 or 128");
  constexpr int KW = kWordsPerStage, SLOT_W = KW * kWordK * NT, SLOT_M = KW * R;
  extern __shared__ __align__(16) float smem[];
  __shared__ int n_list;
  const int nw = k_pad / kWordK;
  float* ws = smem;                                                 // weight ring
  float* zeros = ws + kStages * SLOT_W;                             // NT zeros
  uint32_t* ms = reinterpret_cast<uint32_t*>(zeros + NT);                // mask ring
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  int* pos = reinterpret_cast<int*>(ms + kStages * SLOT_M) + warp * ROWS * KW * 32;
  int* flag = reinterpret_cast<int*>(ms + kStages * SLOT_M) + R * KW * 32;
  int* list = flag + nw;

  const int m0 = blockIdx.y * R, n0 = blockIdx.x * NT;
  const uint32_t* mrows = mask + (size_t)m0 * nw;

  // which words does any of the block's rows spike in? (lane = word, warps
  // split rows) With gating on, an empty occupancy tile has no spike in
  // any of its words, so this also skips every tile whose occ is 0.
  for (int c = tid; c < nw; c += THREADS) flag[c] = 0;
  for (int c = tid; c < NT; c += THREADS) zeros[c] = 0.f;
  __syncthreads();
  for (int base = 0; base < nw; base += 32) {
    const int c = base + lane;
    if (c < nw) {
      uint32_t any = 0;
      for (int r = warp; r < R; r += WARPS) any |= mrows[(size_t)r * nw + c];
      if (any) atomicOr(&flag[c], 1);
    }
  }
  __syncthreads();
  if (warp == 0) {                        // compact in k order
    int count = 0;
    for (int base = 0; base < nw; base += 32) {
      const int c = base + lane;
      const bool hit = c < nw && flag[c];
      const unsigned ballot = __ballot_sync(0xffffffffu, hit);
      if (hit) list[count + __popc(ballot & ((1u << lane) - 1))] = c;
      count += __popc(ballot);
    }
    if (lane == 0) n_list = count;
  }
  __syncthreads();
  const int n = n_list, n_stages = (n + KW - 1) / KW;

  // stage s: the weight rows and mask words of list entries s*KW ..
  // s*KW+KW-1 into slot s % kStages
  auto issue = [&](int s) {
    const int slot = s % kStages;
#pragma unroll
    for (int q = tid; q < SLOT_W / 4; q += THREADS) {
      const int u = q / (kWordK * NT / 4), rem = q % (kWordK * NT / 4);
      const int r = rem / (NT / 4), col = (rem % (NT / 4)) * 4;
      if (s * KW + u < n)
        cp_async16(ws + slot * SLOT_W + (u * kWordK + r) * NT + col,
                   w + ((size_t)list[s * KW + u] * kWordK + r) * n_pad + n0 + col);
    }
    for (int q = tid; q < SLOT_M; q += THREADS) {
      const int u = q / R, r = q % R;
      if (s * KW + u < n)
        cp_async4(ms + slot * SLOT_M + q, mrows + (size_t)r * nw + list[s * KW + u]);
    }
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_stages) issue(s);
    cp_async_commit();                    // empty groups keep the count uniform
  }

  float acc[ROWS][CPL];
#pragma unroll
  for (int i = 0; i < ROWS; ++i)
#pragma unroll
    for (int j = 0; j < CPL; ++j) acc[i][j] = 0.f;

  for (int s = 0; s < n_stages; ++s) {
    cp_async_wait<kStages - 2>();         // stage s has landed (for this thread)
    __syncthreads();                      // ... for every thread; slot s-1 is free
    if (s + kStages - 1 < n_stages) issue(s + kStages - 1);
    cp_async_commit();
    const int slot = s % kStages;
    const float* wt = ws + slot * SLOT_W + lane * CPL;
    const uint32_t* mt = ms + slot * SLOT_M;
    // each row's spikes in this stage, k ascending, as weight-row offsets:
    // lane l of word u writes its offset at the rank of its bit, and the
    // row's list is padded to KW*32 entries with the offset of a row of
    // zeros (adding +0 is exact: a sum from +0 is never -0)
    const int zero_off = (kStages - slot) * SLOT_W;
    int n_evs[ROWS];
#pragma unroll
    for (int rr = 0; rr < ROWS; ++rr) {
      uint32_t word[KW];
      int n_ev = 0;
#pragma unroll
      for (int u = 0; u < KW; ++u) {
        word[u] = s * KW + u < n ? mt[u * R + rr * WARPS + warp] : 0u;
        n_ev += __popc(word[u]);
      }
      int* prow = pos + rr * KW * 32;
      int base = 0;
#pragma unroll
      for (int u = 0; u < KW; ++u) {
        if ((word[u] >> lane) & 1u)
          prow[base + __popc(word[u] & ((1u << lane) - 1u))] = (u * kWordK + lane) * NT;
        if (u * 32 + lane >= n_ev) prow[u * 32 + lane] = zero_off;
        base += __popc(word[u]);
      }
      n_evs[rr] = n_ev;
    }
    __syncwarp();
    // each row's spikes four at a time, their loads in flight together
#pragma unroll
    for (int rr = 0; rr < ROWS; ++rr) {
      const int n_ev = n_evs[rr];
      for (int e = 0; e < n_ev; e += 4) {
        const int4 off = *reinterpret_cast<const int4*>(pos + rr * KW * 32 + e);
        const int offs[4] = {off.x, off.y, off.z, off.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if constexpr (CPL == 4) {
            const float4 v = *reinterpret_cast<const float4*>(wt + offs[q]);
            acc[rr][0] = __fadd_rn(acc[rr][0], v.x);
            acc[rr][1] = __fadd_rn(acc[rr][1], v.y);
            acc[rr][2] = __fadd_rn(acc[rr][2], v.z);
            acc[rr][3] = __fadd_rn(acc[rr][3], v.w);
          } else {
            const float2 v = *reinterpret_cast<const float2*>(wt + offs[q]);
            acc[rr][0] = __fadd_rn(acc[rr][0], v.x);
            acc[rr][1] = __fadd_rn(acc[rr][1], v.y);
          }
        }
      }
    }
  }

  // 16-byte stores: the G = 4/CPL lanes that hold four neighbouring
  // columns trade values in G rounds so that lane j of the group ends with
  // row rr0 + j's four (in round i it reads the lane (j + i) % G of the
  // group, which sends its value of the row that reader needs)
  constexpr int G = 4 / CPL;
  static_assert(ROWS % G == 0, "rows per warp come in groups of G");
  const int j = lane % G;
#pragma unroll
  for (int rr0 = 0; rr0 < ROWS; rr0 += G) {
    float v[4];
#pragma unroll
    for (int i = 0; i < G; ++i) {
      const int t = (j - i + G) % G, src = (j + i) % G;
#pragma unroll
      for (int e = 0; e < CPL; ++e) {
        float send = acc[rr0][e];
#pragma unroll
        for (int q = 1; q < G; ++q)
          if (t == q) send = acc[rr0 + q][e];
        const float got = __shfl_sync(0xffffffffu, send, lane - j + src);
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (src * CPL + e == c) v[c] = got;
      }
    }
    *reinterpret_cast<float4*>(out + (size_t)(m0 + (rr0 + j) * WARPS + warp) * n_pad + n0 +
                               (lane / G) * 4) = make_float4(v[0], v[1], v[2], v[3]);
  }
}

template <int NT, int WARPS>
int launch_event(const uint32_t* mask, const float* w, float* out, int m_pad, int k_pad,
                 int n_pad, cudaStream_t stream) {
  constexpr int R = kRowsPerWarp * WARPS;
  static size_t opted_in = 48 * 1024;     // dynamic shared memory allowed so far
  const size_t smem = event_smem_bytes(R, NT, k_pad / kWordK);
  if (smem > opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        event_matmul_kernel<NT, WARPS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    opted_in = smem;
  }
  event_matmul_kernel<NT, WARPS><<<dim3(n_pad / NT, m_pad / R), WARPS * 32, smem, stream>>>(
      mask, w, out, k_pad, n_pad);
  return (int)cudaGetLastError();
}

template <int NT>
int launch_rows(int rows, const uint32_t* mask, const float* w, float* out, int m_pad,
                int k_pad, int n_pad, cudaStream_t stream) {
  switch (rows) {
    case 16: return launch_event<NT, 16 / kRowsPerWarp>(mask, w, out, m_pad, k_pad, n_pad, stream);
    case 32: return launch_event<NT, 32 / kRowsPerWarp>(mask, w, out, m_pad, k_pad, n_pad, stream);
    case 64: return launch_event<NT, 64 / kRowsPerWarp>(mask, w, out, m_pad, k_pad, n_pad, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x [m_pad, k_pad], w [k_pad, n_pad], out [m_pad, n_pad] fp32; row_occ int8
// [m_pad, k_pad/bk]; occ int32 [m_pad/bm, k_pad/bk]; mask int32 scratch
// [m_pad, k_pad/32]. The caller guarantees m_pad % bm == 0, k_pad % bk == 0,
// bk % 32 == 0, rows in {16, 32, 64}, nt in {64, 128}, m_pad % rows == 0,
// n_pad % nt == 0, and that the product's shared memory fits (at most
// 225 KB, as the wrapper checks). Returns cudaErrorInvalidValue for a
// geometry it has no kernel for.
extern "C" int spike_matmul_mapped(const float* x, const float* w, float* out,
                                   int8_t* row_occ, int32_t* occ, int32_t* mask,
                                   int m_pad, int k_pad, int n_pad, int bm, int bk,
                                   int gate, int rows, int nt, cudaStream_t stream) {
  const int nk = k_pad / bk;
  uint32_t* bits = reinterpret_cast<uint32_t*>(mask);
  occupancy_kernel<<<dim3(m_pad / bm, nk), kPrepassThreads, 0, stream>>>(
      x, row_occ, occ, bits, k_pad, bm, bk, nk, gate);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (nt == 64) return launch_rows<64>(rows, bits, w, out, m_pad, k_pad, n_pad, stream);
  if (nt == 128) return launch_rows<128>(rows, bits, w, out, m_pad, k_pad, n_pad, stream);
  return (int)cudaErrorInvalidValue;
}
