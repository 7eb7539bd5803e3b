// In-kernel-gated binary-spike matmul (the pre-fusion sparse core) as a
// register-blocked spike-bit core, CUDA C++ for sm_90a.
//
// Replaces the TPU kernel `spike_matmul` (src/repro/kernels/spike_conv/
// spike_conv.py, body `_spike_matmul_kernel`), which the unfused pipeline
// (src/repro/models/vgg9.py, `vgg9_infer_hybrid_unfused`) launches once per
// timestep and spiking layer through `spike_conv2d`.
//
// What it computes: patches [M, K] (0/1 spikes, fp32) @ w [K, N] -> [M, N]
// fp32. The occupancy gate is decided inside the kernel, on the spikes it
// has just read: with `gate`, a warp visits only the k at which one of its
// rows spikes, so a 32-deep k word where none does costs it nothing. With
// `gate` off it visits every k. A nonzero patch counts as a spike.
//
// Design. One launch, no pre-pass:
//   1. A block owns BR rows x BC output columns; its consumer warps split
//      them into R rows x 32C columns each (lane l owns C neighbouring
//      columns of the warp's R rows). A producer warp walks K in stages of
//      64 through a 3-stage ring in shared memory: per stage one TMA tile
//      of the block's fp32 patches [BR x 64] and one of the weights
//      [64 x BC], counted on a `full` mbarrier; the consumer warps release
//      the slot on an `empty` one. No block-wide barrier, and the consumer
//      warps issue no copies.
//   2. For each 32-deep word, lane j of a warp reads its R rows' patches at
//      k = 32u + j (conflict-free) and packs them into R spike bits;
//      `__ballot_sync` says which k the warp visits, and each visited lane
//      writes the byte offset of its weight row, and its row bits, into the
//      warp's list at its rank. So the list is built by all lanes at once,
//      k ascending, with nothing serial in front of the loads.
//   3. The warp walks its list four entries at a time: two broadcast loads
//      of entries (the next group's read ahead), then four weight loads in
//      flight together. The walk is warp-uniform, so nothing diverges. Each
//      lane adds its C weights, with __fadd_rn (never contracted), into the
//      rows whose bit the entry carries: C floats of shared memory per R*C
//      adds. With R = 1 every entry adds, so no add is wasted on a silent
//      row, which at low density most of a wider warp's rows are.
//      Lists are padded to a multiple of four with a row of zeros (adding
//      +0 is exact).
//   4. A word where more than 24 k are visited (dense spikes, or `gate`
//      off) skips the list: all 32 k in order, each row's add predicated on
//      its bit, which saves the list's bookkeeping.
//   5. The output is written once from registers (C floats a lane a row).
// The wrapper picks (BR, BC, R, C) per shape from `GATED_GEOMETRIES` in
// ops.py so that the grid has at least as many blocks as the card has SMs
// (132 on an H100): M = 512 at 8 images allows no split-K, so there the
// blocks hold 8 rows.
//
// Sum order, and with it bit identity: every output element is summed in
// one register, k ascending, from +0, adding the weight where the spike is
// set and nothing (or +0) where it is not. A sum from +0 is never -0, so
// leaving a k out is the same as adding +0 or -0. That is the order of
// `spike_matmul_mapped.cu` and of `spike_matmul_event_plain`, so the three
// agree bit for bit and the unfused pipeline stays bit-identical to the
// fused one. No split-K, no tensor cores, no reordering.
//
// What bounds it on an H100 (measured numbers in PERF.md): one add per set
// bit and output column at the fp32 rate, against one read of the patches
// and weights from device memory. In practice: the instructions and shared-
// memory loads per visit (~1 load of C floats per C adds at R = 1) with
// 8-16 consumer warps an SM, and the staging of
// 4 M K N (1/BR + 1/BC) bytes from L2, which the geometry trades against
// the block count. Multicasting the weight tile to a cluster of blocks
// along M cut those bytes but its cluster-scope barriers cost more than
// they saved (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

#include "../../common/csrc/tma.cuh"   // mbarriers, smem_u32, encode_tiled

namespace {

constexpr int kWordK = 32;        // k depth of one spike word
constexpr int kStageWords = 2;    // words per ring stage
constexpr int kStageK = kStageWords * kWordK;
constexpr int kStages = 3;        // ring depth
constexpr int kListLen = kStageK + 8;   // a warp's visit list: padding and one group read ahead
constexpr int kDenseFrom = 24;    // a word with more visited k skips the list

// the box of `map` at (c0 = column, c1 = row) into dst, counted on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)),
         "r"(c0), "r"(c1)
      : "memory");
}

template <int C>
__device__ __forceinline__ void load_cols(const float* p, float (&v)[C]) {
  static_assert(C == 2 || C == 4, "2 or 4 columns a lane");
  if constexpr (C == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x; v[1] = t.y;
  }
}

template <int C>
__device__ __forceinline__ void store_cols(float* p, const float (&v)[C]) {
  if constexpr (C == 4)
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
}

// acc[r] += v for every row r whose bit r `rows` carries
template <int R, int C>
__device__ __forceinline__ void add_rows(float (&acc)[R][C], const float (&v)[C], uint32_t rows) {
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (R == 1 || (rows & (1u << r))) {
#pragma unroll
      for (int c = 0; c < C; ++c) acc[r][c] = __fadd_rn(acc[r][c], v[c]);
    }
}

constexpr size_t smem_bytes(int br, int bc, int warps) {
  return ((size_t)kStages * kStageK * (bc + br) + (size_t)warps * 2 * kListLen + bc) *
         sizeof(float);
}

// grid (M/BR) * (N/BC) blocks, row blocks fastest (one axis, so M and N
// are limited only by the int offsets); WR*WC consumer warps and one
// producer warp. Shared
// memory: the weight ring [kStages][64][BC], the patch ring
// [kStages][BR][64], each consumer warp's visit list (byte offsets of the
// weight rows, then their row bits), then a row of BC zeros that padding
// entries point at (adding +0 is exact: a sum from +0 is never -0).
// Consumer warp w owns rows
// (w / WC)*R .. of the block and columns (w % WC)*32C + lane*C .. .
template <int R, int C, int WR, int WC>
__global__ void __launch_bounds__((WR * WC + 1) * 32, 2)
spike_bits_kernel(const __grid_constant__ CUtensorMap x_map,
                  const __grid_constant__ CUtensorMap w_map, float* __restrict__ out,
                  int k_pad, int n_pad, int gate) {
  constexpr int WARPS = WR * WC, BR = WR * R, BC = WC * 32 * C;
  constexpr int SLOT_W = kStageK * BC, SLOT_P = BR * kStageK;
  extern __shared__ __align__(128) float smem[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  float* ws = smem;
  float* ps = smem + kStages * SLOT_W;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row_blocks = gridDim.x / (n_pad / BC);
  const int m0 = (blockIdx.x % row_blocks) * BR, n0 = (blockIdx.x / row_blocks) * BC;
  const int nw = k_pad / kWordK, n_stages = (nw + kStageWords - 1) / kStageWords;

  float* zeros = ps + kStages * SLOT_P + WARPS * 2 * kListLen;
  for (int c = threadIdx.x; c < BC; c += (WARPS + 1) * 32) zeros[c] = 0.f;
  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full + st, 1);
      mbar_init(empty + st, WARPS);       // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == WARPS) {
    // producer: stage s (k s*64 ..) into slot s % kStages once every
    // consumer warp is done with the stage the slot held: the patches
    // [BR x 64] and weights [64 x BC] as one tile each (a tile past K is
    // zero-filled and counted whole)
    if (lane == 0) {
      for (int s = 0; s < n_stages; ++s) {
        const int slot = s % kStages, k0 = s * kStageK;
        mbar_wait(empty + slot, ((s / kStages) & 1) ^ 1);   // the first round passes
        mbar_expect_tx(full + slot, (uint32_t)((SLOT_W + SLOT_P) * 4));
        tma_load(ps + slot * SLOT_P, &x_map, full + slot, k0, m0);
        tma_load(ws + slot * SLOT_W, &w_map, full + slot, n0, k0);
      }
    }
    return;
  }

  int* offs = reinterpret_cast<int*>(ps + kStages * SLOT_P) + warp * 2 * kListLen;
  int* bits = offs + kListLen;
  float acc[R][C];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < C; ++c) acc[r][c] = 0.f;

  const int col0 = (warp % WC) * 32 * C + lane * C;
  const int row0 = (warp / WC) * R;
  for (int s = 0; s < n_stages; ++s) {
    const int slot = s % kStages;
    mbar_wait(full + slot, (s / kStages) & 1);
    const char* wt = reinterpret_cast<const char*>(ws + slot * SLOT_W + col0);
    const int zero_off = (int)(zeros - (ws + slot * SLOT_W)) * 4;   // from wt to the zeros
    const float* pt = ps + slot * SLOT_P + row0 * kStageK + lane;
    // the n listed entries, four at a time: one broadcast load of offsets
    // (and of row bits), then four weight loads in flight together, while
    // the next group's entries are read
    int n = 0;
    auto walk = [&]() {
      if (lane < 8) {                     // padding: the zero row, no row bits
        offs[n + lane] = zero_off;
        bits[n + lane] = 0;
      }
      __syncwarp();
      int4 o = *reinterpret_cast<const int4*>(offs);
      int4 b = make_int4(1, 1, 1, 1);     // one row a warp: every entry adds
      if constexpr (R > 1) b = *reinterpret_cast<const int4*>(bits);
      for (int e = 0; e < n; e += 4) {
        const int off[4] = {o.x, o.y, o.z, o.w};
        const uint32_t rows[4] = {(uint32_t)b.x, (uint32_t)b.y, (uint32_t)b.z, (uint32_t)b.w};
        o = *reinterpret_cast<const int4*>(offs + e + 4);
        if constexpr (R > 1) b = *reinterpret_cast<const int4*>(bits + e + 4);
        float v[4][C];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          load_cols<C>(reinterpret_cast<const float*>(wt + off[i]), v[i]);
#pragma unroll
        for (int i = 0; i < 4; ++i) add_rows<R, C>(acc, v[i], rows[i]);
      }
      __syncwarp();                       // before the lists are written again
      n = 0;
    };
#pragma unroll
    for (int u = 0; u < kStageWords; ++u) {
      if (s * kStageWords + u >= nw) break;          // warp-uniform
      // lane j: its R rows' spikes at k = 32u + j (a conflict-free read)
      uint32_t rows = 0;
#pragma unroll
      for (int r = 0; r < R; ++r) rows |= (uint32_t)(pt[r * kStageK + u * kWordK] != 0.f) << r;
      const uint32_t hit = __ballot_sync(0xffffffffu, rows != 0 || !gate);
      if (__popc(hit) > kDenseFrom) {
        // a dense word: every k in order; bit j of rw[r] is row r at 32u + j
        if (n) walk();
        uint32_t rw[R];
#pragma unroll
        for (int r = 0; r < R; ++r) rw[r] = __ballot_sync(0xffffffffu, (rows >> r) & 1u);
        const float* wk = reinterpret_cast<const float*>(wt) + u * kWordK * BC;
#pragma unroll
        for (int j = 0; j < kWordK; ++j) {
          float v[C];
          load_cols<C>(wk + j * BC, v);
#pragma unroll
          for (int r = 0; r < R; ++r)
            if (rw[r] & (1u << j)) {
#pragma unroll
              for (int c = 0; c < C; ++c) acc[r][c] = __fadd_rn(acc[r][c], v[c]);
            }
        }
      } else {
        // a sparse word: each visited lane lists its weight row's byte
        // offset and its row bits at its rank
        if ((hit >> lane) & 1u) {
          const int at = n + __popc(hit & ((1u << lane) - 1u));
          offs[at] = (u * kWordK + lane) * BC * 4;
          if constexpr (R > 1) bits[at] = (int)rows;
        }
        n += __popc(hit);
      }
    }
    if (n) walk();
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + slot);        // this warp is done with the slot
  }

#pragma unroll
  for (int r = 0; r < R; ++r)
    store_cols<C>(out + (size_t)(m0 + row0 + r) * n_pad + n0 + col0, acc[r]);
}

// a 2-D map over a row-major fp32 [rows, cols] matrix whose box is
// (box_cols, box_rows), unswizzled; reads past the edge fill zeros
bool make_map(EncodeTiled encode, CUtensorMap* map, const float* base, int rows, int cols,
              int box_rows, int box_cols) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 4};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(base), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int R, int C, int WR, int WC>
int launch(const float* x, const float* w, float* out, int m_pad, int k_pad, int n_pad,
           int gate, cudaStream_t stream) {
  constexpr int BR = WR * R, BC = WC * 32 * C;
  constexpr size_t smem = smem_bytes(BR, BC, WR * WC);
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSharedObjectSymbolNotFound;
  CUtensorMap xm, wm;
  if (!make_map(encode, &xm, x, m_pad, k_pad, BR, kStageK) ||
      !make_map(encode, &wm, w, k_pad, n_pad, kStageK, BC))
    return (int)cudaErrorInvalidValue;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(spike_bits_kernel<R, C, WR, WC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(spike_bits_kernel<R, C, WR, WC>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  spike_bits_kernel<R, C, WR, WC><<<(m_pad / BR) * (n_pad / BC), (WR * WC + 1) * 32, smem,
                                    stream>>>(xm, wm, out, k_pad, n_pad, gate);
  return (int)cudaGetLastError();
}

}  // namespace

// x [m_pad, k_pad], w [k_pad, n_pad], out [m_pad, n_pad] fp32, each 16-byte
// aligned. (rows, cols, rows_per_warp, cols_per_lane) is one of the
// wrapper's GATED_GEOMETRIES; the caller guarantees k_pad % 32 == 0,
// m_pad % rows == 0 and n_pad % cols == 0. Returns cudaErrorInvalidValue
// for a geometry it has no kernel for.
extern "C" int spike_matmul(const float* x, const float* w, float* out, int m_pad,
                            int k_pad, int n_pad, int gate, int rows, int cols,
                            int rows_per_warp, int cols_per_lane, cudaStream_t stream) {
#define GEOMETRY(BR, BC, R, C)                                                        \
  if (rows == BR && cols == BC && rows_per_warp == R && cols_per_lane == C)           \
    return launch<R, C, BR / R, BC / (32 * C)>(x, w, out, m_pad, k_pad, n_pad, gate, stream);
  GEOMETRY(32, 128, 2, 4)
  GEOMETRY(16, 128, 4, 4)
  GEOMETRY(8, 128, 1, 4)
  GEOMETRY(16, 64, 2, 2)
#undef GEOMETRY
  return (int)cudaErrorInvalidValue;
}
