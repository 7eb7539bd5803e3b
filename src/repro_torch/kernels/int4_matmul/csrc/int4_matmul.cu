// W4A16 matmul: activations times packed int4 weights, CUDA C++ for sm_90a.
//
// Replaces the TPU kernel `int4_matmul` (src/repro/kernels/int4_matmul/
// int4_matmul.py, body `_int4_matmul_kernel`), which `w4a16_linear` calls
// and examples/serve_lm_w4.py reaches.
//
// What it computes: x [M, K] (fp32 or bf16) @ w [K, N] -> [M, N] fp32,
// where w[k, 2j] is the sign-extended low nibble of packed[k, j] (int8) and
// w[k, 2j+1] the high one, then times scale[n] once, after the whole sum
// (the TPU kernel scales at its last k step).
//
// What bounds it on an H100: at decode widths (M = 4 slots) the packed
// weights, K*N/2 bytes read once at 3.35 TB/s; at prefill widths (M = 512)
// the products on the tensor cores (989 TFLOP/s bf16; fp32 x takes three
// passes, below).
//
// Design of the tensor-core path (`int4_wgmma_kernel`):
// - A and B swapped: out^T [N, M] = W^T x^T. The weights are wgmma's A
//   operand, taken from registers, 64 output channels per wgmma tile and
//   k16 per instruction. x is the B operand in shared memory: its [M, K]
//   rows are already K-major, so tokens are wgmma's N (n8 at decode
//   widths, n64 or n128 at prefill) and M = 4 fills no 64-row tile with
//   padding. A block owns TN tokens and 64 C T channels: C consumer
//   warpgroups of T wgmma tiles each (the wrapper's INT4_GEOMETRIES).
// - Weights stay packed until registers. One producer thread TMA-loads, per
//   64-deep k unit, the packed tile [64 k x 32 C T bytes] (32-, 64- or
//   128-byte swizzle: a row is one swizzle span, so the consumers' byte
//   reads are free of bank conflicts) and the x tile [planes x TN x 64 k]
//   (128-byte swizzle, read by the wgmma descriptors) into a ring of stages
//   on CTA-scope mbarriers. The A-row order puts the two nibbles of one
//   byte (channels 2j and 2j+1 at one k) in a thread's fragment rows g and
//   g+8, so four byte loads per k16 give a tile's fragment (each byte a
//   thread needs lies in another k row, so a wider load would carry bytes
//   it does not use), and the epilogue writes each row back to its
//   channel. Two values convert per instruction pair: `lop3` forms the bf16
//   pattern 0x4300 | (nibble ^ 8), which is 128 + v + 8, and a bf16x2 FMA
//   subtracts 136: exact.
// - A unit's packed bytes are loaded while the previous unit's wgmmas run
//   and converted once they are done (wgmma_wait 0): writing A registers
//   while wgmmas are pending makes ptxas serialize every wgmma (C7513).
//   Each warp releases a stage after its own wait: a warp's wait covers its
//   share of a wgmma, not the other warps', so one release per warpgroup
//   let the producer overwrite a stage that a lagging warp still read.
// - fp32 x runs as three exact bf16 terms, hi + mid + lo == x, written by a
//   pre-pass in the same entry point into scratch the wrapper allocates:
//   three wgmmas on the same A registers, in that order, form every product
//   the fp32 dot forms (an int4 value times an 8-bit significand is exact
//   in fp32); only the order of the fp32 sum differs. bf16 x takes one
//   pass, straight from x.
// - Deterministic split-K: K goes in 64-deep units, cut into S ranges that
//   the wrapper picks from (K, N) alone, so decode widths put >= 132 blocks
//   on the card. A range's first wgmma writes its accumulator (scale-d 0),
//   the others add, k ascending; the ranges are then added in order, ((p0
//   + p1) + p2) ..., either by a second pass over partial sums in scratch
//   (split mode, `sum_splits_kernel`) or by a block that walks every range
//   (whole mode), keeping the running sum in registers where they are to
//   spare and in the output otherwise: the same fp32 additions, so a row's
//   result depends neither on M nor on the geometry or the mode. No
//   atomics: two calls give the same bits. The scale multiplies once, after
//   the whole sum.
// - With two consumer warpgroups (one block an SM) `setmaxnreg`
//   hands the producer warpgroup's registers to them; one warpgroup runs
//   two blocks an SM instead.
// - Tried on the card and not kept: converting the next unit's fragments
//   while the previous unit's wgmmas run (ptxas then serializes them),
//   splitting fp32 x inside the kernel at decode widths (every block then
//   re-splits the same x tile), four consumer warpgroups a block, and two
//   blocks of a cluster sharing each x tile by TMA multicast (slower at
//   every prefill shape, though it halves the L2 reads of x).
//
// Shapes TMA cannot take (16-byte row strides: N % 32 for `packed`, K % 8
// for bf16 x; the fp32 pre-pass pads its rows) run the SIMT kernel at the
// end of this file: a block owns 4 output rows and 256 columns, each lane 8
// columns (one 32-bit load of packed nibbles per k), the block's 8 warps
// split K into contiguous ranges summed k ascending and added in warp
// order; fp32 FMAs on the CUDA cores, ragged M, K and N masked.
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

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// ---------------------------------------------------------------------------
// tensor-core path
// ---------------------------------------------------------------------------

constexpr int kUnitK = 64;              // k per stage and per split unit: one 128-byte bf16 row
// with two consumer warpgroups: 128*40 + 256*232 <= 65536
constexpr int kProducerRegs = 40, kConsumerRegs = 232;

// Shared memory of one stage: the x tile [P planes][TN tokens][64 k] bf16
// (128-byte rows, swizzled), then the packed tile [64 k][32 C T bytes]; both
// are multiples of 1024 bytes, so every tile keeps its swizzle's alignment.
// A block owns TN tokens and 64 C T channels: C consumer warpgroups of T
// 64-channel wgmma tiles each.
template <int TN, int C, int T, int STAGES, int P> struct Layout {
  static constexpr int threads = 128 * (C + 1);
  static constexpr int w_row = 32 * C * T;               // packed bytes per k row
  static constexpr int x_plane = TN * 128;
  static constexpr int x_bytes = P * x_plane;
  static constexpr int w_bytes = kUnitK * w_row;
  static constexpr int stage_bytes = x_bytes + w_bytes;
  static constexpr int bar_off = STAGES * stage_bytes;
  static constexpr int bytes = bar_off + 2 * STAGES * 8 + 1024;   // + slack to align the base
  static constexpr int min_blocks = C == 1 ? 2 : 1;
};

// first unit of range s when `units` units are cut into `splits` ranges
__device__ __forceinline__ int split_unit(int s, int units, int splits) {
  return (int)((long long)s * units / splits);
}

// box at (c0, c1) of a 2-D map, or (c0, c1, c2) of a 3-D one, into dst
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)),
         "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
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
// returns once every wgmma group this warp committed has completed (a
// warp's wait covers its own share of each wgmma, not the other warps')
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// pins registers at this point of the program: no read of them moves above
// a wgmma wait, no write below a wgmma issue, and the compiler reuses none
// of them while a wgmma may still read them
template <int N> __device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}
template <int T, int N> __device__ __forceinline__ void fence_regs(float (&d)[T][N]) {
#pragma unroll
  for (int i = 0; i < T; ++i) fence_regs(d[i]);
}
template <int T> __device__ __forceinline__ void fence_regs(uint32_t (&d)[T][4][4]) {
#pragma unroll
  for (int i = 0; i < T; ++i)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(d[i][kk][j]) :: "memory");
}

// wgmma shared-memory descriptor of a K-major operand with 128-byte
// swizzle: start address, leading byte offset (unused for K-major), stride
// byte offset 1024 (between 8-row groups), swizzle mode 1 (128 bytes)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(16 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// d = A(registers, 64 x 16) x B(shared, K-major, 16 x TN) + (accumulate ? d
// : 0): fp32 += bf16 x bf16
template <int TN>
__device__ __forceinline__ void wgmma_rs(float (&d)[TN / 2], const uint32_t (&a)[4], uint64_t b,
                                         int accumulate);
template <> __device__ __forceinline__ void wgmma_rs<8>(float (&d)[4], const uint32_t (&a)[4],
                                                        uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}
template <> __device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4],
                                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}
template <> __device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4],
                                                          uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// byte b of row r of a packed tile whose rows are RW bytes (32, 64 or 128),
// where TMA's RW-byte swizzle put it: a row's 16-byte chunks are permuted
// by address bits 7 and up (CUTLASS's Swizzle<1|2|3, 4, 3>)
template <int RW>
__device__ __forceinline__ uint32_t packed_byte(const uint8_t* tile, int r, int b) {
  const int row = r * RW;
  return tile[row + (b ^ (((row >> 7) & (RW / 16 - 1)) << 4))];
}

// v holds a byte in bits 0-7 and one in bits 16-23: their low nibbles as a
// bf16x2 (first byte in the low half). 0x4300 | (nibble ^ 8) is the bf16
// value 136 + the signed nibble, in [128, 143]; subtracting 136 is exact.
__device__ __forceinline__ uint32_t nibbles_to_bf16x2(uint32_t v) {
  const uint32_t bits = (v & 0x000F000Fu) ^ 0x43084308u;     // one lop3
  uint32_t out;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(out) : "r"(bits), "r"(0x3F803F80u),
      "r"(0xC308C308u));                                       // bits * 1 - 136
  return out;
}

// The packed bytes of a unit's A fragments for a thread: tile i's byte
// column is col0 + 32 i; k16 step kk's are k = r0, r0 + 1 (raw[i][kk][0],
// bytes in bits 0-7 and 16-23) and r0 + 8, r0 + 9 (raw[i][kk][1]), r0 =
// 16 kk + 2 (lane % 4)
template <int RW, int T>
__device__ __forceinline__ void load_fragments(const uint8_t* tile, int r_lane, int col0,
                                               uint32_t (&raw)[T][4][2]) {
#pragma unroll
  for (int i = 0; i < T; ++i)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int r0 = 16 * kk + r_lane, col = col0 + 32 * i;
      raw[i][kk][0] = packed_byte<RW>(tile, r0, col) | packed_byte<RW>(tile, r0 + 1, col) << 16;
      raw[i][kk][1] =
          packed_byte<RW>(tile, r0 + 8, col) | packed_byte<RW>(tile, r0 + 9, col) << 16;
    }
}
// ... of one tile and step as the fragment: rows g (low nibbles) and g + 8
// (high nibbles), k = r0, r0 + 1 (registers 0, 1) and r0 + 8, r0 + 9
// (registers 2, 3)
__device__ __forceinline__ void dequant(const uint32_t (&v)[2], uint32_t (&a)[4]) {
  a[0] = nibbles_to_bf16x2(v[0]);
  a[1] = nibbles_to_bf16x2(v[0] >> 4);
  a[2] = nibbles_to_bf16x2(v[1]);
  a[3] = nibbles_to_bf16x2(v[1] >> 4);
}

// Adds a range's sums into dst [m, n] (or writes them, for the first range),
// times the scale after the last range: the same fp32 operations, in the
// same order, as `sum_splits_kernel` applies to the partial sums. A thread
// reads back only what it wrote. Accumulator fragment of tile i: registers
// 4j .. 4j+3 hold (row g, token 8j + 2c), (g, 8j + 2c + 1), (g + 8, 8j +
// 2c), (g + 8, 8j + 2c + 1), c = lane % 4; rows g and g + 8 are channels ch
// and ch + 1, ch = ch0 + 64 i.
template <int TN, int T>
__device__ __forceinline__ void fold(const float (&acc)[T][TN / 2], float* dst,
                                     const float* __restrict__ scale, bool first, bool scaled,
                                     int m, int n, int tok0, int r_lane, int ch0) {
#pragma unroll
  for (int i = 0; i < T; ++i) {
    const int ch = ch0 + 64 * i;
    if (ch >= n) continue;
    const float s0 = scaled ? scale[ch] : 1.f, s1 = scaled ? scale[ch + 1] : 1.f;
#pragma unroll
    for (int j = 0; j < TN / 4; ++j) {       // token 8 (j / 2) + 2c + j % 2 of the tile
      const int tok = tok0 + 8 * (j / 2) + r_lane + j % 2;
      if (tok >= m) continue;
      float2* p = reinterpret_cast<float2*>(dst + (size_t)tok * n + ch);
      float2 v = make_float2(acc[i][4 * (j / 2) + j % 2], acc[i][4 * (j / 2) + 2 + j % 2]);
      if (!first) {
        const float2 o = *p;
        v = make_float2(__fadd_rn(o.x, v.x), __fadd_rn(o.y, v.y));
      }
      if (scaled) v = make_float2(__fmul_rn(v.x, s0), __fmul_rn(v.y, s1));
      *p = v;
    }
  }
}

// The same fold with the running sum in registers, where they are to
// spare: total = acc for the first range, total + acc after it.
template <int N>
__device__ __forceinline__ void fold_registers(float (&total)[N], const float (&acc)[N],
                                               bool first) {
#pragma unroll
  for (int j = 0; j < N; ++j) total[j] = first ? acc[j] : __fadd_rn(total[j], acc[j]);
}

// grid (ceil(M / TN) token tiles, ceil(N / 64CT) channel tiles, S in split
// mode else 1). Warpgroup 0 is the producer (one thread issues every TMA
// load), warpgroups 1 .. C the consumers, 64 T channels each.
template <int TN, int C, int T, int STAGES, int P>
__global__ void __launch_bounds__(Layout<TN, C, T, STAGES, P>::threads,
                                  Layout<TN, C, T, STAGES, P>::min_blocks)
int4_wgmma_kernel(const __grid_constant__ CUtensorMap w_map,
                  const __grid_constant__ CUtensorMap x_map, const float* __restrict__ scale,
                  float* out, float* partial, int m, int k, int n, int splits, int whole) {
  using L = Layout<TN, C, T, STAGES, P>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bar_off);   // [STAGES]
  uint64_t* empty = full + STAGES;                                    // [STAGES]

  const int tok0 = blockIdx.x * TN, n0 = blockIdx.y * 64 * C * T;
  const int units = cdiv(k, kUnitK);
  const int s_first = whole ? 0 : blockIdx.z, s_end = whole ? splits : blockIdx.z + 1;
  const int u_first = split_unit(s_first, units, splits), u_end = split_unit(s_end, units, splits);
  const int warp = threadIdx.x / 32;

  if (threadIdx.x == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full + st, 1);
      mbar_init(empty + st, 4 * C);          // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp < 4) {
    // ---- producer warpgroup: one thread issues every load ----
    if constexpr (C == 2)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(kProducerRegs));
    if (threadIdx.x == 0) {
      for (int u = u_first; u < u_end; ++u) {
        const int it = u - u_first, st = it % STAGES;
        mbar_wait(empty + st, ((it / STAGES) & 1) ^ 1);   // the first round passes
        uint8_t* dst = smem + st * L::stage_bytes;
        mbar_expect_tx(full + st, L::stage_bytes);
        tma_load_3d(dst, &x_map, full + st, u * kUnitK, tok0, 0);
        tma_load_2d(dst + L::x_bytes, &w_map, full + st, n0 / 2, u * kUnitK);
      }
    }
  } else {
    // ---- consumer warpgroup wg: channels n0 + 64 T wg .. + 64 T - 1 ----
    if constexpr (C == 2)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(kConsumerRegs));
    const int wg = warp / 4 - 1, t = threadIdx.x % 128, lane = t % 32;
    // A row 16 (t / 32) + 8h + g of tile i is channel n0 + 2 (col0 + 32 i) + h:
    // the nibble h of packed byte column col0 + 32 i
    const int col0 = 32 * T * wg + 8 * (t / 32) + lane / 4;
    const int r_lane = 2 * (lane % 4);
    const bool to_partial = !whole && splits > 1;
    float* dst = to_partial ? partial + (size_t)s_first * m * n : out;
    // a range's first wgmma writes the accumulator (scale-d 0) rather than
    // adding to zeros: no other instruction defines it while wgmmas run, so
    // ptxas need not serialize them
    float acc[T][TN / 2];
    bool fresh = true;
    // whole mode keeps the ranges' running sum in registers where they are
    // to spare, else in the output itself; the next unit's packed bytes are
    // loaded while this unit's wgmmas run where registers allow, else after
    // (ptxas fits the consumers into the block's launch-bound count, 168
    // with two warpgroups, whatever `setmaxnreg` adds)
    constexpr int kAccRegs = T * TN / 2, kARegs = 16 * T, kRawRegs = 8 * T;
    constexpr bool kRegTotal = 2 * kAccRegs + kARegs <= 144;
    constexpr bool kPrefetch = !kRegTotal || 2 * kAccRegs + kARegs + kRawRegs <= 144;
    float total[kRegTotal ? T : 1][kRegTotal ? TN / 2 : 1];
    // the operands of the wgmmas in flight, and the next unit's packed bytes
    uint32_t a[T][kUnitK / 16][4], raw[T][kUnitK / 16][2];

    int s = s_first, range_end = split_unit(s + 1, units, splits), prev = -1;
    for (int u = u_first; u < u_end; ++u) {
      const int it = u - u_first, st = it % STAGES;
      const uint8_t* stage = smem + st * L::stage_bytes;
      mbar_wait(full + st, (it / STAGES) & 1);
      if constexpr (kPrefetch) load_fragments<L::w_row, T>(stage + L::x_bytes, r_lane, col0, raw);
      // the previous unit's products are done: each warp releases its stage
      // once its own wait returns, and the range is folded in where that unit
      // ended one
      wgmma_wait_all();
      fence_regs(acc);
      fence_regs(a);
      if (prev >= 0 && lane == 0) mbar_arrive(empty + prev);
      if (u == range_end) {
        if constexpr (kRegTotal) {
#pragma unroll
          for (int i = 0; i < T; ++i) fold_registers(total[i], acc[i], s == s_first);
        } else {
          fold<TN, T>(acc, dst, scale, s == s_first, false, m, n, tok0, r_lane, n0 + 2 * col0);
        }
        fresh = true;
        ++s;
        range_end = split_unit(s + 1, units, splits);
      }
      if constexpr (!kPrefetch) load_fragments<L::w_row, T>(stage + L::x_bytes, r_lane, col0, raw);
#pragma unroll
      for (int i = 0; i < T; ++i)
#pragma unroll
        for (int kk = 0; kk < kUnitK / 16; ++kk) dequant(raw[i][kk], a[i][kk]);
      const uint32_t xb = smem_u32(stage);
      wgmma_fence();
      // per k16 step the planes hi, mid, lo in that order; a k16 step's 32
      // bytes lie inside each token's 128-byte swizzled row
#pragma unroll
      for (int kk = 0; kk < kUnitK / 16; ++kk)
#pragma unroll
        for (int i = 0; i < T; ++i)
#pragma unroll
          for (int p = 0; p < P; ++p)
            wgmma_rs<TN>(acc[i], a[i][kk], sw128_desc(xb + p * L::x_plane + 32 * kk),
                         !(fresh && kk == 0 && p == 0));
      wgmma_commit();
      fresh = false;
      prev = st;
    }
    wgmma_wait_all();
    fence_regs(acc);
    if constexpr (kRegTotal) {
      if (s != s_first) {
#pragma unroll
        for (int i = 0; i < T; ++i) fold_registers(acc[i], total[i], false);   // total + acc
      }
    }
    fold<TN, T>(acc, dst, scale, kRegTotal || s == s_first, !to_partial, m, n, tok0, r_lane,
                n0 + 2 * col0);
  }
}

// out = ((p0 + p1) + p2 ...) * scale, the ranges' partial sums in order
__global__ void sum_splits_kernel(const float* __restrict__ partial,
                                  const float* __restrict__ scale, float* __restrict__ out, int m,
                                  int n, int splits) {
  const size_t mn = (size_t)m * n;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < mn;
       i += (size_t)gridDim.x * blockDim.x) {
    float sum = partial[i];
    for (int s = 1; s < splits; ++s) sum = __fadd_rn(sum, partial[s * mn + i]);
    out[i] = __fmul_rn(sum, scale[i % n]);
  }
}

// fp32 x [m, k] -> planes [3][m][row] bf16: hi = bf16(x), mid = bf16(x - hi),
// lo = bf16(x - hi - mid); both differences are exact in fp32, and hi + mid
// + lo == x for normal x
__global__ void split_bf16x3_kernel(const float* __restrict__ x, __nv_bfloat16* __restrict__ planes,
                                    int m, int k, int row) {
  const size_t mk = (size_t)m * k, plane = (size_t)m * row;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < mk;
       i += (size_t)gridDim.x * blockDim.x) {
    const float v = x[i];
    const __nv_bfloat16 hi = __float2bfloat16_rn(v);
    const float r1 = __fsub_rn(v, __bfloat162float(hi));
    const __nv_bfloat16 mid = __float2bfloat16_rn(r1);
    const __nv_bfloat16 lo = __float2bfloat16_rn(__fsub_rn(r1, __bfloat162float(mid)));
    const size_t o = (i / k) * row + i % k;
    planes[o] = hi;
    planes[plane + o] = mid;
    planes[2 * plane + o] = lo;
  }
}

int grid_stride_blocks(size_t elems) {
  return (int)(elems / 256 + 1 < 8192 ? elems / 256 + 1 : 8192);
}

// x planes [planes][m][row] bf16 as a 3-D map whose box is (64 k, TN
// tokens, all planes), 128-byte swizzled; reads past K or M fill zeros
bool make_x_map(EncodeTiled encode, CUtensorMap* map, const void* base, int m, int k, int row,
                int planes, int tn) {
  const cuuint64_t dims[3] = {(cuuint64_t)k, (cuuint64_t)m, (cuuint64_t)planes};
  const cuuint64_t strides[2] = {(cuuint64_t)row * 2, (cuuint64_t)m * row * 2};
  const cuuint32_t box[3] = {(cuuint32_t)kUnitK, (cuuint32_t)tn, (cuuint32_t)planes};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// packed [k, n/2] bytes as a 2-D map whose box is (rw bytes, 64 k), swizzled
// in rw-byte rows (rw = 32, 64 or 128); reads past K or N fill zeros
// (nibble 0 is 0)
bool make_w_map(EncodeTiled encode, CUtensorMap* map, const void* base, int k, int n, int rw) {
  const cuuint64_t dims[2] = {(cuuint64_t)n / 2, (cuuint64_t)k};
  const cuuint64_t strides[1] = {(cuuint64_t)n / 2};
  const cuuint32_t box[2] = {(cuuint32_t)rw, (cuuint32_t)kUnitK};
  const cuuint32_t elem[2] = {1, 1};
  const CUtensorMapSwizzle swizzle = rw == 32   ? CU_TENSOR_MAP_SWIZZLE_32B
                                     : rw == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                : CU_TENSOR_MAP_SWIZZLE_128B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims, strides, box,
                elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int TN, int C, int T, int STAGES, int P>
int launch_wgmma(const void* xs, int row, const void* packed, const float* scale, float* out,
                 float* partial, int m, int k, int n, int splits, int whole, cudaStream_t stream) {
  using L = Layout<TN, C, T, STAGES, P>;
  static_assert(L::bytes <= 232448, "a block takes at most 227 KB of shared memory");
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSharedObjectSymbolNotFound;
  CUtensorMap xm, wm;
  if (!make_x_map(encode, &xm, xs, m, k, row, P, TN) ||
      !make_w_map(encode, &wm, packed, k, n, L::w_row))
    return (int)cudaErrorInvalidValue;
  auto kernel = int4_wgmma_kernel<TN, C, T, STAGES, P>;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         L::bytes);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const dim3 grid(cdiv(m, TN), cdiv(n, 64 * C * T), whole ? 1 : splits);
  kernel<<<grid, L::threads, L::bytes, stream>>>(wm, xm, scale, out, partial, m, k, n, splits,
                                                 whole);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// SIMT path: shapes TMA cannot take
// ---------------------------------------------------------------------------

constexpr int kSimtWarps = 8;
constexpr int kSimtThreads = kSimtWarps * 32;
constexpr int kSimtRows = 4;                        // output rows per block
constexpr int kLaneCols = 8;                        // output columns per lane (one 32-bit word)
constexpr int kSimtTileN = 32 * kLaneCols;          // output columns per block
static_assert(kSimtThreads == kSimtTileN, "the epilogue gives each thread one column");

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// grid (ceil(N/256), ceil(M/4)).
template <typename T>
__global__ void __launch_bounds__(kSimtThreads)
int4_simt_kernel(const T* __restrict__ x, const uint8_t* __restrict__ packed,
                 const float* __restrict__ scale, float* __restrict__ out, int m, int k, int n) {
  __shared__ float part[kSimtWarps][kSimtRows][kSimtTileN];      // 32 KB
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m0 = blockIdx.y * kSimtRows, n0 = blockIdx.x * kSimtTileN;
  const int col0 = n0 + lane * kLaneCols;
  const int half_n = n / 2;
  const int rows = min(kSimtRows, m - m0);
  const int span = (k + kSimtWarps - 1) / kSimtWarps;
  const int k_begin = min(k, warp * span), k_end = min(k, k_begin + span);
  // one aligned 32-bit load per k where the lane's 8 columns lie inside N
  // and packed rows are word aligned; masked byte loads otherwise
  const bool word = (half_n % 4 == 0) && (col0 + kLaneCols <= n);
  const uint8_t* wp = packed + col0 / 2;

  float acc[kSimtRows][kLaneCols];
#pragma unroll
  for (int r = 0; r < kSimtRows; ++r)
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
    for (int r = 0; r < kSimtRows; ++r) {
      if (r < rows) {
        const float xv = to_float(x[(size_t)(m0 + r) * k + kk]);
#pragma unroll
        for (int j = 0; j < kLaneCols; ++j) acc[r][j] = fmaf(xv, w[j], acc[r][j]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kSimtRows; ++r)
#pragma unroll
    for (int j = 0; j < kLaneCols; ++j) part[warp][r][lane * kLaneCols + j] = acc[r][j];
  __syncthreads();

  const int c = threadIdx.x, col = n0 + c;
  if (col >= n) return;
  const float s = scale[col];
  for (int r = 0; r < rows; ++r) {
    float sum = part[0][r][c];
#pragma unroll
    for (int w = 1; w < kSimtWarps; ++w) sum += part[w][r][c];
    out[(size_t)(m0 + r) * n + col] = sum * s;
  }
}

int launch_simt(const void* x, int x_bf16, const void* packed, const float* scale, float* out,
                int m, int k, int n, cudaStream_t stream) {
  const dim3 grid(cdiv(n, kSimtTileN), cdiv(m, kSimtRows));
  const uint8_t* wp = static_cast<const uint8_t*>(packed);
  if (x_bf16)
    int4_simt_kernel<__nv_bfloat16><<<grid, kSimtThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(x), wp, scale, out, m, k, n);
  else
    int4_simt_kernel<float><<<grid, kSimtThreads, 0, stream>>>(
        static_cast<const float*>(x), wp, scale, out, m, k, n);
  return (int)cudaGetLastError();
}

// the tensor-core kernel of geometry (tn, c, t, stages) for x's passes
int launch_geometry(const void* xs, int row, int x_bf16, const void* packed, const float* scale,
                    float* out, float* partial, int m, int k, int n, int tn, int c, int t,
                    int stages, int splits, int whole, cudaStream_t stream) {
#define GEOMETRY(TN, C, T, STAGES)                                                         \
  if (tn == TN && c == C && t == T && stages == STAGES)                                   \
    return x_bf16 ? launch_wgmma<TN, C, T, STAGES, 1>(xs, row, packed, scale, out, partial, m, \
                                                      k, n, splits, whole, stream)          \
                  : launch_wgmma<TN, C, T, STAGES, 3>(xs, row, packed, scale, out, partial, m, \
                                                      k, n, splits, whole, stream);
  GEOMETRY(8, 1, 1, 8)
  GEOMETRY(8, 1, 2, 8)
  GEOMETRY(8, 2, 1, 8)
  GEOMETRY(8, 2, 2, 8)
  GEOMETRY(8, 2, 2, 4)
  GEOMETRY(64, 2, 1, 4)
  GEOMETRY(64, 2, 2, 4)
  GEOMETRY(128, 2, 1, 4)
  GEOMETRY(128, 2, 2, 3)
#undef GEOMETRY
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x [m, k] (fp32, or bf16 when x_bf16), packed [k, n/2] int8, scale [n]
// fp32, out [m, n] fp32, all contiguous and 16-byte aligned. The caller
// guarantees m, n > 0 and n even.
//   tensor_cores = 0: the SIMT kernel (any k >= 0; ceil(m/4) <= 65535).
//   tensor_cores = 1: the wgmma kernel of geometry (tn, c, t, stages), one
//     of the wrapper's INT4_GEOMETRIES, with K cut into `splits` ranges
//     (1 <= splits <= ceil(k/64)), in whole mode (`whole` = 1: a block
//     walks every range) or split mode (partial sums of the ranges in
//     `partial` [splits, m, n] fp32, then summed in order). Needs k >= 1,
//     n % 32 == 0 and, for bf16 x, k % 8 == 0; fp32 x is first split into
//     `planes` [3, m, round_up(k, 8)] bf16.
// One call launches up to three kernels on `stream`. Returns
// cudaErrorInvalidValue for a geometry it has no kernel for.
extern "C" int int4_matmul(const void* x, int x_bf16, const void* packed, const float* scale,
                           float* out, int m, int k, int n, int tensor_cores, int tn, int c,
                           int t, int stages, int splits, int whole, void* planes,
                           float* partial, cudaStream_t stream) {
  if (!tensor_cores) return launch_simt(x, x_bf16, packed, scale, out, m, k, n, stream);
  const void* xs = x;
  int row = k;
  if (!x_bf16) {
    row = cdiv(k, 8) * 8;
    const size_t mk = (size_t)m * k;
    split_bf16x3_kernel<<<grid_stride_blocks(mk), 256, 0, stream>>>(
        static_cast<const float*>(x), static_cast<__nv_bfloat16*>(planes), m, k, row);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    xs = planes;
  }
  const int err = launch_geometry(xs, row, x_bf16, packed, scale, out, partial, m, k, n, tn, c,
                                  t, stages, splits, whole, stream);
  if (err != 0 || whole || splits == 1) return err;
  sum_splits_kernel<<<grid_stride_blocks((size_t)m * n), 256, 0, stream>>>(partial, scale, out, m,
                                                                           n, splits);
  return (int)cudaGetLastError();
}
