"""W4A16 linear layer over packed int4 weights (`QTensor`).

``int4_matmul(x, packed, scale)`` is x [M, K] @ the int4 weights packed
two to a byte along N ([K, N/2] int8, `core.quant.pack_int4`'s layout),
summed in fp32 and times the per-channel ``scale`` [1, N] at the end: on a
CUDA tensor the hand kernel in ``csrc/int4_matmul.cu``, on a CPU tensor
``int4_matmul_plain``. ``w4a16_linear(x, qt)`` takes any leading dims; the
kernel masks ragged M, K and N itself, so nothing is padded (the JAX
wrapper pads to its TPU blocks).

On the card, `int4_plan` picks the kernel's path and geometry from the
shapes: the tensor-core kernel (weights dequantized into wgmma's register
operand, tokens on wgmma's N, fp32 x as three exact bf16 terms, K cut
into ranges from (K, N) alone) where TMA can take the operands, the SIMT
kernel elsewhere. `split_bf16x3_plain` and `nibble_bf16_plain` are plain
mirrors of the kernel's two exact conversions.

``KERNEL_LAUNCHES`` counts wrapper calls (one per ``int4_matmul`` call, on
either path); hand-kernel launches alone are in
``kernels._build.CUDA_LAUNCHES``.
"""
from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
from typing import Optional, Tuple

import torch

from ...core.quant import QTensor, unpack_int4
from .. import _build
from .._build import H100_SMS

# name -> number of wrapper calls issued
KERNEL_LAUNCHES: collections.Counter = collections.Counter()

#: k per stage and per split unit of the tensor-core kernel
UNIT_K = 64
#: channels per consumer warpgroup of the tensor-core kernel (wgmma's M)
WARPGROUP_N = 64
#: (token width, consumer warpgroups, 64-channel tiles per warpgroup,
#: stages) of the tensor-core kernels, as `int4_matmul.cu` instantiates
#: them; a block owns token-width tokens and 64 x warpgroups x tiles
#: channels. (8, 2, 2, 4) and (128, 2, 2, 3) are there for `chip_smoke.py
#: --sweep` alone: the stage count at decode widths, and 256-channel blocks
#: at prefill widths.
INT4_GEOMETRIES = ((8, 1, 1, 8), (8, 1, 2, 8), (8, 2, 1, 8), (8, 2, 2, 8), (8, 2, 2, 4),
                   (64, 2, 1, 4), (64, 2, 2, 4), (128, 2, 1, 4), (128, 2, 2, 3))
# in order of preference, from their times at qwen1.5-4b's shapes on an
# H100 (`chip_smoke.py --sweep`, PERF.md): at decode widths (M <= 8) the
# widest block, at prefill widths the widest token tile with one 64-channel
# tile a warpgroup, that puts a consumer warpgroup on every SM
DECODE_GEOMETRIES = ((8, 2, 2, 8), (8, 2, 1, 8), (8, 1, 2, 8), (8, 1, 1, 8))
PREFILL_GEOMETRIES = ((128, 2, 1, 4), (64, 2, 2, 4), (64, 2, 1, 4), (8, 1, 1, 8))
#: rows of one block of the SIMT kernel (its grid's second axis is M / 4)
SIMT_TILE_M = 4
SIMT_TILE_N = 256
MAX_GRID_Y = 65535


@dataclasses.dataclass(frozen=True)
class Int4Plan:
    """How the card computes one [M, K] x [K, N] call.

    ``path`` is "tma" (the tensor-core kernel) or "ragged" (the SIMT
    kernel, for operands TMA cannot take). On the tma path K is cut into
    ``splits`` ranges of 64-deep units; ``whole`` blocks walk every range
    and add the ranges' sums in order, otherwise each block takes one range
    and a second pass adds the partial sums in the same order. ``ctas`` is
    the kernel's blocks, ``warpgroups`` consumer warpgroups each.
    ``planes_bytes`` and ``partial_bytes`` are the scratch the wrapper
    allocates: fp32 x's three bf16 terms and split mode's partial sums.
    """
    path: str
    token_width: int = 0
    warpgroups: int = 0
    tiles: int = 0
    stages: int = 0
    splits: int = 1
    whole: bool = True
    ctas: int = 0
    planes_bytes: int = 0
    partial_bytes: int = 0

    @property
    def geometry(self) -> Tuple[int, int, int, int]:
        return (self.token_width, self.warpgroups, self.tiles, self.stages)

    @property
    def scratch_bytes(self) -> int:
        return self.planes_bytes + self.partial_bytes


def tma_eligible(k: int, n: int, x_dtype: torch.dtype) -> bool:
    """TMA needs 16-byte row strides: N % 32 for ``packed``, K % 8 for bf16
    x (fp32 x is split into bf16 planes whose rows the pre-pass pads)."""
    return k >= 1 and n >= 32 and n % 32 == 0 and (x_dtype == torch.float32 or k % 8 == 0)


def int4_splits(k: int, n: int) -> int:
    """The number of K ranges, from (K, N) alone: enough that the 64-channel
    tiles times the ranges fill an H100's 132 SMs, at most one range per
    64-deep unit. Neither M nor the card enters, so a row's sum does not
    depend on its batch."""
    return max(1, min(-(-H100_SMS // -(-n // WARPGROUP_N)), -(-k // UNIT_K)))


@functools.lru_cache(maxsize=1024)
def int4_plan(m: int, k: int, n: int, x_dtype: torch.dtype, sms: int = H100_SMS,
              geometry: Optional[Tuple[int, int, int, int]] = None,
              splits: Optional[int] = None) -> Int4Plan:
    """The path and geometry of one call. On the tma path: the first of
    the preferred geometries whose grid puts a consumer warpgroup on each of
    ``sms`` SMs (a two-warpgroup block takes an SM alone), with each block
    walking every range (whole mode) where that does, else with a block per
    range (split mode); else the one with the most blocks. ``geometry`` and
    ``splits`` override the choice (for sweeps)."""
    if not tma_eligible(k, n, x_dtype):
        if geometry is not None or splits is not None:
            raise ValueError(f"int4_matmul: K={k} N={n} {x_dtype} takes the ragged path, "
                             "which has no geometry")
        return Int4Plan("ragged", ctas=-(-n // SIMT_TILE_N) * -(-m // SIMT_TILE_M))
    s = int4_splits(k, n) if splits is None else splits
    if not 1 <= s <= -(-k // UNIT_K):
        raise ValueError(f"int4_matmul: {s} splits of K={k} (1 .. {-(-k // UNIT_K)})")

    def ctas(g, whole):
        return -(-m // g[0]) * -(-n // (WARPGROUP_N * g[1] * g[2])) * (1 if whole else s)

    def fills(g, whole):
        return ctas(g, whole) * g[1] >= sms

    if geometry is not None:
        if geometry not in INT4_GEOMETRIES:
            raise ValueError(f"int4_matmul: no kernel for geometry {geometry}")
        whole = s == 1 or fills(geometry, True)
    else:
        prefs = DECODE_GEOMETRIES if m <= 8 else PREFILL_GEOMETRIES
        choices = [(g, w) for g in prefs for w in (True, False) if fills(g, w) and (w or s > 1)]
        geometry, whole = choices[0] if choices else (
            max(prefs, key=lambda g: ctas(g, s == 1)), s == 1)
    planes = 0 if x_dtype == torch.bfloat16 else 2 * 3 * m * (-(-k // 8) * 8)
    return Int4Plan("tma", *geometry, splits=s, whole=whole, ctas=ctas(geometry, whole),
                    planes_bytes=planes, partial_bytes=0 if whole else 4 * s * m * n)


def split_bf16x3_plain(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """fp32 x -> (hi, mid, lo) bf16, the pre-pass's split: hi = bf16(x), mid
    = bf16(x - hi), lo = bf16(x - hi - mid), each rounded to nearest even.
    Both differences are exact in fp32, and hi + mid + lo == x for normal x."""
    x = x.float()
    hi = x.bfloat16()
    r1 = x - hi.float()
    mid = r1.bfloat16()
    lo = (r1 - mid.float()).bfloat16()
    return hi, mid, lo


def nibble_bf16_plain(nibbles: torch.Tensor) -> torch.Tensor:
    """Nibbles 0..15 -> their signed int4 values as the kernel converts them:
    the bf16 bit pattern 0x4300 | (nibble ^ 8), which is 136 + value, minus
    136 in bf16."""
    bits = (0x4300 | (nibbles.to(torch.int32) ^ 8)).to(torch.int16)
    return bits.view(torch.bfloat16) - torch.tensor(136.0, dtype=torch.bfloat16)


def int4_matmul_plain(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor
                      ) -> torch.Tensor:
    """(x in fp32 @ the unpacked int4 values in fp32) * scale -> [M, N] fp32."""
    k, half_n = packed.shape
    w = unpack_int4(packed, (k, 2 * half_n)).float()
    return (x.float() @ w) * scale.reshape(1, -1).float()


def _int4_matmul_cuda(x, packed, scale, *, geometry=None, splits=None, sms=None):
    """The hand kernel; ``geometry`` (one of ``INT4_GEOMETRIES``),
    ``splits`` and the SM count `int4_plan` fills (``sms``) override the
    picker's choice."""
    _build.check_cuda_operands(
        "int4_matmul", {"x": (torch.float32, torch.bfloat16), "packed": (torch.int8,)},
        x=x, packed=packed, scale=scale)
    m, k = x.shape
    half_n = packed.shape[1]
    n = 2 * half_n
    if packed.shape[0] != k or scale.numel() != n:
        raise ValueError(f"int4_matmul: x {tuple(x.shape)}, packed {tuple(packed.shape)}, "
                         f"scale {tuple(scale.shape)} disagree")
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0:
        return out
    plan = int4_plan(m, k, n, x.dtype, sms or _build.sm_count(x.device.index), geometry, splits)
    if plan.path == "ragged" and -(-m // SIMT_TILE_M) > MAX_GRID_Y:
        raise ValueError(f"int4_matmul: M = {m} exceeds {SIMT_TILE_M * MAX_GRID_Y} rows")
    if plan.path == "tma" and -(-n // (WARPGROUP_N * plan.warpgroups * plan.tiles)) > MAX_GRID_Y:
        raise ValueError(f"int4_matmul: N = {n} exceeds {WARPGROUP_N * MAX_GRID_Y} columns")
    planes = partial = None
    if plan.planes_bytes:
        planes = torch.empty((3, m, -(-k // 8) * 8), dtype=torch.bfloat16, device=x.device)
    if plan.partial_bytes:
        partial = torch.empty((plan.splits, m, n), dtype=torch.float32, device=x.device)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    _build.launch(
        "int4_matmul", [vp, ci, vp, vp, vp] + [ci] * 10 + [vp, vp, vp],
        _build.ptr(x), int(x.dtype == torch.bfloat16), _build.ptr(packed), _build.ptr(scale),
        _build.ptr(out), m, k, n, int(plan.path == "tma"), plan.token_width, plan.warpgroups,
        plan.tiles, plan.stages, plan.splits, int(plan.whole),
        None if planes is None else _build.ptr(planes),
        None if partial is None else _build.ptr(partial), _build.stream())
    return out


def int4_matmul(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x [M, K] (fp32 or bf16) @ dequant(packed [K, N/2] int8, scale [1, N])
    -> [M, N] fp32.

    The tensor's device picks the path: CPU -> the plain version, CUDA ->
    the hand kernel (raises on operands it does not take).
    """
    KERNEL_LAUNCHES["int4_matmul"] += 1
    if _build.is_cpu("int4_matmul", x):
        return int4_matmul_plain(x, packed, scale)
    return _int4_matmul_cuda(x.contiguous(), packed.contiguous(),
                             scale.reshape(-1).float().contiguous())


def w4a16_linear(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """x [..., K] @ int4-packed qt (logical [K, N]) -> [..., N] fp32."""
    k, n = qt.shape
    lead = x.shape[:-1]
    scale = torch.broadcast_to(qt.scale.reshape(1, -1), (1, n))
    out = int4_matmul(x.reshape(-1, k), qt.packed, scale)
    return out.reshape(*lead, n)
