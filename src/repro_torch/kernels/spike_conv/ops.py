"""Spiking convolution: the sparse core, in-kernel-gated and occupancy-mapped.

``spike_conv2d`` is the pre-fusion baseline (one call per timestep): it
im2cols the binary spikes, pads the problem to the TPU tile sizes it is
given and hands it to ``spike_matmul``: on a CUDA tensor the hand kernel in
``csrc/spike_matmul.cu``, which packs the spikes it reads into bit words
inside the kernel and adds only the weight rows they select (its gate), on
a CPU tensor its plain version ``spike_matmul_plain``.

``spike_conv2d_mapped`` im2cols the binary spikes (plain torch, on the
spikes' device), pads the problem to the plan's tiles and hands it to
``spike_matmul_mapped``: on a CUDA tensor the hand kernel in
``csrc/spike_matmul_mapped.cu`` (occupancy and bitmask pre-pass, then an
event-driven product that adds the weight rows the spikes select), on a
CPU tensor its plain PyTorch version ``spike_matmul_mapped_plain``. Both
return the output and the occupancy maps at the plan's (block_m x block_k)
tile geometry, from which the tile-skip stats follow.

``KERNEL_LAUNCHES`` counts wrapper calls per kernel name (one per
``spike_conv2d`` or ``spike_conv2d_mapped`` call, on either path); the
hand-kernel launches alone are counted in ``kernels._build.CUDA_LAUNCHES``.
"""
from __future__ import annotations

import collections
import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ...core.tiling import round_up as _round_up
from .. import _build
from .._build import H100_SMS
from .ref import im2col

# name -> number of gated-matmul wrapper calls issued
KERNEL_LAUNCHES: collections.Counter = collections.Counter()

# geometries (rows, cols) of the event-driven product
# (`spike_matmul_mapped.cu`): a block owns `rows` rows (one warp per 4) x
# `cols` output columns. In this order of preference, which is the order of
# their times at the served shapes on an H100 (`chip_smoke.py --sweep`):
# wide blocks of 32-64 rows first, narrower columns where a shape needs
# them to fill the card. The k axis goes in 32-deep mask words,
# EVENT_STAGE_WORDS of them a stage, through a ring of EVENT_STAGES
# shared-memory stages.
EVENT_GEOMETRIES = ((64, 128), (32, 128), (32, 64), (64, 64), (16, 128), (16, 64))
EVENT_WORD_K = 32
EVENT_STAGE_WORDS = 2
EVENT_STAGES = 3
EVENT_MAX_SMEM = 225 * 1024      # bytes of shared memory a block takes (227 KB opt-in
                                 # less room for the kernel's static shared memory)
# geometries (rows, cols, rows_per_warp, cols_per_lane) of the in-kernel-
# gated spike-bit core (`spike_matmul.cu`): a block owns `rows` x `cols`
# outputs, each consumer warp rows_per_warp rows x 32 * cols_per_lane
# columns. In this order of preference, from their times at the unfused
# pipeline's shapes and spike densities 0.1 / 0.33 / 1.0 on an H100
# (`chip_smoke.py --sweep`, PERF.md): the widest block that fills the card;
# 8-row blocks of one-row warps where M = 512 leaves no other way to fill
# it; 64 columns where N % 128 != 0. The k axis goes in 32-deep spike words;
# M, K and N must be multiples of GATED_M, GATED_WORD_K and GATED_N.
GATED_GEOMETRIES = ((32, 128, 2, 4), (16, 128, 4, 4), (8, 128, 1, 4), (16, 64, 2, 2))
GATED_M = 64
GATED_N = 64
GATED_WORD_K = 32


def reset_launch_counts() -> None:
    KERNEL_LAUNCHES.clear()


def launch_counts() -> Dict[str, int]:
    return dict(KERNEL_LAUNCHES)


def _pad_to(x: torch.Tensor, axis: int, multiple: int) -> torch.Tensor:
    pad = (-x.shape[axis]) % multiple
    if pad == 0:
        return x
    widths = [0, 0] * x.ndim
    widths[2 * (x.ndim - 1 - axis) + 1] = pad     # F.pad counts from the last axis
    return F.pad(x, widths)


def occupancy_map(patches: torch.Tensor, block_m: int, block_k: int) -> torch.Tensor:
    """[M, K] binary spikes -> [M/bm, K/bk] int32 map: 1 iff the tile spikes."""
    m, k = patches.shape
    assert m % block_m == 0 and k % block_k == 0, ((m, k), (block_m, block_k))
    tiles = patches.reshape(m // block_m, block_m, k // block_k, block_k)
    return (tiles != 0).any(dim=3).any(dim=1).to(torch.int32)


def row_occupancy(patches: torch.Tensor, block_k: int) -> torch.Tensor:
    """[M, K] binary spikes -> [M, K/bk] int8: 1 iff the row spikes in the k tile."""
    m, k = patches.shape
    return (patches.reshape(m, k // block_k, block_k) != 0).any(dim=2).to(torch.int8)


def spike_matmul_plain(patches: torch.Tensor, w2d: torch.Tensor, *,
                       gate: bool = True) -> torch.Tensor:
    """Plain PyTorch version of the in-kernel-gated product, on any device:
    patches [M, K] @ w2d [K, N] in fp32. Empty tiles contribute exact
    zeros, so skipping them (``gate``) changes nothing."""
    return patches @ w2d


@functools.lru_cache(maxsize=None)
def gated_geometry(m: int, k: int, n: int, sms: int = H100_SMS,
                   geometry: Optional[Tuple[int, int, int, int]] = None
                   ) -> Tuple[int, int, int, int]:
    """(rows, cols, rows_per_warp, cols_per_lane) of the spike-bit core's
    blocks for [M, K] x [K, N]: ``geometry`` where given (it must be one of
    ``GATED_GEOMETRIES`` and divide the problem), else the first of them
    that divides the problem and puts at least ``sms`` blocks on the card,
    else the one with the most blocks. Raises on a problem or a geometry
    the kernel does not take.
    """
    if m <= 0 or k <= 0 or n <= 0 or m % GATED_M or k % GATED_WORD_K or n % GATED_N:
        raise ValueError(
            f"spike_matmul: unsupported geometry M={m} K={k} N={n} (needs "
            f"M % {GATED_M} == 0, K % {GATED_WORD_K} == 0, N % {GATED_N} == 0)")
    fits = [g for g in GATED_GEOMETRIES
            if m % g[0] == 0 and n % g[1] == 0]
    if geometry is not None:
        if geometry not in fits:
            raise ValueError(f"spike_matmul: geometry {geometry} does not fit M={m} N={n}")
        return geometry
    enough = [g for g in fits if gated_blocks(g, m, n) >= sms]
    return enough[0] if enough else max(fits, key=lambda g: gated_blocks(g, m, n))


def gated_blocks(geometry, m: int, n: int) -> int:
    return (m // geometry[0]) * (n // geometry[1])


def _spike_matmul_cuda(patches, w2d, *, gate, geometry=None):
    """The hand kernel. The patches must be 0/1 spikes: it adds the bare
    weight wherever a patch is nonzero, so any nonzero value counts as 1.
    ``geometry`` (one of ``GATED_GEOMETRIES``) overrides
    `gated_geometry`'s choice."""
    _build.check_cuda_operands("spike_matmul", patches=patches, w2d=w2d)
    m, k = patches.shape
    k2, n = w2d.shape
    if k != k2:
        raise ValueError(f"spike_matmul: K={k} != K'={k2}")
    chosen = gated_geometry(m, k, n, _build.sm_count(patches.device.index), geometry)
    out = torch.empty((m, n), dtype=torch.float32, device=patches.device)
    c_int = ctypes.c_int
    _build.launch(
        "spike_matmul", [ctypes.c_void_p] * 3 + [c_int] * 8 + [ctypes.c_void_p],
        _build.ptr(patches), _build.ptr(w2d), _build.ptr(out),
        m, k, n, int(gate), *chosen, _build.stream())
    return out


def spike_matmul(patches: torch.Tensor, w2d: torch.Tensor, *,
                 gate: bool = True) -> torch.Tensor:
    """In-kernel-gated product of padded operands -> out [M, N].

    The patches must be 0/1 spikes, as the TPU kernel's are: the hand
    kernel counts any nonzero patch as 1, where the plain version would
    multiply by it. The patches' device picks the path: CPU -> the plain
    version, CUDA -> the hand kernel (raises on operands it does not take).
    """
    if _build.is_cpu("spike_matmul", patches):
        return spike_matmul_plain(patches, w2d, gate=gate)
    return _spike_matmul_cuda(patches, w2d, gate=gate)


def spike_conv2d(
    spikes: torch.Tensor,
    weights: torch.Tensor,
    *,
    padding: str = "SAME",
    block_m: int = 256,
    block_k: int = 128,
    block_n: int = 128,
    gate: bool = True,
) -> torch.Tensor:
    """Event-driven spiking conv: [B, H, W, Cin] x [KH, KW, Cin, Cout] (HWIO)
    -> [B, OH, OW, Cout] fp32, through the in-kernel-gated ``spike_matmul``.

    ``block_m/k/n`` are the JAX package's TPU tile sizes: they clamp to the
    padded problem and set the padding (M to block_m, K to block_k, N to
    block_n), as there; the CUDA kernel takes its own tiles, which divide
    every padded size.
    """
    b, h, w, cin = spikes.shape
    kh, kw, _, cout = weights.shape
    patches = im2col(spikes, kh, kw, padding)            # [M, K]
    w2d = weights.reshape(kh * kw * cin, cout)           # [K, N]

    m, k = patches.shape
    block_m = min(block_m, _round_up(m))
    block_k = min(block_k, _round_up(k))
    block_n = min(block_n, _round_up(cout))
    patches = _pad_to(_pad_to(patches, 0, block_m), 1, block_k).contiguous()
    w2d = _pad_to(_pad_to(w2d, 0, block_k), 1, block_n).contiguous()

    KERNEL_LAUNCHES["spike_matmul"] += 1
    out = spike_matmul(patches, w2d, gate=gate)[:m, :cout]
    oh, ow = (h, w) if padding == "SAME" else (h - kh + 1, w - kw + 1)
    return out.reshape(b, oh, ow, cout)


def spike_matmul_mapped_plain(patches: torch.Tensor, w2d: torch.Tensor, *,
                              block_m: int, block_k: int, gate: bool = True
                              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the hand kernel, on any device.

    patches [M, K] @ w2d [K, N] in fp32 on the padded problem (empty tiles
    contribute exact zeros, so skipping them changes nothing), plus
    ``occ`` int32 [M/bm, K/bk] (all ones when ``gate`` is off) and
    ``row_occ`` int8 [M, K/bk].
    """
    occ = occupancy_map(patches, block_m, block_k)
    if not gate:
        occ = torch.ones_like(occ)
    return patches @ w2d, occ, row_occupancy(patches, block_k)


def spike_bitmask_plain(patches: torch.Tensor) -> torch.Tensor:
    """[M, K] spikes -> int32 [M, K/32] words: bit j of word w is 1 iff
    patches[:, 32w + j] != 0 (what the hand kernel's pre-pass packs)."""
    m, k = patches.shape
    bits = (patches != 0).reshape(m, k // EVENT_WORD_K, EVENT_WORD_K).to(torch.int64)
    words = (bits << torch.arange(EVENT_WORD_K, device=patches.device)).sum(dim=2)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)


def spike_matmul_event_plain(patches: torch.Tensor, w2d: torch.Tensor) -> torch.Tensor:
    """The hand kernel's product in its own order, on any device: each
    output element summed in fp32 from +0, k ascending, adding w2d[k] where
    the spike is set and nothing where it is not. The kernel matches it bit
    for bit."""
    acc = torch.zeros((patches.shape[0], w2d.shape[1]), dtype=torch.float32,
                      device=patches.device)
    for k in range(patches.shape[1]):
        acc = acc + torch.where(patches[:, k:k + 1] != 0, w2d[k], 0.0)
    return acc


def event_smem_bytes(rows: int, cols: int, k: int) -> int:
    """Dynamic shared memory of one product block: the weight ring, a row
    of zeros, the mask ring, each row's spike list, and the per-word flags
    and list."""
    return 4 * (EVENT_STAGES * EVENT_STAGE_WORDS * (EVENT_WORD_K * cols + rows) + cols
                + rows * EVENT_STAGE_WORDS * 32 + 2 * (k // EVENT_WORD_K))


@functools.lru_cache(maxsize=None)
def event_geometry(m: int, k: int, n: int, block_m: int, block_k: int,
                   sms: int = H100_SMS) -> Tuple[int, int]:
    """(rows, cols) of the event-driven product's blocks for
    [M, K] x [K, N] at the plan's (block_m, block_k): the first of
    ``EVENT_GEOMETRIES`` that fits and puts at least ``sms`` blocks on the
    card, else the one that fits with the most blocks. Raises on a geometry
    the kernel does not take.
    """
    if m % block_m or k % block_k or block_k % EVENT_WORD_K or n % 64:
        raise ValueError(
            f"spike_matmul_mapped: unsupported geometry M={m} K={k} N={n} "
            f"block_m={block_m} block_k={block_k} (needs M % block_m == 0, "
            f"K % block_k == 0, block_k % {EVENT_WORD_K} == 0, N % 64 == 0)")
    fits = [g for g in EVENT_GEOMETRIES if _fits(g, m, k, n)]
    if not fits:
        raise ValueError(
            f"spike_matmul_mapped: unsupported geometry M={m} K={k} N={n} (needs "
            f"M % 16 == 0 and K small enough for {EVENT_MAX_SMEM} bytes of shared memory)")
    blocks = {g: (m // g[0]) * (n // g[1]) for g in fits}
    enough = [g for g in fits if blocks[g] >= sms]
    return enough[0] if enough else max(fits, key=lambda g: blocks[g])


def _fits(geometry, m, k, n) -> bool:
    rows, cols = geometry
    return (m % rows == 0 and n % cols == 0
            and event_smem_bytes(rows, cols, k) <= EVENT_MAX_SMEM)


def _spike_matmul_mapped_cuda(patches, w2d, *, block_m, block_k, gate, geometry=None):
    """-> (out, occ, row_occ, the pre-pass's spike bitmask). ``geometry`` =
    (rows, cols) overrides `event_geometry`'s choice."""
    _build.check_cuda_operands("spike_matmul_mapped", patches=patches, w2d=w2d)
    m, k = patches.shape
    k2, n = w2d.shape
    if k != k2:
        raise ValueError(f"spike_matmul_mapped: K={k} != K'={k2}")
    rows, cols = event_geometry(m, k, n, block_m, block_k, _build.sm_count(patches.device.index))
    if geometry is not None:
        if geometry not in EVENT_GEOMETRIES or not _fits(geometry, m, k, n):
            raise ValueError(f"spike_matmul_mapped: geometry {geometry} does not fit "
                             f"M={m} K={k} N={n}")
        rows, cols = geometry
    out = torch.empty((m, n), dtype=torch.float32, device=patches.device)
    row_occ = torch.empty((m, k // block_k), dtype=torch.int8, device=patches.device)
    occ = torch.empty((m // block_m, k // block_k), dtype=torch.int32,
                      device=patches.device)
    mask = torch.empty((m, k // EVENT_WORD_K), dtype=torch.int32, device=patches.device)
    c_int = ctypes.c_int
    _build.launch(
        "spike_matmul_mapped",
        [ctypes.c_void_p] * 6 + [c_int] * 8 + [ctypes.c_void_p],
        _build.ptr(patches), _build.ptr(w2d), _build.ptr(out),
        _build.ptr(row_occ), _build.ptr(occ), _build.ptr(mask),
        m, k, n, block_m, block_k, int(gate), rows, cols, _build.stream())
    return out, occ, row_occ, mask


def spike_matmul_mapped(patches: torch.Tensor, w2d: torch.Tensor, *,
                        block_m: int, block_k: int, gate: bool = True
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gated product + occupancy maps -> (out [M, N], occ, row_occ).

    The patches' device picks the path: CPU -> the plain version, CUDA ->
    the hand kernel (raises on operands it does not take).
    """
    if _build.is_cpu("spike_matmul_mapped", patches):
        return spike_matmul_mapped_plain(patches, w2d, block_m=block_m,
                                         block_k=block_k, gate=gate)
    return _spike_matmul_mapped_cuda(patches, w2d, block_m=block_m,
                                     block_k=block_k, gate=gate)[:3]


def spike_conv2d_mapped(
    spikes: torch.Tensor,
    weights: torch.Tensor,
    *,
    padding: str = "SAME",
    block_m: int = 256,
    block_k: int = 128,
    block_n: int = 128,
    gate: bool = True,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Occupancy-mapped spiking conv -> (output, tile-skip stats).

    spikes [B, H, W, Cin] (the batch axis may carry folded timesteps) x
    weights [KH, KW, Cin, Cout] (HWIO) -> [B, OH, OW, Cout] fp32.

    The stats refer to the padded im2col matmul [M_pad, K_pad] with block
    sizes *after* clamping to the padded problem, as in the JAX package:
    ``tiles_total`` / ``tiles_occupied`` / ``skip_rate`` (0-d float32),
    ``occ_map`` (int32 [M_pad/bm, K_pad/bk]), ``row_occ`` (int8
    [M_pad, K_pad/bk]), ``block_m`` and ``rows`` (0-d int32; rows is the
    unpadded M).
    """
    b, h, w, cin = spikes.shape
    kh, kw, _, cout = weights.shape
    patches = im2col(spikes, kh, kw, padding)            # [M, K]
    w2d = weights.reshape(kh * kw * cin, cout)           # [K, N]

    m, k = patches.shape
    block_m = min(block_m, _round_up(m))
    block_k = min(block_k, _round_up(k))
    block_n = min(block_n, _round_up(cout))
    patches = _pad_to(_pad_to(patches, 0, block_m), 1, block_k).contiguous()
    w2d = _pad_to(_pad_to(w2d, 0, block_k), 1, block_n).contiguous()

    KERNEL_LAUNCHES["spike_matmul_mapped"] += 1
    out, occ, row_occ = spike_matmul_mapped(patches, w2d, block_m=block_m,
                                            block_k=block_k, gate=gate)
    out = out[:m, :cout]
    oh, ow = (h, w) if padding == "SAME" else (h - kh + 1, w - kw + 1)

    tiles_total = torch.tensor(occ.numel(), dtype=torch.float32, device=occ.device)
    tiles_occupied = occ.sum().to(torch.float32)
    stats = {
        "tiles_total": tiles_total,
        "tiles_occupied": tiles_occupied,
        "skip_rate": (tiles_total - tiles_occupied) / tiles_total,
        "occ_map": occ,
        "row_occ": row_occ,
        "block_m": torch.tensor(block_m, dtype=torch.int32, device=occ.device),
        "rows": torch.tensor(m, dtype=torch.int32, device=occ.device),
    }
    return out.reshape(b, oh, ow, cout), stats
