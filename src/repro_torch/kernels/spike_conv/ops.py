"""Occupancy-mapped spiking convolution: the sparse core.

``spike_conv2d_mapped`` im2cols the binary spikes (plain torch, on the
spikes' device), pads the problem to the plan's tiles and hands it to
``spike_matmul_mapped``: on a CUDA tensor the hand kernel in
``csrc/spike_matmul_mapped.cu`` (occupancy pre-pass + gated product), on a
CPU tensor its plain PyTorch version ``spike_matmul_mapped_plain``. Both
return the output and the occupancy maps at the plan's (block_m x block_k)
tile geometry, from which the tile-skip stats follow.

``KERNEL_LAUNCHES`` counts wrapper calls per kernel name (one per
``spike_conv2d_mapped`` call, on either path); the hand-kernel launches
alone are counted in ``kernels._build.CUDA_LAUNCHES``.
"""
from __future__ import annotations

import collections
import ctypes
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ...core.tiling import round_up as _round_up
from .. import _build
from .ref import im2col

# name -> number of gated-matmul wrapper calls issued
KERNEL_LAUNCHES: collections.Counter = collections.Counter()

# rows of one product block of the CUDA kernel; the plan's block_m must be a
# multiple so each block lies inside one occupancy tile
CUDA_TILE_M = 128
CUDA_TILE_N = 128
CUDA_STEP_K = 16


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


def _spike_matmul_mapped_cuda(patches, w2d, *, block_m, block_k, gate):
    _build.check_cuda_operands("spike_matmul_mapped", patches=patches, w2d=w2d)
    m, k = patches.shape
    k2, n = w2d.shape
    if (k != k2 or m % block_m or block_m % CUDA_TILE_M or k % block_k
            or block_k % CUDA_STEP_K or n % CUDA_TILE_N):
        raise ValueError(
            f"spike_matmul_mapped: unsupported geometry M={m} K={k} N={n} "
            f"block_m={block_m} block_k={block_k} (needs M % block_m == 0, "
            f"block_m % {CUDA_TILE_M} == 0, K % block_k == 0, "
            f"block_k % {CUDA_STEP_K} == 0, N % {CUDA_TILE_N} == 0)")
    out = torch.empty((m, n), dtype=torch.float32, device=patches.device)
    row_occ = torch.empty((m, k // block_k), dtype=torch.int8, device=patches.device)
    occ = torch.empty((m // block_m, k // block_k), dtype=torch.int32,
                      device=patches.device)
    c_int = ctypes.c_int
    _build.launch(
        "spike_matmul_mapped",
        [ctypes.c_void_p] * 5 + [c_int] * 6 + [ctypes.c_void_p],
        _build.ptr(patches), _build.ptr(w2d), _build.ptr(out),
        _build.ptr(row_occ), _build.ptr(occ),
        m, k, n, block_m, block_k, int(gate), _build.stream())
    return out, occ, row_occ


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
                                     block_k=block_k, gate=gate)


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
