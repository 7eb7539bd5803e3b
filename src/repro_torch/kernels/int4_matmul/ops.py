"""W4A16 linear layer over packed int4 weights (`QTensor`).

``int4_matmul(x, packed, scale)`` is x [M, K] @ the int4 weights packed
two to a byte along N ([K, N/2] int8, `core.quant.pack_int4`'s layout),
summed in fp32 and times the per-channel ``scale`` [1, N] at the end: on a
CUDA tensor the hand kernel in ``csrc/int4_matmul.cu``, on a CPU tensor
``int4_matmul_plain``. ``w4a16_linear(x, qt)`` takes any leading dims; the
kernel masks ragged M, K and N itself, so nothing is padded (the JAX
wrapper pads to its TPU blocks).

``KERNEL_LAUNCHES`` counts wrapper calls (one per ``int4_matmul`` call, on
either path); hand-kernel launches alone are in
``kernels._build.CUDA_LAUNCHES``.
"""
from __future__ import annotations

import collections
import ctypes

import torch

from ...core.quant import QTensor, unpack_int4
from .. import _build

# name -> number of wrapper calls issued
KERNEL_LAUNCHES: collections.Counter = collections.Counter()

#: rows of one block of the CUDA kernel (the grid's second axis is M / 4)
CUDA_TILE_M = 4
MAX_GRID_Y = 65535


def int4_matmul_plain(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor
                      ) -> torch.Tensor:
    """(x in fp32 @ the unpacked int4 values in fp32) * scale -> [M, N] fp32."""
    k, half_n = packed.shape
    w = unpack_int4(packed, (k, 2 * half_n)).float()
    return (x.float() @ w) * scale.reshape(1, -1).float()


def _int4_matmul_cuda(x, packed, scale):
    _build.check_cuda_operands(
        "int4_matmul", {"x": (torch.float32, torch.bfloat16), "packed": (torch.int8,)},
        x=x, packed=packed, scale=scale)
    m, k = x.shape
    half_n = packed.shape[1]
    n = 2 * half_n
    if packed.shape[0] != k or scale.numel() != n:
        raise ValueError(f"int4_matmul: x {tuple(x.shape)}, packed {tuple(packed.shape)}, "
                         f"scale {tuple(scale.shape)} disagree")
    if -(-m // CUDA_TILE_M) > MAX_GRID_Y:
        raise ValueError(f"int4_matmul: M = {m} exceeds {CUDA_TILE_M * MAX_GRID_Y} rows")
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0:
        return out
    vp = ctypes.c_void_p
    _build.launch(
        "int4_matmul", [vp, ctypes.c_int, vp, vp, vp, ctypes.c_int, ctypes.c_int,
                        ctypes.c_int, vp],
        _build.ptr(x), int(x.dtype == torch.bfloat16), _build.ptr(packed), _build.ptr(scale),
        _build.ptr(out), m, k, n, _build.stream())
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
