"""Dense core: the direct-coded input layer, conv once + T fused LIF steps.

``input_layer_conv_lif`` im2cols the image (plain torch, on its device) and
hands the patches to ``dense_conv_lif``: on a CUDA tensor the hand kernel in
``csrc/dense_conv_lif.cu``, on a CPU tensor ``dense_conv_lif_plain``. K
stays at its true depth (27 for a 3-channel 3x3 conv): the JAX package pads
it to 128 only for the TPU's lanes.

Launch configuration (block_m/block_n) comes from the caller — in the
serving pipeline the layer's `KernelSpec` from
`core.hybrid.plan_vgg9_inference`. The clamped blocks of each call are
recorded in ``LAUNCH_LOG`` so tests can assert the plan drives the launch,
though the CUDA grid uses its own layout: ``dense_geometry`` gives the
kernel's row tile, rows per thread, threads and blocks.

``dense_conv_lif_ordered_plain`` is the kernel's own sum order (k ascending,
each product and sum rounded to float32) in PyTorch, for the tests and
``chip_smoke.py`` to hold the kernel's bits against; no path runs it.
"""
from __future__ import annotations

import collections
import ctypes
import functools
from typing import Dict, List, Tuple

import torch

from ...core.tiling import round_up as _round_up
from .. import _build
from ..lif_step.ops import _f32
from ..spike_conv.ref import im2col

# name -> number of dense-core wrapper calls issued
KERNEL_LAUNCHES: collections.Counter = collections.Counter()
# clamped launch configurations, in issue order (cleared with the counter)
LAUNCH_LOG: List[Dict[str, int]] = []

# the CUDA kernel keeps its patch tile, w [K, N] and bias [N] in shared
# memory, at most what a block gets without opting in
SMEM_LIMIT_BYTES = 48 * 1024
# (rows a block, rows a thread, threads a block) of `dense_conv_lif.cu`. A
# thread owns its rows x 4 adjacent channels (x 1 where N % 4 != 0); the
# last block takes the M % 32 tail rows. At the served input layer (M =
# 8192) that is 256 blocks. On an H100 (PERF.md) 16-row, 64-row and
# 256-thread blocks timed within 4 % of it at M = 8192.
DENSE_GEOMETRY = (32, 4, 128)

_VP, _INT, _FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
DENSE_ARGTYPES = [_VP] * 5 + [_INT] * 4 + [_FLOAT, _FLOAT] + [_INT] * 3 + [_VP]


def reset_launch_counts() -> None:
    KERNEL_LAUNCHES.clear()
    LAUNCH_LOG.clear()


def launch_counts() -> Dict[str, int]:
    return dict(KERNEL_LAUNCHES)


def _lif_steps(current: torch.Tensor, num_steps: int, beta: float, theta: float
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """T LIF steps on a constant current from u = s = 0 -> (spikes [T, ...],
    final u). ``beta*u + current`` is rounded once, as in
    `lif_step.ops.lif_epilogue`."""
    u = torch.zeros_like(current)
    s = torch.zeros_like(current)
    out = []
    for _ in range(num_steps):
        u = (_f32(beta) * u.double() + current.double()).float() - s * theta
        s = (u > theta).to(current.dtype)
        out.append(s)
    return torch.stack(out), u


def dense_conv_lif_plain(patches: torch.Tensor, w2d: torch.Tensor,
                         bias: torch.Tensor, *, num_steps: int, beta: float,
                         theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: [M, K] @ [K, N] + bias, then T LIF steps from
    u = s = 0 -> (spikes [T, M, N], final u [M, N])."""
    return _lif_steps(patches @ w2d + bias, num_steps, beta, theta)


def dense_conv_lif_ordered_plain(patches: torch.Tensor, w2d: torch.Tensor,
                                 bias: torch.Tensor, *, num_steps: int, beta: float,
                                 theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """`dense_conv_lif_plain` with the CUDA kernel's sum order: the product
    summed k = 0..K-1, each product and each sum rounded to float32, then
    the bias added. Bit for bit what the kernel computes; for tests only."""
    acc = torch.zeros((patches.shape[0], w2d.shape[1]), dtype=torch.float32,
                      device=patches.device)
    for kk in range(patches.shape[1]):
        acc = acc + patches[:, kk:kk + 1] * w2d[kk]
    return _lif_steps(acc + bias, num_steps, beta, theta)


def dense_smem_bytes(rows: int, k: int, n: int) -> int:
    """Shared memory of a block: the [rows, K] patch tile, w, the bias."""
    return 4 * (rows * k + k * n + n)


@functools.lru_cache(maxsize=None)
def dense_geometry(m: int, k: int, n: int) -> Tuple[int, int, int, int]:
    """(rows a block, rows a thread, threads, blocks) of `dense_conv_lif.cu`
    for [M, K] x [K, N]: ``DENSE_GEOMETRY``, its threads cut to the block's
    micro-tiles where it has fewer. Raises on a problem the kernel does not
    take.
    """
    if m < 1 or k < 1 or n < 1:
        raise ValueError(f"dense_conv_lif: unsupported shape M={m} K={k} N={n}")
    rows, per_thread, threads = DENSE_GEOMETRY
    if dense_smem_bytes(rows, k, n) > SMEM_LIMIT_BYTES:
        raise ValueError(f"dense_conv_lif: K={k} N={n} exceed {SMEM_LIMIT_BYTES} bytes "
                         "of shared memory")
    tiles = rows // per_thread * (n // 4 if n % 4 == 0 else n)
    return rows, per_thread, min(threads, _round_up(tiles, 32)), -(-m // rows)


def _dense_conv_lif_cuda(patches, w2d, bias, *, num_steps, beta, theta):
    _build.check_cuda_operands("dense_conv_lif", patches=patches, w2d=w2d, bias=bias)
    m, k = patches.shape
    k2, n = w2d.shape
    if k != k2 or bias.shape != (n,):
        raise ValueError(f"dense_conv_lif: shapes {tuple(patches.shape)} "
                         f"{tuple(w2d.shape)} {tuple(bias.shape)} disagree")
    rows, per_thread, threads, _ = dense_geometry(m, k, n)
    spikes = patches.new_empty((num_steps, m, n))      # float32, on the patches' device
    u = patches.new_empty((m, n))
    _build.launch(
        "dense_conv_lif", DENSE_ARGTYPES,
        _build.ptr(patches), _build.ptr(w2d), _build.ptr(bias),
        _build.ptr(spikes), _build.ptr(u), m, k, n, num_steps, beta, theta,
        rows, per_thread, threads, _build.stream())
    return spikes, u


def dense_conv_lif(patches: torch.Tensor, w2d: torch.Tensor, bias: torch.Tensor, *,
                   num_steps: int, beta: float, theta: float
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[M, K] patches x [K, N] weights (+ bias [N]) -> spikes [T, M, N], u [M, N].

    The patches' device picks the path: CPU -> the plain version, CUDA ->
    the hand kernel (raises on operands it does not take).
    """
    if _build.is_cpu("dense_conv_lif", patches):
        return dense_conv_lif_plain(patches, w2d, bias, num_steps=num_steps,
                                    beta=beta, theta=theta)
    return _dense_conv_lif_cuda(patches.contiguous(), w2d.contiguous(),
                                bias.contiguous(), num_steps=num_steps,
                                beta=beta, theta=theta)


def input_layer_conv_lif(image: torch.Tensor, weights: torch.Tensor,
                         bias: torch.Tensor, *, num_steps: int,
                         beta: float = 0.15, theta: float = 0.5,
                         block_m: int = 256, block_n: int = 128
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Direct-coded input layer: [B,H,W,Cin] image x [KH,KW,Cin,Cout] weights
    -> (spikes [T,B,H,W,Cout], final u [B,H,W,Cout]).

    Computes the convolution once (direct coding repeats the image every
    timestep) and runs the T-step LIF recurrence fused in the kernel.
    """
    b, h, w, cin = image.shape
    kh, kw, _, cout = weights.shape
    block_m = min(block_m, _round_up(b * h * w))
    block_n = min(block_n, _round_up(cout))
    KERNEL_LAUNCHES["dense_conv_lif"] += 1
    LAUNCH_LOG.append({"block_m": block_m, "block_n": block_n})
    patches = im2col(image, kh, kw, "SAME")              # [M, K], K = kh*kw*cin
    w2d = weights.reshape(kh * kw * cin, cout)
    spikes, u = dense_conv_lif(patches, w2d, bias.to(torch.float32),
                               num_steps=num_steps, beta=beta, theta=theta)
    return spikes.reshape(num_steps, b, h, w, cout), u.reshape(b, h, w, cout)
