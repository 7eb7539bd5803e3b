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
though the CUDA grid uses its own thread layout.
"""
from __future__ import annotations

import collections
import ctypes
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

# the CUDA kernel keeps w [K, N] and bias [N] in static-size shared memory
SMEM_LIMIT_BYTES = 48 * 1024


def reset_launch_counts() -> None:
    KERNEL_LAUNCHES.clear()
    LAUNCH_LOG.clear()


def launch_counts() -> Dict[str, int]:
    return dict(KERNEL_LAUNCHES)


def dense_conv_lif_plain(patches: torch.Tensor, w2d: torch.Tensor,
                         bias: torch.Tensor, *, num_steps: int, beta: float,
                         theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: [M, K] @ [K, N] + bias, then T LIF steps from
    u = s = 0 -> (spikes [T, M, N], final u [M, N]). ``beta*u + current``
    is rounded once, as in `lif_step.ops.lif_epilogue`."""
    current = patches @ w2d + bias
    u = torch.zeros_like(current)
    s = torch.zeros_like(current)
    out = []
    for _ in range(num_steps):
        u = (_f32(beta) * u.double() + current.double()).float() - s * theta
        s = (u > theta).to(current.dtype)
        out.append(s)
    return torch.stack(out), u


def _dense_conv_lif_cuda(patches, w2d, bias, *, num_steps, beta, theta):
    _build.check_cuda_operands("dense_conv_lif", patches=patches, w2d=w2d, bias=bias)
    m, k = patches.shape
    k2, n = w2d.shape
    if k != k2 or bias.shape != (n,):
        raise ValueError(f"dense_conv_lif: shapes {tuple(patches.shape)} "
                         f"{tuple(w2d.shape)} {tuple(bias.shape)} disagree")
    if (k * n + n) * 4 > SMEM_LIMIT_BYTES:
        raise ValueError(f"dense_conv_lif: weights {k}x{n} exceed "
                         f"{SMEM_LIMIT_BYTES} bytes of shared memory")
    spikes = torch.empty((num_steps, m, n), dtype=torch.float32, device=patches.device)
    u = torch.empty((m, n), dtype=torch.float32, device=patches.device)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    _build.launch(
        "dense_conv_lif",
        [vp] * 5 + [ci] * 4 + [ctypes.c_float, ctypes.c_float, vp],
        _build.ptr(patches), _build.ptr(w2d), _build.ptr(bias),
        _build.ptr(spikes), _build.ptr(u), m, k, n, num_steps, beta, theta,
        _build.stream())
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
