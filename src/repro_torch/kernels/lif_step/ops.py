"""Conv/FC-epilogue LIF update: bias add + decay + soft reset + threshold.

``lif_epilogue`` is one timestep in plain PyTorch (the JAX package's
`lif_epilogue`, without the interpret flag). ``lif_epilogue_scan`` runs all
T timesteps of a layer from u = s = 0 and returns the spikes: on a CUDA
tensor the hand kernel in ``csrc/lif_epilogue_scan.cu`` (one launch per
layer), on a CPU tensor ``lif_epilogue_scan_plain``, a Python loop over
``lif_epilogue``.

Rounding: ``beta*u + (I + b)`` is rounded once, not twice. The JAX
reference, as XLA compiles it for the CPU, contracts that sum into one
fused multiply-add; computing it in float64 (where beta*u is exact) and
rounding to float32 once reproduces it, on any device, without an FMA op.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .. import _build


def _f32(x: float) -> float:
    """A Python float rounded to float32, as JAX treats a weak-typed scalar."""
    return float(torch.tensor(x, dtype=torch.float32))


def lif_epilogue(u: torch.Tensor, current: torch.Tensor, prev_spike: torch.Tensor,
                 bias: torch.Tensor, *, beta: float = 0.15, theta: float = 0.5
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step: u' = beta*u + (I + b) - s_prev*theta; s = u' > theta.

    u, current, prev_spike: [..., N] float32; bias: [N].
    """
    assert bias.shape == (u.shape[-1],), (bias.shape, u.shape)
    decayed = (_f32(beta) * u.double() + (current + bias).double()).float()
    u_next = decayed - prev_spike * theta
    return u_next, (u_next > theta).to(u.dtype)


def lif_epilogue_scan_plain(cur: torch.Tensor, bias: torch.Tensor, *,
                            beta: float = 0.15, theta: float = 0.5) -> torch.Tensor:
    """cur [T, R, N], bias [N] -> spikes [T, R, N]: T calls of `lif_epilogue`."""
    u = torch.zeros_like(cur[0])
    s = torch.zeros_like(u)
    out = []
    for t in range(cur.shape[0]):
        u, s = lif_epilogue(u, cur[t], s, bias, beta=beta, theta=theta)
        out.append(s)
    return torch.stack(out)


def _lif_epilogue_scan_cuda(cur, bias, *, beta, theta):
    _build.check_cuda_operands("lif_epilogue_scan", cur=cur, bias=bias)
    steps, rows, n = cur.shape
    if bias.shape != (n,):
        raise ValueError(f"lif_epilogue_scan: bias {tuple(bias.shape)} != ({n},)")
    spikes = torch.empty_like(cur)
    vp = ctypes.c_void_p
    _build.launch(
        "lif_epilogue_scan",
        [vp, vp, vp, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
         ctypes.c_float, ctypes.c_float, vp],
        _build.ptr(cur), _build.ptr(bias), _build.ptr(spikes),
        rows, n, steps, beta, theta, _build.stream())
    return spikes


def lif_epilogue_scan(cur: torch.Tensor, bias: torch.Tensor, *,
                      beta: float = 0.15, theta: float = 0.5) -> torch.Tensor:
    """All T epilogue steps of one layer: cur [T, R, N], bias [N] -> spikes.

    The tensor's device picks the path: CPU -> the plain loop, CUDA -> the
    hand kernel (raises on operands it does not take).
    """
    if _build.is_cpu("lif_epilogue_scan", cur):
        return lif_epilogue_scan_plain(cur, bias, beta=beta, theta=theta)
    return _lif_epilogue_scan_cuda(cur.contiguous(), bias.contiguous(),
                                   beta=beta, theta=theta)
