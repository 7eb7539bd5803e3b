"""The LIF update as kernels: one step over any shape, and the conv/FC epilogue.

``lif_update`` is one LIF timestep over a tensor of any shape (the JAX
package's `lif_update`): on a CUDA tensor the hand kernel in
``csrc/lif_step.cu`` (one launch per call, over the flat length), on a CPU
tensor ``lif_update_plain``. The unfused pipeline calls it T times per layer.

``lif_epilogue`` is one epilogue timestep in plain PyTorch (the JAX
package's `lif_epilogue`, without the interpret flag). ``lif_epilogue_scan``
runs all T timesteps of a layer from u = s = 0 and returns the spikes: on a
CUDA tensor the hand kernel in ``csrc/lif_epilogue_scan.cu`` (one launch per
layer), on a CPU tensor ``lif_epilogue_scan_plain``, a Python loop over
``lif_epilogue``. Its launch geometry (float4 or scalar path, blocks)
comes from ``epilogue_geometry``.

Rounding: ``beta*u + I`` (``beta*u + (I + b)`` in the epilogue) is rounded
once, not twice. The JAX reference, as XLA compiles it for the CPU,
contracts that sum into one fused multiply-add; computing it in float64
(where beta*u is exact) and rounding to float32 once reproduces it, on any
device, without an FMA op.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from ...core.lif import _f32
from .. import _build

_VP, _INT, _FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
LIF_STEP_ARGTYPES = [_VP] * 5 + [ctypes.c_longlong, _FLOAT, _FLOAT, _VP]
EPILOGUE_ARGTYPES = [_VP] * 3 + [ctypes.c_longlong, _INT, _INT, _FLOAT, _FLOAT,
                                 _INT, _INT, _VP]

# `lif_epilogue_scan.cu`: 256 threads a block, one group (a float4, or a
# float where N % 4 != 0) a thread; T in EPILOGUE_UNROLLED_STEPS (every
# served configuration but rate coding's T = 25) is unrolled, every load
# before the recurrence; any other T loads one step ahead.
EPILOGUE_THREADS = 256
EPILOGUE_UNROLLED_STEPS = (2,)
# past this many blocks the threads loop over the rest (32-bit thread ids)
EPILOGUE_MAX_BLOCKS = 1 << 20


def lif_update_plain(u: torch.Tensor, current: torch.Tensor, prev_spike: torch.Tensor,
                     *, beta: float = 0.15, theta: float = 0.5
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step, any shape: u' = beta*u + I - s_prev*theta; s = u' > theta."""
    decayed = (_f32(beta) * u.double() + current.double()).float()
    u_next = decayed - prev_spike * theta
    return u_next, (u_next > theta).to(u.dtype)


def _lif_update_cuda(u, current, prev_spike, *, beta, theta):
    _build.check_cuda_operands("lif_step", u=u, current=current, prev_spike=prev_spike)
    if not u.shape == current.shape == prev_spike.shape:
        raise ValueError(f"lif_step: shapes {tuple(u.shape)} {tuple(current.shape)} "
                         f"{tuple(prev_spike.shape)} disagree")
    u_next = torch.empty_like(u)
    spikes = torch.empty_like(u)
    _build.launch(
        "lif_step", LIF_STEP_ARGTYPES,
        _build.ptr(u), _build.ptr(current), _build.ptr(prev_spike),
        _build.ptr(u_next), _build.ptr(spikes), u.numel(), beta, theta,
        _build.stream())
    return u_next, spikes


def lif_update(u: torch.Tensor, current: torch.Tensor, prev_spike: torch.Tensor, *,
               beta: float = 0.15, theta: float = 0.5
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One LIF step over tensors of one shape -> (u_next, spikes).

    The tensor's device picks the path: CPU -> the plain version, CUDA ->
    the hand kernel (raises on operands it does not take). The JAX
    package's [R, 512] padding is a TPU layout; both paths work on the flat
    length.
    """
    if _build.is_cpu("lif_step", u):
        return lif_update_plain(u, current, prev_spike, beta=beta, theta=theta)
    return _lif_update_cuda(u.contiguous(), current.contiguous(), prev_spike.contiguous(),
                            beta=beta, theta=theta)


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


@functools.lru_cache(maxsize=None)
def epilogue_geometry(rows: int, n: int, steps: int) -> Tuple[bool, int]:
    """(vector, blocks) of `lif_epilogue_scan.cu` for cur [steps, rows, n]:
    the float4 path where n % 4 == 0, else single floats; one block per
    ``EPILOGUE_THREADS`` groups, at most ``EPILOGUE_MAX_BLOCKS``. Raises on
    a problem the kernel does not take.
    """
    if rows < 1 or n < 1 or steps < 1:
        raise ValueError(f"lif_epilogue_scan: unsupported shape T={steps} R={rows} N={n}")
    vector = n % 4 == 0
    groups = rows * (n // 4 if vector else n)
    return vector, min(-(-groups // EPILOGUE_THREADS), EPILOGUE_MAX_BLOCKS)


def _lif_epilogue_scan_cuda(cur, bias, *, beta, theta):
    _build.check_cuda_operands("lif_epilogue_scan", cur=cur, bias=bias)
    steps, rows, n = cur.shape
    if bias.shape != (n,):
        raise ValueError(f"lif_epilogue_scan: bias {tuple(bias.shape)} != ({n},)")
    vector, blocks = epilogue_geometry(rows, n, steps)
    spikes = torch.empty_like(cur)
    _build.launch(
        "lif_epilogue_scan", EPILOGUE_ARGTYPES,
        _build.ptr(cur), _build.ptr(bias), _build.ptr(spikes),
        rows, n, steps, beta, theta, vector, blocks, _build.stream())
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
