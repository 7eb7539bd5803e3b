"""QAT fake quantization with the straight-through estimator (paper §II-B).

The paper quantizes weights and biases to int4 with quantization-aware
training (error folded into the loss via straight-through estimation) and
keeps neuronal parameters (beta, theta, membrane) in float. `fake_quant` is
the quantize-dequantize of the forward and the STE of the backward, as one
`torch.autograd.Function`; `qat_params` applies it to a parameter dict.
`QTensor` and int4 packing arrive with the int4-matmul slice.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def _qrange(bits: int) -> Tuple[int, int]:
    qmax = 2 ** (bits - 1) - 1
    return -qmax, qmax  # symmetric, e.g. int4 -> [-7, 7]


def _scale(w: torch.Tensor, bits: int, axis) -> torch.Tensor:
    _, qmax = _qrange(bits)
    if axis is None:
        amax = w.abs().max()
    else:
        amax = torch.amax(w.abs(), dim=axis, keepdim=True)
    return torch.clamp(amax, min=1e-8) / qmax


def _to_grid(w, s, bits):
    qmin, qmax = _qrange(bits)
    return torch.clamp(torch.round(w / s), qmin, qmax) * s


class _FakeQuant(torch.autograd.Function):

    @staticmethod
    def forward(ctx, w, bits, axis):
        _, qmax = _qrange(bits)
        s = _scale(w, bits, axis)
        ctx.save_for_backward((w.abs() <= (qmax + 0.5) * s).to(w.dtype))
        return _to_grid(w, s, bits)

    @staticmethod
    def backward(ctx, g):
        (in_range,) = ctx.saved_tensors
        return g * in_range, None, None


def fake_quant(w: torch.Tensor, bits: int = 4, axis: Optional[int] = None) -> torch.Tensor:
    """Symmetric uniform quantize-dequantize, per tensor or per channel.

    Forward: w -> round(w / s).clip(qmin, qmax) * s with
    s = max(max|w|, 1e-8) / qmax, the max over the whole tensor, or over
    ``axis`` (an int or a tuple of ints, kept as size-1 dims).
    ``round(w / s)`` is kept literally: torch.round rounds half to even like
    jnp.round, and multiplying by a reciprocal instead would change which
    values tie.
    Backward: straight through where ``|w| <= (qmax + 0.5) * s`` (the
    values the grid can reach), zero elsewhere; the scale gets no gradient.
    Where no gradient is wanted (serving), only the forward runs.
    """
    if torch.is_grad_enabled() and w.requires_grad:
        return _FakeQuant.apply(w, bits, axis)
    return _to_grid(w, _scale(w, bits, axis), bits)


def qat_params(params, bits_w: int = 4, bits_b: int = 8):
    """Fake-quant every 'w*' leaf (bits_w) and 'b*' leaf (bits_b) of a
    nested dict; other leaves (neuronal parameters, norm scales) untouched."""
    out = {}
    for k, v in params.items():
        if isinstance(v, dict):
            out[k] = qat_params(v, bits_w, bits_b)
        elif k.startswith("w"):
            out[k] = fake_quant(v, bits_w)
        elif k.startswith("b"):
            out[k] = fake_quant(v, bits_b)
        else:
            out[k] = v
    return out
