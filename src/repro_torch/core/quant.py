"""QAT fake quantization with the straight-through estimator (paper §II-B).

The paper quantizes weights and biases to int4 with quantization-aware
training (error folded into the loss via straight-through estimation) and
keeps neuronal parameters (beta, theta, membrane) in float. `fake_quant` is
the quantize-dequantize of the forward and the STE of the backward, as one
`torch.autograd.Function`; `qat_params` applies it to a parameter dict.

Storage side (serving): `quantize_int4` / `dequantize` and `pack_int4` /
`unpack_int4` hold int4 values two to an int8 byte in a `QTensor`, the
operand of `kernels.int4_matmul`. The byte layout is the JAX package's,
bit for bit.
"""
from __future__ import annotations

import dataclasses
import math
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


# ---------------------------------------------------------------------------
# Storage-side quantization (serving / checkpoints)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class QTensor:
    """Packed quantized tensor: int4 values (2 per int8 byte) + fp32 scale.

    `shape` is the logical (unpacked) shape; packing is along the last axis,
    which must be even. Scales are per output channel (last axis of the
    logical weight), shaped to broadcast on dequantize.
    """

    packed: torch.Tensor   # int8 [..., N // 2]
    scale: torch.Tensor    # float32, e.g. [1, N] per channel
    shape: tuple           # logical shape
    bits: int = 4

    @property
    def nbytes_logical(self) -> int:
        return math.prod(self.shape) * self.bits // 8


def quantize_int4(w: torch.Tensor, axis: Optional[int] = -1) -> QTensor:
    """Quantize to int4 (one scale per index of ``axis``, reduced over every
    other dim; ``None`` for one scale) and pack along the last axis."""
    qmin, qmax = _qrange(4)
    if axis is None:
        s = _scale(w, 4, None)
    else:
        s = _scale(w, 4, tuple(i for i in range(w.ndim) if i != axis % w.ndim))
    q = torch.clamp(torch.round(w / s), qmin, qmax).to(torch.int8)
    return QTensor(pack_int4(q), s.to(torch.float32), tuple(w.shape), 4)


def dequantize(qt: QTensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    q = unpack_int4(qt.packed, qt.shape)
    return (q.to(dtype) * qt.scale.to(dtype)).reshape(qt.shape)


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """Pack int8 values in [-8, 7] two to a byte along the last axis (even):
    out[..., i] holds q[..., 2i] in the low nibble, q[..., 2i+1] in the high."""
    assert q.shape[-1] % 2 == 0, "packing axis must be even"
    q = q.to(torch.int32)
    byte = (q[..., 0::2] & 0xF) | ((q[..., 1::2] & 0xF) << 4)      # 0..255
    return torch.where(byte >= 128, byte - 256, byte).to(torch.int8)


def unpack_int4(packed: torch.Tensor, shape: tuple) -> torch.Tensor:
    """Inverse of `pack_int4`: int8 values in [-8, 7] with ``shape``."""
    p = packed.to(torch.int32)
    lo, hi = p & 0xF, (p >> 4) & 0xF
    lo = torch.where(lo >= 8, lo - 16, lo)          # sign-extend the nibbles
    hi = torch.where(hi >= 8, hi - 16, hi)
    out = torch.stack([lo, hi], dim=-1).reshape(*packed.shape[:-1], -1)
    return out.reshape(shape).to(torch.int8)
