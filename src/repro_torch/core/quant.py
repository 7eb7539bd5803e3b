"""QAT fake quantization, forward only (paper §II-B).

The paper quantizes weights and biases to int4 with quantization-aware
training and keeps neuronal parameters (beta, theta, membrane) in float.
Serving needs only the forward quantize-dequantize; the straight-through
backward, `QTensor` and int4 packing arrive with the training and
int4-matmul slices.
"""
from __future__ import annotations

from typing import Tuple

import torch


def _qrange(bits: int) -> Tuple[int, int]:
    qmax = 2 ** (bits - 1) - 1
    return -qmax, qmax  # symmetric, e.g. int4 -> [-7, 7]


def fake_quant(w: torch.Tensor, bits: int = 4) -> torch.Tensor:
    """Per-tensor symmetric quantize-dequantize.

    w -> round(w / s).clip(qmin, qmax) * s with s = max(max|w|, 1e-8) / qmax.
    ``round(w / s)`` is kept literally: torch.round rounds half to even like
    jnp.round, and multiplying by a reciprocal instead would change which
    values tie.
    """
    qmin, qmax = _qrange(bits)
    s = torch.clamp(w.abs().max(), min=1e-8) / qmax
    return torch.clamp(torch.round(w / s), qmin, qmax) * s
