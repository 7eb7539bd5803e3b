"""Plain oracle for the W4A16 int4 matmul."""
from __future__ import annotations

import torch

from ...core.quant import QTensor, dequantize


def int4_matmul_ref(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """Dequantize to fp32, then matmul: the numerical ground truth."""
    return x.float() @ dequantize(qt, torch.float32)
