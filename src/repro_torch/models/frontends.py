"""Stub modality frontends: the backbone only, the frontend a stub.

The JAX package's models/frontends.py in PyTorch. The audio (EnCodec) and
vision (CLIP) encoders are external to the backbones; callers pass
precomputed frame/patch embeddings ``[B, n_frontend_tokens, d_frontend]``
as ``batch["frontend_embeds"]``, and the backbone projects them with
``embed.w_front``. These helpers give their shape and synthesize them from
a seeded generator (nothing is downloaded).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..configs.base import ArchConfig
from ..device import resolve_device


def frontend_shape(cfg: ArchConfig, batch: int) -> Optional[Tuple[int, int, int]]:
    """Shape of the precomputed frontend embeddings, or None without a
    frontend (the reference returns a `ShapeDtypeStruct` of it)."""
    if not cfg.frontend:
        return None
    return (batch, cfg.n_frontend_tokens, cfg.d_frontend)


def synth_frontend(gen: torch.Generator, cfg: ArchConfig, batch: int, device="cuda",
                   dtype=torch.float32) -> Optional[torch.Tensor]:
    """Random embeddings of `frontend_shape` (normal x 0.02), drawn from
    ``gen`` (a generator on ``device``)."""
    if not cfg.frontend:
        return None
    return torch.randn(frontend_shape(cfg, batch), generator=gen,
                       device=resolve_device(device), dtype=dtype) * 0.02
