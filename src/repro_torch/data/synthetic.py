"""Synthetic image dataset (the repo trains offline on generated data).

Image task: class-conditional oriented Gabor-like textures at CIFAR geometry
(32x32x3) — learnable structure so the quantization-sparsity study trains to
non-trivial accuracy. The same recipe as the JAX package's `image_batch`,
but drawn from a `torch.Generator`, so the pixels differ from the
reference's for the same seed.

Everything is *stateless and step-keyed*: batch(step) is a pure function of
(seed, step), which makes restarts reproduce the exact data order. The
token task (`token_batch`) arrives with the LM slice.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def _generator(seed: int, step: int) -> torch.Generator:
    """A CPU generator keyed by (seed, step)."""
    key = np.random.SeedSequence([seed, step]).generate_state(1, dtype=np.uint64)[0]
    return torch.Generator().manual_seed(int(key))


def image_batch(seed: int, step: int, batch: int, *, num_classes: int = 10,
                hw: int = 32, dtype=torch.float32, device="cpu"):
    """Class-conditional Gabor textures + noise -> {images [B,hw,hw,3], labels [B]}.

    Drawn on the host (so one (seed, step) gives one batch on every device)
    and moved to ``device``; labels are int64.
    """
    g = _generator(seed, step)
    labels = torch.randint(0, num_classes, (batch,), generator=g)

    # per-class orientation/frequency/phase
    theta = labels.to(torch.float32) / num_classes * math.pi
    freq = 2.0 + (labels % 3).to(torch.float32) * 1.5
    yy, xx = torch.meshgrid(torch.linspace(-1, 1, hw), torch.linspace(-1, 1, hw),
                            indexing="ij")
    phase = torch.rand((batch, 1, 1), generator=g) * 2 * math.pi
    proj = (xx[None] * torch.cos(theta)[:, None, None]
            + yy[None] * torch.sin(theta)[:, None, None])
    pattern = torch.sin(proj * freq[:, None, None] * math.pi + phase) * 0.5 + 0.5
    # class-dependent colour mix
    colour = F.one_hot(labels % 3, 3).to(torch.float32) * 0.6 + 0.2
    imgs = pattern[..., None] * colour[:, None, None, :]
    imgs = imgs + torch.randn(imgs.shape, generator=g) * 0.08
    shift = torch.rand((batch, 1, 1, 1), generator=g) * 0.1
    return {"images": torch.clamp(imgs + shift, 0, 1).to(dtype=dtype, device=device),
            "labels": labels.to(device)}
