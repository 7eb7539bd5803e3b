"""Synthetic datasets (the repo trains offline on generated data).

Image task: class-conditional oriented Gabor-like textures at CIFAR geometry
(32x32x3) — learnable structure so the quantization-sparsity study trains to
non-trivial accuracy. Token task: noisy affine walks over the vocab, so the
next token is predictable. The same recipes as the JAX package's
`image_batch` and `token_batch`, but drawn from a `torch.Generator`, so the
numbers differ from the reference's for the same seed.

Everything is *stateless and step-keyed*: batch(step) is a pure function of
(seed, step), drawn on the host, which makes restarts reproduce the exact
data order.
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


def token_batch(seed: int, step: int, batch: int, seq_len: int, vocab: int, device="cpu"):
    """Markov-ish token streams -> {tokens [B, S], labels [B, S]}, labels the
    next tokens (teacher forcing).

    Each row walks ``(start + stride * t) % vocab`` with start in [0, vocab)
    and stride in [1, 7); 5 % of positions are replaced by uniform tokens.
    int64 (torch's index dtype, which the embedding gather and the loss's
    ``take_along_dim`` take; the reference's are int32). Drawn on the host
    and moved to ``device``.
    """
    g = _generator(seed, step)
    start = torch.randint(0, vocab, (batch, 1), generator=g)
    stride = torch.randint(1, 7, (batch, 1), generator=g)
    pos = torch.arange(seq_len + 1)[None]
    stream = (start + stride * pos) % vocab
    flip = torch.rand(stream.shape, generator=g) < 0.05
    rand = torch.randint(0, vocab, stream.shape, generator=g)
    stream = torch.where(flip, rand, stream)
    return {"tokens": stream[:, :-1].contiguous().to(device),
            "labels": stream[:, 1:].contiguous().to(device)}
