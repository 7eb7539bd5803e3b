"""Input coding schemes for SNNs: direct coding and rate coding (paper §I, §V-D).

Direct coding: the raw floating-point input is presented identically at every
timestep; the first convolution layer turns it into membrane currents, and
because the input is timestep-invariant that convolution can be hoisted out
of the timestep loop.

Rate coding: each pixel intensity p in [0,1] becomes an independent Bernoulli
spike train with rate p (one draw per timestep), drawn from a
`torch.Generator`: the draws differ from `jax.random`'s for the same seed.
"""
from __future__ import annotations

import torch


def direct_code(x: torch.Tensor, num_steps: int) -> torch.Tensor:
    """Repeat input over T timesteps: [B, ...] -> [T, B, ...] (a view)."""
    return x.unsqueeze(0).expand((num_steps,) + tuple(x.shape))


def rate_code(generator: torch.Generator, x: torch.Tensor, num_steps: int) -> torch.Tensor:
    """Bernoulli spike trains with per-pixel rate x (clipped to [0,1]).

    ``generator`` lives on ``x``'s device. Returns binary [T, B, ...] in x.dtype.
    """
    p = torch.clamp(x, 0.0, 1.0)
    u = torch.rand((num_steps,) + tuple(x.shape), generator=generator,
                   dtype=torch.float32, device=x.device)
    return (u < p.unsqueeze(0).to(torch.float32)).to(x.dtype)


def spike_count(spikes: torch.Tensor) -> torch.Tensor:
    """Total number of spikes in a (binary) spike train."""
    return torch.count_nonzero(spikes)


def sparsity(spikes: torch.Tensor) -> torch.Tensor:
    """Fraction of zero entries (the event-driven skip opportunity)."""
    return 1.0 - (spikes != 0).to(torch.float32).mean()
