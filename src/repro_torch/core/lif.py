"""Leaky integrate-and-fire neuron dynamics (paper Eq. 1-2), forward only.

The paper's LIF (soft reset by threshold subtraction):

    u_j[t+1] = beta * u_j[t] + sum_i w_ij * s_i[t] - s_j[t] * theta      (Eq. 1)
    s_j[t]   = 1 if u_j[t] > theta else 0                                 (Eq. 2)

The surrogate-gradient backward arrives with the training path.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class LIFParams:
    """Neuronal hyperparameters. Paper defaults: beta=0.15, theta=0.5."""

    beta: float = 0.15
    theta: float = 0.5
    surrogate_slope: float = 25.0


def lif_step(u: torch.Tensor, current: torch.Tensor, prev_spike: torch.Tensor,
             p: LIFParams) -> Tuple[torch.Tensor, torch.Tensor]:
    """One LIF timestep per paper Eq. 1-2.

    Args:
      u: membrane potential at t (any shape).
      current: weighted input current sum_i w_ij * s_i[t] (same shape).
      prev_spike: s_j[t] of the *previous* evaluation (soft reset term).
    Returns:
      (u_next, spike) where spike = 1[u_next > theta].
    """
    u_next = p.beta * u + current - prev_spike * p.theta
    return u_next, (u_next > p.theta).to(u.dtype)
