"""Leaky integrate-and-fire neuron dynamics (paper Eq. 1-2) with surrogate gradients.

The paper's LIF (soft reset by threshold subtraction):

    u_j[t+1] = beta * u_j[t] + sum_i w_ij * s_i[t] - s_j[t] * theta      (Eq. 1)
    s_j[t]   = 1 if u_j[t] > theta else 0                                 (Eq. 2)

Training uses surrogate gradients (fast sigmoid, snnTorch default slope=25).

Rounding: ``beta*u + current`` is rounded once, as XLA compiles the JAX
package's `lif_step` inside ``jit`` or ``lax.scan`` (one fused
multiply-add): float64 then float32, which autograd passes through.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class LIFParams:
    """Neuronal hyperparameters. Paper defaults: beta=0.15, theta=0.5."""

    beta: float = 0.15
    theta: float = 0.5
    surrogate_slope: float = 25.0

    def astuple(self):
        return (self.beta, self.theta, self.surrogate_slope)


# ---------------------------------------------------------------------------
# Surrogate spike function
# ---------------------------------------------------------------------------

class _SpikeSurrogate(torch.autograd.Function):
    """Heaviside(u - theta) forward; fast-sigmoid surrogate backward."""

    @staticmethod
    def forward(ctx, u, theta, slope):
        ctx.save_for_backward(u)
        ctx.theta, ctx.slope = theta, slope
        return (u > theta).to(u.dtype)

    @staticmethod
    def backward(ctx, g):
        (u,) = ctx.saved_tensors
        x = u - ctx.theta
        surr = 1.0 / (1.0 + ctx.slope * torch.abs(x)) ** 2
        return g * surr.to(g.dtype), None, None


def spike_surrogate(u: torch.Tensor, theta: float, slope: float = 25.0) -> torch.Tensor:
    """Exact Eq. 2 threshold forward; backward d s/d u = 1/(1 + slope*|u - theta|)^2.

    ``theta`` is a float, so it gets no gradient.
    """
    return _SpikeSurrogate.apply(u, theta, slope)


# ---------------------------------------------------------------------------
# Single-step LIF update
# ---------------------------------------------------------------------------

def _f32(x: float) -> float:
    """A Python float rounded to float32, as JAX treats a weak-typed scalar."""
    return float(torch.tensor(x, dtype=torch.float32))


def lif_step(u: torch.Tensor, current: torch.Tensor, prev_spike: torch.Tensor,
             p: LIFParams) -> Tuple[torch.Tensor, torch.Tensor]:
    """One LIF timestep per paper Eq. 1-2.

    Args:
      u: membrane potential at t (any shape).
      current: weighted input current sum_i w_ij * s_i[t] (same shape).
      prev_spike: s_j[t] of the *previous* evaluation (soft reset term).
    Returns:
      (u_next, spike) where spike = 1[u_next > theta], differentiable through
      the surrogate.
    """
    decayed = (_f32(p.beta) * u.double() + current.double()).to(u.dtype)
    u_next = decayed - prev_spike * p.theta
    return u_next, spike_surrogate(u_next, p.theta, p.surrogate_slope)


def lif_scan(currents: torch.Tensor, p: LIFParams,
             u0: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run LIF over a [T, ...] current sequence -> (spikes [T, ...], final u)."""
    u = torch.zeros_like(currents[0]) if u0 is None else u0
    s = torch.zeros_like(u)
    spikes = []
    for t in range(currents.shape[0]):
        u, s = lif_step(u, currents[t], s, p)
        spikes.append(s)
    return torch.stack(spikes), u


# ---------------------------------------------------------------------------
# Generic leaky integrator (shared machinery with RG-LRU / SSM family)
# ---------------------------------------------------------------------------

def leaky_integrate(decay, inputs: torch.Tensor, h0: Optional[torch.Tensor] = None):
    """h[t+1] = decay * h[t] + inputs[t] -> (all h [T, ...], final h).

    `decay` broadcasts against the state (a float or a tensor): LIF Eq. 1
    without the threshold and reset. ``decay*h + x`` is rounded once, as
    the reference's ``lax.scan`` compiles it.
    """
    h = torch.zeros_like(inputs[0]) if h0 is None else h0
    d = decay.double() if isinstance(decay, torch.Tensor) else _f32(decay)
    hs = []
    for t in range(inputs.shape[0]):
        h = (d * h.double() + inputs[t].double()).to(h.dtype)
        hs.append(h)
    return torch.stack(hs), h
