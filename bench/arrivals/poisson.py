"""Poisson arrivals, at one rate or at rates that change in phases.

A mix's ``arrivals`` entry names this law (``"law": "poisson"``) and gives
either ``rate_per_s`` (one rate throughout) or ``phases``, a list of
``[seconds, rate_per_s]`` pairs repeated from the window's start (on/off
bursts: ``[[1, 464], [1, 0]]``).

The due times are the same set for every seed and the seed only orders
them, so runs of different seeds offer the same load: unit-rate gaps at the
exponential distribution's mid-quantiles, as many as the window's expected
arrivals (rounded up), in the seed's order, mapped onto the phases' rates
by inverting the cumulative rate. The first request is due at the window's
start.
"""
import math

import numpy as np

from bench.harness.inputs import stream_seed

KEYS = frozenset({"rate_per_s", "phases"})


def _phases(spec: dict, seconds: float):
    if ("rate_per_s" in spec) == ("phases" in spec):
        raise ValueError("poisson arrivals take either rate_per_s or phases")
    phases = spec["phases"] if "phases" in spec else [[seconds, spec["rate_per_s"]]]
    phases = [(float(d), float(r)) for d, r in phases]
    if any(d <= 0 or r < 0 for d, r in phases) or not any(r > 0 for _, r in phases):
        raise ValueError(f"phases need positive lengths, rates >= 0, one > 0: {phases}")
    return phases


def expected(phases, seconds: float) -> float:
    """The cumulative rate over the first ``seconds``: the expected count."""
    period = sum(d for d, _ in phases)
    cycles, rest = divmod(seconds, period)
    total = cycles * sum(d * r for d, r in phases)
    for d, r in phases:
        total += min(d, max(0.0, rest)) * r
        rest -= d
    return total


def _invert(u: np.ndarray, phases) -> np.ndarray:
    """Times at which the cumulative rate reaches ``u`` (phases of rate 0
    are skipped over)."""
    period = sum(d for d, _ in phases)
    per_cycle = sum(d * r for d, r in phases)
    starts, lam0, rates = [], [], []
    t = lam = 0.0
    for d, r in phases:
        if r > 0:
            starts.append(t)
            lam0.append(lam)
            rates.append(r)
        t += d
        lam += d * r
    cycles, rest = np.divmod(u, per_cycle)
    i = np.searchsorted(np.asarray(lam0), rest, side="right") - 1
    return (cycles * period + np.asarray(starts)[i]
            + (rest - np.asarray(lam0)[i]) / np.asarray(rates)[i])


def offsets(seed: int, spec: dict, seconds: float) -> np.ndarray:
    """Due times, in s from the window's start, over ``seconds``."""
    phases = _phases(spec, seconds)
    n = max(1, math.ceil(expected(phases, seconds)))
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n)
    order = np.random.default_rng(stream_seed(seed, "arrivals")).permutation(n)
    return _invert(np.cumsum(gaps[order]) - gaps[order][0], phases)
