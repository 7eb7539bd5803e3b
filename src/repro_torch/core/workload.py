"""Layer-wise workload model and resource partitioner (paper Eq. 3, §V-A).

    W_CONV = F * C_out * sum_i S_i        (F = filter coefficients, e.g. 9)
    W_FC   = N * S                        (N = output neurons, S = input spikes)

Each sparse-core neural core (NC) retires one membrane update per cycle, so a
layer with allocation `nc` takes ~`W / nc` cycles. The paper's design-time
search allocates NCs to minimize the latency spread across layers (balanced
pipeline). We reproduce that with a water-filling allocator and validate it
against the paper's published configurations.

The dense core processes the direct-coded input layer at one output membrane
per cycle per row, with `rows` the parameterized row count:
    cycles_dense = H_out * W_out * C_out * T / rows

Numpy only: a copy of the JAX package's workload model, kept so the port
stands alone.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class LayerWorkload:
    name: str
    kind: str          # 'conv' | 'fc' | 'dense_input'
    fan: int           # F*C_out for conv, N for fc, H*W*C_out*T for dense
    spikes: float      # sum_i S_i over all timesteps (1.0 for dense input)

    @property
    def work(self) -> float:
        """Total membrane updates (cycles at one NC)."""
        return float(self.fan) * float(max(self.spikes, 0.0)) if self.kind != "dense_input" else float(self.fan)


def conv_workload(name: str, c_out: int, filter_coeffs: int, spikes: float) -> LayerWorkload:
    return LayerWorkload(name, "conv", filter_coeffs * c_out, spikes)


def fc_workload(name: str, n_out: int, spikes: float) -> LayerWorkload:
    return LayerWorkload(name, "fc", n_out, spikes)


def dense_input_workload(name: str, h_out: int, w_out: int, c_out: int, timesteps: int) -> LayerWorkload:
    return LayerWorkload(name, "dense_input", h_out * w_out * c_out * timesteps, 1.0)


def layer_latencies(workloads: Sequence[LayerWorkload], alloc: Sequence[int], f_clk_hz: float = 100e6) -> np.ndarray:
    """Seconds per layer given an NC allocation."""
    w = np.array([l.work for l in workloads], dtype=np.float64)
    a = np.array(alloc, dtype=np.float64)
    return w / a / f_clk_hz


def balance_allocation(workloads: Sequence[LayerWorkload], budget: int) -> List[int]:
    """Water-filling NC allocation minimizing the max layer latency.

    Start with 1 NC per layer and greedily add an NC to the current
    bottleneck until the budget is spent — the discrete optimum for
    monotone 1/n latencies (exchange argument).
    """
    n = len(workloads)
    if budget < n:
        raise ValueError(f"budget {budget} < number of layers {n}")
    alloc = [1] * n
    work = [l.work for l in workloads]
    for _ in range(budget - n):
        lat = [w / a for w, a in zip(work, alloc)]
        # bottleneck layer; ties broken toward the least-provisioned layer
        # (plain argmax starves later layers when workloads are equal)
        peak = max(lat)
        cands = [i for i, l in enumerate(lat) if l >= peak * (1 - 1e-12)]
        alloc[min(cands, key=lambda i: alloc[i])] += 1
    return alloc


def latency_overheads(workloads: Sequence[LayerWorkload], alloc: Sequence[int]) -> np.ndarray:
    """Per-layer share of total execution time (paper reports these as %)."""
    lat = layer_latencies(workloads, alloc)
    return lat / lat.sum()


def scale_allocation(alloc: Sequence[int], factor: int) -> List[int]:
    """perf^k configurations scale the LW allocation by `factor` (paper §V-A)."""
    return [a * factor for a in alloc]
