"""Energy/latency models: the paper's FPGA cost model and an analytical
energy-per-op model.

FPGA side (reproduction): per-image energy = sum over layers of
P_dyn(layer) * t(layer) (+ optional static energy), with layer latencies from
the Eq. 3 workload model. Coefficients are calibrated to the paper's
Table I (CIFAR100 perf^2 instance-level dynamic power, 100 MHz clock) so that
Table II / Fig. 4 ratios reproduce.

Numpy only: a copy of the JAX package's FPGA and analytical models. The
JAX package's accelerator roofline constants are not carried over: they
describe other hardware, and the port states no such figures.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np

from .workload import LayerWorkload, layer_latencies

# ---------------------------------------------------------------------------
# FPGA energy model (paper reproduction)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FPGAPowerModel:
    """Per-layer dynamic power = p_per_nc * NC + p_mem * weight_bytes.

    Coefficients calibrated per precision from the paper's Table I
    (CIFAR100 perf^2): int4 total dynamic 1.231 W over 288 NCs; fp32 total
    3.471 W over the same allocation. Static power: 3.13 W (int4) /
    3.22 W (fp32) for the full device.
    """

    p_per_nc: float           # W per neural core (dynamic)
    p_mem_per_byte: float     # W per byte of on-chip weight storage
    p_static: float           # W (whole device)
    f_clk_hz: float = 100e6

    def layer_power(self, nc: int, weight_bytes: float) -> float:
        return self.p_per_nc * nc + self.p_mem_per_byte * weight_bytes


# Calibration: Table I int4 totals 1.231 W dynamic across allocation
# (1,28,12,54,16,72,70,19,4) = 276 cores and ~1.6 MB int4 weights;
# fp32 totals 3.471 W across the same cores and ~12.9 MB fp32 weights.
# Splitting dynamic power ~60/40 between compute and memory reproduces the
# per-layer ordering in Table I within ~20%.
INT4_POWER = FPGAPowerModel(p_per_nc=1.231 * 0.6 / 276, p_mem_per_byte=1.231 * 0.4 / 1.6e6, p_static=3.13)
FP32_POWER = FPGAPowerModel(p_per_nc=3.471 * 0.6 / 276, p_mem_per_byte=3.471 * 0.4 / 12.9e6, p_static=3.22)


def power_model(precision: str) -> FPGAPowerModel:
    return {"int4": INT4_POWER, "fp32": FP32_POWER}[precision]


# ---------------------------------------------------------------------------
# Analytical energy-per-op model
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AnalyticalEnergyModel:
    """Bottom-up per-operation energy accounting, following the framing of
    "Reconsidering the energy efficiency of SNNs" (arXiv:2409.08290): instead
    of FPGA-calibrated power x latency (Eq. 3 / `FPGAPowerModel`), count the
    operations an image actually triggers and price each one —

    * compute: every membrane update is one accumulate (spiking layers have
      no multiplies; the dense-coded input layer pays full MACs);
    * memory: every update reads one weight (``wbytes`` bytes at the active
      precision) and reads+writes the membrane state word from on-chip SRAM.

    The two models deliberately disagree: Eq. 3 bills weight *storage*
    (per-layer memory power burns for the whole layer latency, spikes or
    not), this model bills weight *traffic* (silent layers cost nothing).
    A near-silent input therefore looks relatively cheaper here, and the
    int4/fp32 ratio differs measurably between the models — which is why
    the serving-time precision controller (`serve.precision`) prices every
    choice with both. Per-op constants are Horowitz-style 45 nm figures
    (ISSCC'14): fp32 add 0.9 pJ / mult 3.7 pJ; integer-datapath accumulate
    ~0.1 pJ; SRAM ~1.25 pJ per byte touched.
    """

    e_acc_j: float            # J per accumulate (one membrane update)
    e_mac_j: float            # J per multiply-accumulate (dense input layer)
    e_sram_j_per_byte: float  # J per byte of on-chip SRAM traffic
    wbytes: float             # bytes fetched per weight at this precision
    state_bytes: float = 8.0  # membrane word read + write per update


ANALYTICAL_FP32 = AnalyticalEnergyModel(
    e_acc_j=0.9e-12, e_mac_j=4.6e-12, e_sram_j_per_byte=1.25e-12, wbytes=4.0)
ANALYTICAL_INT4 = AnalyticalEnergyModel(
    e_acc_j=0.1e-12, e_mac_j=0.6e-12, e_sram_j_per_byte=1.25e-12, wbytes=0.5)


def analytical_model(precision: str) -> AnalyticalEnergyModel:
    return {"int4": ANALYTICAL_INT4, "fp32": ANALYTICAL_FP32}[precision]


def analytical_energy_per_image(
    workloads: Sequence[LayerWorkload],
    precision: str = "int4",
    model: Optional[AnalyticalEnergyModel] = None,
) -> Dict[str, float]:
    """Per-image energy by op counting (no latency term, no static power).

    ``LayerWorkload.work`` is already the membrane-update count (fan x input
    spikes; the dense input layer's fan alone), so compute energy is
    ``work * e_op`` and memory energy is ``work * (wbytes + state_bytes) *
    e_sram`` — weight traffic scales with spikes, which is exactly the
    sparsity-energy coupling the Eq. 3 storage-power model underweights.
    """
    m = model if model is not None else analytical_model(precision)
    e_comp = e_mem = 0.0
    for l in workloads:
        ops = l.work
        e_comp += ops * (m.e_mac_j if l.kind == "dense_input" else m.e_acc_j)
        e_mem += ops * (m.wbytes + m.state_bytes) * m.e_sram_j_per_byte
    return {
        "energy_j": e_comp + e_mem,
        "energy_compute_j": e_comp,
        "energy_memory_j": e_mem,
    }


def energy_per_image(
    workloads: Sequence[LayerWorkload],
    alloc: Sequence[int],
    weight_bytes: Sequence[float],
    precision: str = "int4",
    include_static: bool = False,
) -> Dict[str, float]:
    """Per-image energy/latency following the paper's §V-C methodology.

    Layers execute sequentially through BRAM-staged spike trains, so image
    latency = sum of layer latencies; energy sums per-layer dynamic power x
    per-layer time (the paper's "summing the energy per layer").
    """
    pm = power_model(precision)
    lat = layer_latencies(workloads, alloc, pm.f_clk_hz)
    p = np.array([pm.layer_power(a, wb) for a, wb in zip(alloc, weight_bytes)])
    e_dyn = float(np.sum(p * lat))
    t = float(np.sum(lat))
    e = e_dyn + (pm.p_static * t if include_static else 0.0)
    return {
        "latency_s": t,
        "energy_j": e,
        "energy_dynamic_j": e_dyn,
        "avg_power_w": e / t if t > 0 else 0.0,
        # layers are pipelined through BRAM-staged spike trains (paper §IV):
        # steady-state throughput is set by the slowest layer, latency by the
        # sum; at steady state every layer instance draws power concurrently
        "throughput_fps": 1.0 / float(np.max(lat)) if t > 0 else float("inf"),
        "power_pipelined_w": float(np.sum(p)),
        "energy_pipelined_j": float(np.sum(p) * np.max(lat)),
    }
