"""Hybrid dense/sparse execution planning (paper §IV).

The planner is the software analogue of the paper's architecture overview:
the direct-coded input layer (dense, non-binary activations) goes to the
dense path; every later layer (binary spike activations) goes to the sparse,
event-driven path. Core counts per layer come from the Eq. 3 workload model;
`perf^k` configurations scale the lightweight allocation by k.

The "paths" select kernels: dense path -> kernels/dense_conv_lif (input
conv fused with LIF); sparse path -> kernels/spike_conv (occupancy-gated
binary-spike matmul). Each `LayerPlan`
additionally carries a `KernelSpec` — the block shapes the kernels should run
with, chosen from the layer's matmul geometry — so the serving pipeline
(`models.vgg9.vgg9_infer_hybrid`) takes its launch configuration from the
plan instead of hard-coding it. The plan also carries the FPGA-model core
allocation so the energy benchmarks can evaluate the same network under the
paper's cost model.

Plans are frozen, tuple-backed dataclasses: hashable, so runners cache one
per batch width. The plan's tile geometry (sparse M tile 128, K tile 128, N
tile 128, dense M tile 256) is the *accounting* geometry of every occupancy
and skip stat; a CUDA kernel may launch at other tile shapes, but the stats
it reports stay at this geometry. Numpy only: a copy of the JAX package's
planner, kept so the port stands alone.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

from .tiling import round_up as _round_up
from .workload import (
    LayerWorkload,
    balance_allocation,
    conv_workload,
    dense_input_workload,
    fc_workload,
    latency_overheads,
    scale_allocation,
)

# Tile ceilings; per-layer specs clamp to the padded problem size.
MAX_BLOCK_M = 256
MAX_BLOCK_K = 128
MAX_BLOCK_N = 128


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """Launch configuration for one layer's kernel.

    kernel: 'dense_conv_lif' | 'spike_conv_mapped' | 'fc_lif'
    m, k, n: padded matmul geometry (M = T*B*H*W rows for the fused path).
    block_*: tile shapes for the gated matmul / conv kernels.
    gate: whether occupancy gating is on (dense layers never gate).
    """
    kernel: str
    m: int
    k: int
    n: int
    block_m: int
    block_k: int
    block_n: int
    gate: bool = True


def select_blocks(m: int, k: int, n: int, *, sparse: bool = False) -> Tuple[int, int, int]:
    """Tile-shape selection from matmul geometry.

    Dense layers take the largest M tile (amortize weight loads). Sparse
    layers take the minimum M tile (128): the occupancy gate skips work
    at tile granularity, so smaller spike tiles expose strictly more
    skippable zeros — the software knob the co-design papers say must match
    the hardware's skip granularity.
    """
    max_m = 128 if sparse else MAX_BLOCK_M
    return (
        min(max_m, _round_up(m)),
        min(MAX_BLOCK_K, _round_up(k)),
        min(MAX_BLOCK_N, _round_up(n)),
    )


@dataclasses.dataclass(frozen=True)
class LayerPlan:
    name: str
    path: str          # 'dense' | 'sparse'
    cores: int         # NC allocation (FPGA model)
    kernel: Optional[KernelSpec] = None


@dataclasses.dataclass(frozen=True)
class HybridPlan:
    layers: Tuple[LayerPlan, ...]
    overheads: Tuple[float, ...]   # per-layer latency share, paper-style
    budget: int

    def cores(self) -> Tuple[int, ...]:
        return tuple(l.cores for l in self.layers)

    def layer(self, name: str) -> LayerPlan:
        for l in self.layers:
            if l.name == name:
                return l
        raise KeyError(name)


def plan_hybrid(
    layer_specs: Sequence[dict],
    spike_counts: Dict[str, float],
    budget: int,
    perf_scale: int = 1,
) -> HybridPlan:
    """Build the hybrid plan for a network.

    layer_specs: list of dicts with keys
        name, kind ('conv'|'fc'|'dense_input'), c_out / n_out,
        filter_coeffs (conv), h_out/w_out/timesteps (dense_input),
        and optionally 'kernel' (a KernelSpec to attach).
    spike_counts: measured sum of input spikes per layer (Eq. 3 S terms),
        from a profiling pass (`core.sparsity.SpikeStats`).
    budget: total NC budget for the lightweight configuration.
    perf_scale: 1 for LW, 2 for perf^2, 4 for perf^4.
    """
    workloads: list[LayerWorkload] = []
    for spec in layer_specs:
        kind = spec["kind"]
        name = spec["name"]
        if kind == "dense_input":
            workloads.append(
                dense_input_workload(name, spec["h_out"], spec["w_out"], spec["c_out"], spec["timesteps"])
            )
        elif kind == "conv":
            workloads.append(conv_workload(name, spec["c_out"], spec["filter_coeffs"], spike_counts[name]))
        elif kind == "fc":
            workloads.append(fc_workload(name, spec["n_out"], spike_counts[name]))
        else:
            raise ValueError(f"unknown layer kind {kind}")

    alloc = scale_allocation(balance_allocation(workloads, budget), perf_scale)
    overheads = tuple(latency_overheads(workloads, alloc).tolist())
    layers = tuple(
        LayerPlan(w.name, "dense" if w.kind == "dense_input" else "sparse", a,
                  spec.get("kernel"))
        for w, a, spec in zip(workloads, alloc, layer_specs)
    )
    return HybridPlan(layers, overheads, budget * perf_scale)


def plan_vgg9_inference(cfg, batch: int, *, est_density: float = 0.1,
                        budget: int | None = None, perf_scale: int = 1) -> HybridPlan:
    """Plan the fused VGG9 serving pipeline for a batch size.

    Walks the stage list of a `models.vgg9.VGG9Config`, derives each layer's
    fused matmul geometry (timesteps folded into the batch: M = T*B*H*W), and
    selects kernels + block shapes. Spike counts aren't known before running,
    so the Eq. 3 core allocation uses `est_density` spikes per input element —
    the allocation only feeds the FPGA cost model, not the kernels.

    Args:
        cfg: a `models.vgg9.VGG9Config` (stage list, timesteps, image size,
            quantization) — must match the params the plan will serve.
        batch: slot/batch width the fused graph will run at. Plans are
            per-batch-size: block shapes clamp to the padded M = T*B*H*W
            geometry (`SNNRunner.plan` caches them per width).
        est_density: assumed spikes per input element for the pre-run Eq. 3
            workload estimate (only prices the FPGA-model NC allocation;
            serving recomputes energy from *measured* spikes).
        budget: total NC budget for the lightweight configuration
            (default: 3 per layer).
        perf_scale: 1 for the paper's LW configuration, 2/4 for perf^2 /
            perf^4 scaled allocations.

    Returns:
        A frozen, hashable `HybridPlan`: one `LayerPlan` per layer (conv0 on
        the dense path with ``gate=False``; later convs on the sparse path
        with M tiled at 128 for finest skip granularity; fc layers folded to
        M = T*B), each carrying its `KernelSpec` launch configuration and
        FPGA-model core count, plus the paper-style per-layer latency
        overhead shares.
    """
    t = cfg.timesteps
    convs = cfg.conv_channels
    specs: list[dict] = []
    spike_counts: Dict[str, float] = {}

    hw = cfg.img_hw
    m0, k0, n0 = batch * hw * hw, 9 * cfg.in_ch, convs[0]
    specs.append({
        "name": "conv0", "kind": "dense_input", "h_out": hw, "w_out": hw,
        "c_out": convs[0], "timesteps": t,
        "kernel": KernelSpec("dense_conv_lif", m0, k0, n0,
                             *select_blocks(m0, k0, n0), gate=False),
    })

    # stage walk keeps conv indices aligned with models.vgg9
    cin = convs[0]
    idx = 0
    for s in cfg.stages:
        if s == "MP":
            hw //= 2
            continue
        if idx > 0:
            m, k, n = t * batch * hw * hw, 9 * cin, s
            name = f"conv{idx}"
            specs.append({
                "name": name, "kind": "conv", "c_out": s, "filter_coeffs": 9,
                "kernel": KernelSpec("spike_conv_mapped", m, k, n,
                                     *select_blocks(m, k, n, sparse=True)),
            })
            spike_counts[name] = est_density * t * batch * hw * hw * cin
        cin = s
        idx += 1

    flat = hw * hw * convs[-1]
    for name, d_in, d_out in (("fc0", flat, cfg.fc_dim),
                              ("fc1", cfg.fc_dim, cfg.population)):
        m, k, n = t * batch, d_in, d_out
        specs.append({
            "name": name, "kind": "fc", "n_out": d_out,
            "kernel": KernelSpec("fc_lif", m, k, n, *select_blocks(m, k, n)),
        })
        spike_counts[name] = est_density * t * batch * d_in

    if budget is None:
        budget = 3 * len(specs)
    return plan_hybrid(specs, spike_counts, budget, perf_scale)
