"""Spiking VGG9 (paper §V-A) on the hybrid dense/sparse pipeline.

Network: 64C3-112C3-MP2-192C3-216C3-MP2-480C3-504C3-560C3-MP2-FC(1064)-FC(P)
with LIF neurons after every conv/FC layer and population-coded output (P
neurons, class score = spike count over the class's neuron group).

This slice ports the serving path, `vgg9_infer_hybrid`: the dense core
(`kernels.dense_conv_lif`) for the direct-coded input layer, then one
occupancy-mapped gated matmul per spiking conv (`kernels.spike_conv`) with
the T timesteps folded into its rows, each followed by the all-T LIF
epilogue (`kernels.lif_step`), a 2x2 OR-pool, two FC layers and population
decoding. Layouts follow the JAX package: activations NHWC, conv weights
HWIO, FC weights [in, out]. Params are a plain dict ``{name: {"w", "b"}}``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from ..core.lif import LIFParams
from ..core.quant import fake_quant
from ..device import resolve_device


@dataclasses.dataclass(frozen=True)
class VGG9Config:
    num_classes: int = 10
    population: int = 1000          # P output neurons (paper: 1000 / 5000)
    timesteps: int = 2
    beta: float = 0.15
    theta: float = 0.5
    coding: str = "direct"          # direct | rate
    quant_bits: int = 0             # 0 = fp32, 4 = int4 QAT (biases int8)
    img_hw: int = 32
    in_ch: int = 3
    stages: Tuple = (64, 112, "MP", 192, 216, "MP", 480, 504, 560, "MP")
    fc_dim: int = 1064
    hoist_input_conv: bool = True   # reuse the timestep-invariant input conv
    surrogate_slope: float = 25.0

    @property
    def conv_channels(self):
        return [c for c in self.stages if c != "MP"]

    @property
    def lif(self) -> LIFParams:
        return LIFParams(self.beta, self.theta, self.surrogate_slope)


def conv_names(cfg: VGG9Config):
    return [f"conv{i}" for i in range(len(cfg.conv_channels))]


def init_vgg9(generator: torch.Generator, cfg: VGG9Config, device="cuda",
              dtype=torch.float32) -> Dict[str, Dict[str, torch.Tensor]]:
    """Random weights with the JAX package's distributions (He-normal convs,
    1/fan-in normal FCs, zero biases), drawn from ``generator``.

    ``generator`` is a CPU `torch.Generator`: weights are drawn on the host
    and moved to ``device``, so one seed gives the same weights on every
    device.
    """
    dev = resolve_device(device)

    def normal(shape, std):
        w = torch.randn(shape, generator=generator, dtype=torch.float32) * std
        return w.to(dtype=dtype, device=dev)

    params = {}
    cin = cfg.in_ch
    for i, cout in enumerate(cfg.conv_channels):
        fan_in = 3 * 3 * cin
        params[f"conv{i}"] = {
            "w": normal((3, 3, cin, cout), (2.0 / fan_in) ** 0.5),
            "b": torch.zeros((cout,), dtype=dtype, device=dev),
        }
        cin = cout
    n_mp = sum(1 for s in cfg.stages if s == "MP")
    hw = cfg.img_hw // (2 ** n_mp)
    flat = hw * hw * cfg.conv_channels[-1]
    params["fc0"] = {"w": normal((flat, cfg.fc_dim), (1.0 / flat) ** 0.5),
                     "b": torch.zeros((cfg.fc_dim,), dtype=dtype, device=dev)}
    params["fc1"] = {"w": normal((cfg.fc_dim, cfg.population), (1.0 / cfg.fc_dim) ** 0.5),
                     "b": torch.zeros((cfg.population,), dtype=dtype, device=dev)}
    return params


def params_from_numpy(tree, device="cuda") -> Dict[str, Dict[str, torch.Tensor]]:
    """The JAX package's params (``{name: {"w", "b"}}``, any array type that
    numpy reads) as the port's tensors: same keys, layouts and dtypes."""
    dev = resolve_device(device)
    return {name: {k: torch.from_numpy(np.array(v)).to(dev) for k, v in leaf.items()}
            for name, leaf in tree.items()}


def quantized_view(params: Dict, cfg: VGG9Config) -> Dict:
    """QAT fake-quant view of the weights (paper §II-B): int-`quant_bits`
    weights, int8 biases, per-tensor scales; neuronal parameters untouched."""
    if cfg.quant_bits == 0:
        return params
    return {name: {k: fake_quant(v, cfg.quant_bits if k == "w" else 8)
                   for k, v in leaf.items()}
            for name, leaf in params.items()}


def _maxpool_spikes(s: torch.Tensor) -> torch.Tensor:
    """2x2 max-pool over NHWC binary spikes == OR gate over the window
    (paper §IV-B); an odd trailing row/column is dropped (VALID)."""
    n, h, w, c = s.shape
    s = s[:, :h // 2 * 2, :w // 2 * 2, :]
    return s.reshape(n, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))


def _stage_plan(cfg: VGG9Config):
    """[('MP', None) | ('conv', idx>0), ...] — the post-input-layer walk."""
    plan = []
    ci = 0
    for s in cfg.stages:
        if s == "MP":
            plan.append(("MP", None))
        else:
            if ci > 0:
                plan.append(("conv", ci))
            ci += 1
    return plan


def vgg9_infer_hybrid(params: Dict, images, cfg: VGG9Config, *, device="cuda",
                      plan=None, return_stats: bool = False):
    """Hybrid inference through the three kernels -> (logits, counts[, stats]).

    images: [B, H, W, C] (tensor or array), moved to ``device``; params
    must already live there. Direct coding only. Timesteps are folded into
    the rows of every spiking layer's matmul in the order
    ``(t*B + b)*H*W + pixel``, so each layer issues one gated-matmul launch
    and one all-T epilogue launch.

    counts: per-layer total spikes (0-d float32 tensors). With
    ``return_stats`` also the per-layer stats: the tile-skip measurements of
    each occupancy-mapped conv (see `spike_conv2d_mapped`) plus per-image
    input/output spike counts ([B] vectors) for every layer — what the
    serving runner splits back out per request.
    """
    from ..core.hybrid import plan_vgg9_inference
    from ..kernels.dense_conv_lif.ops import input_layer_conv_lif
    from ..kernels.lif_step.ops import lif_epilogue_scan
    from ..kernels.spike_conv.ops import spike_conv2d_mapped

    if cfg.coding != "direct":
        raise ValueError(f"vgg9_infer_hybrid serves direct coding only, not {cfg.coding!r}")
    dev = resolve_device(device)
    images = torch.as_tensor(images, dtype=torch.float32, device=dev)
    b = images.shape[0]
    t = cfg.timesteps
    if plan is None:
        plan = plan_vgg9_inference(cfg, b)
    qp = quantized_view(params, cfg)

    def lif(cur_t, bias):
        return lif_epilogue_scan(cur_t, bias, beta=cfg.beta, theta=cfg.theta)

    # Dense core: input layer, conv once + T fused LIF steps (one launch).
    ks0 = plan.layer("conv0").kernel
    spikes, _ = input_layer_conv_lif(
        images, qp["conv0"]["w"], qp["conv0"]["b"],
        num_steps=t, beta=cfg.beta, theta=cfg.theta,
        block_m=ks0.block_m, block_n=ks0.block_n)
    counts = {"conv0": spikes.sum()}
    stats: Dict[str, Dict[str, torch.Tensor]] = {}
    if return_stats:
        stats["conv0"] = {"out_spikes_per_image": spikes.sum(dim=(0, 2, 3, 4))}

    # Sparse cores: timesteps folded into the batch — one occupancy-mapped
    # gated matmul per layer, then the T-step LIF epilogue.
    x = spikes.reshape((t * b,) + spikes.shape[2:])      # [T*B, H, W, C]
    for kind, idx in _stage_plan(cfg):
        if kind == "MP":
            x = _maxpool_spikes(x)
            continue
        name = f"conv{idx}"
        ks = plan.layer(name).kernel
        cur, st = spike_conv2d_mapped(
            x, qp[name]["w"], block_m=ks.block_m, block_k=ks.block_k,
            block_n=ks.block_n, gate=ks.gate)            # [T*B, H, W, Cout]
        _, h, w, cout = cur.shape
        s_seq = lif(cur.reshape(t, b * h * w, cout), qp[name]["b"])
        counts[name] = s_seq.sum()
        if return_stats:
            stats[name] = dict(
                st,
                in_spikes_per_image=x.reshape(t, b, -1).sum(dim=(0, 2)),  # Eq. 3 S
                out_spikes_per_image=s_seq.reshape(t, b, -1).sum(dim=(0, 2)),
            )
        x = s_seq.reshape(t * b, h, w, cout)

    # FC layers: same folding; the product is a plain matmul, the bias rides
    # in the epilogue.
    flat = x.reshape(t * b, -1)
    for name in ("fc0", "fc1"):
        w2d = qp[name]["w"]
        in_per_image = flat.reshape(t, b, -1).sum(dim=(0, 2))
        cur = flat @ w2d
        s_seq = lif(cur.reshape(t, b, w2d.shape[-1]), qp[name]["b"])
        counts[name] = s_seq.sum()
        if return_stats:
            stats[name] = {"in_spikes_per_image": in_per_image,
                           "out_spikes_per_image": s_seq.sum(dim=(0, 2))}
        flat = s_seq.reshape(t * b, -1)

    group = cfg.population // cfg.num_classes
    pop = s_seq.sum(0)                                   # [B, P] spike counts over T
    logits = pop.reshape(b, cfg.num_classes, group).sum(-1) / (t * group)
    if return_stats:
        return logits, counts, stats
    return logits, counts
