"""Spiking VGG9 (paper §V-A) on the hybrid dense/sparse pipeline, and its training path.

Network: 64C3-112C3-MP2-192C3-216C3-MP2-480C3-504C3-560C3-MP2-FC(1064)-FC(P)
with LIF neurons after every conv/FC layer and population-coded output (P
neurons, class score = spike count over the class's neuron group).

Execution paths:
  * training / eval, `vgg9_forward` / `vgg9_loss`: plain PyTorch
    (``F.conv2d``), differentiable through the surrogate spike and the QAT
    straight-through estimator (BPTT over a Python loop of T timesteps).
    Direct coding hoists the input conv out of the timestep loop.
  * fused hybrid inference, `vgg9_infer_hybrid`: the dense core
    (`kernels.dense_conv_lif`) for the direct-coded input layer, then one
    occupancy-mapped gated matmul per spiking conv (`kernels.spike_conv`)
    with the T timesteps folded into its rows, each followed by the all-T
    LIF epilogue (`kernels.lif_step`), a 2x2 OR-pool, two FC layers and
    population decoding.
  * unfused hybrid inference, `vgg9_infer_hybrid_unfused`: the pre-fusion
    baseline, T in-kernel-gated `spike_conv2d` + `lif_update` launches per
    spiking layer.

Layouts follow the JAX package: activations NHWC, conv weights HWIO, FC
weights [in, out]. Params are a plain dict ``{name: {"w", "b"}}``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.coding import direct_code, rate_code
from ..core.lif import LIFParams, lif_step
from ..core.quant import fake_quant
from ..device import resolve_device
from ..obs.trace import device_mark


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


def train_state_from_numpy(tree, device="cuda"):
    """A JAX train state (nested dicts of arrays: params, AdamW's ``m``,
    ``v`` and ``t``, ``step``) as the port's: same keys, shapes and dtypes."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: train_state_from_numpy(v, dev) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree)).to(dev)


def quantized_view(params: Dict, cfg: VGG9Config) -> Dict:
    """QAT fake-quant view of the weights (paper §II-B): int-`quant_bits`
    weights, int8 biases, per-tensor scales; neuronal parameters untouched.
    Differentiable: the straight-through gradient reaches the fp32 masters."""
    if cfg.quant_bits == 0:
        return params
    return {name: {k: fake_quant(v, cfg.quant_bits if k == "w" else 8)
                   for k, v in leaf.items()}
            for name, leaf in params.items()}


def _conv(x: torch.Tensor, p: Dict) -> torch.Tensor:
    """SAME conv, NHWC x HWIO -> NHWC, then the bias in its own rounding
    (as the JAX package adds it after ``lax.conv``)."""
    y = F.conv2d(x.permute(0, 3, 1, 2), p["w"].permute(3, 2, 0, 1), padding="same")
    return y.permute(0, 2, 3, 1) + p["b"]


def _maxpool_spikes(s: torch.Tensor) -> torch.Tensor:
    """2x2 max-pool over NHWC binary spikes == OR gate over the window
    (paper §IV-B); an odd trailing row/column is dropped (VALID). Its
    gradient goes to the first maximum of each window in row-major order,
    the element XLA's max-pool gradient picks."""
    y = F.max_pool2d(s.permute(0, 3, 1, 2), kernel_size=2, stride=2)
    return y.permute(0, 2, 3, 1)


def vgg9_forward(params: Dict, images, cfg: VGG9Config, *,
                 generator: torch.Generator = None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """images [B,H,W,C] -> (logits [B,num_classes], spike counts per layer).

    The training path: BPTT through a Python loop over T timesteps carrying
    membrane potentials and previous spikes for every LIF layer. Runs on
    the params' device (images are moved there). The LIF sum
    ``beta*u + current`` is rounded once, as XLA compiles the reference's
    scan body. Rate coding draws its spikes from ``generator`` (on the
    params' device). Counts are detached 0-d float32 tensors.
    """
    qp = quantized_view(params, cfg)
    lif = cfg.lif
    dev = qp["conv0"]["w"].device
    images = torch.as_tensor(images, dtype=torch.float32, device=dev)
    b, t_steps = images.shape[0], cfg.timesteps

    if cfg.coding == "direct":
        if cfg.hoist_input_conv:
            currents_in = [_conv(images, qp["conv0"])] * t_steps   # computed once
        else:
            coded = direct_code(images, t_steps)
            currents_in = [_conv(coded[t], qp["conv0"]) for t in range(t_steps)]
    elif cfg.coding == "rate":      # binary input spikes, conv0 acts as a sparse layer
        if generator is None:
            raise ValueError("rate coding needs a generator")
        coded = rate_code(generator, images, t_steps)
        currents_in = [_conv(coded[t], qp["conv0"]) for t in range(t_steps)]
    else:
        raise ValueError(f"unknown coding {cfg.coding!r}")

    state: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}
    counts: Dict[str, torch.Tensor] = {}

    def fire(name, current):
        u, s_prev = state.get(name) or (torch.zeros_like(current), torch.zeros_like(current))
        u_next, s = lif_step(u, current, s_prev, lif)
        state[name] = (u_next, s)
        counts[name] = counts.get(name, 0) + s.detach().sum()
        return s

    pop = 0
    for t in range(t_steps):
        s = fire("conv0", currents_in[t])
        for kind, idx in _stage_plan(cfg):
            if kind == "MP":
                s = _maxpool_spikes(s)
            else:
                s = fire(f"conv{idx}", _conv(s, qp[f"conv{idx}"]))
        s = s.reshape(b, -1)
        s = fire("fc0", s @ qp["fc0"]["w"] + qp["fc0"]["b"])
        pop = pop + fire("fc1", s @ qp["fc1"]["w"] + qp["fc1"]["b"])   # [B, P] over T

    # population decoding: class score = total spikes in the class's group
    group = cfg.population // cfg.num_classes
    logits = pop.reshape(b, cfg.num_classes, group).sum(-1) / (t_steps * group)
    return logits, counts


def vgg9_loss(params: Dict, batch: Dict, cfg: VGG9Config, *,
              generator: torch.Generator = None) -> torch.Tensor:
    """Cross-entropy of the sharpened population rates (the reference's loss)."""
    logits, _ = vgg9_forward(params, batch["images"], cfg, generator=generator)
    labels = torch.as_tensor(batch["labels"], device=logits.device).long()
    logits = logits * 10.0  # population rates are in [0,1]; sharpen for CE
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[:, None])[:, 0]
    return torch.mean(logz - gold)


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

    Under an open `obs` step record, on a card, the layers are marked on
    the device (`obs.trace.device_mark`): ``vgg9.conv0`` (the dense core),
    ``vgg9.conv1`` ... (each sparse core, its 2x2 pool included),
    ``vgg9.fc0``, ``vgg9.fc1``.
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
    device_mark("vgg9.input", images, starts=True)
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
    done = "conv0"                                       # marked once its pool ran
    for kind, idx in _stage_plan(cfg):
        if kind == "MP":
            x = _maxpool_spikes(x)
            continue
        device_mark(f"vgg9.{done}", x)
        name = done = f"conv{idx}"
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
    device_mark(f"vgg9.{done}", x)
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
        device_mark(f"vgg9.{name}", flat)

    group = cfg.population // cfg.num_classes
    pop = s_seq.sum(0)                                   # [B, P] spike counts over T
    logits = pop.reshape(b, cfg.num_classes, group).sum(-1) / (t * group)
    if return_stats:
        return logits, counts, stats
    return logits, counts


def vgg9_infer_hybrid_sharded(params: Dict, images, cfg: VGG9Config, *, mesh,
                              axis: str = "data", plan=None, return_stats: bool = False):
    """`vgg9_infer_hybrid` split over an in-process data mesh
    (`launch.mesh.DataMesh`) -> (logits, counts[, stats]).

    Every layer is row-independent over the batch, so the batch shards
    contiguously: shard ``d`` serves images ``[d*B/n, (d+1)*B/n)`` on
    ``mesh.devices[d]`` (the parameters copied there once, by
    ``mesh.replicate``) with a plan sized to ``B/n`` slots. The shards run
    one after the other from this thread; results are gathered on the first
    shard's device. Logits equal the unsharded call's bit for bit: a row's
    sums do not depend on how many rows share the launch.

    The stat layout is the reference's, so per-shard counters stay
    attributable (`serve.runners.snn` is the consumer):

    * ``counts``  — per-layer ``[n]`` vectors (sum for the global count);
    * ``*_per_image`` stats — global ``[B]`` vectors (shard-concatenated);
    * every other stat leaf (``occ_map``, ``row_occ``, ``skip_rate``,
      ``block_m``, ``rows``, tile counts) — stacked with a leading ``[n]``
      shard axis; ``row_occ[d]`` rows are in shard ``d``'s folded order.

    Args:
        mesh: an in-process mesh whose ``axis`` divides the batch.
        plan: optional `HybridPlan` sized to the *local* batch ``B/n``.
    """
    from ..core.hybrid import plan_vgg9_inference

    ndev = int(mesh.shape[axis])
    b = images.shape[0]
    if b % ndev:
        raise ValueError(f"batch {b} must divide the '{axis}' axis ({ndev})")
    b_local = b // ndev
    if plan is None:
        plan = plan_vgg9_inference(cfg, b_local)
    images = torch.as_tensor(images, dtype=torch.float32)
    outs = []
    for d, dev in enumerate(mesh.devices):
        outs.append(vgg9_infer_hybrid(
            mesh.replicate(params, dev), images[d * b_local:(d + 1) * b_local].to(dev), cfg,
            device=dev, plan=plan, return_stats=True))
    home = mesh.devices[0]
    logits = torch.cat([o[0].to(home) for o in outs])
    counts = {k: torch.stack([o[1][k].to(home) for o in outs]) for k in outs[0][1]}
    if not return_stats:
        return logits, counts
    stats = {name: {k: (torch.cat if k.endswith("_per_image") else torch.stack)(
        [o[2][name][k].to(home) for o in outs]) for k in st}
        for name, st in outs[0][2].items()}
    return logits, counts, stats


def vgg9_infer_hybrid_unfused(params: Dict, images, cfg: VGG9Config, *,
                              device="cuda") -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The pre-fusion pipeline -> (logits, counts): per spiking layer, T
    in-kernel-gated `spike_conv2d` launches, each followed by one
    `lif_update` launch; the FC layers' LIF per timestep through
    `lif_update` too.
    The baseline the fused `vgg9_infer_hybrid` is measured against, and
    bit-identical to it (same per-row sums, same LIF rounding).

    images: [B, H, W, C] (tensor or array), moved to ``device``; params
    must already live there. Direct coding only.
    """
    from ..kernels.dense_conv_lif.ops import input_layer_conv_lif
    from ..kernels.lif_step.ops import lif_update
    from ..kernels.spike_conv.ops import spike_conv2d

    if cfg.coding != "direct":
        raise ValueError(f"vgg9_infer_hybrid_unfused serves direct coding only, "
                         f"not {cfg.coding!r}")
    dev = resolve_device(device)
    images = torch.as_tensor(images, dtype=torch.float32, device=dev)
    qp = quantized_view(params, cfg)
    b, t_steps = images.shape[0], cfg.timesteps

    def lif_over_time(current_at):
        """For t < T: current_at(t), then one `lif_update` launch -> [T, ...] spikes."""
        outs = []
        for t in range(t_steps):
            cur = current_at(t)
            if t == 0:
                u = s_prev = torch.zeros_like(cur)
            u, s_prev = lif_update(u, cur, s_prev, beta=cfg.beta, theta=cfg.theta)
            outs.append(s_prev)
        return torch.stack(outs)

    # Dense core: input layer, conv once + T fused LIF steps
    spikes, _ = input_layer_conv_lif(
        images, qp["conv0"]["w"], qp["conv0"]["b"],
        num_steps=t_steps, beta=cfg.beta, theta=cfg.theta)
    counts = {"conv0": spikes.sum()}

    layer_in = spikes                                       # [T, B, H, W, C]
    for kind, idx in _stage_plan(cfg):
        if kind == "MP":
            pooled = _maxpool_spikes(layer_in.reshape((t_steps * b,) + layer_in.shape[2:]))
            layer_in = pooled.reshape((t_steps, b) + pooled.shape[1:])
            continue
        p = qp[f"conv{idx}"]
        layer_in = lif_over_time(lambda t: spike_conv2d(layer_in[t], p["w"]) + p["b"])
        counts[f"conv{idx}"] = layer_in.sum()

    # FC layers: one product over all T*B rows, the same call the fused
    # pipeline makes (so both get the same row sums whatever cuBLAS picks
    # for M), then the LIF per timestep
    flat = layer_in.reshape(t_steps, b, -1)
    for name in ("fc0", "fc1"):
        p = qp[name]
        cur = (flat.reshape(t_steps * b, -1) @ p["w"]).reshape(t_steps, b, -1)
        flat = lif_over_time(lambda t: cur[t] + p["b"])
        counts[name] = flat.sum()

    group = cfg.population // cfg.num_classes
    pop = flat.sum(0)
    logits = pop.reshape(b, cfg.num_classes, group).sum(-1) / (t_steps * group)
    return logits, counts
