"""Plain PyTorch reference of the direct-coded spiking VGG9 (Aliyev et al., DATE 2025, §V-A).

The benchmark holds the port against this module. It imports torch alone,
nothing of the program, and takes only what the benchmark made: the
configuration's sizes (a dict, as `bench/configs/<name>.json` holds them),
the fp32 master weights and the images. It re-derives whatever the program
derives from them: the int4 / int8 fake-quantized weights, the spikes, the
loss, the clipped gradients and AdamW's state.

Network: the stages of ``cfg["stages"]`` (3x3 SAME convolutions and 2x2
max-pools), then two fully connected layers, with a LIF neuron after every
convolution and FC (paper Eq. 1-2, soft reset by threshold subtraction):

    u[t+1] = beta * u[t] + (I[t] + b) - s[t] * theta,   s[t+1] = u[t+1] > theta

Direct coding: the input convolution is computed once and fed to its LIF
for all T timesteps. Output: population decoding, the class score being the
spike count of the class's neuron group over T, divided by T * group.

Layouts: images NHWC; conv weights HWIO and FC weights [in, out], as the
benchmark makes them; activations NCHW inside, flattened in H, W, C order
before the first FC (the order the weights' rows are in).

Precision: ``precision="fp32"`` computes in float32 with TF32 off; ``"tf32"``
is the benchmark's control, float32 with TF32 products: on a card the
backends' TF32 switches are turned on, on the CPU (which has no TF32) every
product's operands are rounded to TF32's 10-bit mantissa first.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional, Sequence

import torch
import torch.nn.functional as F

Params = Dict[str, Dict[str, torch.Tensor]]


# -- quantization (paper §II-B): symmetric, per tensor ------------------------

def quantize(w: torch.Tensor, bits: int) -> torch.Tensor:
    """round(w / s) clipped to [-q, q], times s; s = max(max|w|, 1e-8) / q,
    q = 2^(bits-1) - 1."""
    q = 2 ** (bits - 1) - 1
    s = torch.clamp(w.abs().max(), min=1e-8) / q
    return torch.clamp(torch.round(w / s), -q, q) * s


class _StraightThrough(torch.autograd.Function):
    """`quantize` forward; the gradient passes where the grid reaches w."""

    @staticmethod
    def forward(ctx, w, bits):
        q = 2 ** (bits - 1) - 1
        s = torch.clamp(w.abs().max(), min=1e-8) / q
        ctx.save_for_backward(w.abs() <= (q + 0.5) * s)
        return quantize(w, bits)

    @staticmethod
    def backward(ctx, g):
        (reach,) = ctx.saved_tensors
        return g * reach.to(g.dtype), None


def served_weights(params: Params, cfg: dict, *, train: bool = False) -> Params:
    """The weights as the configuration runs them: fp32 as they are, or
    int-``quant_bits`` weights and int8 biases (QAT's straight-through
    estimator where ``train``)."""
    bits = cfg.get("quant_bits", 0)
    if not bits:
        return params
    q = _StraightThrough.apply if train else quantize
    return {name: {"w": q(leaf["w"], bits), "b": q(leaf["b"], 8)}
            for name, leaf in params.items()}


# -- precision -----------------------------------------------------------------

def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits, nearest, ties away from zero as
    the tensor cores' conversion does)."""
    bits = x.detach().contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return x + (rounded - x).detach()       # gradients pass as through the product


@contextlib.contextmanager
def precision_scope(precision: str):
    """Run the body with TF32 products off ("fp32") or on ("tf32")."""
    if precision not in ("fp32", "tf32"):
        raise ValueError(f"unknown precision {precision!r}")
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    on = precision == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _operands(x, w, precision):
    if precision == "tf32" and x.device.type == "cpu":
        return _tf32(x), _tf32(w)
    return x, w


def _conv(x: torch.Tensor, w_hwio: torch.Tensor, precision: str) -> torch.Tensor:
    x, w = _operands(x, w_hwio.permute(3, 2, 0, 1), precision)
    return F.conv2d(x, w, padding=1)


def _fc(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    x, w = _operands(x, w, precision)
    return x @ w


def _flatten_hwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


# -- inference -----------------------------------------------------------------

def _lif_scan(cur: Callable[[int], torch.Tensor], bias: torch.Tensor, steps: int,
              beta: float, theta: float) -> torch.Tensor:
    """Spikes [T, ...] of a LIF neuron fed ``cur(t) + bias`` from u = s = 0."""
    u = s = None
    out = []
    for t in range(steps):
        i = cur(t) + bias
        u = i if u is None else beta * u + i - s * theta
        s = (u > theta).to(torch.float32)
        out.append(s)
    return torch.stack(out)


@torch.no_grad()
def infer(params: Params, images: torch.Tensor, cfg: dict, *, precision: str = "fp32",
          on_layer: Optional[Callable[[str, torch.Tensor, int], None]] = None) -> dict:
    """images [B, H, W, C] -> {"logits" [B, classes], "out_spikes" and
    "in_spikes": {layer: [B]} spike counts over all T}.

    ``on_layer(name, spikes, c_out)`` sees every spiking layer's input
    spikes ([T*B, C, H, W] for a convolution, [T*B, D] for an FC) before the
    layer consumes them.
    """
    if cfg.get("coding", "direct") != "direct":
        raise ValueError("the reference serves direct coding only")
    qp = served_weights(params, cfg)
    t, beta, theta = cfg["timesteps"], cfg["beta"], cfg["theta"]
    b = images.shape[0]
    out, inp = {}, {}
    with precision_scope(precision):
        x = images.to(torch.float32).permute(0, 3, 1, 2)
        cur0 = _conv(x, qp["conv0"]["w"], precision)
        bias = qp["conv0"]["b"][:, None, None]
        s = _lif_scan(lambda _: cur0, bias, t, beta, theta)         # [T, B, C, H, W]
        out["conv0"] = s.sum(dim=(0, 2, 3, 4))
        x = s.reshape((t * b,) + s.shape[2:])
        idx = 0
        for stage in cfg["stages"][1:]:
            if stage == "MP":
                x = F.max_pool2d(x, 2)
                continue
            idx += 1
            name = f"conv{idx}"
            if on_layer is not None:
                on_layer(name, x, stage)
            inp[name] = x.reshape(t, b, -1).sum(dim=(0, 2))
            cur = _conv(x, qp[name]["w"], precision).reshape((t, b) + (stage,) + x.shape[2:])
            s = _lif_scan(lambda k: cur[k], qp[name]["b"][:, None, None], t, beta, theta)
            out[name] = s.sum(dim=(0, 2, 3, 4))
            x = s.reshape((t * b,) + s.shape[2:])
        flat = _flatten_hwc(x)
        for name in ("fc0", "fc1"):
            w = qp[name]["w"]
            if on_layer is not None:
                on_layer(name, flat, w.shape[1])
            inp[name] = flat.reshape(t, b, -1).sum(dim=(0, 2))
            cur = _fc(flat, w, precision).reshape(t, b, -1)
            s = _lif_scan(lambda k: cur[k], qp[name]["b"], t, beta, theta)
            out[name] = s.sum(dim=(0, 2))
            flat = s.reshape(t * b, -1)
    group = cfg["population"] // cfg["num_classes"]
    logits = s.sum(0).reshape(b, cfg["num_classes"], group).sum(-1) / (t * group)
    return {"logits": logits, "out_spikes": out, "in_spikes": inp}


def infer_blocks(params: Params, images: torch.Tensor, cfg: dict, *, block: int = 256,
                 precision: str = "fp32", on_layer=None) -> dict:
    """`infer` over ``images`` in blocks of ``block`` rows, so that it fits
    beside whatever else the card holds."""
    parts = [infer(params, images[i:i + block], cfg, precision=precision, on_layer=on_layer)
             for i in range(0, images.shape[0], block)]
    return {"logits": torch.cat([p["logits"] for p in parts]),
            "out_spikes": {k: torch.cat([p["out_spikes"][k] for p in parts])
                           for k in parts[0]["out_spikes"]},
            "in_spikes": {k: torch.cat([p["in_spikes"][k] for p in parts])
                          for k in parts[0]["in_spikes"]}}


# -- training ------------------------------------------------------------------

class _Spike(torch.autograd.Function):
    """Heaviside(u - theta) forward; fast sigmoid 1 / (1 + k|u - theta|)^2 back."""

    @staticmethod
    def forward(ctx, u, theta, slope):
        ctx.save_for_backward(u)
        ctx.theta, ctx.slope = theta, slope
        return (u > theta).to(u.dtype)

    @staticmethod
    def backward(ctx, g):
        (u,) = ctx.saved_tensors
        return g / (1.0 + ctx.slope * (u - ctx.theta).abs()) ** 2, None, None


def loss(params: Params, images: torch.Tensor, labels: torch.Tensor, cfg: dict,
         precision: str = "fp32") -> torch.Tensor:
    """Cross-entropy of the population rates times 10, through T timesteps
    of surrogate-gradient LIF layers (BPTT), with QAT's fake quantization."""
    qp = served_weights(params, cfg, train=True)
    t, beta, theta = cfg["timesteps"], cfg["beta"], cfg["theta"]
    slope = cfg.get("surrogate_slope", 25.0)
    b = images.shape[0]
    state: Dict[str, tuple] = {}

    def fire(name, current):
        if name in state:
            u, s = state[name]
            u = beta * u + current - s * theta
        else:
            u = current
        s = _Spike.apply(u, theta, slope)
        state[name] = (u, s)
        return s

    with precision_scope(precision):
        x = images.to(torch.float32).permute(0, 3, 1, 2)
        cur0 = _conv(x, qp["conv0"]["w"], precision) + qp["conv0"]["b"][:, None, None]
        pop = 0
        for _ in range(t):
            s = fire("conv0", cur0)
            idx = 0
            for stage in cfg["stages"][1:]:
                if stage == "MP":
                    s = F.max_pool2d(s, 2)
                    continue
                idx += 1
                name = f"conv{idx}"
                s = fire(name, _conv(s, qp[name]["w"], precision) + qp[name]["b"][:, None, None])
            s = _flatten_hwc(s)
            s = fire("fc0", _fc(s, qp["fc0"]["w"], precision) + qp["fc0"]["b"])
            pop = pop + fire("fc1", _fc(s, qp["fc1"]["w"], precision) + qp["fc1"]["b"])
    group = cfg["population"] // cfg["num_classes"]
    logits = 10.0 * pop.reshape(b, cfg["num_classes"], group).sum(-1) / (t * group)
    return F.cross_entropy(logits, labels.long())


def adamw_steps(params: Params, batches: Sequence[tuple], cfg: dict, opt: dict, *,
                precision: str = "fp32", half_batch: bool = False) -> dict:
    """len(batches) AdamW steps from ``params`` -> {"losses": [float],
    "grads": [{leaf: clipped gradient}] per step, "params": the last
    parameters}.

    ``opt``: lr, b1, b2, eps, weight_decay, clip_norm (gradients scaled to
    a global norm of at most clip_norm before the moments take them).
    ``half_batch`` is a fault for the benchmark's tests: each loss is the
    mean over the first half of the batch only.
    """
    p = {n: {k: v.detach().clone() for k, v in leaf.items()} for n, leaf in params.items()}
    m = {n: {k: torch.zeros_like(v) for k, v in leaf.items()} for n, leaf in p.items()}
    v2 = {n: {k: torch.zeros_like(v) for k, v in leaf.items()} for n, leaf in p.items()}
    b1, b2, eps, wd, lr = opt["b1"], opt["b2"], opt["eps"], opt["weight_decay"], opt["lr"]
    losses, grads_seen = [], []
    for step, (images, labels) in enumerate(batches, start=1):
        if half_batch:
            images, labels = images[:images.shape[0] // 2], labels[:labels.shape[0] // 2]
        leaves = {n: {k: v.requires_grad_(True) for k, v in leaf.items()} for n, leaf in p.items()}
        value = loss(leaves, images, labels, cfg, precision)
        flat = [(n, k) for n in leaves for k in leaves[n]]
        gs = torch.autograd.grad(value, [leaves[n][k] for n, k in flat])
        norm = torch.sqrt(sum((g * g).sum() for g in gs))
        scale = torch.clamp(opt["clip_norm"] / torch.clamp(norm, min=1e-9), max=1.0)
        grads = {}
        with torch.no_grad():
            for (n, k), g in zip(flat, gs):
                g = g * scale
                grads.setdefault(n, {})[k] = g
                m[n][k] = b1 * m[n][k] + (1 - b1) * g
                v2[n][k] = b2 * v2[n][k] + (1 - b2) * g * g
                mh = m[n][k] / (1 - b1 ** step)
                vh = v2[n][k] / (1 - b2 ** step)
                p[n][k] = p[n][k].detach() - lr * (mh / (torch.sqrt(vh) + eps) + wd * p[n][k].detach())
        losses.append(float(value.detach()))
        grads_seen.append(grads)
    return {"losses": losses, "grads": grads_seen,
            "params": {n: {k: v.detach() for k, v in leaf.items()} for n, leaf in p.items()}}
