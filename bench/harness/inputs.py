"""Everything a run feeds the program, made from ``--seed``.

Frozen copies, so that what the benchmark measures does not move when the
program's own helpers change:

* `master_weights`: the distributions of the port's ``init_vgg9`` (He-normal
  convolutions, 1/fan-in normal FCs, zero biases), fp32, drawn on the device
  from one generator in one call;
* `images`: the recipe of the port's ``data.synthetic.image_batch``
  (class-conditional oriented Gabor textures in a class colour, noise and a
  brightness shift, clipped to [0, 1]), drawn on the device;
* `sample`: which finished requests a run checks.

Seeds are any whole number (the driver's exceed 32 bits); each use takes a
stream of its own from ``numpy.random.SeedSequence``.
"""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

STREAMS = {"weights": 1, "images": 2, "arrivals": 3, "sample": 4, "batches": 5}


def stream_seed(seed: int, stream: str) -> int:
    """A 63-bit seed for one use of the run's seed."""
    state = np.random.SeedSequence([int(seed) % 2 ** 64, STREAMS[stream]])
    return int(state.generate_state(1, dtype=np.uint64)[0] >> np.uint64(1))


def generator(seed: int, stream: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream_seed(seed, stream))


def weight_shapes(cfg: dict) -> Dict[str, tuple]:
    shapes, cin = {}, cfg["in_ch"]
    convs = [s for s in cfg["stages"] if s != "MP"]
    for i, cout in enumerate(convs):
        shapes[f"conv{i}"] = (3, 3, cin, cout)
        cin = cout
    pools = sum(1 for s in cfg["stages"] if s == "MP")
    flat = (cfg["img_hw"] // 2 ** pools) ** 2 * convs[-1]
    shapes["fc0"] = (flat, cfg["fc_dim"])
    shapes["fc1"] = (cfg["fc_dim"], cfg["population"])
    return shapes


def master_weights(seed: int, cfg: dict, device) -> Dict[str, Dict[str, torch.Tensor]]:
    """fp32 weights {layer: {"w", "b"}}: one normal draw for every weight,
    each layer's slice scaled to its std (sqrt(2 / fan_in) for a conv,
    sqrt(1 / fan_in) for an FC), zero biases."""
    shapes = weight_shapes(cfg)
    sizes = [math.prod(s) for s in shapes.values()]
    draw = torch.randn(sum(sizes), generator=generator(seed, "weights", device),
                       device=device, dtype=torch.float32)
    params, at = {}, 0
    for (name, shape), n in zip(shapes.items(), sizes):
        fan_in = math.prod(shape[:-1])
        std = (2.0 / fan_in) ** 0.5 if name.startswith("conv") else (1.0 / fan_in) ** 0.5
        params[name] = {"w": (draw[at:at + n] * std).reshape(shape),
                        "b": torch.zeros(shape[-1], device=device, dtype=torch.float32)}
        at += n
    return params


def images(seed: int, count: int, cfg: dict, device, stream: str = "images"):
    """(images [count, hw, hw, 3] in [0, 1], labels [count] int64)."""
    g = generator(seed, stream, device)
    hw, classes = cfg["img_hw"], cfg["num_classes"]
    labels = torch.randint(0, classes, (count,), generator=g, device=device)
    theta = labels.to(torch.float32) / classes * math.pi
    freq = 2.0 + (labels % 3).to(torch.float32) * 1.5
    axis = torch.linspace(-1, 1, hw, device=device)
    yy, xx = torch.meshgrid(axis, axis, indexing="ij")
    phase = torch.rand((count, 1, 1), generator=g, device=device) * 2 * math.pi
    proj = xx[None] * torch.cos(theta)[:, None, None] + yy[None] * torch.sin(theta)[:, None, None]
    pattern = torch.sin(proj * freq[:, None, None] * math.pi + phase) * 0.5 + 0.5
    colour = torch.nn.functional.one_hot(labels % 3, 3).to(torch.float32) * 0.6 + 0.2
    imgs = pattern[..., None] * colour[:, None, None, :]
    imgs = imgs + torch.randn(imgs.shape, generator=g, device=device) * 0.08
    shift = torch.rand((count, 1, 1, 1), generator=g, device=device) * 0.1
    return torch.clamp(imgs + shift, 0, 1), labels


def sample(seed: int, population: int, count: int) -> List[int]:
    """``count`` indices of ``population`` (all of them where fewer), drawn
    from the seed, in ascending order."""
    if population <= count:
        return list(range(population))
    rng = np.random.default_rng(stream_seed(seed, "sample"))
    return sorted(int(i) for i in rng.choice(population, size=count, replace=False))
