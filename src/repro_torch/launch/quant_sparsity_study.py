"""The paper's §III ablation as a runnable study: sweep weight precision and
measure the spike-count response (quantization-sparsity interplay) plus the
projected FPGA energy via the Eq. 3 workload model.

    PYTHONPATH=src python -m repro_torch.launch.quant_sparsity_study
    PYTHONPATH=src python -m repro_torch.launch.quant_sparsity_study --device cpu --steps 60

The port of the JAX package's ``examples/quant_sparsity_study.py``: for
weight bits 0 (fp32), 8, 4 and 3 it trains the tiny spiking VGG9 (4
classes, batch 32, AdamW at a constant 2e-3, QAT through `fake_quant` at
that width) for ``--steps`` steps from the same ``--seed`` weights, then
prints accuracy, spikes per image and the Eq. 3 energy per image (balanced
allocation of 12 cores) on a held-out batch of 64. Runs on the card unless
``--device cpu`` is given. The data come from `data.synthetic.image_batch`
(a torch generator), so the numbers are the recipe's, not the JAX
example's digits.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Callable, Dict, List, Optional

import torch

from ..configs import vgg9_snn
from ..core.energy import energy_per_image
from ..core.workload import balance_allocation, conv_workload
from ..data.synthetic import image_batch
from ..device import resolve_device
from ..models.vgg9 import init_vgg9, vgg9_forward, vgg9_loss
from ..train.optim import adamw
from ..train.schedule import constant
from ..train.train_step import init_train_state, make_train_step

BASE = dataclasses.replace(vgg9_snn.TINY, num_classes=4)
BITS = (0, 8, 4, 3)
BATCH, TEST_BATCH = 32, 64


def train(cfg, params, batches: Callable[[int], Dict], steps: int):
    """``steps`` AdamW steps (constant 2e-3) of `vgg9_loss` from ``params``
    on ``batches(i)``; returns the trained params."""
    opt = adamw(weight_decay=0.0)
    step = make_train_step(lambda p, b: vgg9_loss(p, b, cfg), opt, constant(2e-3))
    state = init_train_state(params, opt)
    for i in range(steps):
        state, _ = step(state, batches(i))
    return state["params"]


def evaluate(params, cfg, test: Dict) -> Dict[str, float]:
    """Accuracy, spikes per image and the projected Eq. 3 energy per image
    (J) of ``params`` at ``cfg``'s weight bits on the ``test`` batch."""
    with torch.no_grad():
        logits, counts = vgg9_forward(params, test["images"], cfg)
    labels = torch.as_tensor(test["labels"], device=logits.device)
    n = logits.shape[0]
    acc = float((logits.argmax(-1) == labels).float().mean())
    counts = {k: float(v) for k, v in counts.items()}
    spikes = sum(counts.values()) / n

    # project onto the FPGA cost model (per-image, balanced allocation)
    convs = [c for c in counts if c.startswith("conv")][1:]
    ls = [conv_workload(c, 16, 9, counts[c] / n) for c in convs]
    alloc = balance_allocation(ls, 12)
    bits = cfg.quant_bits
    bytes_per = 4.0 if bits == 0 else bits / 8
    e = energy_per_image(ls, alloc, [9 * 16 * 12 * bytes_per] * len(ls),
                         "fp32" if bits == 0 else "int4")
    return {"accuracy": acc, "spikes_per_image": spikes, "energy_j": e["energy_j"]}


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=60, help="training steps per precision")
    ap.add_argument("--seed", type=int, default=0, help="seed of the initial weights")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where training runs (default: the card)")
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> Dict[str, Dict[str, float]]:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    table = {}
    print(f"{'precision':>10} {'accuracy':>9} {'spikes/img':>11} {'energy (model)':>15}")
    for bits in BITS:
        cfg = dataclasses.replace(BASE, quant_bits=bits)
        params = train(cfg, init_vgg9(torch.Generator().manual_seed(args.seed), cfg, dev),
                       lambda i: image_batch(0, i, BATCH, num_classes=cfg.num_classes,
                                             hw=cfg.img_hw, device=dev),
                       args.steps)
        test = image_batch(55, 0, TEST_BATCH, num_classes=cfg.num_classes, hw=cfg.img_hw,
                           device=dev)
        row = evaluate(params, cfg, test)
        name = "fp32" if bits == 0 else f"int{bits}"
        table[name] = row
        print(f"{name:>10} {row['accuracy']:9.3f} {row['spikes_per_image']:11.0f} "
              f"{row['energy_j'] * 1e6:12.2f} uJ")
    return table


if __name__ == "__main__":
    main()
