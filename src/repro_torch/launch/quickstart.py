"""Quickstart: train a tiny direct-coded spiking VGG9 and inspect the
quantization-sparsity interplay — the paper's core loop in a few lines.

    PYTHONPATH=src python -m repro_torch.launch.quickstart
    PYTHONPATH=src python -m repro_torch.launch.quickstart --device cpu --steps 50

The port of the JAX package's ``examples/quickstart.py``: ``--steps``
AdamW steps (constant 2e-3, batch 32, 4 classes, T = 2, surrogate
gradients) from the ``--seed`` weights, then accuracy, total spikes and
per-layer spikes of the trained weights on a held-out batch of 64, read
once at fp32 and once through the int4 fake-quant view (paper Fig. 1).
Runs on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Dict, List, Optional

import torch

from ..configs import vgg9_snn
from ..data.synthetic import image_batch
from ..device import resolve_device
from ..models.vgg9 import init_vgg9, vgg9_forward, vgg9_loss
from ..train.optim import adamw
from ..train.schedule import constant
from ..train.train_step import init_train_state, make_train_step


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0, help="seed of the initial weights")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where training runs (default: the card)")
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> Dict[str, Dict]:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg = dataclasses.replace(vgg9_snn.TINY, num_classes=4)

    opt = adamw(weight_decay=0.0)
    step = make_train_step(lambda p, b: vgg9_loss(p, b, cfg), opt, constant(2e-3))
    state = init_train_state(init_vgg9(torch.Generator().manual_seed(args.seed), cfg, dev),
                             opt)

    print("training tiny spiking VGG9 (direct coding, T=2, surrogate gradients)...")
    for i in range(args.steps):
        batch = image_batch(0, i, 32, num_classes=4, hw=cfg.img_hw, device=dev)
        state, metrics = step(state, batch)
        if i % 10 == 0:
            print(f"  step {i:3d}  loss={float(metrics['loss']):.4f}")

    # quantization-sparsity interplay (paper Fig. 1)
    test = image_batch(9, 0, 64, num_classes=4, hw=cfg.img_hw, device=dev)
    out = {}
    for name, c in (("fp32", cfg), ("int4", dataclasses.replace(cfg, quant_bits=4))):
        with torch.no_grad():
            logits, counts = vgg9_forward(state["params"], test["images"], c)
        acc = float((logits.argmax(-1) == test["labels"]).float().mean())
        per_layer = {k: int(v) for k, v in counts.items()}
        out[name] = {"accuracy": acc, "spikes": per_layer}
        print(f"{name}: accuracy={acc:.3f} total_spikes={sum(per_layer.values())} "
              f"per-layer={per_layer}")
    return out


if __name__ == "__main__":
    main()
