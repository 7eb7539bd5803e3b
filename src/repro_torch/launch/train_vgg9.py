"""Training driver for the port: the spiking VGG9 with surrogate-gradient BPTT
and optional int4 QAT, checkpoint/restart, a hybrid-pipeline cross-check and
the Eq. 3 core allocation.

    PYTHONPATH=src python -m repro_torch.launch.train_vgg9 --steps 200
    PYTHONPATH=src python -m repro_torch.launch.train_vgg9 --device cpu --steps 3 --int4

Trains the JAX example's configuration (TINY widths, 4 classes, batch 32)
on synthetic Gabor textures (`data.synthetic.image_batch`) with
AdamW and a warmup-cosine schedule, then evaluates on a held-out batch and
prints per-layer spikes, then runs `vgg9_infer_hybrid` on the trained
weights against `vgg9_forward`, then prints the `plan_hybrid` allocation.
Runs on the card unless ``--device cpu`` is given; asking for the card
without one raises. Resumes from the newest checkpoint in ``--ckpt-dir``
(``build/vgg9_ckpt`` at the repo root by default; ``--ckpt-dir ''`` turns
checkpoints off).
"""
from __future__ import annotations

import argparse
import dataclasses
from pathlib import Path
from typing import List, Optional

import torch

from ..configs import vgg9_snn
from ..core.hybrid import plan_hybrid
from ..data.synthetic import image_batch
from ..device import resolve_device
from ..models.vgg9 import init_vgg9, vgg9_forward, vgg9_infer_hybrid, vgg9_loss
from ..train.loop import TrainLoop
from ..train.optim import adamw
from ..train.schedule import warmup_cosine
from ..train.train_step import init_train_state, make_train_step

DEFAULT_CKPT_DIR = Path(__file__).resolve().parents[3] / "build" / "vgg9_ckpt"
BATCH = 32


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--int4", action="store_true", help="train with int4 QAT")
    ap.add_argument("--ckpt-dir", default=str(DEFAULT_CKPT_DIR))
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where training runs (default: the card)")
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> dict:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg = dataclasses.replace(vgg9_snn.TINY, num_classes=4,
                              quant_bits=4 if args.int4 else 0)
    opt = adamw(weight_decay=0.0)
    step = make_train_step(lambda p, b: vgg9_loss(p, b, cfg), opt,
                           warmup_cosine(3e-3, 20, args.steps))
    params = init_vgg9(torch.Generator().manual_seed(0), cfg, dev)
    state = init_train_state(params, opt)

    loop = TrainLoop(step,
                     lambda i: image_batch(0, i, BATCH, num_classes=cfg.num_classes,
                                           hw=cfg.img_hw, device=dev),
                     ckpt_dir=args.ckpt_dir or None, ckpt_every=50, log_every=20)
    restored, start = loop.maybe_restore(state)
    if restored is not None:
        state = restored
        print(f"resumed from checkpoint at step {start}")
    state = loop.run(state, args.steps, start_step=start)

    # evaluate + spike statistics
    params = state["params"]
    test = image_batch(77, 0, 64, num_classes=cfg.num_classes, hw=cfg.img_hw, device=dev)
    with torch.no_grad():
        logits, counts = vgg9_forward(params, test["images"], cfg)
    acc = float((logits.argmax(-1) == test["labels"]).float().mean())
    spikes = {k: int(v) for k, v in counts.items()}
    print(f"\naccuracy={acc:.3f}, per-layer spikes:", spikes)

    # hybrid kernel path cross-check (dense core + sparse cores)
    with torch.no_grad():
        hyb_logits, _ = vgg9_infer_hybrid(params, test["images"][:8], cfg, device=dev)
        ref_logits, _ = vgg9_forward(params, test["images"][:8], cfg)
    match = bool(torch.equal(hyb_logits, ref_logits))
    print("hybrid kernels match reference:", match,
          f"(max |dlogits| {float((hyb_logits - ref_logits).abs().max()):.3e})")

    # Eq. 3 workload model -> balanced core allocation
    per_img = {k: v / 64 for k, v in spikes.items()}
    channels = cfg.conv_channels
    specs = [{"name": "conv0", "kind": "dense_input", "h_out": cfg.img_hw,
              "w_out": cfg.img_hw, "c_out": channels[0], "timesteps": cfg.timesteps}]
    specs += [{"name": f"conv{i}", "kind": "conv", "c_out": c, "filter_coeffs": 9}
              for i, c in enumerate(channels) if i > 0]
    specs += [{"name": "fc0", "kind": "fc", "n_out": cfg.fc_dim},
              {"name": "fc1", "kind": "fc", "n_out": cfg.population}]
    plan = plan_hybrid(specs, per_img, budget=24)
    print("\nhybrid plan (layer, path, cores, latency share):")
    for layer, ov in zip(plan.layers, plan.overheads):
        print(f"  {layer.name:6s} {layer.path:6s} cores={layer.cores:2d} share={ov:.1%}")
    return {"accuracy": acc, "spikes": spikes, "hybrid_match": match,
            "history": loop.history}


if __name__ == "__main__":
    main()
