"""The plain reference against the port's CPU path at TINY and TINY_INT4."""
import dataclasses
import json

import numpy as np
import pytest
import torch

from bench.harness import check, inputs, registry
from bench.tests.tiny import REPO, TINY

ref = registry.reference(REPO, "vgg9")


def tiny_cfg(bits):
    cfg = json.loads((REPO / "bench/configs/vgg9-cifar10.json").read_text())
    return {**cfg, **TINY, "quant_bits": bits}


def port_cfg(cfg):
    from repro_torch.configs.vgg9_snn import TINY as PORT_TINY
    port = dataclasses.replace(PORT_TINY, quant_bits=cfg["quant_bits"])
    assert port.stages == tuple(cfg["stages"]) and port.population == cfg["population"]
    return port


@pytest.mark.parametrize("bits", [0, 4])
def test_inference_matches_port_cpu_path(bits):
    from repro_torch.models.vgg9 import vgg9_infer_hybrid
    cfg = tiny_cfg(bits)
    params = inputs.master_weights(3, cfg, "cpu")
    images, _ = inputs.images(3, 6, cfg, "cpu")
    logits, _, stats = vgg9_infer_hybrid(params, images, port_cfg(cfg), device="cpu",
                                         return_stats=True)
    want = ref.infer(params, images, cfg)
    assert (logits - want["logits"]).abs().max().item() <= 1e-6
    for layer, counts in want["out_spikes"].items():
        assert torch.equal(stats[layer]["out_spikes_per_image"], counts), layer
    for layer, counts in want["in_spikes"].items():
        assert torch.equal(stats[layer]["in_spikes_per_image"], counts), layer
    assert sum(float(v.sum()) for v in want["out_spikes"].values()) > 0


@pytest.mark.parametrize("bits", [0, 4])
def test_training_steps_match_port(bits):
    from repro_torch.models.vgg9 import vgg9_loss
    from repro_torch.train.optim import adamw
    from repro_torch.train.schedule import constant
    from repro_torch.train.train_step import init_train_state, make_train_step
    cfg = tiny_cfg(bits)
    opt_cfg = json.loads((REPO / "bench/traffic/qat.json").read_text())["optimizer"]
    params = inputs.master_weights(5, cfg, "cpu")
    images, labels = inputs.images(5, 8, cfg, "cpu", stream="batches")
    batches = [(images[:4], labels[:4]), (images[4:], labels[4:])]
    port = port_cfg(cfg)
    opt = adamw(b1=opt_cfg["b1"], b2=opt_cfg["b2"], eps=opt_cfg["eps"],
                weight_decay=opt_cfg["weight_decay"])
    step = make_train_step(lambda p, b: vgg9_loss(p, b, port), opt, constant(opt_cfg["lr"]),
                           clip_norm=opt_cfg["clip_norm"])
    state = init_train_state(check.clone_tree(params), opt)
    losses = []
    for i, (x, y) in enumerate(batches):
        state, metrics = step(state, {"images": x, "labels": y})
        losses.append(float(metrics["loss"]))
        if i == 0:
            m1 = check.clone_tree(state["opt"]["m"])
    want = ref.adamw_steps(params, batches, cfg, opt_cfg)
    numbers = check.training_numbers({"losses": losses, "m1": m1, "params": state["params"]},
                                     want, params, opt_cfg["b1"])
    assert max(numbers.values()) <= 1e-5, numbers
    assert np.isfinite(losses).all()
