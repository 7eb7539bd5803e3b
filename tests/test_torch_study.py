"""The port's §III study scripts (`launch.quant_sparsity_study`,
`launch.quickstart`) against the JAX package's recipe.

The study recipe (tiny spiking VGG9, 4 classes, AdamW at a constant 2e-3,
QAT at the weight width) runs in both packages at bits 0 and 4 for 2
steps from the same weights (the JAX init, carried across with
`params_from_numpy`) on the same batches (the JAX package's
`image_batch`, as numpy). The JAX side is built in-line from the
reference's functions, as its example does. Bars: spikes per image and
Eq. 3 energy within 1e-3 relative (a spike near threshold may flip after
two steps: the two packages' convolutions sum in other orders), accuracy
equal.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import vgg9_snn as jax_cfgs
from repro.core.energy import energy_per_image as jax_energy_per_image
from repro.core.workload import balance_allocation as jax_balance_allocation
from repro.core.workload import conv_workload as jax_conv_workload
from repro.data.synthetic import image_batch as jax_image_batch
from repro.models import vgg9 as jax_vgg9
from repro.train import optim as jax_optim
from repro.train import schedule as jax_schedule
from repro.train import train_step as jax_train_step
from repro_torch.launch import quant_sparsity_study as study
from repro_torch.launch import quickstart
from repro_torch.models.vgg9 import params_from_numpy

STEPS = 2


def _jax_study_row(bits, params, batches, test):
    """The reference example's loop body for one weight width."""
    cfg = dataclasses.replace(jax_cfgs.TINY, num_classes=4, quant_bits=bits)
    opt = jax_optim.adamw(weight_decay=0.0)
    step = jax.jit(jax_train_step.make_train_step(lambda p, b: jax_vgg9.vgg9_loss(p, b, cfg),
                                                  opt, jax_schedule.constant(2e-3)))
    state = jax_train_step.init_train_state(params, opt)
    for batch in batches:
        state, _ = step(state, batch)
    logits, counts = jax_vgg9.vgg9_forward(state["params"], test["images"], cfg)
    acc = float((logits.argmax(-1) == test["labels"]).mean())
    spikes = float(sum(float(v) for v in counts.values())) / 64
    convs = [c for c in counts if c.startswith("conv")][1:]
    ls = [jax_conv_workload(c, 16, 9, float(counts[c]) / 64) for c in convs]
    alloc = jax_balance_allocation(ls, 12)
    bytes_per = 4.0 if bits == 0 else bits / 8
    e = jax_energy_per_image(ls, alloc, [9 * 16 * 12 * bytes_per] * len(ls),
                             "fp32" if bits == 0 else "int4")
    return {"accuracy": acc, "spikes_per_image": spikes, "energy_j": e["energy_j"]}


def _numpy(batch):
    return {k: np.array(v) for k, v in batch.items()}


@pytest.mark.parametrize("bits", [0, 4])
def test_study_matches_reference(bits):
    params = jax_vgg9.init_vgg9(jax.random.PRNGKey(0),
                                dataclasses.replace(jax_cfgs.TINY, num_classes=4))
    batches = [_numpy(jax_image_batch(0, i, study.BATCH, num_classes=4, hw=16))
               for i in range(STEPS)]
    test = _numpy(jax_image_batch(55, 0, study.TEST_BATCH, num_classes=4, hw=16))
    ref = _jax_study_row(bits, params, batches, test)

    cfg = dataclasses.replace(study.BASE, quant_bits=bits)
    trained = study.train(cfg, params_from_numpy(jax.tree.map(np.asarray, params), "cpu"),
                          lambda i: {k: torch.from_numpy(v) for k, v in batches[i].items()},
                          STEPS)
    row = study.evaluate(trained, cfg, {k: torch.from_numpy(v) for k, v in test.items()})
    assert row["accuracy"] == ref["accuracy"]
    for key in ("spikes_per_image", "energy_j"):
        assert row[key] == pytest.approx(ref[key], rel=1e-3), key


def test_study_and_quickstart_run_on_cpu(capsys):
    table = study.main(["--device", "cpu", "--steps", "1"])
    assert list(table) == ["fp32", "int8", "int4", "int3"]
    assert all(np.isfinite(list(row.values())).all() for row in table.values())
    out = quickstart.main(["--device", "cpu", "--steps", "1"])
    assert set(out) == {"fp32", "int4"}
    assert set(out["fp32"]["spikes"]) == {"conv0", "conv1", "conv2", "conv3", "fc0", "fc1"}
    printed = capsys.readouterr().out
    assert "precision  accuracy" in printed and "int4: accuracy=" in printed
