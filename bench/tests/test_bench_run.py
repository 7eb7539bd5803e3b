"""Whole runs at TINY on the CPU: the result's shape, the refusal without a
card, and `correct` coming out false under the control and under each fault
the cells can have, with the limits the configurations state."""
import json

import numpy as np
import pytest
import torch

from bench.harness import check, cli, registry
from bench.harness.control import readings
from bench.tests.tiny import NARROW_IMAGES, TINY, make_root

SEED = 2 ** 33 + 11
KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.fixture()
def root(tmp_path):
    return make_root(tmp_path)


@pytest.mark.parametrize("workload", ["c10-fp32-bulk", "c10-fp32-open", "c10-int4-qat"])
def test_result_line_shape(root, workload):
    result = cli.run_cell(root, workload, SEED, 0.3, False, device="cpu")
    assert list(result) == KEYS and result["correct"] is True
    assert result["failed"] == 0 and result["attempted"] > 0
    cell = registry.resolve(root, workload)
    assert set(result["metrics"]) == {m.name for m in cell.end_to_end}
    assert all(c["value"] <= c["limit"] for c in result["checks"].values())
    json.loads(json.dumps(result))


def test_no_card_no_result(root, capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    rc = cli.main(["--workload", "c10-fp32-bulk", "--seed", "1", "--seconds", "1"], root=root)
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "No result" in out.err


def _serving_fault(monkeypatch, kind):
    from repro_torch.serve.runners import snn
    if kind == "half_batch":                 # second half of the slots served the first half's images
        original = snn.vgg9_infer_hybrid

        def half(params, images, cfg, **kw):
            n = images.shape[0] // 2
            return original(params, torch.cat([images[:n], images[:images.shape[0] - n]]), cfg, **kw)
        monkeypatch.setattr(snn, "vgg9_infer_hybrid", half)
        return
    original = snn.SNNRunner.run

    def broken(self, batch):
        results = original(self, batch)
        if kind == "altered":                # the answers changed where they are produced
            for r in results:
                r.outputs[0] += 0.5
        elif kind == "unchanged":            # the step leaves its outputs as they started: zeros
            for r in results:
                r.outputs[:] = 0.0
                r.stats["out_spikes"] = dict.fromkeys(r.stats["out_spikes"], 0.0)
        return results
    monkeypatch.setattr(snn.SNNRunner, "run", broken)


@pytest.mark.parametrize("fault", ["altered", "half_batch", "unchanged"])
def test_serving_faults_are_not_correct(root, monkeypatch, fault):
    _serving_fault(monkeypatch, fault)
    result = cli.run_cell(root, "c10-fp32-bulk", SEED, 0.3, False, device="cpu")
    assert result["correct"] is False, result["checks"]


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_training_faults_are_not_correct(root, monkeypatch, fault):
    from repro_torch.models import vgg9
    from repro_torch.train import train_step
    if fault == "unchanged":                 # the step returns its state unchanged
        original = train_step.make_train_step

        def make(*args, **kw):
            step = original(*args, **kw)
            return lambda state, batch: (state, step(state, batch)[1])
        monkeypatch.setattr(train_step, "make_train_step", make)
    else:                                    # half of the batch left out, the mean over the rest
        original = vgg9.vgg9_loss

        def half(params, batch, cfg, **kw):
            n = batch["images"].shape[0] // 2
            return original(params, {k: v[:n] for k, v in batch.items()}, cfg, **kw)
        monkeypatch.setattr(vgg9, "vgg9_loss", half)
    result = cli.run_cell(root, "c10-int4-qat", SEED, 0.3, False, device="cpu")
    assert result["correct"] is False, result["checks"]


@pytest.mark.parametrize("workload,sizes", [("c10-fp32-bulk", NARROW_IMAGES),
                                            ("c10-int4-bulk", NARROW_IMAGES),
                                            ("c10-int4-qat", TINY)])
def test_control_is_not_correct(tmp_path, workload, sizes):
    """The reference one precision below the configuration's (TF32 products,
    emulated on the CPU) in the program's place fails the stated limits:
    serving at the published widths on 8 x 8 images (TINY's narrow sums
    flip too few spikes to tell), training at TINY."""
    root = make_root(tmp_path, slots=16, pool=32, sizes=sizes, sample=32)
    line = readings(root, workload, SEED, 0.3, control=True, device="cpu")
    limits = registry.resolve(root, workload).config["limits"]
    kind = "train" if workload.endswith("qat") else "serve"
    assert line["correct"] is True
    assert not check.judge(line["control"], limits[kind])[0], line["control"]
    assert np.isfinite([line["control"][k] for k in limits[kind]]).all()
