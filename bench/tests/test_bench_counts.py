"""The frozen work counts against brute force on tiny inputs."""
import itertools
import json

import pytest
import torch

from bench.harness import counts
from bench.tests.tiny import REPO


def brute_taps(spikes):
    """Per image: sum over output positions and 3x3 taps inside the map of the spikes read."""
    n, c, h, w = spikes.shape
    out = torch.zeros(n, dtype=torch.float64)
    for i, j, di, dj in itertools.product(range(h), range(w), (-1, 0, 1), (-1, 0, 1)):
        if 0 <= i + di < h and 0 <= j + dj < w:
            out += spikes[:, :, i + di, j + dj].double().sum(dim=1)
    return out


@pytest.mark.parametrize("shape", [(2, 3, 5, 4), (1, 2, 1, 3), (3, 1, 2, 2)])
def test_conv_taps_match_brute_force(shape):
    spikes = (torch.rand(shape, generator=torch.Generator().manual_seed(sum(shape))) < 0.4).float()
    assert torch.equal(counts.conv_taps(spikes).double(), brute_taps(spikes))
    assert counts.conv_adds(spikes, 7) == float(brute_taps(spikes).sum()) * 7


def test_fc_adds_and_bytes():
    spikes = torch.tensor([[1.0, 0.0, 1.0], [0.0, 0.0, 1.0]])
    assert counts.fc_adds(spikes, 5) == 15.0
    assert counts.spike_map_bytes(64, 16) == 10.0
    assert counts.weight_bytes(9 * 4, 8, 0) == 9 * 4 * 8 * 4
    assert counts.weight_bytes(9 * 4, 8, 4) == 9 * 4 * 8 * 0.5


def test_dense_and_train_flops_by_enumeration():
    cfg = json.loads((REPO / "bench/configs/vgg9-cifar10.json").read_text())
    cfg.update(img_hw=4, stages=[2, 3, "MP", 5, "MP"], fc_dim=6, population=8)
    hw = cfg["img_hw"]
    taps = sum(1 for i, j, di, dj in itertools.product(range(hw), range(hw), (-1, 0, 1), (-1, 0, 1))
               if 0 <= i + di < hw and 0 <= j + dj < hw)
    assert counts.dense_flops(cfg, 3) == 2.0 * taps * 3 * 2 * 3
    t = cfg["timesteps"]
    forward = (2 * 16 * 9 * 3 * 2                # input conv, once
               + t * 2 * 16 * 9 * 2 * 3          # conv1 at 4x4
               + t * 2 * 4 * 9 * 3 * 5           # conv2 at 2x2
               + t * 2 * (1 * 5 * 6 + 6 * 8))    # fc0, fc1
    assert counts.train_flops_per_image(cfg) == 3.0 * forward


def test_work_counter_sums_layers():
    counter = counts.WorkCounter()
    spikes = torch.ones(2, 3, 4, 4)
    counter("conv1", spikes, 5)
    counter("fc0", torch.ones(2, 6), 4)
    assert counter.adds == {"conv1": float(brute_taps(spikes).sum()) * 5, "fc0": 48.0}
    assert counter.entries_in == {"conv1": 96.0, "fc0": 12.0}
    assert counter.entries_out == {"conv1": 2 * 5 * 16.0, "fc0": 8.0}
