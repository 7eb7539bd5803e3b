"""Data-mesh sharded SNN serving in the port against the JAX package, on the CPU.

`vgg9_infer_hybrid_sharded` and `SNNRunner` under an in-process data mesh
(`launch.mesh.DataMesh`) of two host shards; the reference's side runs on
2 host devices in a subprocess (`tests/jax_dist_cases.py`). Bars, and why:

- the sharded pipeline's stat layout (keys and shapes) is the reference's,
  and its logits equal the port's unsharded run bit for bit (every row's
  sums are independent of how many rows share the call);
- `tests/test_dist_snn.py`'s engine: the port's 2-shard engine bit for bit
  its solo engine, and against JAX's 2-device engine on carried weights
  and images: logits within 1e-5, spike counts and skip rates exact, energy
  within 1e-12 relative (the CPU's plain path sums in another order than
  the reference's interpret-mode kernels, but spikes are integers);
- the CLI's ``--data-shard 2``: the reference's data-mesh line and its
  request lines on the same weights and images.
"""
import numpy as np
import pytest
import torch

from jax_dist_cases import collect, run_cases
from repro_torch.configs import vgg9_snn
from repro_torch.dist.context import compute_mesh
from repro_torch.launch import serve as cli
from repro_torch.launch.mesh import DataMesh, make_data_mesh
from repro_torch.models import vgg9
from repro_torch.serve.api import EngineConfig
from repro_torch.serve.core import EngineCore
from repro_torch.serve.runners.snn import SNNRunner

CLI_ARGV = ["--workload", "snn", "--data-shard", "2", "--requests", "6", "--mixed-trace"]


@pytest.fixture(scope="module")
def reference():
    return collect(run_cases([("snn_engine", {}), ("snn_layout", {}),
                              ("snn_cli", {"argv": CLI_ARGV})], 2))


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_shapes(v) for v in tree)
    return tuple(tree.shape)


@pytest.mark.parametrize("name", ["TINY", "TINY_INT4"])
def test_sharded_layout_matches_reference_and_logits_match_unsharded(reference, name):
    cfg = getattr(vgg9_snn, name)
    params = vgg9.init_vgg9(torch.Generator().manual_seed(0), cfg, "cpu")
    images = torch.rand((4, cfg.img_hw, cfg.img_hw, cfg.in_ch),
                        generator=torch.Generator().manual_seed(1))
    images[1] *= 0.01
    out = vgg9.vgg9_infer_hybrid_sharded(params, images, cfg, mesh=make_data_mesh(2, "cpu"),
                                         return_stats=True)
    assert _shapes(out) == reference["snn_layout"][name]
    logits, counts, stats = vgg9.vgg9_infer_hybrid(params, images, cfg, device="cpu",
                                                   return_stats=True)
    assert torch.equal(out[0], logits)
    for k, v in counts.items():
        assert float(out[1][k].sum()) == float(v)
    for layer, st in stats.items():
        for k in ("in_spikes_per_image", "out_spikes_per_image"):
            if k in st:
                assert torch.equal(out[2][layer][k], st[k])
    two = vgg9.vgg9_infer_hybrid_sharded(params, images, cfg, mesh=make_data_mesh(2, "cpu"))
    assert len(two) == 2 and torch.equal(two[0], logits)
    with pytest.raises(ValueError, match="divide"):
        vgg9.vgg9_infer_hybrid_sharded(params, images[:3], cfg, mesh=make_data_mesh(2, "cpu"))


def _serve(runner, imgs, mesh=None, slots=4):
    core = EngineCore(runner, EngineConfig(slots=slots))
    ids = [core.submit(im) for im in imgs]
    if mesh is None:
        results = core.run_until_complete()
    else:
        with compute_mesh(mesh):
            results = core.run_until_complete()
    return [results[i] for i in ids]


KEYS = ("spike_total", "out_spikes", "in_spikes", "skip_rate", "ts_occupancy", "energy_j",
        "latency_s")


def test_two_shard_engine_bit_identical_to_solo(reference):
    """`tests/test_dist_snn.py::test_two_device_engine_bit_identical`, in the
    port, on the reference test's weights and images."""
    ref = reference["snn_engine"]
    cfg = vgg9_snn.TINY
    runner = SNNRunner(cfg, vgg9.params_from_numpy(ref["params"], "cpu"), device="cpu")
    imgs = [torch.from_numpy(np.array(im)) for im in ref["images"]]
    solo = _serve(runner, imgs)
    sharded = _serve(runner, imgs, make_data_mesh(2, "cpu"))
    for a, b in zip(solo, sharded):
        assert np.array_equal(a.outputs, b.outputs)
        for key in KEYS:
            assert a.stats[key] == b.stats[key], key
    silent = np.mean(list(sharded[1].stats["skip_rate"].values()))
    dense = np.mean(list(sharded[0].stats["skip_rate"].values()))
    assert silent > dense, (silent, dense)


def test_two_shard_engine_matches_reference_engine(reference):
    ref = reference["snn_engine"]
    cfg = vgg9_snn.TINY
    runner = SNNRunner(cfg, vgg9.params_from_numpy(ref["params"], "cpu"), device="cpu")
    imgs = [torch.from_numpy(np.array(im)) for im in ref["images"]]
    ours = _serve(runner, imgs, make_data_mesh(2, "cpu"))
    for res, (outputs, stats) in zip(ours, ref["results"]):
        np.testing.assert_allclose(res.outputs, outputs, rtol=0, atol=1e-5)
        for key in ("spike_total", "out_spikes", "in_spikes", "skip_rate"):
            assert res.stats[key] == stats[key], key
        assert abs(res.stats["energy_j"] - stats["energy_j"]) <= 1e-12 * stats["energy_j"]


def test_runner_shards_only_over_an_in_process_data_mesh():
    """A mesh that does not divide the slots, or is not an in-process data
    mesh (a stand-in with the same axes), leaves the batch whole."""
    class Stand:
        axis_names, shape = ("data",), {"data": 2}
    runner = SNNRunner(vgg9_snn.TINY, vgg9.init_vgg9(torch.Generator().manual_seed(0),
                                                     vgg9_snn.TINY, "cpu"), device="cpu")
    assert runner._data_shards(4) == 1
    for mesh, want in ((Stand(), 1), (DataMesh(["cpu"] * 3), 1), (DataMesh(["cpu"] * 2), 2),
                       (DataMesh(["cpu"]), 1)):
        with compute_mesh(mesh):
            assert runner._data_shards(4) == want


def _request_lines(text):
    return [ln.replace(" status=ok", "") for ln in text.splitlines() if ln.startswith("req")]


def test_cli_data_shard_matches_reference_cli(reference, monkeypatch, capsys):
    """``--data-shard 2`` on the CPU: the reference's data-mesh line, and its
    request lines on its weights and images (carried)."""
    ref = reference["snn_cli"]
    monkeypatch.setattr(cli, "init_vgg9",
                        lambda gen, cfg, device: vgg9.params_from_numpy(ref["params"], device))
    monkeypatch.setattr(cli, "snn_images", lambda cfg, n, seed: [
        torch.from_numpy(np.array(im)) for im in ref["images"][:n]])
    cli.main(CLI_ARGV + ["--device", "cpu"])
    out = capsys.readouterr().out
    line = "data-mesh serving: slot batches split over 2 devices"
    assert line in out and line in ref["stdout"]
    assert _request_lines(out) == _request_lines(ref["stdout"])
    assert len(_request_lines(out)) == 6


@pytest.mark.parametrize("flags", [
    ["--workload", "snn", "--precision", "adaptive", "--scheduler", "sparsity", "--mixed-trace"],
    ["--workload", "snn", "--int4", "--slots", "2"],
    ["--workload", "lm", "--tokens", "3", "--requests", "2"],
], ids=["precision", "int4", "lm"])
def test_cli_data_shard_with_other_flags(capsys, flags):
    """With --precision and --int4 the SNN serves through the mesh and its
    request lines are the unsharded run's; the LM ignores the flag, as the
    reference's CLI does."""
    cli.main(flags + ["--device", "cpu"])
    plain = capsys.readouterr().out
    cli.main(flags + ["--device", "cpu", "--data-shard", "2"])
    sharded = capsys.readouterr().out
    assert _request_lines(sharded) == _request_lines(plain) != []
    assert ("data-mesh serving" in sharded) == ("snn" in flags)


def test_cli_data_shard_on_the_card_without_one_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["--workload", "snn", "--data-shard", "2"])
