"""The port's serving stack against the JAX package's, plus its entry points.

The same trace (numpy images from a seed, a silent image, a partial last
batch) goes through both `EngineCore`s over their `SNNRunner`s with the
same weights; admissions, per-request stats and logits must agree.
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import vgg9_snn as jax_cfgs
from repro.models.vgg9 import init_vgg9 as jax_init
from repro.serve.api import EngineConfig as JaxEngineConfig
from repro.serve.core import EngineCore as JaxEngineCore
from repro.serve.runners.snn import SNNRunner as JaxSNNRunner
from repro_torch.configs import vgg9_snn as torch_cfgs
from repro_torch.launch import serve as cli
from repro_torch.models.vgg9 import params_from_numpy
from repro_torch.serve.api import EngineConfig, Request
from repro_torch.serve.core import EngineCore
from repro_torch.serve.runners.snn import SNNRunner

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
EXACT_STATS = ("skip_rate", "batch_skip_rate", "in_spikes", "out_spikes", "spike_total",
               "ts_occupancy", "energy_j", "latency_s", "energy_analytical_j",
               "served_energy_j", "served_energy_analytical_j", "batch_energy_j",
               "batch_latency_s", "batch_real", "precision", "wbytes_per")


@pytest.fixture(scope="module")
def jax_params():
    return jax.tree.map(np.asarray, jax_init(jax.random.PRNGKey(0), jax_cfgs.TINY))


def _trace(n=7):
    rng = np.random.default_rng(2)
    imgs = [rng.random((16, 16, 3)).astype(np.float32) for _ in range(n)]
    for i in range(0, n, 2):
        imgs[i] = imgs[i] * np.float32(0.02)               # --mixed-trace mix
    imgs[n // 2] = np.zeros((16, 16, 3), np.float32)        # silent request
    return imgs


def _serve(core, imgs):
    ids = [core.submit(img, source="sparse" if i % 2 == 0 else "dense")
           for i, img in enumerate(imgs)]
    return ids, core.run_until_complete()


@pytest.mark.parametrize("scheduler", ["fifo", "sparsity"])
@pytest.mark.parametrize("name", ["TINY", "TINY_INT4"])
def test_engine_parity_with_reference(jax_params, scheduler, name):
    imgs = _trace()                                         # 7 requests, 4 slots
    jcore = JaxEngineCore(JaxSNNRunner(getattr(jax_cfgs, name), jax_params, interpret=True),
                          JaxEngineConfig(slots=4, scheduler=scheduler))
    tcore = EngineCore(SNNRunner(getattr(torch_cfgs, name),
                                 params_from_numpy(jax_params, "cpu"), device="cpu"),
                       EngineConfig(slots=4, scheduler=scheduler))
    jids, jres = _serve(jcore, imgs)
    tids, tres = _serve(tcore, imgs)
    assert tids == jids
    assert tcore.admission_log == jcore.admission_log
    assert tcore.stats() == jcore.stats()
    for rid in jids:
        a, b = jres[rid], tres[rid]
        assert b.status == a.status == "ok"
        assert isinstance(b.outputs, np.ndarray)
        np.testing.assert_allclose(b.outputs, np.asarray(a.outputs), atol=1e-5)
        for key in EXACT_STATS:
            assert b.stats[key] == a.stats[key], (rid, key)
    silent = tres[jids[3]]
    assert silent.stats["spike_total"] == 0.0
    assert all(v == 1.0 for v in silent.stats["skip_rate"].values())


def test_batch_admission_pads_partial_batch(jax_params):
    imgs = _trace(3)
    runner = SNNRunner(torch_cfgs.TINY, params_from_numpy(jax_params, "cpu"), device="cpu")
    core = EngineCore(runner, EngineConfig(slots=4, admission="batch"))
    ids, res = _serve(core, imgs)
    assert sorted(res) == ids and core.stats()["batches_run"] == 1
    direct = runner.run([Request(i, img) for i, img in enumerate(imgs)]
                        + [runner.filler(Request(0, imgs[0]))])
    for i, rid in enumerate(ids):
        np.testing.assert_array_equal(res[rid].outputs, direct[i].outputs)


def _req(img):
    return Request(0, img)


def test_filler_is_zero_image_on_runner_device(jax_params):
    runner = SNNRunner(torch_cfgs.TINY, params_from_numpy(jax_params, "cpu"), device="cpu")
    pad = runner.filler(_req(np.ones((16, 16, 3), np.float32)))
    assert pad.is_pad and isinstance(pad.payload, torch.Tensor)
    assert pad.payload.device.type == "cpu" and not pad.payload.any()
    assert runner.bucket_key(pad) == runner.session_key(_req(np.ones((16, 16, 3)))) == (16, 16, 3)


def test_import_leaves_jax_and_reference_out():
    code = ("import importlib, pkgutil, sys\n"
            "import repro_torch\n"
            "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,"
            " 'repro_torch.')]\n"
            "for name in names:\n"
            "    importlib.import_module(name)\n"
            "assert {'repro_torch.train.train_step', 'repro_torch.launch.train_vgg9',"
            " 'repro_torch.core.coding', 'repro_torch.data.synthetic',"
            " 'repro_torch.serve.runners.lm', 'repro_torch.launch.serve_lm_w4',"
            " 'repro_torch.kernels.int4_matmul.ops',"
            " 'repro_torch.kernels.flash_attention.ops', 'repro_torch.obs',"
            " 'repro_torch.serve.precision', 'repro_torch.launch.quant_sparsity_study',"
            " 'repro_torch.launch.quickstart', 'repro_torch.models.moe',"
            " 'repro_torch.models.rglru', 'repro_torch.models.xlstm',"
            " 'repro_torch.models.frontends', 'repro_torch.configs.granite_moe_3b',"
            " 'repro_torch.serve.faults', 'repro_torch.serve.router',"
            " 'repro_torch.serve.wire', 'repro_torch.serve.worker'}"
            " <= set(names)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'repro' or m.startswith('repro.'))\n"
            "assert not bad, bad\n"
            "print('clean')\n")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_card_requested_without_one_raises(jax_params):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        SNNRunner(torch_cfgs.TINY, params_from_numpy(jax_params, "cpu"))
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["--workload", "snn", "--requests", "1"])


def test_cli_serves_on_cpu(capsys):
    cli.main(["--workload", "snn", "--device", "cpu", "--requests", "3",
              "--scheduler", "sparsity", "--mixed-trace"])
    out = capsys.readouterr().out
    assert sum(line.startswith("req") for line in out.splitlines()) == 3
    assert "'requests_done': 3" in out


@pytest.mark.parametrize("flags", [["--data-shard", "2"]])
def test_cli_refuses_unported_flags(flags):
    with pytest.raises(SystemExit, match="not ported yet"):
        cli.main(flags + ["--device", "cpu"])


@pytest.mark.parametrize("flags,expect", [
    (["--workload", "lm", "--scheduler", "slo", "--slo-ms", "3000", "--prefill-chunk", "4",
      "--tokens", "4"], "'scheduler': 'slo'"),
    (["--workload", "snn", "--scheduler", "sparsity", "--mixed-trace", "--precision",
      "adaptive", "--metrics", "prom", "--requests", "6"], "# TYPE precision_served_int4 gauge"),
    (["--workload", "snn", "--scheduler", "sparsity", "--mixed-trace", "--precision",
      "adaptive", "--metrics", "json", "--requests", "6"], "METRICS_JSON {"),
], ids=["slo-ms", "precision", "metrics"])
def test_cli_serves_ported_flags(capsys, flags, expect):
    cli.main(flags + ["--device", "cpu"])
    out = capsys.readouterr().out
    reqs = [line for line in out.splitlines() if line.startswith("req")]
    n = int(flags[flags.index("--requests") + 1]) if "--requests" in flags else 4
    assert len(reqs) == n
    assert all("status=ok" in line for line in reqs)
    assert expect in out
    if "--precision" in flags:
        assert "precision controller: {'decisions': 6" in out
        # every third request is pinned to fp32
        assert all("precision=fp32" in reqs[i] for i in (0, 3))
        assert {"precision=fp32", "precision=int4"} <= {
            w for line in reqs for w in line.split() if w.startswith("precision=")}
        assert "trace: " in out


def _request_lines(capsys, argv):
    cli.main(argv + ["--workload", "snn", "--device", "cpu"])
    out = capsys.readouterr().out
    return [line for line in out.splitlines() if line.startswith("req")], out


@pytest.mark.parametrize("fleet", [["--replicas", "3", "--fault-plan", "0=wedge@1"],
                                   ["--workers", "2"]], ids=["replicas", "workers"])
def test_cli_fleet_lines_equal_the_solo_engine_s(capsys, fleet):
    """Through 3 in-process replicas with replica 0 wedged from its second
    step (the JAX CLI's drain line printed), or through 2 worker
    subprocesses, each request's line equals the solo engine's on the same
    seed. One slot per engine, so that every request rides a batch of its
    own everywhere (its served energy is its batch's share) and replica 0
    still holds a request when its wedge starts."""
    solo, _ = _request_lines(capsys, ["--slots", "1"])
    lines, out = _request_lines(capsys, ["--slots", "1"] + fleet)
    assert len(solo) == 4 and lines == solo
    assert all(line.endswith("status=ok") for line in lines)
    assert "'router_steps'" in out and "admissions:" not in out
    drains = [line for line in out.splitlines() if line.startswith("drain @step")]
    if "--replicas" in fleet:
        assert len(drains) == 1 and "replica 0 condemned (wedged), re-routed requests [3]" \
            in drains[0]
    else:
        assert drains == [] and "'worker_pid'" in out


def test_cli_fleet_reports_requests_no_replica_could_serve(capsys):
    """One replica wedged from its first step: it is condemned with nothing
    healthy left, so every request retires 'failed' without outputs, and the
    CLI reports each one instead of reading logits that do not exist."""
    lines, out = _request_lines(capsys, ["--fault-plan", "0=wedge@0", "--requests", "2"])
    assert lines == ["req0: status=failed", "req1: status=failed"]
    assert "drain @step" in out
