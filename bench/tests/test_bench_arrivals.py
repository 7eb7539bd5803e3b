"""Open-loop arrivals: the Poisson law's due times, a new law added by files
alone, and the open loop's generator and admission readings."""
import json
import math

import numpy as np
import pytest

from bench.harness import cli, registry
from bench.harness.inputs import stream_seed
from bench.tests.tiny import REPO, make_root

SEED = 2 ** 33 + 29


def poisson():
    return registry.arrivals(REPO, {"law": "poisson", "rate_per_s": 1.0})


def test_one_rate_is_the_same_gaps_in_the_seeds_order():
    rate, seconds = 232.0, 3.0
    got = poisson().offsets(SEED, {"law": "poisson", "rate_per_s": rate}, seconds)
    n = math.ceil(rate * seconds)
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
    order = np.random.default_rng(stream_seed(SEED, "arrivals")).permutation(n)
    np.testing.assert_allclose(got, np.cumsum(gaps[order]) - gaps[order][0], rtol=0, atol=1e-12)
    other = poisson().offsets(SEED + 1, {"law": "poisson", "rate_per_s": rate}, seconds)
    assert len(other) == n and not np.array_equal(got, other)


def test_phases_put_no_arrival_in_an_off_phase():
    spec = {"law": "poisson", "phases": [[1.0, 400.0], [0.5, 0.0]]}
    got = poisson().offsets(SEED, spec, 4.0)
    assert len(got) == 1200             # two whole periods of 1.5 s and 1 s more at 400 / s
    assert np.all(np.diff(got) >= 0)
    phase = np.mod(got, 1.5)
    assert np.all(phase <= 1.0 + 1e-9), phase.max()
    assert 0.45 < np.mean(got[got < 3.0] < 1.5) < 0.55


@pytest.mark.parametrize("spec", [{"law": "poisson"},
                                  {"law": "poisson", "rate_per_s": 1.0, "phases": [[1, 1]]},
                                  {"law": "poisson", "phases": [[1, 0]]}])
def test_poisson_refuses_what_it_cannot_offer(spec):
    with pytest.raises(ValueError):
        poisson().offsets(SEED, spec, 1.0)


def test_a_new_arrival_law_runs_by_files_only(tmp_path):
    """A law file, a mix that names it and a cell: the harness runs it."""
    root = make_root(tmp_path)
    (root / "bench/arrivals/even.py").write_text(
        "import numpy as np\n\nKEYS = {'every_s'}\n\n\n"
        "def offsets(seed, spec, seconds):\n"
        "    return np.arange(0.0, seconds, spec['every_s'])\n")
    mix = json.loads((root / "bench/traffic/open.json").read_text())
    mix["arrivals"] = {"law": "even", "every_s": 0.05}
    (root / "bench/traffic/even.json").write_text(json.dumps(mix))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "tiny-even", "config": "vgg9-cifar10", "traffic": "even",
                              "chips": 1, "why": "a dummy"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "c10-fp32-open" in m.get("workloads", []):
            m["workloads"].append("tiny-even")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    assert registry.plan(registry.resolve(root, "tiny-even"))["arrivals"] == "even"
    result = cli.run_cell(root, "tiny-even", SEED, 0.3, False, device="cpu")
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] == len(np.arange(0.0, 0.3, 0.05))
    assert set(result["metrics"]) == {"p95_ms", "setup_s"}


def test_open_loop_reads_the_generator_and_admission_apart(tmp_path):
    """A traced open run: arrivals stamped by the sender thread (generator
    lateness) and admission minus arrival (the engine's wait), each request."""
    root = make_root(tmp_path)
    result = cli.run_cell(root, "c10-fp32-open", SEED, 0.3, True, device="cpu")
    assert result["correct"] is True
    metrics = result["metrics"]
    assert metrics["gen_lag_ms.open"]["value"] >= 0.0
    assert metrics["queue_wait_ms.open"]["value"] >= 0.0
    assert "step_ms.bulk" not in metrics
