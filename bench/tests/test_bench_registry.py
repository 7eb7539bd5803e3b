"""The harness finds cells, configurations, mixes and metrics by name."""
import json
import re

import pytest

from bench.harness import registry
from bench.tests.tiny import REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_every_cell_resolves_and_plans():
    spec = registry.load_benchmark(REPO)
    for w in spec["workloads"]:
        plan = registry.plan(registry.resolve(REPO, w["name"]))
        assert plan["driver"] in ("closed", "open", "train")
        assert "setup_s" in plan["end_to_end"] and len(plan["end_to_end"]) >= 2
        assert plan["per_layer"] and set(plan["readers"]) == set(plan["end_to_end"] + plan["per_layer"])


def test_benchmark_file_keeps_the_contract_shape():
    spec = registry.load_benchmark(REPO)
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in spec[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    e2e = {m["name"] for m in spec["end_to_end"]}
    for m in spec["per_layer"]:
        assert m["moves"] in e2e and set(m) <= {"name", "unit", "better", "source", "layer",
                                               "moves", "workloads"}
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for c in spec["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        assert c["reduced"] == cfg["reduced"] == []
        assert "serve" in cfg["limits"] and set(cfg["limits"]) <= {"serve", "train"}


def _dummy_root(root):
    for folder in ("configs", "traffic", "metrics", "reference", "drivers"):
        (root / "bench" / folder).mkdir(parents=True)
    (root / "bench" / "reference" / "vgg9.py").write_text(
        (REPO / "bench/reference/vgg9.py").read_text())
    (root / "bench/metrics/setup_s.py").write_text((REPO / "bench/metrics/setup_s.py").read_text())
    return root


def test_dummy_parts_added_by_files_only(tmp_path):
    """A new configuration, traffic mix, driver and metric: files and entries, no code."""
    root = _dummy_root(tmp_path)
    cfg = json.loads((REPO / "bench/configs/vgg9-cifar10.json").read_text())
    (root / "bench/configs/dummy-cfg.json").write_text(json.dumps({**cfg, "population": 500}))
    (root / "bench/traffic/dummy-mix.json").write_text(json.dumps(
        {"kind": "dummy-kind", "requests": 3}))
    (root / "bench/drivers/dummy-kind.py").write_text(
        "MIX_KEYS = {'requests'}\n\ndef run(cell, *args, **kwargs):\n"
        "    return cell.traffic['requests']\n")
    (root / "bench/metrics/dummy_ms.py").write_text("def read(r):\n    return 1.5\n")
    spec = {"configs": [{"name": "dummy-cfg", "file": "bench/configs/dummy-cfg.json"}],
            "workloads": [{"name": "dummy-cell", "config": "dummy-cfg", "traffic": "dummy-mix",
                           "chips": 1}],
            "end_to_end": [{"name": "setup_s", "unit": "s", "better": "lower", "bound": 0.25,
                            "source": "host_clock"}],
            "per_layer": [{"name": "dummy_ms.any", "unit": "ms", "better": "lower",
                           "source": "host_clock", "layer": "engine", "moves": "setup_s",
                           "workloads": ["dummy-cell"]}]}
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = registry.resolve(root, "dummy-cell")
    assert cell.config["population"] == 500 and cell.traffic["requests"] == 3
    assert [m.name for m in cell.metrics(trace=True)] == ["dummy_ms.any"]
    plan = registry.plan(cell)
    assert plan["driver"] == "dummy-kind" and plan["driver_file"] == "dummy-kind.py"
    assert plan["readers"] == ["dummy_ms.any", "setup_s"]
    assert registry.driver(cell).run(cell) == 3
    assert registry.reader(root, "dummy_ms.any")(None) == 1.5
    with pytest.raises(KeyError):
        registry.resolve(root, "no-such-cell")


def test_a_metric_file_of_its_own_comes_before_its_base(tmp_path):
    root = _dummy_root(tmp_path)
    (root / "bench/metrics/x_ms.py").write_text("def read(r):\n    return 1\n")
    (root / "bench/metrics/x_ms.open.py").write_text("def read(r):\n    return 2\n")
    assert registry.reader(root, "x_ms.open")(None) == 2
    assert registry.reader(root, "x_ms.bulk")(None) == 1
    with pytest.raises(FileNotFoundError):
        registry.reader(root, "y_ms.bulk")


@pytest.mark.parametrize("mix,what", [
    ({"precision": "adaptive"}, "traffic mix"),
    ({"arrivals": {"law": "poisson", "rate_per_s": 5.0, "burst": 2}}, "arrival law"),
])
def test_a_mix_key_that_no_code_reads_is_refused(mix, what):
    """A key its driver or arrival law does not read fails the plan, so a
    mix never runs as something it does not say."""
    cell = registry.resolve(REPO, "c10-fp32-open")
    cell.traffic = {**cell.traffic, **mix}
    with pytest.raises(ValueError, match=what):
        registry.plan(cell)
