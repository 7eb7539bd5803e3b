"""The readers of the program's step records (`bench/harness/program.py`):
None where the program keeps none, medians and shares on synthetic records,
a file for every entry, and numbers from a traced TINY run on the CPU (the
host spans; the device layers stay None without a card)."""
import json

import pytest

from bench.harness import cli, registry
from bench.harness.core import Readings
from bench.tests.tiny import REPO, make_root
from repro_torch.obs import trace

NEW = {
    "skip_split_ms.bulk": ["c10-fp32-bulk", "c10-int4-bulk"],
    "skip_split_ms.open": ["c10-fp32-open"],
    "stats_read_ms.bulk": ["c10-fp32-bulk", "c10-int4-bulk"],
    "pricing_ms.bulk": ["c10-fp32-bulk", "c10-int4-bulk"],
    "engine_self_ms.bulk": ["c10-fp32-bulk", "c10-int4-bulk"],
    "dense_core_ms.bulk": ["c10-fp32-bulk", "c10-int4-bulk"],
    "sparse_core_ms.bulk": ["c10-fp32-bulk", "c10-int4-bulk"],
    "filler_share.open": ["c10-fp32-open"],
}
DEVICE = {"dense_core_ms.bulk", "sparse_core_ms.bulk"}


def _step(k, fillers=None, device=True):
    """A synthetic step record: step k's spans grow with k."""
    seconds = {"engine.step": 1.0 + k, "engine.session_step": 0.9 + k,
               "snn.skip_split": 0.5 + k, "snn.read": 0.01 * (k + 1), "snn.energy": 0.02 * (k + 1)}
    device_ms = {f"vgg9.{n}": (1.0 if n == "conv0" else 2.0) * (k + 1)
                 for n in ("conv0", "conv1", "conv2", "conv6", "fc0", "fc1")} if device else {}
    return {"step": k, "start_s": 0.0, "end_s": 1.0, "seconds": seconds, "parent": {},
            "counters": {} if fillers is None else {"snn.fillers": fillers},
            "device_ms": device_ms}


def _readings(steps, slots=8, warm=0, step_s=1.0):
    """Readings of a run whose engine stepped ``warm`` unread times, then
    once per synthetic record of ``steps`` (each ``step_s`` from outside)."""
    tracer = trace.Tracer()
    for step in [_step(1000, fillers=8) for _ in range(warm)] + steps:
        with tracer.record_step(step["step"]) as record:
            for key in ("seconds", "counters", "device_ms"):
                getattr(record, key).update(step[key])
    return Readings("closed", {}, {"engine": {"slots": slots}},
                    step_s=[step_s] * len(steps))


@pytest.mark.parametrize("metric", sorted(NEW))
def test_reader_is_none_without_step_records(metric):
    assert registry.reader(REPO, metric)(_readings([])) is None


@pytest.mark.parametrize("metric", sorted(NEW))
def test_reader_is_none_on_a_program_without_step_records(metric, monkeypatch):
    r = _readings([_step(k, fillers=1) for k in range(3)])
    monkeypatch.delattr(trace, "latest_steps")
    assert registry.reader(REPO, metric)(r) is None


@pytest.mark.parametrize("metric", sorted(NEW))
def test_reader_is_none_on_records_longer_than_their_steps(metric):
    """Records that do not fit inside the run's own step times are another
    run's (a process that served twice): nothing is read from them."""
    r = _readings([_step(k, fillers=1) for k in range(3)], step_s=0.0)
    assert registry.reader(REPO, metric)(r) is None


EXPECTED = {                         # medians over the steps k = 0, 1, 2
    "skip_split_ms.bulk": 1500.0,
    "skip_split_ms.open": 1500.0,
    "stats_read_ms.bulk": 20.0,
    "pricing_ms.bulk": 40.0,
    "engine_self_ms.bulk": 100.0,
    "dense_core_ms.bulk": 2.0,
    "sparse_core_ms.bulk": 12.0,     # conv1 + conv2 + conv6, not conv0 or the FCs
    "filler_share.open": 25.0,       # 2 of 8 slots
}


@pytest.mark.parametrize("metric", sorted(NEW))
def test_reader_takes_the_median_over_steps(metric):
    steps = [_step(k, fillers=f) for k, f in enumerate((1, 2, 6))]
    assert registry.reader(REPO, metric)(_readings(steps)) == pytest.approx(EXPECTED[metric])


@pytest.mark.parametrize("metric", sorted(NEW))
def test_reader_leaves_out_the_warm_up_steps(metric):
    """The ring also holds the steps before the window: only the last, one
    per step the run timed, are read."""
    steps = [_step(k, fillers=f) for k, f in enumerate((1, 2, 6))]
    r = _readings(steps, warm=5)
    assert registry.reader(REPO, metric)(r) == pytest.approx(EXPECTED[metric])


def test_steps_without_a_reading_are_left_out():
    steps = [_step(0, fillers=None, device=False), _step(4, fillers=4)]
    r = _readings(steps)
    assert registry.reader(REPO, "filler_share.open")(r) == 50.0
    assert registry.reader(REPO, "sparse_core_ms.bulk")(r) == pytest.approx(30.0)
    assert registry.reader(REPO, "dense_core_ms.bulk")(_readings([_step(0, device=False)])) is None


def test_every_new_metric_is_an_entry_with_a_file():
    spec = registry.load_benchmark(REPO)
    entries = {m["name"]: m for m in spec["per_layer"]}
    for name, cells in NEW.items():
        m = entries[name]
        assert m["workloads"] == cells and m["source"] in ("program_span", "program_counter")
        assert (REPO / "bench" / "metrics" / f"{name.split('.')[0]}.py").is_file()
        assert callable(registry.reader(REPO, name))
    assert [m["name"] for m in spec["per_layer"][-len(NEW):]] == list(NEW)


@pytest.mark.parametrize("workload", ["c10-fp32-bulk", "c10-fp32-open"])
def test_traced_tiny_run_reads_the_program_spans(tmp_path, workload):
    root = make_root(tmp_path)
    result = cli.run_cell(root, workload, 2 ** 33 + 5, 0.3, True, device="cpu")
    assert result["correct"] is True
    expected = {name for name, cells in NEW.items() if workload in cells} - DEVICE
    assert expected <= set(result["metrics"])
    assert not DEVICE & set(result["metrics"])          # no device marks on the CPU
    json.loads(json.dumps(result))
