"""Find a cell's parts by name: `BENCHMARK.json` names them, files hold them.

A cell (an entry of ``workloads``) names a configuration and a traffic mix;
its metrics are the ``end_to_end`` and ``per_layer`` entries that apply to
it. Each part sits in a file of its own under ``bench/``, found by its name:

* configuration: the ``file`` its ``configs`` entry gives (sizes, the
  family whose system and reference run it, the comparison's limits);
* traffic mix: ``bench/traffic/<traffic>.json``, data only: its ``kind``
  names the driver, the other keys are that driver's parameters;
* driver: ``bench/drivers/<kind>.py``, with ``MIX_KEYS`` (every key of a
  mix it reads) and ``run``. A mix key that its driver does not read is
  refused, so a mix never runs as something it does not say;
* arrival law (open loops): ``bench/arrivals/<law>.py``, with ``KEYS`` and
  ``offsets(seed, spec, seconds)``, named by the mix's ``arrivals.law``;
* metric: ``bench/metrics/<name>.py``, else ``bench/metrics/<base>.py``
  where ``<base>`` is the name up to its first dot (``idle_share.py``
  reads ``idle_share.bulk`` and ``idle_share.open``): a reader with
  ``read(readings)`` that returns a number, or None where it finds nothing
  to read. `BENCHMARK.json` alone says which cells a metric is read in;
* reference: ``bench/reference/<family>.py``.

So a later cell, mix, driver, arrival law or metric is added by adding
files and entries. Nothing here needs a card or imports the program.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path
from typing import Dict, List

BENCH_DIR = "bench"
_SAFE = re.compile(r"[^A-Za-z0-9_]")


@dataclasses.dataclass
class Metric:
    name: str
    unit: str


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    end_to_end: List[Metric]
    per_layer: List[Metric]
    root: Path

    @property
    def kind(self) -> str:
        return self.traffic["kind"]

    def metrics(self, trace: bool) -> List[Metric]:
        return self.per_layer if trace else self.end_to_end


def load_benchmark(root: Path) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def _applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def resolve(root: Path, workload: str) -> Cell:
    """The cell named ``workload`` with its configuration, traffic and
    metrics read from their files. Raises KeyError for an unknown name."""
    root = Path(root)
    spec = load_benchmark(root)
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((root / BENCH_DIR / "traffic" / f"{w['traffic']}.json").read_text())

    def metric(entry: dict) -> Metric:
        return Metric(entry["name"], entry["unit"])

    return Cell(
        name=workload, chips=int(w["chips"]),
        config_name=w["config"], config=config,
        traffic_name=w["traffic"], traffic=traffic,
        end_to_end=[metric(m) for m in spec["end_to_end"] if _applies(m, workload)],
        per_layer=[metric(m) for m in spec["per_layer"] if _applies(m, workload)],
        root=root)


def _load_file(path: Path, prefix: str):
    if not path.is_file():
        raise FileNotFoundError(f"{path} not found")
    name = f"_bench_{prefix}_{_SAFE.sub('_', path.stem)}"
    module_spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(module_spec)
    module_spec.loader.exec_module(module)
    return module


def reader(root: Path, metric: str):
    """The reader of ``metric``: ``read`` of ``bench/metrics/<metric>.py``,
    or of ``bench/metrics/<base>.py`` where that file is missing."""
    folder = Path(root) / BENCH_DIR / "metrics"
    path = folder / f"{metric}.py"
    if not path.is_file():
        path = folder / f"{metric.split('.')[0]}.py"
    return _load_file(path, "metric").read


def _refuse_unknown(what: str, given, known) -> None:
    unknown = sorted(set(given) - set(known))
    if unknown:
        raise ValueError(f"{what} has keys its code does not read: {unknown} "
                         f"(it reads {sorted(known)})")


def driver(cell: Cell):
    """The driver module of ``cell``'s mix (``bench/drivers/<kind>.py``),
    after checking that it reads every key the mix gives."""
    module = _load_file(cell.root / BENCH_DIR / "drivers" / f"{cell.kind}.py", "driver")
    _refuse_unknown(f"traffic mix {cell.traffic_name!r}", cell.traffic,
                    {"about", "kind", *module.MIX_KEYS})
    return module


def arrivals(root: Path, spec: dict):
    """The arrival law that ``spec`` names (``bench/arrivals/<law>.py``),
    after checking that it reads every key ``spec`` gives."""
    module = _load_file(Path(root) / BENCH_DIR / "arrivals" / f"{spec['law']}.py", "arrivals")
    _refuse_unknown(f"arrival law {spec['law']!r}", spec, {"law", *module.KEYS})
    return module


def reference(root: Path, family: str):
    """The plain reference module of a configuration family."""
    return _load_file(Path(root) / BENCH_DIR / "reference" / f"{family}.py", "reference")


def plan(cell: Cell) -> Dict[str, object]:
    """What a run of ``cell`` would do, resolved without a card: the driver
    and arrival law with the mix's keys checked, the configuration, and
    each metric with its reader found."""
    readers = {m.name: reader(cell.root, m.name) for m in cell.end_to_end + cell.per_layer}
    module = driver(cell)
    law = cell.traffic.get("arrivals")
    if law is not None:
        arrivals(cell.root, law)
    return {"cell": cell.name, "chips": cell.chips, "driver": cell.kind,
            "driver_file": Path(module.__file__).name,
            "arrivals": law["law"] if law is not None else None,
            "family": cell.config["family"], "config": cell.config_name,
            "traffic": cell.traffic_name,
            "reference": reference(cell.root, cell.config["family"]).__name__,
            "end_to_end": [m.name for m in cell.end_to_end],
            "per_layer": [m.name for m in cell.per_layer],
            "readers": sorted(readers)}
