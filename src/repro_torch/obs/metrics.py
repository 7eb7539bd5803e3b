"""Typed metrics registry: counters, gauges, histograms + fleet aggregation.

The serving stack's measurements used to live in ad-hoc ``stats()`` dicts
(engine goodput, router drain counts, scheduler EWMAs, precision-controller
tallies) with no shared naming, typing, or export path. This registry is
that shared surface:

* **typed** — a name is registered once with one kind; re-registering it as
  a different kind raises (``engine_decode_tokens`` can never silently flip
  from counter to gauge between PRs).
* **pull-friendly** — ``snapshot()`` is a plain JSON-able dict; components
  that learn state privately (schedulers, the precision controller) expose
  a ``metrics_into(registry)`` hook called at snapshot time, so observing
  them costs nothing on the hot path and cannot perturb their decisions.
* **aggregable** — `aggregate` folds per-replica snapshots into one fleet
  snapshot (counters/histograms sum, gauges sum with a per-replica
  breakdown), and `to_prometheus` renders any snapshot in the Prometheus
  text exposition format for scrape-shaped consumers.

Naming convention: ``<component>_<quantity>[_<unit>]`` — e.g.
``engine_decode_tokens``, ``router_drains``, ``scheduler_skip_ewma``,
``precision_served_energy_j``. The full table lives in
``docs/architecture.md``.
"""
from __future__ import annotations

import json
import math
from typing import Any, Dict, List, Mapping, Optional, Sequence

#: default histogram bucket upper bounds (engine-clock seconds / work units)
DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0)


class Counter:
    """Monotonically increasing total."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease "
                             f"({amount})")
        self.value += amount

    def snapshot(self) -> Dict[str, Any]:
        return {"kind": self.kind, "value": self.value, "help": self.help}


class Gauge:
    """Point-in-time value (queue depth, EWMA, occupancy)."""

    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)

    def snapshot(self) -> Dict[str, Any]:
        return {"kind": self.kind, "value": self.value, "help": self.help}


class Histogram:
    """Cumulative-bucket distribution (Prometheus semantics: each bucket
    counts observations <= its bound; +Inf is implicit via ``count``)."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        self.name = name
        self.help = help
        self.bounds = tuple(sorted(float(b) for b in buckets))
        self.bucket_counts = [0] * len(self.bounds)
        self.count = 0
        self.sum = 0.0

    def observe(self, value: float) -> None:
        value = float(value)
        self.count += 1
        self.sum += value
        for i, bound in enumerate(self.bounds):
            if value <= bound:
                self.bucket_counts[i] += 1

    def snapshot(self) -> Dict[str, Any]:
        return {"kind": self.kind, "help": self.help,
                "count": self.count, "sum": self.sum,
                "buckets": {repr(b): c for b, c in
                            zip(self.bounds, self.bucket_counts)}}


class MetricsRegistry:
    """Get-or-create registry of typed metrics, keyed by name."""

    def __init__(self):
        self._metrics: Dict[str, Any] = {}
        #: callables ``fn(registry)`` run at the top of every ``snapshot()``
        #: — the pull hook stateful components (schedulers, the precision
        #: controller) use to publish their learned state without being
        #: touched on the hot path.
        self.collectors: List[Any] = []

    def _get(self, cls, name: str, help: str, **kwargs):
        metric = self._metrics.get(name)
        if metric is None:
            metric = cls(name, help, **kwargs)
            self._metrics[name] = metric
        elif not isinstance(metric, cls):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{metric.kind}, not {cls.kind}")
        return metric

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get(Histogram, name, help, buckets=buckets)

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        """Run every collector, then export all metrics as one JSON-able
        mapping ``{name: {kind, value | count/sum/buckets, help}}``."""
        for collect in self.collectors:
            collect(self)
        return {name: m.snapshot()
                for name, m in sorted(self._metrics.items())}

    def to_json(self, **dump_kwargs: Any) -> str:
        return json.dumps(self.snapshot(), sort_keys=True, **dump_kwargs)

    def to_prometheus(self) -> str:
        return to_prometheus(self.snapshot())


def _fmt(value: float) -> str:
    if value != value:
        return "NaN"
    if value in (math.inf, -math.inf):
        return "+Inf" if value > 0 else "-Inf"
    if float(value).is_integer():
        return str(int(value))
    return repr(float(value))


def to_prometheus(snapshot: Mapping[str, Mapping[str, Any]],
                  labels: Optional[Mapping[str, str]] = None) -> str:
    """Render a snapshot (from `MetricsRegistry.snapshot` or `aggregate`)
    in the Prometheus text exposition format."""
    label_str = ""
    if labels:
        inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
        label_str = "{" + inner + "}"
    lines: List[str] = []
    for name, m in sorted(snapshot.items()):
        if m.get("help"):
            lines.append(f"# HELP {name} {m['help']}")
        lines.append(f"# TYPE {name} {m['kind']}")
        if m["kind"] == "histogram":
            for bound, count in m["buckets"].items():
                le = ('{le="%s"}' % bound) if not labels else \
                    label_str[:-1] + f',le="{bound}"}}'
                lines.append(f"{name}_bucket{le} {_fmt(count)}")
            inf_le = '{le="+Inf"}' if not labels else \
                label_str[:-1] + ',le="+Inf"}'
            lines.append(f"{name}_bucket{inf_le} {_fmt(m['count'])}")
            lines.append(f"{name}_sum{label_str} {_fmt(m['sum'])}")
            lines.append(f"{name}_count{label_str} {_fmt(m['count'])}")
        else:
            lines.append(f"{name}{label_str} {_fmt(m['value'])}")
    return "\n".join(lines) + "\n"


def aggregate(parts: Mapping[Any, Mapping[str, Mapping[str, Any]]]
              ) -> Dict[str, Dict[str, Any]]:
    """Fold per-replica snapshots into one fleet snapshot.

    Counters and histograms sum across replicas (totals are additive);
    gauges sum too (queue depths, occupancies and counts-as-gauges are
    additive fleet-wide) but additionally keep a ``per_replica`` breakdown
    so non-additive gauges (EWMAs) stay inspectable per replica.
    """
    out: Dict[str, Dict[str, Any]] = {}
    for label, snapshot in parts.items():
        for name, m in snapshot.items():
            agg = out.get(name)
            if agg is None:
                if m["kind"] == "histogram":
                    agg = {"kind": "histogram", "help": m.get("help", ""),
                           "count": 0, "sum": 0.0,
                           "buckets": {b: 0 for b in m["buckets"]}}
                else:
                    agg = {"kind": m["kind"], "help": m.get("help", ""),
                           "value": 0.0}
                    if m["kind"] == "gauge":
                        agg["per_replica"] = {}
                out[name] = agg
            if m["kind"] != agg["kind"]:
                raise TypeError(f"metric {name!r} is {m['kind']} on replica "
                                f"{label!r} but {agg['kind']} elsewhere")
            if m["kind"] == "histogram":
                agg["count"] += m["count"]
                agg["sum"] += m["sum"]
                for bound, count in m["buckets"].items():
                    agg["buckets"][bound] = agg["buckets"].get(bound, 0) + count
            else:
                agg["value"] += m["value"]
                if m["kind"] == "gauge":
                    agg["per_replica"][str(label)] = m["value"]
    return out
