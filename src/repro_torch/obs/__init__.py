"""Observability plane: tracing + typed metrics + flight recorder.

One `Observability` bundle rides an `EngineCore` (or a `Router`) and turns
the values the engine already computed into three artifacts:

* a request-lifecycle **trace** (`obs.trace.Tracer` — submit -> admit ->
  prefill-chunk* -> decode|speculate|infer -> terminal status), and the
  tracer's **step records** (`Tracer.steps` — per engine step, the seconds
  of each named phase inside it, counters, and device milliseconds per
  model layer on a card; see `obs.trace`),
* a typed **metrics** snapshot (`obs.metrics.MetricsRegistry` — goodput
  counters, queue gauges, step-seconds histograms, plus whatever the
  scheduler / precision controller publish through ``metrics_into``),
* a **flight recorder** ring (`obs.recorder.FlightRecorder` — the last N
  step frames + decisions, dumped on `EngineStalled`, numerics poison and
  `WorkerDied`).

The contract, tested in ``tests/test_torch_obs.py``: attached
vs. detached is **bit-identical** on every `Result` and every scheduler
decision. The hooks only *receive* values (clock readings, reports,
results) that the engine read anyway — nothing here reads the engine's
clock, advances an RNG, or mutates engine state. Step records read
``time.perf_counter`` (and, on a card, record CUDA events), never the
engine's clock, and the engine keeps them only while a tracer is
attached.

Hook order per engine step (see `serve/core.py`):

    on_submit(rid)  ->  on_admit(rids)  ->  on_step(report, ...)
        ->  on_retire(result) per retirement  ->  on_dump(reason) on faults

Fleet story: each replica owns one bundle; `wire_telemetry()` emits the
*increment* (newly closed spans, current metrics snapshot, fresh recorder
dumps) that worker heartbeats carry; the router folds replicas together
with `merge_traces` + `metrics.aggregate`.

Pure Python: a copy of the JAX package's obs/, kept so the port stands
alone; the port's router and worker fleet (`repro_torch.serve.router`)
fold replica telemetry as the reference's do.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Iterable, List, Optional, Sequence

from .metrics import (Counter, Gauge, Histogram, MetricsRegistry, aggregate,
                      to_prometheus)
from .recorder import FlightRecorder, summarize_report
from .trace import Span, Tracer, merge_traces

__all__ = [
    "Observability", "Tracer", "Span", "merge_traces",
    "MetricsRegistry", "Counter", "Gauge", "Histogram", "aggregate",
    "to_prometheus", "FlightRecorder", "summarize_report",
]

#: Result.stats keys summed into served-energy counters (both cost models)
_ENERGY_KEYS = (("served_energy_j", "precision_served_energy_eq3_j",
                 "Eq. 3 served energy of retired requests (J)"),
                ("served_energy_analytical_j",
                 "precision_served_energy_analytical_j",
                 "analytical per-op served energy of retired requests (J)"))


class Observability:
    """Bundle of tracer + metrics + recorder with engine-shaped hooks.

    Any pillar can be disabled (``trace=False``, ``metrics=False``,
    ``recorder=0``); hooks skip the missing pieces. ``attach_engine``
    registers pull collectors for the scheduler's and precision
    controller's ``metrics_into`` and remembers the controller so its
    per-request decisions land in the recorder's notes.
    """

    def __init__(self, *, trace: bool = True, metrics: bool = True,
                 recorder: int = 64):
        self.tracer: Optional[Tracer] = Tracer() if trace else None
        self.metrics: Optional[MetricsRegistry] = \
            MetricsRegistry() if metrics else None
        self.recorder: Optional[FlightRecorder] = \
            FlightRecorder(recorder) if recorder else None
        self._controller = None      # PrecisionController, if the engine has one
        self._decisions_seen = 0     # controller.decisions already noted
        self._dumps_shipped = 0      # recorder.dumps already sent over the wire
        self._units_seen: Dict[int, int] = {}   # rid -> last units_done

    # -- attachment ---------------------------------------------------------

    def attach_engine(self, core: Any) -> None:
        """Probe ``core`` for metric publishers; never mutates it."""
        if self.metrics is not None:
            publish = getattr(getattr(core, "scheduler", None),
                              "metrics_into", None)
            if callable(publish):
                self.metrics.collectors.append(
                    lambda reg, _p=publish: _p(reg))
        controller = getattr(getattr(core, "runner", None), "controller", None)
        if controller is not None:
            self._controller = controller
            publish = getattr(controller, "metrics_into", None)
            if self.metrics is not None and callable(publish):
                self.metrics.collectors.append(
                    lambda reg, _p=publish: _p(reg))

    # -- engine hooks -------------------------------------------------------

    def on_submit(self, rid: int, step: int, now: float,
                  **attrs: Any) -> None:
        if self.tracer is not None:
            self.tracer.begin(rid, step, now, **attrs)
        if self.metrics is not None:
            self.metrics.counter(
                "engine_submitted", "requests accepted into the queue").inc()

    def on_admit(self, rids: Sequence[int], step: int, now: float) -> None:
        if not rids:
            return
        if self.tracer is not None:
            for rid in rids:
                self.tracer.admit(rid, step, now)
        if self.metrics is not None:
            self.metrics.counter(
                "engine_admitted", "requests admitted into slots").inc(
                    len(rids))
        if self.recorder is not None:
            self.recorder.note(step, "admit", rids=list(rids))

    def on_step(self, report: Any, *, step: int, now: float, seconds: float,
                queue_len: int, occupied: int,
                poisoned: Iterable[int] = ()) -> None:
        """One engine step ran. ``step``/``now``/``seconds`` are the
        engine's own readings; ``poisoned`` the request ids whose slots
        failed the numerics screen this step."""
        cost = report.cost
        if self.recorder is not None:
            self.recorder.record(step, report, seconds=seconds,
                                 queue_len=queue_len, occupied=occupied)
            self._note_precision_decisions(step)
            poisoned = list(poisoned)
            if poisoned:
                self.recorder.note(step, "poison", rids=poisoned)
        if self.tracer is not None:
            speculated = cost.get("drafted_tokens", 0) > 0
            for prog in report.progress.values():
                rid = prog.request_id
                prev = self._units_seen.get(rid, 0)
                self._units_seen[rid] = prog.units_done
                emitted = len(prog.emitted)
                # prompt tokens consumed this step: the units advance not
                # explained by emissions. `SlotProgress.phase` flips to
                # 'decode' *on* the step that finishes the prompt, so the
                # delta — not the label — decides whether this step was a
                # prefill chunk (== the `prefill_chunks` stat).
                consumed = max(0, prog.units_done - prev - emitted)
                if consumed > 0:
                    self.tracer.phase(rid, "prefill", step, now,
                                      units=consumed)
                if emitted > 0:
                    name = ("speculate"
                            if speculated and prog.phase == "decode"
                            else prog.phase)
                    self.tracer.phase(rid, name, step, now, units=emitted)
        if self.metrics is not None:
            m = self.metrics
            m.counter("engine_steps", "engine steps executed").inc()
            for key, help in (("units", "budget units consumed"),
                              ("prompt_tokens", "prompt tokens prefilled"),
                              ("decode_tokens", "decode tokens emitted"),
                              ("drafted_tokens", "draft tokens proposed"),
                              ("accepted_tokens", "draft tokens accepted")):
                amount = float(cost.get(key, 0) or 0)
                if amount > 0:
                    m.counter(f"engine_{key}", help).inc(amount)
            m.gauge("engine_queue_depth", "waiting requests").set(queue_len)
            m.gauge("engine_occupied_slots", "slots holding a request").set(
                occupied)
            m.histogram("engine_step_seconds",
                        "wall seconds per engine step").observe(seconds)

    def on_retire(self, result: Any, step: int, now: float) -> None:
        """A request reached a terminal status (any of `trace.TERMINAL`)."""
        self._units_seen.pop(result.request_id, None)
        if self.tracer is not None:
            self.tracer.end(result.request_id, result.status, step, now)
        if self.metrics is not None:
            self.metrics.counter(
                f"engine_retired_{result.status}",
                f"requests retired with status={result.status}").inc()
            for stats_key, metric, help in _ENERGY_KEYS:
                joules = result.stats.get(stats_key)
                if joules is not None and math.isfinite(joules):
                    self.metrics.counter(metric, help).inc(float(joules))

    def on_dump(self, reason: str, step: int,
                **extra: Any) -> Optional[Dict[str, Any]]:
        """Fault boundary hit ('stalled' | 'numerics-poison' |
        'worker-died' | ...): freeze the recorder rings."""
        if self.metrics is not None:
            self.metrics.counter(
                "recorder_dumps", "flight-recorder postmortems taken").inc()
        if self.recorder is None:
            return None
        return self.recorder.dump(reason, step=step, extra=extra or None)

    def _note_precision_decisions(self, step: int) -> None:
        controller = self._controller
        if controller is None or self.recorder is None:
            return
        decisions = getattr(controller, "decisions", ())
        for decision in decisions[self._decisions_seen:]:
            self.recorder.note(step, "precision",
                               rid=decision.request_id,
                               precision=decision.precision,
                               reason=decision.reason)
        self._decisions_seen = len(decisions)

    # -- export -------------------------------------------------------------

    def wire_telemetry(self) -> Dict[str, Any]:
        """The per-heartbeat increment a worker ships to its parent:
        newly closed spans, the current metrics snapshot, fresh recorder
        dumps, and a short frame tail (postmortem cushion if the process
        dies before its next heartbeat)."""
        telemetry: Dict[str, Any] = {}
        if self.tracer is not None:
            telemetry["spans"] = self.tracer.drain()
        if self.metrics is not None:
            telemetry["metrics"] = self.metrics.snapshot()
        if self.recorder is not None:
            telemetry["frames"] = self.recorder.tail(16)
            fresh = self.recorder.dumps[self._dumps_shipped:]
            if fresh:
                telemetry["dumps"] = list(fresh)
            self._dumps_shipped = len(self.recorder.dumps)
        return telemetry

    def snapshot(self) -> Dict[str, Any]:
        """Everything, in place (in-process consumers / `--metrics`)."""
        out: Dict[str, Any] = {}
        if self.tracer is not None:
            out["trace"] = self.tracer.export()
        if self.metrics is not None:
            out["metrics"] = self.metrics.snapshot()
        if self.recorder is not None:
            out["dumps"] = list(self.recorder.dumps)
        return out
