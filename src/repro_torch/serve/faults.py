"""Deterministic fault injection for the serving stack.

The ROADMAP's fleet-serving north star stands or falls on failure handling:
a wedged session, a NaN-poisoned kernel output, or a queue flood must not
take the engine down ("Reconsidering the energy efficiency of SNNs" makes
the broader point — claimed wins must hold under realistic operating
conditions, not just clean benchmark runs). This module is the harness that
*creates* those conditions on a reproducible schedule, so the chaos tests
in `tests/test_torch_faults.py` / `tests/test_torch_router.py` and
`chip_smoke.py`'s fleet phase are deterministic:

* `Fault` / `FaultPlan` — a declarative schedule of faults keyed to the
  wrapped session's *own step index* (not wall time), parseable from a
  compact CLI spec (``"wedge@3;nan@5:slot=0"``).
* `FaultyRunner` / `FaultySession` — a `ModelRunner` wrapper that delegates
  everything to the inner runner but applies the plan's active faults at
  each ``step()``: wedge (no progress, inner untouched), slow (advance an
  injectable clock before stepping), raise (a mid-step `FaultError`), nan
  (poison the *reported* outputs — the inner session state stays clean, so
  a cancel still yields clean partials).
* `TickClock` — a manually advanced clock; pair it with the ``slow`` fault
  so latency faults are visible to supervision without real sleeps.
* `flood_queue` — drive-side helper for the ``flood`` fault kind: slams
  requests into an engine/router until a target backlog is reached.

Faults corrupt only what crosses the reporting seam. Replaying the same
frozen `Request` on a healthy replica therefore reproduces the fault-free
outputs bit-identically — the property `serve.router.Router` relies on for
re-routing (and that the chaos tests assert).

A copy of the JAX package's serve/faults.py, kept so the port stands
alone. `poison` also takes a torch tensor and poisons it as a tensor on its
own device; the port's runners hand their outputs back as host numpy, so
none reaches it today.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Hashable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .api import (ModelRunner, QueueFull, Request, Result, RunnerSession,
                  StepBudget, StepReport)

KINDS = ("wedge", "slow", "raise", "nan", "flood")


class FaultError(RuntimeError):
    """Raised by a `FaultySession.step` executing a ``raise`` fault."""


@dataclasses.dataclass(frozen=True)
class Fault:
    """One scheduled fault.

    kind:    'wedge' — step makes no progress (inner session not advanced);
             'slow'  — advance the injected clock by ``seconds`` before the
                       (otherwise normal) inner step;
             'raise' — raise `FaultError(message)` mid-step;
             'nan'   — poison the reported outputs of ``slot`` (all slots
                       when None) with NaN after a normal inner step;
             'flood' — no-op at the session seam; callers query it via
                       `FaultPlan.active` and call `flood_queue`.
    start/stop: half-open step-index window [start, stop) in which the
             fault is active; ``stop=None`` means "from start onward".
    """
    kind: str
    start: int
    stop: Optional[int] = None
    slot: Optional[int] = None
    seconds: float = 1.0
    message: str = "injected fault"

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"choose from {KINDS}")

    def active_at(self, step: int) -> bool:
        return step >= self.start and (self.stop is None or step < self.stop)


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """An immutable schedule of `Fault`s, queried by step index."""

    faults: Tuple[Fault, ...] = ()

    def active(self, kind: str, step: int) -> Optional[Fault]:
        """First fault of ``kind`` active at ``step``, or None."""
        for f in self.faults:
            if f.kind == kind and f.active_at(step):
                return f
        return None

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        """Parse a compact plan spec.

        Grammar: ``fault(;fault)*`` where each fault is
        ``kind@start[-stop][:key=val(,key=val)*]`` — e.g.

            "wedge@3"                  wedge every step from 3 on
            "nan@5:slot=0"             NaN-poison slot 0 from step 5 on
            "slow@2-4:seconds=3.5"     steps 2 and 3 run 3.5 clock-s slow
            "wedge@3;nan@5:slot=1"     both
        """
        faults: List[Fault] = []
        for part in filter(None, (p.strip() for p in spec.split(";"))):
            head, _, opts = part.partition(":")
            kind, at, window = head.partition("@")
            if not at:
                raise ValueError(f"fault {part!r}: expected kind@start[-stop]")
            start_s, _, stop_s = window.partition("-")
            kwargs: Dict[str, Any] = {
                "kind": kind.strip(),
                "start": int(start_s),
                "stop": int(stop_s) if stop_s else None,
            }
            for kv in filter(None, (o.strip() for o in opts.split(","))):
                key, eq, val = kv.partition("=")
                if not eq:
                    raise ValueError(f"fault {part!r}: bad option {kv!r}")
                if key == "slot":
                    kwargs["slot"] = int(val)
                elif key == "seconds":
                    kwargs["seconds"] = float(val)
                elif key == "message":
                    kwargs["message"] = val
                else:
                    raise ValueError(f"fault {part!r}: unknown option {key!r}")
            faults.append(Fault(**kwargs))
        return cls(tuple(faults))


def parse_fleet_plan(spec: str) -> Dict[int, FaultPlan]:
    """Parse a per-replica plan spec: ``"1=wedge@3,2=nan@5:slot=0"``
    (replica index ``=`` plan; plans themselves use ``;`` separators, so
    ``,`` splits replicas). Used by ``launch/serve.py --fault-plan``."""
    plans: Dict[int, FaultPlan] = {}
    for part in filter(None, (p.strip() for p in spec.split(","))):
        idx_s, eq, plan_s = part.partition("=")
        if not eq:
            raise ValueError(f"fleet plan {part!r}: expected IDX=PLAN")
        idx = int(idx_s)
        merged = plans.get(idx, FaultPlan()).faults
        plans[idx] = FaultPlan(merged + FaultPlan.parse(plan_s).faults)
    return plans


class TickClock:
    """A manually advanced engine clock (seconds start at 0.0).

    Unlike `serve.core.StepClock` it is not tied to an engine's step count:
    a router shares one TickClock across all replicas, and the ``slow``
    fault advances it mid-step so latency faults show up in the measured
    step seconds deterministically."""

    def __init__(self, t: float = 0.0):
        self.t = float(t)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> float:
        self.t += float(dt)
        return self.t


# -- NaN poisoning ------------------------------------------------------------

def poison(value):
    """A NaN-poisoned copy of ``value``, preserving its shape: numbers
    become NaN, arrays are NaN-filled, containers recurse. Non-numeric
    leaves (strings, bools, None) pass through — the point is to corrupt
    the numeric payload the way a bad kernel would, not the metadata."""
    if isinstance(value, bool) or value is None or isinstance(value, (str, bytes)):
        return value
    if isinstance(value, (int, float)):
        return float("nan")
    if isinstance(value, dict):
        return {k: poison(v) for k, v in value.items()}
    if isinstance(value, tuple):
        return tuple(poison(v) for v in value)
    if isinstance(value, list):
        return [poison(v) for v in value]
    if isinstance(value, torch.Tensor):
        # on its own device: np.asarray would raise on a CUDA tensor
        if value.is_floating_point() or value.is_complex():
            return torch.full_like(value, float("nan"))
        return torch.full(value.shape, float("nan"), dtype=torch.float32,
                          device=value.device)
    if hasattr(value, "dtype"):
        arr = np.asarray(value)
        if np.issubdtype(arr.dtype, np.floating) or \
                np.issubdtype(arr.dtype, np.complexfloating):
            return np.full_like(arr, np.nan)
        return np.full(arr.shape, np.nan, dtype=np.float32)
    return value


def _poison_report(report: StepReport, slot: Optional[int]) -> StepReport:
    """Poison the reported outputs of ``slot`` (all slots when None)."""
    progress = dict(report.progress)
    finished = dict(report.finished)
    targets = [slot] if slot is not None else list(progress) + list(finished)
    for idx in targets:
        prog = progress.get(idx)
        if prog is not None and prog.emitted:
            progress[idx] = dataclasses.replace(
                prog, emitted=tuple(poison(e) for e in prog.emitted))
        res = finished.get(idx)
        if res is not None:
            finished[idx] = dataclasses.replace(res, outputs=poison(res.outputs))
    return StepReport(finished=finished, progress=progress, cost=report.cost)


# -- the wrapper runner -------------------------------------------------------

class FaultySession:
    """`RunnerSession` wrapper applying a `FaultPlan` at each step.

    Keeps its own step index (0-based, incremented on every ``step()`` call
    whether or not the inner session ran) so plans are phrased in the
    replica's local step count. Only the *reported* outputs are corrupted;
    the inner session's state stays clean — ``cancel`` yields the inner
    session's untouched partial result.
    """

    def __init__(self, inner: RunnerSession, plan: FaultPlan,
                 clock: Optional[TickClock] = None):
        self.inner = inner
        self.plan = plan
        self.clock = clock
        self.step_idx = 0

    def admit(self, slot: int, request: Request) -> Optional[Result]:
        return self.inner.admit(slot, request)

    def cancel(self, slot: int) -> Result:
        return self.inner.cancel(slot)

    def step(self, budget: StepBudget) -> StepReport:
        idx = self.step_idx
        self.step_idx += 1
        fault = self.plan.active("raise", idx)
        if fault is not None:
            raise FaultError(f"{fault.message} (step {idx})")
        if self.plan.active("wedge", idx) is not None:
            # no progress, inner untouched: the heartbeat failure mode
            return StepReport(cost={"units": 0})
        fault = self.plan.active("slow", idx)
        if fault is not None and self.clock is not None:
            self.clock.advance(fault.seconds)
        report = self.inner.step(budget)
        fault = self.plan.active("nan", idx)
        if fault is not None:
            report = _poison_report(report, fault.slot)
        return report


class FaultyRunner:
    """`ModelRunner` wrapper: delegates everything, opens `FaultySession`s.

    One plan per runner; a fresh wrapper per replica gives each replica its
    own schedule (`parse_fleet_plan`). With an empty plan the wrapper is
    transparent — `serve.router.make_router` wraps every replica uniformly
    so replica behavior differs only by plan.
    """

    def __init__(self, inner: ModelRunner, plan: Optional[FaultPlan] = None,
                 clock: Optional[TickClock] = None):
        self.inner = inner
        self.plan = plan if plan is not None else FaultPlan()
        self.clock = clock

    def bucket_key(self, request: Request) -> Hashable:
        return self.inner.bucket_key(request)

    def filler(self, request: Request) -> Request:
        return self.inner.filler(request)

    def run(self, batch: Sequence[Request]) -> Sequence[Result]:
        return self.inner.run(batch)

    def session_key(self, request: Request) -> Hashable:
        return self.inner.session_key(request)

    def open_session(self, slots: int) -> FaultySession:
        return FaultySession(self.inner.open_session(slots), self.plan,
                             self.clock)


def flood_queue(target, payload, *, count: Optional[int] = None,
                priority: int = 0, **options) -> List[int]:
    """Drive-side implementation of the ``flood`` fault: submit copies of
    ``payload`` until ``target`` stops admitting (its queue is full / the
    router starts shedding) or ``count`` submissions went in. ``target`` is
    anything with ``submit(payload, **options)`` — an `EngineCore` (stops at
    `QueueFull`) or a `serve.router.Router` (never raises; stops after
    ``count``, which is required then). Returns the submitted request ids."""
    if count is None:
        if not hasattr(target, "config"):
            raise ValueError("flood_queue(count=None) needs a QueueFull-"
                             "raising target; pass count= for routers")
        count = math.inf
    rids: List[int] = []
    while len(rids) < count:
        try:
            rids.append(target.submit(payload, priority=priority, **options))
        except QueueFull:
            break
    return rids
