"""Flight recorder: a bounded ring of recent step activity per replica.

When a replica wedges, poisons its numerics, or its worker dies, the
interesting evidence is the handful of steps *before* the failure — the
`api.StepReport`s, the scheduler's admissions, and the precision
controller's choices that led up to it. The recorder keeps exactly that: a
``deque(maxlen=N)`` of summarized step frames plus a parallel ring of
decision notes, and a ``dump()`` that freezes both into a JSON-able
postmortem the router attaches to its ``drain_log``.

Frames are *summaries*, not the reports themselves: slot -> (request id,
phase, units) and the step's cost dict — no output tensors — so a frame is
cheap to keep, wire-encodable for worker heartbeats (NaN costs included;
the tagged codec round-trips them), and safe to hold after the engine
moved on. Recording is append-only on engine-owned values; the recorder
never reads engine state itself, preserving the no-perturbation contract.
"""
from __future__ import annotations

import collections
from typing import Any, Dict, List, Mapping, Optional


def summarize_report(report: Any) -> Dict[str, Any]:
    """`api.StepReport` -> JSON-able frame body (no output tensors)."""
    return {
        "cost": dict(report.cost),
        "finished": {int(idx): {"rid": res.request_id, "status": res.status}
                     for idx, res in report.finished.items()},
        "progress": {int(idx): {"rid": p.request_id, "phase": p.phase,
                                "done": p.units_done, "total": p.units_total}
                     for idx, p in report.progress.items()},
    }


class FlightRecorder:
    """Ring buffer of the last ``capacity`` step frames + decision notes.

    dumps: every postmortem produced so far (`dump` appends and returns) —
    the router lifts these into ``drain_log`` details; `EngineCore` dumps
    on `EngineStalled` and on a numerics-poison retirement.
    """

    def __init__(self, capacity: int = 64):
        self.capacity = int(capacity)
        self.frames: "collections.deque[Dict[str, Any]]" = \
            collections.deque(maxlen=self.capacity)
        self.notes: "collections.deque[Dict[str, Any]]" = \
            collections.deque(maxlen=self.capacity)
        self.dumps: List[Dict[str, Any]] = []

    def record(self, step: int, report: Any, *, seconds: float = 0.0,
               queue_len: int = 0, occupied: int = 0) -> None:
        """Capture one engine step's `StepReport` summary."""
        frame = summarize_report(report)
        frame.update(step=int(step), seconds=float(seconds),
                     queue=int(queue_len), occupied=int(occupied))
        self.frames.append(frame)

    def note(self, step: int, kind: str, **detail: Any) -> None:
        """Record one scheduler/precision decision (e.g. ``kind='admit'``
        with the admitted request ids, ``kind='precision'`` with the
        controller's choice + reason)."""
        self.notes.append({"step": int(step), "kind": kind, **detail})

    def tail(self, n: Optional[int] = None) -> List[Dict[str, Any]]:
        frames = list(self.frames)
        return frames if n is None else frames[-n:]

    def dump(self, reason: str, *, step: Optional[int] = None,
             extra: Optional[Mapping[str, Any]] = None) -> Dict[str, Any]:
        """Freeze the rings into one postmortem record."""
        record = {
            "reason": reason,
            "step": step if step is not None else (
                self.frames[-1]["step"] if self.frames else None),
            "frames": list(self.frames),
            "notes": list(self.notes),
        }
        if extra:
            record.update(dict(extra))
        self.dumps.append(record)
        return record
