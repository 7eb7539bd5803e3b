"""Request-lifecycle tracing: deterministic spans over the engine clock.

A trace is a list of `Span`s with parent/child ids covering one request's
life through the serving stack:

    request (root, opened at submit, closed with the terminal status)
      queued            submit -> admission (or straight to the terminal
                        status for requests retired from the queue)
      serve             admission -> retirement
        prefill-chunk   one span per engine step that consumed prompt
                        tokens for the request (== ``prefill_chunks``)
        decode|speculate|infer
                        one coalesced span per contiguous phase run
                        ('speculate' when the step's cost showed drafted
                        tokens, 'infer' for the SNN's fused step)

Timestamps are whatever clock the engine runs (`core.StepClock` /
`faults.TickClock` in tests and benches), recorded from values the engine
*already read* — the tracer never touches a clock itself, so attaching it
cannot perturb deadlines or scheduling (the no-perturbation contract
`tests/test_torch_obs.py` asserts bit-identically).

Fleet traces: each replica traces locally; `Tracer.drain` hands closed
spans to the transport (in-process directly, over the wire via the
heartbeat's telemetry field) and `merge_traces` namespaces span ids by
replica label into one ordered trace for the whole run.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

#: terminal statuses a root span may close with (mirrors `api.Result.status`
#: plus the router-side 'rejected')
TERMINAL = ("ok", "cancelled", "expired", "failed", "rejected")


@dataclasses.dataclass
class Span:
    """One lifecycle span. ``start_s``/``end_s`` are engine-clock stamps;
    ``start_step``/``end_step`` engine step indices (router step indices
    for router-level spans)."""
    span_id: int
    parent_id: Optional[int]
    request_id: int
    name: str
    start_step: int
    start_s: float
    end_step: Optional[int] = None
    end_s: Optional[float] = None
    status: str = ""
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def closed(self) -> bool:
        return self.end_step is not None

    def to_dict(self) -> Dict[str, Any]:
        return {
            "span_id": self.span_id, "parent_id": self.parent_id,
            "request_id": self.request_id, "name": self.name,
            "start_step": self.start_step, "start_s": self.start_s,
            "end_step": self.end_step, "end_s": self.end_s,
            "status": self.status, "attrs": dict(self.attrs),
        }


class Tracer:
    """Per-engine (or per-router) span recorder.

    All methods take the clock value and step index as arguments — the
    caller passes readings it already made. Unknown request ids are
    ignored (a request may retire from the queue without ever being
    admitted, or a replica may join a trace mid-life after a re-route).
    """

    def __init__(self):
        self._next_id = 0
        self.spans: List[Span] = []          # every span, open or closed
        self._root: Dict[int, Span] = {}     # request_id -> open root
        self._serve: Dict[int, Span] = {}    # request_id -> open serve span
        self._queued: Dict[int, Span] = {}   # request_id -> open queued span
        self._phase: Dict[int, Span] = {}    # request_id -> open phase span
        self._drained = 0                    # spans[:_drained] already shipped

    def _open(self, name: str, rid: int, step: int, now: float,
              parent: Optional[Span] = None, **attrs: Any) -> Span:
        span = Span(self._next_id,
                    None if parent is None else parent.span_id,
                    rid, name, step, now, attrs=attrs)
        self._next_id += 1
        self.spans.append(span)
        return span

    @staticmethod
    def _close(span: Optional[Span], step: int, now: float,
               status: str = "") -> None:
        if span is not None and not span.closed:
            span.end_step = step
            span.end_s = now
            if status:
                span.status = status

    # -- lifecycle hooks ----------------------------------------------------

    def begin(self, rid: int, step: int, now: float, **attrs: Any) -> None:
        """Request submitted: open the root span and its 'queued' child."""
        root = self._open("request", rid, step, now, **attrs)
        self._root[rid] = root
        self._queued[rid] = self._open("queued", rid, step, now, parent=root)

    def admit(self, rid: int, step: int, now: float) -> None:
        """Request entered a slot: close 'queued', open 'serve'."""
        root = self._root.get(rid)
        if root is None:
            return
        self._close(self._queued.pop(rid, None), step, now)
        self._serve[rid] = self._open("serve", rid, step, now, parent=root)

    def phase(self, rid: int, name: str, step: int, now: float,
              units: int = 0) -> None:
        """One engine step advanced ``rid`` in phase ``name``.

        'prefill' records one closed 'prefill-chunk' span per step (the
        chunk structure is the point); other phases coalesce contiguous
        same-name runs into one span, closed lazily at the next phase flip
        or at retirement.
        """
        parent = self._serve.get(rid) or self._root.get(rid)
        if parent is None:
            return
        if name == "prefill":
            open_phase = self._phase.pop(rid, None)
            self._close(open_phase, step, now)
            chunk = self._open("prefill-chunk", rid, step, now, parent=parent,
                               units=units)
            self._close(chunk, step, now)
            return
        span = self._phase.get(rid)
        if span is not None and span.name == name:
            span.end_step = step        # provisional close: extended in place
            span.end_s = now
            span.attrs["units"] = span.attrs.get("units", 0) + units
            return
        self._close(span, step, now)
        self._phase[rid] = self._open(name, rid, step, now, parent=parent,
                                      units=units)

    def end(self, rid: int, status: str, step: int, now: float) -> None:
        """Request retired: close everything still open for it."""
        self._close(self._phase.pop(rid, None), step, now)
        self._close(self._queued.pop(rid, None), step, now)
        self._close(self._serve.pop(rid, None), step, now)
        self._close(self._root.pop(rid, None), step, now, status=status)

    # -- export -------------------------------------------------------------

    def export(self, *, closed_only: bool = False) -> List[Dict[str, Any]]:
        return [s.to_dict() for s in self.spans
                if not closed_only or s.closed]

    def drain(self) -> List[Dict[str, Any]]:
        """Closed spans not yet drained (wire telemetry: each heartbeat
        ships only the increment). Open spans stay until they close."""
        out = []
        kept = []
        for span in self.spans[self._drained:]:
            (out if span.closed else kept).append(span)
        self.spans = self.spans[:self._drained] + \
            [s for s in self.spans[self._drained:] if s.closed] + kept
        self._drained = len(self.spans) - len(kept)
        return [s.to_dict() for s in out]


def merge_traces(parts: Sequence[Tuple[Any, Sequence[Dict[str, Any]]]]
                 ) -> List[Dict[str, Any]]:
    """Merge per-replica span lists into one fleet trace.

    ``parts`` is ``[(label, spans), ...]``; span ids are namespaced to
    ``"<label>:<id>"`` strings (parent links rewritten alike) and every
    span gains a ``replica`` field, so ids from different replicas can
    never collide. Ordered by (start_step, replica, span id).
    """
    merged: List[Dict[str, Any]] = []
    for label, spans in parts:
        for span in spans:
            out = dict(span)
            out["replica"] = label
            out["span_id"] = f"{label}:{span['span_id']}"
            if span.get("parent_id") is not None:
                out["parent_id"] = f"{label}:{span['parent_id']}"
            merged.append(out)
    merged.sort(key=lambda s: (s["start_step"], str(s["replica"]),
                               s["span_id"]))
    return merged
