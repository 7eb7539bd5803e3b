"""Request-lifecycle tracing over the engine clock, and step records.

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
*already read* — the lifecycle spans never touch a clock themselves, so
attaching them cannot perturb deadlines or scheduling (the no-perturbation
contract `tests/test_torch_obs.py` asserts bit-identically).

Fleet traces: each replica traces locally; `Tracer.drain` hands closed
spans to the transport (in-process directly, over the wire via the
heartbeat's telemetry field) and `merge_traces` namespaces span ids by
replica label into one ordered trace for the whole run.

Step records (`Tracer.steps`, a ring of the last `STEP_RING` steps) time
the phases *inside* each engine step. `Tracer.record_step` opens one and
publishes it in a context variable, the way `dist.context` publishes the
mesh; the module functions `span`, `count` and `device_mark` add to the
record that is open, from any layer below the engine, and do nothing else
when none is (one context-variable read). A record holds, per span name,
its seconds summed over the step's calls and its parent's name, named
counters, and device milliseconds between consecutive `device_mark`s.
Spans read `time.perf_counter`, never the engine's clock, so deadlines and
admission stay bit-identical; each also opens a
``torch.profiler.record_function`` range of its name, so a profiler trace
shows the program's phases on its own timeline. Device marks are CUDA
events on the current stream, resolved when the step closes, with no
synchronize: a runner's step ends in blocking reads of its results, which
have waited for them (a step whose last event is not yet done keeps no
device times). Step records are kept apart from `export`, `drain` and the
metrics: readers take ``tracer.steps`` in process, or `latest_steps()`
(the ring of the tracer that closed the latest record) where they do not
hold the bundle.
"""
from __future__ import annotations

import collections
import contextlib
import contextvars
import dataclasses
import time
from typing import Any, Deque, Dict, List, Optional, Sequence, Tuple

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

    The lifecycle methods take the clock value and step index as
    arguments — the caller passes readings it already made. Unknown
    request ids are ignored (a request may retire from the queue without
    ever being admitted, or a replica may join a trace mid-life after a
    re-route). `record_step` keeps the step records (`steps`), on
    ``time.perf_counter``.
    """

    def __init__(self):
        self._next_id = 0
        self.spans: List[Span] = []          # every span, open or closed
        self._root: Dict[int, Span] = {}     # request_id -> open root
        self._serve: Dict[int, Span] = {}    # request_id -> open serve span
        self._queued: Dict[int, Span] = {}   # request_id -> open queued span
        self._phase: Dict[int, Span] = {}    # request_id -> open phase span
        self._drained = 0                    # spans[:_drained] already shipped
        #: the last `STEP_RING` closed step records, oldest first
        self.steps: Deque[StepRecord] = collections.deque(maxlen=STEP_RING)

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

    # -- step records -------------------------------------------------------

    @contextlib.contextmanager
    def record_step(self, step: int):
        """Open the step record of engine step ``step`` for the ``with``
        body: `span`, `count` and `device_mark` add to it. It is closed,
        and the context variable reset, however the body ends."""
        global _LATEST
        open_step = _OpenStep(StepRecord(step, time.perf_counter()))
        token = _OPEN.set(open_step)
        try:
            yield open_step.record
        finally:
            _OPEN.reset(token)
            open_step.record.end_s = time.perf_counter()
            open_step.resolve_marks()
            self.steps.append(open_step.record)
            _LATEST = self.steps


#: step records a `Tracer` keeps
STEP_RING = 1024


@dataclasses.dataclass
class StepRecord:
    """The phases of one engine step. ``start_s``/``end_s`` are
    ``time.perf_counter`` readings; ``seconds[name]`` sums a span name's
    calls in the step and ``parent[name]`` is the span that was open when
    it first opened (None for a root); ``device_ms[name]`` sums the device
    time between consecutive marks on one device, credited to the later
    mark's name (`device_mark`)."""
    step: int
    start_s: float
    end_s: Optional[float] = None
    seconds: Dict[str, float] = dataclasses.field(default_factory=dict)
    parent: Dict[str, Optional[str]] = dataclasses.field(default_factory=dict)
    counters: Dict[str, float] = dataclasses.field(default_factory=dict)
    device_ms: Dict[str, float] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


class _OpenStep:
    """A record while its step runs: the open spans and the device marks."""

    def __init__(self, record: StepRecord):
        self.record = record
        self.stack: List[str] = []
        self.marks: List[tuple] = []         # (name, event, device, starts)

    def resolve_marks(self) -> None:
        """Turn the marks into ``device_ms``, if each device's last event
        is done (it is once the step has read its results to the host);
        else the step keeps no ``device_ms``."""
        last = {device: event for _, event, device, _ in self.marks}
        if not all(event.query() for event in last.values()):
            return
        device_ms = self.record.device_ms
        for (_, ev0, dev0, _), (name, ev1, dev1, starts) in zip(self.marks, self.marks[1:]):
            if not starts and dev0 == dev1:
                device_ms[name] = device_ms.get(name, 0.0) + ev0.elapsed_time(ev1)


class _Span:
    __slots__ = ("step", "name", "range", "t0")

    def __init__(self, step: _OpenStep, name: str):
        self.step, self.name = step, name

    def __enter__(self):
        from torch.profiler import record_function
        step, name = self.step, self.name
        step.record.parent.setdefault(name, step.stack[-1] if step.stack else None)
        step.stack.append(name)
        self.range = record_function(name)
        self.range.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        seconds = time.perf_counter() - self.t0
        self.range.__exit__(*exc)
        self.step.stack.pop()
        timed = self.step.record.seconds
        timed[self.name] = timed.get(self.name, 0.0) + seconds
        return False


_OPEN: contextvars.ContextVar = contextvars.ContextVar("repro_torch_obs_step", default=None)
_OFF = contextlib.nullcontext()
_LATEST: Deque[StepRecord] = collections.deque()


def latest_steps() -> Deque[StepRecord]:
    """The step ring of the tracer that closed this process's latest step
    record (empty before any): for an in-process reader that does not hold
    the engine's bundle, such as a benchmark reading a run it has finished.
    With several traced engines in one process, it follows whichever
    stepped last."""
    return _LATEST


def span(name: str):
    """A context manager timing ``name`` into the open step record (and a
    ``record_function`` range of it); a shared no-op when none is open."""
    step = _OPEN.get()
    return _OFF if step is None else _Span(step, name)


def count(name: str, n: float = 1) -> None:
    """Add ``n`` to the open step record's counter ``name``."""
    step = _OPEN.get()
    if step is not None:
        counters = step.record.counters
        counters[name] = counters.get(name, 0) + n


def device_mark(name: str, like, *, starts: bool = False) -> None:
    """Record a CUDA event on the current stream of ``like``'s device, if
    a step record is open and ``like`` is a CUDA tensor. The device time
    from the previous mark on that device to this one is credited to
    ``name``; a mark that ``starts`` a run of marks is credited nothing."""
    step = _OPEN.get()
    if step is None or not like.is_cuda:
        return
    import torch
    event = torch.cuda.Event(enable_timing=True)
    event.record(torch.cuda.current_stream(like.device))
    step.marks.append((name, event, like.device, starts))


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
