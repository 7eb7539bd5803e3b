"""What a run hands its metric readers, and the traced window.

`Readings` holds everything a reader may read: the measured window, the
set-up, per-request times, host spans the benchmark wrapped around the
program's calls, the device trace of a few steps, and the work those steps
needed (counted by the reference). A reader returns None where the run has
nothing for it.

`TracedSteps` runs ``torch.profiler`` over a few consecutive steps from
the middle of a traced run's window (the first step that starts after half
of it), inside `devtrace.WINDOW`.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, List, Optional

from . import devtrace

clock = time.perf_counter


@dataclasses.dataclass
class Readings:
    kind: str                                   # the traffic's driver: closed, open, train
    config: dict
    traffic: dict
    window_s: float = 0.0                       # the measured window
    setup_s: float = 0.0                        # process start -> window start
    setup_marks: List[tuple] = dataclasses.field(default_factory=list)   # (phase, s since start)
    done_in_window: int = 0                     # images served / trained inside the window
    latency_s: List[float] = dataclasses.field(default_factory=list)     # every request
    gen_lag_s: List[float] = dataclasses.field(default_factory=list)     # open loop: sent - due
    queue_wait_s: List[float] = dataclasses.field(default_factory=list)  # traced: admit - submit
    step_s: List[float] = dataclasses.field(default_factory=list)        # host s per step
    backlog: List[tuple] = dataclasses.field(default_factory=list)       # open: (s, sent, queued)
    forward_s: List[float] = dataclasses.field(default_factory=list)     # traced: pipeline span
    trace: Optional[devtrace.DeviceTrace] = None  # traced, on a card
    traced_images: int = 0                      # real images of the traced steps
    traced_launches: int = 0                    # pipeline forwards in the traced steps
    work: Optional[Dict[str, Dict[str, float]]] = None  # the traced images' needed work


class TracedSteps:
    """Profile ``steps`` consecutive steps once ``start_after`` seconds of
    the window have passed. Drivers call `before` / `after` around each
    step; `active` says whether the step being run is traced."""

    def __init__(self, enabled: bool, on_card: bool, start_after: float, steps: int):
        self.enabled, self.on_card = enabled, on_card
        self.start_after, self.steps = start_after, steps
        self.done = 0
        self.active = False
        self.trace: Optional[devtrace.DeviceTrace] = None
        self._prof = self._span = self._finished = None

    def warm(self) -> None:
        """Start and stop the profiler once in set-up: its first start
        initialises the tracer, which is no part of a step."""
        if self.enabled and self.on_card:
            prof = self._profile()
            prof.__enter__()
            prof.__exit__(None, None, None)

    def _profile(self):
        from torch.profiler import ProfilerActivity, profile
        return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

    def before(self, elapsed: float) -> None:
        if not self.enabled or self.active or self.done >= self.steps or elapsed < self.start_after:
            return
        self.active = True
        if self.on_card:
            from torch.profiler import record_function
            self._prof = self._profile()
            self._prof.__enter__()
            self._span = record_function(devtrace.WINDOW)
            self._span.__enter__()

    def after(self) -> None:
        if not self.active:
            return
        self.done += 1
        if self.done >= self.steps:
            self._stop()

    def close(self) -> None:
        """After the window: end a trace that the window's end cut short,
        and reduce the trace (parsing takes seconds, so never inside it)."""
        if self.active:
            self._stop()
        if self._finished is not None:
            self.trace = devtrace.reduce(self._finished.events(), self.done)
            self._finished = None

    def _stop(self) -> None:
        self.active = False
        if self.on_card:
            import torch
            torch.cuda.synchronize()
            self._span.__exit__(None, None, None)
            self._prof.__exit__(None, None, None)
            self._finished, self._prof, self._span = self._prof, None, None


def span(name: str, on: bool):
    """A ``record_function`` span while a trace is being taken, else nothing."""
    if not on:
        return contextlib.nullcontext()
    from torch.profiler import record_function
    return record_function(name)


def sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
