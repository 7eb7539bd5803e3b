"""Reduce a `torch.profiler` trace of a few steps to the run's device numbers.

The traced steps run inside a ``record_function(WINDOW)`` span; everything
is taken inside that span, on the profiler's own clock:

* ``busy_s``: the union of the intervals in which some device activity
  (kernel, copy, memset) ran;
* ``window_s``: the span's length;
* per-name device seconds (a metric picks its kernels by name);
* idle gaps, each named by the innermost host event of the span's thread
  that was open at the gap's middle: what the host was doing while the
  device waited. The drivers mark their own phases with
  ``record_function`` spans (`STEP`, `FORWARD`), so a gap in Python work
  that issues no torch op is named by the phase it fell in.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Tuple

WINDOW = "bench.window"
STEP = "bench.step"          # around an engine or train step
FORWARD = "bench.forward"    # around the runner's pipeline call
SPANS = (WINDOW, STEP, FORWARD)
TOP = 10


@dataclasses.dataclass
class DeviceTrace:
    window_s: float
    busy_s: float
    device_s: Dict[str, float]          # device seconds by activity name
    gaps_s: Dict[str, float]            # idle seconds by what the host was doing
    steps: int = 0

    @property
    def idle_share(self) -> float:
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def seconds_of(self, names: List[str]) -> float:
        """Device seconds of the activities whose name holds one of
        ``names`` as a whole word (a kernel's function name)."""
        if not names:
            return 0.0
        pattern = re.compile(r"\b(" + "|".join(map(re.escape, names)) + r")\b")
        return sum(s for n, s in self.device_s.items() if pattern.search(n))

    def breakdown(self) -> dict:
        top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
        return {"device_ops": top(self.device_s), "idle_gaps": top(self.gaps_s)}


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def _label_gaps(gaps, host) -> Dict[str, float]:
    """Name each gap by the innermost host event open at its middle.
    ``host``: (start, end, name) of one thread, properly nested."""
    host = sorted(host, key=lambda e: (e[0], -e[1]))
    out: Dict[str, float] = {}
    stack: List[Tuple[float, float, str]] = []
    i = 0
    for a, b in sorted(gaps):
        mid = 0.5 * (a + b)
        while i < len(host) and host[i][0] <= mid:
            while stack and stack[-1][1] <= host[i][0]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        name = stack[-1][2] if stack else "(outside the window)"
        out[name] = out.get(name, 0.0) + (b - a) * 1e-6
    return out


def reduce(events, steps: int = 0) -> DeviceTrace:
    """``events``: ``prof.events()`` of a profile whose traced steps ran
    inside ``record_function(WINDOW)``."""
    from torch.autograd import DeviceType
    spans = [e for e in events if e.name == WINDOW]
    if not spans:
        raise ValueError(f"no {WINDOW!r} span in the trace")
    w0, w1 = spans[0].time_range.start, spans[0].time_range.end
    thread = spans[0].thread
    device, device_s = [], {}
    host = []
    for e in events:
        a, b = max(e.time_range.start, w0), min(e.time_range.end, w1)
        if b <= a:
            continue
        if e.device_type == DeviceType.CUDA:
            if e.name in SPANS or getattr(e, "is_user_annotation", False):
                continue                   # a span's range on the device's timeline, no work
            device.append((a, b))
            device_s[e.name] = device_s.get(e.name, 0.0) + (b - a) * 1e-6
        elif e.device_type == DeviceType.CPU and e.thread == thread:
            host.append((e.time_range.start, e.time_range.end, e.name))
    busy = _union(device)
    gaps, at = [], w0
    for a, b in busy:
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    if at < w1:
        gaps.append((at, w1))
    return DeviceTrace(window_s=(w1 - w0) * 1e-6,
                       busy_s=sum(b - a for a, b in busy) * 1e-6,
                       device_s=device_s,
                       gaps_s=_label_gaps(gaps, host), steps=steps)
