"""The program's own step records, as its readers take them.

A traced serving run attaches the port's `obs` tracer to the engine, which
then keeps a record of each step (`repro_torch.obs.trace`): ``seconds`` by
span name (summed over the step's calls), ``counters`` by name and
``device_ms`` by model layer (CUDA events between the pipeline's layer
marks, on a card). The readers take them in process, after the run, from
`trace.latest_steps()`: the ring of the tracer that stepped last. The
window's steps are the last ``len(r.step_s)`` records, since every window
step is one engine step that the client timed from outside; each record
has to fit inside its step's outside time, or the ring is some other run's.
A program that keeps no step records gives no steps, and every reader of
them returns None.
"""
from __future__ import annotations

from typing import Callable, List, Optional

from .stats import median


def window_steps(r) -> List[dict]:
    """The step records of the run ``r`` read, oldest first, as dicts;
    empty where the program keeps none or they are not this run's."""
    try:
        from repro_torch.obs import trace
    except ImportError:
        return []
    latest = getattr(trace, "latest_steps", None)
    n = len(r.step_s)
    if latest is None or n == 0:
        return []
    ring = list(latest())
    records = ring[-n:]
    outside = r.step_s[len(r.step_s) - len(records):]
    if not records or any(rec.end_s - rec.start_s > s for rec, s in zip(records, outside)):
        return []
    return [rec.to_dict() for rec in records]


def over_steps(r, value: Callable[[dict], Optional[float]]) -> Optional[float]:
    """The median over the run's step records of ``value(step)``, leaving
    out the steps where it is None; None where no step has one."""
    values = [v for v in map(value, window_steps(r)) if v is not None]
    return median(values)


def span_ms(name: str) -> Callable[[dict], Optional[float]]:
    """A step's ms in the span ``name``, or None where it never opened."""
    def value(step):
        seconds = step["seconds"].get(name)
        return None if seconds is None else 1e3 * seconds
    return value
