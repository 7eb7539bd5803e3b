"""filler_share.<cells> (engine, `serve/runners/snn.py` _SNNSession.step):
median over the window's steps of the program's ``snn.fillers`` counter (the
zero-image slots that ran beside real requests) over the slots, in %."""
from bench.harness.program import over_steps


def read(r):
    slots = r.traffic["engine"]["slots"]
    return over_steps(r, lambda step: (None if "snn.fillers" not in step["counters"]
                                       else 100.0 * step["counters"]["snn.fillers"] / slots))
