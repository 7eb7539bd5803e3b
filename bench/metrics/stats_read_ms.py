"""stats_read_ms.<cells> (runner, `serve/runners/snn.py`): median over the
window's steps of the program's ``snn.read`` span, in ms: every read of the
pipeline's logits and stats to the host, with the wait for the device. In
traced runs the benchmark's forward timer has already waited for it."""
from bench.harness.program import over_steps, span_ms


def read(r):
    return over_steps(r, span_ms("snn.read"))
