"""skip_split_ms.<cells> (runner, `serve/runners/snn.py`): median over the
window's steps of the program's ``snn.skip_split`` span, in ms: splitting
each mapped layer's occupancy back out per request (`_per_request_skip`)."""
from bench.harness.program import over_steps, span_ms


def read(r):
    return over_steps(r, span_ms("snn.skip_split"))
