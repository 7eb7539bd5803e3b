"""pricing_ms.<cells> (runner, `serve/runners/snn.py`): median over the
window's steps of the program's ``snn.energy`` span, in ms: pricing each
request and the batch under Eq. 3 and the analytical energy model."""
from bench.harness.program import over_steps, span_ms


def read(r):
    return over_steps(r, span_ms("snn.energy"))
