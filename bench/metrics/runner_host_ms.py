"""runner_host_ms.<cells> (runner, `serve/runners/snn.py`): median over the
window's steps of the step's host ms less its pipeline span (the runner's
call into `vgg9_infer_hybrid`, timed from outside with a synchronize at both
ends): stacking payloads, reading stats back, pricing, building results."""
from bench.harness.stats import median


def read(r):
    if not r.forward_s or len(r.forward_s) != len(r.step_s):
        return None
    return 1e3 * median([s - f for s, f in zip(r.step_s, r.forward_s)])
