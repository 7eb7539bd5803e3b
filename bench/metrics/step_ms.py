"""step_ms.<cells>: median host ms of the window's steps. Serving (engine,
`serve/core.py` EngineCore.step): every step, each ending in the runner's
blocking reads. Training (trainer, `train/train_step.py` make_train_step):
the traced run's steps, each ending in a synchronize."""
from bench.harness.stats import median


def read(r):
    if not r.step_s:
        return None
    return 1e3 * median(r.step_s)
