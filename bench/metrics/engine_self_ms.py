"""engine_self_ms.<cells> (engine, `serve/core.py` EngineCore.step): median
over the window's steps of the program's ``engine.step`` span less its
``engine.session_step``, in ms: admission, the numerics screen, retirement
and the step hooks."""
from bench.harness.program import over_steps


def _self_ms(step):
    seconds = step["seconds"]
    if "engine.step" not in seconds:
        return None
    return 1e3 * (seconds["engine.step"] - seconds.get("engine.session_step", 0.0))


def read(r):
    return over_steps(r, _self_ms)
