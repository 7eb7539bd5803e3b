"""queue_wait_ms.<cells> (engine admission): 95th percentile of a request's
admission into a slot (the port's `obs` tracer, 'queued' spans, on the
benchmark's clock) minus its arrival, in ms: the running step, then the
queue."""
from bench.harness.stats import p95


def read(r):
    if not r.queue_wait_s:
        return None
    return 1e3 * p95(r.queue_wait_s)
