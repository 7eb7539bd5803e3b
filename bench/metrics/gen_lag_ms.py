"""gen_lag_ms.<cells> (the benchmark's load generator): 95th percentile of
a request's arrival (stamped by the open loop's sender thread) minus its
due time, in ms: the generator's own lateness."""
from bench.harness.stats import p95


def read(r):
    if not r.gen_lag_s:
        return None
    return 1e3 * p95(r.gen_lag_s)
