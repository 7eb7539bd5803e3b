"""p95_ms, and p95_ms.<cells>: 95th percentile of every request's latency, in
ms: from submission (closed loop) or from its due time (open loop) to its
result. In a closed loop that keeps every slot full it is the tail of the
step time, a per-layer metric (`p95_ms.bulk`)."""
from bench.harness.stats import p95


def read(r):
    if not r.latency_s:
        return None
    return 1e3 * p95(r.latency_s)
