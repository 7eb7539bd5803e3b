"""Find the knee of an open-loop cell: the highest offered rate it sustains.

    python3 bench/harness/sweep.py --workload W --seed N --seconds S --rates R1 R2 ...

For each rate, one run of the cell as the benchmark makes it, with its mix's
``arrivals.rate_per_s`` replaced. A rate is sustained when the queue (arrived, not
yet admitted) at the last arrival is no longer than one step's arrivals (the rate times the
median step) beyond the queue at the window's start. Prints one JSON line
per rate; the knee is the highest sustained rate, and the cell's mix takes
0.8 of it.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench.harness import registry  # noqa: E402
from bench.harness.core import clock  # noqa: E402
from bench.harness.stats import p95  # noqa: E402


def at_last_arrival(backlog, sent_total):
    """Queue length at the first step after the last arrival."""
    for _, arrived, queued in backlog:
        if arrived >= sent_total:
            return queued
    return backlog[-1][2] if backlog else 0


def sweep(root: Path, workload: str, seed: int, seconds: float, rates, device="cuda"):
    cell = registry.resolve(root, workload)
    ref = registry.reference(root, cell.config["family"])
    base = dict(cell.traffic)
    for rate in rates:
        cell.traffic = dict(base, arrivals=dict(base["arrivals"], rate_per_s=float(rate)))
        out = registry.driver(cell).run(cell, seed, seconds, False, device, clock(), ref)
        r = out["readings"]
        step = statistics.median(r.step_s) if r.step_s else float("nan")
        start = r.backlog[0][2] if r.backlog else 0
        end = at_last_arrival(r.backlog, out["attempted"])
        yield {"rate_per_s": rate, "attempted": out["attempted"], "failed": out["failed"],
               "queue_start": start, "queue_end": end, "step_ms": 1e3 * step,
               "step_arrivals": rate * step, "sustained": end - start <= rate * step,
               "p95_ms": 1e3 * p95(r.latency_s) if r.latency_s else None,
               "gen_lag_p95_ms": 1e3 * p95(r.gen_lag_s) if r.gen_lag_s else None,
               "correct": out["correct"]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    args = p.parse_args(argv)
    for line in sweep(ROOT, args.workload, args.seed, args.seconds, args.rates):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
