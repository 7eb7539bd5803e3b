"""``python3 bench/run.py --workload W --seed N --seconds S --trace 0|1``.

One cell per process: make the inputs from the seed, build and warm the
cell, measure for ``--seconds``, check the outputs against the plain
reference, and print the result as the last line of standard output, with
the compared numbers and their limits as the last lines of standard error
and as the result's last key. Without a card (or with fewer than the cell
asks for) the run fails and prints no result: it never falls back to the
CPU. Nor does it print one if the process has loaded JAX or the JAX
package.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
from pathlib import Path

from . import registry
from .core import clock

#: top-level module names the process must not hold once the window closed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def seconds_since_start() -> float:
    """Seconds since this process started (Linux's /proc), else 0."""
    try:
        fields = Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return max(0.0, uptime - started)
    except (OSError, ValueError, IndexError):
        return 0.0


def forbidden_modules(names=None) -> list:
    """The FORBIDDEN top-level names among ``names`` (default: the loaded
    modules), compared whole: ``repro_torch`` is not ``repro``."""
    names = sys.modules if names is None else names
    return sorted({name.split(".")[0] for name in names} & set(FORBIDDEN))


def cache_dirs(root: Path) -> None:
    """Fixed build and kernel caches inside the checkout, so that only a
    checkout's first run builds (the port's own kernel library goes to
    ``build/repro_torch/<hash>/`` there by itself)."""
    base = root / "build" / "bench-cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")


def run_cell(root: Path, workload: str, seed: int, seconds: float, trace: bool,
             device="cuda", t_start: float = None) -> dict:
    """Everything but the look for a card: the cell's run, its check and
    its metrics, as the result's dict (with "checks" last)."""
    import torch
    t_start = clock() if t_start is None else t_start
    cell = registry.resolve(root, workload)
    ref = registry.reference(root, cell.config["family"])
    out = registry.driver(cell).run(cell, seed, seconds, trace, device, t_start, ref)
    readings = out["readings"]
    metrics = {}
    for m in cell.metrics(trace):
        value = registry.reader(root, m.name)(readings)
        if value is not None:
            metrics[m.name] = {"value": float(value), "unit": m.unit}
    on_card = torch.device(device).type == "cuda"
    result = {
        "correct": bool(out["correct"]),
        "attempted": int(out["attempted"]),
        "failed": int(out["failed"]),
        "metrics": metrics,
        "device": {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                   "count": cell.chips,
                   "memory_peak_bytes": int(out["memory_peak_bytes"])},
    }
    if trace and readings.trace is not None:
        result["device"]["busy_s"] = readings.trace.busy_s
        result["device"]["window_s"] = readings.trace.window_s
        result["breakdown"] = readings.trace.breakdown()
    print("setup: " + ", ".join(f"{phase} {at:.3f} s" for phase, at in readings.setup_marks),
          file=sys.stderr)
    result["checks"] = {name: {"value": value if math.isfinite(value) else None, "limit": limit}
                        for name, value, limit in out["checks"]}
    return result


def main(argv=None, root: Path = None) -> int:
    elapsed = seconds_since_start()
    t_start = clock() - elapsed
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    root = Path(root) if root is not None else Path.cwd()
    cache_dirs(root)

    cell = registry.resolve(root, args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"bench: {args.workload} needs {cell.chips} CUDA device(s); this machine "
              f"has {have}. No result.", file=sys.stderr)
        return 2
    result = run_cell(root, args.workload, args.seed, args.seconds, bool(args.trace),
                      "cuda", t_start)
    found = forbidden_modules()
    if found:
        print(f"bench: the process loaded {found}: the benchmark measures the port "
              "alone. No result.", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        verdict = "ok" if c["value"] is not None and c["value"] <= c["limit"] else "OVER"
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {verdict}", file=sys.stderr)
    print(f"correct {result['correct']}", file=sys.stderr)
    sys.stderr.flush()
    bad = [k for k, v in result["metrics"].items() if not math.isfinite(v["value"])]
    if bad:
        print(f"bench: metrics {bad} are not finite. No result.", file=sys.stderr)
        return 4
    print(json.dumps(result), flush=True)
    return 0
