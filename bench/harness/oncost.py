"""What the program's step tracer costs when it is on, on the card.

    python3 bench/harness/oncost.py --workload W --seeds N1 N2 N3 [--seconds S]

For each seed, two untraced runs of a serving cell as the benchmark makes
them, in turns (detached then attached, then the other way round): one with
the port's `obs` tracer attached to the engine, as traced runs attach it
(request spans and step records, no profiler), and one without. Prints one
JSON line per run: its median step ms, images/s where the cell serves in
bulk, and how many step records the attached run kept.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench.harness import registry  # noqa: E402
from bench.harness.core import clock  # noqa: E402
from bench.harness.stats import median  # noqa: E402


def run(root: Path, workload: str, seed: int, seconds: float, attached: bool,
        device="cuda") -> dict:
    from repro_torch.obs import Observability
    from repro_torch.serve import core as engine_core
    cell = registry.resolve(root, workload)
    ref = registry.reference(root, cell.config["family"])
    bundles = []
    original = engine_core.EngineCore.__init__

    def with_tracer(self, runner, config, *args, obs=None, **kwargs):
        if obs is None:
            obs = Observability(trace=True, metrics=False, recorder=0)
            bundles.append(obs)
        original(self, runner, config, *args, obs=obs, **kwargs)

    if attached:
        engine_core.EngineCore.__init__ = with_tracer
    try:
        out = registry.driver(cell).run(cell, seed, seconds, False, device, clock(), ref)
    finally:
        engine_core.EngineCore.__init__ = original
    r = out["readings"]
    return {"workload": workload, "seed": seed, "attached": attached,
            "step_ms": 1e3 * median(r.step_s), "steps": len(r.step_s),
            "images_per_s": r.done_in_window / r.window_s if r.window_s > 0 else None,
            "step_records": sum(len(getattr(b.tracer, "steps", ())) for b in bundles),
            "correct": out["correct"]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=51.0)
    args = p.parse_args(argv)
    for k, seed in enumerate(args.seeds):
        for attached in ((False, True) if k % 2 == 0 else (True, False)):
            line = run(ROOT, args.workload, seed, args.seconds, attached)
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
