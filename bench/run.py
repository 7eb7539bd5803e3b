#!/usr/bin/env python3
"""Benchmark of the PyTorch/CUDA port (`src/repro_torch`): one cell per run.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with a CUDA card. The cells,
their metrics and bounds are in `BENCHMARK.json`; `bench/harness/cli.py`
says what a run does and prints.
"""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench.harness.cli import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(root=ROOT))
