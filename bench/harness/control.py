"""The readings that a cell's limits are set from, on the card.

    python3 bench/harness/control.py --workload W --seeds 1 2 ... --control-seeds 1 2 3 [--seconds S]

For each seed, one run of the cell at its own load (a short window: the
readings need no more than the requests a run compares), as the benchmark
makes it, printing one JSON line with the program's numbers against the
reference (``program``). For the control seeds it also prints the control:
the reference put in the program's place and computed one precision below
the configuration's (float32 with TF32 products, where the configuration
states float32 with TF32 off), against the reference (``control``). A
training cell also reads a fault planted in the reference put in the
program's place: each loss taken over half the batch (``half_batch``). A
state left unchanged reads 1 by `check.training_numbers`' measure and needs
no run.

Serving lines also carry numbers that are not compared (a mean logit gap,
the worst single request's spike gap) for the record.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench.harness import check, registry  # noqa: E402
from bench.harness.core import clock  # noqa: E402


def serving_extra(logits, out_spikes, ref) -> dict:
    ref_logits = ref["logits"].double().cpu().numpy()
    worst = 0.0
    for layer, want in ref["out_spikes"].items():
        want = want.double().cpu().numpy()
        got = np.asarray(out_spikes[layer], dtype=np.float64)
        worst = max(worst, float((np.abs(got - want) / np.maximum(want, 1.0)).max()))
    return {"logit_max_gap": float(np.abs(logits - ref_logits).max()),
            "spike_gap_request": worst}


def _train_line(prog, result, master, b1) -> dict:
    d = check.training_detail(prog, result, master, b1)
    worst = lambda gaps: max(gaps.items(), key=lambda kv: kv[1])
    return {**check.training_numbers(prog, result, master, b1),
            "loss_gaps": d["loss_gaps"], "worst_grad_leaf": worst(d["grad_gaps"]),
            "worst_change_leaf": worst(d["change_gaps"]), "still": d["still"]}


def _as_program(steps: dict, b1: float) -> dict:
    """The reference's steps in the program's shape (AdamW's first moment
    after step 1 is (1 - b1) times the first clipped gradient)."""
    return {"losses": steps["losses"], "params": steps["params"],
            "m1": {n: {k: g * (1 - b1) for k, g in leaf.items()}
                   for n, leaf in steps["grads"][0].items()}}


def readings(root: Path, workload: str, seed: int, seconds: float, control: bool,
             device="cuda") -> dict:
    cell = registry.resolve(root, workload)
    ref = registry.reference(root, cell.config["family"])
    driver = registry.driver(cell)
    line = {"workload": workload, "seed": seed}

    if cell.kind == "train":
        def on_check(master, batches, prog, result):
            opt = cell.traffic["optimizer"]
            b1 = opt["b1"]
            line["program_detail"] = _train_line(prog, result, master, b1)
            if control:
                low = ref.adamw_steps(master, batches, cell.config, opt, precision="tf32")
                line["control"] = _train_line(_as_program(low, b1), result, master, b1)
                half = ref.adamw_steps(master, batches, cell.config, opt, half_batch=True)
                line["half_batch"] = _train_line(_as_program(half, b1), result, master, b1)
        out = driver.run(cell, seed, seconds, False, device, clock(), ref, on_check)
    else:
        def on_check(master, images, logits, out_spikes, result):
            line["program_extra"] = serving_extra(logits, out_spikes, result)
            if control:
                low = ref.infer_blocks(master, images, cell.config, precision="tf32")
                low_logits = low["logits"].double().cpu().numpy()
                low_out = {k: v.double().cpu().numpy() for k, v in low["out_spikes"].items()}
                line["control"] = check.serving_numbers(low_logits, low_out, result)
                line["control_extra"] = serving_extra(low_logits, low_out, result)
            line["spikes"] = {k: float(v.double().sum()) for k, v in result["out_spikes"].items()}
            line["images"] = int(images.shape[0])
        out = driver.run(cell, seed, seconds, False, device, clock(), ref, on_check)
    line["program"] = {name: value for name, value, _ in out["checks"]}
    line["correct"] = out["correct"]
    line["attempted"], line["failed"] = out["attempted"], out["failed"]
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=1.0)
    args = p.parse_args(argv)
    for seed in args.seeds:
        line = readings(ROOT, args.workload, seed, args.seconds, seed in args.control_seeds)
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
