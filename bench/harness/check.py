"""The numbers that decide ``correct``, and their limits.

Serving: the program's logits and per-layer spike counts of sampled
requests that the window served, against the plain reference's on the same
images and master weights:

* ``logit_mean_gap``: the mean |logit - reference logit| over the sample's
  logits (the largest single gap is one spike group's flips and swings
  from seed to seed; `control` records it);
* ``spike_gap``: for each layer, the sample's summed |count - reference
  count| over its summed reference count; the worst layer.

Training: the first steps that the window's own call made, against the
reference's steps from the same master weights and batches:

* ``first_loss_gap``: |loss - reference loss| / |reference loss| of the
  first step (the later steps' losses follow spikes that AdamW's sign-like
  first updates flip on round-off; `training_detail` keeps them);
* ``grad_gap``: the first step's gradient as the optimizer took it (AdamW's
  first moment over 1 - b1), by the worst leaf: |norm - reference norm|
  over the larger of the reference's norm of that leaf and the median
  leaf's;
* ``change_gap``: the same for each leaf's change over the steps, leaving
  out leaves whose reference gradient is under a thousandth of the median
  leaf's (they move by round-off alone).

A number is correct when it is at most its limit (the configuration file's
``limits``).
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, List, Tuple

import numpy as np
import torch

NEGLIGIBLE_GRAD = 1e-3


def serving_numbers(logits: np.ndarray, out_spikes: Dict[str, np.ndarray], ref: dict) -> dict:
    ref_logits = ref["logits"].double().cpu().numpy()
    spike_gap = 0.0
    for layer, want in ref["out_spikes"].items():
        want = want.double().cpu().numpy()
        got = np.asarray(out_spikes[layer], dtype=np.float64)
        spike_gap = max(spike_gap, float(np.abs(got - want).sum()) / max(float(want.sum()), 1.0))
    return {"logit_mean_gap": float(np.abs(logits.astype(np.float64) - ref_logits).mean()),
            "spike_gap": spike_gap}


def _norms(tree) -> Dict[str, float]:
    return {f"{n}.{k}": float(v.double().norm()) for n, leaf in tree.items() for k, v in leaf.items()}


def _leaf_gaps(got: Dict[str, float], want: Dict[str, float], keep=None) -> Dict[str, float]:
    keys = [k for k in want if keep is None or k in keep]
    floor = statistics.median(want[k] for k in keys)
    return {k: abs(got[k] - want[k]) / max(want[k], floor, 1e-30) for k in keys}


def training_detail(prog: dict, ref: dict, start: dict, b1: float) -> dict:
    """Every step's relative loss gap, and the gradient and change gaps
    leaf by leaf (`training_numbers` takes the first step and the worst)."""
    g_prog = _norms({n: {k: v / (1 - b1) for k, v in leaf.items()} for n, leaf in prog["m1"].items()})
    g_ref = _norms(ref["grads"][0])
    floor = statistics.median(g_ref.values())
    moving = {k for k, v in g_ref.items() if v >= NEGLIGIBLE_GRAD * floor}
    change = lambda p: {n: {k: p[n][k] - start[n][k] for k in leaf} for n, leaf in p.items()}
    return {"loss_gaps": [abs(a - b) / max(abs(b), 1e-30)
                          for a, b in zip(prog["losses"], ref["losses"])],
            "grad_gaps": _leaf_gaps(g_prog, g_ref),
            "change_gaps": _leaf_gaps(_norms(change(prog["params"])),
                                      _norms(change(ref["params"])), keep=moving),
            "still": sorted(set(g_ref) - moving)}


def training_numbers(prog: dict, ref: dict, start: dict, b1: float) -> dict:
    """``prog``: {"losses", "m1" (AdamW's first moment after step 1),
    "params" (after the steps)}; ``ref``: the reference's `adamw_steps`;
    ``start``: the master weights both began from."""
    d = training_detail(prog, ref, start, b1)
    return {"first_loss_gap": d["loss_gaps"][0],
            "grad_gap": max(d["grad_gaps"].values()),
            "change_gap": max(d["change_gaps"].values())}


def judge(numbers: dict, limits: dict) -> Tuple[bool, List[Tuple[str, float, float]]]:
    """(every limited number within its limit, [(name, value, limit)])."""
    rows = [(name, float(numbers[name]), float(limit)) for name, limit in limits.items()]
    ok = all(math.isfinite(v) and v <= lim for _, v, lim in rows)
    return ok, rows


@torch.no_grad()
def clone_tree(tree) -> dict:
    return {n: {k: v.detach().clone() for k, v in leaf.items()} for n, leaf in tree.items()}
