"""Training cells: the port's `make_train_step` over `vgg9_loss`, back to
back, then its first steps checked against the plain reference's.

Set-up builds one train state from the master weights, drives it through
``checked_steps`` steps with the window's own call and feed (distinct
batches, so every row differs), keeps what the check reads (each loss,
AdamW's first moment after step 1, the parameters after the last), and
hands that same state to the window. The window runs steps back to back,
cycling through the pool of batches, until ``seconds`` have passed, then
waits for the card: every step issued is counted, and the window ends when
the last one has finished.

Traced runs synchronize after every step to time it, and profile a few
steps (`core.TracedSteps`).
"""
from __future__ import annotations

import torch

from . import check, core, devtrace, inputs
from .core import Readings, clock

#: the mix keys a training run reads
MIX_KEYS = frozenset({"batch", "pool_batches", "checked_steps", "traced_steps", "optimizer"})
OPTIMIZER_KEYS = frozenset({"name", "lr", "b1", "b2", "eps", "weight_decay", "clip_norm"})


def _optimizer(traffic: dict):
    from repro_torch.train.optim import adamw
    o = traffic["optimizer"]
    if o["name"] != "adamw" or set(o) != OPTIMIZER_KEYS:
        raise ValueError(f"the training driver runs AdamW with keys {sorted(OPTIMIZER_KEYS)}; "
                         f"the mix gives {o}")
    return adamw(b1=o["b1"], b2=o["b2"], eps=o["eps"], weight_decay=o["weight_decay"])


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float, ref,
        on_check=None) -> dict:
    """One run of a training cell -> {readings, correct, checks, attempted,
    failed, memory_peak_bytes}. ``on_check(master, batches, program,
    reference)`` sees the check's operands (`control`)."""
    from repro_torch.models import vgg9
    from repro_torch.train import schedule, train_step
    from .serving import port_config

    cfg, traffic = cell.config, cell.traffic
    on_card = torch.device(device).type == "cuda"
    readings = Readings(cell.kind, cfg, traffic)
    batch, opt_cfg = traffic["batch"], traffic["optimizer"]

    mark = lambda phase: readings.setup_marks.append((phase, clock() - t_start))
    mark("imports")
    master = inputs.master_weights(seed, cfg, device)
    images, labels = inputs.images(seed, batch * traffic["pool_batches"], cfg, device,
                                   stream="batches")
    batches = [{"images": images[i * batch:(i + 1) * batch],
                "labels": labels[i * batch:(i + 1) * batch]}
               for i in range(traffic["pool_batches"])]
    mark("inputs")

    port_cfg = port_config(cfg)
    opt = _optimizer(traffic)
    step = train_step.make_train_step(lambda p, b: vgg9.vgg9_loss(p, b, port_cfg), opt,
                                      schedule.constant(opt_cfg["lr"]),
                                      clip_norm=opt_cfg["clip_norm"])
    state = train_step.init_train_state(check.clone_tree(master), opt)

    n = 0
    losses, m1 = [], None
    for n in range(1, traffic["checked_steps"] + 1):
        state, metrics = step(state, batches[(n - 1) % len(batches)])
        losses.append(float(metrics["loss"]))
        mark(f"checked step {n}")
        if n == 1:
            m1 = check.clone_tree(state["opt"]["m"])
    prog = {"losses": losses, "m1": m1, "params": check.clone_tree(state["params"])}
    traced = core.TracedSteps(trace, on_card, seconds / 2, traffic["traced_steps"])
    traced.warm()
    core.sync(device)

    readings.setup_s = clock() - t_start
    t0 = clock()
    steps = 0
    while clock() - t0 < seconds:
        traced.before(clock() - t0)
        t = clock()
        with core.span(devtrace.STEP, traced.active and on_card):
            state, metrics = step(state, batches[(n + steps) % len(batches)])
        steps += 1
        if trace:
            core.sync(device)
            readings.step_s.append(clock() - t)
        traced.after()
    core.sync(device)
    t1 = clock()
    traced.close()
    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0
    readings.window_s = t1 - t0
    readings.done_in_window = steps * batch
    readings.trace = traced.trace

    finite = steps == 0 or bool(torch.isfinite(metrics["loss"]))
    del state, step
    if on_card:
        torch.cuda.empty_cache()
    checked = [(b["images"], b["labels"]) for b in batches[:traffic["checked_steps"]]]
    result = ref.adamw_steps(master, checked, cfg, opt_cfg)
    numbers = check.training_numbers(prog, result, master, opt_cfg["b1"])
    if on_check is not None:
        on_check(master, checked, prog, result)
    correct, rows = check.judge(numbers, cfg["limits"]["train"])
    return {"readings": readings, "correct": correct and finite, "checks": rows,
            "attempted": steps, "failed": 0 if finite else 1, "memory_peak_bytes": memory_peak}
