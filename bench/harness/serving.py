"""Serving cells: the port's `EngineCore` over an `SNNRunner`, fed by a
driver's loop (`bench/drivers/closed.py`, `open.py`), then checked against
the plain reference.

Set-up: master weights and a pool of images from the seed, on the card;
the program gets its own copy of the weights and host copies of the images
as request payloads (a server receives images in host memory). The engine
is built from the mix's ``engine`` entry, given whole to the port's
`EngineConfig` (a key it does not know fails there), on the benchmark's
clock, and warmed with full-width steps, the only shape it runs (free
slots are filled with zero images).

A driver's loop sends requests with `_Client.send` and runs engine steps
with `_Client.step`. A request records when it was due, when it arrived
(an open loop's sender stamps it; otherwise when it was sent), when it was
handed to the engine, and when its result came: latency runs from the due
time.

Traced runs (``--trace 1``) also time each step's pipeline forward
(`vgg9_infer_hybrid`, wrapped from outside with a synchronize at both
ends), attach the port's `obs` tracer for admission times, and profile a
few steps (`core.TracedSteps`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from . import check, core, devtrace, inputs
from .core import Readings, clock

DRAIN_LIMIT_S = 60.0
#: the mix keys this module reads; a driver adds its own
MIX_KEYS = frozenset({"engine", "pool", "warmup_steps", "traced_steps", "check_sample"})


@dataclasses.dataclass
class _Rec:
    image: int
    due: float
    arrived: float
    sent: float
    rid: int = -1
    done: Optional[float] = None
    status: str = ""
    logits: Optional[np.ndarray] = None
    out_spikes: Optional[dict] = None
    traced: bool = False


def port_config(cfg: dict):
    from repro_torch.models.vgg9 import VGG9Config
    names = {f.name for f in dataclasses.fields(VGG9Config)}
    return VGG9Config(**{k: tuple(v) if isinstance(v, list) else v
                         for k, v in cfg.items() if k in names})


class _Client:
    """Sends requests and collects their results from the engine."""

    def __init__(self, engine, pool_host: torch.Tensor, traced: core.TracedSteps):
        self.engine, self.pool, self.traced = engine, pool_host, traced
        self.records: List[_Rec] = []
        self.live: Dict[int, _Rec] = {}
        self.step_s: List[float] = []
        self.backlog: List[tuple] = []      # open loop: (s into the window, arrived, queued)
        self.failed_submits = 0

    def send(self, due: float, arrived: Optional[float] = None) -> None:
        from repro_torch.serve.api import QueueFull
        image = len(self.records) % self.pool.shape[0]
        sent = clock()
        rec = _Rec(image, due, sent if arrived is None else arrived, sent)
        self.records.append(rec)
        try:
            rec.rid = self.engine.submit(self.pool[image])
            self.live[rec.rid] = rec
        except QueueFull:
            rec.status, rec.done = "refused", rec.sent
            self.failed_submits += 1

    def step(self, elapsed: float) -> List[_Rec]:
        self.traced.before(elapsed)
        traced = self.traced.active
        t = clock()
        with core.span(devtrace.STEP, traced and self.traced.on_card):
            self.engine.step()
        done = clock()
        self.step_s.append(done - t)
        self.traced.after()
        finished = []
        for rid in list(self.live):
            res = self.engine.poll(rid)
            if res is None:
                continue
            rec = self.live.pop(rid)
            rec.done, rec.status, rec.traced = done, res.status, traced
            rec.logits = res.outputs
            rec.out_spikes = res.stats.get("out_spikes")
            finished.append(rec)
        return finished


def _program_forward_timer(readings: Readings, device, traced: core.TracedSteps):
    """Wrap the runner's pipeline call from outside: (install, remove)."""
    from repro_torch.serve.runners import snn
    original = snn.vgg9_infer_hybrid

    def timed(*args, **kwargs):
        core.sync(device)
        t = clock()
        with core.span(devtrace.FORWARD, traced.active and traced.on_card):
            out = original(*args, **kwargs)
        core.sync(device)
        readings.forward_s.append(clock() - t)
        return out

    def install():
        snn.vgg9_infer_hybrid = timed

    def remove():
        snn.vgg9_infer_hybrid = original
    return install, remove


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float, ref,
        loop, on_check=None) -> dict:
    """One run of a serving cell whose window is ``loop(client, cell, seed,
    seconds) -> (t0, t1)`` -> {readings, correct, checks, attempted, failed,
    memory_peak_bytes}. ``on_check(master, images, logits, out_spikes,
    reference)`` sees the check's operands (`control`)."""
    from repro_torch.serve.api import EngineConfig
    from repro_torch.serve.core import EngineCore
    from repro_torch.serve.runners.snn import SNNRunner

    cfg, traffic = cell.config, cell.traffic
    on_card = torch.device(device).type == "cuda"
    readings = Readings(cell.kind, cfg, traffic)

    mark = lambda phase: readings.setup_marks.append((phase, clock() - t_start))
    mark("imports")
    master = inputs.master_weights(seed, cfg, device)
    pool, _ = inputs.images(seed, traffic["pool"], cfg, device)
    pool_host = pool.cpu()
    mark("inputs")
    obs = None
    if trace:
        from repro_torch.obs import Observability
        obs = Observability(trace=True, metrics=False, recorder=0)
    engine_cfg = EngineConfig(**traffic["engine"])
    engine = EngineCore(
        SNNRunner(port_config(cfg), check.clone_tree(master), device=device),
        engine_cfg, clock=clock, obs=obs)
    traced = core.TracedSteps(trace, on_card, seconds / 2, traffic["traced_steps"])

    # warm-up: full-width steps, the one shape the window runs
    warm = _Client(engine, pool_host, core.TracedSteps(False, False, 0, 0))
    for k in range(traffic["warmup_steps"]):
        for _ in range(engine_cfg.slots):
            warm.send(clock())
        while warm.live:
            warm.step(0.0)
        mark(f"warm step {k + 1}")
    traced.warm()
    install, remove = _program_forward_timer(readings, device, traced)
    if trace:
        install()
    if obs is not None:
        obs.tracer.spans.clear()
    core.sync(device)

    client = _Client(engine, pool_host, traced)
    readings.setup_s = clock() - t_start
    try:
        t0, t1 = loop(client, cell, seed, seconds)
    finally:
        remove()
        traced.close()
    core.sync(device)
    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0

    recs = client.records
    readings.window_s = t1 - t0
    readings.step_s = client.step_s
    readings.backlog = client.backlog
    readings.done_in_window = sum(1 for r in recs if r.done is not None and r.done <= t1
                                  and r.status == "ok")
    readings.latency_s = [r.done - r.due for r in recs if r.status == "ok"]
    readings.gen_lag_s = [r.arrived - r.due for r in recs]
    if obs is not None:
        admitted = {s.request_id: s.end_s for s in obs.tracer.spans
                    if s.name == "queued" and s.closed}
        readings.queue_wait_s = [admitted[r.rid] - r.arrived for r in recs if r.rid in admitted]
    readings.trace = traced.trace
    attempted = len(recs)
    failed = sum(1 for r in recs if r.status != "ok")

    # the program's state goes before the reference runs
    del engine, client, warm
    if on_card:
        torch.cuda.empty_cache()

    ok_recs = [r for r in recs if r.status == "ok"]
    picked = [ok_recs[i] for i in inputs.sample(seed, len(ok_recs), traffic["check_sample"])]
    numbers = dict.fromkeys(cfg["limits"]["serve"], float("inf"))
    if picked:
        result = ref.infer_blocks(master, pool[[r.image for r in picked]], cfg)
        layers = list(result["out_spikes"])
        logits = np.stack([r.logits for r in picked])
        out_spikes = {k: np.array([r.out_spikes[k] for r in picked]) for k in layers}
        numbers = check.serving_numbers(logits, out_spikes, result)
        if on_check is not None:
            on_check(master, pool[[r.image for r in picked]], logits, out_spikes, result)
    correct, rows = check.judge(numbers, cfg["limits"]["serve"])

    traced_recs = [r for r in recs if r.traced and r.status == "ok"]
    readings.traced_images = len(traced_recs)
    readings.traced_launches = readings.trace.steps if readings.trace else 0
    if readings.trace is not None and traced_recs:
        from .counts import WorkCounter
        counter = WorkCounter()
        ref.infer_blocks(master, pool[[r.image for r in traced_recs]], cfg, on_layer=counter)
        readings.work = {"adds": counter.adds, "entries_in": counter.entries_in,
                         "entries_out": counter.entries_out}
    return {"readings": readings, "correct": correct and failed == 0, "checks": rows,
            "attempted": attempted, "failed": failed, "memory_peak_bytes": memory_peak}
