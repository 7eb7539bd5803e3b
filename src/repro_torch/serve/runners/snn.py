"""SNN runner: batched spiking-VGG9 inference behind the `ModelRunner` protocol.

Wraps `models.vgg9.vgg9_infer_hybrid` — the dense-core + sparse-core
serving pipeline — under a `core.hybrid.plan_vgg9_inference` plan sized to
the engine's fixed slot count. Image requests are stacked onto the runner's
device into the slot batch (zero images fill empty slots; all layers are
row-independent, so real rows equal a direct `vgg9_infer_hybrid` call on
the same batch), and the pipeline's occupancy/skip counters are split back
out per request:

* spike counts — the per-image input/output sums the pipeline measures
  ([B] vectors; 0/1 spikes make the split exact);
* tile-skip rates — each request's rows of the folded [T*B·H·W, K] matmul
  re-tiled at the layer's block size, i.e. the skip rate the occupancy map
  would deliver if the request were served alone (a tile straddling two
  images never bills the silent one);
* paper-model energy — Eq. 3 workloads built from each request's *measured*
  input-spike counts, priced with the plan's NC allocation and the FPGA
  power model (`core.energy.energy_per_image`).

Every stat crosses back to the host as numpy (``.cpu().numpy()``), so
results are device-independent and `serve.core.all_finite` reads them.
"""
from __future__ import annotations

from typing import Dict, Hashable, List, Optional, Sequence

import numpy as np
import torch

from ...core.energy import analytical_energy_per_image, energy_per_image
from ...core.hybrid import HybridPlan, plan_vgg9_inference
from ...core.workload import conv_workload, dense_input_workload, fc_workload
from ...device import resolve_device
from ...models.vgg9 import VGG9Config, conv_names, vgg9_infer_hybrid
from ..api import (PAD_REQUEST_ID, Request, Result, SlotProgress, StepBudget,
                   StepReport)


def _host(t: torch.Tensor, dtype=None) -> np.ndarray:
    out = t.detach().cpu().numpy()
    return out if dtype is None else out.astype(dtype)


def _per_request_skip(row_occ: np.ndarray, block_m: int, rows: int,
                      rows_per_slice: int, batch: int) -> np.ndarray:
    """Split a folded layer's occupancy back out per request.

    row_occ: [M_pad, K/bk] 0/1 spike occupancy at (row x k-tile) granularity,
    rows ordered (t*batch + b)*rows_per_slice + pixel. For each request we
    gather *its own* rows (in folded order — the order a solo run would fold
    them) and re-tile them at the layer's block_m: the returned skip rate is
    the fraction of (block_m x block_k) tiles the occupancy map would skip if
    the request were served alone with the same kernel plan. This makes the
    per-request number independent of who shares a straddled tile — a silent
    request reports exactly 1.0 next to a dense neighbour — which is the
    intrinsic sparsity signal a co-batching scheduler needs.
    """
    kt = row_occ.shape[1]
    owner = (np.arange(rows) // rows_per_slice) % batch  # folded slice -> request
    skip = np.zeros(batch)
    for b in range(batch):
        rb = row_occ[:rows][owner == b]                  # [T*rows_per_slice, kt]
        pad = (-len(rb)) % block_m
        if pad:
            rb = np.concatenate([rb, np.zeros((pad, kt), rb.dtype)])
        occ = rb.reshape(-1, block_m, kt).any(axis=1)
        skip[b] = 1.0 - occ.sum() / occ.size
    return skip


def _per_timestep_occupancy(row_occ: np.ndarray, rows: int,
                            rows_per_slice: int, batch: int) -> np.ndarray:
    """Per-request per-timestep active-row fraction, [T, B].

    Rows of the folded matmul are ordered (t*batch + b)*rows_per_slice +
    pixel, so slicing the 0/1 row occupancy back out by (t, b) gives each
    request's sparsity *trace over timesteps* — the per-timestep stat the
    engine streams through `poll_partial` while a request is in flight.
    """
    active = row_occ[:rows].any(axis=1).astype(np.float64)
    t = rows // (batch * rows_per_slice)
    return active.reshape(t, batch, rows_per_slice).mean(axis=2)


class SNNRunner:
    """Fixed-slot spiking-VGG9 serving (`ModelRunner`) on one device.

    ``params`` must live on ``device`` ("cuda" unless the caller asks for
    "cpu"; asking for the card without one raises).
    """

    def __init__(self, cfg: VGG9Config, params, *, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = params
        self._plans: Dict[int, HybridPlan] = {}

    def plan(self, batch: int) -> HybridPlan:
        """The inference plan for a slot count (cached per batch size)."""
        if batch not in self._plans:
            self._plans[batch] = plan_vgg9_inference(self.cfg, batch)
        return self._plans[batch]

    # -- ModelRunner protocol ------------------------------------------------

    def bucket_key(self, request: Request) -> Hashable:
        return tuple(np.shape(request.payload))

    def filler(self, request: Request) -> Request:
        return Request(PAD_REQUEST_ID, torch.zeros(
            tuple(np.shape(request.payload)), dtype=torch.float32,
            device=self.device))

    def _run(self, images: torch.Tensor, n: int):
        plan = self.plan(n)
        logits, _, stats = vgg9_infer_hybrid(
            self.params, images, self.cfg, device=self.device, plan=plan,
            return_stats=True)
        batch_skip = {k: float(v["skip_rate"]) for k, v in stats.items()
                      if "skip_rate" in v}
        out_spikes = {k: _host(v["out_spikes_per_image"], np.float64)
                      for k, v in stats.items()}
        in_spikes = {k: _host(v["in_spikes_per_image"], np.float64)
                     for k, v in stats.items() if "in_spikes_per_image" in v}

        per_req_skip: Dict[str, np.ndarray] = {}
        ts_occ: Dict[str, np.ndarray] = {}
        for name, st in stats.items():
            if "occ_map" not in st:
                continue
            ks = plan.layer(name).kernel
            rps = ks.m // (self.cfg.timesteps * n)
            row_occ = _host(st["row_occ"])
            rows = int(st["rows"])
            per_req_skip[name] = _per_request_skip(
                row_occ, int(st["block_m"]), rows, rows_per_slice=rps, batch=n)
            ts_occ[name] = _per_timestep_occupancy(
                row_occ, rows, rows_per_slice=rps, batch=n)
        return (_host(logits), batch_skip, out_spikes, in_spikes,
                per_req_skip, ts_occ)

    def run(self, batch: Sequence[Request]) -> List[Result]:
        images = torch.stack([torch.as_tensor(r.payload, dtype=torch.float32,
                                              device=self.device)
                              for r in batch])
        n = len(batch)
        logits, batch_skip, out_spikes, in_spikes, per_req_skip, ts_occ = \
            self._run(images, n)

        plan = self.plan(n)
        energies = [self._energy_estimate(plan, {k: v[i] for k, v in in_spikes.items()})
                    for i in range(n)]

        # batch-context cost: Eq. 3 priced on the batch's *total* measured
        # spikes (pad slots are zero images and contribute nothing). A
        # request's served_energy_j — its share of the batch it actually rode
        # in — is what a sparsity-aware scheduler improves for sparse
        # requests: co-batched with dense stragglers, the batch total (and
        # therefore the share) is dominated by the straggler's spikes.
        n_real = sum(1 for r in batch if not r.is_pad) or 1
        batch_est = self._energy_estimate(
            plan, {k: float(v.sum()) for k, v in in_spikes.items()})
        batch_stats = {
            "batch_energy_j": batch_est["energy_j"],
            "batch_latency_s": batch_est["latency_s"],
            "batch_real": n_real,
            "served_energy_j": batch_est["energy_j"] / n_real,
            # the analytical (per-op) model's view of the same share
            "served_energy_analytical_j":
                batch_est["energy_analytical_j"] / n_real,
            # active numerics: which weight precision served this request
            "precision": self.precision,
            "wbytes_per": self.wbytes_per,
        }

        results = []
        for i, req in enumerate(batch):
            results.append(Result(req.request_id, logits[i], stats={
                "skip_rate": {k: float(v[i]) for k, v in per_req_skip.items()},
                "batch_skip_rate": batch_skip,
                "out_spikes": {k: float(v[i]) for k, v in out_spikes.items()},
                "in_spikes": {k: float(v[i]) for k, v in in_spikes.items()},
                "spike_total": float(sum(v[i] for v in out_spikes.values())),
                "ts_occupancy": {k: [float(x) for x in v[:, i]]
                                 for k, v in ts_occ.items()},
                **energies[i],
                **batch_stats,
            }))
        return results

    # -- continuous admission ------------------------------------------------

    def session_key(self, request: Request) -> Hashable:
        # only same-shape images may share a live session's slot batch
        return tuple(np.shape(request.payload))

    def open_session(self, slots: int) -> "_SNNSession":
        return _SNNSession(self, slots)

    # -- paper-model energy --------------------------------------------------

    def _energy_estimate(self, plan: HybridPlan, in_spikes: Dict[str, float]) -> Dict[str, float]:
        """Eq. 3 workloads from one request's measured input spikes, priced
        with the plan's NC allocation and the calibrated FPGA power model."""
        cfg = self.cfg
        convs = cfg.conv_channels
        t = cfg.timesteps
        hw = cfg.img_hw
        n_mp = sum(1 for s in cfg.stages if s == "MP")
        flat = (hw // (2 ** n_mp)) ** 2 * convs[-1]
        wbytes_per = 0.5 if cfg.quant_bits == 4 else 4.0
        precision = "int4" if cfg.quant_bits == 4 else "fp32"

        workloads = [dense_input_workload("conv0", hw, hw, convs[0], t)]
        weight_bytes = [9 * cfg.in_ch * convs[0] * wbytes_per]
        cin = convs[0]
        for i, name in enumerate(conv_names(cfg)[1:], start=1):
            workloads.append(conv_workload(name, convs[i], 9, in_spikes[name]))
            weight_bytes.append(9 * cin * convs[i] * wbytes_per)
            cin = convs[i]
        for name, d_in, d_out in (("fc0", flat, cfg.fc_dim),
                                  ("fc1", cfg.fc_dim, cfg.population)):
            workloads.append(fc_workload(name, d_out, in_spikes[name]))
            weight_bytes.append(d_in * d_out * wbytes_per)

        est = energy_per_image(workloads, plan.cores(), weight_bytes, precision)
        ana = analytical_energy_per_image(workloads, precision)
        return {"energy_j": est["energy_j"], "latency_s": est["latency_s"],
                "energy_analytical_j": ana["energy_j"]}

    @property
    def precision(self) -> str:
        return "int4" if self.cfg.quant_bits == 4 else "fp32"

    @property
    def wbytes_per(self) -> float:
        return 0.5 if self.cfg.quant_bits == 4 else 4.0


class _SNNSession:
    """Slot-refill session: each engine step runs one T-timestep batch.

    The spiking VGG9 is feedforward over a fixed timestep window, so a
    request occupies its slot for exactly one step — "continuous admission"
    for this workload means freed (zero-image padding) slots are refilled
    with real queued work at every step boundary instead of only between
    run-to-completion batches. Execution reuses `SNNRunner.run` on the full
    slot width (free slots become zero-image fillers), so row-independence
    keeps mid-stream-admitted requests identical to solo runs.
    """

    def __init__(self, runner: SNNRunner, slots: int):
        self.runner = runner
        self.slots = slots
        self.req: List[Optional[Request]] = [None] * slots

    def admit(self, slot: int, request: Request) -> Optional[Result]:
        assert self.req[slot] is None, f"slot {slot} busy"
        self.req[slot] = request
        return None

    def cancel(self, slot: int) -> Result:
        """An SNN request holds no device state between steps (the pipeline
        runs whole); cancellation just frees the slot."""
        assert self.req[slot] is not None, f"slot {slot} empty"
        req = self.req[slot]
        self.req[slot] = None
        return Result(req.request_id, None, stats={}, status="cancelled")

    def step(self, budget: StepBudget = StepBudget()) -> StepReport:
        """One T-timestep batch. The SNN's work unit is the timestep; the
        pipeline always spends all T per occupied slot, so the budget is
        reported as cost rather than enforced. Each finished request's
        per-timestep sparsity trace (input-row occupancy per mapped layer)
        is emitted as T partial entries for `EngineCore.poll_partial`."""
        occupied = [i for i in range(self.slots) if self.req[i] is not None]
        if not occupied:
            return StepReport()
        ref = self.req[occupied[0]]
        batch = [self.req[i] if self.req[i] is not None
                 else self.runner.filler(ref) for i in range(self.slots)]
        results = self.runner.run(batch)
        t = self.runner.cfg.timesteps
        finished = {}
        progress = {}
        for i in occupied:
            res = results[i]
            trace = res.stats.get("ts_occupancy", {})
            emitted = tuple({layer: vals[k] for layer, vals in trace.items()}
                            for k in range(t))
            progress[i] = SlotProgress(
                request_id=res.request_id, phase="infer",
                units_done=t, units_total=t, emitted=emitted)
            finished[i] = res
            self.req[i] = None
        return StepReport(finished=finished, progress=progress,
                          cost={"units": t * len(occupied), "timesteps": t})
