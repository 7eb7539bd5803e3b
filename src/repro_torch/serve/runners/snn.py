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
  images never bills the silent one), and each request's active-row
  fraction per timestep. Both are reduced on the occupancy map's own device
  to integer counts ([B] busy tiles, [T, B] active rows per layer); only
  those counts cross to the host, where the rates are formed in float64;
* paper-model energy — Eq. 3 workloads built from each request's *measured*
  input-spike counts, priced with the plan's NC allocation and the FPGA
  power model (`core.energy.energy_per_image`).

Every stat crosses back to the host as numpy (``.cpu().numpy()``), so
results are device-independent and `serve.core.all_finite` reads them.

Data-mesh sharding: under an ambient in-process data mesh
(`launch.mesh.DataMesh`, installed with ``dist.context.compute_mesh``)
whose ``'data'`` axis divides the slot count, `run` switches to
`vgg9_infer_hybrid_sharded`: the slot batch split over the mesh's shards,
weights replicated, and the per-shard occupancy counters re-assembled so
that every per-request stat (logits, skip rate, spike counts, energy) is
the unsharded run's. `EngineCore` needs no change. A process-group mesh
(training's) is not a serving mesh and is ignored.

Step phases (`obs.trace` spans, kept in the engine's step record when a
tracer is attached; the same names on the sharded path), all beneath
``engine.session_step``:

* ``snn.stack`` — the request payloads stacked onto the device;
* ``snn.forward`` — the `vgg9_infer_hybrid` call. CUDA launches return
  before the device is done, so this is the time to enqueue the forward,
  unless a caller wraps the call with synchronizes (the benchmark's traced
  runs do), when it holds the device's work too;
* ``snn.read`` — every read of a device value to the host (``_host``,
  ``float``, ``int``), the wait for the device included: the occupancy
  reductions' wait and their counts' one copy fall here;
* ``snn.skip_split`` — `_per_request_skip`, which enqueues the per-request
  busy-tile reduction on the device;
* ``snn.ts_occupancy`` — `_per_timestep_occupancy`, which enqueues the
  per-timestep active-row reduction on the device;
* ``snn.energy`` — every `SNNRunner._energy_estimate` call;
* ``snn.results`` — building the `Result`s.

One counter: ``snn.fillers``, the zero-image filler slots of a session
step (`_SNNSession.step`). The pipeline marks its layers on the device
(`models.vgg9.vgg9_infer_hybrid`).
"""
from __future__ import annotations

from typing import Dict, Hashable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...core.energy import analytical_energy_per_image, energy_per_image
from ...core.hybrid import HybridPlan, plan_vgg9_inference
from ...core.workload import conv_workload, dense_input_workload, fc_workload
from ...device import resolve_device
from ...dist.context import current_mesh
from ...launch.mesh import DataMesh
from ...models.vgg9 import (VGG9Config, conv_names, vgg9_infer_hybrid,
                            vgg9_infer_hybrid_sharded)
from ...obs.trace import count, span
from ..api import (PAD_REQUEST_ID, Request, Result, SlotProgress, StepBudget,
                   StepReport)


def _host(t: torch.Tensor, dtype=None) -> np.ndarray:
    out = t.detach().cpu().numpy()
    return out if dtype is None else out.astype(dtype)


def _spikes_per_image(stats) -> tuple:
    """Per-layer output and input spike counts per image, as float64 [B]."""
    out_spikes = {k: _host(v["out_spikes_per_image"], np.float64) for k, v in stats.items()}
    in_spikes = {k: _host(v["in_spikes_per_image"], np.float64)
                 for k, v in stats.items() if "in_spikes_per_image" in v}
    return out_spikes, in_spikes


def _per_request_skip(row_occ: torch.Tensor, block_m: int, rows: int,
                      rows_per_slice: int, batch: int) -> Tuple[torch.Tensor, int]:
    """Split a folded layer's occupancy back out per request -> (busy, tiles).

    row_occ: [M_pad, K/bk] 0/1 spike occupancy at (row x k-tile) granularity,
    rows ordered (t*batch + b)*rows_per_slice + pixel. Each request's *own*
    rows (in folded order — the order a solo run would fold them) are re-tiled
    at the layer's block_m: ``busy`` (int64 [batch], on row_occ's device)
    counts the (block_m x block_k) tiles that hold a spike if the request were
    served alone with the same kernel plan, out of ``tiles`` per request, and
    its skip rate is ``1.0 - busy / tiles`` (`_split_occupancy`). This makes
    the per-request number independent of who shares a straddled tile — a
    silent request reports exactly 1.0 next to a dense neighbour — which is
    the intrinsic sparsity signal a co-batching scheduler needs.

    One reduction for the whole batch, enqueued on row_occ's device: the rows
    viewed [T, batch, rps, kt] go batch-first ([batch, T*rps, kt]: a request's
    rows in solo-fold order), are zero-padded to a multiple of block_m (a tile
    may straddle timesteps), OR-ed over each block_m group and counted.
    """
    kt = row_occ.shape[1]
    t = rows // (batch * rows_per_slice)
    own = row_occ[:rows].view(t, batch, rows_per_slice, kt).transpose(0, 1)
    own = own.reshape(batch, t * rows_per_slice, kt)
    pad = (-t * rows_per_slice) % block_m
    if pad:
        own = torch.nn.functional.pad(own, (0, 0, 0, pad))
    busy = own.view(batch, -1, block_m, kt).any(dim=2).sum(dim=(1, 2))
    return busy, own.shape[1] // block_m * kt


def _per_timestep_occupancy(row_occ: torch.Tensor, rows: int,
                            rows_per_slice: int, batch: int) -> torch.Tensor:
    """Per-request per-timestep active rows, int64 [T, B] on row_occ's device.

    Rows of the folded matmul are ordered (t*batch + b)*rows_per_slice +
    pixel, so slicing the 0/1 row occupancy back out by (t, b) gives each
    request's sparsity *trace over timesteps* — the per-timestep stat the
    engine streams through `poll_partial` while a request is in flight.
    Each count is of the rows with a spike in any k tile; the active-row
    fraction is ``active / rows_per_slice`` (`_split_occupancy`).
    """
    t = rows // (batch * rows_per_slice)
    return row_occ[:rows].any(dim=1).view(t, batch, rows_per_slice).sum(dim=2)


def _split_occupancy(layers: Sequence[tuple], n: int,
                     t: int) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """Per-request skip rates (float64 [n]) and per-timestep occupancy
    (float64 [T, n]) of every mapped layer, by layer name.

    layers: ``(name, row_occ, rows, block_m, rows_per_slice, first)`` per
    occupancy map, whose requests are ``[first, first + rows / (T *
    rows_per_slice))`` of the ``n`` (one map per layer, or one per shard of a
    layer). Every map's reductions are enqueued first; their integer counts
    then cross to the host in one copy, and the rates are formed there.
    """
    pending = []
    for name, row_occ, rows, block_m, rps, first in layers:
        b = rows // (t * rps)
        with span("snn.skip_split"):
            busy, tiles = _per_request_skip(row_occ, block_m, rows, rows_per_slice=rps, batch=b)
        with span("snn.ts_occupancy"):
            active = _per_timestep_occupancy(row_occ, rows, rows_per_slice=rps, batch=b)
        pending.append((name, slice(first, first + b), busy, tiles, active, rps))
    with span("snn.read"):
        counts = _host(torch.cat([c.reshape(-1) for _, _, busy, _, active, _ in pending
                                  for c in (busy, active)]))
    skip: Dict[str, np.ndarray] = {}
    occ: Dict[str, np.ndarray] = {}
    at = 0
    for name, sl, busy, tiles, active, rps in pending:
        b = busy.numel()
        skip.setdefault(name, np.zeros(n))[sl] = 1.0 - counts[at:at + b] / tiles
        at += b
        occ.setdefault(name, np.zeros((t, n)))[:, sl] = counts[at:at + t * b].reshape(t, b) / rps
        at += t * b
    return skip, occ


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
        with span("snn.forward"):
            logits, _, stats = vgg9_infer_hybrid(
                self.params, images, self.cfg, device=self.device, plan=plan,
                return_stats=True)
        with span("snn.read"):
            batch_skip = {k: float(v["skip_rate"]) for k, v in stats.items()
                          if "skip_rate" in v}
            out_spikes, in_spikes = _spikes_per_image(stats)

        t = self.cfg.timesteps
        layers = []
        for name, st in stats.items():
            if "occ_map" not in st:
                continue
            with span("snn.read"):
                rows, block_m = int(st["rows"]), int(st["block_m"])
            layers.append((name, st["row_occ"], rows, block_m,
                           plan.layer(name).kernel.m // (t * n), 0))
        per_req_skip, ts_occ = _split_occupancy(layers, n, t)
        with span("snn.read"):
            logits = _host(logits)
        return (logits, batch_skip, out_spikes, in_spikes, per_req_skip, ts_occ)

    def _data_shards(self, n: int) -> int:
        """How many ways to split a slot batch: the ambient in-process
        mesh's 'data' axis size when it divides the batch, else 1."""
        mesh = current_mesh()
        if not isinstance(mesh, DataMesh):
            return 1
        ndev = int(mesh.shape["data"])
        return ndev if ndev > 1 and n % ndev == 0 else 1

    def _run_sharded(self, images: torch.Tensor, n: int, ndev: int):
        """Split the slot batch over the data mesh (`vgg9_infer_hybrid_sharded`)
        and re-assemble per-request counters from the per-shard stats.

        Per-image spike vectors come back shard-concatenated (already
        global); occupancy maps come back stacked per shard, so per-request
        skip rates and occupancy traces are reduced shard by shard on the
        device — shard ``d`` owns requests ``[d*n/ndev, (d+1)*n/ndev)`` — and
        placed into the global vectors. They equal the unsharded run's:
        rows_per_slice and the sparse M tile do not depend on the batch size,
        so re-tiling a request's own rows gives the same served-alone skip
        rate."""
        b_local = n // ndev
        plan = self.plan(b_local)
        with span("snn.forward"):
            logits, _, stats = vgg9_infer_hybrid_sharded(
                self.params, images, self.cfg, mesh=current_mesh(), plan=plan,
                return_stats=True)
        with span("snn.read"):
            batch_skip = {k: float(_host(v["skip_rate"]).mean()) for k, v in stats.items()
                          if "skip_rate" in v}
            out_spikes, in_spikes = _spikes_per_image(stats)

        t = self.cfg.timesteps
        layers = []
        for name, st in stats.items():
            if "occ_map" not in st:
                continue
            rps = plan.layer(name).kernel.m // (t * b_local)
            with span("snn.read"):
                rows, block_m = _host(st["rows"]), _host(st["block_m"])
            layers += [(name, st["row_occ"][d], int(rows[d]), int(block_m[d]), rps, d * b_local)
                       for d in range(ndev)]
        per_req_skip, ts_occ = _split_occupancy(layers, n, t)
        with span("snn.read"):
            logits = _host(logits)
        return (logits, batch_skip, out_spikes, in_spikes, per_req_skip, ts_occ)

    def run(self, batch: Sequence[Request]) -> List[Result]:
        with span("snn.stack"):
            images = torch.stack([torch.as_tensor(r.payload, dtype=torch.float32,
                                                  device=self.device)
                                  for r in batch])
        n = len(batch)
        ndev = self._data_shards(n)
        if ndev > 1:
            logits, batch_skip, out_spikes, in_spikes, per_req_skip, ts_occ = \
                self._run_sharded(images, n, ndev)
        else:
            logits, batch_skip, out_spikes, in_spikes, per_req_skip, ts_occ = \
                self._run(images, n)

        # energy is priced with the full-slot plan in both modes, so that a
        # request's Eq. 3 estimate does not change with the shard count
        plan = self.plan(n)
        with span("snn.energy"):
            energies = [self._energy_estimate(plan, {k: v[i] for k, v in in_spikes.items()})
                        for i in range(n)]
            # batch-context cost: Eq. 3 priced on the batch's *total* measured
            # spikes (pad slots are zero images and contribute nothing). A
            # request's served_energy_j — its share of the batch it actually
            # rode in — is what a sparsity-aware scheduler improves for sparse
            # requests: co-batched with dense stragglers, the batch total (and
            # therefore the share) is dominated by the straggler's spikes.
            batch_est = self._energy_estimate(
                plan, {k: float(v.sum()) for k, v in in_spikes.items()})
        with span("snn.results"):
            n_real = sum(1 for r in batch if not r.is_pad) or 1
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
        count("snn.fillers", self.slots - len(occupied))
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
