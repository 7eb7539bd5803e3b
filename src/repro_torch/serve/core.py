"""EngineCore: the one fixed-slot serving core both workloads share.

Decoupled-processing SNN architectures (Windhager et al., arXiv:2311.14447)
separate request admission from execution; this module is that split in
software. `EngineCore` owns the admission queue, slot lifecycle and result
routing, delegates *batch composition* to a pluggable `scheduler.Scheduler`,
and delegates tensors to an `api.ModelRunner`. The same `submit()` /
`poll()` / `run_until_complete()` surface serves greedy LM decoding
(`runners.lm.LMRunner`) and batched spiking-VGG9 inference
(`runners.snn.SNNRunner`).

Two admission policies (``EngineConfig.admission``):

* ``'continuous'`` (default) — step-level admission. The engine holds one
  live `api.RunnerSession` per session key; each `step()` first retires
  expired requests, asks the scheduler to refill freed slots from the
  queue, plans a work budget (`api.StepBudget` — default
  ``EngineConfig.prefill_chunk``, or the scheduler's ``plan_step`` split),
  then advances the session by that budget. For the LM a step consumes one
  decode token per resident plus up to ``chunk`` prompt tokens per
  prefilling slot — a newly admitted request prefills its prompt in
  scheduler-sized chunks in the same launches its slot-mates decode in
  (per-row positions + ``active`` cache masking keep it bit-identical to a
  solo run), so a long prompt no longer holds goodput down for its whole
  prefill and a freed KV-cache slot never idles while other requests still
  decode. For the SNN a step is one fused T-timestep batch: freed
  (zero-image padding) slots are refilled with real work every step.
  Requests with different decode budgets co-reside; nothing waits for a
  bucket.
* ``'batch'`` — the PR-2 run-to-completion policy: one `step()` forms one
  batch (scheduler-composed, same `bucket_key`), pads it to the slot count
  and runs it to completion. Kept for offline/throughput use and as the
  reference semantics. Budgets, deadlines and partial results are
  continuous-admission concepts; the batch path ignores them.

Request lifecycle beyond completion (continuous admission):

* **streaming** — every `api.StepReport` carries per-slot partial outputs
  (`SlotProgress.emitted`: new LM tokens, per-timestep SNN stats); the
  engine accumulates them per request for `poll_partial`.
* **cancellation** — `cancel(request_id)` removes a queued request or
  reclaims a resident's slot via `RunnerSession.cancel` (row-independence
  keeps neighbours bit-identical); the `Result` carries
  ``status='cancelled'`` and whatever partial outputs existed.
* **deadlines** — requests submitted with ``deadline_s`` are retired with
  ``status='expired'`` once the engine clock passes their deadline
  (queued or resident), and a scheduler ``expire`` hook may evict
  provably-late residents early. The clock is injectable (``clock=``) so
  tests and benchmarks can drive deadlines deterministically in steps.
* **fault containment** — every step's emitted partials and finished
  results pass a NaN/Inf screen (``EngineConfig.numerics_screen``); a
  poisoned slot is retired with ``status='failed'`` (clean partials
  preserved) instead of streaming the poison or corrupting its own next
  step, and `run_until_complete(max_idle_steps=...)` raises
  `api.EngineStalled` instead of spinning forever when no slot makes
  progress. `serve.router.Router` builds fleet-level supervision (drain +
  replay re-route) on these per-engine guarantees.

Per-step occupancy/goodput accounting lives on `stats()`; the admission
history (which requests entered which step) on `admission_log`.

Numpy only: a copy of the JAX package's serve/core.py, kept so the
port stands alone.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Callable, Dict, Hashable, List, Optional, Tuple

import numpy as np

from .api import (EngineConfig, EngineStalled, ModelRunner, QueueFull,
                  Request, Result, RunnerSession, SlotProgress, StepBudget,
                  SubmitSpec)
from .scheduler import Scheduler, make_scheduler


def all_finite(value) -> bool:
    """True when ``value`` contains no NaN/Inf anywhere (recursing into
    lists/tuples/dicts and array-likes). The numerics probe the engine (and
    `serve.router.Router`) runs over step outputs: ints, strings, None and
    non-numeric leaves are vacuously finite."""
    if value is None or isinstance(value, (bool, int, str, bytes)):
        return True
    if isinstance(value, float):
        return value == value and value not in (float("inf"), float("-inf"))
    if isinstance(value, dict):
        return all(all_finite(v) for v in value.values())
    if isinstance(value, (list, tuple, set)):
        return all(all_finite(v) for v in value)
    if hasattr(value, "dtype"):
        arr = np.asarray(value)
        if not np.issubdtype(arr.dtype, np.floating) and \
                not np.issubdtype(arr.dtype, np.complexfloating):
            return True
        return bool(np.isfinite(arr).all())
    return True


class StepClock:
    """Deterministic engine clock: one 'second' per completed engine step.

    Deadlines expressed in steps make SLO behavior machine-independent.
    `EngineCore` auto-attaches itself to an unattached clock it is
    constructed with, so the usual form is just::

        core = EngineCore(runner, config, clock=StepClock())
    """

    def __init__(self):
        self.core: Optional["EngineCore"] = None

    def attach(self, core: "EngineCore") -> "StepClock":
        self.core = core
        return self

    def __call__(self) -> float:
        return 0.0 if self.core is None else float(self.core._steps_run)


class _Slot:
    """One batch lane. Tracks which request occupies it (None = free) and
    how many requests it has served — the lifecycle the benchmarks report
    as slot occupancy."""

    __slots__ = ("index", "request_id", "served")

    def __init__(self, index: int):
        self.index = index
        self.request_id: Optional[int] = None
        self.served = 0

    def acquire(self, request_id: int) -> None:
        assert self.request_id is None, f"slot {self.index} busy"
        self.request_id = request_id

    def release(self) -> None:
        if self.request_id is not None:
            self.served += 1
        self.request_id = None


class EngineCore:
    """Fixed-slot admission queue + pluggable scheduler over a `ModelRunner`."""

    def __init__(self, runner: ModelRunner, config: EngineConfig = EngineConfig(),
                 scheduler: Optional[Scheduler] = None,
                 clock: Callable[[], float] = time.monotonic,
                 obs: Optional[Any] = None):
        assert config.admission in ("continuous", "batch"), config.admission
        self.runner = runner
        self.config = config
        if config.precision:
            set_precision = getattr(runner, "set_precision", None)
            if set_precision is None:
                raise ValueError(
                    f"EngineConfig.precision={config.precision!r} needs a "
                    "precision-capable runner "
                    "(serve.precision.PrecisionRunner); "
                    f"{type(runner).__name__} has no set_precision")
            set_precision(config.precision)
        self.scheduler = scheduler if scheduler is not None else make_scheduler(config.scheduler)
        self.slots = [_Slot(i) for i in range(config.slots)]
        self._queue: collections.deque[Request] = collections.deque()
        self._results: Dict[int, Result] = {}
        self._next_id = 0
        # request_id -> Request for everything currently resident in a slot
        self._resident: Dict[int, Request] = {}
        self._session: Optional[RunnerSession] = None
        self._session_key: Optional[Hashable] = None
        #: engine clock: deadlines and arrival stamps are measured on it.
        #: Wall time by default; tests/benchmarks inject a step counter for
        #: deterministic deadline behavior. An unattached `StepClock` (or
        #: anything with the same attach/core surface) is bound to this
        #: engine here, so forgetting the attach call cannot silently
        #: freeze the clock at 0.
        if getattr(clock, "core", False) is None and callable(
                getattr(clock, "attach", None)):
            clock.attach(self)
        self._clock = clock
        # request_id -> partial outputs emitted but not yet polled
        self._partials: Dict[int, List[Any]] = {}
        # slot index -> last SlotProgress (scheduler budget/evict input)
        self._progress: Dict[int, SlotProgress] = {}
        # accounting
        self._batches_run = 0          # runner invocations (compute steps)
        self._requests_done = 0
        self._cancelled = 0
        self._expired = 0
        self._failed = 0               # numerics screen retirements
        self._steps_run = 0            # compute steps (== batches_run today)
        self._occupied_slot_steps = 0  # sum over steps of occupied slots
        self._decode_tokens = 0        # LM decode tokens emitted (goodput)
        self._work_units = 0           # budget units consumed (StepReport.cost)
        self._drafted_tokens = 0       # speculative drafts verified
        self._accepted_tokens = 0      # drafts accepted (free decode tokens)
        #: [(step_index, [request_ids admitted])] — the scheduler's decisions,
        #: in order; tests and benchmarks read batch composition off this.
        self.admission_log: List[Tuple[int, List[int]]] = []
        #: the last `StepReport` a continuous-admission step produced —
        #: supervision surface for `serve.router.Router`'s health probes.
        self.last_report: Optional[Any] = None
        #: optional `repro.obs.Observability` bundle. Hooks only receive
        #: values the engine computed anyway (clock readings, reports,
        #: results) — attaching one is bit-identical to running without
        #: (the no-perturbation contract `tests/test_obs.py` asserts).
        self.obs = obs
        if obs is not None:
            obs.attach_engine(self)

    # -- admission ----------------------------------------------------------

    def submit(self, payload: Any, *, deadline_s: Optional[float] = None,
               priority: int = 0, **options: Any) -> int:
        """Admit one request; returns its id. Raises `QueueFull` at capacity.

        The kwarg surface parses into one canonical `api.SubmitSpec`
        (shared verbatim by `Router.submit` and the wire `SubmitMsg`);
        unknown or ill-typed option keys raise ValueError *here*, at the
        submit boundary, not mid-step inside a runner.

        deadline_s: optional latency SLO in engine-clock seconds from now —
        the request is retired with ``status='expired'`` if it has not
        completed by then. priority: admission tie-break for deadline-aware
        schedulers (higher wins).
        """
        return self.submit_spec(SubmitSpec.make(
            payload, deadline_s=deadline_s, priority=priority, **options))

    def submit_spec(self, spec: SubmitSpec) -> int:
        """Admit one already-validated `api.SubmitSpec` (the primitive
        `submit` wraps; transports call this directly)."""
        if len(self._queue) >= self.config.max_queue:
            raise QueueFull(
                f"admission queue at capacity ({self.config.max_queue})")
        rid = self._next_id
        self._next_id += 1
        now = self._clock()
        self._queue.append(Request(rid, spec.payload, dict(spec.options),
                                   deadline_s=spec.deadline_s,
                                   priority=spec.priority,
                                   arrival_s=now))
        if self.obs is not None:
            self.obs.on_submit(rid, self._steps_run, now,
                               priority=spec.priority,
                               deadline_s=spec.deadline_s)
        return rid

    def pending(self) -> int:
        return len(self._queue)

    def in_flight(self) -> int:
        """Requests currently resident in slots (continuous admission)."""
        return sum(1 for s in self.slots if s.request_id is not None)

    # -- results ------------------------------------------------------------

    def poll(self, request_id: int) -> Optional[Result]:
        """Return (and retire) the result for ``request_id``, or None if it
        has not completed yet. Retiring a result also drops its undrained
        partials (the full outputs are on the `Result`)."""
        res = self._results.pop(request_id, None)
        if res is not None:
            self._partials.pop(request_id, None)
        return res

    def poll_partial(self, request_id: int) -> List[Any]:
        """Drain the partial outputs streamed for ``request_id`` since the
        last call: new tokens for LM requests, per-timestep sparsity stats
        for SNN requests (`api.SlotProgress.emitted`). Empty list when
        nothing new was emitted; works while the request is in flight and —
        until the final `Result` is polled — after completion."""
        return self._partials.pop(request_id, [])

    # -- lifecycle -----------------------------------------------------------

    def cancel(self, request_id: int, *, status: str = "cancelled") -> bool:
        """Cancel a queued or resident request; False if the engine does not
        hold it (already completed, polled, or never submitted).

        The `Result` (retrievable via `poll`) carries ``status`` and, for a
        resident request, its partial outputs. Reclaiming the slot does not
        perturb slot-mates: sessions are row-independent and the freed row's
        state is re-zeroed before reuse, exactly as on normal completion.
        """
        for req in self._queue:
            if req.request_id == request_id:
                self._queue.remove(req)
                res = Result(request_id, None, stats={}, status=status)
                # the scheduler may hold queue-side state for this request
                # (e.g. pass-over counters); let it retire that too
                self.scheduler.observe(req, res)
                self._results[request_id] = res
                self._count_retired(status)
                self._obs_retire(res)
                return True
        if request_id not in self._resident:
            return False
        slot = next(s for s in self.slots if s.request_id == request_id)
        res = self._session.cancel(slot.index)
        assert res.request_id == request_id, (res.request_id, request_id)
        if res.status != status:
            res = dataclasses.replace(res, status=status)
        req = self._resident.pop(request_id)
        self.scheduler.observe(req, res)
        self._results[request_id] = res
        self._progress.pop(slot.index, None)
        slot.release()
        self._count_retired(status)
        self._obs_retire(res)
        return True

    def _count_retired(self, status: str) -> None:
        if status == "expired":
            self._expired += 1
        elif status == "failed":
            self._failed += 1
        else:
            self._cancelled += 1

    def _expire_due(self, now: float) -> None:
        """Retire every request whose deadline has passed: queued ones drop
        with an empty result, residents are evicted with their partial
        progress. A scheduler ``expire`` hook may additionally evict
        residents that are predicted (by a lower-bound estimate) to miss."""
        for req in [r for r in self._queue
                    if r.deadline_at is not None and now >= r.deadline_at]:
            self.cancel(req.request_id, status="expired")
        for rid, req in list(self._resident.items()):
            if req.deadline_at is not None and now >= req.deadline_at:
                self.cancel(rid, status="expired")
        hook = getattr(self.scheduler, "expire", None)
        if hook is not None and self._resident:
            residents = {s.index: self._resident[s.request_id]
                         for s in self.slots if s.request_id is not None}
            for rid in hook(residents, dict(self._progress), now=now):
                if rid in self._resident:
                    self.cancel(rid, status="expired")

    # -- scheduling ---------------------------------------------------------

    def step(self) -> int:
        """Advance the engine; returns #requests completed.

        continuous: refill freed slots from the queue, then run one session
        iteration. batch: form and run one batch to completion.
        """
        if self.config.admission == "batch":
            return self._step_batch()
        return self._step_continuous()

    def _progress_marker(self) -> Tuple[int, int, int, int]:
        """Anything that changes between steps when the engine is healthy:
        work consumed, requests retired (any status), queue drained."""
        retired = (self._requests_done + self._cancelled + self._expired
                   + self._failed)
        return (retired, self._work_units, self._decode_tokens,
                len(self._queue))

    def run_until_complete(self, *,
                           max_idle_steps: Optional[int] = None
                           ) -> Dict[int, Result]:
        """Drain queue and live slots; returns every unretrieved result
        keyed by id (retiring them from `poll`).

        max_idle_steps bounds the wedged-session failure mode: after that
        many consecutive steps with zero progress (no work units, nothing
        retired, queue unmoved) the drain raises `EngineStalled` naming the
        stuck residents, instead of spinning forever on a session that
        stopped advancing. Defaults to `EngineConfig.max_idle_steps`
        (finite); 0 disables the guard.
        """
        limit = self.config.max_idle_steps if max_idle_steps is None \
            else max_idle_steps
        idle = 0
        while self._queue or self.in_flight():
            before = self._progress_marker()
            self.step()
            idle = 0 if self._progress_marker() != before else idle + 1
            if limit and idle >= limit:
                stuck = sorted(self._resident)
                if self.obs is not None:
                    self.obs.on_dump("stalled", self._steps_run,
                                     resident=stuck, queued=len(self._queue))
                raise EngineStalled(
                    f"no slot made progress for {idle} consecutive steps "
                    f"(steps_run={self._steps_run}, resident request ids "
                    f"{stuck}, queued={len(self._queue)}, last progress "
                    f"phases={[ (p.request_id, p.phase, p.units_done, p.units_total) for p in self._progress.values() ]})")
        out, self._results = self._results, {}
        for rid in out:
            self._partials.pop(rid, None)
        return out

    def _take_from_queue(self, picks: List[Request], key_fn) -> Hashable:
        """Validate a scheduler selection and remove it from the queue;
        returns the selection's (single) session/bucket key."""
        keys = {key_fn(r) for r in picks}
        assert len(keys) == 1, f"scheduler mixed keys in one selection: {keys}"
        chosen = {r.request_id for r in picks}
        assert len(chosen) == len(picks), "scheduler returned duplicate requests"
        self._queue = collections.deque(
            r for r in self._queue if r.request_id not in chosen)
        return keys.pop()

    def _complete(self, slot: _Slot, result: Result) -> None:
        req = self._resident.pop(result.request_id)
        self.scheduler.observe(req, result)
        self._results[result.request_id] = result
        slot.release()
        self._requests_done += 1
        self._obs_retire(result)

    def _obs_retire(self, result: Result) -> None:
        """Every terminal-result path funnels here for the trace's sake."""
        if self.obs is not None:
            self.obs.on_retire(result, self._steps_run, self._clock())

    # -- continuous admission ------------------------------------------------

    def _step_continuous(self) -> int:
        done = 0
        now = self._clock()
        tick = getattr(self.scheduler, "on_clock", None)
        if tick is not None:        # select()'s signature carries no clock
            tick(now)
        self._expire_due(now)
        free = [s for s in self.slots if s.request_id is None]
        resident = self.config.slots - len(free)
        if (resident and self._queue
                and self.runner.session_key(self._queue[0]) != self._session_key):
            # the *oldest* queued request needs a different session: stop
            # refilling and let the residents drain so its key takes over —
            # PR-2's oldest-bucket-first fairness at session granularity.
            # Without this, a steady same-key stream arriving behind it
            # would keep the session resident and starve it forever.
            free = []
        if self._queue and free:
            active_key = self._session_key if resident else None
            picks = self.scheduler.select(
                tuple(self._queue), len(free),
                key_fn=self.runner.session_key, active_key=active_key)
            if picks:
                key = self._take_from_queue(picks, self.runner.session_key)
                assert active_key is None or key == active_key, (key, active_key)
                if resident == 0 and (self._session is None
                                      or key != self._session_key):
                    # no live work: safe to swap in a session for the new key
                    self._session = self.runner.open_session(self.config.slots)
                    self._session_key = key
                self.admission_log.append(
                    (self._steps_run, [r.request_id for r in picks]))
                if self.obs is not None:
                    self.obs.on_admit([r.request_id for r in picks],
                                      self._steps_run, now)
                for req, slot in zip(picks, free):
                    slot.acquire(req.request_id)
                    self._resident[req.request_id] = req
                    self.scheduler.on_admit(req)
                    immediate = self._session.admit(slot.index, req)
                    if immediate is not None:   # degenerate request: 0 work
                        self._complete(slot, immediate)
                        done += 1
            elif resident == 0:
                raise RuntimeError(
                    "scheduler admitted nothing into an idle engine with a "
                    "non-empty queue (Scheduler.select contract: with "
                    "active_key=None it must pick at least one request)")

        occupied = [s for s in self.slots if s.request_id is not None]
        if not occupied:
            return done

        budget = StepBudget(chunk=self.config.prefill_chunk)
        plan = getattr(self.scheduler, "plan_step", None)
        if plan is not None:
            residents = {s.index: self._resident[s.request_id] for s in occupied}
            budget = plan(residents, dict(self._progress), now=now,
                          default=budget)
        t0 = self._clock()
        report = self._session.step(budget)
        self._steps_run += 1          # before the clock read: a step-counting
        self._batches_run += 1        # clock must see this step as elapsed
        seconds = self._clock() - t0
        self._occupied_slot_steps += len(occupied)
        self._decode_tokens += int(report.cost.get("decode_tokens", 0))
        self._work_units += int(report.cost.get("units", 0))
        self._drafted_tokens += int(report.cost.get("drafted_tokens", 0))
        self._accepted_tokens += int(report.cost.get("accepted_tokens", 0))

        # numerics probe: a slot whose step outputs carry NaN/Inf is retired
        # with status='failed' before the poison can stream to the caller or
        # feed the slot's next step — batchmates are row-independent, so the
        # retirement never perturbs them.
        poisoned: Dict[int, SlotProgress] = {}
        if self.config.numerics_screen:
            for idx, prog in report.progress.items():
                res = report.finished.get(idx)
                if not all_finite(prog.emitted) or (
                        res is not None and not (all_finite(res.outputs)
                                                 and all_finite(res.stats))):
                    poisoned[idx] = prog

        self._progress = dict(report.progress)
        for idx, prog in report.progress.items():
            if prog.emitted and idx not in poisoned:
                self._partials.setdefault(prog.request_id, []).extend(prog.emitted)
        hook = getattr(self.scheduler, "on_report", None)
        if hook is not None:
            hook(report, seconds=seconds, now=self._clock())
        self.last_report = report
        if self.obs is not None:
            self.obs.on_step(
                report, step=self._steps_run - 1, now=t0 + seconds,
                seconds=seconds, queue_len=len(self._queue),
                occupied=len(occupied),
                poisoned=[p.request_id for p in poisoned.values()])

        for idx, res in report.finished.items():
            slot = self.slots[idx]
            assert slot.request_id == res.request_id, (slot.request_id,
                                                       res.request_id)
            self._progress.pop(idx, None)
            if idx in poisoned:
                # finished but poisoned: surface the result as 'failed'
                # (outputs/stats kept for diagnosis; clean partials already
                # streamed stay available through poll_partial)
                res = dataclasses.replace(res, status="failed")
                req = self._resident.pop(res.request_id)
                self.scheduler.observe(req, res)
                self._results[res.request_id] = res
                slot.release()
                self._failed += 1
                self._obs_retire(res)
                continue
            self._complete(slot, res)
            done += 1
        for idx, prog in poisoned.items():
            # mid-flight poison: reclaim the slot via the cancel path — the
            # session rebuilds a clean partial Result (the poison lived only
            # in the reported outputs, e.g. a fault wrapper's injection)
            if idx not in report.finished and prog.request_id in self._resident:
                self.cancel(prog.request_id, status="failed")
        if poisoned and self.obs is not None:
            self.obs.on_dump("numerics-poison", self._steps_run - 1,
                             rids=[p.request_id for p in poisoned.values()])
        return done

    # -- run-to-completion batching (PR-2 semantics) -------------------------

    def _step_batch(self) -> int:
        if not self._queue:
            return 0
        picks = self.scheduler.select(
            tuple(self._queue), self.config.slots,
            key_fn=self.runner.bucket_key, active_key=None)
        assert picks, "Scheduler.select returned nothing for an idle engine"
        self._take_from_queue(picks, self.runner.bucket_key)
        self.admission_log.append(
            (self._steps_run, [r.request_id for r in picks]))
        if self.obs is not None:
            self.obs.on_admit([r.request_id for r in picks],
                              self._steps_run, self._clock())

        batch: List[Request] = list(picks)
        for slot, req in zip(self.slots, batch):
            slot.acquire(req.request_id)
            self._resident[req.request_id] = req
            self.scheduler.on_admit(req)
        # pad to the full slot count: the runner always sees static shapes
        while len(batch) < self.config.slots:
            batch.append(self.runner.filler(batch[0]))

        results = self.runner.run(batch)
        assert len(results) == self.config.slots, (
            f"runner returned {len(results)} results for {self.config.slots} slots")

        done = 0
        for slot, (req, res) in zip(self.slots, zip(batch, results)):
            if req.is_pad:
                continue
            assert res.request_id == req.request_id, (res.request_id, req.request_id)
            self._complete(slot, res)
            done += 1
        for slot in self.slots:
            slot.release()                 # pad slots; real ones already free
        self._batches_run += 1
        self._steps_run += 1
        self._occupied_slot_steps += len(picks)
        return done

    # -- introspection ------------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        served = [s.served for s in self.slots]
        steps = self._steps_run
        return {
            "batches_run": self._batches_run,
            "steps_run": steps,
            "requests_done": self._requests_done,
            "cancelled": self._cancelled,
            "expired": self._expired,
            "failed": self._failed,
            "pending": len(self._queue),
            "in_flight": self.in_flight(),
            "slots": self.config.slots,
            "slot_served": served,
            "admission": self.config.admission,
            "scheduler": getattr(self.scheduler, "name", type(self.scheduler).__name__),
            "prefill_chunk": self.config.prefill_chunk,
            # active weight-numerics policy: the config override if set,
            # else the runner's native precision ('native' if it has none)
            "precision": self.config.precision
                         or getattr(self.runner, "precision", "native"),
            # mean fraction of slots holding real work per compute step
            "slot_occupancy": (self._occupied_slot_steps
                               / (steps * self.config.slots) if steps else 0.0),
            # requests retired per compute step (continuous: tokens cost
            # steps, so LM goodput < 1; SNN completes whole slots per step)
            "goodput_req_per_step": (self._requests_done / steps if steps else 0.0),
            # budget-units consumed and LM decode tokens emitted, total and
            # per step — decode goodput is what chunked prefill raises: the
            # same decode work packs into fewer wall-clock steps
            "work_units": self._work_units,
            "decode_tokens": self._decode_tokens,
            "goodput_decode_tok_per_step": (self._decode_tokens / steps
                                            if steps else 0.0),
            # speculative decode: drafts verified, drafts accepted, and the
            # fraction accepted — accepted tokens are the decode tokens a
            # step emitted beyond one-per-slot, i.e. exactly the goodput
            # speculation buys (zero everywhere when speculation is off)
            "drafted_tokens": self._drafted_tokens,
            "accepted_tokens": self._accepted_tokens,
            "accept_rate": (self._accepted_tokens / self._drafted_tokens
                            if self._drafted_tokens else 0.0),
            "goodput_accepted_tok_per_step": (self._accepted_tokens / steps
                                              if steps else 0.0),
        }
