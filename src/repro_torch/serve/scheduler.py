"""Pluggable batch-composition schedulers for `serve.core.EngineCore`.

The paper's co-design loop runs: quantization raises spike sparsity, the
hybrid dense/sparse hardware turns sparsity into energy savings — but only
if the work actually arriving at the cores *is* sparse. Sparsity-aware
co-design (Aliyev et al., arXiv:2408.14437) asks the software stack to
exploit workload sparsity when scheduling; the Eq. 3 energy model
(`core.energy`) makes the cost of ignoring it concrete: a batch's latency
and energy follow its total spike workload, so one dense request co-batched
with sparse ones drags every slot-mate up to its own cost ("dense stragglers
poisoning sparse batches").

This module is the seam where that policy plugs in. `EngineCore` delegates
every admission decision — which queued requests go into the currently free
slots — to a `Scheduler`:

* `FIFOScheduler`            — arrival order, filtered to the compatible
                               session key. Reproduces the PR-2 run-to-
                               completion batching when used with
                               ``admission='batch'``.
* `SparsityAwareScheduler`   — co-batches requests by observed/predicted
                               tile-skip rate. Every completed `Result`
                               already carries per-request ``skip_rate``
                               stats (that is why they exist); the scheduler
                               folds them into EWMAs keyed by the request's
                               ``source`` option and ranks the queue by
                               distance to the resident batch's predicted
                               sparsity.
* `SLOScheduler`             — deadline/priority admission plus per-step
                               budget splitting, layered *over* an inner
                               scheduler ('slo:sparsity' composes with the
                               sparsity policy rather than replacing it).
                               Learns the engine's measured cost per work
                               unit from `StepReport`s, admits deadlined
                               requests first (by priority class, then
                               tightest deadline), boosts the prefill chunk
                               of slots racing a deadline, and evicts
                               residents that cannot make their deadline
                               even under an optimistic estimate.

Schedulers are deliberately workload-agnostic: they see only `Request`
(payload opaque), the session-compatibility key function, and `Result.stats`
/ `StepReport` costs. LM results carry no skip rates, so the sparsity
scheduler degrades to FIFO for them — prediction falls back to the prior for
every request and the ranking sort is stable.

Beyond the required `Scheduler` protocol, `EngineCore` probes three
*optional* hooks with ``getattr`` (so FIFO/sparsity need not implement
them):

* ``on_clock(now)``                                 — the engine clock at
  the start of every step, before ``select`` (whose protocol signature
  carries no clock);
* ``plan_step(residents, progress, now, default)`` -> `StepBudget` — set
  this step's work budget and its per-slot split;
* ``on_report(report, seconds, now)``               — observe each step's
  `StepReport` and measured wall seconds (cost-model learning);
* ``expire(residents, progress, now)`` -> [request_id] — residents to evict
  early because they can no longer meet their deadline.

Numpy only: a copy of the JAX package's serve/scheduler.py, kept so the
port stands alone.
"""
from __future__ import annotations

import math
from typing import (Callable, Dict, Hashable, List, Mapping, Optional,
                    Protocol, Sequence, runtime_checkable)

from .api import Request, Result, SlotProgress, StepBudget, StepReport

KeyFn = Callable[[Request], Hashable]


def observed_skip_rate(result: Result) -> Optional[float]:
    """Mean per-layer tile-skip rate of a completed request, or None.

    Reads ``Result.stats['skip_rate']`` — the per-request, served-alone skip
    rates the SNN runner splits out of the folded occupancy maps (fractions
    in [0, 1], one per sparse layer). Results without the field (e.g. LM
    requests) yield None and leave the scheduler's state untouched.
    """
    rates = result.stats.get("skip_rate")
    if rates is None:
        return None
    if isinstance(rates, dict):
        if not rates:
            return None
        vals = list(rates.values())
    else:
        vals = [float(rates)]        # scalar form: 0.0 is a valid observation
    return float(sum(vals)) / len(vals)


@runtime_checkable
class Scheduler(Protocol):
    """Admission policy: picks which queued requests enter free slots.

    Contract (enforced by `EngineCore`):

    * ``select`` returns requests drawn from ``queue`` (at most ``free``),
      all sharing one session key. When ``active_key`` is not None only
      key-matching requests may be returned (they will join live slots of
      that session); when it is None the scheduler chooses the key — and
      MUST return at least one request if the queue is non-empty, so the
      engine can always make progress.
    * ``on_admit`` is called for every selected request when it takes a
      slot; ``observe`` when its `Result` is produced — normal completion,
      cancellation, expiry, and also for requests retired straight from
      the queue (which never saw ``on_admit``), so schedulers can drop any
      queue-side state they hold. Between ``on_admit`` and ``observe`` the
      request is "resident" — the sparsity scheduler anchors admission on
      the residents' predicted skip rates.
    """

    def select(self, queue: Sequence[Request], free: int, *,
               key_fn: KeyFn, active_key: Optional[Hashable]) -> List[Request]:
        ...

    def on_admit(self, request: Request) -> None:
        ...

    def observe(self, request: Request, result: Result) -> None:
        ...


class FIFOScheduler:
    """Arrival order, filtered to one session key (the PR-2 policy)."""

    name = "fifo"

    def select(self, queue: Sequence[Request], free: int, *,
               key_fn: KeyFn, active_key: Optional[Hashable]) -> List[Request]:
        if not queue or free <= 0:
            return []
        key = active_key if active_key is not None else key_fn(queue[0])
        return [r for r in queue if key_fn(r) == key][:free]

    def on_admit(self, request: Request) -> None:
        pass

    def observe(self, request: Request, result: Result) -> None:
        pass


class SparsityAwareScheduler:
    """Co-batch requests with similar observed/predicted tile-skip rates.

    Prediction, per request (first hit wins):

    1. ``request.options['skip_hint']`` — caller-supplied estimate in [0, 1];
    2. EWMA of observed skip rates for ``request.options['source']`` (a
       client/stream tag: requests from one source tend to share sparsity);
    3. global EWMA over all observed results;
    4. ``prior`` (no history yet).

    Selection: the seed is the oldest compatible request when the batch is
    empty (no starvation of whoever waited longest); the anchor is the mean
    predicted skip of the resident requests, or the seed's own prediction.
    Remaining slots are filled by predicted-skip distance to the anchor
    (stable sort: FIFO breaks ties, so workloads without skip stats degrade
    to FIFO exactly). Requests passed over more than ``patience`` times jump
    the ranking — an aging escape hatch so dense requests cannot starve
    behind an endless sparse stream.

    ``spread`` (optional) defers requests whose prediction is farther than
    ``spread`` from the anchor even when slots are free — trading occupancy
    for batch purity. Off by default; aging overrides it.
    """

    name = "sparsity"

    def __init__(self, *, alpha: float = 0.3, prior: float = 0.5,
                 patience: int = 16, spread: Optional[float] = None):
        assert 0.0 < alpha <= 1.0, alpha
        self.alpha = alpha
        self.prior = prior
        self.patience = patience
        self.spread = spread
        self._by_source: Dict[Hashable, float] = {}
        self._global: Optional[float] = None
        self._resident: Dict[int, float] = {}   # request_id -> predicted skip
        self._passes: Dict[int, int] = {}       # request_id -> times passed over
        # skip-rate observation fan-out: callables (request, result, skip)
        # invoked for every result that carried a skip rate. The serving-time
        # precision controller (`serve.precision.bind_controller`) attaches
        # here to learn realized skip-rate deltas *per precision* — the
        # scheduler is the one place every completed Result already flows
        # through, so the quantization->sparsity feedback rides the same
        # channel the EWMAs do.
        self.listeners: List[Callable[[Request, Result, float], None]] = []

    # -- prediction ---------------------------------------------------------

    def predict(self, request: Request) -> float:
        hint = request.options.get("skip_hint")
        if hint is not None:
            return float(hint)
        src = request.options.get("source")
        if src is not None and src in self._by_source:
            return self._by_source[src]
        if self._global is not None:
            return self._global
        return self.prior

    def _ewma(self, old: Optional[float], new: float) -> float:
        return new if old is None else self.alpha * new + (1 - self.alpha) * old

    # -- Scheduler protocol -------------------------------------------------

    def select(self, queue: Sequence[Request], free: int, *,
               key_fn: KeyFn, active_key: Optional[Hashable]) -> List[Request]:
        if not queue or free <= 0:
            return []
        picked: List[Request] = []
        if active_key is None:
            seed = queue[0]                       # oldest request: never starved
            active_key = key_fn(seed)
            picked.append(seed)
            free -= 1
        compatible = [r for r in queue if key_fn(r) == active_key
                      and (not picked or r.request_id != picked[0].request_id)]

        anchor_pool = list(self._resident.values()) or [self.predict(p) for p in picked]
        anchor = sum(anchor_pool) / len(anchor_pool) if anchor_pool else self.prior

        aged = [r for r in compatible
                if self._passes.get(r.request_id, 0) >= self.patience]
        fresh = [r for r in compatible
                 if self._passes.get(r.request_id, 0) < self.patience]
        fresh.sort(key=lambda r: abs(self.predict(r) - anchor))  # stable: FIFO ties
        if self.spread is not None:
            fresh = [r for r in fresh if abs(self.predict(r) - anchor) <= self.spread]
        ranked = aged + fresh

        picked.extend(ranked[:free])
        chosen = {r.request_id for r in picked}
        for r in compatible:
            if r.request_id not in chosen:
                self._passes[r.request_id] = self._passes.get(r.request_id, 0) + 1
        return picked

    def on_admit(self, request: Request) -> None:
        self._resident[request.request_id] = self.predict(request)
        self._passes.pop(request.request_id, None)

    def observe(self, request: Request, result: Result) -> None:
        self._resident.pop(request.request_id, None)
        # a request can be retired straight from the queue (cancel/expiry)
        # without ever being admitted: drop its pass-over counter too
        self._passes.pop(request.request_id, None)
        skip = observed_skip_rate(result)
        if skip is None:
            return
        self._global = self._ewma(self._global, skip)
        src = request.options.get("source")
        if src is not None:
            self._by_source[src] = self._ewma(self._by_source.get(src), skip)
        for listener in self.listeners:
            listener(request, result, skip)

    def metrics_into(self, registry) -> None:
        """Publish learned skip-rate state into a `repro.obs` registry —
        the pull hook `Observability.attach_engine` registers as a
        snapshot-time collector (never called on the hot path)."""
        registry.gauge(
            "scheduler_skip_ewma_global",
            "global EWMA of observed tile-skip rates").set(
                self._global if self._global is not None else self.prior)
        registry.gauge(
            "scheduler_resident_requests",
            "requests the scheduler currently tracks as resident").set(
                len(self._resident))
        for src, ewma in sorted(self._by_source.items()):
            registry.gauge(
                f"scheduler_skip_ewma_source_{src}",
                f"per-source skip-rate EWMA (source={src!r})").set(ewma)


class SLOScheduler:
    """Deadline/priority admission + per-step budget split over an inner policy.

    Composes with, rather than replaces, the batch-composition schedulers:
    requests carrying a ``deadline_s`` are admitted ahead of the rest,
    ordered by priority class first (strict: a higher ``priority`` beats
    any deadline below it), tightest deadline within a class; everything
    else is delegated to the ``inner`` scheduler ('slo:sparsity' keeps the
    sparsity co-batching for the non-deadlined stream).

    The cost model is learned, not configured: every `StepReport` the engine
    forwards through ``on_report`` updates two *fastest observed* figures —
    seconds per engine step, and seconds per *work unit* (LM token / SNN
    timestep) keyed by workload kind. Deadline estimates prefer the per-unit
    model: the step model prices every step at the fastest observed step
    (usually a wide prefill chunk), so mixed chunk widths misprice decode-
    heavy requests; seconds-per-unit is invariant to chunking. A minimum
    (not a mean) keeps every estimate built on it a lower bound on real
    service — required for the never-evict-the-feasible guarantee below —
    and makes the model immune to wall-clock outliers like the XLA compile
    on a step's first launch width. On top of it:

    * ``plan_step`` sets the step's `StepBudget` split — a prefilling
      resident racing its deadline gets its chunk boosted to
      ``ceil(prefill_remaining / slack_steps)`` (capped at ``boost_cap``),
      so a long prompt finishes prefill inside its SLO instead of at the
      engine-wide default pace;
    * ``expire`` evicts residents that cannot meet their deadline even
      under an *optimistic* estimate (prefill at ``boost_cap`` per step,
      one step per remaining decode token) — the estimate is a lower bound
      on real service, so a request that could still finish is never
      evicted;
    * ``select`` defers queued deadlined requests that are already hopeless
      by the same estimate (they expire in the queue instead of wasting a
      slot), falling back to admitting the head when the engine would
      otherwise sit idle.

    Deadlines are in engine-clock seconds (`EngineCore`'s injectable clock;
    wall time by default, steps in the deterministic benchmarks/tests).
    """

    #: default ceiling on the per-slot prefill chunk this scheduler will
    #: grant; drivers that pre-compile launch widths key off it
    DEFAULT_BOOST_CAP = 64

    def __init__(self, inner: Optional[Scheduler] = None, *,
                 boost_cap: int = DEFAULT_BOOST_CAP):
        self.inner: Scheduler = inner if inner is not None else FIFOScheduler()
        self.name = "slo" if inner is None else f"slo:{self.inner.name}"
        self.boost_cap = max(1, boost_cap)
        # fastest observed step: the optimistic (lower-bound) cost model
        self._sec_per_step: Optional[float] = None
        # fastest observed seconds per *work unit* (LM token / SNN timestep),
        # keyed by workload kind — see `_estimate_seconds` for why the step
        # model alone misprices mixed chunk widths
        self._sec_per_unit: Dict[str, float] = {}
        # most decode tokens one LM slot has emitted in one step: 1 under
        # plain decode, up to speculate_k+1 when speculative verification
        # accepts a draft. The step lower bound divides by it — an
        # optimistic model must assume every future step speculates as well
        # as the best step observed, or it over-prices decode phases and
        # evicts requests speculation would have finished in time.
        self._max_decode_per_slot_step = 1
        self._now = 0.0

    def on_clock(self, now: float) -> None:
        """Engine clock at the start of each step — keeps the hopeless-
        deferral check in ``select`` (fixed protocol signature, no clock
        argument) evaluating deadlines against the current time rather
        than a timestamp from before an idle gap."""
        self._now = now

    # -- cost model ---------------------------------------------------------

    def _optimistic_steps(self, prefill_rem: int, decode_rem: int) -> float:
        """Lower bound on remaining engine steps: prefill at the maximum
        chunk this scheduler would ever grant, decode at the best
        emitted-tokens-per-slot-step observed so far (1 until a
        speculative step demonstrates more — see ``on_report``) — minus
        one when both phases remain, because the step that consumes the
        last prompt token also emits the first decode token."""
        steps = (math.ceil(prefill_rem / self.boost_cap)
                 + math.ceil(decode_rem / self._max_decode_per_slot_step))
        if prefill_rem > 0 and decode_rem > 0:
            steps -= 1
        return steps

    def _service_units(self, request: Request) -> "tuple[int, int]":
        """(prefill, decode) units a queued request will need. Workload
        heuristic: a token-sequence payload (LM) prefills its length; the
        decode budget is the ``max_new_tokens`` option. Anything else
        (e.g. an SNN image array, which completes in one fused step)
        estimates 0 — the estimate must stay a *lower bound* on real
        service, so an unknown payload shape never defers/evicts a request
        that could still finish."""
        payload = request.payload
        prefill = len(payload) if isinstance(payload, (list, tuple)) else 0
        return prefill, int(request.options.get("max_new_tokens", 0))

    @staticmethod
    def _request_kind(request: Request) -> str:
        """Workload kind for the per-unit cost model. Mirrors the
        `_service_units` heuristic: a token-sequence payload is LM work
        (units = tokens), anything else is treated as SNN work (units =
        timesteps)."""
        return "lm" if isinstance(request.payload, (list, tuple)) else "snn"

    @staticmethod
    def _report_kind(cost: Mapping) -> Optional[str]:
        """Workload kind of a `StepReport.cost` dict, by the fields the
        runners actually emit: LM steps break units down into prompt/decode
        tokens, SNN steps report timesteps."""
        if "prompt_tokens" in cost or "decode_tokens" in cost:
            return "lm"
        if "timesteps" in cost:
            return "snn"
        return None

    def _optimistic_units(self, prefill_rem: int, decode_rem: int) -> int:
        """Lower bound on remaining *work units* (tokens): every prompt
        token plus every decode token, minus one when both phases remain —
        the forward pass that consumes the last prompt token also emits the
        first decode token."""
        units = prefill_rem + decode_rem
        if prefill_rem > 0 and decode_rem > 0:
            units -= 1
        return units

    def _estimate_seconds(self, prefill_rem: int, decode_rem: int,
                          kind: str) -> Optional[float]:
        """Optimistic (lower-bound) seconds of remaining service.

        Prefers the per-unit model when it has been learned for ``kind``:
        the step model prices every step at the fastest *observed* step —
        usually a wide prefill chunk — so a decode phase of N one-token
        steps is under-priced by up to the chunk width, while conversely a
        request whose remaining work is mostly prefill is over-priced when
        the fastest step was a narrow decode. Seconds-per-unit is invariant
        to how the engine chunks the work, so mixed chunk widths no longer
        misprice deadlines. Falls back to the step model until a costed
        report for ``kind`` arrives; None when nothing is learned yet.
        """
        spu = self._sec_per_unit.get(kind)
        if spu is not None:
            return self._optimistic_units(prefill_rem, decode_rem) * spu
        if self._sec_per_step is not None:
            return (self._optimistic_steps(prefill_rem, decode_rem)
                    * self._sec_per_step)
        return None

    def _hopeless(self, request: Request, now: float) -> bool:
        if request.deadline_at is None:
            return False
        prefill, decode = self._service_units(request)
        est = self._estimate_seconds(prefill, decode,
                                     self._request_kind(request))
        if est is None:
            return False
        return now + est > request.deadline_at

    # -- Scheduler protocol -------------------------------------------------

    def select(self, queue: Sequence[Request], free: int, *,
               key_fn: KeyFn, active_key: Optional[Hashable]) -> List[Request]:
        if not queue or free <= 0:
            return []
        deadlined = sorted(
            (r for r in queue if r.deadline_s is not None),
            key=lambda r: (-r.priority, r.deadline_at, r.arrival_s))
        key = active_key
        if key is None and deadlined:
            key = key_fn(deadlined[0])
        if key is None:                       # no deadlines anywhere: pure inner
            return self.inner.select(queue, free, key_fn=key_fn,
                                     active_key=None)
        urgent = [r for r in deadlined if key_fn(r) == key]
        picks = [r for r in urgent
                 if not self._hopeless(r, self._now)][:free]
        if len(picks) < free:
            rest = [r for r in queue if r.deadline_s is None]
            picks = picks + self.inner.select(
                rest, free - len(picks), key_fn=key_fn, active_key=key)
        if not picks and active_key is None:
            # contract: an idle engine with a non-empty queue must make
            # progress — admit the head even if it is predicted to miss
            # (the engine will expire it with a partial result)
            picks = [r for r in queue if key_fn(r) == key][:1]
        return picks

    def on_admit(self, request: Request) -> None:
        self.inner.on_admit(request)

    def observe(self, request: Request, result: Result) -> None:
        self.inner.observe(request, result)

    # -- optional EngineCore hooks ------------------------------------------

    def plan_step(self, residents: Mapping[int, Request],
                  progress: Mapping[int, SlotProgress], *,
                  now: float, default: StepBudget) -> StepBudget:
        self._now = now
        if self._sec_per_step is None:
            return default
        per = dict(default.per_slot or {})
        for slot, req in residents.items():
            prog = progress.get(slot)
            if req.deadline_at is None or prog is None or prog.phase != "prefill":
                continue
            decode = int(req.options.get("max_new_tokens", 0))
            prefill_rem = max(0, prog.units_total - decode - prog.units_done)
            slack_steps = (req.deadline_at - now) / self._sec_per_step - decode
            if slack_steps <= 0:
                chunk = self.boost_cap      # racing an already-tight deadline
            else:
                chunk = math.ceil(prefill_rem / max(1.0, slack_steps))
            if chunk > default.for_slot(slot):
                per[slot] = min(self.boost_cap, chunk)
        if per == (default.per_slot or {}):
            return default
        return StepBudget(units=default.units, chunk=default.chunk,
                          per_slot=per)

    def on_report(self, report: StepReport, *, seconds: float,
                  now: float) -> None:
        self._now = now
        if seconds <= 0:
            return
        old = self._sec_per_step
        self._sec_per_step = seconds if old is None else min(old, seconds)
        units = int(report.cost.get("units", 0) or 0)
        kind = self._report_kind(report.cost)
        if units > 0 and kind is not None:
            spu = seconds / units
            prev = self._sec_per_unit.get(kind)
            self._sec_per_unit[kind] = spu if prev is None else min(prev, spu)
        if kind == "lm":
            # the per-unit model stays a lower bound under speculation
            # (every emitted token costs >= 1 forward unit); the *step*
            # model must additionally learn that one step can emit several
            # tokens per slot, or it over-prices pure-decode tails
            for prog in report.progress.values():
                emitted = len(prog.emitted)
                if emitted > self._max_decode_per_slot_step:
                    self._max_decode_per_slot_step = emitted

    def expire(self, residents: Mapping[int, Request],
               progress: Mapping[int, SlotProgress], *,
               now: float) -> List[int]:
        self._now = now
        out: List[int] = []
        for slot, req in residents.items():
            prog = progress.get(slot)
            if req.deadline_at is None or prog is None:
                continue
            decode = int(req.options.get("max_new_tokens", 0))
            if prog.phase == "prefill":
                prefill_rem = max(0, prog.units_total - decode - prog.units_done)
                decode_rem = decode
            else:
                prefill_rem = 0
                decode_rem = max(0, prog.units_total - prog.units_done)
            est = self._estimate_seconds(prefill_rem, decode_rem,
                                         self._request_kind(req))
            if est is not None and now + est > req.deadline_at:
                out.append(req.request_id)
        return out

    def metrics_into(self, registry) -> None:
        """Publish the learned cost model into a `repro.obs` registry
        (snapshot-time pull hook; see `SparsityAwareScheduler.metrics_into`).
        Unlearned figures read 0. Delegates to the inner policy too, so
        'slo:sparsity' publishes both layers."""
        registry.gauge(
            "scheduler_sec_per_step",
            "fastest observed engine-clock seconds per step").set(
                self._sec_per_step or 0.0)
        for kind in ("lm", "snn"):
            registry.gauge(
                f"scheduler_sec_per_unit_{kind}",
                f"fastest observed seconds per {kind} work unit").set(
                    self._sec_per_unit.get(kind, 0.0))
        registry.gauge(
            "scheduler_max_decode_per_slot_step",
            "most decode tokens one slot emitted in one step").set(
                self._max_decode_per_slot_step)
        inner_publish = getattr(self.inner, "metrics_into", None)
        if inner_publish is not None:
            inner_publish(registry)


SCHEDULERS = {
    "fifo": FIFOScheduler,
    "sparsity": SparsityAwareScheduler,
    "slo": SLOScheduler,
}


def make_scheduler(name: str, **kwargs) -> Scheduler:
    """Build a scheduler by `EngineConfig.scheduler` name.

    'fifo' | 'sparsity' | 'slo' — and the composed form 'slo:<inner>'
    (e.g. 'slo:sparsity'), which wraps the inner policy in an
    `SLOScheduler`; kwargs go to the outer scheduler in that case.
    """
    if name.startswith("slo:"):
        inner = make_scheduler(name.split(":", 1)[1])
        return SLOScheduler(inner, **kwargs)
    try:
        cls = SCHEDULERS[name]
    except KeyError:
        raise ValueError(
            f"unknown scheduler {name!r}; choose from "
            f"{sorted(SCHEDULERS) + ['slo:<inner>']}")
    return cls(**kwargs)
