"""Supervised multi-replica serving: the fleet layer over `EngineCore`.

The ROADMAP's fleet north star — N replicas behind one `submit()` — is only
worth having if it *survives* the faults production traffic generates: a
wedged session, a NaN-poisoned kernel, a queue flood. `Router` is that
layer, in-process:

* **load balancing** — `submit()` places each request on the healthy
  replica with the cheapest estimated backlog: outstanding work units
  (tokens/timesteps the router already routed there) priced by a learned
  per-replica seconds-per-unit EWMA, the fleet-level counterpart of
  `SLOScheduler`'s per-workload cost model. Streaming callers pass
  ``affinity=`` to pin a stream's requests to one replica (KV locality).
* **health supervision** — every `step()` the router advances each healthy
  replica and probes it. Heartbeat: a replica holding work that makes no
  progress (`EngineCore._progress_marker`) for ``wedge_patience``
  consecutive steps — or whose step takes longer than the learned fleet
  baseline times ``stall_factor`` (or an absolute ``stall_seconds``) — is
  WEDGED. Numerics: a step that trips the engine's NaN/Inf screen
  (``stats()['failed']`` delta, or non-finite `StepReport.cost`) marks the
  replica POISONED. A replica whose ``step()`` raises is WEDGED with the
  exception recorded. Either way it is drained and retired from placement.
* **drain + re-route by deterministic replay** — in-flight requests on a
  condemned replica are re-submitted from their frozen `Request` payloads
  to a healthy replica. Runners are deterministic (greedy decode,
  row-independent slots), so the replay is bit-identical to a fault-free
  run; partials the caller already saw are deduplicated by count, and the
  absolute deadline is preserved (the remaining budget is recomputed on
  the shared clock). Each request carries ``max_retries`` re-routes; past
  that it retires ``status='failed'``, past its deadline ``'expired'``.
* **graceful overload** — `submit()` never raises: a replica's `QueueFull`
  parks the request in a router-side waiting line with exponential backoff
  (retry after 1, 2, 4, ... router steps), and when the line itself
  overflows ``max_waiting`` the *lowest-priority* (then newest) waiters
  are shed with ``status='rejected'`` — an explicit outcome instead of
  silently blowing the deadline of everything behind them.

The router speaks the same request surface as a single engine (`submit` /
`poll` / `poll_partial` / `cancel` / `run_until_complete` / `stats`), so
callers like `launch/serve.py --replicas N` swap it in transparently.
Fault schedules for chaos tests/benches come from `serve.faults`
(`make_router(..., plans=...)` wraps each replica in a `FaultyRunner`).

**Transports.** The router never talks to an `EngineCore` directly any
more — it talks to a `Transport`, the seam that makes supervision
deployment-agnostic. `InProcTransport` wraps an in-process engine
bit-identically (the default: `make_router` fleets behave exactly as
before), and `serve.worker.SubprocessTransport` speaks the versioned wire
protocol (`serve.wire`) to an engine hosted in a worker subprocess
(`make_worker_fleet`, `launch/serve.py --workers N`). Every health probe
above reads transport methods (`progress_marker`, `failed_count`,
`cost_finite`) that in-process delegate to engine internals and over the
wire come from `HeartbeatMsg` piggybacked on step replies — so stall
detection, the NaN probe and drain + deterministic-replay re-route work
unchanged when a worker hangs or dies outright: a dead pipe raises
`TransportError` from `step()`/`submit_spec()`, which condemns the replica
exactly like an in-process step fault.

Pure Python over the port's `EngineCore`: a copy of the JAX package's
serve/router.py, kept so the port stands alone. One departure:
`make_worker_fleet` builds the hand-kernel library in the parent before it
spawns card workers that serve the SNN (see there).
"""
from __future__ import annotations

import collections
import dataclasses
from typing import (Any, Callable, Dict, List, Mapping, Optional, Protocol,
                    Sequence, Set, Tuple, runtime_checkable)

import torch

from ..obs import Observability, aggregate, merge_traces
from .api import (EngineConfig, EngineStalled, ModelRunner, QueueFull,
                  Request, Result, SubmitSpec)
from .core import EngineCore, all_finite
from .faults import FaultPlan, FaultyRunner, TickClock

#: replica lifecycle: healthy -> (wedged | poisoned) -> drained
HEALTHY, WEDGED, POISONED, DRAINED = "healthy", "wedged", "poisoned", "drained"


class TransportError(RuntimeError):
    """A transport lost its replica (dead worker, broken pipe, timed-out
    step). Raised from `Transport.step`/`submit_spec`; the router responds
    by condemning the replica and re-routing its in-flight requests, the
    same path an in-process step exception takes."""


@runtime_checkable
class Transport(Protocol):
    """What the router needs from a replica, wherever it lives.

    The probe surface is exactly the supervision contract: a cumulative
    progress marker (retired, work_units, decode_tokens, queue_len), the
    numerics-screen failure count, and whether the last step's cost was
    finite. In-process these read engine internals; over the wire they are
    the `serve.wire.HeartbeatMsg` fields.
    """

    #: clock the replica stamps deadlines on (the router adopts the first
    #: replica's clock when none is passed)
    clock: Callable[[], float]

    def submit_spec(self, spec: SubmitSpec) -> int: ...
    def poll(self, request_id: int) -> Optional[Result]: ...
    def poll_partial(self, request_id: int) -> List[Any]: ...
    def cancel(self, request_id: int, *, status: str = "cancelled") -> bool: ...
    def step(self) -> None: ...
    def progress_marker(self) -> Tuple[int, int, int, int]: ...
    def failed_count(self) -> int: ...
    def cost_finite(self) -> bool: ...
    def in_flight(self) -> int: ...
    def pending(self) -> int: ...
    def stats(self) -> Dict[str, Any]: ...
    def max_idle_steps(self) -> int: ...
    def close(self) -> None: ...


class InProcTransport:
    """`Transport` over an in-process `EngineCore` — the default deployment
    mode, bit-identical to the pre-seam router (every method is a direct
    delegation; no serialization, no copies). The wrapped engine stays
    reachable as ``.core`` for tests and schedulers that introspect slots."""

    def __init__(self, core: EngineCore):
        self.core = core
        self.clock = core._clock

    def submit_spec(self, spec: SubmitSpec) -> int:
        return self.core.submit_spec(spec)

    def poll(self, request_id: int) -> Optional[Result]:
        return self.core.poll(request_id)

    def poll_partial(self, request_id: int) -> List[Any]:
        return self.core.poll_partial(request_id)

    def cancel(self, request_id: int, *, status: str = "cancelled") -> bool:
        return self.core.cancel(request_id, status=status)

    def step(self) -> None:
        self.core.step()

    def progress_marker(self) -> Tuple[int, int, int, int]:
        return self.core._progress_marker()

    def failed_count(self) -> int:
        return self.core._failed

    def cost_finite(self) -> bool:
        report = self.core.last_report
        return report is None or all_finite(report.cost)

    def in_flight(self) -> int:
        return self.core.in_flight()

    def pending(self) -> int:
        return self.core.pending()

    def stats(self) -> Dict[str, Any]:
        return self.core.stats()

    def max_idle_steps(self) -> int:
        return self.core.config.max_idle_steps

    def close(self) -> None:
        pass


def _est_units(payload: Any, options: Mapping[str, Any]) -> int:
    """Outstanding-work estimate for load balancing: prompt + decode tokens
    for token-sequence (LM) payloads, 1 unit for anything else (an SNN
    request completes in one fused step). Only relative magnitudes matter —
    the same heuristic as `SLOScheduler._service_units`."""
    prefill = len(payload) if isinstance(payload, (list, tuple)) else 0
    return max(1, prefill + int(options.get("max_new_tokens", 0)))


@dataclasses.dataclass
class _Tracked:
    """Router-side record of one submitted request — everything needed to
    replay it from scratch on another replica."""
    rid: int
    payload: Any
    options: Dict[str, Any]
    priority: int
    deadline_at: Optional[float]        # absolute, on the shared clock
    affinity: Optional[Any]
    retries_left: int
    forwarded: int = 0                  # partial items surfaced to caller
    skip: int = 0                       # replayed partials to drop (dedup)
    attempts: int = 0                   # QueueFull backoff exponent


class _Replica:
    """One supervised replica (behind a `Transport`) and its health
    bookkeeping."""

    def __init__(self, idx: int, transport: Any):
        self.idx = idx
        self.transport = transport
        self.state = HEALTHY
        self.condition: Optional[str] = None    # why it left HEALTHY
        self.reason: Optional[str] = None
        self.idle_steps = 0                     # consecutive no-progress steps
        self.placed: Dict[int, int] = {}        # local rid -> router rid
        self.sec_per_unit = 1.0                 # EWMA, placement cost prior

    @property
    def core(self) -> Optional[EngineCore]:
        """The in-process engine, when there is one (`InProcTransport`);
        None for subprocess replicas. Tests and in-proc tooling reach
        through this."""
        return getattr(self.transport, "core", None)

    def busy(self) -> bool:
        return self.transport.in_flight() > 0 or self.transport.pending() > 0


class Router:
    """Fault-tolerant front end over N `EngineCore` replicas.

    replicas share one engine clock (deadlines are absolute on it); build
    fleets with `make_router`, which wires the shared clock and optional
    per-replica `FaultPlan`s.

    wedge_patience: consecutive no-progress steps of a busy replica before
                    it is condemned as WEDGED.
    stall_factor:   a step slower than ``stall_factor x`` the fastest
                    observed fleet step is treated as a stall (wall-clock
                    fleets); ``stall_seconds`` is the absolute variant for
                    deterministic clocks, where healthy steps cost 0.
    max_retries:    re-route budget per request; exhausting it retires the
                    request ``status='failed'``.
    max_waiting:    bound on the backoff line; beyond it the lowest-priority
                    waiters are shed ``status='rejected'``.
    tick_s:         seconds the router advances an owned `TickClock` per
                    `step()` (deterministic deadline pacing, like
                    `core.StepClock`); 0 leaves the clock alone.
    obs:            optional `repro_torch.obs.Observability` bundle for
                    *router-level* spans (one per request, submit ->
                    terminal status, on the router's step index) and fleet
                    counters. Per-replica observability lives on the
                    engines/workers themselves (`make_router(obs=True)` /
                    `make_worker_fleet(obs=True)`); `telemetry()` merges
                    both layers into one trace + one metrics snapshot.
    """

    def __init__(self, replicas: Sequence[Any], *,
                 clock: Optional[Callable[[], float]] = None,
                 wedge_patience: int = 3, stall_factor: float = 8.0,
                 stall_seconds: Optional[float] = None,
                 max_retries: int = 2, max_waiting: int = 64,
                 tick_s: float = 0.0, obs: Optional[Observability] = None):
        assert replicas, "router needs at least one replica"
        transports = [r if not isinstance(r, EngineCore) else InProcTransport(r)
                      for r in replicas]
        self.replicas = [_Replica(i, t) for i, t in enumerate(transports)]
        self._clock = clock if clock is not None else transports[0].clock
        self.wedge_patience = max(1, wedge_patience)
        self.stall_factor = stall_factor
        self.stall_seconds = stall_seconds
        self.max_retries = max_retries
        self.max_waiting = max_waiting
        self.tick_s = tick_s
        self._next_id = 0
        self._step_idx = 0
        self._requests: Dict[int, _Tracked] = {}
        self._placement: Dict[int, int] = {}        # router rid -> replica idx
        self._results: Dict[int, Result] = {}
        self._partials: Dict[int, List[Any]] = {}
        self._outstanding: Set[int] = set()
        self._waiting: Dict[int, int] = {}          # router rid -> due step
        self._affinity: Dict[Any, int] = {}         # key -> replica idx
        self._fastest_dt: Optional[float] = None    # learned fleet baseline
        self._counts = collections.Counter()
        self._rerouted = 0
        #: [(router step, replica idx, condition, [router rids re-routed],
        #: detail)] — the supervision audit trail benches mine for recovery
        #: latency. ``detail`` carries the condemned replica's last progress
        #: marker + cost_finite probe and, when the replica was observed,
        #: its flight-recorder postmortem under ``'dump'``.
        self.drain_log: List[tuple] = []
        #: router rid -> router step of its terminal result
        self.completed_at: Dict[int, int] = {}
        self.obs = obs

    # -- request surface -----------------------------------------------------

    def submit(self, payload: Any, *, deadline_s: Optional[float] = None,
               priority: int = 0, affinity: Optional[Any] = None,
               **options: Any) -> int:
        """Admit one request to the fleet; returns its router-scoped id.

        The kwarg surface is `EngineCore.submit`'s exactly (one shared
        `api.SubmitSpec` shape; unknown/ill-typed options raise here) plus
        ``affinity`` — a routing concern, not a request option, so it stays
        a first-class router kwarg.

        Never raises `QueueFull`: overload parks the request in the backoff
        line and, past ``max_waiting``, sheds by priority with
        ``status='rejected'`` (see class docstring)."""
        return self.submit_spec(
            SubmitSpec.make(payload, deadline_s=deadline_s,
                            priority=priority, **options),
            affinity=affinity)

    def submit_spec(self, spec: SubmitSpec, *,
                    affinity: Optional[Any] = None) -> int:
        """Admit one already-validated `api.SubmitSpec` to the fleet."""
        rid = self._next_id
        self._next_id += 1
        now = self._clock()
        self._requests[rid] = _Tracked(
            rid, spec.payload, dict(spec.options), spec.priority,
            None if spec.deadline_s is None else now + spec.deadline_s,
            affinity, self.max_retries)
        self._outstanding.add(rid)
        if self.obs is not None:
            if self.obs.tracer is not None:
                self.obs.tracer.begin(rid, self._step_idx, now,
                                      layer="router", priority=spec.priority)
            if self.obs.metrics is not None:
                self.obs.metrics.counter(
                    "router_submitted", "requests admitted to the fleet").inc()
        self._try_place(rid)
        return rid

    def poll(self, request_id: int) -> Optional[Result]:
        """Return (and retire) the terminal `Result`, or None while the
        request is queued/running. Statuses: ok | cancelled | expired |
        failed | rejected. Unlike `EngineCore.poll`, retrieving a *non-ok*
        result keeps its undrained partials available to `poll_partial` —
        for a failed/expired request the clean partial stream is the only
        output there is ("partials intact")."""
        res = self._results.pop(request_id, None)
        if res is not None and res.status == "ok":
            self._partials.pop(request_id, None)
        return res

    def poll_partial(self, request_id: int) -> List[Any]:
        """Drain partial outputs streamed since the last call. Replayed
        requests never re-deliver items the caller already saw."""
        return self._partials.pop(request_id, [])

    def cancel(self, request_id: int) -> bool:
        """Cancel a waiting or in-flight request fleet-wide."""
        if request_id in self._waiting:
            del self._waiting[request_id]
            self._finish(request_id, Result(request_id, None, {}, "cancelled"))
            return True
        idx = self._placement.get(request_id)
        if idx is None:
            return False
        replica = self.replicas[idx]
        local = next(l for l, r in replica.placed.items() if r == request_id)
        self._drain_partials(replica)
        if not replica.transport.cancel(local):
            return False
        del replica.placed[local]
        res = replica.transport.poll(local)
        self._finish(request_id,
                     res if res is not None
                     else Result(request_id, None, {}, "cancelled"))
        return True

    # -- placement -----------------------------------------------------------

    def _healthy(self) -> List[_Replica]:
        return [r for r in self.replicas if r.state == HEALTHY]

    def _outstanding_units(self, replica: _Replica) -> int:
        units = 0
        for rid in replica.placed.values():
            t = self._requests.get(rid)
            if t is not None:
                units += _est_units(t.payload, t.options)
        return units

    def _pick_replica(self, tracked: _Tracked) -> Optional[_Replica]:
        healthy = self._healthy()
        if not healthy:
            return None
        if tracked.affinity is not None:
            pinned = self._affinity.get(tracked.affinity)
            if pinned is not None and self.replicas[pinned].state == HEALTHY:
                return self.replicas[pinned]
        est = _est_units(tracked.payload, tracked.options)
        best = min(healthy, key=lambda r: (
            (self._outstanding_units(r) + r.transport.pending() + est)
            * r.sec_per_unit, r.idx))
        if tracked.affinity is not None:
            self._affinity[tracked.affinity] = best.idx
        return best

    def _try_place(self, rid: int) -> bool:
        """Place a tracked request on the best healthy replica; on
        `QueueFull` park it in the backoff line. Returns True if placed."""
        tracked = self._requests[rid]
        now = self._clock()
        if tracked.deadline_at is not None and now >= tracked.deadline_at:
            self._waiting.pop(rid, None)
            self._finish(rid, Result(rid, None, {}, "expired"))
            return False
        replica = self._pick_replica(tracked)
        if replica is None:
            # every replica condemned: nothing can ever run this request
            self._waiting.pop(rid, None)
            self._finish(rid, Result(rid, None, {}, "failed"))
            return False
        deadline_s = (None if tracked.deadline_at is None
                      else tracked.deadline_at - now)
        # options were validated at Router.submit; the replay spec skips
        # re-parsing (plain constructor) so a re-route can never be rejected
        spec = SubmitSpec(payload=tracked.payload, deadline_s=deadline_s,
                          priority=tracked.priority, options=tracked.options)
        try:
            local = replica.transport.submit_spec(spec)
        except QueueFull:
            tracked.attempts += 1
            self._waiting[rid] = self._step_idx + 2 ** (tracked.attempts - 1)
            self._shed_overflow()
            return False
        except TransportError as e:
            # the worker died between supervision steps; condemn it now and
            # place the request elsewhere (the replica is no longer healthy,
            # so the recursion is bounded by the fleet size)
            self._condemn(replica, WEDGED, f"transport failed at submit: {e}")
            return self._try_place(rid)
        self._waiting.pop(rid, None)
        replica.placed[local] = rid
        self._placement[rid] = replica.idx
        return True

    def _shed_overflow(self) -> None:
        while len(self._waiting) > self.max_waiting:
            rid = min(self._waiting,
                      key=lambda r: (self._requests[r].priority, -r))
            del self._waiting[rid]
            self._finish(rid, Result(rid, None, {}, "rejected"))

    # -- supervision ---------------------------------------------------------

    def step(self) -> int:
        """Advance the fleet one supervision round; returns requests that
        reached a terminal result this round. Order: retry waiters, step +
        probe every healthy replica, collect partials/results, drain and
        re-route condemned replicas."""
        self._step_idx += 1
        if self.tick_s and hasattr(self._clock, "advance"):
            self._clock.advance(self.tick_s)
        finished_before = sum(self._counts.values())

        for rid, due in sorted(self._waiting.items(),
                               key=lambda kv: (-self._requests[kv[0]].priority,
                                               kv[0])):
            if due <= self._step_idx:
                self._try_place(rid)

        for replica in list(self.replicas):
            if replica.state != HEALTHY:
                continue
            if not replica.busy():
                replica.idle_steps = 0
                continue
            marker0 = replica.transport.progress_marker()
            failed0 = replica.transport.failed_count()
            t0 = self._clock()
            try:
                replica.transport.step()
            except Exception as e:          # mid-step fault: condemn replica
                self._condemn(replica, WEDGED, f"step raised: {e!r}")
                continue
            dt = self._clock() - t0
            self._drain_partials(replica)
            self._collect_results(replica)
            self._learn_cost(replica, marker0, dt)
            if replica.transport.failed_count() > failed0 or (
                    not replica.transport.cost_finite()):
                self._condemn(replica, POISONED,
                              "numerics screen tripped on step outputs")
                continue
            if self._stalled(dt):
                self._condemn(replica, WEDGED,
                              f"step took {dt:.3f}s vs fleet baseline "
                              f"{self._fastest_dt}")
                continue
            if replica.transport.progress_marker() == marker0 and replica.busy():
                replica.idle_steps += 1
                if replica.idle_steps >= self.wedge_patience:
                    self._condemn(replica, WEDGED,
                                  f"no progress for {replica.idle_steps} "
                                  "consecutive steps with work resident")
            else:
                replica.idle_steps = 0
        if self.obs is not None and self.obs.metrics is not None:
            m = self.obs.metrics
            m.counter("router_steps", "fleet supervision rounds").inc()
            m.gauge("router_waiting",
                    "requests parked in the backoff line").set(
                        len(self._waiting))
            m.gauge("router_healthy_replicas",
                    "replicas in HEALTHY state").set(len(self._healthy()))
        return sum(self._counts.values()) - finished_before

    def _learn_cost(self, replica: _Replica, marker0, dt: float) -> None:
        units = replica.transport.progress_marker()[1] - marker0[1]
        if dt > 0:
            self._fastest_dt = dt if self._fastest_dt is None \
                else min(self._fastest_dt, dt)
            if units > 0:
                sample = dt / units
                replica.sec_per_unit = (0.3 * sample
                                        + 0.7 * replica.sec_per_unit)

    def _stalled(self, dt: float) -> bool:
        if self.stall_seconds is not None and dt >= self.stall_seconds:
            return True
        return (self._fastest_dt is not None and dt > 0
                and dt > self.stall_factor * self._fastest_dt
                and self._fastest_dt > 0)

    def _drain_partials(self, replica: _Replica) -> None:
        for local, rid in list(replica.placed.items()):
            items = replica.transport.poll_partial(local)
            if not items:
                continue
            tracked = self._requests.get(rid)
            if tracked is None:
                continue
            fresh: List[Any] = []
            for item in items:
                if tracked.skip > 0:    # replay re-emitted a seen partial
                    tracked.skip -= 1
                    continue
                fresh.append(item)
            if fresh:
                tracked.forwarded += len(fresh)
                self._partials.setdefault(rid, []).extend(fresh)

    def _collect_results(self, replica: _Replica) -> None:
        for local, rid in list(replica.placed.items()):
            res = replica.transport.poll(local)
            if res is None:
                continue
            del replica.placed[local]
            self._finish(rid, res)

    def _condemn(self, replica: _Replica, condition: str, reason: str) -> None:
        """Mark a replica WEDGED/POISONED, salvage what it finished, and
        re-route its in-flight requests by deterministic replay."""
        replica.condition = condition
        replica.reason = reason
        replica.state = condition
        self._drain_partials(replica)
        self._collect_results(replica)      # salvage already-finished work
        rerouted: List[int] = []
        now = self._clock()
        for local, rid in list(replica.placed.items()):
            tracked = self._requests.get(rid)
            # reclaim the slot/queue entry; the inner session is clean, so
            # this cannot disturb anything else on the replica (a dead
            # transport returns False/None here — nothing left to salvage)
            replica.transport.cancel(local)
            self._drain_partials(replica)
            salvage = replica.transport.poll(local)
            del replica.placed[local]
            self._placement.pop(rid, None)
            if tracked is None:
                continue
            if tracked.deadline_at is not None and now >= tracked.deadline_at:
                self._finish(rid, dataclasses.replace(
                    salvage or Result(rid, None, {}), status="expired"))
            elif tracked.retries_left > 0:
                tracked.retries_left -= 1
                tracked.skip = tracked.forwarded    # dedup the replay stream
                rerouted.append(rid)
                self._rerouted += 1
                self._try_place(rid)
            else:
                self._finish(rid, dataclasses.replace(
                    salvage or Result(rid, None, {}), status="failed"))
        replica.state = DRAINED
        # postmortem detail: the supervision probes the parent already holds
        # (heartbeat-cached for workers, direct reads in-process) plus the
        # replica's flight-recorder dump when it was observed
        detail: Dict[str, Any] = {
            "reason": reason,
            "marker": tuple(replica.transport.progress_marker()),
            "cost_finite": replica.transport.cost_finite(),
        }
        dump = None
        core = replica.core
        if core is not None and getattr(core, "obs", None) is not None:
            dump = core.obs.on_dump(condition, self._step_idx,
                                    replica=replica.idx)
        else:
            dump_fn = getattr(replica.transport, "recorder_dump", None)
            if dump_fn is not None:
                dump = dump_fn(condition)
        if dump is not None:
            detail["dump"] = dump
        if self.obs is not None and self.obs.metrics is not None:
            self.obs.metrics.counter(
                "router_drains", "replicas condemned and drained").inc()
            self.obs.metrics.counter(
                "router_rerouted",
                "requests re-routed by deterministic replay").inc(
                    len(rerouted))
        self.drain_log.append((self._step_idx, replica.idx, condition,
                               rerouted, detail))

    def _finish(self, rid: int, result: Result) -> None:
        if result.request_id != rid:
            result = dataclasses.replace(result, request_id=rid)
        self._results[rid] = result
        self._placement.pop(rid, None)
        self._outstanding.discard(rid)
        self._requests.pop(rid, None)
        self._counts[result.status] += 1
        self.completed_at[rid] = self._step_idx
        if self.obs is not None:
            if self.obs.tracer is not None:
                self.obs.tracer.end(rid, result.status, self._step_idx,
                                    self._clock())
            if self.obs.metrics is not None:
                self.obs.metrics.counter(
                    f"router_retired_{result.status}",
                    f"requests retired with status={result.status}").inc()

    # -- drain loop ----------------------------------------------------------

    def run_until_complete(self, *, max_idle_steps: Optional[int] = None
                           ) -> Dict[int, Result]:
        """Step the fleet until every submitted request has a terminal
        result; returns (and retires) all unpolled results. Raises
        `EngineStalled` after ``max_idle_steps`` consecutive rounds with no
        fleet-wide progress (default: the first replica's configured
        guard) — possible only if supervision itself cannot retire the
        stuck work (e.g. the guard is set too tight)."""
        limit = (self.replicas[0].transport.max_idle_steps()
                 if max_idle_steps is None else max_idle_steps)
        idle = 0
        while self._outstanding:
            before = self._fleet_marker()
            self.step()
            idle = 0 if self._fleet_marker() != before else idle + 1
            if limit and idle >= limit:
                raise EngineStalled(
                    f"fleet made no progress for {idle} consecutive router "
                    f"steps (outstanding={sorted(self._outstanding)}, "
                    f"states={[r.state for r in self.replicas]}, "
                    f"waiting={sorted(self._waiting)})")
        out, self._results = self._results, {}
        for rid, res in out.items():
            if res.status == "ok":      # non-ok keeps partials pollable
                self._partials.pop(rid, None)
        return out

    def _fleet_marker(self) -> tuple:
        return (sum(self._counts.values()), len(self._waiting),
                tuple(r.transport.progress_marker() for r in self.replicas),
                tuple(r.state for r in self.replicas))

    # -- introspection -------------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        return {
            "router_steps": self._step_idx,
            "replicas": [{
                "idx": r.idx,
                "state": r.state,
                "condition": r.condition,
                "reason": r.reason,
                "sec_per_unit": r.sec_per_unit,
                "stats": r.transport.stats(),
            } for r in self.replicas],
            "healthy": len(self._healthy()),
            "rerouted": self._rerouted,
            "waiting": len(self._waiting),
            "outstanding": len(self._outstanding),
            "drains": len(self.drain_log),
            **{status: self._counts.get(status, 0)
               for status in ("ok", "cancelled", "expired", "failed",
                              "rejected")},
        }

    def telemetry(self) -> Dict[str, Any]:
        """One merged observability view of the whole fleet: every
        replica's spans namespaced by replica index (plus the router's own
        spans under ``'router'``) via `repro_torch.obs.merge_traces`, per-replica
        metrics folded with `repro_torch.obs.aggregate`, and every
        flight-recorder dump taken anywhere. Works for in-process replicas
        (read off `EngineCore.obs` directly) and subprocess workers (read
        off the heartbeat telemetry their transport accumulated); replicas
        that were never observed simply contribute nothing."""
        parts: List[Tuple[Any, List[Dict[str, Any]]]] = []
        metrics_parts: Dict[Any, Mapping[str, Any]] = {}
        dumps: List[Dict[str, Any]] = []
        if self.obs is not None:
            if self.obs.tracer is not None:
                parts.append(("router", self.obs.tracer.export()))
            if self.obs.metrics is not None:
                metrics_parts["router"] = self.obs.metrics.snapshot()
        for replica in self.replicas:
            core = replica.core
            if core is not None and getattr(core, "obs", None) is not None:
                snap = core.obs.snapshot()
                parts.append((replica.idx, snap.get("trace", [])))
                if "metrics" in snap:
                    metrics_parts[replica.idx] = snap["metrics"]
                dumps.extend(snap.get("dumps", ()))
            elif getattr(replica.transport, "obs", False):
                tel = replica.transport.telemetry()
                parts.append((replica.idx, tel.get("spans", [])))
                if tel.get("metrics"):
                    metrics_parts[replica.idx] = tel["metrics"]
                dumps.extend(tel.get("dumps", ()))
        return {"trace": merge_traces(parts),
                "metrics": aggregate(metrics_parts),
                "dumps": dumps}

    def close(self) -> None:
        """Release every replica's transport (terminates subprocess
        workers; a no-op for in-process fleets)."""
        for replica in self.replicas:
            replica.transport.close()


def make_router(runner: ModelRunner, n: int,
                config: EngineConfig = EngineConfig(), *,
                plans: Optional[Mapping[int, FaultPlan]] = None,
                clock: Optional[Callable[[], float]] = None,
                obs: bool = False, **router_kwargs) -> Router:
    """Build an N-replica fleet over one `ModelRunner`.

    Every replica gets its own `EngineCore` (own queue, slots, sessions)
    over the shared ``runner``, wrapped in a `serve.faults.FaultyRunner` so
    replica behavior differs only by its `FaultPlan` (``plans`` maps
    replica index -> plan; missing indices get the empty, transparent
    plan). All replicas and the router share one clock; when none is
    passed, a deterministic `TickClock` advanced 1 s per router step is
    created — the fleet analogue of `core.StepClock`.

    obs=True attaches one `repro_torch.obs.Observability` bundle per replica and
    one to the router; `Router.telemetry()` then yields the merged fleet
    trace/metrics/dumps. Off by default and bit-identical when on."""
    owned = clock is None
    if owned:
        clock = TickClock()
    plans = dict(plans or {})
    cores = [EngineCore(FaultyRunner(runner, plans.get(i), clock),
                        config, clock=clock,
                        obs=Observability() if obs else None)
             for i in range(n)]
    if owned:
        router_kwargs.setdefault("tick_s", 1.0)
    return Router(cores, clock=clock,
                  obs=Observability() if obs else None, **router_kwargs)


def make_worker_fleet(spec: Any, n: int,
                      config: EngineConfig = EngineConfig(), *,
                      step_timeout_s: float = 120.0, obs: bool = False,
                      **router_kwargs) -> Router:
    """Build an N-worker *subprocess* fleet: one `serve.worker` process per
    replica, each hosting its own `EngineCore` + runner built from the
    wire-encodable ``spec`` (`serve.worker.RunnerSpec`), supervised over
    the versioned wire protocol.

    Workers run on wall clocks (each stamps deadlines on its own
    ``time.monotonic``; the router forwards *remaining* deadline seconds,
    so absolute deadlines survive re-routes). The relative stall-ratio
    probe is disabled by default — a worker's first step on the card loads
    the kernel library and the CUDA libraries' kernels, so honest
    wall-clock variance would trip ``stall_factor`` — while the
    heartbeat progress probe, the NaN probe, and dead-pipe detection
    (`TransportError` -> condemn -> replay) carry the supervision load.
    Pass ``stall_seconds`` for an absolute hang bound below the
    transport's own ``step_timeout_s``.

    obs=True asks every worker (via the v2 hello) to observe its engine
    and ship telemetry increments on each heartbeat; `Router.telemetry()`
    merges them — spans from all workers plus the router's own — into one
    cross-process trace.

    Unlike the reference, when ``spec`` serves the SNN on the card the
    parent builds the hand-kernel library before it spawns (the LM runners
    launch no hand kernel): workers then load it from
    ``build/repro_torch/<hash>/`` instead of each running nvcc inside its
    handshake.
    """
    from .worker import SubprocessTransport
    if spec.kind == "snn" and torch.device(spec.device).type == "cuda":
        from ..kernels import _build
        _build.build()
    transports = [SubprocessTransport(spec, config,
                                      step_timeout_s=step_timeout_s, obs=obs)
                  for _ in range(n)]
    router_kwargs.setdefault("stall_factor", float("inf"))
    return Router(transports,
                  obs=Observability() if obs else None, **router_kwargs)
