"""Workload-agnostic serving API: Request/Result dataclasses + runner protocol.

The paper's hybrid architecture is an inference *serving* design: a dense
core plus sparse event-driven cores fed by a stream of inputs. This module is
the software seam for that design — one request/result vocabulary shared by
every workload the engine can serve (today: the unified LM and the spiking
VGG9), so the scheduler (`serve.core.EngineCore`) never needs to know what a
payload is.

Sparsity-aware co-design (Aliyev et al., arXiv:2408.14437) requires the
software stack to surface *per-request* sparsity to the scheduler; `Result`
therefore carries per-request stats next to the outputs: tile-skip rates of
the occupancy-mapped kernels, spike counts, and the paper-model energy
estimate for SNN requests; prompt/decode accounting for LM requests.

Numpy only: a copy of the JAX package's serve/api.py, kept so the
port stands alone.
"""
from __future__ import annotations

import dataclasses
from typing import (Any, Hashable, Mapping, Optional, Protocol, Sequence,
                    Tuple, runtime_checkable)

# Request id used for the filler requests that pad a batch to the full slot
# count. Results for pad slots are dropped by the engine, never surfaced.
PAD_REQUEST_ID = -1


@dataclasses.dataclass(frozen=True)
class Request:
    """One admitted unit of work.

    payload is workload-defined: a token-id list for the LM runner, an
    [H, W, C] image for the SNN runner. options carry per-request knobs the
    runner understands: ``max_new_tokens`` for the LM, plus the sampling
    keys the continuous-admission LM runner parses into
    `serve.sampling.SamplingParams` — ``temperature`` (0.0 = greedy),
    ``top_k``, ``top_p``, ``seed`` (per-request PRNG seed; the token at
    generation index i is a pure function of (seed, i, logits), so router
    replay and engine restarts reproduce the stream bit-identically) and
    ``logprobs`` (surface per-token logprobs even for greedy requests).
    Options ride the frozen Request through queue, drain and re-route
    untouched, which is what makes replay determinism possible.

    deadline_s/priority are scheduler-facing lifecycle knobs (first-class,
    not options, because the engine itself acts on them):

    deadline_s: latency SLO in engine-clock seconds *relative to submission*.
                A request past ``arrival_s + deadline_s`` at a step boundary
                is retired with ``Result.status == 'expired'`` (queued or
                resident; residents surface their partial progress). None =
                no deadline.
    priority:   strict admission class for deadline-aware schedulers;
                higher wins over any deadline in a lower class, and the
                tightest deadline wins within a class. Ignored by
                FIFO/sparsity.
    arrival_s:  engine-clock timestamp stamped by `EngineCore.submit` —
                the reference point for ``deadline_s``.
    """
    request_id: int
    payload: Any
    options: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    deadline_s: Optional[float] = None
    priority: int = 0
    arrival_s: float = 0.0

    @property
    def is_pad(self) -> bool:
        return self.request_id < 0

    @property
    def deadline_at(self) -> Optional[float]:
        """Absolute engine-clock deadline, or None."""
        if self.deadline_s is None:
            return None
        return self.arrival_s + self.deadline_s


def _is_int(value: Any) -> bool:
    return isinstance(value, int) and not isinstance(value, bool)


def _is_num(value: Any) -> bool:
    return isinstance(value, (int, float)) and not isinstance(value, bool)


#: validator table for every option key any layer of the stack reads.
#: (predicate, human-readable expectation) — the single place a new
#: per-request knob gets registered so it is accepted at submit() and at
#: the wire boundary.
OPTION_SPECS: Mapping[str, Any] = {
    # LM decode budget
    "max_new_tokens": (lambda v: _is_int(v) and v >= 0, "int >= 0"),
    # sampling layer (serve.sampling.SamplingParams)
    "temperature": (lambda v: _is_num(v) and v >= 0.0, "number >= 0"),
    "top_k": (lambda v: _is_int(v) and v >= 0, "int >= 0"),
    "top_p": (lambda v: _is_num(v) and 0.0 < v <= 1.0, "number in (0, 1]"),
    "seed": (lambda v: _is_int(v), "int"),
    "logprobs": (lambda v: isinstance(v, bool), "bool"),
    # precision control (serve.precision)
    "pin_precision": (lambda v: v in ("fp32", "int4"),
                      "'fp32' or 'int4'"),
    # scheduler hints (serve.scheduler)
    "source": (lambda v: isinstance(v, str), "str"),
    "skip_hint": (lambda v: _is_num(v) and 0.0 <= v <= 1.0,
                  "number in [0, 1]"),
}

#: option keys that opt a request into the sampling path (mirrors
#: `serve.sampling.OPTION_KEYS`; asserted equal there)
SAMPLING_OPTION_KEYS = ("temperature", "top_k", "top_p", "seed", "logprobs")


@dataclasses.dataclass(frozen=True)
class RequestOptions:
    """Validated view of `Request.options`, parsed once at the submit
    boundary.

    Sampling, speculation, precision and the schedulers all read raw
    option dicts; before this class each consumed its keys ad-hoc, so a
    typo'd or ill-typed option surfaced (if ever) mid-step, deep inside a
    runner. `parse` is the single choke point: `EngineCore.submit`,
    `Router.submit` and the wire boundary (`serve.worker`) all call it, so
    unknown keys and ill-typed values fail *at submission* with a message
    naming the key — and a request that made it into the queue is known
    parseable by every downstream consumer.

    ``present`` records which keys the caller actually passed. That
    preservation matters: `serve.sampling.SamplingParams.from_options`
    returns None when *no* sampling key was passed (the zero-cost greedy
    path that never fetches logits), so "absent" and "present with the
    default value" are observably different requests.
    """
    max_new_tokens: int = 0
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0
    logprobs: bool = False
    pin_precision: Optional[str] = None
    source: Optional[str] = None
    skip_hint: Optional[float] = None
    present: Tuple[str, ...] = ()

    KEYS = tuple(OPTION_SPECS)

    @classmethod
    def parse(cls, options: Optional[Mapping[str, Any]]) -> "RequestOptions":
        """Validate a raw option mapping; raises ValueError on unknown
        keys or ill-typed/out-of-range values."""
        options = options or {}
        unknown = sorted(set(options) - set(OPTION_SPECS))
        if unknown:
            raise ValueError(
                f"unknown request option(s) {unknown}; known options: "
                f"{sorted(OPTION_SPECS)}")
        for key, value in options.items():
            ok, expect = OPTION_SPECS[key]
            if not ok(value):
                raise ValueError(
                    f"request option {key!r}={value!r} invalid: expected "
                    f"{expect}")
        fields = {k: options[k] for k in options}
        # numeric knobs normalize to their canonical python type
        if "temperature" in fields:
            fields["temperature"] = float(fields["temperature"])
        if "top_p" in fields:
            fields["top_p"] = float(fields["top_p"])
        if "skip_hint" in fields:
            fields["skip_hint"] = float(fields["skip_hint"])
        return cls(present=tuple(sorted(options)), **fields)

    @property
    def sampling(self):
        """`serve.sampling.SamplingParams` when any sampling key was
        present, else None — the `SamplingParams.from_options` contract,
        ported here so the opt-in semantics live with the validation."""
        if not any(k in self.present for k in SAMPLING_OPTION_KEYS):
            return None
        from .sampling import SamplingParams
        return SamplingParams(temperature=self.temperature, top_k=self.top_k,
                              top_p=self.top_p, seed=self.seed,
                              logprobs=self.logprobs)


def validate_options(options: Optional[Mapping[str, Any]]) -> Mapping[str, Any]:
    """Validate and return ``options`` (convenience over
    `RequestOptions.parse` for call sites that keep the raw mapping)."""
    RequestOptions.parse(options)
    return dict(options or {})


@dataclasses.dataclass(frozen=True)
class SubmitSpec:
    """The one canonical submit shape.

    `EngineCore.submit` and `Router.submit` used to duplicate the same
    ``(payload, *, deadline_s, priority, **options)`` kwarg list; both now
    parse into this spec, and the wire `SubmitMsg` serializes exactly
    these fields — one shape for in-process calls, the router's replay
    log, and the subprocess control plane.
    """
    payload: Any
    deadline_s: Optional[float] = None
    priority: int = 0
    options: Mapping[str, Any] = dataclasses.field(default_factory=dict)

    @classmethod
    def make(cls, payload: Any, *, deadline_s: Optional[float] = None,
             priority: int = 0, options: Optional[Mapping[str, Any]] = None,
             **extra: Any) -> "SubmitSpec":
        """Build + validate a spec from the submit kwarg surface. Option
        keys may come as an explicit ``options=`` mapping, as loose
        keyword arguments, or both (loose kwargs win on conflict)."""
        merged = dict(options or {})
        merged.update(extra)
        if deadline_s is not None:
            deadline_s = float(deadline_s)
            if deadline_s < 0:
                raise ValueError(f"deadline_s {deadline_s} < 0")
        return cls(payload=payload, deadline_s=deadline_s,
                   priority=int(priority),
                   options=validate_options(merged))


@dataclasses.dataclass(frozen=True)
class Result:
    """Outputs *and* per-request stats for one completed request.

    outputs: generated token list (LM) or class logits (SNN).
    stats:   flat mapping of per-request measurements.

    SNN result stats (see `runners.snn.SNNRunner`):

    ``skip_rate``        per-layer dict, each value in [0, 1]: the fraction of
                         (block_m x block_k) spike tiles the occupancy map
                         would skip if this request were served *alone* with
                         the same kernel plan (the request's own rows of the
                         folded [T*B*H*W, K] matmul, re-tiled at the layer's
                         block_m). The intrinsic sparsity signal schedulers
                         co-batch on; independent of slot-mates.
    ``batch_skip_rate``  per-layer dict: the skip rate the kernel actually
                         measured for the *whole* batch this request was
                         served in. The gap to ``skip_rate`` is the
                         co-batching penalty (dense neighbours un-skipping
                         tiles that straddle requests).
    ``in_spikes`` /      per-layer dicts: this request's input/output spike
    ``out_spikes``       *counts* (events over all T timesteps; spikes are
                         0/1, so the per-request split of the batch totals is
                         exact). ``spike_total``: sum of ``out_spikes``.
    ``energy_j``         paper Eq. 3 / §V-C dynamic energy estimate for this
                         request served alone, in joules — per-layer FPGA
                         power x per-layer latency from the request's
                         *measured* input-spike workloads, priced with the
                         plan's NC allocation. ``latency_s``: the matching
                         sum-of-layer-latencies estimate, in seconds.
    ``batch_energy_j`` / Eq. 3 energy (J) / latency (s) of the whole batch
    ``batch_latency_s``  this request was served in (workloads = batch total
                         spikes). ``batch_real``: how many non-pad requests
                         shared the batch. ``served_energy_j`` =
                         ``batch_energy_j / batch_real``: this request's
                         share of the energy of the batch it actually rode
                         in — the quantity a sparsity-aware scheduler
                         improves for sparse requests by not co-batching
                         them with dense stragglers.
    ``energy_analytical_j`` / the same two quantities under the *analytical*
    ``served_energy_analytical_j`` per-op cost model
                         (`core.energy.analytical_energy_per_image`):
                         bottom-up op counting instead of FPGA power x
                         latency. Reported side by side with the Eq. 3
                         figures so the two models' disagreement on any
                         request is measurable.

    ``ts_occupancy``     per-layer dict of length-T lists: the fraction of
                         this request's folded matmul rows that carried at
                         least one spike at each timestep — the per-timestep
                         sparsity trace streamed through
                         `EngineCore.poll_partial` while a request is being
                         served.

    LM result stats: ``prompt_len`` (tokens), ``padded_len`` (prompt length
    after bucket padding; the continuous-admission runner feeds prompts
    unpadded and *asserts* ``padded_len == prompt_len``), ``new_tokens``
    (decode budget), ``prefill_chunks`` (session steps that consumed at
    least one prompt token — ``ceil(prompt_len / chunk)`` under chunked
    prefill), ``ttft_steps`` (session steps from admission through the step
    that emitted the first generated token). Speculative-decode accounting
    (always present under continuous admission): ``drafted_tokens`` /
    ``accepted_tokens`` / ``rejected_tokens``, with accepted + rejected ==
    drafted exactly. Requests that opted into logprob tracking
    (``temperature > 0`` or ``logprobs: True``) also carry ``logprobs``:
    one ``log_softmax(raw logits)[token]`` per generated token.

    Both runners additionally stamp the active numerics on every result:
    ``precision`` ('fp32' or 'int4' — under adaptive serving, the variant
    this request was *actually* served at) and ``wbytes_per`` (bytes per
    weight at that precision: 4.0 fp32, 0.5 int4).

    status: lifecycle outcome —

    ``'ok'``        ran to completion.
    ``'cancelled'`` caller `EngineCore.cancel`.
    ``'expired'``   deadline passed before completion (queued or resident).
    ``'failed'``    the engine's numerics screen caught NaN/Inf in the
                    slot's step outputs and retired the request before the
                    poison could propagate (`EngineConfig.numerics_screen`),
                    or a supervised router exhausted the request's retry
                    budget re-routing it off faulted replicas
                    (`serve.router.Router`).
    ``'rejected'``  shed under sustained overload before ever running — the
                    router's explicit alternative to silently blowing the
                    deadline of everything behind it (`serve.router`).

    Non-'ok' results carry whatever partial outputs/stats the runner had
    produced ('rejected' requests never ran, so they carry none).
    """
    request_id: int
    outputs: Any
    stats: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    status: str = "ok"


@dataclasses.dataclass(frozen=True)
class StepBudget:
    """How much work one `RunnerSession.step` may perform, in workload-native
    units (LM: prompt+decode tokens; SNN: timesteps of the fused graph).

    Decoupling the work a step performs from the wall-clock step itself is
    the decoupled-processing-time idea (arXiv:2311.14447) applied to the
    serving seam: the scheduler spends budget where latency matters.

    units:    total units the whole step may consume (all slots summed), or
              None for no cap. Sessions never starve a slot below one unit —
              the cap trims *extra* prefill allowance, slot-index order.
    chunk:    default per-slot prefill allowance: how many prompt tokens a
              prefilling LM slot may consume this step (decode slots always
              consume exactly one). 1 reproduces token-by-token prefill.
    per_slot: optional per-slot overrides of ``chunk`` — the scheduler's
              budget *split* (e.g. boost the slot racing a deadline).
    """
    units: Optional[int] = None
    chunk: int = 1
    per_slot: Optional[Mapping[int, int]] = None

    def for_slot(self, slot: int) -> int:
        """Prefill allowance for one slot index (always >= 1)."""
        if self.per_slot is not None and slot in self.per_slot:
            return max(1, int(self.per_slot[slot]))
        return max(1, int(self.chunk))


@dataclasses.dataclass(frozen=True)
class SlotProgress:
    """One occupied slot's progress after a session step.

    phase:       workload-defined label ('prefill' | 'decode' for the LM,
                 'infer' for the SNN).
    units_done / consumed vs total work in the budget's units (LM: prompt +
    units_total: budgeted decode tokens; SNN: timesteps).
    emitted:     partial outputs produced *this step* — new tokens for the
                 LM, per-timestep sparsity stats for the SNN. The engine
                 accumulates these per request for `EngineCore.poll_partial`.
    """
    request_id: int
    phase: str
    units_done: int
    units_total: int
    emitted: tuple = ()


@dataclasses.dataclass(frozen=True)
class StepReport:
    """What one `RunnerSession.step` actually did.

    finished: results for the slots that completed this step (their slot
              indices are free again) — the old ``step()`` return value.
    progress: per-occupied-slot `SlotProgress` (finished slots included, so
              their last partials are not lost).
    cost:     measured cost of the step in workload-native units, e.g.
              ``{'units': 9, 'prompt_tokens': 8, 'decode_tokens': 1}`` (LM)
              or ``{'units': 8, 'timesteps': 4}`` (SNN). LM semantics:
              ``units`` is forward work (token positions processed),
              ``prompt_tokens`` the prompt tokens consumed out of it, and
              ``decode_tokens`` the tokens *emitted* — on the step that
              consumes a row's last prompt token the same forward pass
              also emits its first decode token, so ``prompt_tokens +
              decode_tokens`` may exceed ``units``. Under speculative
              decode the LM also reports ``drafted_tokens`` /
              ``accepted_tokens`` for the step, and ``decode_tokens``
              counts every emitted token (accepted draft prefix + the
              corrected/bonus token per speculating row) — so
              decode-tokens-per-step is the goodput headline speculation
              moves, while ``units`` still prices the forward work spent
              to get them. Schedulers fold these, with the
              engine-measured wall seconds, into their cost models
              (`SLOScheduler`).
    """
    finished: Mapping[int, Result] = dataclasses.field(default_factory=dict)
    progress: Mapping[int, SlotProgress] = dataclasses.field(default_factory=dict)
    cost: Mapping[str, float] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Scheduler configuration shared by all workloads.

    slots:     fixed batch width. Every runner invocation sees exactly this
               many requests (short batches are padded with runner fillers) —
               the static-shape contract that keeps TPU serving free of
               per-batch recompilation.
    max_queue: admission bound; `submit` past it raises ``QueueFull``.
    admission: 'continuous' (default) — step-level admission: each
               `EngineCore.step` first refills freed slots from the queue,
               then advances the live runner session one iteration (one
               decode token for the LM, one fused batch for the SNN), so new
               requests join between iterations instead of waiting for the
               current batch to drain. 'batch' — the PR-2 run-to-completion
               policy: one `step` forms one same-bucket batch and runs it to
               completion.
    scheduler: batch-composition policy name, resolved by
               `scheduler.make_scheduler`: 'fifo' (arrival order),
               'sparsity' (co-batch by observed/predicted tile-skip rate,
               EWMA-learned from per-request `Result` stats), or 'slo'
               (deadline/priority admission + per-step budget split;
               composes over an inner policy — 'slo:sparsity').
    prefill_chunk: default `StepBudget.chunk` for continuous admission —
               prompt tokens a joining LM request prefills per engine step,
               interleaved with resident decode rows in the same launch.
               1 reproduces token-by-token prefill; larger values stop long
               prompts from holding goodput down for their whole prefill.
               Bit-identical outputs for any value (chunking only regroups
               the same masked per-token launches).
    max_idle_steps: stall guard for `EngineCore.run_until_complete` — after
               this many *consecutive* steps in which no slot made progress
               (no work units consumed, nothing retired, nothing admitted)
               the drain raises `EngineStalled` with diagnostics instead of
               spinning forever on a wedged session. 0 disables the guard
               (the pre-fault-tolerance behavior); per-call override via
               ``run_until_complete(max_idle_steps=...)``.
    numerics_screen: screen every step's emitted partials and finished
               results for NaN/Inf; a poisoned slot is retired with
               ``status='failed'`` (partials preserved) instead of feeding
               the poison onward or corrupting batchmates' steps.
    precision: weight-numerics policy for precision-capable runners
               (`serve.precision.PrecisionRunner`): '' (default) leaves the
               runner's native numerics untouched; 'fp32'/'int4' pin every
               unpinned request to that variant; 'adaptive' lets the
               per-request `PrecisionController` choose from EWMA sparsity
               estimates, SLO slack and the accuracy budget. Requests with
               ``options['pin_precision']`` are never switched in any mode.
               Setting this on a runner without ``set_precision`` raises at
               engine construction.
    """
    slots: int = 8
    max_queue: int = 256
    admission: str = "continuous"
    scheduler: str = "fifo"
    prefill_chunk: int = 1
    max_idle_steps: int = 1000
    numerics_screen: bool = True
    precision: str = ""


class QueueFull(RuntimeError):
    """Raised by `EngineCore.submit` when the admission queue is at capacity."""


class EngineStalled(RuntimeError):
    """Raised by `EngineCore.run_until_complete` when no slot has made
    progress for `EngineConfig.max_idle_steps` consecutive steps — the
    wedged-session failure mode surfaced as a diagnosis instead of an
    infinite spin. The message carries the stalled residents and queue
    depth; a supervising router catches the same condition earlier via its
    per-step heartbeat (`serve.router.Router`)."""


@runtime_checkable
class ModelRunner(Protocol):
    """What a workload must provide to be served by `EngineCore`.

    The engine owns admission, bucketing, slot lifecycle and result routing;
    the runner owns tensors. ``run`` is handed a batch of exactly
    ``EngineConfig.slots`` requests whose ``bucket_key`` all match and must
    return one `Result` per request, in order (pad results included; the
    engine drops them).
    """

    def bucket_key(self, request: Request) -> Hashable:
        """Requests are only batched together when their keys are equal
        (e.g. padded prompt length + decode budget for the LM, image shape
        for the SNN): the padding/bucketing contract of the scheduler."""
        ...

    def filler(self, request: Request) -> Request:
        """A `PAD_REQUEST_ID` request compatible with ``request``'s bucket,
        used by the engine to pad short batches to the full slot count."""
        ...

    def run(self, batch: Sequence[Request]) -> Sequence[Result]:
        """Execute one fixed-slot batch."""
        ...

    # -- continuous admission (step-level serving) ---------------------------

    def session_key(self, request: Request) -> Hashable:
        """Compatibility key for *joining a live session*. Coarser than
        ``bucket_key``: the LM accepts any prompt/decode budget that fits
        ``max_seq`` into a running session (slots free and fill
        independently), so its key is constant; the SNN key is the image
        shape (one compiled fused graph per shape)."""
        ...

    def open_session(self, slots: int) -> "RunnerSession":
        """Start a live fixed-slot session for continuous admission."""
        ...


@runtime_checkable
class RunnerSession(Protocol):
    """A live fixed-width batch the engine admits into between steps.

    The engine drives the session as: ``admit`` requests into free slot
    indices, then ``step(budget)`` to advance every occupied slot by up to
    the budgeted amount of work (prompt/decode tokens for the LM; one fused
    T-timestep batch for the SNN). Slots the engine never admitted into are
    the runner's problem to pad (inactive rows for the LM, zero images for
    the SNN) — the engine only guarantees it will not reuse a slot index
    before the session reported (or ``cancel`` reclaimed) the previous
    occupant.
    """

    def admit(self, slot: int, request: Request) -> Optional[Result]:
        """Place ``request`` in slot index ``slot``. May complete degenerate
        requests immediately (e.g. ``max_new_tokens=0``) by returning their
        `Result`; returns None when the request will run in coming steps."""
        ...

    def step(self, budget: StepBudget) -> StepReport:
        """Advance every occupied slot by up to ``budget`` work; returns a
        `StepReport` with finished results, per-slot progress + partial
        outputs, and the step's measured cost."""
        ...

    def cancel(self, slot: int) -> Result:
        """Reclaim ``slot`` without perturbing its neighbours; returns a
        partial `Result` (outputs so far, ``status='cancelled'``) for the
        evicted occupant. The slot index is free for reuse afterwards."""
        ...
