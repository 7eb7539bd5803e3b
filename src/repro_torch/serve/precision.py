"""Adaptive-precision serving: per-request fp32/int4 selection that closes
the paper's quantization->sparsity loop at serving time.

The JAX package's serve/precision.py in PyTorch; the controller, the
registry and the runner are plain Python and equal the reference's
decision for decision. In short:

* `VariantRegistry` holds one `ModelRunner` per precision over the *same*
  raw params (the LM quantizes its weights once at construction; the SNN's
  int4 variant differs only in ``cfg.quant_bits``), with a ``prewarm`` hook
  that runs every launch width each variant can be asked for once — on the
  card that builds the kernels (nvcc, at first use) and takes the first
  cuBLAS calls, so a precision flip mid-trace never hides a build inside a
  deadline.
* `PrecisionController` decides each unpinned request's precision from the
  scheduler's EWMA sparsity estimates, SLO slack and an accuracy budget,
  pricing the choice with BOTH the paper's Eq. 3 FPGA model and the
  analytical energy-per-op model (`core.energy.analytical_energy_per_image`).
  Requests carrying ``options['pin_precision']`` are NEVER switched.
  Predicted-*dense* inputs go int4: they are the requests whose sparsity
  (and therefore energy) quantization improves the most.
* `PrecisionRunner` / `_PrecisionSession` serve both precisions behind one
  `EngineCore`: each precision gets its own full-width sub-session (its own
  KV cache / fused SNN batch), a slot index is owned by exactly one
  precision at a time, and every launch stays single-precision — which is
  why outputs within a precision are bit-identical to a pinned
  single-precision engine.
* `bind_controller` closes the loop online: the controller predicts with
  `SparsityAwareScheduler.predict` and listens to every observed result's
  realized skip rate *per precision*; the learned
  ``skip_ewma['int4'] - skip_ewma['fp32']`` delta is fed back into the
  int4 price.

`make_snn_variants` and `make_lm_variants` take a ``device`` ("cuda"
unless the caller asks for "cpu") where the JAX package takes
``interpret``; everything they make runs there. Wiring: ``EngineConfig.precision='fp32'|'int4'|'adaptive'``
(the engine calls `PrecisionRunner.set_precision`) and
``launch/serve.py --precision``.
"""
from __future__ import annotations

import dataclasses
from typing import (Any, Callable, Dict, Hashable, List, Mapping, Optional,
                    Sequence, Tuple)

from .api import (PAD_REQUEST_ID, ModelRunner, Request, Result, StepBudget,
                  StepReport)

PRECISIONS = ("fp32", "int4")

#: pricer signature: (precision, activity in [0, 1]) -> both cost models'
#: energy estimates, e.g. {"eq3_j": 1.2e-5, "analytical_j": 3.4e-7}
Pricer = Callable[[str, float], Dict[str, float]]


# ---------------------------------------------------------------------------
# Variant registry: one runner per precision, pre-warmed launch widths
# ---------------------------------------------------------------------------

class VariantRegistry:
    """Per-precision `ModelRunner` variants of one model.

    Variants are built once (quantized params / quantized-view configs are
    cached on the runners themselves) and must agree on ``session_key`` and
    ``filler`` semantics — they are the same model at different numerics, so
    an engine session can hold both behind one slot array.
    """

    def __init__(self, variants: Mapping[str, ModelRunner], *,
                 default: str = "fp32",
                 warm_fn: Optional[Callable[["VariantRegistry", int], None]] = None):
        assert default in variants, (default, tuple(variants))
        self.variants: Dict[str, ModelRunner] = dict(variants)
        self.default = default
        self._warm_fn = warm_fn
        self._warmed = False

    @property
    def precisions(self) -> Tuple[str, ...]:
        return tuple(self.variants)

    def runner(self, precision: str) -> ModelRunner:
        return self.variants[precision]

    def prewarm(self, slots: int) -> None:
        """Run every launch width each variant can be asked for, once.

        On the card the first launch builds the kernels and the first
        library calls set themselves up; after this call a controller
        precision flip at any session width the variants were warmed for
        finds them ready. Idempotent."""
        if self._warmed:
            return
        if self._warm_fn is not None:
            self._warm_fn(self, slots)
        self._warmed = True


def make_snn_variants(cfg, params, *, device="cuda") -> VariantRegistry:
    """fp32 + int4 spiking-VGG9 variants over one set of raw params.

    Both variants share ``params`` (on ``device``) and differ only in
    ``cfg.quant_bits``: the int4 variant's forward takes the fake-quant
    view of the weights (`models.vgg9.quantized_view`). Prewarm runs one
    full-width fused batch per precision, the only launch width each
    variant serves at that slot count."""
    import torch

    from .runners.snn import SNNRunner

    fp32_cfg = dataclasses.replace(cfg, quant_bits=0)
    int4_cfg = dataclasses.replace(cfg, quant_bits=4)
    variants = {"fp32": SNNRunner(fp32_cfg, params, device=device),
                "int4": SNNRunner(int4_cfg, params, device=device)}

    def warm(reg: VariantRegistry, slots: int) -> None:
        img = torch.zeros((cfg.img_hw, cfg.img_hw, cfg.in_ch),
                          device=variants["fp32"].device)
        for runner in reg.variants.values():
            sess = runner.open_session(slots)
            sess.admit(0, Request(PAD_REQUEST_ID, img))
            sess.step(StepBudget())

    return VariantRegistry(variants, warm_fn=warm)


def make_lm_variants(cfg, params, *, max_seq: int = 512,
                     prompt_bucket: int = 8, quant_bits: int = 4,
                     warm_chunk_cap: int = 64,
                     device="cuda") -> VariantRegistry:
    """fp32 + quantized LM variants over one set of raw params (on
    ``device``).

    The quantized variant fake-quants its weight matrices once at
    construction (`runners.lm.quantized_lm_params`) — serving never
    re-quantizes. Prewarm mirrors the CLI's SLO warm loop: each variant
    runs the width-1 launch plus every pow2-bucketed chunk width up to
    ``warm_chunk_cap`` (the widest chunk an `SLOScheduler` budget boost can
    request), so a mid-deadline precision flip finds its kernels hot."""
    from .runners.lm import LMRunner

    name = f"int{quant_bits}"
    variants = {"fp32": LMRunner(cfg, params, max_seq=max_seq,
                                 prompt_bucket=prompt_bucket, device=device),
                name: LMRunner(cfg, params, max_seq=max_seq,
                               quant_bits=quant_bits,
                               prompt_bucket=prompt_bucket, device=device)}

    def warm(reg: VariantRegistry, slots: int) -> None:
        for runner in reg.variants.values():
            w = 1
            while True:
                plen = min(w + 1, max_seq - 2)
                sess = runner.open_session(slots)
                sess.admit(0, Request(PAD_REQUEST_ID, [1] * plen,
                                      {"max_new_tokens": 1}))
                sess.step(StepBudget(chunk=w))
                if w >= warm_chunk_cap or w >= max_seq:
                    break
                w *= 2

    return VariantRegistry(variants, warm_fn=warm)


# ---------------------------------------------------------------------------
# Pricing: both cost models over a predicted-activity workload estimate
# ---------------------------------------------------------------------------

def _snn_reference_spikes(cfg) -> Dict[str, float]:
    """Upper-bound input spike counts per sparse layer: every input neuron
    firing at every timestep. Scaled by a predicted activity fraction
    (1 - predicted skip rate) these become the workload estimate the
    controller prices a not-yet-served request with."""
    from ..models.vgg9 import conv_names

    t = cfg.timesteps
    size = cfg.img_hw
    names = conv_names(cfg)
    ref: Dict[str, float] = {}
    conv_i = 0
    prev_c = cfg.in_ch
    for s in cfg.stages:
        if s == "MP":
            size //= 2
            continue
        if conv_i > 0:     # conv0 is the dense-coded input layer: no spikes in
            ref[names[conv_i]] = float(t * size * size * prev_c)
        prev_c = s
        conv_i += 1
    n_mp = sum(1 for s in cfg.stages if s == "MP")
    flat = (cfg.img_hw // (2 ** n_mp)) ** 2 * cfg.conv_channels[-1]
    ref["fc0"] = float(t * flat)
    ref["fc1"] = float(t * cfg.fc_dim)
    return ref


def make_snn_pricer(cfg) -> Pricer:
    """Price (precision, activity) with both cost models for a VGG9 config.

    Builds the same Eq. 3 workload/weight geometry `runners.snn.SNNRunner`
    prices measured requests with, but from *estimated* spikes (reference
    counts x predicted activity), so the controller can compare fp32 vs
    int4 before a request has ever run. Returns
    ``{"eq3_j": ..., "analytical_j": ...}`` per call."""
    from ..core.energy import analytical_energy_per_image, energy_per_image
    from ..core.hybrid import plan_vgg9_inference
    from ..core.workload import (conv_workload, dense_input_workload,
                                 fc_workload)
    from ..models.vgg9 import conv_names

    ref = _snn_reference_spikes(cfg)
    cores = plan_vgg9_inference(cfg, 1).cores()
    convs = cfg.conv_channels
    t, hw = cfg.timesteps, cfg.img_hw
    n_mp = sum(1 for s in cfg.stages if s == "MP")
    flat = (hw // (2 ** n_mp)) ** 2 * convs[-1]
    names = conv_names(cfg)

    def price(precision: str, activity: float) -> Dict[str, float]:
        activity = min(1.0, max(0.0, float(activity)))
        wb = 0.5 if precision == "int4" else 4.0
        workloads = [dense_input_workload("conv0", hw, hw, convs[0], t)]
        weight_bytes = [9 * cfg.in_ch * convs[0] * wb]
        cin = convs[0]
        for i, name in enumerate(names[1:], start=1):
            workloads.append(conv_workload(name, convs[i], 9,
                                           ref[name] * activity))
            weight_bytes.append(9 * cin * convs[i] * wb)
            cin = convs[i]
        for name, d_in, d_out in (("fc0", flat, cfg.fc_dim),
                                  ("fc1", cfg.fc_dim, cfg.population)):
            workloads.append(fc_workload(name, d_out, ref[name] * activity))
            weight_bytes.append(d_in * d_out * wb)
        eq3 = energy_per_image(workloads, cores, weight_bytes, precision)
        ana = analytical_energy_per_image(workloads, precision)
        return {"eq3_j": eq3["energy_j"], "analytical_j": ana["energy_j"]}

    return price


# ---------------------------------------------------------------------------
# The controller
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PrecisionDecision:
    """One logged precision choice (``PrecisionController.decisions``)."""
    request_id: int
    precision: str
    reason: str                 # 'pinned' | 'slo_tight' | 'harvest' |
                                # 'budget_exhausted' | 'priced_out' | 'default'
    predicted_skip: float
    prices: Dict[str, Dict[str, float]]   # precision -> {eq3_j, analytical_j}
    models_agree: bool          # did Eq. 3 and analytical rank the choice alike


class PrecisionController:
    """Per-request precision policy: sparsity estimate + SLO slack +
    accuracy budget, priced under two energy models.

    Decision order for `decide` (first hit wins):

    1. ``options['pin_precision']`` — always honored, never switched.
    2. A tight SLO (``deadline_s <= slo_tight_s``) — int4: cheaper under
       both cost models, so the latency-critical request also burns the
       least energy while racing its deadline.
    3. Predicted-dense input (predicted skip < ``dense_threshold``) — int4
       to harvest the extra tile-skips quantization buys, *if* the accuracy
       budget allows (at most ``accuracy_budget`` of unpinned requests may
       be downshifted) and the priced int4 energy actually wins under
       ``price_with``.
    4. Otherwise ``default`` (fp32: already-sparse requests are cheap, so
       the accuracy budget is spent where quantization buys the most).

    Predictions come from ``options['skip_hint']``, then the bound
    predictor (`bind_controller` wires `SparsityAwareScheduler.predict`),
    then ``prior``. The int4 branch's predicted skip additionally includes
    the *learned* interplay delta (`interplay_delta`): realized skip-rate
    EWMAs per precision, fed by the scheduler's observation stream — the
    paper's quantization->sparsity coupling, learned online.

    Decisions are cached by request id and never re-made: a replayed
    request (router re-route) re-resolves to the same precision, which
    keeps replay bit-identical.
    """

    def __init__(self, *, default: str = "fp32",
                 dense_threshold: float = 0.5,
                 slo_tight_s: Optional[float] = None,
                 accuracy_budget: float = 1.0,
                 prior: float = 0.5, alpha: float = 0.3,
                 pricer: Optional[Pricer] = None,
                 price_with: str = "eq3",
                 predictor: Optional[Callable[[Request], float]] = None):
        assert default in PRECISIONS, default
        assert price_with in ("eq3", "analytical"), price_with
        assert 0.0 <= accuracy_budget <= 1.0, accuracy_budget
        self.default = default
        self.dense_threshold = dense_threshold
        self.slo_tight_s = slo_tight_s
        self.accuracy_budget = accuracy_budget
        self.prior = prior
        self.alpha = alpha
        self.pricer = pricer
        self.price_with = price_with
        self.predictor = predictor
        #: realized mean skip-rate EWMA per served precision (the observed
        #: side of the sparsity-quantization interplay)
        self.skip_ewma: Dict[str, float] = {}
        self.decisions: List[PrecisionDecision] = []
        self._decided: Dict[int, PrecisionDecision] = {}
        self._unpinned = 0
        self._downshifted = 0

    # -- prediction & learning ----------------------------------------------

    def predict_skip(self, request: Request) -> float:
        hint = request.options.get("skip_hint") if request.options else None
        if hint is not None:
            return float(hint)
        if self.predictor is not None:
            return float(self.predictor(request))
        return self.prior

    def observe_skip(self, request: Request, result: Result,
                     skip: float) -> None:
        """Realized skip-rate feedback, keyed by the precision the result
        was actually served at (`Result.stats['precision']`). Wired to the
        scheduler's observation stream by `bind_controller`."""
        precision = result.stats.get("precision")
        if precision is None or skip is None:
            return
        old = self.skip_ewma.get(precision)
        self.skip_ewma[precision] = (
            skip if old is None else self.alpha * skip + (1 - self.alpha) * old)

    def interplay_delta(self) -> Optional[float]:
        """Learned extra skip rate int4 delivers over fp32 (the paper's
        headline coupling), or None until both precisions have been
        observed."""
        if "int4" in self.skip_ewma and "fp32" in self.skip_ewma:
            return self.skip_ewma["int4"] - self.skip_ewma["fp32"]
        return None

    # -- pricing -------------------------------------------------------------

    def _price(self, predicted_skip: float) -> Dict[str, Dict[str, float]]:
        if self.pricer is None:
            return {}
        delta = self.interplay_delta() or 0.0
        skip_int4 = min(1.0, predicted_skip + max(0.0, delta))
        return {"fp32": self.pricer("fp32", 1.0 - predicted_skip),
                "int4": self.pricer("int4", 1.0 - skip_int4)}

    @staticmethod
    def _models_agree(prices: Dict[str, Dict[str, float]]) -> bool:
        if not prices:
            return True
        return ((prices["int4"]["eq3_j"] < prices["fp32"]["eq3_j"])
                == (prices["int4"]["analytical_j"]
                    < prices["fp32"]["analytical_j"]))

    # -- decision ------------------------------------------------------------

    def decide(self, request: Request) -> str:
        """Precision for ``request``; cached by request id (idempotent).

        A ``pin_precision`` always wins — even over a stale cached decision
        for the same id (an id reuse or replay must never unpin a request),
        in which case the stale entry is re-decided as pinned."""
        rid = request.request_id
        pin = (request.options or {}).get("pin_precision")
        cached = self._decided.get(rid)
        if cached is not None and (pin is None or cached.precision == pin):
            return cached.precision
        d = self._decide(request)
        if rid >= 0:             # pad fillers are not logged or budgeted
            self._decided[rid] = d
            self.decisions.append(d)
        return d.precision

    def _decide(self, request: Request) -> PrecisionDecision:
        rid = request.request_id
        options = request.options or {}
        pin = options.get("pin_precision")
        pred = self.predict_skip(request)
        if pin is not None:
            assert pin in PRECISIONS, pin
            return PrecisionDecision(rid, pin, "pinned", pred, {}, True)

        prices = self._price(pred)
        agree = self._models_agree(prices)
        if (self.slo_tight_s is not None and request.deadline_s is not None
                and request.deadline_s <= self.slo_tight_s):
            self._count(rid, downshift=True)
            return PrecisionDecision(rid, "int4", "slo_tight", pred, prices,
                                     agree)
        if pred < self.dense_threshold:
            # predicted-dense: the class quantization helps the most
            if not self._budget_allows():
                self._count(rid, downshift=False)
                return PrecisionDecision(rid, self.default,
                                         "budget_exhausted", pred, prices,
                                         agree)
            if prices and (prices["int4"][f"{self.price_with}_j"]
                           >= prices["fp32"][f"{self.price_with}_j"]):
                self._count(rid, downshift=False)
                return PrecisionDecision(rid, self.default, "priced_out",
                                         pred, prices, agree)
            self._count(rid, downshift=True)
            return PrecisionDecision(rid, "int4", "harvest", pred, prices,
                                     agree)
        self._count(rid, downshift=False)
        return PrecisionDecision(rid, self.default, "default", pred, prices,
                                 agree)

    def _budget_allows(self) -> bool:
        return (self._downshifted + 1) <= self.accuracy_budget * (
            self._unpinned + 1)

    def _count(self, rid: int, *, downshift: bool) -> None:
        if rid < 0:
            return
        self._unpinned += 1
        if downshift:
            self._downshifted += 1

    # -- reporting -----------------------------------------------------------

    def summary(self) -> Dict[str, Any]:
        by_reason: Dict[str, int] = {}
        by_precision: Dict[str, int] = {}
        disagreements = 0
        for d in self.decisions:
            by_reason[d.reason] = by_reason.get(d.reason, 0) + 1
            by_precision[d.precision] = by_precision.get(d.precision, 0) + 1
            disagreements += not d.models_agree
        return {
            "decisions": len(self.decisions),
            "by_reason": by_reason,
            "by_precision": by_precision,
            "skip_ewma": dict(self.skip_ewma),
            "interplay_delta": self.interplay_delta(),
            "model_disagreements": disagreements,
            "unpinned": self._unpinned,
            "downshifted": self._downshifted,
        }

    def metrics_into(self, registry) -> None:
        """Publish controller state into an `obs` registry — the pull
        hook `Observability.attach_engine` finds through the engine's
        `PrecisionRunner.controller` and runs at snapshot time."""
        summary = self.summary()
        registry.gauge("precision_decisions",
                       "precision choices made so far").set(
                           summary["decisions"])
        registry.gauge("precision_downshifted",
                       "unpinned requests downshifted to int4").set(
                           self._downshifted)
        registry.gauge("precision_model_disagreements",
                       "decisions where Eq. 3 and the analytical model "
                       "ranked precisions differently").set(
                           summary["model_disagreements"])
        for precision, count in sorted(summary["by_precision"].items()):
            registry.gauge(f"precision_served_{precision}",
                           f"requests decided to {precision}").set(count)
        for reason, count in sorted(summary["by_reason"].items()):
            registry.gauge(f"precision_reason_{reason}",
                           f"decisions made for reason={reason!r}").set(count)
        for precision, ewma in sorted(self.skip_ewma.items()):
            registry.gauge(f"precision_skip_ewma_{precision}",
                           f"realized skip-rate EWMA at {precision}").set(
                               ewma)
        delta = self.interplay_delta()
        if delta is not None:
            registry.gauge("precision_interplay_delta",
                           "learned extra skip rate int4 delivers over "
                           "fp32 (paper SIII coupling)").set(delta)


def bind_controller(scheduler, controller: PrecisionController
                    ) -> PrecisionController:
    """Close the co-design loop between a `SparsityAwareScheduler` and a
    controller: predictions flow scheduler -> controller (`predict`'s
    per-source EWMAs), realized per-precision skip rates flow back
    controller <- scheduler (its ``listeners`` observation stream)."""
    controller.predictor = scheduler.predict
    scheduler.listeners.append(controller.observe_skip)
    return controller


# ---------------------------------------------------------------------------
# The runner: both precisions behind one EngineCore
# ---------------------------------------------------------------------------

class PrecisionRunner:
    """`ModelRunner` serving every registry precision behind one engine.

    mode: ``'adaptive'`` — the controller decides per request; or a pinned
    precision name — every *unpinned* request is served at that precision
    (``options['pin_precision']`` is still honored, so the never-switch
    invariant holds in every mode).

    Bucketing (batch admission) includes the decided precision, so the
    engine only ever forms single-precision batches; the session key does
    NOT, so both precisions co-reside in one continuous-admission session
    (`_PrecisionSession`)."""

    def __init__(self, registry: VariantRegistry,
                 controller: Optional[PrecisionController] = None,
                 mode: str = "adaptive"):
        self.registry = registry
        self.controller = (controller if controller is not None
                           else PrecisionController())
        self.set_precision(mode)

    # -- precision surface (EngineConfig.precision wiring) -------------------

    def set_precision(self, mode: str) -> None:
        assert mode == "adaptive" or mode in self.registry.precisions, mode
        self.mode = mode

    @property
    def precision(self) -> str:
        """Engine-facing label: the pinned precision, or 'adaptive'."""
        return self.mode

    @property
    def reference(self) -> ModelRunner:
        return self.registry.runner(self.registry.default)

    def decide_precision(self, request: Request) -> str:
        if request.is_pad:
            return self.registry.default
        pin = request.options.get("pin_precision") if request.options else None
        if self.mode != "adaptive":
            if pin is not None:
                assert pin in self.registry.precisions, pin
                return pin
            return self.mode
        return self.controller.decide(request)

    # -- ModelRunner protocol ------------------------------------------------

    def bucket_key(self, request: Request) -> Hashable:
        return (self.decide_precision(request),
                self.reference.bucket_key(request))

    def filler(self, request: Request) -> Request:
        return self.reference.filler(request)

    def run(self, batch: Sequence[Request]) -> Sequence[Result]:
        real = [r for r in batch if not r.is_pad]
        if not real:
            return self.reference.run(batch)
        decided = {self.decide_precision(r) for r in real}
        assert len(decided) == 1, (
            f"mixed-precision batch reached run(): {decided} — bucket_key "
            "must keep batches single-precision")
        return self.registry.runner(decided.pop()).run(batch)

    def session_key(self, request: Request) -> Hashable:
        # precision deliberately excluded: both variants co-reside in one
        # live session, each owning its own slots (see _PrecisionSession)
        return self.reference.session_key(request)

    def open_session(self, slots: int) -> "_PrecisionSession":
        return _PrecisionSession(self, slots)


class _PrecisionSession:
    """One engine session spanning every precision variant.

    Holds one full-width sub-session per precision (its own KV cache /
    fused-batch state); a slot index is owned by exactly one precision at a
    time (``owner``), so a precision flip between a slot's occupants can
    never leak the slot or double-release it — `admit`/`cancel`/`step`
    all assert the ownership transfer. Each sub-session only ever sees
    requests of its own precision, so every launch is single-precision and
    outputs are bit-identical to a pinned single-precision engine.
    """

    def __init__(self, runner: PrecisionRunner, slots: int):
        self.runner = runner
        self.slots = slots
        self.sub = {p: runner.registry.runner(p).open_session(slots)
                    for p in runner.registry.precisions}
        self.owner: List[Optional[str]] = [None] * slots

    def admit(self, slot: int, request: Request) -> Optional[Result]:
        assert self.owner[slot] is None, (
            f"slot {slot} already owned by {self.owner[slot]}")
        precision = self.runner.decide_precision(request)
        res = self.sub[precision].admit(slot, request)
        if res is not None:        # degenerate request: done on arrival,
            return res             # the sub-session never occupied the slot
        self.owner[slot] = precision
        return None

    def cancel(self, slot: int) -> Result:
        precision = self.owner[slot]
        assert precision is not None, f"slot {slot} empty"
        self.owner[slot] = None
        return self.sub[precision].cancel(slot)

    def step(self, budget: StepBudget) -> StepReport:
        """Advance each precision's sub-session that holds occupants, and
        merge the reports (slot sets are disjoint by ownership; costs sum —
        co-resident precisions really do launch once each per engine
        step)."""
        finished: Dict[int, Result] = {}
        progress: Dict[int, Any] = {}
        cost: Dict[str, float] = {}
        for precision, sess in self.sub.items():
            if not any(o == precision for o in self.owner):
                continue
            report = sess.step(budget)
            for idx, res in report.finished.items():
                assert self.owner[idx] == precision, (
                    f"slot {idx} finished in {precision} but owned by "
                    f"{self.owner[idx]}")
                self.owner[idx] = None
                assert idx not in finished, f"slot {idx} finished twice"
                finished[idx] = res
            for idx, prog in report.progress.items():
                assert idx not in progress, f"slot {idx} progressed twice"
                progress[idx] = prog
            for k, v in report.cost.items():
                cost[k] = cost.get(k, 0) + v
        return StepReport(finished=finished, progress=progress, cost=cost)
