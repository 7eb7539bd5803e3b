"""The port's adaptive-precision serving (`repro_torch.serve.precision`)
against the JAX package's.

Three invariants, as the reference states them: requests carrying
``options['pin_precision']`` are never served at another precision; outputs
within a precision are bit-identical to a pinned single-precision engine;
a precision flip mid-trace never leaks or double-releases a slot. The
engine mechanics run on stub variants in both packages, driven by the same
random draws: served precisions and the controllers' decision logs must be
equal. The real variants serve the same mixed trace through both packages
(TINY spiking VGG9, 2 slots, ``adaptive``, sparsity scheduler, weights
carried across with `params_from_numpy`): served precisions, decisions and
Eq. 3 / analytical served energy equal, logits within 1e-5, spike counts
and skip rates exact. The pricer equals JAX's within 1e-12 relative and
`_snn_reference_spikes` exactly. The LM variants (reduced qwen: d_model 64,
2 layers, vocab 512) serve streams equal to pinned `LMRunner` engines' and
to JAX's greedy streams.
"""
import random
import types

import jax
import numpy as np
import pytest

from repro.configs import base as jax_base
from repro.configs import vgg9_snn as jax_cfgs
from repro.models import transformer as jax_tf
from repro.models.vgg9 import init_vgg9 as jax_init_vgg9
from repro.serve import api as jax_api
from repro.serve import core as jax_core
from repro.serve import precision as jax_precision
from repro.serve import scheduler as jax_scheduler
from repro.serve.runners.lm import LMRunner as JaxLMRunner
from repro_torch.configs import vgg9_snn as torch_cfgs
from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as tf
from repro_torch.models.vgg9 import params_from_numpy
from repro_torch.serve import api, core, precision, scheduler
from repro_torch.serve.api import EngineConfig, Request, Result
from repro_torch.serve.core import EngineCore
from repro_torch.serve.precision import (PRECISIONS, PrecisionController,
                                         PrecisionRunner, VariantRegistry,
                                         bind_controller, make_lm_variants,
                                         make_snn_pricer, make_snn_variants)
from repro_torch.serve.runners.lm import LMRunner
from repro_torch.serve.runners.snn import SNNRunner
from repro_torch.serve.scheduler import SparsityAwareScheduler

PKGS = {"jax": types.SimpleNamespace(api=jax_api, core=jax_core, precision=jax_precision,
                                     scheduler=jax_scheduler),
        "torch": types.SimpleNamespace(api=api, core=core, precision=precision,
                                       scheduler=scheduler)}


# ---------------------------------------------------------------------------
# Stub variants: one fake runner per precision, results stamp the precision
# ---------------------------------------------------------------------------

def _stub_variant_class(a):
    """The reference test's stub runner over one package's `serve.api`.
    payload: {'key': session key, 'steps': iterations, 'skip': rate}."""

    def result(precision, request):
        return a.Result(request.request_id, outputs=[precision],
                        stats={"precision": precision,
                               "skip_rate": {"l": request.payload.get("skip", 0.5)}})

    class StubVariantSession:
        def __init__(self, runner, slots):
            self.runner = runner
            self.req = [None] * slots
            self.left = [0] * slots

        def admit(self, slot, request):
            assert self.req[slot] is None
            steps = request.payload.get("steps", 1)
            if steps == 0:                         # degenerate: done on arrival
                return result(self.runner.precision, request)
            self.req[slot] = request
            self.left[slot] = steps
            return None

        def cancel(self, slot):
            req = self.req[slot]
            self.req[slot] = None
            return a.Result(req.request_id, None, stats={}, status="cancelled")

        def step(self, budget=a.StepBudget()):
            finished, progress = {}, {}
            for i, r in enumerate(self.req):
                if r is None:
                    continue
                self.left[i] -= 1
                total = r.payload.get("steps", 1)
                progress[i] = a.SlotProgress(r.request_id, "decode", total - self.left[i],
                                             total, emitted=(total - self.left[i],))
                if self.left[i] <= 0:
                    finished[i] = result(self.runner.precision, r)
                    self.req[i] = None
            return a.StepReport(finished=finished, progress=progress,
                                cost={"units": len(progress)})

    class StubVariant:
        def __init__(self, precision):
            self.precision = precision

        def bucket_key(self, request):
            return request.payload.get("key")

        def session_key(self, request):
            return request.payload.get("key")

        def filler(self, request):
            return a.Request(a.PAD_REQUEST_ID, dict(request.payload))

        def run(self, batch):
            return [result(self.precision, r) for r in batch]

        def open_session(self, slots):
            return StubVariantSession(self, slots)

    return StubVariant


STUBS = {name: _stub_variant_class(pkg.api) for name, pkg in PKGS.items()}
StubVariant = STUBS["torch"]


def _stub_registry(pkg="torch"):
    stub = STUBS[pkg]
    return PKGS[pkg].precision.VariantRegistry({"fp32": stub("fp32"), "int4": stub("int4")})


def _random_controller(rng, pkg="torch"):
    """The reference test's random controller, drawn in its order."""
    c = PKGS[pkg].precision.PrecisionController(
        default=rng.choice(PRECISIONS),
        dense_threshold=rng.choice([0.0, 0.3, 0.5, 0.8, 1.0]),
        slo_tight_s=rng.choice([None, 2000.0]),
        accuracy_budget=rng.choice([0.0, 0.5, 1.0]),
        prior=rng.random())
    # arbitrary learned state: the pin invariant may not depend on it
    if rng.random() < 0.7:
        c.skip_ewma.update({"fp32": rng.random(), "int4": rng.random()})
    return c


def _decision_log(controller):
    return [(d.request_id, d.precision, d.reason, d.predicted_skip, d.prices, d.models_agree)
            for d in controller.decisions]


# ---------------------------------------------------------------------------
# (a) pinned requests are never switched — any mode, any controller state
# ---------------------------------------------------------------------------

def _pinned_scenario(pkg, seed):
    rng = random.Random(seed)
    p = PKGS[pkg]
    runner = p.precision.PrecisionRunner(_stub_registry(pkg), _random_controller(rng, pkg),
                                         mode=rng.choice(["adaptive", "fp32", "int4"]))
    engine = p.core.EngineCore(runner, p.api.EngineConfig(slots=2))
    pinned, unpinned = [], []
    for _ in range(12):
        skip = rng.random()                 # stub reads skip from the payload
        opts = {}
        if rng.random() < 0.5:
            opts["skip_hint"] = rng.random()
        if rng.random() < 0.5:
            opts["pin_precision"] = "fp32"
        rid = engine.submit({"key": "a", "steps": rng.randrange(1, 4), "skip": skip},
                            deadline_s=rng.choice([None, 1000.0]), **opts)
        (pinned if "pin_precision" in opts else unpinned).append(rid)
    results = engine.run_until_complete()
    served = {rid: res.stats["precision"] for rid, res in results.items()}
    return runner, served, pinned, unpinned


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5])
def test_pinned_fp32_never_served_int4(seed):
    runner, served, pinned, unpinned = _pinned_scenario("torch", seed)
    for rid in pinned:
        assert served[rid] == "fp32", (seed, rid)
    if runner.mode in PRECISIONS:         # pinned modes switch everyone else
        for rid in unpinned:
            assert served[rid] == runner.mode
    ref_runner, ref_served, _, _ = _pinned_scenario("jax", seed)
    assert served == ref_served
    assert _decision_log(runner.controller) == _decision_log(ref_runner.controller)


def test_pin_honored_even_in_pinned_int4_mode():
    runner = PrecisionRunner(_stub_registry(), mode="int4")
    engine = EngineCore(runner, EngineConfig(slots=2, precision="int4"))
    a = engine.submit({"key": "a"}, pin_precision="fp32")
    b = engine.submit({"key": "a"})
    results = engine.run_until_complete()
    assert results[a].stats["precision"] == "fp32"
    assert results[b].stats["precision"] == "int4"


def test_accuracy_budget_zero_never_downshifts():
    c = PrecisionController(dense_threshold=1.0, accuracy_budget=0.0)
    runner = PrecisionRunner(_stub_registry(), c)
    engine = EngineCore(runner, EngineConfig(slots=2))
    rids = [engine.submit({"key": "a", "skip": 0.0}) for _ in range(6)]
    results = engine.run_until_complete()
    assert all(results[r].stats["precision"] == "fp32" for r in rids)
    assert all(d.reason == "budget_exhausted" for d in c.decisions)


def test_decisions_cached_per_request():
    c = PrecisionController(dense_threshold=1.0)
    runner = PrecisionRunner(_stub_registry(), c)
    req = Request(7, {"key": "a"})
    first = c.decide(req)
    # learned state moving after the decision must not re-decide it
    c.skip_ewma.update({"fp32": 1.0, "int4": 1.0})
    assert runner.decide_precision(req) == first
    assert len(c.decisions) == 1


# ---------------------------------------------------------------------------
# (c) precision flips never leak or double-release slots
# ---------------------------------------------------------------------------

def _assert_precision_slot_invariants(engine):
    sess = engine._session
    if sess is None:
        return
    occupied = {s.index for s in engine.slots if s.request_id is not None}
    owned = {i for i, p in enumerate(sess.owner) if p is not None}
    assert owned == occupied, "sub-session ownership out of sync with slots"
    for prec, sub in sess.sub.items():
        for i, r in enumerate(sub.req):
            if r is not None:
                assert sess.owner[i] == prec, \
                    f"slot {i} occupied in {prec} but owned by {sess.owner[i]}"


def test_slot_handoff_across_precisions():
    """One slot serving fp32 -> int4 -> fp32 back-to-back: each handoff
    releases exactly once and the next precision admits cleanly."""
    runner = PrecisionRunner(_stub_registry())
    engine = EngineCore(runner, EngineConfig(slots=1))
    rids = [engine.submit({"key": "a", "steps": 2}, pin_precision=p)
            for p in ("fp32", "int4", "fp32")]
    while engine.in_flight() or engine.stats()["pending"]:
        engine.step()
        _assert_precision_slot_invariants(engine)
    results = {r: engine.poll(r) for r in rids}
    assert [results[r].stats["precision"] for r in rids] == ["fp32", "int4", "fp32"]
    assert engine._session.owner == [None]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_random_precision_interleavings_never_leak_slots(seed):
    """Random submit/cancel/step interleavings over a controller whose
    decisions flip precision mid-trace keep slot ownership exact, every
    request gets exactly one terminal result, and the JAX package's engine
    driven by the same operations gives the same results and decisions."""
    rng = random.Random(seed)
    ctl = {"torch": _random_controller(rng), "jax": _random_controller(random.Random(seed), "jax")}
    engines = {name: p.core.EngineCore(p.precision.PrecisionRunner(_stub_registry(name),
                                                                   ctl[name]),
                                       p.api.EngineConfig(slots=3, max_queue=16,
                                                          max_idle_steps=0))
               for name, p in PKGS.items()}
    engine, ref = engines["torch"], engines["jax"]
    submitted, polled, live = set(), {}, []
    for _ in range(60):
        op = rng.random()
        if op < 0.45 and len(live) < 12:
            skip = rng.random()             # stub reads skip from the payload
            opts = {}
            if rng.random() < 0.3:
                opts["pin_precision"] = rng.choice(PRECISIONS)
            payload = {"key": "a", "steps": rng.randrange(1, 5), "skip": skip}
            rid = engine.submit(dict(payload), **opts)
            assert ref.submit(dict(payload), **opts) == rid
            submitted.add(rid)
            live.append(rid)
        elif op < 0.6 and live:
            victim = rng.choice(live)
            engine.cancel(victim)
            ref.cancel(victim)
        else:
            engine.step()
            ref.step()
        for rid in list(live):
            res, res_ref = engine.poll(rid), ref.poll(rid)
            assert (res is None) == (res_ref is None)
            if res is not None:
                assert rid not in polled, "double terminal result"
                assert (res.status, res.stats) == (res_ref.status, res_ref.stats)
                polled[rid] = res
                live.remove(rid)
        _assert_precision_slot_invariants(engine)
    results, results_ref = engine.run_until_complete(), ref.run_until_complete()
    assert sorted(results) == sorted(results_ref)
    for rid, res in results.items():
        assert rid not in polled
        assert (res.status, res.stats) == (results_ref[rid].status, results_ref[rid].stats)
        polled[rid] = res
    _assert_precision_slot_invariants(engine)
    assert set(polled) == submitted                 # exactly-once, no losses
    for rid, res in polled.items():
        if res.status == "ok":
            assert res.stats["precision"] in PRECISIONS
    assert _decision_log(ctl["torch"]) == _decision_log(ctl["jax"])
    assert engine.admission_log == ref.admission_log


# ---------------------------------------------------------------------------
# controller <-> scheduler feedback loop
# ---------------------------------------------------------------------------

def test_bind_controller_learns_per_precision_skip():
    sched = SparsityAwareScheduler(alpha=1.0)
    c = PrecisionController(alpha=1.0)
    bind_controller(sched, c)
    req = Request(1, {}, {"source": "s"})
    sched.observe(req, Result(1, None, stats={"precision": "fp32", "skip_rate": {"l": 0.2}}))
    sched.observe(req, Result(2, None, stats={"precision": "int4", "skip_rate": {"l": 0.6}}))
    assert c.skip_ewma == {"fp32": 0.2, "int4": 0.6}
    assert c.interplay_delta() == pytest.approx(0.4)
    # predictions route through the scheduler's per-source EWMAs
    assert c.predict_skip(req) == sched.predict(req)
    # a result without skip stats (LM) leaves the learned state untouched
    sched.observe(req, Result(3, None, stats={"precision": "fp32"}))
    assert c.skip_ewma["fp32"] == 0.2


def test_learned_interplay_raises_int4_predicted_skip():
    pricer_calls = []

    def pricer(precision, activity):
        pricer_calls.append((precision, activity))
        return {"eq3_j": activity, "analytical_j": activity}

    c = PrecisionController(pricer=pricer, dense_threshold=1.0)
    c.skip_ewma.update({"fp32": 0.2, "int4": 0.5})      # learned +0.3 delta
    c.decide(Request(1, {}, {"skip_hint": 0.4}))
    # fp32 priced at the predicted activity, int4 at the delta-boosted skip
    assert ("fp32", pytest.approx(0.6)) in pricer_calls
    assert ("int4", pytest.approx(0.3)) in pricer_calls


def test_snn_pricer_reports_both_models_and_int4_wins():
    price = make_snn_pricer(torch_cfgs.TINY)
    for activity in (0.1, 0.5, 1.0):
        fp32 = price("fp32", activity)
        int4 = price("int4", activity)
        assert set(fp32) == {"eq3_j", "analytical_j"}
        assert int4["eq3_j"] < fp32["eq3_j"]
        assert int4["analytical_j"] < fp32["analytical_j"]
    # both models are monotone in predicted activity
    assert price("int4", 0.2)["eq3_j"] < price("int4", 0.8)["eq3_j"]
    assert price("int4", 0.2)["analytical_j"] < price("int4", 0.8)["analytical_j"]


@pytest.mark.parametrize("name", ["TINY", "CIFAR10"])
def test_snn_pricer_and_reference_spikes_match_reference(name):
    cfg, jcfg = getattr(torch_cfgs, name), getattr(jax_cfgs, name)
    assert precision._snn_reference_spikes(cfg) == jax_precision._snn_reference_spikes(jcfg)
    price, ref = make_snn_pricer(cfg), jax_precision.make_snn_pricer(jcfg)
    for prec in PRECISIONS:
        for activity in (0.0, 0.1, 0.5, 1.0):
            got, want = price(prec, activity), ref(prec, activity)
            assert set(got) == set(want) == {"eq3_j", "analytical_j"}
            for k in want:
                assert got[k] == pytest.approx(want[k], rel=1e-12, abs=0), (prec, activity, k)


# ---------------------------------------------------------------------------
# EngineConfig.precision wiring
# ---------------------------------------------------------------------------

def test_engine_config_precision_requires_capable_runner():
    with pytest.raises(ValueError, match="set_precision"):
        EngineCore(StubVariant("fp32"), EngineConfig(precision="adaptive"))


def test_engine_config_precision_sets_runner_mode():
    runner = PrecisionRunner(_stub_registry(), mode="adaptive")
    engine = EngineCore(runner, EngineConfig(slots=2, precision="int4"))
    assert runner.mode == "int4"
    assert engine.stats()["precision"] == "int4"
    rid = engine.submit({"key": "a"})
    assert engine.run_until_complete()[rid].stats["precision"] == "int4"


def test_mixed_precision_batches_never_reach_run():
    """bucket_key carries the decided precision, so batch admission can only
    form single-precision batches; run() enforces it."""
    runner = PrecisionRunner(_stub_registry())
    a = Request(1, {"key": "a"}, {"pin_precision": "fp32"})
    b = Request(2, {"key": "a"}, {"pin_precision": "int4"})
    assert runner.bucket_key(a) != runner.bucket_key(b)
    with pytest.raises(AssertionError, match="mixed-precision"):
        runner.run([a, b])
    engine = EngineCore(runner, EngineConfig(slots=2, admission="batch"))
    ra = engine.submit({"key": "a"}, pin_precision="fp32")
    rb = engine.submit({"key": "a"}, pin_precision="int4")
    results = engine.run_until_complete()
    assert results[ra].stats["precision"] == "fp32"
    assert results[rb].stats["precision"] == "int4"


def test_prewarm_runs_once():
    calls = []
    reg = VariantRegistry({"fp32": StubVariant("fp32"), "int4": StubVariant("int4")},
                          warm_fn=lambda r, slots: calls.append(slots))
    reg.prewarm(3)
    reg.prewarm(3)
    assert calls == [3] and reg.precisions == ("fp32", "int4")


# ---------------------------------------------------------------------------
# (b) the real SNN variants, against the JAX package and pinned engines
# ---------------------------------------------------------------------------

SNN_EXACT_STATS = ("skip_rate", "batch_skip_rate", "in_spikes", "out_spikes", "spike_total",
                   "energy_j", "energy_analytical_j", "served_energy_j",
                   "served_energy_analytical_j", "precision", "wbytes_per")


def _snn_trace(cfg, n=6):
    """Numpy images from a seed: even ids near-silent (x0.02, source
    'sparse'), every third pinned to fp32."""
    rng = np.random.default_rng(1)
    payloads, options = [], []
    for i in range(n):
        img = rng.random((cfg.img_hw, cfg.img_hw, cfg.in_ch)).astype(np.float32)
        sparse = i % 2 == 0
        payloads.append(img * np.float32(0.02) if sparse else img)
        opts = {"source": "sparse" if sparse else "dense"}
        if i % 3 == 0:
            opts["pin_precision"] = "fp32"
        options.append(opts)
    return payloads, options


def _adaptive_engine(p, registry, cfg, obs=None):
    controller = p.precision.PrecisionController(pricer=p.precision.make_snn_pricer(cfg),
                                                 dense_threshold=0.8)
    runner = p.precision.PrecisionRunner(registry, controller)
    sched = p.scheduler.make_scheduler("sparsity")
    p.precision.bind_controller(sched, controller)
    kw = {} if obs is None else {"obs": obs}
    return p.core.EngineCore(runner, p.api.EngineConfig(slots=2, scheduler="sparsity",
                                                        precision="adaptive"),
                             scheduler=sched, **kw), controller


def _serve(engine, payloads, options):
    ids = [engine.submit(x, **o) for x, o in zip(payloads, options)]
    res = engine.run_until_complete()
    return [res[i] for i in ids]


@pytest.fixture(scope="module")
def snn_weights():
    return jax.tree.map(np.asarray, jax_init_vgg9(jax.random.PRNGKey(0), jax_cfgs.TINY))


@pytest.mark.parametrize("name", ["TINY", "TINY_INT4"])
def test_snn_adaptive_serving_matches_reference(snn_weights, name):
    cfg, jcfg = getattr(torch_cfgs, name), getattr(jax_cfgs, name)
    payloads, options = _snn_trace(cfg)
    jengine, jctl = _adaptive_engine(PKGS["jax"], jax_precision.make_snn_variants(
        jcfg, snn_weights, interpret=True), jcfg)
    ref = _serve(jengine, payloads, options)
    registry = make_snn_variants(cfg, params_from_numpy(snn_weights, "cpu"), device="cpu")
    registry.prewarm(2)
    engine, ctl = _adaptive_engine(PKGS["torch"], registry, cfg)
    out = _serve(engine, payloads, options)

    served = [r.stats["precision"] for r in out]
    assert served == [r.stats["precision"] for r in ref]
    assert set(served) == {"fp32", "int4"}
    assert all(served[i] == "fp32" for i, o in enumerate(options) if "pin_precision" in o)
    assert engine.admission_log == jengine.admission_log
    for a, b in zip(out, ref):
        assert a.status == b.status == "ok"
        np.testing.assert_allclose(a.outputs, np.asarray(b.outputs), atol=1e-5)
        for key in SNN_EXACT_STATS:
            assert a.stats[key] == b.stats[key], (a.request_id, key)
    log, ref_log = _decision_log(ctl), _decision_log(jctl)
    assert [d[:4] + d[5:] for d in log] == [d[:4] + d[5:] for d in ref_log]
    for d, r in zip(log, ref_log):
        for prec, prices in r[4].items():
            for k, v in prices.items():
                assert d[4][prec][k] == pytest.approx(v, rel=1e-12, abs=0)
    assert ctl.summary() == jctl.summary()


def test_snn_outputs_bit_identical_within_precision(snn_weights):
    cfg = torch_cfgs.TINY
    registry = make_snn_variants(cfg, params_from_numpy(snn_weights, "cpu"), device="cpu")
    payloads, options = _snn_trace(cfg, n=4)
    refs = {}
    for prec in registry.precisions:
        runner = registry.runner(prec)
        assert isinstance(runner, SNNRunner) and runner.device.type == "cpu"
        refs[prec] = _serve(EngineCore(runner, EngineConfig(slots=2)), payloads, options)
    engine, _ = _adaptive_engine(PKGS["torch"], registry, cfg)
    res = _serve(engine, payloads, options)
    served = [r.stats["precision"] for r in res]
    assert served[0] == served[3] == "fp32"              # the pinned requests
    assert "int4" in served                              # something harvested
    for i, r in enumerate(res):
        np.testing.assert_array_equal(r.outputs, refs[served[i]][i].outputs)
        assert r.stats["wbytes_per"] == (0.5 if served[i] == "int4" else 4.0)
        # both cost models ride on every result
        assert r.stats["served_energy_analytical_j"] > 0.0
        assert r.stats["served_energy_j"] > 0.0


# ---------------------------------------------------------------------------
# the LM half: reduced qwen
# ---------------------------------------------------------------------------

LM = dict(name="qwen-small", family="dense", n_layers=2, d_model=64, n_heads=4,
          n_kv_heads=4, head_dim=16, d_ff=128, vocab=512, qkv_bias=True,
          dtype="float32", remat="none", q_chunk=16, kv_chunk=16)
LM_SEQ, LM_TOKENS = 48, 6
LM_PROMPTS = ([1, 2, 3], [9, 8], [12, 13, 14, 15, 16, 17, 18, 19], [5], [7, 8, 9, 7, 8])


def test_lm_variant_streams_match_pinned_engines_and_reference():
    jp = jax_tf.init_params(jax.random.PRNGKey(0), jax_base.ArchConfig(**LM))
    tp = tf.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    cfg = ArchConfig(**LM)
    registry = make_lm_variants(cfg, tp, max_seq=LM_SEQ, device="cpu")
    registry.prewarm(3)
    # every other request pinned to int4; the rest the controller decides
    options = [{"pin_precision": "int4"} if i % 2 else {} for i in range(len(LM_PROMPTS))]
    engine = EngineCore(PrecisionRunner(registry), EngineConfig(slots=3, prefill_chunk=4))
    ids = [engine.submit(list(p), max_new_tokens=LM_TOKENS, **o)
           for p, o in zip(LM_PROMPTS, options)]
    res = engine.run_until_complete()
    served = [res[i].stats["precision"] for i in ids]
    assert served == ["fp32", "int4", "fp32", "int4", "fp32"]

    for prec, bits in (("fp32", 0), ("int4", 4)):
        pinned = EngineCore(LMRunner(cfg, tp, max_seq=LM_SEQ, quant_bits=bits, device="cpu"),
                            EngineConfig(slots=3, prefill_chunk=4))
        jengine = jax_core.EngineCore(
            JaxLMRunner(jax_base.ArchConfig(**LM), jp, max_seq=LM_SEQ, quant_bits=bits),
            jax_api.EngineConfig(slots=3, prefill_chunk=4))
        for single in (pinned, jengine):
            rids = [single.submit(list(p), max_new_tokens=LM_TOKENS) for p in LM_PROMPTS]
            streams = single.run_until_complete()
            for i, rid in enumerate(ids):
                if served[i] == prec:
                    assert res[rid].outputs == streams[rids[i]].outputs, (prec, i)
