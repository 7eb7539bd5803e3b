"""The port's observability plane (`repro_torch.obs`) against the JAX
package's `repro.obs`, and its no-perturbation contract.

Units: the same operation sequence on the metrics registry, the tracer,
`merge_traces`, the flight recorder and the `Observability` hooks gives
equal snapshots, Prometheus text, spans and dumps in both packages. The
contract: serving the LM and the SNN with a bundle attached gives results
and admission decisions bit-identical to serving detached, and an engine
run on the deterministic `StepClock` gives the JAX package's snapshot.
Step records (the port's own, on ``time.perf_counter``): their spans nest
as the engine and the runner open them, count the step's fillers, stay out
of every export, reach a profiler's timeline, and are left open by no step.
"""
import types

import jax
import numpy as np
import pytest
import torch

from repro import obs as jax_obs
from repro.configs import vgg9_snn as jax_cfgs
from repro.models.vgg9 import init_vgg9 as jax_init_vgg9
from repro.serve.api import EngineConfig as JaxEngineConfig
from repro.serve.core import EngineCore as JaxEngineCore
from repro.serve.core import StepClock as JaxStepClock
from repro.serve.runners.snn import SNNRunner as JaxSNNRunner
from repro_torch import obs
from repro_torch.configs import vgg9_snn as torch_cfgs
from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as tf
from repro_torch.models.vgg9 import params_from_numpy
from repro_torch.obs import MetricsRegistry, Observability, Tracer, to_prometheus
from repro_torch.serve.api import EngineConfig
from repro_torch.serve.core import EngineCore, StepClock
from repro_torch.serve.precision import (PrecisionController, PrecisionRunner,
                                         bind_controller, make_snn_pricer,
                                         make_snn_variants)
from repro_torch.serve.runners.lm import LMRunner
from repro_torch.serve.runners.snn import SNNRunner
from repro_torch.serve.scheduler import make_scheduler


def _both(fn):
    """fn(obs module) in each package: (port's, JAX's)."""
    return fn(obs), fn(jax_obs)


# ---------------------------------------------------------------------------
# Metrics registry
# ---------------------------------------------------------------------------

def _registry_ops(o):
    reg = o.MetricsRegistry()
    reg.counter("c", "help c").inc(2)
    reg.gauge("g").set(1.5)
    reg.histogram("h", buckets=(0.1, 1.0)).observe(0.5)
    with pytest.raises(TypeError):          # kind clash on a known name
        reg.gauge("c")
    with pytest.raises(ValueError):         # counters are monotonic
        reg.counter("c").inc(-1)
    snap = reg.snapshot()
    return (snap, o.to_prometheus(snap), o.to_prometheus(snap, labels={"replica": "3"}),
            reg.to_json(), "c" in reg)


def test_registry_typed_and_prometheus():
    (snap, text, labelled, as_json, known), ref = _both(_registry_ops)
    assert (snap, text, labelled, as_json, known) == ref
    assert snap["c"] == {"kind": "counter", "value": 2.0, "help": "help c"}
    assert "# TYPE c counter" in text and "\nc 2" in text
    assert 'h_bucket{le="0.1"} 0' in text
    assert 'h_bucket{le="1.0"} 1' in text and "h_count 1" in text
    assert 'c{replica="3"} 2' in labelled and 'h_bucket{replica="3",le="+Inf"} 1' in labelled


def test_registry_collectors_pull_at_snapshot():
    reg = MetricsRegistry()
    state = {"ewma": 0.25}
    reg.collectors.append(lambda r: r.gauge("skip_ewma").set(state["ewma"]))
    assert reg.snapshot()["skip_ewma"]["value"] == 0.25
    state["ewma"] = 0.75                    # observed lazily, not cached
    assert reg.snapshot()["skip_ewma"]["value"] == 0.75


def _aggregate_ops(o):
    r0, r1 = o.MetricsRegistry(), o.MetricsRegistry()
    r0.counter("steps").inc(3)
    r1.counter("steps").inc(4)
    r0.gauge("depth").set(2)
    r1.gauge("depth").set(5)
    r0.histogram("lat", buckets=(1.0,)).observe(0.5)
    r1.histogram("lat", buckets=(1.0,)).observe(2.0)
    agg = o.aggregate({0: r0.snapshot(), 1: r1.snapshot()})
    r2 = o.MetricsRegistry()
    r2.gauge("steps").set(1)                # counter elsewhere
    with pytest.raises(TypeError):
        o.aggregate({0: r0.snapshot(), 2: r2.snapshot()})
    return agg


def test_aggregate_sums_and_per_replica_breakdown():
    agg, ref = _both(_aggregate_ops)
    assert agg == ref
    assert agg["steps"]["value"] == 7
    assert agg["depth"]["value"] == 7
    assert agg["depth"]["per_replica"] == {"0": 2.0, "1": 5.0}
    assert agg["lat"]["count"] == 2 and agg["lat"]["sum"] == 2.5


# ---------------------------------------------------------------------------
# Tracer
# ---------------------------------------------------------------------------

def _lifecycle(o):
    tr = o.Tracer()
    tr.begin(0, 0, 0.0, priority=1)
    tr.admit(0, 1, 1.0)
    tr.phase(0, "prefill", 1, 1.0, units=4)
    tr.phase(0, "prefill", 2, 2.0, units=4)
    tr.phase(0, "decode", 3, 3.0, units=1)
    tr.phase(0, "decode", 4, 4.0, units=1)
    tr.end(0, "ok", 5, 5.0)
    return tr.export()


def test_tracer_span_lifecycle():
    spans, ref = _both(_lifecycle)
    assert spans == ref
    by_name = {}
    for s in spans:
        by_name.setdefault(s["name"], []).append(s)
    root, = by_name["request"]
    assert root["status"] == "ok" and root["end_step"] == 5
    assert root["attrs"] == {"priority": 1}
    queued, = by_name["queued"]
    assert queued["parent_id"] == root["span_id"]
    assert (queued["start_step"], queued["end_step"]) == (0, 1)
    serve, = by_name["serve"]
    assert serve["parent_id"] == root["span_id"] and serve["end_step"] == 5
    assert len(by_name["prefill-chunk"]) == 2       # one span per chunk step
    decode, = by_name["decode"]                     # contiguous run coalesced
    assert (decode["start_step"], decode["end_step"]) == (3, 4)
    assert decode["attrs"]["units"] == 2


def test_tracer_queue_retirement_and_unknown_rids():
    tr = Tracer()
    tr.begin(7, 0, 0.0)
    tr.end(7, "expired", 3, 3.0)            # retired from the queue
    spans = {s["name"]: s for s in tr.export()}
    assert spans["request"]["status"] == "expired"
    assert spans["queued"]["end_step"] == 3
    tr.phase(99, "decode", 1, 1.0)          # unknown rid: ignored
    tr.end(99, "ok", 1, 1.0)
    assert len(tr.export()) == 2


def _drains(o):
    tr = o.Tracer()
    tr.begin(0, 0, 0.0)
    tr.admit(0, 1, 1.0)                     # closes 'queued'
    first, again = tr.drain(), tr.drain()
    tr.end(0, "ok", 2, 2.0)
    return first, again, tr.drain(), tr.drain()


def test_tracer_drain_ships_increments():
    drains, ref = _both(_drains)
    assert drains == ref
    first, again, last, empty = drains
    assert [s["name"] for s in first] == ["queued"]
    assert again == [] and empty == []      # an increment, not a repeat
    assert sorted(s["name"] for s in last) == ["request", "serve"]


def _merged(o):
    a = o.Tracer()
    a.begin(0, 0, 0.0)
    a.end(0, "ok", 1, 1.0)
    b = o.Tracer()
    b.begin(0, 0, 0.0)                      # same local ids as a's
    b.end(0, "failed", 2, 2.0)
    return o.merge_traces([(0, a.export()), (1, b.export())])


def test_merge_traces_namespaces_ids():
    merged, ref = _both(_merged)
    assert merged == ref
    ids = {s["span_id"] for s in merged}
    assert len(ids) == len(merged) == 4     # no collisions after namespacing
    assert all(s["parent_id"] in ids for s in merged if s["parent_id"] is not None)
    assert {s["replica"] for s in merged} == {0, 1}


# ---------------------------------------------------------------------------
# Flight recorder and the bundle's hooks
# ---------------------------------------------------------------------------

def _report(units):
    """Minimal StepReport stand-in for ring tests."""
    return types.SimpleNamespace(cost={"units": units}, finished={}, progress={})


def _recorder_ops(o):
    rec = o.FlightRecorder(capacity=3)
    for step in range(5):
        rec.record(step, _report(step), seconds=0.1, queue_len=1, occupied=2)
        rec.note(step, "admit", rids=[step])
    dump = rec.dump("stalled", extra={"resident": [7]})
    return list(rec.frames), rec.tail(2), dump, rec.dumps


def test_recorder_ring_is_bounded_and_dumps():
    (frames, tail, dump, dumps), ref = _both(_recorder_ops)
    assert (frames, tail, dump, dumps) == ref
    assert [f["step"] for f in frames] == [2, 3, 4]
    assert tail[-1]["cost"] == {"units": 4}
    assert dump["reason"] == "stalled" and dump["step"] == 4
    assert len(dump["frames"]) == 3 and dump["resident"] == [7]
    assert [n["step"] for n in dump["notes"]] == [2, 3, 4]
    assert dumps == [dump]


def _telemetry(o):
    bundle = o.Observability()
    bundle.on_submit(0, 0, 0.0)
    bundle.on_admit([0], 0, 0.0)
    t1, t2 = bundle.wire_telemetry(), bundle.wire_telemetry()
    dump = bundle.on_dump("stalled", 3, resident=[0])
    return t1, t2, dump, bundle.wire_telemetry(), bundle.wire_telemetry(), bundle.snapshot()


def test_wire_telemetry_is_incremental():
    (t1, t2, dump, t3, t4, snap), ref = _both(_telemetry)
    assert (t1, t2, dump, t3, t4, snap) == ref
    assert [s["name"] for s in t1["spans"]] == ["queued"]
    assert "engine_admitted" in t1["metrics"]
    assert t2["spans"] == []                # only newly closed spans ship
    assert dump["reason"] == "stalled"
    assert [d["reason"] for d in t3["dumps"]] == ["stalled"]
    assert "dumps" not in t4                # shipped once
    assert Observability(trace=False, metrics=False, recorder=0).snapshot() == {}


# ---------------------------------------------------------------------------
# No-perturbation contract: attached == detached, bit-identically
# ---------------------------------------------------------------------------

LM_CFG = dict(name="t-obs", family="dense", n_layers=2, d_model=32, n_heads=4,
              n_kv_heads=2, head_dim=8, d_ff=64, vocab=61, dtype="float32", remat="none",
              q_chunk=8, kv_chunk=8)


@pytest.mark.parametrize("seed", [0, 1])
def test_lm_bit_identical_with_obs_attached(seed):
    cfg = ArchConfig(**LM_CFG)
    params = tf.init_params(torch.Generator().manual_seed(seed), cfg, "cpu")
    runner = LMRunner(cfg, params, max_seq=32, device="cpu")
    prompts = [[1 + seed, 2, 3], [7, 5], [4, 4, 4, 4]]

    def serve(bundle):
        engine = EngineCore(runner, EngineConfig(slots=2, prefill_chunk=2),
                            clock=StepClock(), obs=bundle)
        rids = [engine.submit(p, max_new_tokens=5) for p in prompts]
        results = engine.run_until_complete()
        return [results[r] for r in rids], list(engine.admission_log)

    plain, log_plain = serve(None)
    bundle = Observability()
    observed, log_obs = serve(bundle)
    assert [r.outputs for r in observed] == [r.outputs for r in plain]
    assert [r.status for r in observed] == [r.status for r in plain]
    assert [dict(r.stats) for r in observed] == [dict(r.stats) for r in plain]
    assert log_obs == log_plain             # identical admission decisions
    # ... and the attached bundle really observed the run
    roots = [s for s in bundle.tracer.export() if s["name"] == "request"]
    assert len(roots) == len(prompts)
    assert {s["status"] for s in roots} == {"ok"}
    chunks = [s for s in bundle.tracer.export() if s["name"] == "prefill-chunk"]
    assert len(chunks) == sum(dict(r.stats)["prefill_chunks"] for r in plain)
    snap = bundle.metrics.snapshot()
    assert snap["engine_retired_ok"]["value"] == len(prompts)
    assert snap["engine_decode_tokens"]["value"] == sum(
        dict(r.stats)["new_tokens"] for r in plain)
    assert len(bundle.recorder.frames) > 0


@pytest.fixture(scope="module")
def snn_weights():
    return {seed: jax.tree.map(np.asarray, jax_init_vgg9(jax.random.PRNGKey(seed),
                                                        jax_cfgs.TINY))
            for seed in (0, 1)}


def _snn_images(seed, cfg):
    rng = np.random.default_rng(seed + 10)
    imgs = [rng.random((cfg.img_hw, cfg.img_hw, cfg.in_ch)).astype(np.float32)
            for _ in range(3)]
    imgs[0] = imgs[0] * np.float32(0.02)    # near-silent: sparse class
    return imgs


def _snn_serve(engine, imgs):
    rids = [engine.submit(img, source="sparse" if i == 0 else "dense")
            for i, img in enumerate(imgs)]
    results = engine.run_until_complete()
    return [results[r] for r in rids], list(engine.admission_log)


@pytest.mark.parametrize("seed", [0, 1])
def test_snn_bit_identical_with_obs_attached(snn_weights, seed):
    cfg = torch_cfgs.TINY
    runner = SNNRunner(cfg, params_from_numpy(snn_weights[seed], "cpu"), device="cpu")
    imgs = _snn_images(seed, cfg)

    def serve(bundle):
        return _snn_serve(EngineCore(runner, EngineConfig(slots=2, scheduler="sparsity"),
                                     clock=StepClock(), obs=bundle), imgs)

    plain, log_plain = serve(None)
    bundle = Observability()
    observed, log_obs = serve(bundle)
    for a, b in zip(observed, plain):
        assert a.status == b.status == "ok"
        assert (a.outputs == b.outputs).all()
        assert dict(a.stats) == dict(b.stats)
    assert log_obs == log_plain             # same batch-composition decisions
    snap = bundle.snapshot()
    assert "scheduler_skip_ewma_global" in snap["metrics"]      # sparsity EWMAs pulled
    assert snap["metrics"]["engine_retired_ok"]["value"] == len(imgs)
    assert snap["metrics"]["precision_served_energy_eq3_j"]["value"] > 0

    # the JAX package's engine, on the same clock and weights: the same
    # spans, notes and metrics (step seconds come from the clock)
    jbundle = jax_obs.Observability()
    _snn_serve(JaxEngineCore(JaxSNNRunner(jax_cfgs.TINY, snn_weights[seed], interpret=True),
                             JaxEngineConfig(slots=2, scheduler="sparsity"),
                             clock=JaxStepClock(), obs=jbundle), imgs)
    ref = jbundle.snapshot()
    assert snap["trace"] == ref["trace"]
    assert snap["dumps"] == ref["dumps"] == []
    assert list(bundle.recorder.notes) == list(jbundle.recorder.notes)
    assert snap["metrics"].keys() == ref["metrics"].keys()
    for name, metric in ref["metrics"].items():
        if metric["kind"] == "histogram":
            assert snap["metrics"][name] == metric, name
        else:
            assert snap["metrics"][name]["value"] == pytest.approx(metric["value"],
                                                                   rel=1e-12), name


def test_adaptive_snn_bit_identical_with_obs_attached(snn_weights):
    cfg = torch_cfgs.TINY
    registry = make_snn_variants(cfg, params_from_numpy(snn_weights[0], "cpu"), device="cpu")
    imgs = _snn_images(0, cfg) + _snn_images(1, cfg)

    def serve(bundle):
        controller = PrecisionController(pricer=make_snn_pricer(cfg), dense_threshold=0.8)
        sched = make_scheduler("sparsity")
        bind_controller(sched, controller)
        engine = EngineCore(PrecisionRunner(registry, controller),
                            EngineConfig(slots=2, scheduler="sparsity", precision="adaptive"),
                            scheduler=sched, clock=StepClock(), obs=bundle)
        rids = [engine.submit(img, source="sparse" if i % 3 == 0 else "dense",
                              **({"pin_precision": "fp32"} if i == 1 else {}))
                for i, img in enumerate(imgs)]
        results = engine.run_until_complete()
        decisions = [(d.request_id, d.precision, d.reason, d.predicted_skip, d.prices)
                     for d in controller.decisions]
        return [results[r] for r in rids], list(engine.admission_log), decisions

    plain, log_plain, dec_plain = serve(None)
    bundle = Observability()
    observed, log_obs, dec_obs = serve(bundle)
    for a, b in zip(observed, plain):
        assert np.array_equal(a.outputs, b.outputs)
        assert dict(a.stats) == dict(b.stats)
    assert log_obs == log_plain and dec_obs == dec_plain
    assert {r.stats["precision"] for r in plain} == {"fp32", "int4"}
    snap = bundle.metrics.snapshot()
    served = sum(r.stats["served_energy_j"] for r in plain)
    assert snap["precision_served_energy_eq3_j"]["value"] == pytest.approx(served, rel=1e-12)
    assert snap["precision_decisions"]["value"] == len(imgs)
    assert snap["precision_served_int4"]["value"] + snap["precision_served_fp32"]["value"] \
        == len(imgs)
    assert "precision_served_energy_analytical_j" in snap
    notes = [n for n in bundle.recorder.notes if n["kind"] == "precision"]
    assert [(n["rid"], n["precision"]) for n in notes] == [d[:2] for d in dec_plain]
    assert to_prometheus(snap).count("# TYPE precision_") >= 5


# ---------------------------------------------------------------------------
# Step records: phases inside each engine step (`obs.trace.record_step`)
# ---------------------------------------------------------------------------

def _tiny_snn_engine(snn_weights, bundle, admission="continuous", runner_cls=SNNRunner):
    runner = runner_cls(torch_cfgs.TINY, params_from_numpy(snn_weights[0], "cpu"),
                        device="cpu")
    return EngineCore(runner, EngineConfig(slots=4, admission=admission),
                      clock=StepClock(), obs=bundle)


def _bench_bundle():
    """The bundle a benchmark's traced run attaches: the tracer alone."""
    return Observability(trace=True, metrics=False, recorder=0)


@pytest.mark.parametrize("admission", ["continuous", "batch"])
def test_step_records_leave_serving_bit_identical(snn_weights, admission):
    imgs = _snn_images(0, torch_cfgs.TINY)

    def serve(bundle):
        engine = _tiny_snn_engine(snn_weights, bundle, admission)
        results, log = _snn_serve(engine, imgs)
        return results, log, engine.stats()

    plain, log_plain, stats_plain = serve(None)
    bundle = _bench_bundle()
    observed, log_obs, stats_obs = serve(bundle)
    for a, b in zip(observed, plain):
        assert a.status == b.status == "ok"
        assert np.array_equal(a.outputs, b.outputs)
        assert dict(a.stats) == dict(b.stats)
    assert log_obs == log_plain and stats_obs == stats_plain
    steps = list(bundle.tracer.steps)
    assert [s.step for s in steps] == list(range(stats_plain["steps_run"]))
    for s in steps:
        assert s.start_s <= s.end_s
        assert {"engine.step", "engine.admit", "engine.session_step", "engine.retire",
                "snn.stack", "snn.forward", "snn.read", "snn.skip_split",
                "snn.ts_occupancy", "snn.energy", "snn.results"} <= set(s.seconds)
        assert s.device_ms == {}                # no device marks on the CPU
    # step records stay out of every export the JAX package's bundle has
    assert not any(s["name"].startswith(("engine.", "snn.")) for s in bundle.tracer.export())
    assert set(bundle.snapshot()) == {"trace"}


@pytest.mark.parametrize("shards", [1, 2])
def test_step_record_spans_nest(snn_weights, shards):
    """The same spans on the unsharded and the data-mesh path."""
    from repro_torch.dist.context import compute_mesh
    from repro_torch.launch.mesh import make_data_mesh
    bundle = _bench_bundle()
    with compute_mesh(make_data_mesh(shards, "cpu")):
        _snn_serve(_tiny_snn_engine(snn_weights, bundle), _snn_images(1, torch_cfgs.TINY))
    step, = bundle.tracer.steps
    assert step.parent["engine.step"] is None
    children = [n for n, p in step.parent.items() if p == "engine.step"]
    assert set(children) == {"engine.admit", "engine.session_step", "engine.screen",
                             "engine.retire"}
    assert step.seconds["engine.step"] >= sum(step.seconds[n] for n in children)
    runner_spans = [n for n in step.parent if n.startswith("snn.")]
    assert len(runner_spans) == 7
    assert all(step.parent[n] == "engine.session_step" for n in runner_spans)
    assert step.seconds["engine.session_step"] >= sum(step.seconds[n] for n in runner_spans)


def test_step_record_counts_fillers(snn_weights):
    bundle = _bench_bundle()
    engine = _tiny_snn_engine(snn_weights, bundle)
    _snn_serve(engine, _snn_images(0, torch_cfgs.TINY))     # 3 requests on 4 slots
    step, = bundle.tracer.steps
    assert step.counters == {"snn.fillers": 1}
    assert step.device_ms == {}


def test_step_ring_is_bounded():
    from repro_torch.obs.trace import STEP_RING, count
    tracer = Tracer()
    for k in range(STEP_RING + 5):
        with tracer.record_step(k):
            count("n", k)
    assert len(tracer.steps) == STEP_RING
    assert [s.step for s in (tracer.steps[0], tracer.steps[-1])] == [5, STEP_RING + 4]
    assert tracer.steps[-1].counters == {"n": STEP_RING + 4}
    assert tracer.export() == [] and tracer.drain() == []


def test_latest_steps_follows_the_tracer_that_stepped_last():
    from repro_torch.obs.trace import latest_steps
    first, second = Tracer(), Tracer()
    with first.record_step(0):
        pass
    assert latest_steps() is first.steps
    with second.record_step(0):
        pass
    with second.record_step(1):
        pass
    assert latest_steps() is second.steps
    assert [s.step for s in latest_steps()] == [0, 1]


class _RecordingRunner(SNNRunner):
    """Notes the step record open while it runs; raises when told to."""
    seen = []
    fail = False

    def run(self, batch):
        from repro_torch.obs import trace
        type(self).seen.append(trace._OPEN.get())
        if type(self).fail:
            raise RuntimeError("runner fault")
        return super().run(batch)


def test_no_step_record_without_a_tracer_and_none_left_open(snn_weights, monkeypatch):
    from repro_torch.obs import trace
    monkeypatch.setattr(_RecordingRunner, "seen", [])
    _snn_serve(_tiny_snn_engine(snn_weights, None, runner_cls=_RecordingRunner),
               _snn_images(0, torch_cfgs.TINY))
    _snn_serve(_tiny_snn_engine(snn_weights, Observability(trace=False),
                                runner_cls=_RecordingRunner), _snn_images(0, torch_cfgs.TINY))
    assert _RecordingRunner.seen == [None, None]
    assert trace._OPEN.get() is None

    bundle = _bench_bundle()
    engine = _tiny_snn_engine(snn_weights, bundle, runner_cls=_RecordingRunner)
    monkeypatch.setattr(_RecordingRunner, "fail", True)
    engine.submit(_snn_images(0, torch_cfgs.TINY)[1])
    with pytest.raises(RuntimeError, match="runner fault"):
        engine.step()
    assert _RecordingRunner.seen[-1] is not None    # open while the runner ran
    assert trace._OPEN.get() is None                # and reset by the fault
    step, = bundle.tracer.steps
    assert step.end_s is not None and "snn.forward" not in step.seconds


def test_step_spans_reach_the_profiler(snn_weights):
    from torch.profiler import ProfilerActivity, profile, record_function
    engine = _tiny_snn_engine(snn_weights, _bench_bundle())
    for img in _snn_images(0, torch_cfgs.TINY):
        engine.submit(img)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("caller"):
            engine.step()
    events = {}
    for e in prof.events():
        events.setdefault(e.name, e)
    inside = lambda inner, outer: (outer.time_range.start <= inner.time_range.start
                                   and inner.time_range.end <= outer.time_range.end)
    for name in ("engine.step", "engine.admit", "engine.session_step", "engine.retire",
                 "snn.forward", "snn.skip_split", "snn.energy"):
        assert name in events and inside(events[name], events["caller"]), name
    assert inside(events["snn.skip_split"], events["engine.session_step"])
    assert inside(events["engine.session_step"], events["engine.step"])
