"""The port's supervised router against the JAX package's.

Every stub scenario of `tests/test_serve_router.py` (balance, affinity,
QueueFull backoff, overload shedding, wedge / raise / NaN re-route, retry
exhaustion, deadline across re-route, flood, slot invariants, the stats
surface) runs once over each package's `make_router` on the reference's
`StubRunner`: the reference test's assertions hold for both, and the
port's drain log, completion steps, results, partial streams and
``stats()`` equal the reference's exactly. Then the chaos runs on real
models, with the weights carried across from JAX:

* the SNN at TINY, 3 replicas, plan ``0=wedge@1,1=nan@2:slot=0`` over an
  image trace submitted in waves: the same drain log and statuses, equal
  per-layer spike counts, logits within 1e-5, and every ``ok`` result bit
  for bit the port's solo `EngineCore`;
* the LM at the reference chaos test's config: token streams equal JAX's.

With ``obs=True`` the results are bit-identical, and `Router.telemetry`
merges replica spans and recorder dumps as `tests/test_obs.py` shows.
"""
import types

import jax
import numpy as np
import pytest

import repro.serve.api as ref_api
import repro.serve.core as ref_core
import repro.serve.faults as ref_faults
import repro.serve.router as ref_router
import repro_torch.serve.api as port_api
import repro_torch.serve.core as port_core
import repro_torch.serve.faults as port_faults
import repro_torch.serve.router as port_router
from repro.configs import vgg9_snn as jax_cfgs
from repro.configs.base import ArchConfig as JaxArchConfig
from repro.models import transformer as jax_tf
from repro.models.vgg9 import init_vgg9 as jax_init_vgg9
from repro.serve.runners.lm import LMRunner as JaxLMRunner
from repro.serve.runners.snn import SNNRunner as JaxSNNRunner
from repro_torch.configs import vgg9_snn as torch_cfgs
from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as tf
from repro_torch.models.vgg9 import params_from_numpy
from repro_torch.serve.runners.lm import LMRunner
from repro_torch.serve.runners.snn import SNNRunner
from test_serve_continuous import StubRunner
from test_serve_router import LM_CFG
from test_torch_faults import canon


def _package(api, core, faults, router):
    return types.SimpleNamespace(
        EngineConfig=api.EngineConfig, EngineCore=core.EngineCore, StepClock=core.StepClock,
        all_finite=core.all_finite, FaultPlan=faults.FaultPlan, flood_queue=faults.flood_queue,
        parse_fleet_plan=faults.parse_fleet_plan, make_router=router.make_router)


REF = _package(ref_api, ref_core, ref_faults, ref_router)
PORT = _package(port_api, port_core, port_faults, port_router)


def _router(pkg, n=3, plans=None, config=None, **kw):
    config = config if config is not None else pkg.EngineConfig(slots=2, max_queue=4)
    plans = {i: pkg.FaultPlan.parse(p) for i, p in (plans or {}).items()}
    return pkg.make_router(StubRunner(), n, config, plans=plans, **kw)


def _payload(steps=2, key="a"):
    return {"key": key, "steps": steps}


def _drive(router, rids, max_steps=400):
    """Step the fleet to completion, draining each request's partial stream
    as a live client would; returns (results, streams)."""
    streams = {rid: [] for rid in rids}
    for _ in range(max_steps):
        router.step()
        for rid in rids:
            streams[rid].extend(router.poll_partial(rid))
        if not router._outstanding:
            break
    assert not router._outstanding, "fleet did not converge"
    return {rid: router.poll(rid) for rid in rids}, streams


def _record(router, **extra):
    """What two packages' fleets must agree on."""
    return dict(extra, drain_log=router.drain_log, completed_at=router.completed_at,
                stats=router.stats(), placement=router._placement)


# ---------------------------------------------------------------------------
# stub scenarios: each takes one package, asserts what the reference test
# asserts, and returns the fleet's record
# ---------------------------------------------------------------------------

def submit_balances_across_replicas(pkg):
    router = _router(pkg, 3)
    rids = [router.submit(_payload()) for _ in range(6)]
    placed = [router._placement[rid] for rid in rids]
    assert sorted(placed.count(i) for i in range(3)) == [2, 2, 2]
    results = router.run_until_complete()
    assert all(r.status == "ok" for r in results.values())
    return _record(router, placed=placed, results=results)


def affinity_pins_stream_to_one_replica(pkg):
    router = _router(pkg, 3)
    rids = [router.submit(_payload(), affinity="stream-7") for _ in range(4)]
    assert len({router._placement[r] for r in rids}) == 1
    other = router.submit(_payload())
    assert router._placement[other] != router._placement[rids[0]]
    placed = [router._placement[r] for r in rids + [other]]
    return _record(router, placed=placed, results=router.run_until_complete())


def queue_full_backs_off_then_places(pkg):
    router = _router(pkg, 1, config=pkg.EngineConfig(slots=1, max_queue=1))
    rids = [router.submit(_payload(1)) for _ in range(5)]
    waiting = dict(router._waiting)
    assert waiting
    results = router.run_until_complete()
    assert sorted(results) == rids and all(r.status == "ok" for r in results.values())
    return _record(router, waiting=waiting, results=results)


def overload_sheds_lowest_priority(pkg):
    router = _router(pkg, 1, config=pkg.EngineConfig(slots=1, max_queue=1), max_waiting=3)
    high = [router.submit(_payload(1), priority=5) for _ in range(4)]
    low = [router.submit(_payload(1), priority=0) for _ in range(4)]
    results = router.run_until_complete()
    assert all(results[r].status == "ok" for r in high)
    shed = [r for r in low if results[r].status == "rejected"]
    assert shed and router.stats()["rejected"] == len(shed)
    return _record(router, results=results)


def wedged_replica_drained_and_rerouted(pkg):
    router = _router(pkg, 2, plans={0: "wedge@2"}, wedge_patience=3)
    rid = router.submit(_payload(steps=6))
    results, streams = _drive(router, [rid])
    assert results[rid].status == "ok" and streams[rid] == [1, 2, 3, 4, 5, 6]
    assert [r.state for r in router.replicas] == ["drained", "healthy"]
    assert router.replicas[0].condition == "wedged" and router.stats()["rerouted"] == 1
    return _record(router, results=results, streams=streams)


def raise_fault_condemns_and_reroutes(pkg):
    router = _router(pkg, 2, plans={0: "raise@1:message=kaboom"})
    rid = router.submit(_payload(steps=4))
    results = router.run_until_complete()
    assert results[rid].status == "ok" and "kaboom" in router.replicas[0].reason
    return _record(router, results=results,
                   reasons=[(r.condition, r.reason) for r in router.replicas])


def nan_poisoned_request_fails_with_partials_intact(pkg):
    router = _router(pkg, 3, plans={0: "nan@2:slot=0"})
    a = router.submit(_payload(steps=6))
    f1 = router.submit(_payload(steps=1))
    f2 = router.submit(_payload(steps=1))
    b = router.submit(_payload(steps=6))
    assert router._placement[a] == router._placement[b] == 0
    results, streams = _drive(router, [a, f1, f2, b])
    assert results[a].status == "failed" and results[b].status == "ok"
    assert router.replicas[0].condition == "poisoned"
    assert streams[a] == [1, 2] and pkg.all_finite(streams[a])
    assert streams[b] == [1, 2, 3, 4, 5, 6]
    return _record(router, results=results, streams=streams)


def retry_budget_exhaustion_fails_request(pkg):
    router = _router(pkg, 3, plans={i: "wedge@1" for i in range(3)}, max_retries=2,
                     wedge_patience=2)
    rid = router.submit(_payload(steps=5))
    results = router.run_until_complete()
    assert results[rid].status == "failed" and router.stats()["rerouted"] == 2
    assert all(r.state == "drained" for r in router.replicas)
    return _record(router, results=results)


def deadline_preserved_across_reroute(pkg):
    router = _router(pkg, 2, plans={0: "wedge@1"}, wedge_patience=8)
    rid = router.submit(_payload(steps=4), deadline_s=6.0)
    results = router.run_until_complete()
    assert results[rid].status == "expired"
    return _record(router, results=results)


def flood_queue_on_router(pkg):
    router = _router(pkg, 2)
    rids = pkg.flood_queue(router, _payload(1), count=10)
    assert len(rids) == 10
    results = router.run_until_complete()
    assert len(results) == 10
    return _record(router, results=results)


def slot_invariants_under_faults(pkg):
    plans = pkg.parse_fleet_plan("0=wedge@3,1=nan@4:slot=0")
    router = pkg.make_router(StubRunner(), 3, pkg.EngineConfig(slots=2, max_queue=4),
                             plans=plans, wedge_patience=2)
    rids = [router.submit(_payload(steps=4)) for _ in range(9)]
    for _ in range(60):
        router.step()
        for rep in router.replicas:
            occupied = [s.request_id for s in rep.core.slots if s.request_id is not None]
            assert len(occupied) == len(set(occupied))
            assert set(occupied) == set(rep.core._resident)
        if not router._outstanding:
            break
    assert not router._outstanding
    return _record(router, results={rid: router.poll(rid) for rid in rids})


def stats_surface(pkg):
    router = _router(pkg, 2, plans={0: "wedge@1"}, wedge_patience=2)
    router.submit(_payload(steps=3))
    results = router.run_until_complete()
    stats = router.stats()
    assert stats["healthy"] == 1 and stats["drains"] == 1 and stats["ok"] == 1
    assert [r["state"] for r in stats["replicas"]] == ["drained", "healthy"]
    return _record(router, results=results)


def wedge_drain_detail_with_and_without_obs(pkg):
    """`tests/test_obs.py`'s drain-detail cases: observed, the detail
    carries the wedged replica's recorder dump and the merged telemetry the
    router's drain counter; unobserved, no dump."""
    out = {}
    for obs in (True, False):
        router = pkg.make_router(StubRunner(), 2, pkg.EngineConfig(slots=2, max_queue=8),
                                 plans=pkg.parse_fleet_plan("0=wedge@2"), wedge_patience=2,
                                 obs=obs)
        rids = [router.submit({"key": "a", "steps": 6}, affinity="a") for _ in range(2)]
        results, streams = _drive(router, rids)
        assert all(results[r].status == "ok" for r in rids)
        (step, idx, condition, rerouted, detail), = router.drain_log
        assert idx == 0 and condition == "wedged" and rerouted
        assert isinstance(detail["marker"], tuple) and detail["cost_finite"] is True
        if obs:
            assert detail["dump"]["reason"] == "wedged" and detail["dump"]["frames"]
            tel = router.telemetry()
            assert tel["dumps"] and tel["metrics"]["router_drains"]["value"] == 1
            out["telemetry"] = tel
        else:
            assert detail.get("dump") is None
        out[obs] = _record(router, results=results, streams=streams)
    return out


def telemetry_merges_replica_spans(pkg):
    router = pkg.make_router(StubRunner(), 2, pkg.EngineConfig(slots=2, max_queue=8),
                             obs=True)
    rids = [router.submit({"key": "a", "steps": 2}) for _ in range(4)]
    results = router.run_until_complete()
    tel = router.telemetry()
    spans = tel["trace"]
    replicas = {str(s["replica"]) for s in spans}
    assert "router" in replicas and len(replicas) == 3
    ids = {s["span_id"] for s in spans}
    assert all(s["parent_id"] in ids for s in spans if s["parent_id"] is not None)
    roots = [s for s in spans if s["name"] == "request" and s["replica"] == "router"]
    assert len(roots) == 4 and all(r["status"] == "ok" for r in roots)
    agg = tel["metrics"]
    assert agg["router_submitted"]["value"] == 4 and agg["engine_retired_ok"]["value"] == 4
    return _record(router, results={r: results[r] for r in rids}, telemetry=tel)


SCENARIOS = {fn.__name__: fn for fn in (
    submit_balances_across_replicas, affinity_pins_stream_to_one_replica,
    queue_full_backs_off_then_places, overload_sheds_lowest_priority,
    wedged_replica_drained_and_rerouted, raise_fault_condemns_and_reroutes,
    nan_poisoned_request_fails_with_partials_intact, retry_budget_exhaustion_fails_request,
    deadline_preserved_across_reroute, flood_queue_on_router, slot_invariants_under_faults,
    stats_surface, wedge_drain_detail_with_and_without_obs, telemetry_merges_replica_spans)}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_port_equals_reference(name):
    assert canon(SCENARIOS[name](PORT)) == canon(SCENARIOS[name](REF))


@pytest.mark.parametrize("name", ["wedged_replica_drained_and_rerouted",
                                  "nan_poisoned_request_fails_with_partials_intact",
                                  "slot_invariants_under_faults"])
def test_obs_attached_changes_nothing(name):
    """``obs=True`` fleets give the same results, streams and drain log as
    detached ones (the drain detail gains only the recorder dump)."""
    plain = SCENARIOS[name](PORT)
    make_router = PORT.make_router
    observed = SCENARIOS[name](types.SimpleNamespace(
        **dict(vars(PORT), make_router=lambda *a, **kw: make_router(*a, obs=True, **kw))))
    for record in (plain, observed):
        record["drain_log"] = [entry[:4] for entry in record["drain_log"]]
        record["stats"] = {k: v for k, v in record["stats"].items() if k != "replicas"}
    assert canon(observed) == canon(plain)


# ---------------------------------------------------------------------------
# chaos on the real runners, weights carried across from JAX
# ---------------------------------------------------------------------------

SNN_PLAN = "0=wedge@1,1=nan@2:slot=0"
SNN_SLOTS = 2


def _images(n=9):
    rng = np.random.default_rng(5)
    imgs = [rng.random((16, 16, 3)).astype(np.float32) for _ in range(n)]
    for i in range(0, n, 2):
        imgs[i] = imgs[i] * np.float32(0.02)
    return imgs


def _snn_fleet(pkg, runner, imgs, waves=3):
    """3 replicas; the trace submitted in ``waves`` (one router step after
    each but the last), so that the wedge and the poison find work on their
    replicas' later steps."""
    router = pkg.make_router(runner, 3, pkg.EngineConfig(slots=SNN_SLOTS),
                             plans=pkg.parse_fleet_plan(SNN_PLAN))
    per = -(-len(imgs) // waves)
    rids = []
    for w in range(waves):
        rids += [router.submit(img) for img in imgs[w * per:(w + 1) * per]]
        if w < waves - 1:
            router.step()
    streams = {rid: router.poll_partial(rid) for rid in rids}
    results, more = _drive(router, rids)
    for rid in rids:
        streams[rid] += more[rid]
    return router, [results[r] for r in rids], streams


@pytest.fixture(scope="module")
def snn_runs():
    imgs = _images()
    jp = jax.tree.map(np.asarray, jax_init_vgg9(jax.random.PRNGKey(0), jax_cfgs.TINY))
    port_runner = SNNRunner(torch_cfgs.TINY, params_from_numpy(jp, "cpu"), device="cpu")
    solo = port_core.EngineCore(port_runner, port_api.EngineConfig(slots=SNN_SLOTS))
    ids = [solo.submit(img) for img in imgs]
    solo_res = solo.run_until_complete()
    return {"ref": _snn_fleet(REF, JaxSNNRunner(jax_cfgs.TINY, jp, interpret=True), imgs),
            "port": _snn_fleet(PORT, port_runner, imgs),
            "solo": [solo_res[i] for i in ids]}


def test_snn_chaos_equals_reference(snn_runs):
    (ref_router_, ref_res, ref_streams), (router, res, streams) = snn_runs["ref"], \
        snn_runs["port"]
    assert [e[:4] for e in router.drain_log] == [e[:4] for e in ref_router_.drain_log]
    assert canon([e[4] for e in router.drain_log]) == canon([e[4] for e in ref_router_.drain_log])
    assert {e[2] for e in router.drain_log} == {"wedged", "poisoned"}
    assert router.completed_at == ref_router_.completed_at
    assert [r.status for r in res] == [r.status for r in ref_res]
    assert [r.status for r in res].count("failed") == 1
    assert canon(streams) == canon(ref_streams)
    for a, b in zip(res, ref_res):
        if b.status != "ok":
            continue
        np.testing.assert_allclose(a.outputs, np.asarray(b.outputs), atol=1e-5)
        for key in ("out_spikes", "in_spikes", "spike_total", "skip_rate", "ts_occupancy"):
            assert a.stats[key] == b.stats[key], key


def test_snn_chaos_ok_results_bit_identical_to_solo_engine(snn_runs):
    router, res, streams = snn_runs["port"]
    failed = [r for r in res if r.status == "failed"]
    assert len(failed) == 1
    # the poisoned request: retired 'failed', nothing poisoned was streamed
    assert streams[failed[0].request_id] == [] and not port_core.all_finite(failed[0].outputs)
    for got, want in zip(res, snn_runs["solo"]):
        if got.status != "ok":
            continue
        assert np.array_equal(got.outputs, want.outputs)
        for key in ("out_spikes", "in_spikes", "spike_total", "skip_rate", "ts_occupancy"):
            assert got.stats[key] == want.stats[key], key
        assert canon(streams[got.request_id]) == canon(
            [{k: v[t] for k, v in want.stats["ts_occupancy"].items()} for t in range(2)])
    assert router.stats()["rerouted"] >= 1


def _lm_chaos(pkg, runner, config):
    """The reference's LM chaos test
    (`test_chaos_lm_wedge_and_poison_bit_identical`) on one package's runner."""
    prompts = [[1, 2, 3, 4], [7, 5, 3], [9, 9]]
    ref_core_ = pkg.EngineCore(runner, config(slots=2), clock=pkg.StepClock())
    ref_ids = [ref_core_.submit(p, max_new_tokens=6) for p in prompts]
    solo = ref_core_.run_until_complete()
    router = pkg.make_router(runner, 3, config(slots=2),
                             plans=pkg.parse_fleet_plan("0=wedge@4,1=nan@4:slot=0"),
                             wedge_patience=3)
    rids = [router.submit(p, max_new_tokens=6, affinity=k) for p, k in zip(prompts, "abc")]
    assert [router._placement[r] for r in rids] == [0, 1, 2]
    results, streams = _drive(router, rids)
    a, b, c = rids
    assert results[a].status == "ok" and results[a].outputs == solo[ref_ids[0]].outputs
    assert results[b].status == "failed" and router.replicas[1].condition == "poisoned"
    partials_b = streams[b]
    ref_b = solo[ref_ids[1]].outputs[len(prompts[1]):]
    assert partials_b and partials_b == ref_b[:len(partials_b)] and len(partials_b) < len(ref_b)
    assert results[c].status == "ok" and results[c].outputs == solo[ref_ids[2]].outputs
    assert streams[a] == solo[ref_ids[0]].outputs[len(prompts[0]):]
    return _record(router, results={r: (results[r].status, list(results[r].outputs))
                                    for r in rids}, streams=streams)


def test_lm_chaos_streams_equal_reference():
    cfg = dict(LM_CFG.__dict__)
    jp = jax_tf.init_params(jax.random.PRNGKey(0), JaxArchConfig(**cfg))
    params = tf.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    ours = _lm_chaos(PORT, LMRunner(ArchConfig(**cfg), params, max_seq=32, device="cpu"),
                     port_api.EngineConfig)
    theirs = _lm_chaos(REF, JaxLMRunner(LM_CFG, jp, max_seq=32), ref_api.EngineConfig)
    assert canon(ours) == canon(theirs)
