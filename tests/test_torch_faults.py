"""The port's fault-injection harness against the JAX package's.

Every scenario of `tests/test_serve_faults.py` runs once over each
package's `serve.faults` + `EngineCore` on the reference's pure-Python
`StubRunner` (the same stub for both): the reference test's own assertions
hold for both, and the port's results, stats, partial streams, admission
logs and error messages equal the reference's exactly. That covers plan
parsing and its rejection messages, the wedge / raise / slow / nan / flood
faults, the engine's numerics screen and `EngineStalled` guard, and the
random interleavings that must never leak a slot. The last tests hold what
only the port has: `poison` of torch tensors.
"""
import dataclasses
import random
import types

import numpy as np
import pytest
import torch

import repro.serve.api as ref_api
import repro.serve.core as ref_core
import repro.serve.faults as ref_faults
import repro_torch.serve.api as port_api
import repro_torch.serve.core as port_core
import repro_torch.serve.faults as port_faults
from test_serve_continuous import StubRunner


def _package(api, core, faults):
    return types.SimpleNamespace(
        EngineConfig=api.EngineConfig, EngineStalled=api.EngineStalled,
        Request=api.Request, StepBudget=api.StepBudget, EngineCore=core.EngineCore,
        StepClock=core.StepClock, all_finite=core.all_finite, Fault=faults.Fault,
        FaultError=faults.FaultError, FaultPlan=faults.FaultPlan,
        FaultyRunner=faults.FaultyRunner, TickClock=faults.TickClock,
        flood_queue=faults.flood_queue, parse_fleet_plan=faults.parse_fleet_plan,
        poison=faults.poison)


REF = _package(ref_api, ref_core, ref_faults)
PORT = _package(port_api, port_core, port_faults)


def canon(value):
    """A package-independent, NaN-safe form of a value for equality: a
    dataclass by its class name and fields, an array (or tensor) by dtype,
    shape and bytes, a float by its repr (NaN equals NaN, -0.0 is not 0.0),
    an exception by its type name and message."""
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return (type(value).__name__,) + tuple(
            (f.name, canon(getattr(value, f.name))) for f in dataclasses.fields(value))
    if isinstance(value, BaseException):
        return (type(value).__name__, str(value))
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu().numpy()
    if isinstance(value, (np.ndarray, np.generic)):
        arr = np.asarray(value)
        return ("nd", arr.dtype.str, arr.shape, arr.tobytes())
    if isinstance(value, float):
        return ("float", repr(value))
    if isinstance(value, dict):
        return ("dict", tuple(sorted(((canon(k), canon(v)) for k, v in value.items()),
                                     key=repr)))
    if isinstance(value, (list, tuple)):
        return (type(value).__name__, tuple(canon(v) for v in value))
    return value


def raised(fn, *args, **kwargs):
    """The exception ``fn`` raises (pytest fails the test if it returns)."""
    with pytest.raises(Exception) as exc:
        fn(*args, **kwargs)
    return exc.value


def _core(pkg, runner=None, **cfg):
    cfg.setdefault("slots", 2)
    return pkg.EngineCore(runner if runner is not None else StubRunner(),
                          pkg.EngineConfig(**cfg), clock=pkg.StepClock())


def _session(pkg, plan, clock=None, slots=2):
    return pkg.FaultyRunner(StubRunner(), pkg.FaultPlan.parse(plan), clock).open_session(slots)


# ---------------------------------------------------------------------------
# scenarios: each takes one package, asserts what the reference test
# asserts, and returns what the two packages must agree on
# ---------------------------------------------------------------------------

def fault_plan_parse(pkg):
    plan = pkg.FaultPlan.parse("wedge@3;nan@5-7:slot=0;slow@2:seconds=3.5")
    assert plan.active("wedge", 2) is None
    assert plan.active("wedge", 3).kind == "wedge"
    assert plan.active("nan", 7) is None
    assert pkg.FaultPlan.parse("").faults == ()
    return [plan, [(kind, step, plan.active(kind, step))
                   for kind in ("wedge", "nan", "slow", "raise") for step in range(9)]]


def fault_plan_parse_rejects_garbage(pkg):
    errors = [raised(pkg.FaultPlan.parse, spec)
              for spec in ("wedge3", "meteor@3", "nan@3:wat=1", "nan@3:slot")]
    assert all(isinstance(e, ValueError) for e in errors)
    return errors


def parse_fleet_plan(pkg):
    plans = pkg.parse_fleet_plan("1=wedge@3,2=nan@5:slot=0;raise@9,1=slow@4")
    assert set(plans) == {1, 2}
    assert plans[2].active("nan", 5).slot == 0
    error = raised(pkg.parse_fleet_plan, "wedge@3")
    assert isinstance(error, ValueError)
    return [plans, error]


def tick_clock(pkg):
    clock = pkg.TickClock()
    seen = [clock()]
    seen.append(clock.advance(2.5))
    seen.append(clock())
    assert seen == [0.0, 2.5, 2.5]
    return seen


def poison_preserves_shape(pkg):
    out = pkg.poison({"a": [1, 2.0], "b": ("x", 3), "c": np.ones((2, 2)),
                      "d": np.arange(3, dtype=np.int32), "e": np.float32(2.0)})
    assert out["a"][0] != out["a"][0] and out["b"][0] == "x"
    assert out["c"].shape == (2, 2) and not pkg.all_finite(out["c"])
    meta = pkg.poison({"meta": "tag", "flag": True, "none": None, "raw": b"\x00"})
    assert pkg.all_finite(meta)
    return [out, meta]


def wedge_leaves_inner_untouched(pkg):
    sess = _session(pkg, "wedge@1-3")
    sess.admit(0, pkg.Request(1, {"key": "a", "steps": 2}))
    reports = [sess.step(pkg.StepBudget()) for _ in range(4)]
    assert reports[0].progress[0].units_done == 1
    assert all(not r.progress and r.cost == {"units": 0} for r in reports[1:3])
    assert 0 in reports[3].finished and reports[3].progress[0].units_done == 2
    return [reports, sess.step_idx]


def raise_fault_raises(pkg):
    sess = _session(pkg, "raise@1:message=boom")
    sess.admit(0, pkg.Request(1, {"key": "a", "steps": 3}))
    first = sess.step(pkg.StepBudget())
    error = raised(sess.step, pkg.StepBudget())
    assert isinstance(error, pkg.FaultError) and "boom" in str(error)
    return [first, error]


def slow_fault_advances_clock(pkg):
    clock = pkg.TickClock()
    sess = _session(pkg, "slow@0-1:seconds=4.0", clock=clock)
    sess.admit(0, pkg.Request(1, {"key": "a", "steps": 2}))
    seen = []
    for _ in range(2):
        seen.append((sess.step(pkg.StepBudget()), clock()))
    assert [t for _, t in seen] == [4.0, 4.0]
    return seen


def nan_fault_poisons_only_target_slot(pkg):
    sess = _session(pkg, "nan@0:slot=1")
    sess.admit(0, pkg.Request(1, {"key": "a", "steps": 2}))
    sess.admit(1, pkg.Request(2, {"key": "a", "steps": 2}))
    rep = sess.step(pkg.StepBudget())
    assert pkg.all_finite(rep.progress[0].emitted)
    assert not pkg.all_finite(rep.progress[1].emitted)
    res = sess.cancel(1)
    assert res.status == "cancelled" and pkg.all_finite(res.outputs)
    return [rep, res]


def flood_queue_fills_to_capacity(pkg):
    core = _core(pkg, max_queue=5)
    rids = pkg.flood_queue(core, {"key": "a", "steps": 1})
    assert len(rids) == 5 and core.pending() == 5
    assert pkg.flood_queue(core, {"key": "a", "steps": 1}) == []
    error = raised(pkg.flood_queue, object(), {"key": "a"})
    assert isinstance(error, ValueError)
    return [rids, error, core.run_until_complete(), core.stats()]


def run_until_complete_raises_on_wedged_session(pkg):
    runner = pkg.FaultyRunner(StubRunner(), pkg.FaultPlan.parse("wedge@1"))
    core = _core(pkg, runner, max_idle_steps=7)
    rid = core.submit({"key": "a", "steps": 5})
    error = raised(core.run_until_complete)
    assert isinstance(error, pkg.EngineStalled)
    assert "7 consecutive steps" in str(error) and str(rid) in str(error)
    return [error, core.stats(), core.poll_partial(rid)]


def run_until_complete_override_and_recovery(pkg):
    runner = pkg.FaultyRunner(StubRunner(), pkg.FaultPlan.parse("wedge@1-4"))
    core = _core(pkg, runner, max_idle_steps=2)
    rid = core.submit({"key": "a", "steps": 2})
    results = core.run_until_complete(max_idle_steps=10)
    assert results[rid].status == "ok"
    return [results, core.stats()]


def numerics_screen_retires_poisoned_slot(pkg):
    clean = _core(pkg)
    a0 = clean.submit({"key": "a", "steps": 4})
    b0 = clean.submit({"key": "a", "steps": 4})
    ref = clean.run_until_complete()

    runner = pkg.FaultyRunner(StubRunner(), pkg.FaultPlan.parse("nan@2:slot=0"))
    core = _core(pkg, runner)
    a = core.submit({"key": "a", "steps": 4})
    b = core.submit({"key": "a", "steps": 4})
    core.step()
    core.step()
    pre_poison = core.poll_partial(a)
    assert pre_poison == [1, 2] and pkg.all_finite(pre_poison)
    results = core.run_until_complete()
    assert results[a].status == "failed" and results[b].status == "ok"
    assert results[b].outputs == ref[b0].outputs
    assert core.stats()["failed"] == 1 and core.in_flight() == 0
    return [ref, a0, pre_poison, results, core.stats(), core.admission_log]


def numerics_screen_never_streams_poison(pkg):
    runner = pkg.FaultyRunner(StubRunner(), pkg.FaultPlan.parse("nan@1"))
    core = _core(pkg, runner, slots=1)
    rid = core.submit({"key": "a", "steps": 3})
    core.step()
    core.step()
    partials = core.poll_partial(rid)
    result = core.poll(rid)
    assert partials == [1] and result.status == "failed"
    return [partials, result, core.stats()]


def numerics_screen_can_be_disabled(pkg):
    runner = pkg.FaultyRunner(StubRunner(), pkg.FaultPlan.parse("nan@0"))
    core = _core(pkg, runner, slots=1, numerics_screen=False)
    rid = core.submit({"key": "a", "steps": 1})
    results = core.run_until_complete()
    assert results[rid].status == "ok"
    return [results, core.stats()]


def _assert_slot_invariants(core, polled, submitted):
    occupied = [s.request_id for s in core.slots if s.request_id is not None]
    assert len(occupied) == len(set(occupied)), "slot holds duplicate rids"
    assert set(occupied) == set(core._resident), "slot occupancy out of sync"
    assert core.in_flight() == len(core._resident)
    for rid in occupied:
        assert rid not in polled, f"rid {rid} resident after terminal result"
    assert set(polled) <= submitted


def random_interleavings(pkg, seed):
    """The reference's property sweep: random submit / cancel / expiry /
    NaN retirement under a random fault schedule keep slot accounting exact
    after every step, and every request ends with one terminal result."""
    rng = random.Random(seed)
    faults = []
    for step in sorted(rng.sample(range(2, 40), 6)):
        faults.append(pkg.Fault("nan", step, stop=step + 1, slot=rng.randrange(3)))
    if rng.random() < 0.5:
        w = rng.randrange(10, 30)
        faults.append(pkg.Fault("wedge", w, stop=w + rng.randrange(1, 4)))
    runner = pkg.FaultyRunner(StubRunner(), pkg.FaultPlan(tuple(faults)))
    core = _core(pkg, runner, slots=3, max_queue=16, max_idle_steps=0)

    submitted, polled, live = set(), {}, []
    for _ in range(60):
        op = rng.random()
        if op < 0.45 and len(live) < 12:
            rid = core.submit(
                {"key": "a", "steps": rng.randrange(1, 5)},
                deadline_s=rng.choice([None, None, float(rng.randrange(1, 6))]))
            submitted.add(rid)
            live.append(rid)
        elif op < 0.6 and live:
            core.cancel(rng.choice(live))
        else:
            core.step()
        for rid in list(live):
            res = core.poll(rid)
            if res is not None:
                assert rid not in polled, "double terminal result"
                polled[rid] = res
                live.remove(rid)
        _assert_slot_invariants(core, polled, submitted)
    for rid, res in core.run_until_complete().items():
        assert rid not in polled
        polled[rid] = res
    _assert_slot_invariants(core, polled, submitted)
    assert set(polled) == submitted
    admitted = {rid for _, group in core.admission_log for rid in group}
    assert sum(s.served for s in core.slots) == len(admitted)
    return [polled, core.stats(), core.admission_log]


SCENARIOS = {fn.__name__: fn for fn in (
    fault_plan_parse, fault_plan_parse_rejects_garbage, parse_fleet_plan, tick_clock,
    poison_preserves_shape, wedge_leaves_inner_untouched, raise_fault_raises,
    slow_fault_advances_clock, nan_fault_poisons_only_target_slot,
    flood_queue_fills_to_capacity, run_until_complete_raises_on_wedged_session,
    run_until_complete_override_and_recovery, numerics_screen_retires_poisoned_slot,
    numerics_screen_never_streams_poison, numerics_screen_can_be_disabled)}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_port_equals_reference(name):
    assert canon(SCENARIOS[name](PORT)) == canon(SCENARIOS[name](REF))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_random_interleavings_equal_reference_and_never_leak(seed):
    assert canon(random_interleavings(PORT, seed)) == canon(random_interleavings(REF, seed))


# ---------------------------------------------------------------------------
# the port only: torch tensors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64])
def test_poison_float_tensor_stays_a_tensor_on_its_device(dtype):
    t = torch.arange(6, dtype=dtype).reshape(2, 3)
    out = port_faults.poison({"logits": t, "tag": "x"})
    assert isinstance(out["logits"], torch.Tensor) and out["tag"] == "x"
    assert out["logits"].dtype == dtype and out["logits"].device == t.device
    assert out["logits"].shape == t.shape and bool(out["logits"].isnan().all())
    assert torch.equal(t, torch.arange(6, dtype=dtype).reshape(2, 3))   # a copy


def test_poison_integer_tensor_becomes_float32_nan_like_numpy():
    t = torch.arange(4, dtype=torch.int64)
    out = port_faults.poison(t)
    ref = ref_faults.poison(t.numpy())
    assert out.dtype == torch.float32 and out.shape == t.shape
    assert canon(out) == canon(ref)
