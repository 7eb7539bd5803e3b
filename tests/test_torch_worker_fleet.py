"""The port's worker fleet: subprocess workers on the CPU (``device="cpu"``).

The cases of `tests/test_worker_fleet.py`, on the port's `serve.worker`:

* `serve_connection` over in-memory byte streams: the protocol exchange
  (pushes before the terminal reply, the heartbeat echoing the step seq)
  byte for byte the reference worker's on the same input, a clean EOF
  exit, a bad handshake refused with the reference's message;
* `SubprocessTransport` against real stub workers: a round trip,
  `QueueFull` and option rejection crossing the wire, a version-mismatch
  handshake refused, ``kill()`` surfacing as `WorkerDied`;
* the supervised router over worker fleets: a killed worker's in-flight
  requests replay on the survivor, bit-identical to an in-process
  `EngineCore` over ``build_runner(spec)`` for the stub, the LM and the
  spiking VGG9; and a cross-process telemetry merge.

And what the port adds: `RunnerSpec` serves on the card unless it asks for
the CPU, and a worker without one refuses the handshake; the reference's
``interpret`` spec is refused; importing the worker imports neither JAX
nor the JAX package.
"""
import dataclasses
import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro.serve.worker as ref_worker
import repro.serve.wire as ref_wire
from repro_torch.configs import vgg9_snn
from repro_torch.configs.base import ArchConfig
from repro_torch.serve.api import EngineConfig, QueueFull, SubmitSpec
from repro_torch.serve.core import EngineCore
from repro_torch.serve.router import make_worker_fleet
from repro_torch.serve.wire import (AckMsg, ErrorMsg, HeartbeatMsg, HelloMsg, PartialMsg,
                                    ProtocolError, ReadyMsg, ResultMsg, ShutdownMsg,
                                    StepMsg, SubmitMsg, read_frame, write_frame)
from repro_torch.serve.worker import (RunnerSpec, SubprocessTransport, WorkerDied,
                                      build_runner, lm_spec, serve_connection, snn_spec)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
STUB = RunnerSpec(kind="stub")
CONFIG = EngineConfig(slots=2, max_queue=4, max_idle_steps=50)


# ---------------------------------------------------------------------------
# serve_connection over in-memory streams
# ---------------------------------------------------------------------------

def _hello_and(messages, runner=None, config=CONFIG):
    """Framed input for a worker: a hello (by default the stub spec's wire
    form common to both packages) then ``messages``."""
    runner = {"kind": "stub"} if runner is None else runner
    inbuf = io.BytesIO()
    write_frame(inbuf, HelloMsg(runner=runner, config=dataclasses.asdict(config)))
    for msg in messages:
        write_frame(inbuf, msg)
    return inbuf.getvalue()


def _serve_bytes(serve, data):
    out = io.BytesIO()
    code = serve(io.BytesIO(data), out)
    return code, out.getvalue()


def _frames(data):
    stream, frames = io.BytesIO(data), []
    while (frame := read_frame(stream)) is not None:
        frames.append(frame)
    return frames


def test_protocol_exchange_shape_byte_identical_to_reference():
    data = _hello_and([SubmitMsg(payload={"steps": 2}), StepMsg(seq=1), StepMsg(seq=2),
                       ShutdownMsg()])
    code, out = _serve_bytes(serve_connection, data)
    ref_code, ref_out = _serve_bytes(ref_worker.serve_connection, data)
    assert code == ref_code == 0
    assert out == ref_out                  # the reference worker's frames, byte for byte
    ready, ack, *rest = _frames(out)
    assert isinstance(ready, ReadyMsg) and ready.workload == "stub"
    assert ack == AckMsg(ok=True, rid=0)
    assert rest[0] == PartialMsg(rid=0, items=(("tick", 1),))
    assert isinstance(rest[1], HeartbeatMsg) and rest[1].seq == 1 and rest[1].in_flight == 1
    assert rest[2] == PartialMsg(rid=0, items=(("tick", 2),))
    assert isinstance(rest[3], ResultMsg) and rest[3].outputs == ("done", 2)
    assert isinstance(rest[4], HeartbeatMsg) and rest[4].seq == 2 and rest[4].in_flight == 0
    assert rest[5] == AckMsg(ok=True)


def test_worker_eof_is_clean_exit():
    code, out = _serve_bytes(serve_connection, _hello_and([SubmitMsg(payload={"steps": 1})]))
    assert code == 0 and isinstance(_frames(out)[0], ReadyMsg)


def test_worker_rejects_bad_handshake_with_reference_message():
    inbuf = io.BytesIO()
    write_frame(inbuf, StepMsg(seq=1))     # step before hello
    code, out = _serve_bytes(serve_connection, inbuf.getvalue())
    ref_code, ref_out = _serve_bytes(ref_worker.serve_connection, inbuf.getvalue())
    assert code == ref_code == 2 and out == ref_out
    assert "expected hello" in _frames(out)[0].error


def test_runner_spec_defaults_to_the_card_and_refuses_the_reference_knob():
    spec = snn_spec(vgg9_snn.TINY)
    assert spec.device == "cuda" and lm_spec(ArchConfig(**_LM)).device == "cuda"
    assert RunnerSpec.from_wire(spec.to_wire()) == spec
    ref_spec = ref_worker.snn_spec(vgg9_snn.TINY).to_wire()     # carries 'interpret'
    with pytest.raises(ProtocolError, match=r"unknown RunnerSpec fields \['interpret'\]"):
        RunnerSpec.from_wire(ref_spec)


def test_card_spec_without_a_card_refuses_the_handshake():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        build_runner(snn_spec(vgg9_snn.TINY))
    code, out = _serve_bytes(serve_connection,
                             _hello_and([], runner=snn_spec(vgg9_snn.TINY).to_wire()))
    reply, = _frames(out)
    assert code == 2 and isinstance(reply, ErrorMsg)
    assert reply.error.startswith("worker build failed: RuntimeError(") and "cuda" in reply.error


# ---------------------------------------------------------------------------
# SubprocessTransport against real stub workers
# ---------------------------------------------------------------------------

def test_subprocess_stub_round_trip():
    t = SubprocessTransport(STUB, CONFIG)
    try:
        assert t.stats()["worker_pid"] == t.pid and t.pid > 0 and t.handshake_s > 0
        rid = t.submit_spec(SubmitSpec.make({"steps": 2}))
        assert t.in_flight() == 1
        t.step()
        assert t.poll(rid) is None
        t.step()
        res = t.poll(rid)
        assert res.outputs == ("done", 2) and res.status == "ok"
        assert t.poll_partial(rid) == [("tick", 1), ("tick", 2)]
        assert t.in_flight() == 0
        marker = t.progress_marker()
        assert len(marker) == 4 and marker[0] >= 1
        assert t.cost_finite() and t.failed_count() == 0
    finally:
        t.close()
    assert t.proc.returncode == 0


def test_queue_full_and_option_rejection_cross_the_wire():
    t = SubprocessTransport(STUB, EngineConfig(slots=1, max_queue=1))
    try:
        t.submit_spec(SubmitSpec.make({"steps": 5}))
        t.step()
        t.submit_spec(SubmitSpec.make({"steps": 5}))
        with pytest.raises(QueueFull):
            t.submit_spec(SubmitSpec.make({"steps": 5}))
        with pytest.raises(ValueError, match="unknown request option"):
            t.submit_spec(SubmitSpec(payload={"steps": 1}, options={"bogus": 1}))
    finally:
        t.close()


def test_handshake_version_mismatch_refused():
    with pytest.raises(ProtocolError, match="rejected handshake.*version") as exc:
        SubprocessTransport(STUB, CONFIG, _hello_version=999)
    assert f"v{ref_wire.PROTOCOL_VERSION}" in str(exc.value) and "v999" in str(exc.value)


def test_kill_surfaces_as_workerdied():
    t = SubprocessTransport(STUB, CONFIG, step_timeout_s=10.0)
    rid = t.submit_spec(SubmitSpec.make({"steps": 10}))
    t.step()
    t.kill()
    with pytest.raises(WorkerDied):
        t.step()
    assert t.cancel(rid) is False and t.poll(rid) is None
    assert t.stats()["worker_dead"] is not None
    with pytest.raises(WorkerDied):
        t.submit_spec(SubmitSpec.make({"steps": 1}))
    t.close()


# ---------------------------------------------------------------------------
# worker fleets: kill -> replay, bit-identical to the in-process engine
# ---------------------------------------------------------------------------

def _kill_and_replay(spec, payloads, config, steps_before_kill=1, **options):
    """In-process reference results, then a 2-worker fleet that loses
    worker 0 with requests in flight; returns (reference, fleet results,
    router)."""
    reference = EngineCore(build_runner(spec), config)
    ref_ids = [reference.submit(p, **options) for p in payloads]
    ref_results = reference.run_until_complete()
    router = make_worker_fleet(spec, 2, config, step_timeout_s=300.0)
    try:
        rids = [router.submit(p, **options) for p in payloads]
        for _ in range(steps_before_kill):
            router.step()
        victim = router.replicas[0].transport
        assert victim.in_flight() > 0      # killing a worker with work
        victim.kill()
        results = router.run_until_complete()
    finally:
        router.close()
    assert len(router.drain_log) == 1 and router.stats()["rerouted"] >= 1
    assert [r for r in router.replicas if r.state == "healthy"]
    return [ref_results[i] for i in ref_ids], [results[r] for r in rids], router


def test_stub_fleet_reroutes_after_kill():
    ref, res, _ = _kill_and_replay(STUB, [{"steps": 4}] * 6,
                                   EngineConfig(slots=2, max_queue=8, max_idle_steps=50))
    for got, want in zip(res, ref):
        assert got.status == "ok" and got.outputs == want.outputs == ("done", 4)


_LM = dict(name="t-fleet", family="dense", n_layers=1, d_model=32, n_heads=4, n_kv_heads=2,
           head_dim=8, d_ff=64, vocab=31, dtype="float32", remat="none", q_chunk=8,
           kv_chunk=8)


def test_lm_fleet_kill_replays_bit_identical():
    """The reference's acceptance property on the port: kill a worker
    mid-stream and every request completes, each stream equal to the
    in-process run of the same `RunnerSpec`."""
    spec = lm_spec(ArchConfig(**_LM), seed=0, max_seq=16, device="cpu")
    prompts = [[1, 2, 3], [7, 5, 3, 9], [11, 4], [8, 8, 8]]
    ref, res, _ = _kill_and_replay(spec, prompts, EngineConfig(slots=2, max_queue=8,
                                                               max_idle_steps=50),
                                   steps_before_kill=2, max_new_tokens=4)
    for got, want, prompt in zip(res, ref, prompts):
        assert got.status == "ok" and list(got.outputs) == list(want.outputs), prompt


def test_snn_fleet_kill_replays_bit_identical():
    """TINY spiking VGG9 in 2 workers: worker 0 dies with a request in
    flight; every result (logits and per-request stats) equals the
    in-process engine's over ``build_runner(spec)`` bit for bit."""
    spec = snn_spec(vgg9_snn.TINY, seed=0, device="cpu")
    rng = np.random.default_rng(3)
    imgs = [rng.random((16, 16, 3)).astype(np.float32) * np.float32(0.02 if i % 2 else 1.0)
            for i in range(6)]
    ref, res, router = _kill_and_replay(spec, imgs, EngineConfig(slots=2, max_queue=8,
                                                                 max_idle_steps=50))
    assert router.drain_log[0][1:3] == (0, "wedged")
    for got, want in zip(res, ref):
        assert got.status == want.status == "ok"
        assert got.outputs.dtype == want.outputs.dtype
        assert np.array_equal(got.outputs, want.outputs)
        for key in ("out_spikes", "in_spikes", "spike_total", "skip_rate", "ts_occupancy",
                    "energy_j", "precision"):
            assert got.stats[key] == want.stats[key], key


def test_worker_fleet_merges_cross_process_telemetry():
    fleet = make_worker_fleet(STUB, 2, EngineConfig(slots=2, max_queue=8, max_idle_steps=50),
                              obs=True)
    try:
        rids = [fleet.submit({"steps": 2}) for _ in range(4)]
        results = fleet.run_until_complete()
        tel = fleet.telemetry()
    finally:
        fleet.close()
    assert all(results[r].status == "ok" for r in rids)
    spans = tel["trace"]
    replicas = {str(s["replica"]) for s in spans}
    assert "router" in replicas and len(replicas) >= 3
    ids = {s["span_id"] for s in spans}
    assert all(s["parent_id"] in ids for s in spans if s["parent_id"] is not None)
    roots = [s for s in spans if s["name"] == "request" and s["replica"] == "router"]
    assert len(roots) == 4 and all(r["status"] == "ok" for r in roots)
    agg = tel["metrics"]
    assert agg["router_submitted"]["value"] == 4
    assert agg["engine_steps"]["kind"] == "counter"
    assert agg["engine_retired_ok"]["value"] == 4


def test_worker_imports_neither_jax_nor_the_reference():
    code = ("import io, sys\n"
            "from repro_torch.serve import wire\n"
            "from repro_torch.serve.worker import RunnerSpec, build_runner, serve_connection\n"
            "build_runner(RunnerSpec(kind='stub'))\n"
            "inbuf = io.BytesIO()\n"
            "wire.write_frame(inbuf, wire.HelloMsg(runner={'kind': 'stub'}))\n"
            "wire.write_frame(inbuf, wire.ShutdownMsg())\n"
            "inbuf.seek(0)\n"
            "assert serve_connection(inbuf, io.BytesIO()) == 0\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'repro' or m.startswith('repro.'))\n"
            "assert not bad, bad\n"
            "print('clean')\n")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"
