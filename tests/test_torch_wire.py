"""The port's wire protocol against the JAX package's, byte for byte.

For the reference test's random value trees (`tests/test_wire.py`), its
request/result round trips and every message type, the frame the port packs
equals the frame the reference packs for the same message, and each package
unpacks the other's frames to equal values: NaN payload bit patterns, 0-d
arrays, tuples, bytes and non-string keys included. A version mismatch is
refused in both directions with both versions named. What only the port
has: a torch tensor encodes as its numpy array does, and a dtype numpy
cannot hold (bfloat16) is refused with `ProtocolError`.
"""
import dataclasses
import io
import math
import random

import numpy as np
import pytest
import torch

import repro.serve.api as ref_api
import repro.serve.wire as ref
import repro_torch.serve.api as port_api
import repro_torch.serve.wire as port
from test_wire import deep_equal, random_value


def _fields(msg):
    return {f.name: getattr(msg, f.name) for f in dataclasses.fields(msg)}


def _as(pkg, msg):
    """The same message as the other package's class."""
    return pkg.MESSAGE_TYPES[msg.TYPE](**_fields(msg))


def _same_message(a, b):
    return a.TYPE == b.TYPE and deep_equal(_fields(a), _fields(b))


def _both_ways(msg):
    """Pack ``msg`` in each package; assert the frames are equal and that
    each package unpacks the other's frame to the message."""
    frame = port.pack(_as(port, msg))
    assert frame == ref.pack(_as(ref, msg))
    from_port, from_ref = ref.unpack(frame), port.unpack(frame)
    assert type(from_port) is ref.MESSAGE_TYPES[msg.TYPE]
    assert type(from_ref) is port.MESSAGE_TYPES[msg.TYPE]
    assert _same_message(from_port, msg) and _same_message(from_ref, msg)
    return from_ref


def test_protocol_constants_and_message_set_are_the_reference_s():
    assert port.PROTOCOL_VERSION == ref.PROTOCOL_VERSION
    assert port.MAX_FRAME_BYTES == ref.MAX_FRAME_BYTES
    assert port._TAGS == ref._TAGS
    assert list(port.MESSAGE_TYPES) == list(ref.MESSAGE_TYPES)
    for name, cls in ref.MESSAGE_TYPES.items():
        ours = port.MESSAGE_TYPES[name]
        assert ours.__name__ == cls.__name__
        assert [(f.name, f.default) for f in dataclasses.fields(ours)] == \
            [(f.name, f.default) for f in dataclasses.fields(cls)]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_random_trees_pack_byte_identical_and_cross_unpack(seed):
    rng = random.Random(seed)
    for _ in range(60):
        value = random_value(rng)
        back = _both_ways(ref.ResultMsg(rid=7, outputs=value, stats={"x": 1}))
        assert deep_equal(back.outputs, value), value


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_request_and_result_wire_forms_equal_reference(seed):
    rng = random.Random(1000 + seed)
    fields = dict(request_id=rng.randrange(100), payload=random_value(rng),
                  options={"max_new_tokens": rng.randrange(8), "seed": seed},
                  deadline_s=rng.choice([None, 12.5]), priority=rng.randrange(-2, 3),
                  arrival_s=rng.random())
    wire_req = port.request_to_wire(port_api.Request(**fields))
    assert ref.json.dumps(wire_req) == ref.json.dumps(
        ref.request_to_wire(ref_api.Request(**fields)))
    for back in (port.request_from_wire(wire_req), ref.request_from_wire(wire_req)):
        assert back.request_id == fields["request_id"]
        assert deep_equal(back.payload, fields["payload"])
        assert dict(back.options) == fields["options"]
        assert back.deadline_s == fields["deadline_s"] and back.priority == fields["priority"]

    fields = dict(request_id=rng.randrange(100), outputs=random_value(rng),
                  stats={"cost": {"flops": math.nan, "bytes": math.inf},
                         "probe": np.float32(3.25), "tree": random_value(rng)},
                  status=rng.choice(["ok", "failed", "expired"]))
    wire_res = port.result_to_wire(port_api.Result(**fields))
    assert ref.json.dumps(wire_res) == ref.json.dumps(
        ref.result_to_wire(ref_api.Result(**fields)))
    back = ref.result_from_wire(wire_res)
    assert back.status == fields["status"] and deep_equal(back.outputs, fields["outputs"])
    assert math.isnan(back.stats["cost"]["flops"]) and back.stats["cost"]["bytes"] == math.inf


def test_every_message_type_both_ways():
    for cls in ref.MESSAGE_TYPES.values():
        _both_ways(cls())
    for msg in (ref.SubmitMsg(payload=[1, 2], deadline_s=3.0, priority=-1,
                              options={"max_new_tokens": 4}),
                ref.HeartbeatMsg(seq=9, marker=(1, 2, 3, 4), failed=1, cost_finite=False,
                                 in_flight=2, pending=1, stats={"ok": 3, "lat": [0.5, None]},
                                 telemetry={"spans": [], "metrics": {"m": {"value": 1.0}}}),
                ref.PartialMsg(rid=5, items=(("tok", 7), ("tok", 8))),
                ref.AckMsg(ok=False, rid=3, error="QueueFull: full"),
                ref.HelloMsg(runner={"kind": "snn", "arch": {"conv_channels": (64, 128)},
                                     "seed": 0}, config={"slots": 8}, obs=True),
                ref.ErrorMsg(error="worker build failed: RuntimeError('cuda')"),
                ref.ResultMsg(rid=2, outputs=np.linspace(0, 1, 10, dtype=np.float32),
                              stats={"skip_rate": {"conv1": 0.25}}, status="failed")):
        back = _both_ways(msg)
    hb = port.unpack(ref.pack(ref.HeartbeatMsg(marker=(1, 2, 3, 4))))
    assert hb.marker == (1, 2, 3, 4) and isinstance(hb.marker, tuple)
    assert isinstance(back, port.ResultMsg)


def test_nan_payload_bit_patterns_and_0d_arrays_cross_the_packages():
    raw = np.array([0x7FC00001, 0x7FC00002, 0xFFC00003], dtype=np.uint32).view(np.float32)
    for value in (raw, np.float32(3.25), np.array(5, np.int64), np.array(-0.0), np.bool_(1)):
        back = _both_ways(ref.ResultMsg(rid=1, outputs=value))
        assert isinstance(back.outputs, np.ndarray)
        assert back.outputs.shape == np.shape(value)
        assert back.outputs.tobytes() == np.asarray(value).tobytes()


def test_version_mismatch_refused_both_ways_naming_both_versions():
    bad = port.PROTOCOL_VERSION + 41
    for packer, unpacker in ((ref, port), (port, ref)):
        with pytest.raises(unpacker.ProtocolError) as exc:
            unpacker.unpack(packer.pack(packer.StepMsg(seq=1), version=bad))
        assert f"v{bad}" in str(exc.value) and f"v{port.PROTOCOL_VERSION}" in str(exc.value)
    with pytest.raises(port.ProtocolError) as ours:
        port.unpack(port.pack(port.StepMsg(seq=1), version=bad))
    with pytest.raises(ref.ProtocolError) as theirs:
        ref.unpack(ref.pack(ref.StepMsg(seq=1), version=bad))
    assert str(ours.value) == str(theirs.value)


def test_refusals_carry_the_reference_messages():
    cases = [
        lambda w: w.unpack(w.pack(w.PollMsg(rid=1)).replace(b'"poll"', b'"gossip"')),
        lambda w: w.unpack(w.pack(w.PollMsg(rid=1)).replace(b'"rid"', b'"rip"')),
        lambda w: w.unpack(b"\xff not json"),
        lambda w: w.unpack(b'{"v": 2}'),
        lambda w: w.decode_value({"__hologram__": [1, 2]}),
        lambda w: w.encode_value(object()),
        lambda w: w.pack(w.Request(0, [])) if hasattr(w, "Request") else w.pack(object()),
    ]
    for case in cases:
        with pytest.raises(port.ProtocolError) as ours:
            case(port)
        with pytest.raises(ref.ProtocolError) as theirs:
            case(ref)
        assert str(ours.value) == str(theirs.value)


def test_framing_byte_identical_and_read_across():
    bufs = []
    for w in (port, ref):
        buf = io.BytesIO()
        w.write_frame(buf, w.HelloMsg(runner={"kind": "stub"}))
        w.write_frame(buf, w.StepMsg(seq=2))
        bufs.append(buf.getvalue())
    assert bufs[0] == bufs[1]
    stream = io.BytesIO(bufs[1])
    assert isinstance(port.read_frame(stream), port.HelloMsg)
    assert port.read_frame(stream) == port.StepMsg(seq=2)
    assert port.read_frame(stream) is None
    cut = io.BytesIO(bufs[1][:-3])
    port.read_frame(cut)
    with pytest.raises(port.ProtocolError, match="truncated"):
        port.read_frame(cut)


def test_submit_msg_carries_the_port_submit_spec():
    spec = port_api.SubmitSpec.make([1, 2], deadline_s=3, priority=2,
                                    options={"top_k": 1}, temperature=0.5)
    frame = port.pack(port.SubmitMsg.from_spec(spec))
    assert frame == ref.pack(ref.SubmitMsg.from_spec(ref_api.SubmitSpec.make(
        [1, 2], deadline_s=3, priority=2, options={"top_k": 1}, temperature=0.5)))
    assert port.unpack(frame).to_spec() == spec


# ---------------------------------------------------------------------------
# the port only: torch tensors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("make", [
    lambda: torch.linspace(-1, 1, 12, dtype=torch.float32).reshape(3, 4),
    lambda: torch.arange(-5, 7, dtype=torch.int64).reshape(4, 3).t(),      # non-contiguous
    lambda: torch.tensor(2.5, dtype=torch.float64),                         # 0-d
    lambda: torch.tensor([True, False]),
    lambda: torch.full((2,), float("nan")).requires_grad_(True),
], ids=["float32", "int64-transposed", "float64-0d", "bool", "nan-requires-grad"])
def test_cpu_tensor_encodes_like_its_numpy_array(make):
    t = make()
    host = t.detach().numpy()
    assert port.encode_value(t) == ref.encode_value(host) == port.encode_value(host)
    assert port.pack(port.ResultMsg(outputs={"x": t})) == ref.pack(
        ref.ResultMsg(outputs={"x": host}))
    back = ref.unpack(port.pack(port.ResultMsg(outputs=t))).outputs
    assert back.dtype == host.dtype and back.shape == host.shape
    assert back.tobytes() == np.ascontiguousarray(host).tobytes()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float8_e4m3fn])
def test_tensor_numpy_cannot_hold_is_refused_naming_its_dtype(dtype):
    t = torch.ones(3).to(dtype)
    with pytest.raises(port.ProtocolError, match=str(dtype).replace("torch.", "")):
        port.pack(port.ResultMsg(outputs=[t]))
