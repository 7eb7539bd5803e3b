"""Versioned wire protocol for the serving control plane.

The engine is message-shaped (`submit/poll/cancel/poll_partial`) and
the router's supervision transport-agnostic; this module makes the implicit
in-process call contract *explicit*: a frozen message schema plus a codec
that round-trips every value the control plane moves — `Request` payloads
(token lists, numpy images), `Result` outputs/stats (nested dicts, tuples,
NaN/Inf from the numerics probe), and streamed partials — bit-exactly.
`serve.worker` speaks this protocol over a pipe; `serve.router`'s
`SubprocessTransport` is the client side.

Design rules:

* **No pickle.** Frames are length-prefixed JSON with a small set of tagged
  value types. A worker is a subprocess we supervise, not a peer we trust
  with arbitrary code objects — and refusing pickle keeps the protocol
  implementable from any language.
* **Bit-exact round trips.** numpy arrays travel as
  ``{dtype, shape, base64(raw bytes)}`` so every payload and every stats
  tensor decodes to the same bits (NaN payload patterns included); floats
  ride JSON's repr round-trip (exact for float64); tuples are tagged so
  ``marker`` et al. come back as tuples, not lists. This is what lets the
  router assert replayed outputs bit-identical across process boundaries.
* **Versioned.** Every frame carries ``PROTOCOL_VERSION``; `unpack` refuses
  a mismatched peer with a `ProtocolError` naming both versions. The
  worker handshake (`HelloMsg` -> `ReadyMsg`) therefore fails fast and
  loudly instead of mis-decoding messages mid-flight.

Framing: ``!I`` big-endian length prefix + JSON body (``allow_nan=True`` —
NaN/Infinity literals are part of the contract; both ends are Python today
and the tagged-ndarray path covers them for any future non-Python peer).

The port speaks the JAX package's protocol unchanged: the same
`PROTOCOL_VERSION`, messages and framing, so a frame packed here is byte
for byte the reference's frame for the same message and either side
unpacks the other's. A torch tensor (on any device) travels as the numpy
array ``t.detach().cpu().numpy()`` gives; a dtype numpy cannot hold
(bfloat16, say) is refused with `ProtocolError` rather than widened.
"""
from __future__ import annotations

import base64
import dataclasses
import json
import struct
from typing import Any, ClassVar, Dict, Mapping, Optional, Tuple, Type

import numpy as np
import torch

from .api import Request, Result

#: bump on any incompatible change to the message set or the codec.
#: v2: `HelloMsg.obs` opt-in + `HeartbeatMsg.telemetry` (observability
#: increments piggybacking on the step reply). Both are default-valued —
#: same-build peers always agree, and the version stamp keeps a v1 peer
#: from half-decoding a v2 stream.
PROTOCOL_VERSION = 2

#: refuse frames larger than this (corrupted length prefix guard)
MAX_FRAME_BYTES = 1 << 30

_HEADER = struct.Struct("!I")

_TAG_ND = "__nd__"        # numpy array / scalar: [dtype.str, shape, b64 bytes]
_TAG_TUPLE = "__tuple__"  # tuple: [items...]
_TAG_BYTES = "__bytes__"  # bytes: b64 string
_TAG_MAP = "__map__"      # mapping with non-string (or tag-like) keys: [[k, v]...]
_TAGS = (_TAG_ND, _TAG_TUPLE, _TAG_BYTES, _TAG_MAP)


class ProtocolError(RuntimeError):
    """A frame violated the wire contract: version mismatch, unknown
    message type or value tag, truncated frame, or an unencodable value."""


# ---------------------------------------------------------------------------
# value codec
# ---------------------------------------------------------------------------

def encode_value(value: Any) -> Any:
    """Encode one Python value into the JSON-able tagged form.

    Supported: None, bool, int, float (NaN/Inf included), str, bytes,
    list, tuple, dict/Mapping (any encodable keys), numpy arrays and
    numpy scalars, and torch tensors whose dtype numpy holds (encoded as
    that numpy array). Anything else raises `ProtocolError` — the control
    plane refuses to guess at a serialization.
    """
    if value is None or isinstance(value, (bool, int, str)):
        return value
    if isinstance(value, float):
        return value
    if isinstance(value, np.ndarray):
        # ascontiguousarray promotes 0-d to (1,): take the shape first so
        # numpy scalars round-trip as true 0-d arrays
        raw = base64.b64encode(
            np.ascontiguousarray(value).tobytes()).decode("ascii")
        return {_TAG_ND: [value.dtype.str, list(value.shape), raw]}
    if isinstance(value, np.generic):
        # scalars keep their dtype via the 0-d array form
        return encode_value(np.asarray(value))
    if isinstance(value, torch.Tensor):
        # before the duck-typed branch (a tensor has __array__, dtype and
        # shape, but np.asarray raises on a CUDA tensor): one bit-exact
        # copy to the host
        try:
            host = value.detach().cpu().numpy()
        except TypeError as e:
            raise ProtocolError(
                f"cannot encode a torch tensor of dtype {value.dtype} on the "
                f"wire: numpy has no such dtype (cast it explicitly)") from e
        return encode_value(host)
    if (hasattr(value, "__array__") and hasattr(value, "dtype")
            and hasattr(value, "shape")):
        # duck-typed array (e.g. a jax device array): np.asarray is a
        # bit-exact device->host transfer, so payloads submitted as device
        # arrays cross the wire losslessly
        return encode_value(np.asarray(value))
    if isinstance(value, (bytes, bytearray)):
        return {_TAG_BYTES: base64.b64encode(bytes(value)).decode("ascii")}
    if isinstance(value, tuple):
        return {_TAG_TUPLE: [encode_value(v) for v in value]}
    if isinstance(value, list):
        return [encode_value(v) for v in value]
    if isinstance(value, Mapping):
        keys = list(value.keys())
        plain = all(isinstance(k, str) and not k.startswith("__") for k in keys)
        if plain:
            return {k: encode_value(v) for k, v in value.items()}
        # non-string or tag-like keys: escape into an explicit pair list
        return {_TAG_MAP: [[encode_value(k), encode_value(v)]
                           for k, v in value.items()]}
    raise ProtocolError(
        f"cannot encode {type(value).__name__!r} on the wire: the control "
        f"plane only moves JSON scalars, bytes, lists/tuples, mappings and "
        f"numpy arrays")


def decode_value(value: Any) -> Any:
    """Inverse of `encode_value`. Unknown tags raise `ProtocolError`."""
    if value is None or isinstance(value, (bool, int, float, str)):
        return value
    if isinstance(value, list):
        return [decode_value(v) for v in value]
    if isinstance(value, dict):
        if len(value) == 1:
            (key, body), = value.items()
            if key == _TAG_ND:
                dtype, shape, raw = body
                arr = np.frombuffer(base64.b64decode(raw), dtype=np.dtype(dtype))
                arr = arr.reshape([int(s) for s in shape]).copy()
                return arr
            if key == _TAG_TUPLE:
                return tuple(decode_value(v) for v in body)
            if key == _TAG_BYTES:
                return base64.b64decode(body)
            if key == _TAG_MAP:
                return {decode_value(k): decode_value(v) for k, v in body}
            if isinstance(key, str) and key.startswith("__"):
                raise ProtocolError(f"unknown wire value tag {key!r} "
                                    f"(peer newer than v{PROTOCOL_VERSION}?)")
        return {k: decode_value(v) for k, v in value.items()}
    raise ProtocolError(f"cannot decode wire value of type {type(value).__name__!r}")


# ---------------------------------------------------------------------------
# message schema
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class HelloMsg:
    """Parent -> worker handshake opener. ``runner`` is the wire form of a
    `serve.worker.RunnerSpec`; ``config`` the `api.EngineConfig` fields.
    The frame's version field *is* the version check — a mismatched worker
    never gets as far as reading these fields.

    obs: when True the worker attaches a `repro_torch.obs.Observability` bundle
    to its engine and ships telemetry increments on every heartbeat
    (v2, default off — the observability plane is strictly opt-in)."""
    TYPE: ClassVar[str] = "hello"
    runner: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    config: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    obs: bool = False


@dataclasses.dataclass(frozen=True)
class ReadyMsg:
    """Worker -> parent handshake close: the engine is built and serving."""
    TYPE: ClassVar[str] = "ready"
    pid: int = 0
    workload: str = ""


@dataclasses.dataclass(frozen=True)
class ErrorMsg:
    """Worker -> parent fatal report (bad handshake, unknown runner kind).
    The worker exits after sending one."""
    TYPE: ClassVar[str] = "error"
    error: str = ""


@dataclasses.dataclass(frozen=True)
class SubmitMsg:
    """Parent -> worker: admit one request. Fields are exactly the canonical
    `api.SubmitSpec` shape — the single submit surface `EngineCore.submit`
    and `Router.submit` both parse into."""
    TYPE: ClassVar[str] = "submit"
    payload: Any = None
    deadline_s: Optional[float] = None
    priority: int = 0
    options: Mapping[str, Any] = dataclasses.field(default_factory=dict)

    @classmethod
    def from_spec(cls, spec: "SubmitSpec") -> "SubmitMsg":
        return cls(payload=spec.payload, deadline_s=spec.deadline_s,
                   priority=spec.priority, options=dict(spec.options))

    def to_spec(self) -> "SubmitSpec":
        from .api import SubmitSpec
        return SubmitSpec.make(self.payload, deadline_s=self.deadline_s,
                               priority=self.priority,
                               options=dict(self.options))


@dataclasses.dataclass(frozen=True)
class AckMsg:
    """Worker -> parent terminal reply for submit/poll/cancel requests.
    ``rid`` is the worker-local request id on successful submit."""
    TYPE: ClassVar[str] = "ack"
    ok: bool = True
    rid: int = -1
    error: str = ""


@dataclasses.dataclass(frozen=True)
class PollMsg:
    """Parent -> worker: fetch the `Result` for ``rid`` if retired."""
    TYPE: ClassVar[str] = "poll"
    rid: int = -1


@dataclasses.dataclass(frozen=True)
class CancelMsg:
    """Parent -> worker: cancel ``rid`` (queued or resident)."""
    TYPE: ClassVar[str] = "cancel"
    rid: int = -1
    status: str = "cancelled"


@dataclasses.dataclass(frozen=True)
class StepMsg:
    """Parent -> worker: advance the engine one step. The worker replies
    with any newly available `PartialMsg`/`ResultMsg` pushes followed by
    exactly one `HeartbeatMsg` echoing ``seq``."""
    TYPE: ClassVar[str] = "step"
    seq: int = 0


@dataclasses.dataclass(frozen=True)
class ResultMsg:
    """Worker -> parent push: one retired request's `api.Result`."""
    TYPE: ClassVar[str] = "result"
    rid: int = -1
    outputs: Any = None
    stats: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    status: str = "ok"

    @classmethod
    def from_result(cls, rid: int, result: Result) -> "ResultMsg":
        return cls(rid=rid, outputs=result.outputs,
                   stats=dict(result.stats), status=result.status)

    def to_result(self) -> Result:
        return Result(request_id=self.rid, outputs=self.outputs,
                      stats=dict(self.stats), status=self.status)


@dataclasses.dataclass(frozen=True)
class PartialMsg:
    """Worker -> parent push: streamed partial outputs for ``rid`` — the
    same items `EngineCore.poll_partial` would have returned in-process."""
    TYPE: ClassVar[str] = "partial"
    rid: int = -1
    items: Tuple = ()


@dataclasses.dataclass(frozen=True)
class HeartbeatMsg:
    """Worker -> parent: terminal reply to every `StepMsg` — the engine
    vitals the router's supervision reads each step.

    marker:      `EngineCore._progress_marker()` — (retired, work_units,
                 decode_tokens, queue_len); an unchanged marker across
                 ``wedge_patience`` supervised steps condemns the replica.
    failed:      cumulative numerics-screen failures (`EngineCore._failed`);
                 a delta trips the router's NaN probe.
    cost_finite: whether the last step's reported cost was NaN/Inf-free —
                 the second half of the numerics probe.
    in_flight /  queue-depth signals the router's placement reads.
    pending:
    stats:       the full `EngineCore.stats()` mapping (fleet dashboards);
                 supervision only needs the scalar fields above.
    telemetry:   observability increment (v2, None unless `HelloMsg.obs`):
                 ``{spans, metrics, frames[, dumps]}`` from
                 `repro_torch.obs.Observability.wire_telemetry` — newly closed
                 trace spans, the current metrics snapshot, a recorder
                 frame tail (postmortem cushion if the worker dies before
                 its next heartbeat) and any fresh recorder dumps.
    """
    TYPE: ClassVar[str] = "heartbeat"
    seq: int = 0
    marker: Tuple = ()
    failed: int = 0
    cost_finite: bool = True
    in_flight: int = 0
    pending: int = 0
    stats: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    telemetry: Any = None


@dataclasses.dataclass(frozen=True)
class ShutdownMsg:
    """Parent -> worker: exit cleanly after the current message."""
    TYPE: ClassVar[str] = "shutdown"


MESSAGE_TYPES: Dict[str, Type] = {
    cls.TYPE: cls
    for cls in (HelloMsg, ReadyMsg, ErrorMsg, SubmitMsg, AckMsg, PollMsg,
                CancelMsg, StepMsg, ResultMsg, PartialMsg, HeartbeatMsg,
                ShutdownMsg)
}


# ---------------------------------------------------------------------------
# pack / unpack + framing
# ---------------------------------------------------------------------------

def pack(msg: Any, *, version: Optional[int] = None) -> bytes:
    """Serialize one message to a frame body. ``version`` overrides the
    stamped protocol version (tests use it to provoke the mismatch path)."""
    cls = type(msg)
    if getattr(cls, "TYPE", None) not in MESSAGE_TYPES:
        raise ProtocolError(f"not a wire message: {cls.__name__}")
    fields = {f.name: encode_value(getattr(msg, f.name))
              for f in dataclasses.fields(cls)}
    body = {"v": PROTOCOL_VERSION if version is None else int(version),
            "t": cls.TYPE, "f": fields}
    return json.dumps(body, allow_nan=True, separators=(",", ":")).encode("utf-8")


def unpack(data: bytes) -> Any:
    """Deserialize one frame body. Rejects version mismatches and unknown
    message types with `ProtocolError` — the handshake's failure mode."""
    try:
        body = json.loads(data.decode("utf-8"))
    except (ValueError, UnicodeDecodeError) as e:
        raise ProtocolError(f"undecodable wire frame: {e}") from e
    if not isinstance(body, dict) or not {"v", "t", "f"} <= set(body):
        raise ProtocolError("malformed wire frame: missing v/t/f envelope")
    version = body["v"]
    if version != PROTOCOL_VERSION:
        raise ProtocolError(
            f"protocol version mismatch: peer speaks v{version}, this "
            f"process speaks v{PROTOCOL_VERSION}; refusing to talk to a "
            f"mismatched peer (upgrade both ends to the same repro build)")
    cls = MESSAGE_TYPES.get(body["t"])
    if cls is None:
        raise ProtocolError(f"unknown wire message type {body['t']!r}")
    known = {f.name for f in dataclasses.fields(cls)}
    fields = body["f"]
    if not isinstance(fields, dict) or not set(fields) <= known:
        extra = sorted(set(fields) - known) if isinstance(fields, dict) else fields
        raise ProtocolError(f"unknown fields {extra} for {body['t']!r} frame")
    return cls(**{k: decode_value(v) for k, v in fields.items()})


def write_frame(stream, msg: Any, *, version: Optional[int] = None) -> None:
    """Write one length-prefixed frame and flush."""
    data = pack(msg, version=version)
    stream.write(_HEADER.pack(len(data)))
    stream.write(data)
    stream.flush()


def _read_exact(stream, n: int) -> Optional[bytes]:
    """Read exactly n bytes; None on clean EOF at a frame boundary."""
    chunks = []
    got = 0
    while got < n:
        chunk = stream.read(n - got)
        if not chunk:
            if got == 0:
                return None
            raise ProtocolError(
                f"truncated wire frame: peer closed mid-frame "
                f"({got}/{n} bytes)")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def read_frame(stream) -> Optional[Any]:
    """Read one frame; None on clean EOF (peer closed between frames)."""
    header = _read_exact(stream, _HEADER.size)
    if header is None:
        return None
    (length,) = _HEADER.unpack(header)
    if length > MAX_FRAME_BYTES:
        raise ProtocolError(f"wire frame length {length} exceeds "
                            f"{MAX_FRAME_BYTES} (corrupted stream?)")
    data = _read_exact(stream, length)
    if data is None:
        raise ProtocolError("truncated wire frame: peer closed after header")
    return unpack(data)


# ---------------------------------------------------------------------------
# Request / Result round-trip helpers
# ---------------------------------------------------------------------------

def request_to_wire(request: Request) -> Mapping[str, Any]:
    """Full frozen `Request` -> wire mapping (codec tests + drain logs).
    The live control plane moves `SubmitMsg` instead — workers stamp their
    own request ids and arrival clocks."""
    return {
        "request_id": request.request_id,
        "payload": encode_value(request.payload),
        "options": encode_value(dict(request.options)),
        "deadline_s": request.deadline_s,
        "priority": request.priority,
        "arrival_s": request.arrival_s,
    }


def request_from_wire(data: Mapping[str, Any]) -> Request:
    return Request(request_id=int(data["request_id"]),
                   payload=decode_value(data["payload"]),
                   options=decode_value(data["options"]),
                   deadline_s=data["deadline_s"],
                   priority=int(data["priority"]),
                   arrival_s=float(data["arrival_s"]))


def result_to_wire(result: Result) -> Mapping[str, Any]:
    return {
        "request_id": result.request_id,
        "outputs": encode_value(result.outputs),
        "stats": encode_value(dict(result.stats)),
        "status": result.status,
    }


def result_from_wire(data: Mapping[str, Any]) -> Result:
    return Result(request_id=int(data["request_id"]),
                  outputs=decode_value(data["outputs"]),
                  stats=decode_value(data["stats"]),
                  status=str(data["status"]))
