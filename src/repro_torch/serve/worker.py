"""Subprocess worker harness: one `EngineCore` + runner per process.

This is the second deployment mode of the serving stack. The in-process
fleet (`serve.router.make_router`) shares one Python interpreter; a worker
fleet (`serve.router.make_worker_fleet`, `launch/serve.py --workers N`)
hosts each replica's engine in its own subprocess and drives it over the
versioned wire protocol (`serve.wire`) on a stdin/stdout pipe. Process
isolation is what the ROADMAP's fleet-scale item needs: a worker that
wedges, poisons its numerics, or dies outright (kill -9) cannot take the
router down with it — the pipe breaks, the transport raises
`router.TransportError`, and supervision drains + replays exactly as it
would for an in-process fault.

**Determinism across the process boundary.** A runner holds device state
that cannot (and should not) travel over a pipe, so workers are built from
a `RunnerSpec` — a wire-encodable recipe (workload kind, architecture
config, generator seed, device) from which parent and worker construct
*identical* runners: same seeded params, same greedy decode, therefore
bit-identical outputs whether a request runs in-process, in a worker, or
is replayed on a different worker after its first one was killed
mid-stream. That is the property the chaos benches assert.

**Protocol shape.** Every parent request gets zero or more push frames
(`PartialMsg`/`ResultMsg` for newly available outputs) followed by exactly
one terminal reply:

    HelloMsg    -> ReadyMsg            (handshake; version-checked)
    SubmitMsg   -> AckMsg              (rid on ok; QueueFull/ValueError text)
    StepMsg     -> pushes + HeartbeatMsg (progress marker + numerics probe)
    PollMsg     -> pushes + AckMsg
    CancelMsg   -> pushes + AckMsg
    ShutdownMsg -> AckMsg, then exit

Heartbeats piggyback on step replies — the router never pays an extra
round trip for supervision. Fatal worker-side errors emit one `ErrorMsg`
and exit; the parent surfaces them as a dead transport.

The worker's real stdout file descriptor is reserved for protocol frames;
fd 1 is re-pointed at stderr on startup so stray library prints cannot
corrupt the stream.

The port's worker hosts the port's runners (`repro_torch.serve.runners`)
on ``RunnerSpec.device``: the card unless the spec asks for the CPU, with
no fallback (a worker that cannot reach the card refuses the handshake
with its `ErrorMsg`). Its boot line re-points fd 1 before it imports
anything of torch, so neither a library print nor the kernels' nvcc build
can reach the protocol stream. Several workers on one card each hold their
own CUDA context and their own copy of the model.
"""
from __future__ import annotations

import dataclasses
import os
import select
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional, Set, Tuple

from . import wire
from .api import (PAD_REQUEST_ID, EngineConfig, QueueFull, Request, Result,
                  SlotProgress, StepBudget, StepReport, SubmitSpec)
from .core import EngineCore, all_finite
from .router import TransportError
from .wire import (AckMsg, CancelMsg, ErrorMsg, HeartbeatMsg, HelloMsg,
                   PartialMsg, PollMsg, ProtocolError, ReadyMsg, ResultMsg,
                   ShutdownMsg, StepMsg, SubmitMsg)


class WorkerDied(TransportError):
    """The worker subprocess is gone or unresponsive: closed pipe, fatal
    `ErrorMsg`, or a step that outlived the transport timeout. The router
    condemns the replica and replays its in-flight requests elsewhere."""


# ---------------------------------------------------------------------------
# RunnerSpec: a wire-encodable recipe for building a runner
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RunnerSpec:
    """Deterministic runner recipe both ends of the wire can execute.

    kind:        'lm' (transformer LM), 'snn' (spiking VGG9), or 'stub'
                 (a tiny model-free arithmetic runner for protocol tests).
    arch:        architecture-config fields (`configs.base.ArchConfig` for
                 'lm', `configs.vgg9_snn.VGG9Config` for 'snn') as a plain
                 mapping — `dataclasses.asdict` of the config.
    seed:        `torch.Generator` seed for parameter init. Same spec ->
                 same params -> bit-identical greedy outputs in every
                 process. The SNN draws its weights on the host
                 (`models.vgg9.init_vgg9`), so one seed gives the same
                 weights on every device; the LM draws them from a
                 generator on ``device`` (`models.transformer.init_params`),
                 so a "cuda" spec and a "cpu" spec with one seed give
                 different LM weights — parent and workers agree because
                 they build from the same spec.
    max_seq / quant_bits / speculate_k: `runners.lm.LMRunner` knobs.
    device:      where the runner serves: "cuda" (the card, the default)
                 or "cpu" (the plain PyTorch path). Asking for the card
                 without one raises; there is no CPU fallback.
    """
    kind: str
    arch: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    seed: int = 0
    max_seq: int = 64
    quant_bits: int = 0
    speculate_k: int = 0
    device: str = "cuda"

    def to_wire(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_wire(cls, data: Mapping[str, Any]) -> "RunnerSpec":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(data) - known)
        if unknown:
            raise ProtocolError(f"unknown RunnerSpec fields {unknown}")
        return cls(**{k: v for k, v in data.items()})


def lm_spec(cfg, *, seed: int = 0, max_seq: int = 64, quant_bits: int = 0,
            speculate_k: int = 0, device: str = "cuda") -> RunnerSpec:
    """Spec for an `LMRunner` over ``cfg`` (an `ArchConfig`)."""
    return RunnerSpec(kind="lm", arch=dataclasses.asdict(cfg), seed=seed,
                      max_seq=max_seq, quant_bits=quant_bits,
                      speculate_k=speculate_k, device=device)


def snn_spec(cfg, *, seed: int = 0, device: str = "cuda") -> RunnerSpec:
    """Spec for an `SNNRunner` over ``cfg`` (a `VGG9Config`)."""
    return RunnerSpec(kind="snn", arch=dataclasses.asdict(cfg), seed=seed,
                      device=device)


def build_runner(spec: RunnerSpec):
    """Construct the runner a spec describes (used by workers *and* by
    in-process reference runs asserting cross-process bit-identity)."""
    if spec.kind == "stub":
        return _StubRunner()
    if spec.kind == "lm":
        import torch

        from ..configs.base import ArchConfig
        from ..device import resolve_device
        from ..models import transformer as tf
        from .runners.lm import LMRunner
        cfg = ArchConfig(**dict(spec.arch))
        device = resolve_device(spec.device)
        params = tf.init_params(
            torch.Generator(device=device).manual_seed(spec.seed), cfg, device)
        return LMRunner(cfg, params, max_seq=spec.max_seq,
                        quant_bits=spec.quant_bits,
                        speculate_k=spec.speculate_k, device=device)
    if spec.kind == "snn":
        import torch

        from ..configs.vgg9_snn import VGG9Config
        from ..device import resolve_device
        from ..models.vgg9 import init_vgg9
        from .runners.snn import SNNRunner
        cfg = VGG9Config(**dict(spec.arch))
        device = resolve_device(spec.device)
        params = init_vgg9(torch.Generator().manual_seed(spec.seed), cfg, device)
        return SNNRunner(cfg, params, device=device)
    raise ProtocolError(f"unknown RunnerSpec.kind {spec.kind!r} "
                        f"(known: lm, snn, stub)")


# ---------------------------------------------------------------------------
# stub runner: deterministic, model-free — protocol tests without model cost
# ---------------------------------------------------------------------------

class _StubSession:
    def __init__(self, slots: int):
        self.rows: List[Optional[list]] = [None] * slots

    def admit(self, slot: int, request: Request) -> Optional[Result]:
        payload = request.payload if isinstance(request.payload, Mapping) else {}
        steps = int(payload.get("steps", 1))
        if steps <= 0:
            return Result(request.request_id, ("done", 0), {"steps": 0})
        self.rows[slot] = [request, steps, 0]
        return None

    def step(self, budget: StepBudget) -> StepReport:
        finished: Dict[int, Result] = {}
        progress: Dict[int, SlotProgress] = {}
        units = 0
        for slot, row in enumerate(self.rows):
            if row is None:
                continue
            request, total, done = row
            done += 1
            row[2] = done
            units += 1
            progress[slot] = SlotProgress(request.request_id, "stub", done,
                                          total, (("tick", done),))
            if done >= total:
                finished[slot] = Result(request.request_id, ("done", done),
                                        {"steps": done})
                self.rows[slot] = None
        return StepReport(finished, progress, {"units": units})

    def cancel(self, slot: int) -> Result:
        request, _total, done = self.rows[slot]
        self.rows[slot] = None
        return Result(request.request_id, ("done", done), {"steps": done},
                      "cancelled")


class _StubRunner:
    """Minimal deterministic `ModelRunner`: a request runs for
    ``payload['steps']`` session steps and finishes with outputs
    ``('done', steps)``. Keeps worker protocol tests free of model
    construction cost."""

    def bucket_key(self, request: Request):
        return "stub"

    def session_key(self, request: Request):
        return "stub"

    def filler(self, request: Request) -> Request:
        return Request(PAD_REQUEST_ID, {"steps": 1})

    def run(self, batch):
        return [Result(r.request_id, ("done", 1), {"steps": 1})
                for r in batch]

    def open_session(self, slots: int) -> _StubSession:
        return _StubSession(slots)


# ---------------------------------------------------------------------------
# worker side: the subprocess main loop
# ---------------------------------------------------------------------------

def _heartbeat(core: EngineCore, seq: int) -> HeartbeatMsg:
    report = core.last_report
    telemetry = core.obs.wire_telemetry() if core.obs is not None else None
    return HeartbeatMsg(seq=seq, marker=core._progress_marker(),
                        failed=core._failed,
                        cost_finite=report is None or all_finite(report.cost),
                        in_flight=core.in_flight(), pending=core.pending(),
                        stats=core.stats(), telemetry=telemetry)


def serve_connection(rfile, wfile) -> int:
    """Speak the worker side of the protocol until shutdown/EOF.

    Returns a process exit code. Factored off `main` so tests can run a
    worker over arbitrary byte streams (e.g. `io.BytesIO` pairs).
    """
    def send(msg) -> None:
        wire.write_frame(wfile, msg)

    try:
        hello = wire.read_frame(rfile)
    except ProtocolError as e:
        # version mismatch or garbage on the pipe: report and refuse
        send(ErrorMsg(error=f"handshake failed: {e}"))
        return 2
    if hello is None:
        return 0                        # parent vanished before handshake
    if not isinstance(hello, HelloMsg):
        send(ErrorMsg(error=f"expected hello, got {type(hello).__name__}"))
        return 2
    try:
        spec = RunnerSpec.from_wire(hello.runner)
        config = EngineConfig(**dict(hello.config))
        obs = None
        if hello.obs:
            from ..obs import Observability
            obs = Observability()
        core = EngineCore(build_runner(spec), config, obs=obs)
    except Exception as e:              # bad spec/config: refuse loudly
        send(ErrorMsg(error=f"worker build failed: {e!r}"))
        return 2
    send(ReadyMsg(pid=os.getpid(), workload=spec.kind))

    live: Set[int] = set()              # rids with no ResultMsg pushed yet

    def push_new(rids) -> None:
        """Push partials/results that became available for ``rids``."""
        for rid in sorted(rids):
            items = core.poll_partial(rid)
            if items:
                send(PartialMsg(rid=rid, items=tuple(items)))
        for rid in sorted(rids):
            res = core.poll(rid)
            if res is not None:
                send(ResultMsg.from_result(rid, res))
                live.discard(rid)

    while True:
        try:
            msg = wire.read_frame(rfile)
        except ProtocolError as e:
            send(ErrorMsg(error=f"bad frame: {e}"))
            return 2
        if msg is None:                 # parent closed the pipe: we're done
            return 0
        try:
            if isinstance(msg, SubmitMsg):
                try:
                    rid = core.submit_spec(msg.to_spec())
                except QueueFull as e:
                    send(AckMsg(ok=False, error=f"QueueFull: {e}"))
                except ValueError as e:
                    send(AckMsg(ok=False, error=f"ValueError: {e}"))
                else:
                    live.add(rid)
                    send(AckMsg(ok=True, rid=rid))
            elif isinstance(msg, StepMsg):
                if core.in_flight() > 0 or core.pending() > 0:
                    core.step()
                push_new(set(live))
                send(_heartbeat(core, msg.seq))
            elif isinstance(msg, PollMsg):
                was_live = msg.rid in live
                push_new({msg.rid})
                send(AckMsg(ok=was_live and msg.rid not in live, rid=msg.rid))
            elif isinstance(msg, CancelMsg):
                ok = core.cancel(msg.rid, status=msg.status)
                push_new({msg.rid})
                send(AckMsg(ok=ok, rid=msg.rid))
            elif isinstance(msg, ShutdownMsg):
                send(AckMsg(ok=True))
                return 0
            else:
                send(ErrorMsg(error=f"unexpected {type(msg).__name__}"))
                return 2
        except Exception as e:          # engine/runner fault: die loudly —
            # the parent condemns this replica and replays elsewhere,
            # exactly the in-process step-raised path
            send(ErrorMsg(error=f"worker fault: {e!r}"))
            return 3


def main(proto_fd: Optional[int] = None) -> int:
    """Serve the protocol on stdin and the real stdout.

    ``proto_fd`` is a duplicate of the real stdout that the caller made
    before re-pointing fd 1 at stderr (`SubprocessTransport`'s boot line
    does this before torch is imported); without it, ``main`` reserves the
    real stdout fd itself and re-points fd 1, so library prints and nvcc
    output cannot corrupt the stream."""
    proto_in = sys.stdin.buffer
    if proto_fd is None:
        proto_fd = os.dup(sys.stdout.fileno())
        os.dup2(sys.stderr.fileno(), sys.stdout.fileno())
    proto_out = os.fdopen(proto_fd, "wb")
    try:
        return serve_connection(proto_in, proto_out)
    except BrokenPipeError:
        return 0                        # parent died mid-reply


# ---------------------------------------------------------------------------
# parent side: SubprocessTransport
# ---------------------------------------------------------------------------

class SubprocessTransport:
    """`router.Transport` over a worker subprocess.

    Spawns a `repro_torch.serve.worker` process, performs the version-checked
    handshake, and maps the transport surface onto wire round trips:
    `step()` is one `StepMsg` -> pushes + `HeartbeatMsg` exchange (the
    heartbeat caches the progress marker / numerics-probe fields the
    router's between-step probes read), `submit_spec` is a `SubmitMsg` ->
    `AckMsg` exchange re-raising `QueueFull`/`ValueError` from the worker's
    submit boundary. Results and partials arrive as pushes during step and
    cancel exchanges and are served to `poll`/`poll_partial` from local
    caches — after a worker dies, whatever it already delivered remains
    salvageable, and `step`/`submit_spec` raise `WorkerDied` so the router
    condemns the replica.

    ``handshake_s`` is the wall time from spawn to the worker's `ReadyMsg`
    (its interpreter and torch import, CUDA context and model build).
    """

    def __init__(self, spec: RunnerSpec, config: EngineConfig = EngineConfig(),
                 *, step_timeout_s: float = 120.0,
                 handshake_timeout_s: float = 300.0,
                 python: str = sys.executable, obs: bool = False,
                 _hello_version: Optional[int] = None):
        self.spec = spec
        self.config = config
        self.clock = time.monotonic
        self.step_timeout_s = step_timeout_s
        self.pid: Optional[int] = None
        self._dead: Optional[str] = None
        self._seq = 0
        self._hb: Optional[HeartbeatMsg] = None
        self._results: Dict[int, Result] = {}
        self._partials: Dict[int, List[Any]] = {}
        self._live: Set[int] = set()    # submitted, no terminal result yet
        #: telemetry accumulated from heartbeats when the hello asked the
        #: worker to observe. Spans accumulate (each heartbeat ships the
        #: increment); metrics/frames are replaced by the newest snapshot —
        #: so the *last* heartbeat before a crash is the postmortem source.
        self.obs = obs
        self._spans: List[Dict[str, Any]] = []
        self._metrics: Dict[str, Any] = {}
        self._frames: List[Dict[str, Any]] = []
        self._dumps: List[Dict[str, Any]] = []
        env = dict(os.environ)
        src_root = str(Path(__file__).resolve().parents[2])
        env["PYTHONPATH"] = src_root + (
            os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
        # spawn via -c (not -m): the package __init__ already imports this
        # module, and runpy warns when re-executing an imported module. The
        # real stdout is kept for frames and fd 1 re-pointed at stderr
        # before anything imports torch.
        boot = ("import os, sys; proto = os.dup(1); os.dup2(2, 1); "
                "from repro_torch.serve.worker import main; "
                "sys.exit(main(proto))")
        t0 = time.monotonic()
        self.proc = subprocess.Popen(
            [python, "-c", boot],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, bufsize=0, env=env)
        try:
            self._send(HelloMsg(runner=spec.to_wire(),
                                config=dataclasses.asdict(config), obs=obs),
                       version=_hello_version)
            reply = self._recv(handshake_timeout_s)
        except TransportError:
            self._reap()
            raise
        except ProtocolError:
            self._mark_dead("handshake version mismatch")
            self._reap()
            raise
        if isinstance(reply, ErrorMsg):
            self._mark_dead(reply.error)
            self._reap()
            raise ProtocolError(f"worker rejected handshake: {reply.error}")
        if not isinstance(reply, ReadyMsg):
            self._mark_dead(f"unexpected handshake reply {type(reply).__name__}")
            self._reap()
            raise ProtocolError(self._dead)
        self.pid = reply.pid
        self.handshake_s = time.monotonic() - t0

    # -- low-level I/O -------------------------------------------------------

    def _send(self, msg, *, version: Optional[int] = None) -> None:
        try:
            wire.write_frame(self.proc.stdin, msg, version=version)
        except (BrokenPipeError, OSError) as e:
            self._mark_dead(f"pipe to worker broke: {e}")
            raise WorkerDied(self._dead) from e

    def _read_exact(self, n: int, timeout: float) -> bytes:
        deadline = time.monotonic() + timeout
        fd = self.proc.stdout.fileno()
        buf = b""
        while len(buf) < n:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                self._mark_dead(
                    f"worker pid {self.pid} unresponsive for {timeout:.0f}s")
                raise WorkerDied(self._dead)
            ready, _, _ = select.select([fd], [], [], min(remaining, 1.0))
            if not ready:
                continue
            chunk = os.read(fd, n - len(buf))
            if not chunk:
                code = self.proc.poll()
                self._mark_dead(f"worker pid {self.pid} closed its pipe "
                                f"(exit code {code})")
                raise WorkerDied(self._dead)
            buf += chunk
        return buf

    def _recv(self, timeout: float):
        header = self._read_exact(wire._HEADER.size, timeout)
        (length,) = wire._HEADER.unpack(header)
        if length > wire.MAX_FRAME_BYTES:
            self._mark_dead(f"oversized frame ({length} bytes) from worker")
            raise WorkerDied(self._dead)
        return wire.unpack(self._read_exact(length, timeout))

    def _rpc(self, msg, timeout: Optional[float] = None):
        """One request -> (pushes cached) -> terminal reply."""
        if self._dead:
            raise WorkerDied(self._dead)
        self._send(msg)
        while True:
            reply = self._recv(timeout if timeout is not None
                               else self.step_timeout_s)
            if isinstance(reply, PartialMsg):
                self._partials.setdefault(reply.rid, []).extend(reply.items)
            elif isinstance(reply, ResultMsg):
                self._results[reply.rid] = reply.to_result()
                self._live.discard(reply.rid)
            elif isinstance(reply, ErrorMsg):
                self._mark_dead(f"worker reported: {reply.error}")
                raise WorkerDied(self._dead)
            else:
                return reply

    def _mark_dead(self, reason: str) -> None:
        if self._dead is None:
            self._dead = reason

    def _reap(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
        try:
            self.proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            pass
        for stream in (self.proc.stdin, self.proc.stdout):
            try:
                stream.close()
            except OSError:
                pass

    # -- Transport surface ---------------------------------------------------

    def submit_spec(self, spec: SubmitSpec) -> int:
        reply = self._rpc(SubmitMsg.from_spec(spec))
        if not isinstance(reply, AckMsg):
            self._mark_dead(f"bad submit reply {type(reply).__name__}")
            raise WorkerDied(self._dead)
        if reply.ok:
            self._live.add(reply.rid)
            return reply.rid
        if reply.error.startswith("QueueFull"):
            raise QueueFull(reply.error)
        raise ValueError(reply.error)

    def step(self) -> None:
        self._seq += 1
        reply = self._rpc(StepMsg(seq=self._seq))
        if not isinstance(reply, HeartbeatMsg):
            self._mark_dead(f"bad step reply {type(reply).__name__}")
            raise WorkerDied(self._dead)
        self._hb = reply
        telemetry = reply.telemetry
        if telemetry:
            self._spans.extend(telemetry.get("spans") or ())
            if telemetry.get("metrics") is not None:
                self._metrics = telemetry["metrics"]
            if telemetry.get("frames") is not None:
                self._frames = list(telemetry["frames"])
            self._dumps.extend(telemetry.get("dumps") or ())

    def poll(self, request_id: int) -> Optional[Result]:
        return self._results.pop(request_id, None)

    def poll_partial(self, request_id: int) -> List[Any]:
        return self._partials.pop(request_id, [])

    def cancel(self, request_id: int, *, status: str = "cancelled") -> bool:
        if self._dead:
            return False            # nothing to reclaim from a dead worker
        try:
            reply = self._rpc(CancelMsg(rid=request_id, status=status))
        except TransportError:
            return False
        return isinstance(reply, AckMsg) and reply.ok

    def progress_marker(self) -> Tuple[int, int, int, int]:
        return tuple(self._hb.marker) if self._hb else (0, 0, 0, 0)

    def failed_count(self) -> int:
        return self._hb.failed if self._hb else 0

    def cost_finite(self) -> bool:
        return self._hb.cost_finite if self._hb else True

    def in_flight(self) -> int:
        # local liveness, not the stale heartbeat: the router must see a
        # freshly submitted request as work even before the first step
        return len(self._live)

    def pending(self) -> int:
        return self._hb.pending if self._hb else 0

    def stats(self) -> Dict[str, Any]:
        stats = dict(self._hb.stats) if self._hb else {}
        stats["worker_pid"] = self.pid
        stats["worker_dead"] = self._dead
        return stats

    def max_idle_steps(self) -> int:
        return self.config.max_idle_steps

    # -- observability surface (probed by the router via getattr) ------------

    def telemetry(self) -> Dict[str, Any]:
        """Everything this transport has learned from worker heartbeats:
        closed spans (accumulated), the latest metrics snapshot, the latest
        recorder frame tail, and every recorder dump. Spans still open in
        the worker at death are lost — the frame tail is the cushion."""
        return {"spans": list(self._spans), "metrics": dict(self._metrics),
                "frames": list(self._frames), "dumps": list(self._dumps)}

    def recorder_dump(self, reason: str) -> Optional[Dict[str, Any]]:
        """Parent-side postmortem from the last heartbeat's frame tail —
        the `WorkerDied` path, where the worker can no longer dump for
        itself. None when the hello never asked the worker to observe."""
        if not self.obs:
            return None
        dump = {"reason": reason,
                "step": self._frames[-1]["step"] if self._frames else None,
                "frames": list(self._frames), "notes": [],
                "worker_pid": self.pid}
        self._dumps.append(dump)
        return dump

    def kill(self) -> None:
        """SIGKILL the worker (chaos harness). The transport does *not*
        mark itself dead — discovery happens through the protocol, the way
        a real crash would surface."""
        self.proc.kill()

    def close(self) -> None:
        if self._dead is None and self.proc.poll() is None:
            try:
                self._rpc(ShutdownMsg(), timeout=10.0)
                self.proc.wait(timeout=10)
            except (TransportError, ProtocolError,
                    subprocess.TimeoutExpired):
                pass
        self._reap()


if __name__ == "__main__":
    sys.exit(main())
