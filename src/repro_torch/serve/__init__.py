"""Serving: the engine core and its runners (`runners.SNNRunner` over the
hybrid pipeline, `runners.LMRunner` over the decoder LM), adaptive
precision (`precision.PrecisionRunner`: fp32 and int4 variants behind one
engine), and the fleet: a fault-tolerant multi-replica router
(`router.Router`, with `faults` to inject wedges, raises, slow steps, NaN
and floods) and a versioned wire protocol (`wire`) for running replicas as
worker subprocesses (`worker`).

`api`, `scheduler`, `core`, `sampling`, `speculative`, `faults`, `router`,
`wire` and the controller side of `precision` are numpy-only copies of the
JAX package's control plane, kept so the port stands alone; `wire` frames
are byte for byte the reference's. The engine takes an optional
`repro_torch.obs.Observability` bundle (``obs=``).
"""
from .api import (EngineConfig, EngineStalled, ModelRunner, PAD_REQUEST_ID,
                  QueueFull, Request, RequestOptions, Result, RunnerSession,
                  SlotProgress, StepBudget, StepReport, SubmitSpec,
                  validate_options)
from .core import EngineCore, StepClock, all_finite
from .faults import (Fault, FaultError, FaultPlan, FaultyRunner, TickClock,
                     flood_queue, parse_fleet_plan)
from .precision import (PrecisionController, PrecisionDecision,
                        PrecisionRunner, VariantRegistry, bind_controller,
                        make_lm_variants, make_snn_pricer, make_snn_variants)
from .router import (InProcTransport, Router, Transport, TransportError,
                     make_router, make_worker_fleet)
from .scheduler import (FIFOScheduler, Scheduler, SLOScheduler,
                        SparsityAwareScheduler, make_scheduler)
from .wire import PROTOCOL_VERSION, ProtocolError
from .worker import RunnerSpec, SubprocessTransport, WorkerDied, build_runner

__all__ = [
    "EngineConfig", "EngineCore", "EngineStalled", "FIFOScheduler", "Fault",
    "FaultError", "FaultPlan", "FaultyRunner", "InProcTransport",
    "ModelRunner", "PAD_REQUEST_ID", "PROTOCOL_VERSION",
    "PrecisionController", "PrecisionDecision", "PrecisionRunner",
    "ProtocolError", "QueueFull", "Request", "RequestOptions", "Result",
    "Router", "RunnerSession", "RunnerSpec", "SLOScheduler", "Scheduler",
    "SlotProgress", "SparsityAwareScheduler", "StepBudget", "StepClock",
    "StepReport", "SubmitSpec", "SubprocessTransport", "TickClock",
    "Transport", "TransportError", "VariantRegistry", "WorkerDied",
    "all_finite", "bind_controller", "build_runner", "flood_queue",
    "make_lm_variants", "make_router", "make_scheduler", "make_snn_pricer",
    "make_snn_variants", "make_worker_fleet", "parse_fleet_plan",
    "validate_options",
]
