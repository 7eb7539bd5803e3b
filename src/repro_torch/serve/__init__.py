"""Serving: the engine core and its runners (`runners.SNNRunner` over the
hybrid pipeline, `runners.LMRunner` over the decoder LM), and adaptive
precision (`precision.PrecisionRunner`: fp32 and int4 variants behind one
engine).

`api`, `scheduler`, `core`, `sampling`, `speculative` and the controller
side of `precision` are numpy-only copies of the JAX package's control
plane, kept so the port stands alone. The engine takes an optional
`repro_torch.obs.Observability` bundle (``obs=``); the fleet (router,
workers, wire protocol, fault injection) is not ported yet.
"""
from .api import (EngineConfig, EngineStalled, ModelRunner, PAD_REQUEST_ID,
                  QueueFull, Request, RequestOptions, Result, RunnerSession,
                  SlotProgress, StepBudget, StepReport, SubmitSpec,
                  validate_options)
from .core import EngineCore, StepClock, all_finite
from .precision import (PrecisionController, PrecisionDecision,
                        PrecisionRunner, VariantRegistry, bind_controller,
                        make_lm_variants, make_snn_pricer, make_snn_variants)
from .scheduler import (FIFOScheduler, Scheduler, SLOScheduler,
                        SparsityAwareScheduler, make_scheduler)

__all__ = [
    "EngineConfig", "EngineCore", "EngineStalled", "FIFOScheduler",
    "ModelRunner", "PAD_REQUEST_ID", "PrecisionController",
    "PrecisionDecision", "PrecisionRunner", "QueueFull", "Request",
    "RequestOptions", "Result", "RunnerSession", "SLOScheduler",
    "Scheduler", "SlotProgress", "SparsityAwareScheduler", "StepBudget",
    "StepClock", "StepReport", "SubmitSpec", "VariantRegistry",
    "all_finite", "bind_controller", "make_lm_variants", "make_scheduler",
    "make_snn_pricer", "make_snn_variants", "validate_options",
]
