"""Serving: the engine core and the SNN runner over the hybrid pipeline.

`api`, `scheduler`, `core` and `sampling` are numpy-only copies of the JAX
package's control plane, kept so the port stands alone; the engine runs
with ``obs=None`` (the observability plane arrives with the fleet).
"""
from .api import (EngineConfig, EngineStalled, ModelRunner, PAD_REQUEST_ID,
                  QueueFull, Request, RequestOptions, Result, RunnerSession,
                  SlotProgress, StepBudget, StepReport, SubmitSpec,
                  validate_options)
from .core import EngineCore, StepClock, all_finite
from .scheduler import (FIFOScheduler, Scheduler, SLOScheduler,
                        SparsityAwareScheduler, make_scheduler)

__all__ = [
    "EngineConfig", "EngineCore", "EngineStalled", "FIFOScheduler",
    "ModelRunner", "PAD_REQUEST_ID", "QueueFull", "Request",
    "RequestOptions", "Result", "RunnerSession", "SLOScheduler",
    "Scheduler", "SlotProgress", "SparsityAwareScheduler", "StepBudget",
    "StepClock", "StepReport", "SubmitSpec", "all_finite", "make_scheduler",
    "validate_options",
]
