"""Serving (``repro.serve``): the slot engine with its mixed-step and
phase-serialized forms over paged or contiguous KV lanes, seeded sampling,
the chaos harness and audits, the asyncio front end and the multi-replica
dispatcher with its fleet prefix index.

``__all__`` is the reference's public surface; the internals stay
importable for tests and tools.
"""
from repro_torch.core.errors import (AuditError,  # noqa: F401
                                     UnsupportedConfigError)
from repro_torch.serve.config import EngineConfig
from repro_torch.serve.dispatch import Dispatcher
from repro_torch.serve.engine import Engine, StepResult  # noqa: F401
from repro_torch.serve.faults import FaultInjector, FaultPlan  # noqa: F401
from repro_torch.serve.frontend import Frontend, StreamHandle  # noqa: F401
from repro_torch.serve.kv_slots import (SlotKVCache,  # noqa: F401
                                        SlotStateTable)
from repro_torch.serve.pages import FleetPrefixIndex, PagePool  # noqa: F401
from repro_torch.serve.sampling import (SamplingParams,  # noqa: F401
                                        sample_tokens, sample_tokens_batch)
from repro_torch.serve.scheduler import (TERMINAL_STATUSES,  # noqa: F401
                                         Admission, DynamicBatcher, Request,
                                         Scheduler)

__all__ = [
    "Engine",
    "EngineConfig",
    "Request",
    "SamplingParams",
    "Frontend",
    "Dispatcher",
    "FaultPlan",
    "TERMINAL_STATUSES",
]
