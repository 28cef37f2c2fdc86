"""Serving: the mixed-step engine over paged KV lanes."""
from repro_torch.serve.config import EngineConfig
from repro_torch.serve.engine import Engine, StepResult
from repro_torch.serve.sampling import SamplingParams
from repro_torch.serve.scheduler import Request, Scheduler

__all__ = ["Engine", "EngineConfig", "Request", "SamplingParams",
           "Scheduler", "StepResult"]
