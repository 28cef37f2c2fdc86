"""Loading the per-metric readers by name, and what they read.

A reader is a file ``bench/metrics/<name>.py`` (per-layer) or
``bench/endtoend/<name>.py`` (end to end) defining ``LAYER``, ``MOVES``
(per-layer), ``UNIT``, ``SOURCE`` and ``read(run) -> float | None``; a
reader that finds nothing to read returns None and the metric is left out
of the run's line. ``run`` is a :class:`Run`.
"""
from __future__ import annotations

import dataclasses
import importlib.util
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from bench.lib import arch, counts
from bench.lib.drive import StepRec, Window
from bench.lib.trace import matching
from bench.lib.traffic import Mix

__all__ = ["Run", "load_reader", "window_steps", "traced_steps"]

_ROOT = Path(__file__).resolve().parents[1]


@dataclasses.dataclass
class Run:
    workload: str
    spec: object                   # the configuration's (bench/lib/arch.py)
    mix: Mix
    window: Window
    setup_s: float
    trace: Optional[Dict] = None   # trace.reduce's result, traced runs


def window_steps(run: Run, kind: Optional[str] = None) -> List[StepRec]:
    return [s for s in run.window.steps if s.phase == "window"
            and (kind is None or s.kind == kind)]


def traced_steps(run: Run, kind: Optional[str] = None) -> List[StepRec]:
    return [s for s in window_steps(run, kind) if s.traced]


def step_work(run: Run, s: StepRec) -> Dict[str, float]:
    """The step's useful work, as the spec's architecture module counts
    it."""
    return arch.module_of(run.spec).step_work(run.spec, s.kind, s.lengths,
                                               s.n_new)


def roofline(run: Run, kind: Optional[str], part: str,
             patterns) -> Optional[float]:
    """Percent of the least time the traced steps' ``part`` (``attn`` or
    ``linear``) work could take, over the device time of the kernels whose
    names hold ``patterns``."""
    if run.trace is None:
        return None
    dev = matching(run.trace["kernels"], patterns)
    bound = 0.0
    for s in traced_steps(run, kind):
        if part == "attn":
            w = step_work(run, s)
            bound += counts.bound_s(w["attn_flops"], w["attn_bytes"])
        else:
            m = int(s.n_new.sum())
            bound += run.spec.layers * sum(
                counts.bound_s(counts.linear_flops(lin, m),
                               counts.linear_bytes(lin, run.spec, m))
                for lin in run.spec.linears())
    if dev <= 0 or bound <= 0:
        return None
    return 100.0 * bound / dev


def mean(xs) -> Optional[float]:
    xs = list(xs)
    return float(np.mean(xs)) if xs else None


def load_reader(kind: str, name: str):
    """The module of ``bench/<kind>/<name>.py``."""
    path = _ROOT / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
