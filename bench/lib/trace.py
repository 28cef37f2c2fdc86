"""The traced run's device timeline: ``torch.profiler`` recording the
device's activity alone (kernels, copies, sets) over the last
:data:`TRACE_S` seconds of the window (the whole window when it is
shorter), started and stopped at step boundaries.

Reduction (the method of the program's ``launch/profile_serve.py``,
copied): device busy time is the union of kernel intervals over the
traced steps' span; an idle gap is labelled by the innermost host range of
the harness's step records that holds it (``mixed`` or ``decode``: inside
the engine's device call; ``engine_host``: inside ``Engine.step`` but
outside it, i.e. admission, page growth and retire; ``harness``: between
steps). Host ranges are on the wall clock, which the profiler's timeline
uses too; recording no host activity keeps the profiler off the host's
path, so traced steps take about the time untraced ones do.
"""
from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Tuple

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

__all__ = ["TRACE_S", "Tracer", "union", "matching", "reduce"]

TRACE_S = 8.0

_HOST = ("mixed", "decode", "engine_host")


def union(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def matching(kernels, patterns) -> float:
    """Seconds of the kernels whose lower-cased name holds any pattern."""
    return sum(b - a for n, a, b in kernels
               if any(p in n.lower() for p in patterns))


def _events(prof):
    """(name, is_device, start_s, end_s) of every event, from the kineto
    results: their times are on the wall clock, as the host ranges are."""
    out = []
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns() * 1e-9
        out.append((e.name(), e.device_type() == DeviceType.CUDA, s,
                    s + e.duration_ns() * 1e-9))
    return out


class Tracer:
    """Starts the profiler once the window has less than :data:`TRACE_S`
    seconds to run; ``stop`` ends it and reduces the timeline."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.prof = None
        self.active = False
        self.result: Optional[Dict] = None
        # The first profiler start of a process sets up the tracer (CUPTI)
        # and blocks for seconds: pay it here, in set-up, not in the window.
        with profile(activities=self._activities()):
            torch.zeros(1, device=device).add_(1)
            if self.cuda:
                torch.cuda.synchronize()

    def _activities(self):
        return [ProfilerActivity.CUDA] if self.cuda \
            else [ProfilerActivity.CPU]

    def maybe_start(self, elapsed: float, seconds: float) -> None:
        if self.prof is not None or elapsed < seconds - TRACE_S:
            return
        self.prof = profile(activities=self._activities())
        self.prof.__enter__()
        self.active = True

    def stop(self, steps) -> None:
        """End the trace and reduce it against the traced ``steps``
        (:class:`~bench.lib.drive.StepRec`)."""
        if not self.active:
            return
        if self.cuda:
            torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)
        self.active = False
        host = []
        for st in steps:
            if st.traced:
                host.append(("engine_host", st.ns_step[0] * 1e-9,
                             st.ns_step[1] * 1e-9))
                host.append((st.kind, st.ns_run[0] * 1e-9,
                             st.ns_run[1] * 1e-9))
        self.result = reduce(_events(self.prof), host)
        self.prof = None


def reduce(events, host) -> Dict:
    """Kernels, busy and idle seconds, idle by host label, top kernels.
    ``host``: ``(label, start_s, end_s)`` ranges on the wall clock."""
    kernels = [(n, a, b) for n, dev, a, b in events if dev]
    steps = [(a, b) for n, a, b in host if n == "engine_host"]
    if not steps:
        return {"kernels": kernels, "busy_s": 0.0, "window_s": 0.0,
                "idle_by_host": {}, "top": [], "outside_s": 0.0}
    lo, hi = min(a for a, _ in steps), max(b for _, b in steps)
    merged = union([(a, b) for _, a, b in kernels])
    busy = [(max(a, lo), min(b, hi)) for a, b in merged if b > lo and a < hi]
    busy_s = sum(b - a for a, b in busy)
    gaps, prev = [], lo
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if hi > prev:
        gaps.append((prev, hi))
    # innermost host range holding the gap's midpoint: a device call
    # inside a step inside the harness (ranges of one label never overlap)
    by = {n: sorted((a, b) for m, a, b in host if m == n) for n in _HOST}
    starts = {n: [a for a, _ in iv] for n, iv in by.items()}
    idle: Dict[str, float] = {}
    for a, b in gaps:
        mid = (a + b) / 2
        label = "harness"
        for n in _HOST:
            i = bisect.bisect_right(starts[n], mid) - 1
            if i >= 0 and by[n][i][1] >= mid:
                label = n
                break
        idle[label] = idle.get(label, 0.0) + (b - a)
    top: Dict[str, float] = {}
    for n, a, b in kernels:
        top[n[:96]] = top.get(n[:96], 0.0) + (b - a)
    return {"kernels": [k for k in kernels if k[2] > lo and k[1] < hi],
            "busy_s": busy_s, "window_s": hi - lo, "idle_by_host": idle,
            "top": sorted(top.items(), key=lambda kv: -kv[1])[:10],
            # device time outside the traced steps' span: clocks that
            # disagree would show here
            "outside_s": sum(b - a for a, b in merged) - busy_s}
