"""The program's own spans over the measured window, for the readers of
``bench/metrics/``.

Besides ``program.py`` this is the only module of the harness that touches
the program, and it reads ``repro_torch.serve.spans`` alone: the engine's
step spans (``step``; ``expire``, ``grow``, ``admit``, ``dispatch``,
``retire``; in a dispatch ``upload``, ``model``, ``choose``, ``sync``) and
its request spans (``queued``, ``prefill``, ``decode``), stamped on the
wall clock of the profiler's timeline. Everything here gives None when the
program has no recorder (an older checkout) or when its ring overwrote
spans of the window, and the metric is then left out of the run's line.

The window is the wall-clock range of the window's steps
(``StepRec.ns_step``); the traced window that of the traced steps, the
range ``trace.reduce`` measures over.
"""
from __future__ import annotations

import importlib
from typing import Dict, List, Optional, Tuple

from bench.lib import program
from bench.lib.readers import Run, traced_steps, window_steps
from bench.lib.trace import union

__all__ = ["ENQUEUE", "window", "dispatches", "children", "idle_by_span"]

# The dispatch's host phases that enqueue work: the device idles in them
# only while the host has not enqueued enough yet.
ENQUEUE = ("upload", "model", "choose")


def _recorder():
    """``repro_torch.serve.spans``, or None where the program has none."""
    program._import_path()
    try:
        return importlib.import_module("repro_torch.serve.spans")
    except ModuleNotFoundError as e:
        if e.name != "repro_torch.serve.spans":
            raise
        return None


def window(run: Run, traced: bool = False
           ) -> Optional[Tuple[int, int, List]]:
    """``(lo_ns, hi_ns, spans)``: the closed spans overlapping the window
    (``traced``: the traced window), or None."""
    steps = traced_steps(run) if traced else window_steps(run)
    rec = _recorder() if steps else None
    if rec is None:
        return None
    lo = min(s.ns_step[0] for s in steps)
    hi = max(s.ns_step[1] for s in steps)
    got = rec.records(lo, hi)
    return (lo, hi, got.spans) if got.complete else None


def dispatches(spans, kind: str, lo: int, hi: int) -> List:
    """The ``dispatch`` spans of ``kind`` starting in ``[lo, hi]``."""
    return sorted((s for s in spans if s.name == "dispatch"
                   and lo <= s.start_ns <= hi
                   and (s.attrs or {}).get("kind") == kind),
                  key=lambda s: s.start_ns)


def children(spans) -> Dict[int, List]:
    """Each span's children, by the parent's id."""
    out: Dict[int, List] = {}
    for s in spans:
        if s.parent >= 0:
            out.setdefault(s.parent, []).append(s)
    return out


def _segments(spans, lo: float, hi: float) -> List[Tuple[float, float, str]]:
    """``[lo, hi]`` cut into stretches, each under the name of the
    innermost step-level span holding it (``harness`` under none). Step
    spans nest, so one sweep with a stack of open spans does it."""
    tree = sorted(((s.start_ns * 1e-9, s.end_ns * 1e-9, s.name)
                   for s in spans if s.rid < 0),
                  key=lambda x: (x[0], -x[1]))
    out: List[Tuple[float, float, str]] = []
    stack: List[Tuple[float, str]] = []
    cur = lo

    def close_to(t: float) -> None:
        nonlocal cur
        while stack and stack[-1][0] <= t:
            e, name = stack.pop()
            if e > cur:
                out.append((cur, e, name))
                cur = e

    for a, b, name in tree:
        close_to(a)
        if a > cur:
            out.append((cur, a, stack[-1][1] if stack else "harness"))
            cur = a
        stack.append((b, name))
    close_to(float("inf"))
    if hi > cur:
        out.append((cur, hi, "harness"))
    return [(max(a, lo), min(b, hi), n) for a, b, n in out if b > lo
            and a < hi]


def idle_by_span(run: Run) -> Optional[Dict[str, float]]:
    """Seconds of the traced window in which no device operation ran, by
    the innermost program span the host was in (a gap that spans several
    is cut at their bounds). They add up to the trace's idle time,
    ``window_s - busy_s``."""
    if run.trace is None:
        return None
    w = window(run, traced=True)
    if w is None:
        return None
    lo, hi = w[0] * 1e-9, w[1] * 1e-9
    busy = [(max(a, lo), min(b, hi)) for a, b in
            union([(a, b) for _, a, b in run.trace["kernels"]])
            if b > lo and a < hi]
    gaps, prev = [], lo
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if hi > prev:
        gaps.append((prev, hi))
    segs = _segments(w[2], lo, hi)
    idle: Dict[str, float] = {}
    j = 0
    for a, b in gaps:
        while j < len(segs) and segs[j][1] <= a:
            j += 1
        k = j
        while k < len(segs) and segs[k][0] < b:
            x, y, name = segs[k]
            if min(b, y) > max(a, x):
                idle[name] = idle.get(name, 0.0) + min(b, y) - max(a, x)
            k += 1
    return idle
