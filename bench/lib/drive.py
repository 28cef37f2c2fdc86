"""The measured window: the harness's load generator driving
``Engine.step`` (every step ends in a host sync), and the records the
metrics are read from.

The engine's step functions ``_run_mixed`` and ``_run_decode`` are wrapped
on the instance, as ``launch/profile_serve.py`` does, to record each
step's kind, rows, resident lengths and fresh tokens, its host time, and
the pool's pages in use. The wrappers run in every run, traced or not.

Times are host clock (``time.perf_counter``) read after each step's
return: a token's emission time is the end of the step that made it. Each
step also keeps its ranges on the wall clock (``time.time_ns``, the clock
of the profiler's timeline), around ``Engine.step`` and around its device
call, which label the traced run's idle gaps.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np

from bench.lib import program
from bench.lib.traffic import Item, Mix

__all__ = ["StepRec", "ReqRec", "Window", "instrument", "closed_loop",
           "open_loop", "warm_open"]

DRAIN_S = 60.0  # how long past the close a due request may wait for its
# first token before it counts as never served


@dataclasses.dataclass
class StepRec:
    kind: str                  # decode or mixed
    lengths: np.ndarray        # resident tokens of each active row, before
    n_new: np.ndarray          # fresh tokens of each active row
    slots: int                 # the engine's rows (num_slots)
    pages_in_use: int
    pages_total: int
    run_ms: float              # host ms of the step's device call
    t_start: float = 0.0       # host clock around Engine.step
    t_end: float = 0.0
    ns_step: tuple = (0, 0)    # wall-clock ns around Engine.step
    ns_run: tuple = (0, 0)     # and around the device call
    emitted: int = 0
    phase: str = "window"      # ramp, window or drain
    traced: bool = False


@dataclasses.dataclass
class ReqRec:
    rid: int
    item: Item
    req: object
    due: float                 # host clock at which it was due
    times: List[float] = dataclasses.field(default_factory=list)
    finished: Optional[float] = None
    status: Optional[str] = None


@dataclasses.dataclass
class Window:
    t0: float = 0.0            # host clock at the first measured step
    t_close: float = 0.0       # t0 + seconds
    t_last: float = 0.0        # end of the last step started before close
    steps: List[StepRec] = dataclasses.field(default_factory=list)
    reqs: Dict[int, ReqRec] = dataclasses.field(default_factory=dict)
    setup_end: float = 0.0


def instrument(eng, steps: List[StepRec]) -> None:
    """Wrap the engine's two step kinds to record each step into
    ``steps``."""
    sl = eng.slots

    def rec(kind, n_new):
        active = sl.active.copy()
        return StepRec(kind=kind, lengths=sl.lengths[active].astype(np.int64),
                       n_new=np.asarray(n_new)[active].astype(np.int64),
                       slots=int(eng.num_slots),
                       pages_in_use=int(sl.pool.pages_in_use())
                       if eng.paged else 0,
                       pages_total=int(sl.pool.total_pages)
                       if eng.paged else 0, run_ms=0.0)

    run_mixed, run_decode = eng._run_mixed, eng._run_decode

    def mixed(toks, n_new, *a, **k):
        r = rec("mixed", n_new)
        ns, t = time.time_ns(), time.perf_counter()
        out = run_mixed(toks, n_new, *a, **k)
        r.run_ms = (time.perf_counter() - t) * 1e3
        r.ns_run = (ns, time.time_ns())
        steps.append(r)
        return out

    def decode(cur, *a, **k):
        r = rec("decode", np.ones(eng.num_slots, np.int64))
        ns, t = time.time_ns(), time.perf_counter()
        out = run_decode(cur, *a, **k)
        r.run_ms = (time.perf_counter() - t) * 1e3
        r.ns_run = (ns, time.time_ns())
        steps.append(r)
        return out

    eng._run_mixed = mixed
    eng._run_decode = decode


def _step(eng, w: Window, submits, phase: str, traced: bool):
    n0 = len(w.steps)
    ns, t = time.time_ns(), time.perf_counter()
    res = eng.step(submits)
    t_end = time.perf_counter()
    ns_end = time.time_ns()
    for s in w.steps[n0:]:
        s.t_start, s.t_end, s.phase, s.traced = t, t_end, phase, traced
        s.ns_step = (ns, ns_end)
        s.emitted = len(res.emitted)
    for req, _tok in res.emitted:
        w.reqs[req.rid].times.append(t_end)
    for req in res.finished:
        r = w.reqs.get(req.rid)
        if r is not None and r.finished is None:
            r.finished, r.status = t_end, req.status
    return res, t_end


class _Pool:
    """The requests not yet sent, in order, per caller (closed loop) or in
    one queue (open loop: caller -1)."""

    def __init__(self, items: List[Item], w: Window):
        self.queues: Dict[int, List[Item]] = {}
        for it in items:
            self.queues.setdefault(it.client, []).append(it)
        self.w = w

    def peek(self, client: int = -1) -> Optional[Item]:
        q = self.queues.get(client)
        return q[0] if q else None

    def take(self, due: float, client: int = -1):
        q = self.queues.get(client)
        if not q:
            raise RuntimeError(
                f"caller {client} has no request left: raise the mix's "
                "'per_client'")
        it = q.pop(0)
        req = program.request(it.idx, it.prompt, it.max_new)
        self.w.reqs[it.idx] = ReqRec(rid=it.idx, item=it, req=req, due=due)
        return req


def closed_loop(eng, mix: Mix, items: List[Item], seconds: float,
                tracer=None) -> Window:
    """``mix.clients`` callers over the engine. Set-up ends once every
    caller's first request has its first token (the ramp: every slot is
    then decoding or prefilling a follow-up); the window then runs for
    ``seconds``. A caller submits its next request at the step after its
    last one finished."""
    w = Window()
    instrument(eng, w.steps)
    pool = _Pool(items, w)
    now = time.perf_counter()
    submits = [pool.take(now, c) for c in range(mix.clients)]
    first = [r.rid for r in submits]
    phase = "ramp"
    while True:
        if phase == "ramp" and all(w.reqs[i].times for i in first):
            phase = "window"
            w.t0 = w.setup_end = time.perf_counter()
            w.t_close = w.t0 + seconds
        if phase == "window":
            if time.perf_counter() >= w.t_close:
                break
            if tracer is not None:
                tracer.maybe_start(time.perf_counter() - w.t0, seconds)
        traced = tracer is not None and tracer.active
        res, t_end = _step(eng, w, submits, phase, traced)
        if phase == "window":
            w.t_last = t_end
        submits = [pool.take(t_end, w.reqs[r.rid].item.client)
                   for r in res.finished]
    if tracer is not None:
        tracer.stop(w.steps)
    return w


def warm_open(eng, vocab: int) -> None:
    """Warm the open loop's shapes in a session of its own: two requests,
    one whose prompt spans two chunks of the mixed step, both decoding a
    few tokens, so the mixed ``(slots, chunk)`` and decode ``(slots, 1)``
    steps and every kernel body they pick have run."""
    chunk = min(eng.max_len, eng.prefill_budget or eng.max_len)
    rng = np.random.default_rng(0)
    for i, n in enumerate((chunk + chunk // 2, 8)):
        eng.submit(program.request(
            -1 - i, rng.integers(0, vocab, size=n).astype(np.int32), 4))
    eng.run()


def open_loop(eng, mix: Mix, items: List[Item], seconds: float,
              tracer=None) -> Window:
    """Requests submitted at the first step boundary after they are due,
    for ``seconds``; then, with no new arrivals, steps on until every
    request due in the window has its first token (at most
    :data:`DRAIN_S`)."""
    w = Window()
    instrument(eng, w.steps)
    pool = _Pool(items, w)
    w.t0 = w.setup_end = time.perf_counter()
    w.t_close = w.t0 + seconds
    while True:
        now = time.perf_counter()
        if now >= w.t_close:
            break
        submits = []
        while pool.peek() is not None and w.t0 + pool.peek().due_s <= now:
            submits.append(pool.take(w.t0 + pool.peek().due_s))
        if not submits and not eng.has_work():
            nxt = w.t0 + pool.peek().due_s if pool.peek() is not None \
                else w.t_close
            time.sleep(max(0.0, min(nxt, w.t_close) - now))
            continue
        if tracer is not None:
            tracer.maybe_start(now - w.t0, seconds)
        traced = tracer is not None and tracer.active
        _, w.t_last = _step(eng, w, submits, "window", traced)
    if tracer is not None:
        tracer.stop(w.steps)
    deadline = time.perf_counter() + DRAIN_S
    while eng.has_work() and time.perf_counter() < deadline and any(
            not r.times and r.finished is None for r in w.reqs.values()):
        _step(eng, w, [], "drain", False)
    return w

