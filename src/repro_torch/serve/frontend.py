"""Async serving front end (``repro.serve.frontend``): submit, stream and
cancel over a steppable engine.

:class:`~repro_torch.serve.engine.Engine` and the multi-replica
:class:`~repro_torch.serve.dispatch.Dispatcher` expose the serving loop
one iteration at a time (``step()`` / ``has_work()`` / ``finish_run()``),
and this module puts an ``asyncio`` surface on top without touching
engine semantics:

* :meth:`Frontend.submit` returns a :class:`StreamHandle` at once; the
  request reaches the engine at its due tick (trace replay) or the next
  step (live traffic);
* ``async for tok in handle`` yields each token when its step retires
  (``StepResult.emitted``), the prefill's first token included;
* ``await handle.result()`` resolves to the finished
  :class:`~repro_torch.serve.scheduler.Request` with its terminal status;
* :meth:`Frontend.cancel` frees the request's slot and pages mid-decode
  (``Engine.cancel``) and finishes the handle ``cancelled``.

One asyncio task steps the engine in line (one device dispatch per step,
consumers woken between steps), so everything stays single-threaded and
deterministic: the same submission ticks give the same admission schedule,
and so the same tokens, as a synchronous ``Engine.run`` over the same
trace.
"""
from __future__ import annotations

import asyncio
from typing import Any, List, Optional, Tuple

from repro_torch.serve.scheduler import Request

__all__ = ["Frontend", "StreamHandle"]

_DONE = object()  # stream sentinel: the handle's request turned terminal


class StreamHandle:
    """One submitted request's streaming view: async-iterate the tokens,
    await the terminal result, or cancel. Created by
    :meth:`Frontend.submit` — never directly."""

    def __init__(self, frontend: "Frontend", request: Request):
        self._frontend = frontend
        self.request = request
        self._q: "asyncio.Queue[Any]" = asyncio.Queue()
        self._done = asyncio.Event()

    # -- stepping side --------------------------------------------------

    def _push(self, tok: int) -> None:
        if not self._done.is_set():
            self._q.put_nowait(tok)

    def _finish(self) -> None:
        if not self._done.is_set():
            self._done.set()
            self._q.put_nowait(_DONE)

    # -- consumer side --------------------------------------------------

    @property
    def status(self) -> Optional[str]:
        """The request's terminal status (None while in flight)."""
        return self.request.status

    def done(self) -> bool:
        return self._done.is_set()

    def __aiter__(self) -> "StreamHandle":
        return self

    async def __anext__(self) -> int:
        tok = await self._q.get()
        if tok is _DONE:
            raise StopAsyncIteration
        return tok

    async def result(self) -> Request:
        """Wait for the terminal status; returns the request (its
        ``output`` holds every token, ``status``/``status_reason`` say
        how it ended)."""
        await self._done.wait()
        return self.request

    async def cancel(self) -> bool:
        """Withdraw this request (see :meth:`Frontend.cancel`)."""
        return await self._frontend.cancel(self)


class Frontend:
    """Async submit/stream/cancel tier over one steppable engine.

    Use as an async context manager (starts/stops the drive task), or
    call :meth:`start` / :meth:`stop` explicitly::

        async with Frontend(engine) as fe:
            h = fe.submit(Request(rid=0, prompt=toks))
            async for tok in h:
                ...
            req = await h.result()
        stats = fe.stats  # engine decode_stats, sealed by stop()

    ``submit(..., tick=n)`` schedules trace arrivals on the engine's
    deterministic iteration axis — the same ``(tick, Request)`` contract
    as ``Engine.run(arrivals=...)``, so a replayed trace is
    token-identical to the synchronous engine."""

    def __init__(self, engine):
        self.engine = engine
        # (tick or None, request, handle): not yet handed to the engine.
        self._queue: List[Tuple[Optional[int], Request, StreamHandle]] = []
        self._wake = asyncio.Event()
        self._task: Optional[asyncio.Task] = None
        self._running = False
        # Requests cancelled before ever reaching the engine (the engine's
        # done list never sees them); merged into results by stop().
        self._unsubmitted_done: List[Request] = []
        self.results: List[Request] = []  # finish_run order, sealed by stop
        self.stats: dict = {}

    # -- lifecycle ------------------------------------------------------

    async def __aenter__(self) -> "Frontend":
        await self.start()
        return self

    async def __aexit__(self, *exc) -> None:
        await self.stop()

    async def start(self) -> None:
        if self._task is not None:
            raise RuntimeError("frontend already started")
        self._running = True
        self._task = asyncio.create_task(self._drive())

    async def stop(self) -> None:
        """Drain remaining work, stop the drive task, and seal the
        session: ``results`` gets the engine's completion-order done list
        and ``stats`` its ``decode_stats``."""
        if self._task is None:
            return
        self._running = False
        self._wake.set()
        await self._task
        self._task = None
        self.results = self.engine.finish_run() + self._unsubmitted_done
        self._unsubmitted_done = []
        self.stats = self.engine.decode_stats
        # Anything the drive loop never surfaced (e.g. cancelled between
        # steps) still finishes its handle here.
        for req in self.results:
            h = getattr(req, "_handle", None)
            if h is not None:
                h._finish()

    # -- submission / cancellation -------------------------------------

    def submit(self, request: Request,
               tick: Optional[int] = None) -> StreamHandle:
        """Queue a request and return its stream handle immediately.

        ``tick=None`` (live traffic) hands it to the engine on the next
        step; an integer tick replays a trace arrival exactly like
        ``Engine.run(arrivals=[(tick, request)])``. Admission control
        (shedding, never-admissible rejection) runs inside the engine's
        step — a shed request's handle finishes with that status."""
        handle = StreamHandle(self, request)
        request._handle = handle  # type: ignore[attr-defined]
        self._queue.append((tick, request, handle))
        self._wake.set()
        return handle

    async def cancel(self, handle: StreamHandle) -> bool:
        """Withdraw a request: if still queued here it never reaches the
        engine; otherwise ``Engine.cancel`` drops it from the scheduler
        or releases its slot — pages return to the pool mid-decode.
        Finishes the handle with ``status="cancelled"``. False when the
        request already reached a terminal status."""
        req = handle.request
        for i, (_, r, h) in enumerate(self._queue):
            if r is req:
                del self._queue[i]
                req.status = "cancelled"
                req.status_reason = "cancelled before submission"
                self._unsubmitted_done.append(req)
                h._finish()
                return True
        if req.status is not None:
            return False
        ok = self.engine.cancel(req)
        if ok:
            handle._finish()
        return ok

    # -- drive loop -----------------------------------------------------

    def _take_due(self) -> List[Request]:
        """Pop every queued request due for the NEXT step: live submits
        (tick None) plus trace arrivals with ``tick <= iteration + 1`` —
        the same schedule ``Engine.run`` derives from its arrivals
        list."""
        nxt = self.engine.iteration + 1
        due, rest = [], []
        for item in self._queue:
            tick = item[0]
            (due if tick is None or tick <= nxt else rest).append(item)
        self._queue = rest
        due.sort(key=lambda it: (it[0] is not None, it[0] or 0))
        return [r for _, r, _ in due]

    def _fanout(self, res) -> None:
        for req, tok in res.emitted:
            h = getattr(req, "_handle", None)
            if h is not None:
                h._push(tok)
        for req in res.finished:
            h = getattr(req, "_handle", None)
            if h is not None:
                h._finish()

    async def _drive(self) -> None:
        while self._running:
            # Keep stepping while anything is queued (a future-tick
            # arrival needs the clock to advance toward its tick) or in
            # flight; otherwise idle until a submit/cancel/stop wakes us.
            if not self._queue and not self.engine.has_work():
                self._wake.clear()
                if not self._running:
                    break
                await self._wake.wait()
                continue
            res = self.engine.step(submits=self._take_due())
            self._fanout(res)
            # One cooperative yield per step: consumers see this step's
            # tokens before the next jitted dispatch starts.
            await asyncio.sleep(0)
        # Drain on stop: finish everything already accepted so every
        # handle resolves (stop() then seals results/stats).
        while self._queue or self.engine.has_work():
            res = self.engine.step(submits=self._take_due())
            self._fanout(res)
            await asyncio.sleep(0)
