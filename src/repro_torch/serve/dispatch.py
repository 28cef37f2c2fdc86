"""Multi-replica dispatch (``repro.serve.dispatch``): N engines behind one
steppable surface.

:class:`Dispatcher` balances requests over a fixed set of
:class:`~repro_torch.serve.engine.Engine` replicas and exposes the same
steppable protocol (``step(submits=...)`` / ``has_work()`` /
``finish_run()`` / ``cancel`` / ``run``), so a
:class:`~repro_torch.serve.frontend.Frontend` drives one replica or a fleet
alike. Routing is deterministic least-loaded (queued plus decoding plus
routed this step; ties to the lowest index): the same trace always gives
the same placement, and so the same tokens. Replicas that share prefixes
are joined through one :class:`~repro_torch.serve.pages.FleetPrefixIndex`,
so a prefix prefilled on replica A is restored into replica B's pool from
the host tier on B's first probe.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serve.engine import Engine, StepResult
from repro_torch.serve.pages import FleetPrefixIndex
from repro_torch.serve.scheduler import Request, TERMINAL_STATUSES

__all__ = ["Dispatcher"]

# decode_stats keys summed across replicas (the rest are reported
# per-replica under "replicas" or recomputed over the merged done set).
_SUM_KEYS = (
    "steps", "decoded_tokens", "kv_blocks_visited", "kv_blocks_dense",
    "preemptions", "preemptions_recovered", "pages_shared",
    "audit_violations", "clock_ticks", "device_time",
    "fleet_restored_pages", "mixed_steps", "prefill_chunk_tokens",
    "completed_ok", "shed", "rejected", "timed_out", "failed", "cancelled",
)


class Dispatcher:
    """Route requests over engine replicas with fleet prefix sharing.

    ``replicas`` is a non-empty sequence of engines (typically identical
    configs — the dispatcher does not require it, but token-identity
    across placements obviously does). When ``share_fleet`` is true
    (default), every fleet-eligible replica is attached to a shared
    :class:`FleetPrefixIndex` (pass ``fleet=`` to supply your own, e.g.
    with a bounded host-tier ``capacity``); replicas with ``prefix_share``
    off stay out.
    """

    def __init__(self, replicas: Sequence[Engine], *,
                 fleet: Optional[FleetPrefixIndex] = None,
                 share_fleet: bool = True):
        if not replicas:
            raise ValueError("Dispatcher needs at least one engine replica")
        self.replicas: List[Engine] = list(replicas)
        self.fleet: Optional[FleetPrefixIndex] = None
        if share_fleet:
            eligible = [e for e in self.replicas if e.prefix_share]
            if eligible:
                self.fleet = fleet if fleet is not None else FleetPrefixIndex()
                for eng in eligible:
                    eng.attach_fleet(self.fleet)
        self._owner: Dict[int, Engine] = {}  # id(request) -> routed replica
        # Routed but not yet stepped into the engine (cleared each step):
        # without this a same-step burst would all land on one replica,
        # since engine-side load only moves when the replica steps.
        self._staged = [0] * len(self.replicas)
        self._iters = 0
        self.routed_counts = [0] * len(self.replicas)
        self.decode_stats: dict = {}

    # -- routing --------------------------------------------------------

    def _load(self, eng: Engine) -> int:
        return int(eng.scheduler.pending()) + int(eng.slots.active.sum())

    def route(self, req: Request) -> Engine:
        """Pick the least-loaded replica (queued + decoding + staged this
        pass; ties → lowest index) and record ownership for
        :meth:`cancel`. Deterministic for a given request order."""
        loads = [self._load(e) + self._staged[i]
                 for i, e in enumerate(self.replicas)]
        i = int(np.argmin(loads))
        self._staged[i] += 1
        self._owner[id(req)] = self.replicas[i]
        self.routed_counts[i] += 1
        return self.replicas[i]

    # -- steppable protocol ---------------------------------------------

    @property
    def iteration(self) -> int:
        """The dispatcher's own step count — the tick axis external
        callers schedule trace arrivals on (replica clocks advance only
        while that replica has work, so they are not a shared axis)."""
        return self._iters

    def has_work(self) -> bool:
        return any(e.has_work() for e in self.replicas)

    def step(self, submits: Sequence[Request] = ()) -> StepResult:
        """One fleet step: route ``submits`` (in order) to least-loaded
        replicas, then step every replica that has work or new submits.
        Returns the merged :class:`StepResult` — emissions and finishes
        concatenated in replica order, ``device_time`` summed (fleet
        device-tokens spent this step)."""
        self._iters += 1
        per: Dict[int, List[Request]] = {}
        for req in submits:
            eng = self.route(req)
            per.setdefault(id(eng), []).append(req)
        emitted: List[Tuple[Request, int]] = []
        finished: List[Request] = []
        device_time = 0
        for eng in self.replicas:
            mine = per.get(id(eng), [])
            if not mine and not eng.has_work():
                continue
            res = eng.step(submits=mine)
            emitted.extend(res.emitted)
            finished.extend(res.finished)
            device_time += res.device_time
        # staged submits are now inside their engines' own load counts
        self._staged = [0] * len(self.replicas)
        return StepResult(emitted=emitted, finished=finished,
                          device_time=device_time)

    def cancel(self, req: Request) -> bool:
        """Cancel on whichever replica the request was routed to."""
        eng = self._owner.get(id(req))
        if eng is None:
            return False
        return eng.cancel(req)

    def finish_run(self) -> List[Request]:
        """Close every replica's session and merge: returns the combined
        done list (replica-major completion order) and builds the fleet's
        ``decode_stats`` — summed counters, merged TTFT map, ITL
        percentiles recomputed over the merged per-request emission
        stamps, per-replica stats under ``"replicas"``, and the fleet
        index's own hit/publish counters."""
        done: List[Request] = []
        per_stats: List[dict] = []
        for eng in self.replicas:
            done.extend(eng.finish_run())
            per_stats.append(eng.decode_stats)
        stats: dict = {k: sum(s.get(k, 0) for s in per_stats)
                       for k in _SUM_KEYS}
        stats["num_replicas"] = len(self.replicas)
        stats["routed_counts"] = list(self.routed_counts)
        stats["status_counts"] = {
            s: sum(ps["status_counts"].get(s, 0) for ps in per_stats)
            for s in TERMINAL_STATUSES}
        stats["slot_utilization"] = float(np.mean(
            [ps["slot_utilization"] for ps in per_stats]))
        stats["ttft"] = {}
        for ps in per_stats:
            stats["ttft"].update(ps.get("ttft", {}))
        itl = [b - a
               for r in done
               for a, b in zip(getattr(r, "_token_dev", []),
                               getattr(r, "_token_dev", [])[1:])]
        stats["itl_p50"] = float(np.percentile(itl, 50)) if itl else 0.0
        stats["itl_p99"] = float(np.percentile(itl, 99)) if itl else 0.0
        if self.fleet is not None:
            stats["fleet"] = {
                "entries": len(self.fleet), "hits": self.fleet.hits,
                "misses": self.fleet.misses,
                "published": self.fleet.published,
                "restored_pages": self.fleet.restored_pages,
            }
        stats["replicas"] = per_stats
        self.decode_stats = stats
        self._owner.clear()
        self._iters = 0
        return done

    def run(self, arrivals: Optional[Sequence[Tuple[int, Request]]] = None
            ) -> List[Request]:
        """Synchronous fleet loop — same contract as ``Engine.run``:
        drain an optional ``(tick, request)`` trace against the
        dispatcher's step clock and return the merged done list."""
        arr = sorted(arrivals or [], key=lambda a: a[0])
        ai = 0
        while (self.has_work() or ai < len(arr)):
            due: List[Request] = []
            while ai < len(arr) and arr[ai][0] <= self._iters + 1:
                due.append(arr[ai][1])
                ai += 1
            self.step(submits=due)
        return self.finish_run()
