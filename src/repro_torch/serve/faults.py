"""Deterministic fault injection for the slot engine
(``repro.serve.faults``): the seeded chaos harness.

A :class:`FaultPlan` says what can go wrong; a :class:`FaultInjector`
replays it as a reproducible per-iteration schedule through host-side
seams the engine already has:

* **page-allocation failures**: ``alloc_fail()`` is consulted wherever the
  engine asks the pool for pages (the admission reservation, per-step lane
  growth and chunk spans); ``True`` makes that call behave as a dry pool;
* **forced preemptions**: ``forced_preempt()`` preempts the youngest active
  request at the top of a step;
* **NaN logits**: ``nan_mask()`` marks slots whose step logits the engine
  overwrites with NaN on the device, after the model and before the
  sampler, so the caches never see them and the finiteness guard fails
  exactly those slots;
* **stalls**: ``begin_step`` returns extra virtual-clock ticks.

For a fixed plan and workload the schedule, and with it the engine's
recovery trace, is bit-reproducible: the probabilistic fields draw from
one ``numpy.random.default_rng(seed)`` in a fixed per-step order (NaN,
then preempt, then stall; allocation draws per call), and the ``*_at``
fields pin faults to exact iterations on top. ``Engine(faults=plan)``
builds a fresh injector for every session; pass a ``FaultInjector`` to
let one schedule run on across sessions.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

__all__ = ["FaultPlan", "FaultInjector"]


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Seeded description of the faults to inject.

    Probabilities are per engine iteration (``p_nan_logits`` per slot per
    iteration); the ``*_at`` schedules name exact iteration indices and
    fire regardless of the probabilistic draws. ``max_faults`` bounds the
    *probabilistic* faults so a chaos run terminates in bounded extra
    work; scheduled (``*_at``) faults always fire.
    """

    seed: int = 0
    p_alloc_fail: float = 0.0        # per pool-allocation call
    p_forced_preempt: float = 0.0    # per engine iteration
    p_nan_logits: float = 0.0        # per slot per iteration
    p_stall: float = 0.0             # per engine iteration
    stall_ticks: int = 4             # virtual-clock ticks per stall
    max_faults: Optional[int] = None
    # Exact-iteration schedules (applied on top of the draws):
    nan_at: Tuple[Tuple[int, int], ...] = ()    # (iteration, slot)
    preempt_at: Tuple[int, ...] = ()            # iterations
    alloc_fail_at: Tuple[int, ...] = ()         # every alloc call fails
    stall_at: Tuple[Tuple[int, int], ...] = ()  # (iteration, extra ticks)

    def any_faults(self) -> bool:
        return bool(self.p_alloc_fail or self.p_forced_preempt
                    or self.p_nan_logits or self.p_stall or self.nan_at
                    or self.preempt_at or self.alloc_fail_at
                    or self.stall_at)


class FaultInjector:
    """Replays a :class:`FaultPlan` as a concrete per-iteration schedule.

    The engine calls :meth:`begin_step` once per run-loop iteration (with
    the iteration index and the active-slot mask), then consults the
    per-seam queries. ``counts`` tallies every fault actually injected —
    the chaos tests reconcile it against the engine's terminal statuses.
    """

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._rng = np.random.default_rng(plan.seed)
        self.counts: Dict[str, int] = {
            "alloc_fail": 0, "forced_preempt": 0,
            "nan_logits": 0, "stall": 0,
        }
        self._nan: Optional[np.ndarray] = None
        self._forced = False
        self._alloc_all = False

    @property
    def total_injected(self) -> int:
        return sum(self.counts.values())

    def _budget_left(self) -> bool:
        mf = self.plan.max_faults
        return mf is None or self.total_injected < mf

    # ------------------------------------------------------------------

    def begin_step(self, step: int, num_slots: int,
                   active: np.ndarray) -> int:
        """Draw iteration ``step``'s faults; returns artificial stall
        ticks to add to the engine's virtual clock. Call order (and
        therefore the RNG stream) is fixed: nan draw, preempt draw,
        stall draw."""
        p = self.plan
        nan = np.zeros(num_slots, bool)
        if p.p_nan_logits > 0:
            draw = self._rng.random(num_slots) < p.p_nan_logits
            if self._budget_left():
                nan |= draw
        for it, sl in p.nan_at:
            if it == step and 0 <= sl < num_slots:
                nan[sl] = True
        nan &= np.asarray(active, bool)
        self._nan = nan
        self.counts["nan_logits"] += int(nan.sum())
        forced_draw = (p.p_forced_preempt > 0
                       and self._rng.random() < p.p_forced_preempt
                       and self._budget_left())
        self._forced = (forced_draw or step in p.preempt_at) \
            and bool(np.any(active))
        if self._forced:
            self.counts["forced_preempt"] += 1
        self._alloc_all = step in p.alloc_fail_at
        ticks = 0
        if (p.p_stall > 0 and self._rng.random() < p.p_stall
                and self._budget_left()):
            ticks = p.stall_ticks
        for it, k in p.stall_at:
            if it == step:
                ticks += k
        if ticks:
            self.counts["stall"] += 1
        return ticks

    # -- per-seam queries (valid after begin_step) ----------------------

    def nan_mask(self) -> Optional[np.ndarray]:
        """Bool ``(num_slots,)`` mask of slots whose logits this step are
        poisoned with NaN (already restricted to active slots); None when
        no NaN fault is live."""
        if self._nan is None or not self._nan.any():
            return None
        return self._nan

    def forced_preempt(self) -> bool:
        """Whether this iteration force-preempts the youngest request."""
        return self._forced

    def alloc_fail(self) -> bool:
        """Whether *this* pool-allocation attempt is made to fail. Drawn
        per call (plus the all-calls-fail ``alloc_fail_at`` schedule), so
        the stream depends only on the plan seed and the call sequence."""
        if self._alloc_all:
            self.counts["alloc_fail"] += 1
            return True
        if (self.plan.p_alloc_fail > 0 and self._budget_left()
                and self._rng.random() < self.plan.p_alloc_fail):
            self.counts["alloc_fail"] += 1
            return True
        return False
