"""Iteration-level request queue (``repro.serve.scheduler``): the FIFO
:class:`Scheduler` and its two admission forms.

* :meth:`Scheduler.next_admissions` (the phase-serialized engine) groups
  queue-head requests into prefill sweeps: short prompts (<= ``max_len``)
  packed first-fit-decreasing into shared ``(rows, max_len)`` rows with
  segment ids (T-REX dynamic batching, ``core/packing.py``), and each
  longer prompt alone, chunked into a solo row of ``len(chunks) *
  max_len`` tokens.
* :meth:`Scheduler.next_mixed` (the mixed-step engine) pops requests for
  chunk-granular admission.

Both stop at the first queue head that a page-budget ``reserve`` callback
refuses (head-blocking, never skip-ahead), so admission order is
deterministic. Prefix-sharing probes and the row-per-request layout of
recurrent stacks (``pack=False``) are refused in this slice.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np

from repro_torch.core.errors import UnsupportedConfigError
from repro_torch.core.packing import (PackedBatch, PackingPolicy,
                                      chunk_prompt, pack_requests)
from repro_torch.serve.sampling import SamplingParams

__all__ = ["Request", "Admission", "Scheduler", "TERMINAL_STATUSES"]

TERMINAL_STATUSES = ("ok", "rejected", "shed", "timed_out", "failed",
                     "cancelled")


@dataclasses.dataclass
class Request:
    """Same fields as the reference's ``Request``."""

    rid: int
    prompt: np.ndarray  # int32 token ids
    max_new_tokens: int = 16
    seed: Optional[int] = None
    ttl_steps: Optional[int] = None
    max_preemptions: Optional[int] = None
    sampling: Optional[SamplingParams] = None
    output: Optional[List[int]] = None
    status: Optional[str] = None
    status_reason: Optional[str] = None

    def __post_init__(self):
        if self.output is None:
            self.output = []


@dataclasses.dataclass
class Admission:
    """One prefill sweep's worth of admitted requests: a ``packed`` batch
    of short prompts, or one long prompt's ``chunks`` (its prefill row is
    ``len(chunks) * max_len`` wide)."""

    requests: List[Request]
    packed: Optional[PackedBatch] = None
    chunks: Optional[List[np.ndarray]] = None

    @property
    def utilization(self) -> float:
        """Filled fraction of the prefill token slots this sweep."""
        if self.packed is not None:
            return float((self.packed.segment_ids > 0).mean())
        total = sum(len(c) for c in self.chunks)
        return total / max(len(self.chunks) * len(self.chunks[0]), 1)


class Scheduler:
    """FIFO admission queue with packing. ``max_len`` is the packed row
    width (longer prompts are chunked), ``max_per_row`` the packing depth,
    ``max_rows`` the rows of one packed sweep; ``max_prompt_len`` (when
    set) is the hard cache-capacity bound a prompt may not exceed."""

    def __init__(self, max_len: int = 128, max_per_row: int = 4,
                 max_rows: int = 8, max_prompt_len: Optional[int] = None,
                 pack: bool = True):
        if not pack:
            raise UnsupportedConfigError(
                "row-per-request admissions (pack=False, recurrent stacks) "
                "come with a later slice of the port (ROADMAP Queue 1 "
                "item 10)")
        self.policy = PackingPolicy(max_len=max_len, max_per_row=max_per_row)
        self.max_rows = max_rows
        self.max_prompt_len = max_prompt_len
        self.queue: List[Request] = []

    def submit(self, req: Request) -> None:
        n = len(req.prompt)
        if n == 0:
            raise ValueError("empty prompt")
        if self.max_prompt_len is not None and n > self.max_prompt_len:
            raise ValueError(
                f"prompt len {n} > max_prompt_len {self.max_prompt_len} "
                "(cache capacity); raise the engine's max_prompt_len")
        self.queue.append(req)

    def pending(self) -> int:
        return len(self.queue)

    def requeue(self, req: Request) -> None:
        """Put a request back at the queue head."""
        self.queue.insert(0, req)

    def drop_where(self, pred: Callable[[Request], bool]) -> List[Request]:
        """Remove and return every queued request matching ``pred`` (queue
        order kept for both)."""
        kept: List[Request] = []
        dropped: List[Request] = []
        for r in self.queue:
            (dropped if pred(r) else kept).append(r)
        self.queue = kept
        return dropped

    def next_admissions(self, free_slots: int, reserve=None,
                        probe=None) -> List[Admission]:
        """Admit up to ``free_slots`` queue-head requests that ``reserve``
        accepts, as admission groups: each prompt longer than ``max_len``
        its own chunked group, in queue order, then one packed group of the
        short ones. A packing wider than ``max_rows`` rows hands its last
        requests back to the queue head."""
        if probe is not None:
            raise UnsupportedConfigError(
                "prefix-sharing probes come with a later slice of the port "
                "(ROADMAP Queue 1 item 7)")
        groups: List[Admission] = []
        shorts: List[Request] = []
        taken = 0
        while (self.queue and taken < free_slots
               and (reserve is None or reserve(self.queue[0]))):
            req = self.queue.pop(0)
            if len(req.prompt) > self.policy.max_len:
                groups.append(Admission(
                    requests=[req],
                    chunks=chunk_prompt(req.prompt, self.policy.max_len)))
            else:
                shorts.append(req)
            taken += 1
        if shorts:
            packed = pack_requests([r.prompt for r in shorts], self.policy)
            while packed.rows > self.max_rows and len(shorts) > 1:
                self.queue.insert(0, shorts.pop())
                packed = pack_requests([r.prompt for r in shorts],
                                       self.policy)
            groups.append(Admission(requests=shorts, packed=packed))
        return groups

    def next_mixed(self, free_slots: int, reserve=None) -> List[Request]:
        """Pop up to ``free_slots`` queue-head requests that ``reserve``
        accepts (FIFO head-blocking)."""
        out: List[Request] = []
        while (self.queue and len(out) < free_slots
               and (reserve is None or reserve(self.queue[0]))):
            out.append(self.queue.pop(0))
        return out
