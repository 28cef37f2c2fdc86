"""Iteration-level request queue (``repro.serve.scheduler``, the parts
the mixed-step engine uses): :class:`Request` and a FIFO
:class:`Scheduler` whose :meth:`Scheduler.next_mixed` pops queue-head
requests for chunked admission under a page-budget ``reserve`` callback
(head-blocking, never skip-ahead, so admission order is deterministic)."""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np

from repro_torch.serve.sampling import SamplingParams

__all__ = ["Request", "Scheduler", "TERMINAL_STATUSES"]

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


class Scheduler:
    """FIFO admission queue. ``max_prompt_len`` (when set) is the hard
    cache-capacity bound a prompt may not exceed. (The reference's packing
    knobs, ``max_len``/``max_rows``, belong to the serialized prefill.)"""

    def __init__(self, max_prompt_len: Optional[int] = None):
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

    def next_mixed(self, free_slots: int, reserve=None) -> List[Request]:
        """Pop up to ``free_slots`` queue-head requests that ``reserve``
        accepts (FIFO head-blocking)."""
        out: List[Request] = []
        while (self.queue and len(out) < free_slots
               and (reserve is None or reserve(self.queue[0]))):
            out.append(self.queue.pop(0))
        return out
