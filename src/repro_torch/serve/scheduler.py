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
* :meth:`Scheduler.next_batch`, the drain interface of the absorbed
  ``DynamicBatcher`` (kept as an alias): one packed batch of queue-head
  short prompts, or one long prompt's chunks.

Both stop at the first queue head that a page-budget ``reserve`` callback
refuses (head-blocking, never skip-ahead), so admission order is
deterministic. With prefix sharing the engine passes a ``probe``: requests
whose leading tokens sit in the prefix cache ride row-per-request
**shared** admissions, hits adjacent in admission order batched into one
suffix sweep. A recurrent stack's scheduler (``pack=False``) admits one
request per row instead: a recurrent prefill cache keeps only each row's
end state, so requests cannot share a row.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.packing import (PackedBatch, PackingPolicy,
                                      chunk_prompt, pack_requests)
from repro_torch.serve.sampling import SamplingParams

__all__ = ["Request", "Admission", "Scheduler", "DynamicBatcher",
           "TERMINAL_STATUSES"]

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
    of short prompts, one long prompt's ``chunks`` (its prefill row is
    ``len(chunks) * max_len`` wide), (``shared_prefix > 0``) requests
    whose leading tokens are expected in the prefix cache, one row each:
    ``shared_prefixes[i]`` is request i's estimate, ``shared_prefix`` the
    largest (the engine re-probes at prefill time), or (``row_width``
    set, a ``pack=False`` scheduler's) one request per row, right-aligned
    in rows of ``row_width`` tokens."""

    requests: List[Request]
    packed: Optional[PackedBatch] = None
    chunks: Optional[List[np.ndarray]] = None
    row_width: Optional[int] = None
    shared_prefix: int = 0
    shared_prefixes: Optional[List[int]] = None

    @property
    def utilization(self) -> float:
        """Filled fraction of the prefill token slots this sweep."""
        if self.packed is not None:
            return float((self.packed.segment_ids > 0).mean())
        if self.chunks is not None:
            total = sum(len(c) for c in self.chunks)
            return total / max(len(self.chunks) * len(self.chunks[0]), 1)
        total = sum(len(r.prompt) for r in self.requests)
        return total / max(len(self.requests) * self.row_width, 1)


class Scheduler:
    """FIFO admission queue with packing. ``max_len`` is the packed row
    width (longer prompts are chunked), ``max_per_row`` the packing depth,
    ``max_rows`` the rows of one packed sweep; ``max_prompt_len`` (when
    set) is the hard cache-capacity bound a prompt may not exceed.
    ``pack=False`` (recurrent stacks) admits one request per row."""

    def __init__(self, max_len: int = 128, max_per_row: int = 4,
                 max_rows: int = 8, max_prompt_len: Optional[int] = None,
                 pack: bool = True):
        self.pack = pack
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
        """Put a request (a preempted continuation) back at the queue
        head, skipping :meth:`submit`'s length check: a continuation
        carries its generated tokens, and its admission proved they fit."""
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
        accepts, as admission groups in queue order: requests that
        ``probe`` reports a prefix hit for gather into shared groups (at
        most ``max_rows`` each), each prompt longer than ``max_len`` is its
        own chunked group (flushing the hits buffered before it), then one
        packed group of the short ones. A packing wider than ``max_rows``
        rows hands its last requests back to the queue head. With ``pack``
        off: one admission of up to ``min(free_slots, max_rows)`` requests,
        one row each, rows as wide as the longest prompt rounded up to a
        ``max_len`` multiple (no probe: sharing is off for such stacks)."""
        if not self.pack:
            reqs: List[Request] = []
            while (self.queue and len(reqs) < min(free_slots, self.max_rows)
                   and (reserve is None or reserve(self.queue[0]))):
                reqs.append(self.queue.pop(0))
            if not reqs:
                return []
            ml = self.policy.max_len
            width = max(-(-len(r.prompt) // ml) * ml for r in reqs)
            return [Admission(requests=reqs, row_width=width)]
        groups: List[Admission] = []
        shorts: List[Request] = []
        hits: List[Request] = []
        hit_ns: List[int] = []

        def flush_hits() -> None:
            if hits:
                groups.append(Admission(requests=list(hits),
                                        shared_prefix=max(hit_ns),
                                        shared_prefixes=list(hit_ns)))
                hits.clear()
                hit_ns.clear()

        taken = 0
        while (self.queue and taken < free_slots
               and (reserve is None or reserve(self.queue[0]))):
            req = self.queue[0]
            shared = probe(req) if probe is not None else 0
            if shared > 0:
                self.queue.pop(0)
                hits.append(req)
                hit_ns.append(shared)
                if len(hits) >= self.max_rows:
                    flush_hits()
            elif len(req.prompt) > self.policy.max_len:
                flush_hits()
                self.queue.pop(0)
                groups.append(Admission(
                    requests=[req],
                    chunks=chunk_prompt(req.prompt, self.policy.max_len)))
            else:
                shorts.append(self.queue.pop(0))
            taken += 1
        flush_hits()
        if shorts:
            packed = pack_requests([r.prompt for r in shorts], self.policy)
            while packed.rows > self.max_rows and len(shorts) > 1:
                self.queue.insert(0, shorts.pop())
                packed = pack_requests([r.prompt for r in shorts],
                                       self.policy)
            groups.append(Admission(requests=shorts, packed=packed))
        return groups

    def next_mixed(self, free_slots: int, reserve=None,
                   probe=None) -> List[Tuple[Request, int]]:
        """Pop up to ``free_slots`` queue-head requests that ``reserve``
        accepts (FIFO head-blocking), as ``(request, probe estimate)``
        pairs (0 without a ``probe``; the engine re-probes)."""
        out: List[Tuple[Request, int]] = []
        while (self.queue and len(out) < free_slots
               and (reserve is None or reserve(self.queue[0]))):
            req = self.queue.pop(0)
            out.append((req, probe(req) if probe is not None else 0))
        return out

    def next_batch(self) -> Optional[Dict]:
        """Drain-style batches (the absorbed ``DynamicBatcher`` API): the
        queue head's contiguous run of short prompts packed together (at
        most ``max_rows`` rows; ``packed`` a :class:`PackedBatch`), or a
        long head prompt alone (``packed`` None, its ``chunks``); None on
        an empty queue."""
        if not self.queue:
            return None
        if len(self.queue[0].prompt) > self.policy.max_len:
            adm = self.next_admissions(1)[0]
            return {"requests": adm.requests, "packed": None,
                    "chunks": adm.chunks, "utilization": adm.utilization}
        take: List[Request] = []
        limit = self.max_rows * self.policy.max_per_row
        while (self.queue and len(take) < limit
               and len(self.queue[0].prompt) <= self.policy.max_len):
            take.append(self.queue.pop(0))
        packed = pack_requests([r.prompt for r in take], self.policy)
        while packed.rows > self.max_rows and len(take) > 1:
            self.queue.insert(0, take.pop())
            packed = pack_requests([r.prompt for r in take], self.policy)
        util = float((packed.segment_ids > 0).mean())
        return {"requests": take, "packed": packed, "utilization": util}


# The absorbed DynamicBatcher's name, kept as an alias (submit/next_batch).
DynamicBatcher = Scheduler
