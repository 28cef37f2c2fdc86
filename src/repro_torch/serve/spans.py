"""The serving engine's spans: one process-wide recorder of closed spans
in a bounded ring, stamped on the wall clock (``time.time_ns``), which is
the clock of ``torch.profiler``'s (kineto's) timeline, so a host span and
the device activity it enqueued line up without a conversion. That clock
is not monotonic: a length is right only while the system clock is not
stepped (set by hand, or by NTP outside its slew) during the span.

A span is ``(sid, name, start_ns, end_ns, parent, step, rid, attrs)``:
``parent`` is the enclosing span's ``sid`` (-1 for none), ``step`` the
engine's iteration count when the span opened, ``rid`` the submitted
request's id (-1 on step-level spans) and ``attrs`` a small dict or None.
A span is written when it closes, so the ring holds spans in the order they
ended; an open span is in no read.

What :class:`~repro_torch.serve.engine.Engine` records:

* ``step`` with children ``expire``, ``grow``, ``admit``, ``dispatch``
  (attr ``kind``: decode, mixed or prefill; a mixed one also ``cols``, the
  columns its linears ran over, and ``live``, its fresh tokens) and
  ``retire``; a
  ``dispatch`` holds ``upload`` (host arrays and block tables to the
  device), ``model`` (the launches of the model call), ``choose`` (the
  sampler's launches) and ``sync`` (the copy of the tokens to the host). The serialized engine's prefill sweep is a
  ``dispatch`` of kind prefill inside ``admit``.
* per request, parent -1: ``queued`` (submit to the slot claim; the
  serialized engine: to the prefill sweep that takes it), ``prefill`` (to
  the token that ends its prompt; attr ``first`` 1 on the request's first
  token) and ``decode`` (to the terminal status). A terminal close carries
  ``status``; a preemption closes the open span and opens ``queued`` again
  under the same rid.

The engine steps in one thread at a time; the recorder takes no lock.
"""
from __future__ import annotations

import time
from typing import Dict, List, NamedTuple, Optional, Tuple

__all__ = ["Span", "Records", "Recorder", "Token", "RECORDER", "SIZE",
           "begin", "end", "switch", "records"]

# Records the ring holds. A decode or mixed step closes ten or eleven
# step-level spans (step, expire, one or two grow, admit, dispatch and its
# four phases, retire) and a request three or more in all, so this holds
# the last ~3 000 steps with their requests: a minute of steps of 20 ms or
# longer.
SIZE = 1 << 15

_now = time.time_ns

# An open span: (sid, name, parent, step, rid, start_ns).
Token = Tuple[int, str, int, int, int, int]


class Span(NamedTuple):
    sid: int
    name: str
    start_ns: int
    end_ns: int
    parent: int
    step: int
    rid: int
    attrs: Optional[Dict]


class Records(NamedTuple):
    spans: List[Span]   # closed spans overlapping the range, in close order
    overwritten: int    # records the ring has overwritten, all told
    complete: bool      # no overwritten record ended inside the range


class Recorder:
    """A ring of ``size`` closed spans. :meth:`begin` hands out a token
    (the span's id and start); :meth:`end` stamps the end and writes the
    record over the oldest once the ring is full."""

    def __init__(self, size: int = SIZE):
        self.size = size
        self._ring: List[Optional[tuple]] = [None] * size
        self._written = 0
        self._next_sid = 0
        self._lost_end = -1  # end of the last record overwritten

    def begin(self, name: str, parent: int = -1, step: int = -1,
              rid: int = -1, t: Optional[int] = None) -> Token:
        sid = self._next_sid
        self._next_sid = sid + 1
        return (sid, name, parent, step, rid, _now() if t is None else t)

    def end(self, tok: Token, attrs: Optional[Dict] = None,
            t: Optional[int] = None) -> int:
        """Close ``tok`` at ``t`` (now by default); returns the end
        stamp."""
        if t is None:
            t = _now()
        i = self._written
        self._written = i + 1
        j = i % self.size
        if i >= self.size:
            self._lost_end = self._ring[j][3]
        self._ring[j] = (tok[0], tok[1], tok[5], t, tok[2], tok[3], tok[4],
                         attrs)
        return t

    def switch(self, tok: Token, name: str,
               attrs: Optional[Dict] = None) -> Token:
        """Close ``tok`` and open its next sibling ``name`` on one stamp."""
        return self.begin(name, tok[2], tok[3], tok[4], self.end(tok, attrs))

    def records(self, lo_ns: int, hi_ns: int) -> Records:
        """The closed spans overlapping ``[lo_ns, hi_ns]``. ``complete`` is
        False when a record the ring overwrote may have overlapped it:
        records are written in the order spans end, so no overwritten
        record ended after the last of them."""
        n, size = self._written, self.size
        if n <= size:
            kept = self._ring[:n]
            lost = 0
        else:
            k = n % size
            kept = self._ring[k:] + self._ring[:k]
            lost = n - size
        complete = self._lost_end < lo_ns
        return Records([Span(*r) for r in kept
                        if r[2] <= hi_ns and r[3] >= lo_ns], lost, complete)


RECORDER = Recorder()
begin = RECORDER.begin
end = RECORDER.end
switch = RECORDER.switch
records = RECORDER.records
