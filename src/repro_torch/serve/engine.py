"""Continuous-batching serving engine (``repro.serve.engine``, greedy).

Two engines share the slot table, the run loop and the accounting:

* the **mixed-step** engine (``mixed=True``, the default where the stack
  can take it: paged, unquantized lanes): every admitted prompt streams
  through per-step chunks of ONE fixed-shape mixed step, up to
  ``prefill_budget`` fresh prompt tokens per step (oldest admission
  first), packed with every active decode slot, each chunk's K/V written
  straight into the slot's paged lane (``Model.mixed_step``). A new
  request claims a free slot immediately; steps with nobody prefilling run
  the ``(B, 1)`` decode step.
* the **phase-serialized** engine (``mixed=False``, and the default for
  ``kv_quant`` or contiguous lanes): each admission round is one prefill
  sweep per admission group — short prompts packed into shared rows with
  segment ids (T-REX dynamic batching, :meth:`Scheduler.next_admissions`),
  each long prompt alone in ``max_len`` chunks — whose caches
  ``SlotKVCache.assign_many`` copies into the claimed lanes; every step
  after that is the ``(B, 1)`` decode step over contiguous (``paged=False``)
  or paged lanes, fp or int8 (``kv_quant``).

Finished requests (budget or ``eos_id``) release their slot (and pages),
and freed slots are refilled from the queue mid-decode.

What the reference does that the port refuses so far
(``EngineConfig.validate`` and here): preemption when the pool runs dry,
prefix sharing, sampling, faults, audits, meshes and fleets. Deadlines
(``ttl_steps``), load shedding (``max_pending``), never-admissible
rejection, the non-finite-logits guard and the no-progress watchdog are
kept, as are ``run(arrivals=...)``, the ``decode_stats`` counters and one
``stats`` entry per prefill sweep.

**Estimated HBM traffic** (``weight_bytes_per_token``,
``kv_bytes_per_token``, ``bytes_per_token``), as the reference reports it:
every step streams the whole weight set once — ``weight_stream_bits``
(the audited number from ``Model.compress_params``) or, when it is not
given, every leaf of the params as passed at its in-memory width — plus
the K/V of the blocks the predicated attention visits (int8 codes and
their f32 scales under ``kv_quant``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.errors import UnsupportedConfigError
from repro_torch.core.factorized import params_stream_bits
from repro_torch.kernels.common import resolve_decode_attn
from repro_torch.kernels.tda.ref import block_stats
from repro_torch.serve.config import EngineConfig
from repro_torch.serve.kv_slots import SlotKVCache
from repro_torch.serve.sampling import greedy_tokens
from repro_torch.serve.scheduler import (TERMINAL_STATUSES, Admission,
                                         Request, Scheduler)

__all__ = ["Engine", "EngineConfig", "StepResult"]


@dataclasses.dataclass
class StepResult:
    """One :meth:`Engine.step`: ``(request, token)`` events in emission
    order, the requests that became terminal, and the modeled device time
    after the step."""

    emitted: List[Tuple[Request, int]] = dataclasses.field(
        default_factory=list)
    finished: List[Request] = dataclasses.field(default_factory=list)
    device_time: int = 0


@dataclasses.dataclass
class _RunState:
    cur: np.ndarray       # next input token per slot
    emitted: np.ndarray   # tokens emitted so far per slot
    budget: np.ndarray    # per-slot output budget
    pending: List[Optional[np.ndarray]]  # un-prefilled prompt suffix
    done: List[Request] = dataclasses.field(default_factory=list)
    iters: int = 0
    steps: int = 0
    active_slot_steps: int = 0
    decoded_tokens: int = 0
    blocks_visited: int = 0
    blocks_dense: int = 0
    kv_bytes: float = 0.0
    pages_used_steps: int = 0
    mixed_steps: int = 0
    chunk_tokens: int = 0
    idle: int = 0
    step_ms: Dict[str, List[float]] = dataclasses.field(
        default_factory=lambda: {"decode": [], "mixed": [], "prefill": []})


class Engine:
    def __init__(self, model, params, config: Optional[EngineConfig] = None,
                 *, mesh=None, faults=None, fleet=None):
        for name, val, item in (("mesh", mesh, 11), ("faults", faults, 7),
                                ("fleet", fleet, 7)):
            if val is not None:
                raise UnsupportedConfigError(
                    f"Engine({name}=...) comes with a later slice of the "
                    f"port (ROADMAP Queue 1 item {item})")
        cfg_e = config if config is not None else EngineConfig()
        traits = cfg_e.validate(model.cfg)
        self.config = cfg_e
        self.device = model.device
        self.model = model
        self.max_len = cfg_e.max_len
        self.max_new = cfg_e.max_new_tokens
        self.num_slots = num_slots = cfg_e.num_slots
        self.eos_id = cfg_e.eos_id
        self.max_prompt_len = cfg_e.max_prompt_len or 2 * self.max_len
        self.cache_len = self.max_prompt_len + self.max_new
        self.scheduler = Scheduler(max_len=self.max_len,
                                   max_rows=cfg_e.max_rows,
                                   max_prompt_len=self.max_prompt_len)
        self.decode_attn = resolve_decode_attn(cfg_e.decode_attn, self.device)
        self._dmodel = model.with_decode_attn(self.decode_attn,
                                              cfg_e.decode_block_k)
        self._block_k = self._dmodel.cfg.decode_block_k
        # One page is one kv block of the predicated attention.
        self.paged = traits["paged"]
        self.page_size = (cfg_e.page_size or self._block_k) \
            if self.paged else None
        if self.paged:
            self._block_k = self.page_size
        self.slots = SlotKVCache(model, num_slots, self.cache_len,
                                 page_size=self.page_size,
                                 pool_frac=cfg_e.pool_frac,
                                 page_cap=cfg_e.page_cap)
        self.mixed = traits["mixed_ok"] if cfg_e.mixed is None \
            else bool(cfg_e.mixed)
        self.prefill_budget = cfg_e.prefill_budget
        self._chunk_width = max(1, min(self.max_len,
                                       cfg_e.prefill_budget or self.max_len))
        self._width = self.slots.width
        # Weights: every step streams the full weight set once, priced at
        # the audited `weight_stream_bits` or at the in-memory width of the
        # params as passed (before `prepare`'s compute-dtype copy).
        self._weight_stream_bits = (
            float(cfg_e.weight_stream_bits)
            if cfg_e.weight_stream_bits is not None
            else float(params_stream_bits(params)) if params is not None
            else 0.0)
        # KV: bytes per cached token the predicated attention visits (int8
        # codes + per-(token, head) f32 scales under kv_quant).
        c = model.cfg
        self._kv_token_bytes = (2 * c.kv_heads * (c.head_dim + 4)
                                if c.kv_quant else
                                2 * c.kv_heads * c.head_dim
                                * c.compute_dtype.itemsize)
        self.params = self._dmodel.prepare(params) if params is not None \
            else None
        self._admit_seq = np.zeros(num_slots, np.int64)
        self._seq = 0
        self.stats: List[Dict] = []  # one entry per prefill sweep
        self.decode_stats: Dict = {}
        self.max_pending = cfg_e.max_pending
        self.default_ttl = cfg_e.default_ttl_steps
        self.watchdog_patience = int(cfg_e.watchdog_patience)
        self._clock = 0
        self._device_time = 0
        self._counts: Dict[str, int] = {s: 0 for s in TERMINAL_STATUSES}
        self._terminal: List[Request] = []
        self._st: Optional[_RunState] = None
        self._events: Optional[List[Tuple[Request, int]]] = None

    # ------------------------------------------------------------------

    def submit(self, req: Request) -> None:
        """Queue a request: shed it when the pending queue is full
        (``max_pending``), reject it when its lane can never be allocated,
        raise ``ValueError`` when the prompt exceeds ``max_prompt_len``,
        and refuse per-request sampling."""
        sp = req.sampling
        if sp is not None and ((sp.temperature or 0.0) > 0 or sp.top_k):
            raise UnsupportedConfigError(
                "per-request sampling comes with a later slice of the port "
                "(ROADMAP Queue 1 item 7); this slice decodes greedily")
        if (self.max_pending is not None
                and self.scheduler.pending() >= self.max_pending):
            self._finish_terminal(
                req, "shed",
                f"pending queue full ({self.scheduler.pending()} queued >= "
                f"max_pending={self.max_pending})")
            return
        pool = self.slots.pool
        for w, need in (pool.class_needs(len(req.prompt) + 1).items()
                        if self.paged else ()):
            cap = pool.classes[w].num_pages
            if need > cap:
                self._finish_terminal(
                    req, "rejected",
                    f"never admissible: prompt ({len(req.prompt)} tokens) "
                    f"needs {need} width-{w} pages but the pool holds {cap}")
                return
        try:
            self.scheduler.submit(req)
        except ValueError as e:
            req.status = "rejected"
            req.status_reason = str(e)
            raise
        req._submit_clock = self._clock  # type: ignore[attr-defined]
        req._submit_dev = self._device_time  # type: ignore[attr-defined]
        req._submit_wall = time.perf_counter()  # type: ignore[attr-defined]

    def run(self, arrivals: Optional[Sequence[Tuple[int, Request]]] = None
            ) -> List[Request]:
        """Serve until queue and slots are empty; returns the finished
        requests in completion order. ``arrivals`` are ``(tick, Request)``
        pairs submitted when the iteration count reaches ``tick``."""
        if self._st is not None:
            raise RuntimeError("a stepping session is already in flight")
        arr = sorted(arrivals or [], key=lambda a: a[0])
        ai = 0
        st = self._session()
        while (self.scheduler.pending() or self.slots.active.any()
               or ai < len(arr)):
            due: List[Request] = []
            while ai < len(arr) and arr[ai][0] <= st.iters + 1:
                due.append(arr[ai][1])
                ai += 1
            self.step(submits=due)
        return self.finish_run()

    def has_work(self) -> bool:
        return bool(self.scheduler.pending() or self.slots.active.any())

    def _session(self) -> _RunState:
        if self._st is None:
            n = self.num_slots
            st = _RunState(cur=np.zeros(n, np.int32),
                           emitted=np.zeros(n, np.int32),
                           budget=np.zeros(n, np.int32), pending=[None] * n)
            st.done.extend(self._terminal)
            self._terminal.clear()
            self._st = st
        return self._st

    def _emit(self, req: Request, tok: int) -> None:
        req.output.append(int(tok))
        if self._events is not None:
            self._events.append((req, int(tok)))

    def _step_result(self, res: StepResult, n_done0: int) -> StepResult:
        res.finished = self._st.done[n_done0:]
        res.device_time = self._device_time
        return res

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def step(self, submits: Sequence[Request] = ()) -> StepResult:
        """ONE engine iteration — admit, one mixed or decode dispatch,
        retire. ``submits`` are submitted after this step's clock tick."""
        st = self._session()
        sl = self.slots
        cur, emitted, budget, pending = st.cur, st.emitted, st.budget, \
            st.pending
        done = st.done
        res = StepResult()
        self._events = res.emitted
        n_done0 = len(done)
        try:
            self._clock += 1
            st.iters += 1
            for r in submits:
                self.submit(r)
            if self._terminal:
                done.extend(self._terminal)
                self._terminal.clear()
            progressed = self._expire(done) > 0
            if self.paged:
                self._ensure_pages()
            for s in range(self.num_slots):
                if not sl.active[s]:
                    pending[s] = None
            if self.scheduler.pending():
                free = sl.free_slots()
                if free.size:
                    n_done = len(done)
                    if self.mixed:
                        admitted = self._admit_mixed(free, cur, emitted,
                                                     budget, pending, done)
                    else:
                        admitted = self._admit(free, cur, emitted, budget,
                                               done)
                    progressed |= admitted > 0 or len(done) > n_done
            active_ix = np.flatnonzero(sl.active)
            if active_ix.size == 0:
                if progressed:
                    st.idle = 0
                else:
                    st.idle += 1
                    if st.idle > self.watchdog_patience:
                        self._watchdog_escalate(done)
                        st.idle = 0
                return self._step_result(res, n_done0)
            st.idle = 0
            if any(pending[s] is not None for s in active_ix):
                self._mixed_step(st, active_ix)
            else:
                self._decode_step(st, active_ix)
            return self._step_result(res, n_done0)
        finally:
            self._events = None

    def _pages_arg(self) -> Optional[Dict]:
        if not self.paged:
            return None
        bt = self.slots.pool.device_tables()[self._width][:self.num_slots]
        return {"bt": bt, "width": self._width, "page_size": self.page_size}

    def _count_blocks(self, st: _RunState, hi: np.ndarray) -> None:
        bs = block_stats(np.where(self.slots.active,
                                  np.minimum(hi, self._width), 0),
                         self._width, min(self._block_k, self._width))
        st.blocks_visited += bs["visited"]
        st.blocks_dense += bs["dense"]
        # visited blocks x tokens per block, once per attention layer
        st.kv_bytes += (bs["visited"] * min(self._block_k, self._width)
                        * self.model.cfg.n_layers * self._kv_token_bytes)

    def _mixed_step(self, st: _RunState, active_ix: np.ndarray) -> None:
        """Pack up to ``prefill_budget`` fresh prompt tokens (chunk rows,
        oldest admission first) with every decode slot in one step."""
        sl = self.slots
        pending, cur, emitted, budget = st.pending, st.cur, st.emitted, \
            st.budget
        S = self._chunk_width
        left = self.prefill_budget
        n_new = np.zeros(self.num_slots, np.int32)
        order = sorted(active_ix, key=lambda s: self._admit_seq[s])
        for s in order:
            if pending[s] is None:
                n_new[s] = 1  # decode row
            else:
                c = min(len(pending[s]), S)
                if left is not None:
                    c = min(c, left)
                    left -= c
                n_new[s] = c
        for s in order:
            if pending[s] is not None and n_new[s] > 0:
                self._grow_span(int(s), int(sl.lengths[s]) + int(n_new[s]))
        n_new = np.where(sl.active, n_new, 0).astype(np.int32)
        toks = np.zeros((self.num_slots, S), np.int32)
        for s in active_ix:
            if pending[s] is not None:
                c = int(n_new[s])
                toks[s, :c] = pending[s][:c]
            else:
                toks[s, 0] = cur[s]
        self._count_blocks(st, sl.lengths + n_new)
        t0 = time.perf_counter()
        nxt = self._run_mixed(toks, n_new)
        st.step_ms["mixed"].append((time.perf_counter() - t0) * 1e3)
        self._device_time += self._chunk_width
        st.steps += 1
        st.mixed_steps += 1
        st.active_slot_steps += active_ix.size
        st.pages_used_steps += sl.pool.pages_in_use()
        for s in active_ix:
            tok = int(nxt[s])
            req = sl.request[s]
            if tok < 0:
                sl.release(int(s))
                pending[s] = None
                self._finish(req, "failed", "non-finite logits (NaN/Inf) in "
                             "the mixed step", st.done)
                continue
            if pending[s] is not None:
                c = int(n_new[s])
                if c <= 0:
                    continue  # budget-starved: nothing this step
                sl.advance_n(int(s), c)
                st.chunk_tokens += c
                rest = pending[s][c:]
                if len(rest):
                    pending[s] = rest  # still mid-prefill
                    continue
                # Prefill complete: ``tok`` is the request's first token.
                pending[s] = None
                self._emit(req, tok)
                self._note_ttft(req)
                emitted[s] = len(req.output)
                cur[s] = tok
                if emitted[s] >= budget[s] or tok == self.eos_id:
                    self._finish(req, "ok", None, st.done)
                    sl.release(int(s))
                continue
            sl.advance(s)
            self._emit(req, tok)
            emitted[s] += 1
            cur[s] = tok
            st.decoded_tokens += 1
            if emitted[s] >= budget[s] or tok == self.eos_id:
                self._finish(req, "ok", None, st.done)
                sl.release(s)

    def _decode_step(self, st: _RunState, active_ix: np.ndarray) -> None:
        sl = self.slots
        self._count_blocks(st, sl.lengths + 1)
        t0 = time.perf_counter()
        nxt = self._run_decode(st.cur)
        st.step_ms["decode"].append((time.perf_counter() - t0) * 1e3)
        self._device_time += 1
        st.steps += 1
        st.active_slot_steps += active_ix.size
        if self.paged:
            st.pages_used_steps += sl.pool.pages_in_use()
        for s in active_ix:
            sl.advance(s)
            tok = int(nxt[s])
            req = sl.request[s]
            if tok < 0:
                sl.release(s)
                self._finish(req, "failed", "non-finite logits (NaN/Inf) in "
                             "the decode step", st.done)
                continue
            self._emit(req, tok)
            st.emitted[s] += 1
            st.cur[s] = tok
            st.decoded_tokens += 1
            if st.emitted[s] >= st.budget[s] or tok == self.eos_id:
                self._finish(req, "ok", None, st.done)
                sl.release(s)

    @torch.inference_mode()
    def _run_mixed(self, toks: np.ndarray, n_new: np.ndarray) -> np.ndarray:
        """The mixed step on the device; the emitted token of row b comes
        from chunk column ``n_new - 1`` (clamped: inert rows read column 0
        and the host ignores it). Returns the (B,) tokens on the host."""
        sl = self.slots
        nn = self._tensor(n_new)
        h, sl.caches = self._dmodel.mixed_hidden(
            self.params, {"inputs": self._tensor(toks)}, sl.caches,
            self._tensor(sl.lengths), nn,
            slot_mask=self._tensor(sl.active), pages=self._pages_arg())
        last = torch.clamp(nn.long() - 1, 0, toks.shape[1] - 1)
        row = h[torch.arange(h.shape[0], device=h.device), last]
        logits = self._dmodel.logits(self.params, row)
        return greedy_tokens(logits).cpu().numpy()  # the step's host sync

    @torch.inference_mode()
    def _run_decode(self, cur: np.ndarray) -> np.ndarray:
        sl = self.slots
        logits, sl.caches = self._dmodel.decode_step(
            self.params, {"inputs": self._tensor(cur[:, None])}, sl.caches,
            self._tensor(sl.lengths), slot_mask=self._tensor(sl.active),
            pages=self._pages_arg())
        return greedy_tokens(logits[:, 0]).cpu().numpy()

    def finish_run(self) -> List[Request]:
        """Close the session: build ``decode_stats``, reset the session
        state, return every terminal request in completion order."""
        st = self._session()
        sl = self.slots
        done = st.done
        self.decode_stats = {
            "steps": st.steps,
            "decoded_tokens": st.decoded_tokens,
            "slot_utilization": (st.active_slot_steps
                                 / max(st.steps * self.num_slots, 1)),
            "kv_blocks_visited": st.blocks_visited,
            "kv_blocks_dense": st.blocks_dense,
            "kv_block_ratio": st.blocks_visited / max(st.blocks_dense, 1),
            "paged": self.paged,
            "preemptions": 0,
            # contiguous lanes hold everything up front: ratio 1.0
            "kv_pages_total": sl.pool.total_pages if self.paged else 0,
            "kv_memory_ratio": (st.pages_used_steps
                                / max(st.steps * sl.pool.total_pages, 1)
                                if self.paged else 1.0),
            # Estimated HBM bytes per decoded token: the weights streamed
            # once per step plus the KV blocks actually visited.
            "weight_format": self.model.cfg.weight_format,
            "weight_bytes_per_step": self._weight_stream_bits / 8.0,
            "weight_bytes_per_token": (st.steps
                                       * self._weight_stream_bits / 8.0
                                       / max(st.decoded_tokens, 1)),
            "kv_bytes_per_token": st.kv_bytes / max(st.decoded_tokens, 1),
            "tp_ranks": 1,
            "kv_bytes_per_token_per_rank": (st.kv_bytes
                                            / max(st.decoded_tokens, 1)),
            "bytes_per_token": ((st.steps * self._weight_stream_bits / 8.0
                                 + st.kv_bytes)
                                / max(st.decoded_tokens, 1)),
            "status_counts": dict(self._counts),
            "completed_ok": self._counts["ok"],
            "clock_ticks": self._clock,
            "device_time": self._device_time,
            "mixed": self.mixed,
            "prefill_budget": self.prefill_budget,
            "mixed_steps": st.mixed_steps,
            "prefill_chunk_tokens": st.chunk_tokens,
            "step_ms": {k: list(v) for k, v in st.step_ms.items()},
            "ttft": {
                r.rid: {"wall_s": float(r._ttft_wall),
                        "clock": int(r._ttft_clock),
                        "device_tokens": int(r._ttft_dev),
                        "first_token_clock": int(r._first_token_clock)}
                for r in done if hasattr(r, "_ttft_wall")},
        }
        self._counts = {s: 0 for s in TERMINAL_STATUSES}
        self._st = None
        return done

    # ------------------------------------------------------------------

    def _ensure_pages(self) -> None:
        """Make every active slot's next write position resident (oldest
        request first). A dry pool would need preemption, which this slice
        does not port: raise instead of serving wrong."""
        sl, pool = self.slots, self.slots.pool
        for s in sorted(np.flatnonzero(sl.active),
                        key=lambda s: self._admit_seq[s]):
            if not pool.ensure_write(int(s), int(sl.lengths[s])):
                raise UnsupportedConfigError(
                    "the page pool ran dry mid-decode; preemption comes with "
                    "a later slice of the port (ROADMAP Queue 1 item 7) — "
                    "serve with pool_frac=1.0 (the default)")

    def _grow_span(self, s: int, end: int) -> None:
        """Make lane positions ``[lengths[s], end)`` writable for a chunk
        scatter; a dry pool raises (see :meth:`_ensure_pages`)."""
        pool = self.slots.pool
        end = min(end, self.cache_len)
        try:
            pool.alloc_prefix(s, end)
            pool.make_range_writable(s, int(self.slots.lengths[s]), end)
        except RuntimeError as e:
            raise UnsupportedConfigError(
                f"the page pool cannot hold a prefill chunk ({e}); "
                "preemption and chunk deferral come with a later slice of "
                "the port (ROADMAP Queue 1 item 7)") from e

    def _note_ttft(self, req: Request) -> None:
        if len(req.output) != 1 or hasattr(req, "_ttft_wall"):
            return
        now = time.perf_counter()
        req._ttft_wall = now - getattr(req, "_submit_wall", now)
        req._ttft_clock = self._clock - getattr(req, "_submit_clock",
                                                self._clock)
        req._first_token_clock = self._clock
        req._ttft_dev = self._device_time - getattr(req, "_submit_dev",
                                                    self._device_time)

    def _page_reserve(self, chunk: Optional[int] = None):
        """Admission control over the page budget: a request reserves the
        pages of its prompt's span plus one position — for the mixed step
        (``chunk``) only its first chunk's span — with FIFO head-blocking
        once the budget would overcommit."""
        pool = self.slots.pool
        ps = pool.page_size
        avail = {w: c.available() for w, c in pool.classes.items()}

        def reserve(req: Request) -> bool:
            span = len(req.prompt) if chunk is None \
                else min(len(req.prompt), chunk)
            consume = {w: -(-min(span + 1, c.width) // ps)
                       for w, c in pool.classes.items()}
            if any(n > avail[w] for w, n in consume.items()):
                return False
            for w, n in consume.items():
                avail[w] -= n
            return True

        return reserve

    def _admit_mixed(self, free: np.ndarray, cur, emitted, budget, pending,
                     done: List[Request]) -> int:
        """Claim a free slot per admitted request and stage its prompt in
        ``pending`` for the chunk scheduler."""
        pool = self.slots.pool
        adms = self.scheduler.next_mixed(
            len(free), reserve=self._page_reserve(self._chunk_width))
        fi = 0
        n_processed = 0
        for req in adms:
            n_processed += 1
            total_budget = min(req.max_new_tokens, self.max_new)
            if len(req.output) >= total_budget:
                self._finish(req, "ok", None, done)
                continue
            slot = int(free[fi])
            fi += 1
            self.slots.claim(slot, req, 0)
            try:
                pool.alloc_prefix(slot, min(1, self.cache_len))
            except RuntimeError:
                self.slots.release(slot)
                self.scheduler.requeue(req)
                break
            pending[slot] = np.asarray(req.prompt, np.int32)
            cur[slot] = 0
            emitted[slot] = len(req.output)
            budget[slot] = total_budget
            self._admit_seq[slot] = self._seq
            self._seq += 1
        if n_processed:
            # One entry per admission round: chunk rows carry no padding
            # (rows=0 flags the sweepless mixed path).
            self.stats.append({"rows": 0, "n_requests": n_processed,
                               "utilization": 1.0})
        return n_processed

    def _admit(self, free: np.ndarray, cur, emitted, budget,
               done: List[Request]) -> int:
        """Prefill one round of admissions into the free slots (one sweep
        per admission group, each group's lanes in one ``assign_many``);
        returns the number of requests processed. With paged lanes the
        run loop grows active lanes before admitting and ``assign_many``
        holds each new lane's first decode page, so an admitted request
        always reaches its first decode step."""
        groups = self.scheduler.next_admissions(
            len(free), reserve=self._page_reserve() if self.paged else None)
        fi = 0
        n_processed = 0
        for adm in groups:
            n_processed += len(adm.requests)
            firsts, caches, slots_of = self._prefill_admission(adm)
            assigns = []
            for req, first, (row, start, length) in zip(adm.requests,
                                                        firsts, slots_of):
                total_budget = min(req.max_new_tokens, self.max_new)
                if len(req.output) >= total_budget:
                    self._finish(req, "ok", None, done)  # nothing left
                    continue
                first = int(first)
                if first < 0:
                    self._finish(req, "failed", "non-finite logits (NaN/Inf) "
                                 "in the prefill sweep", done)
                    continue
                self._emit(req, first)
                self._note_ttft(req)
                if len(req.output) >= total_budget or first == self.eos_id:
                    self._finish(req, "ok", None, done)  # slot stays free
                    continue
                slot = int(free[fi])
                fi += 1
                assigns.append((slot, req, row, start, length))
                cur[slot] = first
                emitted[slot] = len(req.output)
                budget[slot] = total_budget
                self._admit_seq[slot] = self._seq
                self._seq += 1
            self.slots.assign_many(assigns, caches)
        return n_processed

    @torch.inference_mode()
    def _prefill_admission(self, adm: Admission):
        """One prefill sweep: returns ``(first tokens (n,) on the host,
        filled caches (L, rows, width, ...), per-request (row, start,
        length))``. Packed rows are padded to a power of two (padding rows
        ride segment id 0, fully masked), as the reference bounds its
        compiled shapes. Logits are taken only at each request's last
        prompt position."""
        if adm.packed is not None:
            packed = adm.packed
            rows = packed.rows
            pad = ((0, (1 << (rows - 1).bit_length()) - rows), (0, 0))
            tokens, positions, seg = (np.pad(a, pad) for a in (
                packed.tokens, packed.positions, packed.segment_ids))
            slots_of = list(packed.request_slots)
        else:  # solo long prompt, chunked
            prompt = np.concatenate(adm.chunks)
            width = len(adm.chunks) * self.max_len
            n = len(prompt)
            tokens = np.zeros((1, width), np.int32)
            seg = np.zeros((1, width), np.int32)
            tokens[0, :n] = prompt
            seg[0, :n] = 1
            positions = np.arange(width, dtype=np.int32)[None]
            slots_of = [(0, 0, n)]
            rows = 1
        t0 = time.perf_counter()
        caches = self._dmodel.init_cache(*tokens.shape)
        h, caches = self._dmodel.hidden(
            self.params, {"inputs": self._tensor(tokens),
                          "positions": self._tensor(positions),
                          "seg_ids": self._tensor(seg)}, caches=caches)
        last = np.array([[r, s + n - 1] for r, s, n in slots_of], np.int64)
        logits = self._dmodel.logits(self.params, h[self._tensor(last[:, 0]),
                                                    self._tensor(last[:, 1])])
        firsts = greedy_tokens(logits).cpu().numpy()  # the sweep's host sync
        self._st.step_ms["prefill"].append((time.perf_counter() - t0) * 1e3)
        self._device_time += int(tokens.shape[1])
        self.stats.append({"rows": rows, "n_requests": len(adm.requests),
                           "utilization": adm.utilization})
        return firsts, caches, slots_of

    def _finish(self, req: Request, status: str, reason: Optional[str],
                done: List[Request]) -> None:
        req.status = status
        req.status_reason = reason
        self._counts[status] += 1
        done.append(req)

    def _finish_terminal(self, req: Request, status: str,
                         reason: str) -> None:
        req.status = status
        req.status_reason = reason
        self._counts[status] += 1
        self._terminal.append(req)

    def _expire(self, done: List[Request]) -> int:
        """Expire queued and in-flight requests whose deadline (virtual
        clock ticks since submission) has passed."""
        def expired(req: Request) -> bool:
            ttl = req.ttl_steps if req.ttl_steps is not None \
                else self.default_ttl
            return ttl is not None and \
                self._clock > getattr(req, "_submit_clock", 0) + int(ttl)

        n = 0
        for req in self.scheduler.drop_where(expired):
            self._finish(req, "timed_out", f"deadline exceeded in queue at "
                         f"clock tick {self._clock}", done)
            n += 1
        for s in np.flatnonzero(self.slots.active):
            req = self.slots.request[s]
            if expired(req):
                self.slots.release(int(s))
                self._finish(req, "timed_out", f"deadline exceeded in-flight "
                             f"at clock tick {self._clock}", done)
                n += 1
        return n

    def _watchdog_escalate(self, done: List[Request]) -> None:
        """Fail the queue head after ``watchdog_patience`` consecutive idle
        iterations, so a run can never spin forever."""
        if not self.scheduler.queue:
            return
        req = self.scheduler.queue.pop(0)
        self._finish(req, "failed", "no-progress watchdog: queue head still "
                     f"not admitted after {self.watchdog_patience} "
                     "consecutive idle iterations", done)
