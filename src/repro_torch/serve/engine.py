"""Continuous-batching serving engine (``repro.serve.engine``).

Two engines share the slot table, the run loop and the accounting:

* the **mixed-step** engine (``mixed=True``, the default where the stack
  can take it: paged, unquantized lanes): every admitted prompt streams
  through per-step chunks of one mixed step, up to ``prefill_budget``
  fresh prompt tokens per step (oldest admission first), packed with
  every active decode slot, each chunk's K/V written straight into the
  slot's paged lane (``Model.mixed_hidden``). The step's linears, norms
  and FFN run over its fresh tokens alone, ``Σ n_new`` columns; a routed
  (MoE) stack's over the whole ``num_slots x chunk`` grid, whose dead
  columns take expert capacity as in the reference. A new request claims
  a free slot immediately; steps with nobody prefilling run the ``(B, 1)``
  decode step.
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

**Preemption.** Paged lanes grow a page at a time. When the pool runs
dry, the youngest active request is preempted and requeued at the queue
head as a continuation (prompt + tokens so far, ``_origin`` pointing at
the submitted request), whose resumed greedy decode is token-identical
to an uninterrupted run; a mixed-step chunk whose slot is itself the
youngest is deferred a step instead. ``max_preemptions`` (per request,
or the engine's ``max_preemptions_per_request``) fails a request stuck
in an admit-preempt cycle.

**Prefix sharing** (paged lanes, ``prefix_share``, on by default): a
prompt whose page-aligned leading tokens are in the pool's prefix index
(a system prompt, a duplicate, a continuation resuming over its own
published pages) maps those pages into its lane and computes and writes
only the rest: the mixed engine streams only the suffix, the serialized
engine runs one suffix prefill that attends the prefix gathered out of
the pool (``Model.hidden(prefix_kv=...)``). Copy-on-write keeps sharing
invisible: a write that would land in a shared page copies it first.
``decode_stats`` reports ``prefix_hit_ratio`` (prompt tokens served from
shared pages over prompt tokens admitted) and ``pages_shared``.

**Sampling** (``serve/sampling.py``): each slot carries the seed,
temperature and top-k resolved at admission (``SamplingParams.seed`` >
``Request.seed`` > ``seed + rid``); a step whose active slots are all
greedy runs the plain argmax and nothing else, otherwise the batch sampler
draws at the token's absolute position (decode: ``lengths + 1``; mixed:
``lengths + n_new``; a prefill's first token: the prompt length), so a
preempted continuation draws what it would have drawn uninterrupted.

**Failure hardening**, as the reference's: deadlines (``ttl_steps`` on a
virtual clock), load shedding (``max_pending``), never-admissible
rejection, ``cancel``, the non-finite-logits guard (a row reports ``-1``
and its request alone fails), the no-progress watchdog, the seeded chaos
harness (``faults=``: a :class:`~repro_torch.serve.faults.FaultPlan`
replayed by a fresh injector each session, or an injector used as is;
allocation failures at every page request, forced youngest-first
preemption, NaN logits written on the device after the model and before
the sampler, stall ticks on the clock) and opt-in per-step audits
(``audit``, default from ``REPRO_SERVE_AUDIT``).

**Fleet** (``fleet=`` or :meth:`Engine.attach_fleet`, which
``serve/dispatch.py`` calls): a
:class:`~repro_torch.serve.pages.FleetPrefixIndex` shared by replicas;
publishes mirror full prefix pages to its host tier, probes restore
fleet-only pages into the local pool first.

**Tensor parallelism** (``mesh=``, one rank's
:class:`~repro_torch.launch.mesh.Mesh` of a ``(1, N)`` grid, each rank
its own process: ``launch.mesh.run_ranks``): every rank builds the same
Engine over its slice of the weights (``Model.prepare``) and its ``Hkv /
N`` heads of every lane and page, and runs the same host schedule — the
scheduler, the page pool, the fault plan and the sampling keys are host
state that every rank computes from the same inputs, and every rank ends
each step with the same logits (the vocabulary blocks gathered by an
``all_gather``), so every rank picks the same tokens. The reference's
contract holds: token identity with ``mesh=None`` at float32.
``decode_stats`` reports ``tp_ranks`` and the K/V bytes each rank
streams; audits check each rank's view of the pool and compare the
ranks' host state with one ``all_reduce``; the fleet refuses a mesh, as
the reference's does.

**Recurrent stacks** (mamba2, recurrentgemma): the phase-serialized
engine (no recurrent block has a multi-token decode form), admitting one
request per prefill row, right-aligned (``Scheduler(pack=False)``,
:meth:`Engine._rows_batch`), so each row's end state is its request's;
``assign_many`` copies the states into the slot's ``"state"`` lanes.
Only the attention layers' lanes page (recurrentgemma's local layers, a
ring of the window); mamba2 is never paged. Prefix sharing stays off:
a recurrent layer's end-of-prefix state is not content-addressable.

**Sliding-window stacks** (starcoder2): each attention lane is a ring of
``min(window, cache_len)`` positions in canonical ring phase; prefill
sweeps fill full-length caches (``init_cache(..., ring=False)``) so the
lane gather can address every row position. A ring lane that wraps into
a shared page copies it first (copy-on-write), and a prompt longer than
its ring neither shares, publishes nor restores fleet pages: its lane is
not a function of the prompt's prefix.

**Spans** (``serve/spans.py``, always on): each :meth:`Engine.step` records
a ``step`` span and its phases (``expire``, ``grow``, ``admit``,
``dispatch`` with ``upload``, ``model``, ``choose`` and ``sync``,
``retire``; a mixed ``dispatch`` carries ``cols``, the columns its linears
ran over, and ``live``, its fresh tokens), each request its ``queued``,
``prefill`` and ``decode`` spans, on the wall clock of the profiler's
timeline. ``decode_stats``' ``step_ms`` are the ``dispatch`` spans'
lengths and its ``ttft`` ``wall_s`` runs from the ``queued`` span's start
(the call of ``submit``) to the first ``decode`` span's; a step of the
system clock during the run distorts both, and :meth:`Engine.finish_run`
warns when one reads negative.

**Construction**: ``Engine(model, params, config=EngineConfig(...))``; the
reference's legacy per-knob keyword arguments (``Engine(model, params,
max_len=64)``) still build the same ``EngineConfig`` behind a one-time
``DeprecationWarning``, and ``TypeError`` when mixed with ``config=`` or
unknown.

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
import hashlib
import os
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.errors import AuditError, UnsupportedConfigError
from repro_torch.core.factorized import params_stream_bits
from repro_torch.core.packing import chunk_prompt
from repro_torch.kernels.common import resolve_decode_attn
from repro_torch.kernels.tda.ref import block_stats
from repro_torch.launch.mesh import tensor_parallel_size
from repro_torch.serve import spans
from repro_torch.serve.config import EngineConfig
from repro_torch.serve.kv_slots import SlotKVCache
from repro_torch.serve.faults import FaultInjector, FaultPlan
from repro_torch.serve.pages import PrefixHit, prefix_digests
from repro_torch.serve.sampling import sample_or_greedy
from repro_torch.serve.scheduler import (TERMINAL_STATUSES, Admission,
                                         Request, Scheduler)

__all__ = ["Engine", "EngineConfig", "StepResult"]


# The legacy per-knob construction surface warns once per process.
_LEGACY_KWARGS_WARNED = False


def _resolve_engine_config(config: Optional[EngineConfig],
                           legacy: Dict) -> EngineConfig:
    """``config``, or an ``EngineConfig`` of the legacy per-knob kwargs
    (never both; unknown names raise ``TypeError``), as the reference's
    ``_resolve_engine_config``."""
    global _LEGACY_KWARGS_WARNED
    if not legacy:
        return config if config is not None else EngineConfig()
    if config is not None:
        raise TypeError(
            "pass either config=EngineConfig(...) or the legacy per-knob "
            f"kwargs, not both (got config plus {sorted(legacy)})")
    names = {f.name for f in dataclasses.fields(EngineConfig)}
    unknown = sorted(set(legacy) - names)
    if unknown:
        raise TypeError(f"Engine() got unexpected keyword arguments "
                        f"{unknown}; see EngineConfig for the serving "
                        "knobs (mesh/faults/fleet stay Engine kwargs)")
    if not _LEGACY_KWARGS_WARNED:
        warnings.warn(
            "Engine's per-knob kwargs are deprecated; pass "
            "config=EngineConfig(...) instead", DeprecationWarning,
            stacklevel=3)
        _LEGACY_KWARGS_WARNED = True
    return EngineConfig(**legacy)


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
    pending_full: List[Optional[np.ndarray]]  # the admitted prompt
    done: List[Request] = dataclasses.field(default_factory=list)
    iters: int = 0
    steps: int = 0
    active_slot_steps: int = 0
    decoded_tokens: int = 0
    blocks_visited: int = 0
    blocks_dense: int = 0
    kv_bytes: float = 0.0
    preemptions: int = 0
    preempt_recovered: int = 0
    pages_used_steps: int = 0
    mixed_steps: int = 0
    chunk_tokens: int = 0
    idle: int = 0
    step_ms: Dict[str, List[float]] = dataclasses.field(
        default_factory=lambda: {"decode": [], "mixed": [], "prefill": []})


class Engine:
    def __init__(self, model, params, config: Optional[EngineConfig] = None,
                 *, mesh=None, faults=None, fleet=None, **legacy):
        cfg_e = _resolve_engine_config(config, legacy)
        traits = cfg_e.validate(model.cfg, mesh)
        self.mesh = mesh
        self._tp = tensor_parallel_size(mesh)
        self._rank = mesh.coords["model"] if self._tp > 1 else 0
        self.config = cfg_e
        self.device = model.device
        self.model = model
        self.max_len = cfg_e.max_len
        self.max_new = cfg_e.max_new_tokens
        self.num_slots = num_slots = cfg_e.num_slots
        self.eos_id = cfg_e.eos_id
        self.temperature = float(cfg_e.temperature)
        self.top_k = cfg_e.top_k
        self._base_seed = int(cfg_e.seed)
        self.max_prompt_len = cfg_e.max_prompt_len or 2 * self.max_len
        self.cache_len = self.max_prompt_len + self.max_new
        # Recurrent prefill caches hold one end-of-row state per row, so
        # those stacks admit one request per row, right-aligned.
        self._recurrent = traits["recurrent"]
        self.scheduler = Scheduler(max_len=self.max_len,
                                   max_rows=cfg_e.max_rows,
                                   max_prompt_len=self.max_prompt_len,
                                   pack=not self._recurrent)
        # SSD's chunked scan takes prefill widths of whole chunks.
        self._ssd_chunk = model.cfg.ssm.chunk \
            if "ssd" in traits["kinds"] and model.cfg.ssm else None
        self.decode_attn = resolve_decode_attn(cfg_e.decode_attn,
                                               self.device) \
            if traits["has_attn"] else "dense"
        self._dmodel = model.with_decode_attn(self.decode_attn,
                                              cfg_e.decode_block_k)
        self._block_k = self._dmodel.cfg.decode_block_k
        # One page is one kv block of the predicated attention; only the
        # attention lanes page (state lanes have a fixed shape).
        self.paged = traits["paged"]
        self.page_size = (cfg_e.page_size or self._block_k) \
            if self.paged else None
        if self.paged:
            self._block_k = self.page_size
        self.slots = SlotKVCache(model, num_slots, self.cache_len,
                                 page_size=self.page_size,
                                 pool_frac=cfg_e.pool_frac,
                                 page_cap=cfg_e.page_cap, mesh=mesh)
        # Prefix sharing: paged stacks whose every lane is a per-token kv
        # lane. A recurrent layer would need its end-of-prefix state, which
        # is neither paged nor content-addressable, so recurrent stacks
        # prefill cold (the probe never fires).
        self.prefix_share = bool(cfg_e.prefix_share) and self.paged \
            and not self.slots.state_lanes
        self._shared_tokens = 0
        self._prompt_tokens = 0
        self._pages_shared = 0
        self._fleet = None
        self._fleet_restored_pages = 0
        if fleet is not None:
            self.attach_fleet(fleet)
        self.mixed = traits["mixed_ok"] if cfg_e.mixed is None \
            else bool(cfg_e.mixed)
        self.prefill_budget = cfg_e.prefill_budget
        self._chunk_width = max(1, min(self.max_len,
                                       cfg_e.prefill_budget or self.max_len))
        # The mixed step's linears run over its live columns alone, but for
        # a routed (MoE) stack: its experts route every column of the step
        # together, so the dead ones take capacity as in the reference.
        self._pack_mixed = model.cfg.moe is None
        # Attention layers per lane ring, for the blocks-visited and K/V
        # byte accounting (one ring per window among the attention layers;
        # none in a pure-recurrent stack).
        self._ring_layers: Dict[int, int] = {}
        for i in range(model.cfg.n_layers):
            kind = model.cfg.block_kind(i)
            if kind in ("attn", "local"):
                ring = model._block_ring(kind, self.cache_len)
                self._ring_layers[ring] = self._ring_layers.get(ring, 0) + 1
        self._attn_rings = sorted(self._ring_layers)
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
        self.params = self._dmodel.prepare(params, mesh) \
            if params is not None \
            else None
        # Per-slot sampling state, resolved at admission (temps 0: greedy;
        # topks 0: no truncation).
        self._seeds = np.zeros(num_slots, np.uint32)
        self._temps = np.zeros(num_slots, np.float32)
        self._topks = np.zeros(num_slots, np.int32)
        self._admit_seq = np.zeros(num_slots, np.int64)
        self._seq = 0
        self.stats: List[Dict] = []  # one entry per prefill sweep
        self.decode_stats: Dict = {}
        audit = cfg_e.audit
        if audit is None:
            audit = bool(int(os.environ.get("REPRO_SERVE_AUDIT", "0") or 0))
        self.audit = bool(audit)
        self._audit_violations = 0
        # A FaultPlan builds a fresh injector per session (every run replays
        # the same schedule); an injector instance is used as it is.
        self._fault_plan: Optional[FaultPlan] = None
        self.fault_injector: Optional[FaultInjector] = None
        if isinstance(faults, FaultPlan):
            self._fault_plan = faults if faults.any_faults() else None
        elif isinstance(faults, FaultInjector):
            self.fault_injector = faults
        elif faults is not None:
            raise TypeError("faults must be a FaultPlan or FaultInjector")
        self._inj: Optional[FaultInjector] = None  # the session's injector
        self.max_pending = cfg_e.max_pending
        self.default_ttl = cfg_e.default_ttl_steps
        self.max_preempt = cfg_e.max_preemptions_per_request
        self.watchdog_patience = int(cfg_e.watchdog_patience)
        self._clock = 0
        self._device_time = 0
        self._counts: Dict[str, int] = {s: 0 for s in TERMINAL_STATUSES}
        self._terminal: List[Request] = []
        self._st: Optional[_RunState] = None
        self._events: Optional[List[Tuple[Request, int]]] = None
        # The open step-level spans (tokens of serve/spans.py).
        self._step_span = self._admit_span = self._dispatch_span = \
            spans.begin("none", t=0)

    # ------------------------------------------------------------------

    def submit(self, req: Request) -> None:
        """Queue a request: shed it when the pending queue is full
        (``max_pending``), reject it when its lane can never be allocated,
        and raise ``ValueError`` when the prompt exceeds
        ``max_prompt_len``. Opens the request's ``queued`` span."""
        req._submit_ns = self._req_span(  # type: ignore[attr-defined]
            req, "queued")
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
            self._req_close(req, "rejected")
            raise
        req._submit_clock = self._clock  # type: ignore[attr-defined]
        req._submit_dev = self._device_time  # type: ignore[attr-defined]

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

    @property
    def iteration(self) -> int:
        """The session's iteration count (0 outside a session): a request
        with ``tick <= iteration + 1`` is due for the next :meth:`step`."""
        return self._st.iters if self._st is not None else 0

    def _session(self) -> _RunState:
        if self._st is None:
            n = self.num_slots
            inj = FaultInjector(self._fault_plan) \
                if self._fault_plan is not None else self.fault_injector
            self._inj = self.fault_injector = inj
            self._shared_tokens = 0
            self._prompt_tokens = 0
            self._pages_shared = 0
            self._fleet_restored_pages = 0
            st = _RunState(cur=np.zeros(n, np.int32),
                           emitted=np.zeros(n, np.int32),
                           budget=np.zeros(n, np.int32), pending=[None] * n,
                           pending_full=[None] * n)
            st.done.extend(self._terminal)
            self._terminal.clear()
            self._st = st
        return self._st

    def _emit(self, req: Request, tok: int) -> None:
        """Append a token to the submitted request (a continuation's
        ``_origin``), stamp its modeled device time (the ITL clock) and
        report it as a step event."""
        target = getattr(req, "_origin", req)
        target.output.append(int(tok))
        if not hasattr(target, "_token_dev"):
            target._token_dev = []  # type: ignore[attr-defined]
        target._token_dev.append(self._device_time)
        if self._events is not None:
            self._events.append((target, int(tok)))

    def cancel(self, req: Request) -> bool:
        """Withdraw a request: drop it from the queue and/or release its
        slot (its pages return to the pool at once) and finish it
        ``cancelled``. Works between steps of a session and outside one.
        False when the request is already terminal or unknown here."""
        target = getattr(req, "_origin", req)
        if target.status is not None:
            return False
        hit = bool(self.scheduler.drop_where(
            lambda r: getattr(r, "_origin", r) is target))
        sl = self.slots
        for s in np.flatnonzero(sl.active):
            if sl.request[s] is target:
                sl.release(int(s))
                if self._st is not None:
                    self._st.pending[s] = None
                    self._st.pending_full[s] = None
                hit = True
        if not hit:
            return False
        if self._st is not None:
            self._finish(target, "cancelled", "cancelled by caller",
                         self._st.done)
        else:
            self._finish_terminal(target, "cancelled", "cancelled by caller")
        return True

    def _step_result(self, res: StepResult, n_done0: int) -> StepResult:
        res.finished = self._st.done[n_done0:]
        res.device_time = self._device_time
        return res

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def step(self, submits: Sequence[Request] = ()) -> StepResult:
        """ONE engine iteration — grow lanes (preempting when the pool runs
        dry), admit, one mixed or decode dispatch, retire. ``submits`` are
        submitted after this step's clock tick."""
        st = self._session()
        sl = self.slots
        inj = self._inj
        cur, emitted, budget = st.cur, st.emitted, st.budget
        pending, pending_full = st.pending, st.pending_full
        done = st.done
        res = StepResult()
        self._events = res.emitted
        n_done0 = len(done)
        self._step_span = step = spans.begin("step", step=st.iters + 1)
        sid, it = step[0], step[3]
        try:
            # One tick per iteration plus injected stall ticks: deadlines
            # age even while nothing decodes.
            self._clock += 1
            if inj is not None:
                self._clock += inj.begin_step(st.iters, self.num_slots,
                                              sl.active)
            st.iters += 1
            for r in submits:
                self.submit(r)
            if self._terminal:
                done.extend(self._terminal)
                self._terminal.clear()
            sp = spans.begin("expire", sid, it)
            progressed = self._expire(done) > 0
            spans.end(sp)
            if inj is not None and inj.forced_preempt() and sl.active.any():
                if self._preempt_or_fail(self._youngest_active()[0], done):
                    st.preempt_recovered += 1
                st.preemptions += 1
            if self.paged:
                # Growth runs before admission, so an admission reserves
                # only pages the in-flight lanes do not need this step.
                sp = spans.begin("grow", sid, it)
                rec, esc = self._ensure_pages(done)
                spans.end(sp)
                st.preemptions += rec + esc
                st.preempt_recovered += rec
            self._drop_stale_chunks(st)
            if self.scheduler.pending():
                free = sl.free_slots()
                if free.size:
                    n_done = len(done)
                    self._admit_span = sp = spans.begin("admit", sid, it)
                    if self.mixed:
                        admitted = self._admit_mixed(free, cur, emitted,
                                                     budget, pending,
                                                     pending_full, done)
                    else:
                        admitted = self._admit(free, cur, emitted, budget,
                                               done)
                    spans.end(sp)
                    progressed |= admitted > 0 or len(done) > n_done
            active_ix = np.flatnonzero(sl.active)
            if self.audit:
                self._audit_step()
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
            spans.end(step)

    def _drop_stale_chunks(self, st: _RunState) -> None:
        """Forget the chunk state of slots released since it was staged
        (expired, preempted, failed)."""
        for s in np.flatnonzero(~self.slots.active):
            st.pending[s] = None
            st.pending_full[s] = None

    def _youngest_active(self) -> Tuple[int, int]:
        """``(slot of the youngest active request, active slots)``: the
        preemption victim, youngest first, so older requests progress."""
        active = np.flatnonzero(self.slots.active)
        return int(max(active, key=lambda v: self._admit_seq[v])), \
            active.size

    def _pages_arg(self) -> Optional[Dict]:
        """The paged step's ``pages``: one entry for a uniform stack,
        ``{layer: entry or None}`` for a heterogeneous one."""
        if not self.paged:
            return None
        tables = self.slots.pool.device_tables()

        def entry(w):
            return None if w is None else {
                "bt": tables[w][:self.num_slots], "width": w,
                "page_size": self.page_size}

        lw = self.slots.layer_widths
        if isinstance(lw, dict):
            return {name: entry(w) for name, w in lw.items()}
        return entry(lw)

    def _count_blocks(self, st: _RunState, hi: np.ndarray) -> None:
        """The predicated attention's kv blocks over each active lane's
        occupancy ``hi`` clamped to its ring, one term per ring; K/V bytes:
        visited blocks x tokens per block, once per layer of that ring."""
        for ring in self._attn_rings:
            bk = min(self._block_k, ring)
            bs = block_stats(np.where(self.slots.active,
                                      np.minimum(hi, ring), 0), ring, bk)
            st.blocks_visited += bs["visited"]
            st.blocks_dense += bs["dense"]
            st.kv_bytes += (bs["visited"] * bk * self._ring_layers[ring]
                            * self._kv_token_bytes)

    def _mixed_step(self, st: _RunState, active_ix: np.ndarray) -> None:
        """Pack up to ``prefill_budget`` fresh prompt tokens (chunk rows,
        oldest admission first) with every decode slot in one step."""
        sl = self.slots
        pending, pending_full = st.pending, st.pending_full
        cur, emitted, budget = st.cur, st.emitted, st.budget
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
        # Chunk writes span [len, len + c): allocate and copy-on-write each
        # span, oldest first; a dry pool preempts the youngest or defers
        # the chunk (an inert row this step, chunk intact).
        sp = spans.begin("grow", self._step_span[0], self._step_span[3])
        for s in order:
            if not sl.active[s] or pending[s] is None or n_new[s] <= 0:
                continue
            ok, rec, esc = self._grow_span(
                int(s), int(sl.lengths[s]) + int(n_new[s]), st.done)
            st.preemptions += rec + esc
            st.preempt_recovered += rec
            if not ok:
                n_new[s] = 0
        spans.end(sp)
        self._drop_stale_chunks(st)
        n_new = np.where(sl.active, n_new, 0).astype(np.int32)
        active_ix = np.flatnonzero(sl.active)
        if active_ix.size == 0:
            return
        toks = np.zeros((self.num_slots, S), np.int32)
        for s in active_ix:
            if pending[s] is not None:
                c = int(n_new[s])
                toks[s, :c] = pending[s][:c]
            else:
                toks[s, 0] = cur[s]
        self._count_blocks(st, sl.lengths + n_new)
        d = self._open_dispatch()
        nxt, cols = self._run_mixed(toks, n_new,
                                    *self._step_inputs(d, sl.lengths + n_new))
        sp = spans.switch(d, "retire", {"kind": "mixed", "cols": cols,
                                        "live": int(n_new.sum())})
        st.step_ms["mixed"].append((sp[5] - d[5]) * 1e-6)
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
                pending_full[s] = None
                self._finish(req, "failed", "non-finite logits (NaN/Inf) in "
                             "the mixed step", st.done)
                continue
            if pending[s] is not None:
                c = int(n_new[s])
                if c <= 0:
                    continue  # budget-starved or deferred: nothing this step
                sl.advance_n(int(s), c)
                st.chunk_tokens += c
                rest = pending[s][c:]
                if len(rest):
                    pending[s] = rest  # still mid-prefill
                    continue
                # Prefill complete: ``tok`` is the request's first token,
                # and the prompt's full pages hold their final bytes.
                if self.prefix_share:
                    self._publish_prefix(int(s), pending_full[s])
                pending[s] = None
                pending_full[s] = None
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
        spans.end(sp)

    def _decode_step(self, st: _RunState, active_ix: np.ndarray) -> None:
        sl = self.slots
        self._count_blocks(st, sl.lengths + 1)
        d = self._open_dispatch()
        nxt = self._run_decode(st.cur,
                               *self._step_inputs(d, sl.lengths + 1))
        sp = spans.switch(d, "retire", {"kind": "decode"})
        st.step_ms["decode"].append((sp[5] - d[5]) * 1e-6)
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
        spans.end(sp)

    def _open_dispatch(self) -> spans.Token:
        """Open the step's ``dispatch`` span."""
        st = self._step_span
        self._dispatch_span = d = spans.begin("dispatch", st[0], st[3])
        return d

    def _step_inputs(self, d: spans.Token, positions: np.ndarray):
        """``(nan_mask, sampling)`` of the step's dispatch ``d``; an
        ``upload`` span when either goes to the device."""
        nan_mask, sampling = self._nan_mask(), self._sampling(positions)
        if nan_mask is not None or sampling is not None:
            spans.end(spans.begin("upload", d[0], d[3], t=d[5]))
        return nan_mask, sampling

    def _nan_mask(self) -> Optional[torch.Tensor]:
        """This step's injected NaN rows on the device (None: no fault)."""
        m = self._inj.nan_mask() if self._inj is not None else None
        return None if m is None else self._tensor(m)

    def _sampling(self, positions: np.ndarray):
        """The sampler's per-slot ``(seeds, positions, temperatures,
        top_ks)`` on the device, or None when every active slot is greedy:
        such a step runs the plain argmax alone."""
        if not np.any(self._temps[self.slots.active] > 0):
            return None
        return (self._tensor(self._seeds.astype(np.int64)),
                self._tensor(np.asarray(positions, np.int64)),
                self._tensor(self._temps), self._tensor(self._topks))

    @staticmethod
    def _choose(logits: torch.Tensor, nan_mask, sampling) -> torch.Tensor:
        """Injected NaN rows go onto the logits after the model and before
        the sampler, so the caches never see them and the row reports the
        ``-1`` sentinel."""
        if nan_mask is not None:
            logits = torch.where(nan_mask[:, None],
                                 torch.full_like(logits, float("nan")),
                                 logits)
        return sample_or_greedy(logits, sampling)

    @torch.inference_mode()
    def _run_mixed(self, toks: np.ndarray, n_new: np.ndarray, nan_mask=None,
                   sampling=None) -> Tuple[np.ndarray, int]:
        """The mixed step on the device over the columns the linears run
        on, laid flat row after row: a dense stack's ``n_new[b]`` fresh
        columns of each row b, a routed stack's every column of ``toks``
        (``Model.mixed_hidden``), and every column too when no row has a
        fresh token. Row b's token comes from its last fresh column
        (clamped: an inert row reads any column and the host ignores it).
        Returns the (B,) tokens on the host and the columns run."""
        sl = self.slots
        d = self._dispatch_span
        sp = spans.begin("upload", d[0], d[3])
        B, S = toks.shape
        run = n_new if self._pack_mixed and n_new.any() \
            else np.full(B, S, np.int64)
        row = np.repeat(np.arange(B), run)
        first = np.cumsum(run) - run
        col = np.arange(row.size) - first[row]
        flat = self._tensor(np.stack([toks[row, col], row, col]).astype(
            np.int64))
        last = self._tensor(np.minimum(first + np.maximum(n_new, 1) - 1,
                                       row.size - 1))
        nn = self._tensor(n_new)
        lengths, mask = self._tensor(sl.lengths), self._tensor(sl.active)
        pages = self._pages_arg()
        sp = spans.switch(sp, "model")
        h, sl.caches = self._dmodel.mixed_hidden(
            self.params, {"inputs": flat[0][None]}, sl.caches, lengths, nn,
            slot_mask=mask, pages=pages, mesh=self.mesh,
            cols={"row": flat[1], "col": flat[2], "width": S})
        logits = self._dmodel.logits(self.params, h[0, last], self.mesh)
        return self._choose_sync(sp, logits, nan_mask, sampling), row.size

    @torch.inference_mode()
    def _run_decode(self, cur: np.ndarray, nan_mask=None,
                    sampling=None) -> np.ndarray:
        sl = self.slots
        d = self._dispatch_span
        sp = spans.begin("upload", d[0], d[3])
        inputs = {"inputs": self._tensor(cur[:, None])}
        lengths, mask = self._tensor(sl.lengths), self._tensor(sl.active)
        pages = self._pages_arg()
        sp = spans.switch(sp, "model")
        logits, sl.caches = self._dmodel.decode_step(
            self.params, inputs, sl.caches, lengths, slot_mask=mask,
            pages=pages, mesh=self.mesh)
        return self._choose_sync(sp, logits[:, 0], nan_mask, sampling)

    def _choose_sync(self, model: spans.Token, logits, nan_mask, sampling
                     ) -> np.ndarray:
        """End the ``model`` span; the sampler (``choose``), then the
        step's host sync (``sync``). Returns the tokens on the host."""
        sp = spans.switch(model, "choose")
        tok = self._choose(logits, nan_mask, sampling)
        sp = spans.switch(sp, "sync")
        out = tok.cpu().numpy()
        spans.end(sp)
        return out

    def finish_run(self) -> List[Request]:
        """Close the session: build ``decode_stats``, reset the session
        state, return every terminal request in completion order."""
        st = self._session()
        sl = self.slots
        inj = self._inj
        done = st.done
        # Inter-token latency in modeled device tokens (``_emit`` stamps).
        itl = [b - a for r in done
               for a, b in zip(getattr(r, "_token_dev", []),
                               getattr(r, "_token_dev", [])[1:])]
        self.decode_stats = {
            "steps": st.steps,
            "decoded_tokens": st.decoded_tokens,
            "slot_utilization": (st.active_slot_steps
                                 / max(st.steps * self.num_slots, 1)),
            "kv_blocks_visited": st.blocks_visited,
            "kv_blocks_dense": st.blocks_dense,
            "kv_block_ratio": st.blocks_visited / max(st.blocks_dense, 1),
            "paged": self.paged,
            "preemptions": st.preemptions,
            "preemptions_recovered": st.preempt_recovered,
            # contiguous lanes hold everything up front: ratio 1.0
            "kv_pages_total": sl.pool.total_pages if self.paged else 0,
            "kv_memory_ratio": (st.pages_used_steps
                                / max(st.steps * sl.pool.total_pages, 1)
                                if self.paged else 1.0),
            # Prefix sharing: admitted prompt tokens served from shared
            # pages over prompt tokens admitted; page mappings served.
            "prefix_hit_ratio": (self._shared_tokens
                                 / max(self._prompt_tokens, 1)),
            "pages_shared": self._pages_shared,
            # Estimated HBM bytes per decoded token: the weights streamed
            # once per step plus the KV blocks actually visited.
            "weight_format": self.model.cfg.weight_format,
            "weight_bytes_per_step": self._weight_stream_bits / 8.0,
            "weight_bytes_per_token": (st.steps
                                       * self._weight_stream_bits / 8.0
                                       / max(st.decoded_tokens, 1)),
            "kv_bytes_per_token": st.kv_bytes / max(st.decoded_tokens, 1),
            # Each rank streams its Hkv / N heads of every visited page.
            "tp_ranks": self._tp,
            "kv_bytes_per_token_per_rank": (
                st.kv_bytes / max(st.decoded_tokens, 1) / self._tp),
            "bytes_per_token": ((st.steps * self._weight_stream_bits / 8.0
                                 + st.kv_bytes)
                                / max(st.decoded_tokens, 1)),
            "status_counts": dict(self._counts),
            "completed_ok": self._counts["ok"],
            **{s: self._counts[s] for s in TERMINAL_STATUSES if s != "ok"},
            "audit_violations": self._audit_violations,
            "faults_injected": dict(inj.counts) if inj is not None else {},
            "clock_ticks": self._clock,
            "device_time": self._device_time,
            "fleet_restored_pages": self._fleet_restored_pages,
            "itl_p50": float(np.percentile(itl, 50)) if itl else 0.0,
            "itl_p99": float(np.percentile(itl, 99)) if itl else 0.0,
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
        # Both are differences of the wall clock, which a clock step moves.
        if (any(v < 0 for vs in st.step_ms.values() for v in vs)
                or any(t["wall_s"] < 0
                       for t in self.decode_stats["ttft"].values())):
            warnings.warn("the system clock stepped back during the run: "
                          "decode_stats' step_ms or ttft wall_s hold "
                          "negative lengths", RuntimeWarning)
        self._counts = {s: 0 for s in TERMINAL_STATUSES}
        self._inj = None
        self._st = None
        return done

    # ------------------------------------------------------------------

    def _ensure_pages(self, done: List[Request]) -> Tuple[int, int]:
        """Make every active slot's next write position writable, oldest
        request first: allocate missing pages, copy-on-write shared ones,
        unpublish sole-owner published ones. When the pool is dry (no free
        page and no retained one to evict, or the fault injector fails the
        request), preempt the youngest active request and retry; an
        injected failure is never fatal to the only active request. The
        oldest can always progress: preempting every other holder leaves
        its pages to it alone. Returns
        ``(recovered, escalated)``: victims requeued, and victims failed
        (over their preemption budget, or a lane that cannot grow even
        alone under ``page_cap``)."""
        sl, pool = self.slots, self.slots.pool
        inj = self._inj
        n_rec = n_esc = 0
        order = sorted(np.flatnonzero(sl.active),
                       key=lambda s: self._admit_seq[s])
        for s in order:
            suppress = False
            while sl.active[s]:  # a victim earlier in this pass is gone
                injected = (not suppress and inj is not None
                            and inj.alloc_fail())
                ok, copies = (False, []) if injected else \
                    pool.make_writable(int(s), int(sl.lengths[s]))
                if ok:
                    sl.copy_pages(copies)
                    break
                victim, n_active = self._youngest_active()
                if victim == s and n_active == 1:
                    if injected:  # retry for real
                        suppress = True
                        continue
                    req = sl.request[s]
                    sl.release(int(s))
                    self._finish(
                        req, "failed",
                        "page pool cannot hold the request's next page "
                        "even with every other slot evicted (page_cap too "
                        "small for its decode growth)", done)
                    n_esc += 1
                    break
                if self._preempt_or_fail(victim, done):
                    n_rec += 1
                else:
                    n_esc += 1
        return n_rec, n_esc

    def _grow_span(self, s: int, end: int,
                   done: List[Request]) -> Tuple[bool, int, int]:
        """Make lane positions ``[lengths[s], end)`` writable for a chunk
        scatter: allocate the span's pages and copy-on-write shared ones.
        A dry pool preempts the youngest active request and retries (both
        calls are all-or-nothing); when the youngest is ``s`` itself and
        others are active, the chunk is deferred (``ok=False``: the slot
        keeps its pages and streamed prefix) while older requests drain.
        A sole survivor that still cannot grow is failed. Returns ``(ok,
        recovered, escalated)``."""
        sl, pool = self.slots, self.slots.pool
        inj = self._inj
        n_rec = n_esc = 0
        suppress = False
        end = min(end, self.cache_len)
        while True:
            injected = not suppress and inj is not None and inj.alloc_fail()
            try:
                if injected:
                    raise RuntimeError("injected allocation failure")
                pool.alloc_prefix(s, end)
                copies = pool.make_range_writable(s, int(sl.lengths[s]), end)
            except RuntimeError:
                victim, n_active = self._youngest_active()
                if victim == s:
                    if n_active == 1:
                        if injected:
                            suppress = True
                            continue
                        req = sl.request[s]
                        sl.release(s)
                        self._finish(
                            req, "failed",
                            "page pool cannot hold the prefill chunk span "
                            "even with every other slot evicted (page_cap "
                            "too small for the prompt)", done)
                        n_esc += 1
                    return False, n_rec, n_esc
                if self._preempt_or_fail(victim, done):
                    n_rec += 1
                else:
                    n_esc += 1
                continue
            sl.copy_pages(copies)
            return True, n_rec, n_esc

    def _preempt_or_fail(self, slot: int, done: List[Request]) -> bool:
        """Preempt and requeue ``slot``'s request within its preemption
        budget (``Request.max_preemptions``, else the engine's
        ``max_preemptions_per_request``; None is unbounded); over budget
        it is failed. True when the request was requeued."""
        req = self.slots.request[slot]
        target = getattr(req, "_origin", req)
        n = getattr(target, "_preempt_count", 0) + 1
        target._preempt_count = n  # type: ignore[attr-defined]
        limit = target.max_preemptions \
            if target.max_preemptions is not None else self.max_preempt
        if limit is not None and n > limit:
            self.slots.release(slot)
            self._finish(
                target, "failed",
                f"preemption budget exhausted ({n - 1} preempt-requeue "
                "cycles; stuck in an admit-preempt cycle)", done)
            return False
        self._preempt(slot)
        return True

    def _preempt(self, slot: int) -> None:
        """Requeue the slot's request at the queue head as a continuation:
        its prompt plus everything generated so far, with its sampling.
        Prefilling that sequence gives the token the next decode step would
        have (greedy, or drawn with the same key at the same position), and
        its published pages make the resume a prefix hit."""
        req = self.slots.request[slot]
        cont = Request(
            rid=req.rid,
            prompt=np.concatenate([np.asarray(req.prompt, np.int32),
                                   np.asarray(req.output, np.int32)]),
            max_new_tokens=req.max_new_tokens, seed=req.seed,
            sampling=req.sampling)
        cont._origin = req  # type: ignore[attr-defined]
        self.scheduler.requeue(cont)
        self.slots.release(slot)
        self._req_span(req, "queued")

    def _note_ttft(self, req: Request) -> None:
        """A prefill ended in a token: the request's ``prefill`` span
        gives way to ``decode``. Stamp time-to-first-token when that token
        is the submitted request's first (a continuation resumes with
        earlier output)."""
        target = getattr(req, "_origin", req)
        first = len(target.output) == 1 and not hasattr(target, "_ttft_wall")
        now = self._req_span(target, "decode", {"first": int(first)})
        if not first:
            return
        target._ttft_wall = (now - getattr(target, "_submit_ns", now)) * 1e-9
        target._ttft_clock = self._clock - getattr(target, "_submit_clock",
                                                   self._clock)
        target._first_token_clock = self._clock
        target._ttft_dev = self._device_time - getattr(
            target, "_submit_dev", self._device_time)

    # -- prefix sharing ------------------------------------------------

    def attach_fleet(self, fleet) -> None:
        """Join a cross-replica
        :class:`~repro_torch.serve.pages.FleetPrefixIndex`: local prefix
        publishes mirror page bytes into its host tier, and probes first
        restore fleet-only pages into the local pool. Needs local prefix
        sharing."""
        if not self.prefix_share:
            raise UnsupportedConfigError(
                "a fleet prefix index needs local prefix sharing: this "
                "engine has prefix_share disabled (or contiguous lanes that "
                "cannot share)")
        if self._tp > 1:
            raise UnsupportedConfigError(
                "fleet prefix sharing reads/writes whole pages on the "
                "host and is single-rank: a KV-head-sharded cache would "
                "need per-rank page slices. Serve fleet replicas "
                "unsharded, or drop the fleet index.")
        self._fleet = fleet

    def _publish_prefix(self, slot: int, tokens) -> None:
        """Publish a freshly prefilled lane's full pages locally, then
        mirror each indexed page's bytes into the fleet tier, consecutive
        from logical page 0 (a fleet entry is useful only in an unbroken
        chain, as a local hit run)."""
        pool = self.slots.pool
        toks = np.asarray(tokens, np.int32)
        pool.publish_prefix(slot, toks)
        fleet = self._fleet
        m = len(toks) // pool.page_size
        if fleet is None or m == 0:
            return
        digests = prefix_digests(toks, pool.page_size, m)
        for w, c in pool.classes.items():
            if len(toks) > c.width:
                continue
            for lp in range(m):
                pg = c.index.get((lp, digests[lp]))
                if pg is None:
                    break
                if not fleet.has(w, lp, digests[lp]):
                    fleet.publish(w, lp, digests[lp],
                                  self.slots.read_page(w, pg))

    def _fleet_restore(self, toks: np.ndarray) -> None:
        """Pull fleet-published prefix pages this pool is missing into its
        retained tier, so the local probe that follows hits them: a logical
        page in every width class or none, stopping at the first page that
        cannot be restored (hit runs are consecutive)."""
        fleet, pool = self._fleet, self.slots.pool
        m = len(toks) // pool.page_size
        if m == 0 or any(len(toks) > c.width for c in pool.classes.values()):
            return
        digests = prefix_digests(toks, pool.page_size, m)
        for lp in range(m):
            plan = []
            for w, c in pool.classes.items():
                if (lp, digests[lp]) in c.index:
                    continue  # already resident
                host = fleet.get(w, lp, digests[lp])
                if host is None or c.available() == 0:
                    return
                plan.append((w, host))
            for w, host in plan:
                pg = pool.adopt_published(w, lp, digests[lp])
                if pg is None:
                    return
                self.slots.write_page(w, pg, host)
                self._fleet_restored_pages += 1
                fleet.restored_pages += 1

    def _probe_req(self, req: Request) -> Optional[PrefixHit]:
        """The prefix-cache hit of ``req``'s prompt (None when sharing is
        off or nothing matches; with a fleet, fleet-only pages are restored
        first), memoized on the request against the pool's identity,
        ``prefix_version`` and the fleet's ``version``: one admission
        consults it up to three times, and a head-blocked queue front every
        step."""
        if not self.prefix_share:
            return None
        pool = self.slots.pool
        ver = (pool.prefix_version,
               self._fleet.version if self._fleet is not None else -1)
        memo = getattr(req, "_probe_memo", None)
        if memo is not None and memo[0] is pool and memo[1] == ver:
            return memo[2]
        toks = np.asarray(req.prompt, np.int32)
        if self._fleet is not None:
            self._fleet_restore(toks)
        hit = pool.probe_prefix(toks)
        req._probe_memo = (pool, ver, hit)  # type: ignore[attr-defined]
        return hit

    def _probe_len(self, req: Request) -> int:
        hit = self._probe_req(req)
        return hit.n_shared if hit is not None else 0

    def _page_reserve(self, chunk: Optional[int] = None):
        """Admission control over the page budget: a request reserves the
        pages of its prompt's span plus one position — for the mixed step
        (``chunk``) only its first chunk's span — with FIFO head-blocking
        once the budget (free plus retained pages, per width class) would
        overcommit. A prefix hit reserves only its net-new pages, plus the
        shared pages its writes will copy and the retained pages it pins by
        mapping them."""
        pool = self.slots.pool
        ps = pool.page_size
        avail = {w: c.available() for w, c in pool.classes.items()}

        def reserve(req: Request) -> bool:
            if self._inj is not None and self._inj.alloc_fail():
                return False  # injected pool failure: head-block the round
            L = len(req.prompt)
            span = L if chunk is None else min(L, chunk)
            hit = self._probe_req(req)
            consume = {}
            for w, c in pool.classes.items():
                need = -(-min(span + 1, c.width) // ps)
                if hit is None:
                    consume[w] = need
                    continue
                shared = -(-hit.n_shared // ps)
                writes = {(p % c.width) // ps
                          for p in range(min(hit.n_shared, span), span + 1)}
                cow = sum(1 for lp in writes if lp < shared)
                pinned = sum(1 for pg in hit.pages[w] if c.refcount[pg] == 0)
                consume[w] = max(0, need - shared) + cow + pinned
            if any(n > avail[w] for w, n in consume.items()):
                return False
            for w, n in consume.items():
                avail[w] -= n
            return True

        return reserve

    # -- admission -----------------------------------------------------

    def _admit_mixed(self, free: np.ndarray, cur, emitted, budget, pending,
                     pending_full, done: List[Request]) -> int:
        """Claim a free slot per admitted request and stage its prompt in
        ``pending`` for the chunk scheduler. A prefix hit maps its shared
        pages first, so the chunks stream only the suffix."""
        pool = self.slots.pool
        adms = self.scheduler.next_mixed(
            len(free), reserve=self._page_reserve(self._chunk_width),
            probe=self._probe_len if self.prefix_share else None)
        fi = 0
        n_processed = 0
        for req, _ in adms:
            n_processed += 1
            target = getattr(req, "_origin", req)
            total_budget = min(target.max_new_tokens, self.max_new)
            if len(target.output) >= total_budget:
                self._finish(target, "ok", None, done)
                continue
            prompt = np.asarray(req.prompt, np.int32)
            hit = self._probe_req(req)
            off = hit.n_shared if hit is not None else 0
            self._prompt_tokens += len(prompt)
            self._shared_tokens += off
            slot = int(free[fi])
            fi += 1
            if off:
                pool.map_shared(slot, hit)
                self._pages_shared += sum(len(v) for v in hit.pages.values())
            self.slots.claim(slot, target, off)
            self._req_span(target, "prefill")
            try:
                # Hold the first chunk's write position now, copied out of
                # a shared tail page.
                pool.alloc_prefix(slot, min(off + 1, self.cache_len))
                copies = pool.make_range_writable(slot, off, off + 1) \
                    if off else []
            except RuntimeError:
                # The reservation makes this unreachable; requeue rather
                # than wedge the round.
                self.slots.release(slot)
                self.scheduler.requeue(req)
                self._req_span(target, "queued")
                break
            self.slots.copy_pages(copies)
            pending[slot] = prompt[off:]
            pending_full[slot] = prompt
            cur[slot] = 0
            emitted[slot] = len(target.output)
            budget[slot] = total_budget
            self._set_sampling(slot, target)
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
        always reaches its first decode step. Prefix hits map their shared
        pages before the copy, and every admitted prompt's full pages are
        published after it."""
        pool = self.slots.pool
        groups = self.scheduler.next_admissions(
            len(free), reserve=self._page_reserve() if self.paged else None,
            probe=self._probe_len if self.prefix_share else None)
        fi = 0
        n_processed = 0
        for adm in groups:
            n_processed += len(adm.requests)
            for req in adm.requests:
                self._req_span(getattr(req, "_origin", req), "prefill")
            firsts, caches, slots_of, hits = self._prefill_admission(adm)
            assigns, pubs = [], []
            for i, req in enumerate(adm.requests):
                target = getattr(req, "_origin", req)
                row, start, length, off = slots_of[i]
                total_budget = min(target.max_new_tokens, self.max_new)
                if len(target.output) >= total_budget:
                    self._finish(target, "ok", None, done)  # nothing left
                    continue
                # Hit accounting covers requests that finish at prefill
                # too: their prefix compute was saved all the same.
                self._prompt_tokens += off + length
                self._shared_tokens += off
                first = int(firsts[i])
                if first < 0:
                    self._finish(target, "failed", "non-finite logits "
                                 "(NaN/Inf) in the prefill sweep", done)
                    continue
                self._emit(target, first)
                self._note_ttft(target)
                if len(target.output) >= total_budget or first == self.eos_id:
                    self._finish(target, "ok", None, done)  # slot stays free
                    continue
                slot = int(free[fi])
                fi += 1
                if off:
                    pool.map_shared(slot, hits[i])
                    self._pages_shared += sum(
                        len(v) for v in hits[i].pages.values())
                assigns.append((slot, target, row, start, length, off))
                if self.prefix_share:
                    pubs.append((slot, req.prompt))
                cur[slot] = first
                emitted[slot] = len(target.output)
                budget[slot] = total_budget
                self._set_sampling(slot, target)
                self._admit_seq[slot] = self._seq
                self._seq += 1
            self.slots.assign_many(assigns, caches)
            # Publish after the copy: only then do the full pages hold
            # their final bytes.
            for slot, toks in pubs:
                self._publish_prefix(slot, toks)
        return n_processed

    @torch.inference_mode()
    def _prefill_admission(self, adm: Admission):
        """One prefill sweep: returns ``(first tokens (n,) on the host,
        filled caches (L, rows, width, ...), per-request (row, start,
        length, offset), per-request prefix hits)``. Packed rows are padded
        to a power of two (padding rows ride segment id 0, fully masked),
        as the reference bounds its compiled shapes. First tokens are
        greedy, or drawn by the batch sampler at position ``offset +
        length`` for requests that sample. A shared admission
        re-probes (the scheduler's estimates may be stale or short): a solo
        full miss falls back to a chunked prefill, otherwise one suffix
        sweep, one row per request, attends each row's prefix gathered out
        of the pool (``offset`` tokens). Logits are taken only at each
        request's last prompt position."""
        hits: List[Optional[PrefixHit]] = [None] * len(adm.requests)
        prefix_kv = None
        if adm.shared_prefix:
            hits = [self._probe_req(r) for r in adm.requests]
            if len(hits) == 1 and hits[0] is None:
                adm = Admission(requests=adm.requests, chunks=chunk_prompt(
                    adm.requests[0].prompt, self.max_len))
        if adm.shared_prefix:
            tokens, positions, seg, ids, plen, slots_of = \
                self._shared_batch_many(adm.requests, hits)
            rows = len(adm.requests)
            util = sum(s[2] for s in slots_of) / max(tokens.size, 1)
        elif adm.packed is not None:
            packed = adm.packed
            rows = packed.rows
            pad = ((0, (1 << (rows - 1).bit_length()) - rows), (0, 0))
            tokens, positions, seg = (np.pad(a, pad) for a in (
                packed.tokens, packed.positions, packed.segment_ids))
            slots_of = [(r, s, n, 0) for r, s, n in packed.request_slots]
            util = adm.utilization
        elif adm.chunks is None:  # row per request (recurrent stacks)
            tokens, positions, seg, slots_of = self._rows_batch(adm)
            rows = len(adm.requests)
            util = adm.utilization
        else:  # solo long prompt, chunked
            prompt = np.concatenate(adm.chunks)
            width = len(adm.chunks) * self.max_len
            n = len(prompt)
            tokens = np.zeros((1, width), np.int32)
            seg = np.zeros((1, width), np.int32)
            tokens[0, :n] = prompt
            seg[0, :n] = 1
            positions = np.arange(width, dtype=np.int32)[None]
            slots_of = [(0, 0, n, 0)]
            rows = 1
            util = adm.utilization
        d = spans.begin("dispatch", self._admit_span[0],
                        self._step_span[3])
        sp = spans.begin("upload", d[0], d[3], t=d[5])
        batch = {"inputs": self._tensor(tokens),
                 "positions": self._tensor(positions),
                 "seg_ids": self._tensor(seg)}
        last = np.array([[r, s + n - 1] for r, s, n, _ in slots_of],
                        np.int64)
        rows_at, cols_at = self._tensor(last[:, 0]), self._tensor(last[:, 1])
        sampling = None
        res = [self._resolve_sampling(getattr(r, "_origin", r))
               for r in adm.requests]
        if any(temp > 0 for temp, _, _ in res):
            sampling = (
                self._tensor(np.array([sd for _, _, sd in res], np.int64)),
                self._tensor(np.array([o + n for _, _, n, o in slots_of],
                                      np.int64)),
                self._tensor(np.array([tp for tp, _, _ in res], np.float32)),
                self._tensor(np.array([k for _, k, _ in res], np.int32)))
        if adm.shared_prefix:
            plen = self._tensor(plen)
        sp = spans.switch(sp, "model")
        if adm.shared_prefix:
            pk, pv = self.slots.gather_prefix(ids)
            prefix_kv = {"k": pk, "v": pv, "len": plen}
        # Full-length caches: the lane gather addresses every row position.
        caches = self._dmodel.init_cache(*tokens.shape, ring=False,
                                         mesh=self.mesh)
        h, caches = self._dmodel.hidden(
            self.params, batch, caches=caches, prefix_kv=prefix_kv,
            mesh=self.mesh)
        logits = self._dmodel.logits(self.params, h[rows_at, cols_at],
                                     self.mesh)
        firsts = self._choose_sync(sp, logits, None, sampling)
        t = spans.end(d, {"kind": "prefill"})
        self._st.step_ms["prefill"].append((t - d[5]) * 1e-6)
        self._device_time += int(tokens.shape[1])
        self.stats.append({"rows": rows, "n_requests": len(adm.requests),
                           "utilization": util})
        return firsts, caches, slots_of, hits

    def _rows_batch(self, adm: Admission):
        """Row-per-request layout of a recurrent stack: each request in its
        own row, **right-aligned**, so the row's end state (all a recurrent
        prefill cache keeps) is the request's. Leading padding rides
        segment id 0: attention masks it and the recurrent blocks take it
        as identity steps, so each row ends where a solo prefill would. An
        SSD stack's width is rounded up to whole scan chunks (and
        ``adm.row_width`` with it, for the utilization stat); rows are
        padded to a power of two. Returns ``(tokens, positions, seg,
        slots_of)``."""
        width = adm.row_width
        q = self._ssd_chunk
        if q is not None and width > q and width % q:
            width = -(-width // q) * q
            adm.row_width = width
        pad_rows = 1 << (len(adm.requests) - 1).bit_length()
        tokens = np.zeros((pad_rows, width), np.int32)
        seg = np.zeros((pad_rows, width), np.int32)
        pos = np.zeros((pad_rows, width), np.int32)
        slots_of = []
        for i, req in enumerate(adm.requests):
            n = len(req.prompt)
            start = width - n
            tokens[i, start:] = req.prompt
            seg[i, start:] = 1
            pos[i, start:] = np.arange(n)
            slots_of.append((i, start, n, 0))
        return tokens, pos, seg, slots_of

    def _shared_batch_many(self, reqs: List[Request],
                           hits: List[Optional[PrefixHit]]):
        """The suffix sweep's layout: row i holds ``prompt[n_i:]`` at
        absolute positions (``n_i = 0`` for a stale probe: a cold row in
        the same sweep), padded to the widest suffix's ``max_len``
        multiple, rows padded to a power of two (fully masked). The
        prefixes ride as an ``(rows, n_pages)`` page-id array per width
        class (``FREE``-padded, the widest prefix's ``max_len`` multiple,
        at least one ``max_len``) and per-row prefix lengths. Returns
        ``(tokens, positions, seg, ids, plen, slots_of)``."""
        pool = self.slots.pool
        ns = [h.n_shared if h is not None else 0 for h in hits]
        prompts = [np.asarray(r.prompt, np.int32) for r in reqs]
        sufs = [len(p) - n for p, n in zip(prompts, ns)]
        width = max(-(-s // self.max_len) * self.max_len for s in sufs)
        R = len(reqs)
        pad_rows = 1 << (R - 1).bit_length()
        tokens = np.zeros((pad_rows, width), np.int32)
        seg = np.zeros((pad_rows, width), np.int32)
        pos = np.zeros((pad_rows, width), np.int32)
        slots_of = []
        for i, (prompt, n, suf) in enumerate(zip(prompts, ns, sufs)):
            tokens[i, :suf] = prompt[n:]
            seg[i, :suf] = 1
            pos[i, :suf] = np.arange(n, len(prompt), dtype=np.int32)
            slots_of.append((i, 0, suf, n))
        np_pad = max(max(-(-n // self.max_len) * self.max_len for n in ns),
                     self.max_len)
        n_pages = -(-np_pad // pool.page_size)
        ids = {}
        for w, c in pool.classes.items():
            padded = np.full((pad_rows, n_pages), c.FREE, np.int32)
            for i, h in enumerate(hits):
                if h is not None:
                    padded[i, :len(h.pages[w])] = h.pages[w]
            ids[w] = padded
        plen = np.zeros(pad_rows, np.int32)
        plen[:R] = ns
        return tokens, pos, seg, ids, plen, slots_of

    # -- lifecycle -----------------------------------------------------

    def _finish(self, req: Request, status: str, reason: Optional[str],
                done: List[Request]) -> None:
        target = getattr(req, "_origin", req)
        target.status = status
        target.status_reason = reason
        self._counts[status] += 1
        self._req_close(target, status)
        done.append(target)

    def _finish_terminal(self, req: Request, status: str,
                         reason: str) -> None:
        target = getattr(req, "_origin", req)
        target.status = status
        target.status_reason = reason
        self._counts[status] += 1
        self._req_close(target, status)
        self._terminal.append(target)

    def _req_span(self, target: Request, name: str,
                  attrs: Optional[Dict] = None) -> int:
        """Close the submitted request's open span (with ``attrs``) and
        open its ``name`` span on the same stamp; returns the stamp."""
        tok = getattr(target, "_span", None)
        t = spans.end(tok, attrs) if tok is not None else None
        target._span = tok = spans.begin(  # type: ignore[attr-defined]
            name, step=self.iteration, rid=target.rid, t=t)
        return tok[5]

    def _req_close(self, target: Request, status: str) -> None:
        """Close the request's open span with its terminal status."""
        tok = getattr(target, "_span", None)
        if tok is not None:
            target._span = None  # type: ignore[attr-defined]
            spans.end(tok, {"status": status})

    def _expire(self, done: List[Request]) -> int:
        """Expire queued and in-flight requests whose deadline (virtual
        clock ticks since submission) has passed. A continuation expires
        on its origin's clock: a preempt-requeue cycle resets nothing."""
        def expired(req: Request) -> bool:
            t = getattr(req, "_origin", req)
            ttl = t.ttl_steps if t.ttl_steps is not None \
                else self.default_ttl
            return ttl is not None and \
                self._clock > getattr(t, "_submit_clock", 0) + int(ttl)

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

    def _audit_step(self) -> None:
        """The opt-in per-iteration audit (``audit=True``), after page growth
        and admissions, before the dispatch: the pool's refcount, partition
        and index invariants, each active lane's block-table bounds and
        private write target, and each slot's length bound; on a mesh, the
        ranks' host state against each other (:meth:`_audit_ranks`). A
        violation is counted and raised as :class:`AuditError`."""
        sl = self.slots
        err = None
        try:
            active = np.flatnonzero(sl.active)
            if self.paged:
                sl.pool.check_invariants(ranks=self._tp, rank=self._rank)
                for s in active:
                    sl.pool.check_lane_bounds(int(s), int(sl.lengths[s]))
                    sl.pool.check_write_private(int(s), int(sl.lengths[s]))
            for s in active:
                if not 0 <= int(sl.lengths[s]) < self.cache_len:
                    raise AuditError(
                        "slot-length-bounds",
                        f"slot {int(s)} length {int(sl.lengths[s])} "
                        f"outside [0, {self.cache_len})")
        except AuditError as e:
            err = e
        if self._tp > 1:
            err = self._audit_ranks(err)
        if err is not None:
            self._audit_violations += 1
            raise err

    def _audit_ranks(self, err: Optional[AuditError]
                     ) -> Optional[AuditError]:
        """Every rank decides admission, paging and preemption on its own
        copy of the host state, so the copies must stay equal. A digest of
        the slot table (active slots, lengths, requests) and of the pool
        (:meth:`PagePool.digest`), with whether this rank's own checks
        failed, goes through one ``all_reduce(MAX)`` as ``(d, -d,
        failed)``: every rank takes part whatever its own result, and every
        rank raises when one rank's checks failed (``rank-failed``) or two
        digests differ (``rank-drift``). Returns the error to raise."""
        sl = self.slots
        h = hashlib.blake2b(digest_size=8)
        h.update(sl.active.tobytes())
        h.update(sl.lengths.tobytes())
        h.update(repr([None if r is None else r.rid
                       for r in sl.request]).encode())
        if sl.pool is not None:
            h.update(sl.pool.digest())
        d = int.from_bytes(h.digest(), "little") >> 1
        t = torch.tensor([d, -d, int(err is not None)], dtype=torch.int64,
                         device=self.mesh.device)
        hi, neg_lo, failed = self.mesh.all_reduce(t, op="max").tolist()
        if err is not None:
            return err
        view = f"[rank {self._rank}/{self._tp} view]"
        if failed:
            return AuditError("rank-failed",
                              f"another rank's own audit failed {view}")
        if hi != -neg_lo:
            return AuditError(
                "rank-drift", f"host state differs across the {self._tp} "
                f"ranks: digest {d:#x}, ranks' range [{-neg_lo:#x}, "
                f"{hi:#x}] {view}")
        return None

    def _resolve_sampling(self, target: Request) -> Tuple[float, int, int]:
        """A request's ``(temperature, top_k, seed)``: its
        :class:`SamplingParams` override the engine defaults field by field
        (``top_k=0`` disables truncation); the seed is
        ``SamplingParams.seed``, else ``Request.seed``, else ``seed +
        rid``, as a 32-bit word."""
        sp = target.sampling
        temp = self.temperature if sp is None or sp.temperature is None \
            else float(sp.temperature)
        topk = self.top_k if sp is None or sp.top_k is None \
            else int(sp.top_k)
        if sp is not None and sp.seed is not None:
            seed = sp.seed
        elif target.seed is not None:
            seed = target.seed
        else:
            seed = self._base_seed + target.rid
        return float(temp), int(topk or 0), int(seed) & 0xFFFFFFFF

    def _set_sampling(self, slot: int, target: Request) -> None:
        self._temps[slot], self._topks[slot], self._seeds[slot] = \
            self._resolve_sampling(target)

    def _watchdog_escalate(self, done: List[Request]) -> None:
        """Fail the queue head after ``watchdog_patience`` consecutive idle
        iterations, so a run can never spin forever."""
        if not self.scheduler.queue:
            return
        req = self.scheduler.queue.pop(0)
        self._finish(req, "failed", "no-progress watchdog: queue head still "
                     f"not admitted after {self.watchdog_patience} "
                     "consecutive idle iterations", done)
