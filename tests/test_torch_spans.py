"""The serving engine's spans (``repro_torch.serve.spans``) on the CPU with
the smoke model: they are on the profiler's clock, step phases nest inside
their step, each request's ``queued`` / ``prefill`` / ``decode`` spans tile
its life from submit to terminal status (through preemption, cancel,
expiry and shedding), the ring counts what it overwrites, and
``decode_stats``' ``step_ms`` and TTFT come from the spans' stamps."""
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_parity as tp  # noqa: E402

from repro_torch.serve import spans  # noqa: E402

STEP_CHILDREN = {"expire", "grow", "admit", "dispatch", "retire"}
DISPATCH_CHILDREN = {"upload", "model", "choose", "sync"}
# 7 pages of 8 tokens for three lanes of up to 48 positions
# (tests/test_torch_preemption.py): the youngest lanes are preempted.
TIGHT = dict(page_size=8, pool_frac=0.34)
SLACK_NS = 50_000  # kineto's CPU stamps against time.time_ns (below)


@pytest.fixture(scope="module")
def smoke():
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import Model
    cfg = get_config("qwen2.5-32b", "smoke", dtype="float32", n_layers=2)
    model = Model(cfg, device="cpu")
    return model, model.init(0)


def _engine(smoke, mixed=True, **kw):
    from repro_torch.serve import Engine, EngineConfig
    model, params = smoke
    return Engine(model, params, config=EngineConfig(**dict(
        tp.ENGINE_KW, mixed=mixed, prefix_share=False, **kw)))


def _requests(lengths=tp.LENGTHS, budgets=tp.BUDGETS, **kw):
    from repro_torch.serve import Request
    return [Request(rid=i, prompt=p, max_new_tokens=b, **kw)
            for i, (p, b) in enumerate(zip(tp.prompts(256, lengths),
                                           budgets))]


def _serve(eng, reqs, ticks=tp.TICKS):
    lo = time.time_ns()
    done = eng.run(arrivals=list(zip(ticks, reqs)))
    got = spans.records(lo, time.time_ns())
    assert got.complete
    return done, got.spans


def _inside(inner, outer):
    return outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns


def _request_spans(all_spans, rid):
    return sorted((s for s in all_spans if s.rid == rid),
                  key=lambda s: (s.start_ns, s.sid))


def _check_tiles(all_spans, req):
    """The request's spans run back to back from its submit to its
    terminal status; a preemption reopens ``queued``."""
    mine = _request_spans(all_spans, req.rid)
    assert mine[0].name == "queued"
    assert mine[0].start_ns == req._submit_ns
    for a, b in zip(mine, mine[1:]):
        assert a.end_ns == b.start_ns, (a, b)
        assert (a.name, b.name) in {("queued", "prefill"),
                                    ("prefill", "decode"),
                                    ("prefill", "queued"),
                                    ("decode", "queued")}, (a, b)
    assert mine[-1].attrs == {"status": req.status}
    assert sum(s.end_ns - s.start_ns for s in mine) == \
        mine[-1].end_ns - req._submit_ns
    return mine


@pytest.mark.parametrize("mixed", [True, False])
def test_step_phases_nest_and_step_ms_reads_dispatch(smoke, mixed):
    """Every step phase lies inside its step, every dispatch phase inside
    its dispatch, siblings do not overlap; a decode or mixed step holds
    one dispatch; ``step_ms`` holds one entry per dispatch, its length."""
    eng = _engine(smoke, mixed=mixed)
    done, got = _serve(eng, _requests())
    assert all(r.status == "ok" for r in done)
    by_id = {s.sid: s for s in got}
    steps = [s for s in got if s.name == "step"]
    assert len(steps) == eng.decode_stats["clock_ticks"]
    kids = {}
    for s in got:
        if s.parent >= 0:
            kids.setdefault(s.parent, []).append(s)
            assert _inside(s, by_id[s.parent]), (s, by_id[s.parent])
    stepped = 0
    for st in steps:
        names = [c.name for c in kids.get(st.sid, ())]
        assert set(names) <= STEP_CHILDREN, names
        assert st.attrs is None
        assert names.count("dispatch") <= 1
        stepped += names.count("dispatch")
    for parent, cs in kids.items():
        cs = sorted(cs, key=lambda s: s.start_ns)
        assert all(a.end_ns <= b.start_ns for a, b in zip(cs, cs[1:]))
        if by_id[parent].name == "dispatch":
            assert {c.name for c in cs} == DISPATCH_CHILDREN
    st = eng.decode_stats
    for kind in ("decode", "mixed", "prefill"):
        ds = sorted((s for s in got if s.name == "dispatch"
                     and s.attrs["kind"] == kind), key=lambda s: s.start_ns)
        assert st["step_ms"][kind] == [(d.end_ns - d.start_ns) * 1e-6
                                       for d in ds]
    assert len(st["step_ms"]["mixed"]) == st["mixed_steps"]
    assert len(st["step_ms"]["decode"]) + len(st["step_ms"]["mixed"]) == \
        st["steps"] == stepped
    assert len(st["step_ms"]["prefill"]) == (0 if mixed else len(eng.stats))
    # a prefill sweep's dispatch lies inside its step's admit
    for d in got:
        if d.name == "dispatch" and d.attrs["kind"] == "prefill":
            assert by_id[d.parent].name == "admit"


@pytest.mark.parametrize("mixed", [True, False])
def test_request_spans_tile_submit_to_terminal(smoke, mixed):
    """``queued``, ``prefill`` and ``decode`` tile each request; the first
    token ends its one ``prefill``; TTFT's ``wall_s`` runs from submit to
    the start of ``decode``."""
    eng = _engine(smoke, mixed=mixed)
    done, got = _serve(eng, _requests())
    for req in done:
        mine = _check_tiles(got, req)
        assert [s.name for s in mine] == ["queued", "prefill", "decode"]
        assert mine[1].attrs == {"first": 1}
        assert eng.decode_stats["ttft"][req.rid]["wall_s"] == \
            (mine[2].start_ns - mine[0].start_ns) * 1e-9


@pytest.mark.parametrize("mixed", [True, False])
def test_preempted_request_reopens_queued(smoke, mixed):
    """A pool too small for its load preempts: the victim's open span
    closes and ``queued`` opens again under its rid; the resumed prefill's
    token is not a first token."""
    eng = _engine(smoke, mixed=mixed, **TIGHT)
    reqs = _requests(lengths=[30, 30, 30, 12], budgets=[8] * 4)
    done, got = _serve(eng, reqs, ticks=[1] * 4)
    assert eng.decode_stats["preemptions"] > 0
    requeued = 0
    for req in done:
        mine = _check_tiles(got, req)
        requeued += sum(s.name == "queued" for s in mine[1:])
        firsts = [s for s in mine if s.name == "prefill"
                  and s.attrs == {"first": 1}]
        assert len(firsts) == (1 if req.output else 0)
    assert requeued >= eng.decode_stats["preemptions_recovered"] > 0


@pytest.mark.parametrize("case", ["cancel_queued", "cancel_running",
                                  "expired", "shed"])
def test_terminal_status_closes_the_open_span(smoke, case):
    """A cancel, an expiry or a shed closes the request's open span with
    its status."""
    kw = {"max_pending": 1} if case == "shed" else {}
    eng = _engine(smoke, num_slots=1, **kw)
    reqs = _requests(lengths=[12, 12], budgets=[8, 8],
                     ttl_steps=3 if case == "expired" else None)
    lo = time.time_ns()
    eng.step(reqs)
    eng.step()
    if case.startswith("cancel"):
        assert eng.cancel(reqs[1 if case == "cancel_queued" else 0])
    while eng.has_work():
        eng.step()
    eng.finish_run()
    got = spans.records(lo, time.time_ns()).spans
    # (status, the span it closed) of each request
    want = {"cancel_queued": (("ok", "decode"), ("cancelled", "queued")),
            "cancel_running": (("cancelled", "decode"), ("ok", "decode")),
            "expired": (("timed_out", "decode"), ("timed_out", "queued")),
            "shed": (("ok", "decode"), ("shed", "queued"))}[case]
    assert tuple((r.status, _check_tiles(got, r)[-1].name)
                 for r in reqs) == want


def test_model_span_holds_the_model_calls_ops(smoke, monkeypatch):
    """The spans' clock is the profiler's: under a CPU ``torch.profiler``,
    every ``aten::`` op the model call launched (kineto's own intervals,
    inside a ``record_function`` around the call) lies inside its step's
    ``model`` span. Kineto stamps CPU events with the TSC and maps them to
    the wall clock by a line fitted at the profiler's start and stop, so
    its stamps may stray from ``time.time_ns`` by microseconds
    (``SLACK_NS``); consecutive ``model`` spans lie further apart than
    twice that, so a call can fall in its own span only."""
    from torch.profiler import ProfilerActivity, profile, record_function
    eng = _engine(smoke)
    dm = eng._dmodel
    for name in ("decode_step", "mixed_hidden", "logits"):
        def wrapped(*a, _f=getattr(dm, name), **k):
            with record_function("model_call"):
                return _f(*a, **k)
        monkeypatch.setattr(dm, name, wrapped)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, got = _serve(eng, _requests())
    events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()]
    calls = [(a, b) for n, a, b in events if n == "model_call"]
    models = sorted((s.start_ns, s.end_ns) for s in got if s.name == "model")
    assert len(models) == eng.decode_stats["steps"]
    assert min(b[0] - a[1] for a, b in zip(models, models[1:])) > \
        2 * SLACK_NS
    held = set()
    for a, b in calls:
        ops = [(x, y) for n, x, y in events
               if n.startswith("aten::") and a <= x and y <= b]
        assert ops
        inside = [m for m in models
                  if m[0] - SLACK_NS <= a and b <= m[1] + SLACK_NS]
        assert len(inside) == 1, (a, b)
        lo, hi = inside[0]
        assert all(lo - SLACK_NS <= x and y <= hi + SLACK_NS
                   for x, y in ops)
        held.add(inside[0])
    assert held == set(models)


def test_finish_run_warns_when_the_clock_steps_back(smoke, monkeypatch):
    """Span lengths are differences of the wall clock: a clock that steps
    back during the run gives negative ``step_ms`` and TTFT, and
    ``finish_run`` says so."""
    clock = iter(range(10**12, 0, -1000))
    monkeypatch.setattr(spans, "_now", lambda: next(clock))
    eng = _engine(smoke)
    with pytest.warns(RuntimeWarning, match="clock stepped back"):
        eng.run(arrivals=list(zip(tp.TICKS, _requests())))
    st = eng.decode_stats
    assert all(v < 0 for v in st["step_ms"]["decode"])
    assert all(t["wall_s"] < 0 for t in st["ttft"].values())


def test_ring_counts_what_it_overwrites():
    """A ring of 4: the fifth and sixth records overwrite the first two; a
    read reaching back to them says it is not complete."""
    rec = spans.Recorder(4)
    for i in range(6):
        rec.end(rec.begin(f"s{i}", t=10 * i), t=10 * i + 5)
    got = rec.records(0, 100)
    assert got.overwritten == 2
    assert not got.complete
    assert [s.name for s in got.spans] == ["s2", "s3", "s4", "s5"]
    assert rec.records(16, 100).complete
    assert not rec.records(15, 100).complete
    assert [s.name for s in rec.records(31, 42).spans] == ["s3", "s4"]
    tok = rec.begin("a", parent=7, step=3, rid=9, t=100)
    nxt = rec.switch(tok, "b", {"x": 1})
    rec.end(nxt, t=nxt[5])
    a, b = rec.records(100, np.iinfo(np.int64).max).spans[-2:]
    assert (a.name, a.parent, a.step, a.rid, a.attrs) == ("a", 7, 3, 9,
                                                           {"x": 1})
    assert (b.parent, b.step, b.rid, b.start_ns) == (7, 3, 9, a.end_ns)
    assert rec.records(0, 100).overwritten == 4
