"""The readers of the program's spans (``bench/lib/program_spans.py`` and
five metrics) against span logs and kernel lists built by hand, with the
counts worked out by hand; and one traced harness run on the CPU, whose
``dispatch`` spans pair one to one with the harness's step records."""
import pytest

pytest.importorskip("torch")

import time  # noqa: E402

import numpy as np  # noqa: E402

from bench import run as bench_run  # noqa: E402
from bench.lib import program, program_spans  # noqa: E402
from bench.lib.drive import StepRec, Window  # noqa: E402
from bench.lib.modelspec import spec_from_dict  # noqa: E402
from bench.lib.readers import Run, load_reader  # noqa: E402
from bench.lib.traffic import mix_from_dict  # noqa: E402
from bench.test_bench_faults import CONF, LIMIT, MIX  # noqa: E402

program._import_path()

from repro_torch.serve import spans  # noqa: E402

SPAN_METRICS = ("queue_wait_ms", "request_prefill_ms", "decode_enqueue_ms")
TRACE_METRICS = ("decode_launches", "idle_dispatch_share")
T0 = 5 * 10**9  # ns


def _step(kind, a, b, traced):
    return StepRec(kind=kind, lengths=np.array([4]), n_new=np.array([1]),
                   slots=2, pages_in_use=1, pages_total=4, run_ms=0.0,
                   ns_step=(T0 + a, T0 + b), traced=traced)


def _log():
    """Two traced decode steps (0-1000, 1000-2000 ns after T0) and an
    untraced mixed one (2000-3000), with request spans around them."""
    rec = spans.Recorder(256)

    def put(name, a, b, parent=-1, rid=-1, attrs=None):
        tok = rec.begin(name, parent, 1, rid, t=T0 + a)
        rec.end(tok, attrs, t=T0 + b)
        return tok[0]

    for lo, phases, (u, m, c, y) in (
            (0, (("expire", 0, 10), ("grow", 10, 20)),
             (100, 200, 500, 600)),
            (1000, (), (1100, 1150, 1450, 1500))):
        st = rec.begin("step", t=T0 + lo)
        for name, a, b in phases:
            put(name, lo + a, lo + b, st[0])
        d = rec.begin("dispatch", st[0], t=T0 + u)
        for name, a, b in (("upload", u, m), ("model", m, c),
                           ("choose", c, y), ("sync", y, lo + 890)):
            put(name, a, b, d[0])
        rec.end(d, {"kind": "decode"}, t=T0 + lo + 900)
        put("retire", lo + 900, lo + 1000, st[0])
        rec.end(st, t=T0 + lo + 1000)
    st = rec.begin("step", t=T0 + 2000)
    put("dispatch", 2000, 2900, st[0], attrs={"kind": "mixed"})
    rec.end(st, t=T0 + 3000)
    # requests: claimed in the window after 5020, 20 and 200 ns (rid 5
    # after a preemption); first tokens 2480 and 920 ns after the claim
    put("queued", -5000, 20, rid=1)
    put("prefill", 20, 2500, rid=1, attrs={"first": 1})
    put("queued", 10, 30, rid=2)
    put("prefill", 30, 950, rid=2, attrs={"first": 1})
    put("queued", 40, 60, rid=3, attrs={"status": "cancelled"})
    put("queued", -9000, -8000, rid=4)
    put("prefill", -8000, -7000, rid=5, attrs={"first": 1})
    put("decode", -7000, 400, rid=5)
    put("queued", 400, 600, rid=5)
    put("prefill", 600, 800, rid=5, attrs={"first": 0})
    return rec


def _run(trace=True):
    steps = [_step("decode", 0, 1000, True),
             _step("decode", 1000, 2000, True),
             _step("mixed", 2000, 3000, False)]
    # device ops (s): three start in the first decode dispatch, one in the
    # second; the last one runs after the traced window
    kernels = [(n, (T0 + a) * 1e-9, (T0 + b) * 1e-9) for n, a, b in (
        ("k1", 250, 450), ("k2", 460, 560), ("memcpy", 620, 880),
        ("k4", 1160, 1880), ("k5", 2100, 2500))]
    tr = {"kernels": kernels, "busy_s": 0.0,
          "window_s": (T0 + 2000) * 1e-9 - T0 * 1e-9} if trace else None
    return Run(workload="w",
               spec=spec_from_dict(dict(CONF, torch_dtype="float32")),
               mix=mix_from_dict(MIX), window=Window(steps=steps),
               setup_s=1.0, trace=tr)


def _read(name, run):
    return load_reader("metrics", name).read(run)


def test_readers_against_hand_counts(monkeypatch):
    rec = _log()
    monkeypatch.setattr(program_spans, "_recorder", lambda: rec)
    run = _run()
    # queued spans a claim ended inside [T0, T0 + 3000]: 5020, 20, 200 ns
    assert _read("queue_wait_ms", run) == pytest.approx(5240 / 3 * 1e-6)
    # prefills that ended in a first token in the window: 2480, 920 ns
    assert _read("request_prefill_ms", run) == pytest.approx(1700e-6)
    # upload + model + choose: 100 + 300 + 100, 50 + 300 + 50 ns
    assert _read("decode_enqueue_ms", run) == pytest.approx(450e-6)
    # 3 then 1 device ops start inside the two decode dispatches
    assert _read("decode_launches", run) == 2.0
    # gaps 0-250, 450-460, 560-620, 880-1160, 1880-2000 cut by span
    idle = program_spans.idle_by_span(run)
    want = {"expire": 10, "grow": 10, "step": 180, "upload": 150,
            "model": 70, "choose": 40, "sync": 40, "dispatch": 20,
            "retire": 200}
    assert set(idle) == set(want)
    for name, ns in want.items():
        assert idle[name] == pytest.approx(ns * 1e-9, abs=1e-12), name
    assert _read("idle_dispatch_share", run) == pytest.approx(
        100 * 260 / 2000, rel=1e-5)


def test_readers_read_nothing_without_their_source(monkeypatch):
    """No recorder in the program (an older checkout), a ring that
    overwrote spans of the window, no trace, a trace without device
    operations: every reader gives None."""
    monkeypatch.setattr(program_spans, "_recorder", lambda: None)
    for name in SPAN_METRICS + TRACE_METRICS:
        assert _read(name, _run()) is None, name
    rec = _log()
    for _ in range(rec.size):
        rec.end(rec.begin("x", t=T0 + 50), t=T0 + 60)
    monkeypatch.setattr(program_spans, "_recorder", lambda: rec)
    assert rec.records(T0, T0 + 3000).overwritten > 0
    for name in SPAN_METRICS + TRACE_METRICS:
        assert _read(name, _run()) is None, name
    monkeypatch.setattr(program_spans, "_recorder", _log)
    for name in TRACE_METRICS:
        assert _read(name, _run(trace=False)) is None, name
        run = _run()
        run.trace["kernels"] = []
        assert _read(name, run) is None, name
    monkeypatch.undo()
    assert program_spans._recorder() is spans


def test_traced_cpu_run_pairs_dispatch_spans_with_step_records(monkeypatch):
    """One traced harness run on the CPU: each ``dispatch`` span pairs with
    one of the harness's step records (same kind; the harness's device
    call lies inside the dispatch, the harness's step around the
    program's), the span metrics read values, and the device-trace ones
    read None (no device op in a CPU trace)."""
    kept = {}
    serve = bench_run.serve

    def keep(*a, **k):
        out = serve(*a, **k)
        kept["window"] = out[0]
        return out

    monkeypatch.setattr(bench_run, "serve", keep)
    lo = time.time_ns()
    out = bench_run.run_cell(
        spec_from_dict(dict(CONF, torch_dtype="float32")),
        mix_from_dict(MIX), "t", 2**31 + 7, 4.0, True, "cpu", LIMIT,
        list(SPAN_METRICS + TRACE_METRICS) + ["decode_step_ms"],
        time.perf_counter())
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == set(SPAN_METRICS) | {"decode_step_ms"}
    assert all(out["metrics"][n]["value"] > 0 for n in SPAN_METRICS)
    steps = kept["window"].steps
    got = spans.records(lo, time.time_ns())
    assert got.complete
    by_id = {s.sid: s for s in got.spans}
    ds = sorted((s for s in got.spans if s.name == "dispatch"),
                key=lambda s: s.start_ns)
    assert len(ds) == len(steps) > 10
    assert {s.kind for s in steps} == {"decode", "mixed"}
    for d, rec in zip(ds, steps):
        st = by_id[d.parent]
        assert st.name == "step"
        assert d.attrs["kind"] == rec.kind
        assert d.start_ns <= rec.ns_run[0] <= rec.ns_run[1] <= d.end_ns
        assert rec.ns_step[0] <= st.start_ns <= st.end_ns <= rec.ns_step[1]
