"""The ``mixed_step_columns`` reader against span logs built by hand: the
mean ``cols`` of the window's mixed dispatches, and None where the program
has no recorder, the ring overwrote the window, or the dispatches carry no
``cols`` (a program that runs every column and does not say so)."""
import pytest

pytest.importorskip("torch")

from bench.lib import program, program_spans  # noqa: E402
from bench.test_bench_spans import T0, _read, _run  # noqa: E402

program._import_path()

from repro_torch.serve import spans  # noqa: E402


def _log(first, second):
    """A decode dispatch and two mixed ones inside [T0, T0 + 3000] ns, and
    a mixed one after the window."""
    rec = spans.Recorder(64)
    for kind, a, b, extra in (("decode", 100, 900, {"cols": 1}),
                              ("mixed", 2100, 2400, first),
                              ("mixed", 2500, 2900, second),
                              ("mixed", 9000, 9500, {"cols": 999})):
        rec.end(rec.begin("dispatch", t=T0 + a), dict(extra, kind=kind),
                t=T0 + b)
    return rec


@pytest.mark.parametrize("attrs,want", [
    (({"cols": 40, "live": 40}, {"cols": 11, "live": 11}), 25.5),
    (({"cols": 96, "live": 40}, {"cols": 96, "live": 11}), 96.0),
    (({}, {}), None),
], ids=["packed", "every_column", "no_cols"])
def test_mixed_step_columns_reads_mixed_dispatches(monkeypatch, attrs, want):
    """The mean ``cols`` of the mixed dispatches that start in the window
    (decode dispatches, and a mixed one after the window, left out); left
    out where the dispatches carry no ``cols`` (an older program)."""
    rec = _log(*attrs)
    monkeypatch.setattr(program_spans, "_recorder", lambda: rec)
    got = _read("mixed_step_columns", _run())
    assert got == (None if want is None else pytest.approx(want))


def test_mixed_step_columns_reads_nothing_without_its_source(monkeypatch):
    """No recorder in the program (an older checkout), or a ring that
    overwrote spans of the window: the reader gives None."""
    monkeypatch.setattr(program_spans, "_recorder", lambda: None)
    assert _read("mixed_step_columns", _run()) is None
    rec = _log({"cols": 40}, {"cols": 11})
    for _ in range(rec.size):
        rec.end(rec.begin("x", t=T0 + 50), t=T0 + 60)
    monkeypatch.setattr(program_spans, "_recorder", lambda: rec)
    assert rec.records(T0, T0 + 3000).overwritten > 0
    assert _read("mixed_step_columns", _run()) is None
