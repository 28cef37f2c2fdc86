"""Every cell of ``BENCHMARK.json`` resolves to files that exist, and each
per-layer metric's file agrees with its entry."""
import pytest

pytest.importorskip("torch")

import json  # noqa: E402
import re  # noqa: E402
from pathlib import Path  # noqa: E402

from bench.lib.modelspec import load_spec  # noqa: E402
from bench.lib.readers import load_reader  # noqa: E402
from bench.lib.traffic import load_mix  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
B = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CELLS = [c["name"] for c in B["workloads"]]


def test_top_level_keys_and_command():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert B["command"] == ["python3", "bench/run.py"]
    assert B["paths"] == ["bench"]
    assert 1 <= B["run_seconds"] <= 51


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    c = next(w for w in B["workloads"] if w["name"] == cell)
    conf = next(x for x in B["configs"] if x["name"] == c["config"])
    spec = load_spec(ROOT / conf["file"])
    assert spec.name == conf["name"]
    mix = load_mix(BENCH / "traffic" / f"{c['traffic']}.json")
    assert mix.name == c["traffic"]
    lim = json.loads((BENCH / "limits" / f"{cell}.json").read_text())
    assert lim["widest_gap"]["limit"] > 0
    assert c["chips"] == 1 and len(c["why"]) <= 200
    raw = json.loads((ROOT / conf["file"]).read_text())
    assert (ROOT / raw["reference"]).is_file()
    assert set(conf["reduced"]) <= set(raw) and raw["reduced"] == \
        conf["reduced"]
    for group in ("end_to_end", "per_layer"):
        names = [m["name"] for m in B[group]
                 if "workloads" not in m or cell in m["workloads"]]
        assert names, group


@pytest.mark.parametrize("conf", [c["name"] for c in B["configs"]])
def test_config_lists_each_departure(conf):
    """Every key in ``reduced`` is a top-level key of the file whose value
    as run differs from the published one beside it, and is explained."""
    c = next(x for x in B["configs"] if x["name"] == conf)
    raw = json.loads((ROOT / c["file"]).read_text())
    assert set(raw["published"]) == set(c["reduced"])
    for k in c["reduced"]:
        assert raw[k] != raw["published"][k], k
        assert raw["assumed"][k], k


def test_names_units_and_sources():
    seen = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for m in B[group]:
            assert NAME.match(m["name"]), m["name"]
            seen.add((group, m["name"]))
    assert len(seen) == sum(len(B[g]) for g in ("configs", "workloads",
                                                 "end_to_end", "per_layer"))
    e2e = {m["name"] for m in B["end_to_end"]}
    assert "setup_s" in e2e
    for m in B["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert load_reader("endtoend", m["name"]).UNIT == m["unit"]
        for w in m.get("workloads", []):
            assert w in CELLS
    for m in B["per_layer"]:
        mod = load_reader("metrics", m["name"])
        assert (mod.LAYER, mod.MOVES, mod.UNIT, mod.SOURCE) == \
            (m["layer"], m["moves"], m["unit"], m["source"])
        assert m["moves"] in e2e
        moved = next(e for e in B["end_to_end"] if e["name"] == m["moves"])
        for w in m.get("workloads", CELLS):
            assert w in CELLS
            assert "workloads" not in moved or w in moved["workloads"]
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_every_roofline_has_an_mfu_beside_it():
    mfu_moves = {m["moves"] for m in B["per_layer"] if "mfu" in m["name"]}
    for m in B["per_layer"]:
        if m["name"].endswith("_roofline"):
            assert m["moves"] in mfu_moves
