"""The traffic generator: the same seed gives the same requests, another
seed another order of the same sizes."""
import pytest

pytest.importorskip("torch")

import json  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

from bench.lib.traffic import draw_items, draw_sizes, load_mix  # noqa: E402

TRAFFIC = Path(__file__).resolve().parent / "traffic"
MIXES = sorted(p.stem for p in TRAFFIC.glob("*.json"))


SECONDS = 51.0


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_requests(name):
    mix = load_mix(TRAFFIC / f"{name}.json")
    a = draw_items(mix, 2**31 + 7, 1000, SECONDS)
    b = draw_items(mix, 2**31 + 7, 1000, SECONDS)
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert np.array_equal(x.prompt, y.prompt)
        assert (x.max_new, x.due_s, x.client) == (y.max_new, y.due_s,
                                                  y.client)


def _lists(items):
    """Each caller's list of (prompt length, output budget)."""
    out = {}
    for it in items:
        out.setdefault(it.client, []).append((len(it.prompt), it.max_new))
    return out


@pytest.mark.parametrize("name", MIXES)
def test_other_seed_same_work_other_order(name):
    """Another seed replays the same trace of sizes and arrivals, in the
    same order, with other token ids."""
    mix = load_mix(TRAFFIC / f"{name}.json")
    a = draw_items(mix, 11, 1000, SECONDS)
    b = draw_items(mix, 12, 1000, SECONDS)
    assert [(len(i.prompt), i.max_new, i.due_s, i.client) for i in a] == \
        [(len(i.prompt), i.max_new, i.due_s, i.client) for i in b]
    assert not np.array_equal(a[0].prompt[:16], b[0].prompt[:16])
    plen, olen, _ = draw_sizes(mix, SECONDS)
    if mix.loop == "open":
        assert all(np.diff([i.due_s for i in a]) >= 0)
        # every request is due inside the window
        assert 0 < a[-1].due_s < SECONDS
        assert len(a) == round(mix.rate_per_s * SECONDS)
        assert [len(i.prompt) for i in a] == plen.tolist()
    else:
        # caller c sends row c of the lists, in order
        lists = _lists(a)
        for c in range(mix.clients):
            assert lists[c] == list(zip(plen[c].tolist(), olen[c].tolist()))


@pytest.mark.parametrize("name", MIXES)
def test_sizes_inside_bands(name):
    mix = load_mix(TRAFFIC / f"{name}.json")
    plen, olen, gaps = draw_sizes(mix, SECONDS)
    assert plen.min() >= mix.prompt["min"] and plen.max() <= mix.prompt["max"]
    assert olen.min() >= mix.output["min"] and olen.max() <= mix.output["max"]
    e = mix.engine
    assert plen.max() <= e["max_prompt_len"] and olen.max() <= \
        e["max_new_tokens"]
    if mix.loop == "open":
        assert gaps.sum() == pytest.approx(SECONDS)
    else:
        assert e["num_slots"] == mix.clients
        assert plen.shape == (mix.clients, mix.per_client)


def test_every_mix_is_json_with_a_why():
    for name in MIXES:
        d = json.loads((TRAFFIC / f"{name}.json").read_text())
        assert d["name"] == name and d["why"]


@pytest.mark.parametrize("name", MIXES)
def test_every_mix_names_its_source_and_bands(name):
    """Lengths come from published statistics: the file names them and
    says how its bands follow from them."""
    d = json.loads((TRAFFIC / f"{name}.json").read_text())
    assert "arXiv:" in d["source"] or "github.com/" in d["source"]
    for side in ("prompt", "output"):
        assert f"{d[side]['min']}-{d[side]['max']}" in d["bands"]
