"""Both engines serving the MoE family (dbrx-132b, arctic-480b smoke,
float32) against the reference Engine at the published capacity factor
1.25, with the reference's params bridged over (``tests/_torch_parity.py::
moe_pair``): the mixed engine (prefix sharing with hits, and a cut pool
that preempts), the phase-serialized engine over paged lanes (with hits)
and contiguous lanes, and compressed dbrx. Tokens, statuses and host
counters exact; claims dropped in every run (the port's
``router_counts``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_parity as tp  # noqa: E402

tp.tf32_off()


_TIMED = ("step_ms", "ttft")
LENGTHS = [3, 11, 25, 7, 40, 45, 33]
BUDGETS = [4, 2, 12, 3, 6, 9, 5]


def _stats(eng):
    """Every key of decode_stats but wall-clock timings (the weight bytes
    per step among them)."""
    return {k: v for k, v in eng.decode_stats.items() if k not in _TIMED}


def _rounds(shared: bool):
    prompts = tp.prompts(256, LENGTHS)
    rnd = [(i, p, b) for i, (p, b) in enumerate(zip(prompts, BUDGETS))]
    if not shared:
        return [rnd]
    # a second round on the same engine: two prompts behind round 1's
    # 25-token prompt's first 16 tokens (two pages of 8), one of them late
    rng = np.random.default_rng(9)
    tails = [rng.integers(0, 256, size=n).astype(np.int32) for n in (5, 9)]
    return [rnd, [(7, np.concatenate([prompts[2][:16], tails[0]]), 6),
                  (2, (8, np.concatenate([prompts[2][:16], tails[1]]), 4)),
                  (9, tp.prompts(256, [14], seed=4)[0], 5)]]


@pytest.mark.parametrize("arch,fmt,kw", [
    ("dbrx-132b", "dense", {"page_size": 8, "shared": True}),
    ("arctic-480b", "dense", {"page_size": 8, "pool_frac": 0.5}),
    ("dbrx-132b", "dense", {"mixed": False, "page_size": 8,
                            "shared": True}),
    ("arctic-480b", "dense", {"mixed": False, "paged": False}),
    ("dbrx-132b", "compressed", {}),
], ids=["dbrx_mixed_shared", "arctic_mixed_cut_pool",
        "dbrx_serialized_paged_shared", "arctic_serialized_contiguous",
        "dbrx_compressed_mixed"])
def test_engines_match_reference(arch, fmt, kw):
    """Both engines at the published capacity factor (claims dropped over
    the run): tokens, statuses and every host counter
    of decode_stats equal the reference Engine's, the weight bytes per
    step (every expert leaf) included. ``shared``: a second round whose
    prompts share a cached prefix (hits); ``pool_frac`` 0.5 preempts."""
    from repro_torch.models import moe as TMoE
    jm, jp, tm, tparams = tp.moe_pair(arch, fmt)
    kw = dict(kw)
    rounds = _rounds(kw.pop("shared", False))
    ekw = dict(max_len=16, max_new_tokens=12, num_slots=3, max_prompt_len=48,
               **kw)
    want, wst, jeng = tp.serve_rounds("repro", jm, jp, rounds, **ekw)
    TMoE.reset_router_counts()
    got, gst, eng = tp.serve_rounds("repro_torch", tm, tparams, rounds,
                                    **ekw)
    assert got == want
    assert all(s == "ok" for _, s in got.values())
    assert gst == wst
    assert _stats(eng) == _stats(jeng)
    assert TMoE.router_counts()["dropped"] > 0
    if len(rounds) > 1:
        assert gst[1]["prefix_hit_ratio"] > 0
    if kw.get("pool_frac"):
        assert eng.decode_stats["preemptions"] > 0
