"""The port's Engine on recurrent stacks (mamba2-370m, recurrentgemma-2b)
against the reference Engine at float32 on the CPU: tokens, statuses and
``decode_stats`` counters equal, and the prefill sweeps' rows and
utilization too.

Workloads: the reference's own (``tests/test_serve_continuous.py``:
mamba2 prompts 3-8, recurrentgemma 3-11) plus prompts past the SSD chunk
(16) and past recurrentgemma's window (32), two arriving mid-decode; the
recurrentgemma stack paged (its local layers' ring of 32 in the pool) and
contiguous; a cut pool that preempts; compressed mamba2 weights. Then the
slot table's state lanes (release, re-assign), the sharing gate, the
mixed-step refusal and the row-per-request scheduler. One reference run
per workload (module-scoped).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_parity as tp  # noqa: E402

KW = dict(max_len=16, max_new_tokens=8, num_slots=2, max_prompt_len=48)
WORKLOADS = {
    "mamba2-370m": ([3, 7, 5, 8, 4, 20, 33], [4, 3, 2, 4, 3, 5, 4]),
    "recurrentgemma-2b": ([3, 11, 7, 5, 9, 40, 37], [4, 2, 5, 3, 4, 5, 6]),
}
TICKS = [0, 0, 0, 0, 0, 2, 5]
STATS = ("steps", "decoded_tokens", "slot_utilization", "kv_blocks_visited",
         "kv_blocks_dense", "kv_bytes_per_token", "paged", "preemptions",
         "preemptions_recovered", "kv_pages_total", "kv_memory_ratio",
         "prefix_hit_ratio", "pages_shared", "mixed", "mixed_steps",
         "status_counts", "device_time", "clock_ticks")
_PAIRS: dict = {}


def _pair(arch, **over):
    key = (arch, tuple(sorted(over.items())))
    if key not in _PAIRS:
        nl = 3 if arch == "recurrentgemma-2b" else 2
        cfg, jm, jp = tp.jax_smoke(arch, n_layers=nl, **over)
        tm, tparams = tp.torch_smoke(arch, jp, n_layers=nl, **over)
        _PAIRS[key] = (cfg, jm, jp, tm, tparams)
    return _PAIRS[key]


def _serve(pkg, model, params, items, **cfg_kw):
    """One ``run`` of ``items`` ((tick, rid, prompt, budget)) on a fresh
    engine: ({rid: (output, status)}, {stat: value}, sweep stats)."""
    import importlib
    serve = importlib.import_module(pkg + ".serve")
    eng = serve.Engine(model, params, config=serve.EngineConfig(**cfg_kw))
    arrivals = []
    for tick, rid, prompt, budget in items:
        req = serve.Request(rid=rid, prompt=prompt, max_new_tokens=budget)
        if tick:
            arrivals.append((tick, req))
        else:
            eng.submit(req)
    done = eng.run(arrivals=arrivals)
    stats = {k: eng.decode_stats[k] for k in STATS}
    return ({r.rid: (list(r.output), r.status) for r in done}, stats,
            [(s["rows"], s["n_requests"], round(s["utilization"], 9))
             for s in eng.stats])


def _items(arch, cfg):
    lengths, budgets = WORKLOADS[arch]
    ps = tp.prompts(cfg.vocab_size, lengths)
    return [(t, i, p, b) for i, (t, p, b) in
            enumerate(zip(TICKS, ps, budgets))]


CASES = [("mamba2-370m", {}), ("recurrentgemma-2b", {}),
         ("recurrentgemma-2b", {"paged": False, "decode_attn": "dense"})]


@pytest.fixture(scope="module", params=CASES,
                ids=["mamba2", "rgemma-paged", "rgemma-contiguous"])
def served(request):
    arch, over = request.param
    cfg, jm, jp, tm, tparams = _pair(arch)
    items = _items(arch, cfg)
    ref = _serve("repro", jm, jp, items, **KW, **over)
    got = _serve("repro_torch", tm, tparams, items, **KW, **over)
    return arch, over, ref, got, items


def test_engine_tokens_match_reference(served):
    arch, over, ref, got, _ = served
    assert got[0] == ref[0]
    assert all(st == "ok" for _, st in got[0].values())


def test_engine_counters_match_reference(served):
    """Every counter equal; mamba2 has no kv blocks and no pages,
    recurrentgemma's local layers visit blocks of their ring."""
    arch, over, ref, got, _ = served
    assert got[1] == ref[1]
    if arch == "mamba2-370m":
        assert got[1]["kv_blocks_dense"] == 0 and not got[1]["paged"]
    else:
        assert got[1]["kv_blocks_dense"] > 0
        assert got[1]["paged"] == over.get("paged", True)
    assert got[1]["prefix_hit_ratio"] == 0.0


def test_engine_prefill_sweeps_match_reference(served):
    """One row per request, right-aligned: the same sweeps (rows,
    requests, utilization over SSD-chunk-rounded widths)."""
    _, _, ref, got, _ = served
    assert got[2] == ref[2]


def test_tda_decode_matches_dense_path():
    """The decode kernels' path (on the CPU their plain versions) gives
    the dense path's tokens and counters on recurrentgemma, paged and
    contiguous."""
    cfg, jm, jp, tm, tparams = _pair("recurrentgemma-2b")
    items = _items("recurrentgemma-2b", cfg)
    for paged in (True, False):
        a = _serve("repro_torch", tm, tparams, items, **KW, paged=paged,
                   decode_attn="tda")
        b = _serve("repro_torch", tm, tparams, items, **KW, paged=paged,
                   decode_attn="dense")
        assert a[0] == b[0] and a[1] == b[1]


def test_cut_pool_preempts_as_the_reference():
    """recurrentgemma on a cut pool (6 pages of 8 for 3 slots whose lanes
    grow to the 32-position ring): the reference preempts twice; so does
    the port, with the same tokens and counters (the continuation
    re-prefills its state from prompt + output)."""
    cfg, jm, jp, tm, tparams = _pair("recurrentgemma-2b")
    ps = tp.prompts(cfg.vocab_size, [5, 6, 7], seed=3)
    items = [(0, i, p, 24) for i, p in enumerate(ps)]
    kw = dict(max_len=16, max_new_tokens=24, num_slots=3, max_prompt_len=16,
              pool_frac=0.5, page_size=8)
    ref = _serve("repro", jm, jp, items, **kw)
    got = _serve("repro_torch", tm, tparams, items, **kw)
    assert ref[1]["preemptions"] == 2
    assert got == ref


def test_compressed_mamba2_engine_matches_reference():
    """mamba2 with factorized SSD projections, W_D projected and
    compressed by the reference's ``compress_params``, bridged: the port's
    Engine (decompressing on the CPU) gives the reference Engine's tokens
    and counters, with the audited stream bits."""
    import jax
    from repro.core import factorized as rf
    from repro_torch.core import factorized as tf
    arch = "mamba2-370m"
    cfg, jm, jp = tp.jax_smoke(
        arch, factorization=rf.FactorizationConfig(**tp.MOE_FCFG))
    jmc, jcp, stats = jm.compress_params(rf.project_wd_leaves(
        jp, cfg.factorization))
    assert "wd_vq" in jcp["layers"]["ssd"]["in_proj"]
    tm, tcp = tp.torch_smoke(
        arch, jcp, factorization=tf.FactorizationConfig(**tp.MOE_FCFG),
        weight_format="compressed")
    items = _items(arch, cfg)[:5]
    kw = dict(KW, weight_stream_bits=stats["weight_stream_bits"])
    ref = _serve("repro", jmc, jcp, items, **kw)
    got = _serve("repro_torch", tm, tcp, items, **kw)
    assert got == ref
    assert jax.tree.leaves(jcp)  # the compressed tree is non-empty


@pytest.mark.parametrize("arch", ["mamba2-370m", "recurrentgemma-2b"])
def test_release_then_assign_leaves_no_stale_state(arch):
    """A state lane released and re-assigned equals a fresh assignment of
    the new request's prefill (every leaf of the slot, the reference's
    property), contiguous and paged."""
    from repro_torch.serve.kv_slots import SlotKVCache
    cfg, jm, jp, tm, tparams = _pair(arch)
    rng = np.random.default_rng(7)
    pa, pb = (rng.integers(0, cfg.vocab_size, 8).astype(np.int32)
              for _ in range(2))

    def prefill(prompt):
        caches = tm.init_cache(1, 8, ring=False)
        tm.hidden(tparams, {"inputs": tp.t(prompt[None])}, caches=caches)
        return caches

    for page_size in (None, 8):
        sl = SlotKVCache(tm, num_slots=2, cache_len=16, page_size=page_size)
        fresh = SlotKVCache(tm, num_slots=2, cache_len=16,
                            page_size=page_size)
        sl.assign(0, "A", prefill(pa), row=0, start=0, length=8)
        sl.release(0)
        sl.assign(0, "B", prefill(pb), row=0, start=0, length=8)
        fresh.assign(0, "B", prefill(pb), row=0, start=0, length=8)
        for path in sl._paths:
            if path in sl._kv:
                continue
            a, b = sl._leaf(sl.caches, path), sl._leaf(fresh.caches, path)
            assert torch.equal(a[:, 0], b[:, 0]), path
            assert a[:, 0].abs().sum() > 0, path


@pytest.mark.parametrize("arch", ["mamba2-370m", "recurrentgemma-2b"])
def test_sharing_gate_and_mixed_refusal(arch):
    """Sharing switches itself off on stacks with state lanes (zero hits,
    zero pages shared, as in the reference); ``mixed=True`` is refused
    with the reference's message; the default resolves to the serialized
    engine (mamba2 unpaged, recurrentgemma paged)."""
    from repro.serve import Engine as JE
    from repro.serve import EngineConfig as JC
    from repro_torch.core.errors import UnsupportedConfigError
    from repro_torch.serve import Engine, EngineConfig, Request
    cfg, jm, jp, tm, tparams = _pair(arch)
    eng = Engine(tm, tparams, config=EngineConfig(max_len=16,
                                                  max_new_tokens=4,
                                                  num_slots=2))
    ref = JE(jm, jp, config=JC(max_len=16, max_new_tokens=4, num_slots=2))
    assert not eng.prefix_share and not ref.prefix_share
    assert not eng.mixed and eng.paged == ref.paged \
        == (arch == "recurrentgemma-2b")
    p = tp.prompts(cfg.vocab_size, [7])[0]
    eng.submit(Request(rid=0, prompt=p, max_new_tokens=3))
    eng.run()
    assert eng.decode_stats["prefix_hit_ratio"] == 0.0
    assert eng.decode_stats["pages_shared"] == 0
    with pytest.raises(UnsupportedConfigError) as mine:
        Engine(tm, tparams, config=EngineConfig(mixed=True))
    with pytest.raises(Exception) as theirs:
        JE(jm, jp, config=JC(mixed=True))
    assert str(mine.value) == str(theirs.value)


def test_row_per_request_scheduler_matches_reference():
    """``Scheduler(pack=False)``: the reference's admissions (requests,
    row widths, head-blocking on ``max_rows`` and free slots)."""
    from repro.serve.scheduler import Request as JR
    from repro.serve.scheduler import Scheduler as JS
    from repro_torch.serve.scheduler import Request, Scheduler
    lengths = [3, 40, 17, 5, 9, 16, 2]
    ps = tp.prompts(256, lengths)
    for free, rows in ((8, 3), (2, 8), (5, 5)):
        mine, ref = Scheduler(16, max_rows=rows, pack=False), \
            JS(16, max_rows=rows, pack=False)
        for i, p in enumerate(ps):
            mine.submit(Request(rid=i, prompt=p))
            ref.submit(JR(rid=i, prompt=p))
        while ref.pending():
            a, b = mine.next_admissions(free), ref.next_admissions(free)
            assert [[r.rid for r in g.requests] for g in a] \
                == [[r.rid for r in g.requests] for g in b]
            assert [g.row_width for g in a] == [g.row_width for g in b]
            assert [g.utilization for g in a] == [g.utilization for g in b]
        assert not mine.pending()
