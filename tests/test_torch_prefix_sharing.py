"""Prefix sharing with copy-on-write in the port, held to the reference:
the page pool op by op (probe, publish, ``map_shared``, copy-on-write,
adopt, release into the retained LRU, eviction, drop) on fixed seeds;
the slot table's offset assigns, page copies and prefix gathers; the
scheduler's shared admissions; the suffix prefill; and both engines
(mixed, and serialized over fp and int8 lanes) against the reference
Engine's tokens and counters, and against the port's own cold and
contiguous runs."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_parity as tp  # noqa: E402

tp.tf32_off()

ARCHS = ["qwen2.5-32b", "qwen1.5-4b"]
# (mixed, kv_quant): the mixed engine takes fp lanes only, as in the
# reference; the serialized engine serves both.
ENGINES = {"mixed": (True, False), "serialized": (False, False),
           "serialized_int8": (False, True)}
KW = dict(max_len=16, max_new_tokens=6, num_slots=2, max_prompt_len=40,
          page_size=8)


@pytest.fixture(scope="module")
def models():
    out = {}
    for arch in ARCHS:
        cfg, jm, jp = tp.jax_smoke(arch)
        tm, tparams = tp.torch_smoke(arch, jp)
        out[arch] = (cfg, jm, jp, tm, tparams)
    return out


def _pair(models, arch, kv_quant):
    """(reference model, params, port model, params), int8 lanes when
    ``kv_quant`` (same weights)."""
    from repro.models.transformer import Model as JModel
    from repro_torch.models.transformer import Model
    cfg, jm, jp, tm, tparams = models[arch]
    if kv_quant:
        jm = JModel(dataclasses.replace(jm.cfg, kv_quant=True))
        tm = Model(dataclasses.replace(tm.cfg, kv_quant=True), device="cpu")
    return jm, jp, tm, tparams


def _both(models, arch, engine, rounds, **kw):
    """The reference and the port on the same rounds; asserts equal
    outputs, statuses and host counters, returns the port's run."""
    mixed, kv_quant = ENGINES[engine]
    jm, jp, tm, tparams = _pair(models, arch, kv_quant)
    cfg_kw = dict(KW, mixed=mixed, **kw)
    ref_out, ref_st, _ = tp.serve_rounds("repro", jm, jp, rounds, **cfg_kw)
    out, st, eng = tp.serve_rounds("repro_torch", tm, tparams, rounds,
                                   **cfg_kw)
    assert out == ref_out
    assert st == ref_st
    return out, st, eng


def _solo(models, arch, engine, rid, prompt, budget, **kw):
    """One request alone on a fresh port engine (contiguous lanes take the
    serialized engine)."""
    mixed, kv_quant = ENGINES[engine]
    mixed = mixed and kw.get("paged", True)
    _, _, tm, tparams = _pair(models, arch, kv_quant)
    out, _, _ = tp.serve_rounds("repro_torch", tm, tparams,
                                [[(rid, prompt, budget)]],
                                **dict(KW, mixed=mixed, **kw))
    return out[rid]


# ---------------------------------------------------------------------------
# page pool
# ---------------------------------------------------------------------------


def _pool_state(pool):
    return ({w: (c.table.tolist(), c.refcount.tolist(), list(c.free),
                 list(c.retained), dict(c.index), dict(c.published))
             for w, c in pool.classes.items()},
            pool.prefix_version, pool.pages_shared(), pool.pages_in_use(),
            pool.free_page_budget(), pool.memory_ratio())


def _hit(h):
    return None if h is None else (h.n_shared, h.pages)


def _call(pool, name, *args):
    """``(result, error type)`` of one pool op."""
    try:
        return getattr(pool, name)(*args), None
    except RuntimeError as e:
        return None, type(e)


@pytest.mark.parametrize("seed,widths,pool_frac,page_cap", [
    (0, [64], 1.0, None), (1, [64], 0.5, None), (2, [64, 32], 0.7, None),
    (3, [64, 32], 1.0, 9), (4, [40], 0.4, None), (2101, [64, 32], 0.55,
                                                  None)])
def test_pool_sharing_schedule_matches_reference(seed, widths, pool_frac,
                                                 page_cap):
    """Admissions (probe, ``map_shared``, ``alloc_prefix``, the assign's
    copy-on-write span, publish), decode growth (``make_writable``),
    arbitrary write spans, releases into the retained LRU (evicted by later
    allocations), adopts and cache drops, on both pools: after every op the
    block tables, refcounts, free lists, retained LRU order, prefix index,
    ``prefix_version`` and ``pages_shared`` are equal, the copy lists are
    equal, and where the reference raises (pool exhausted) the port raises
    too. Seed 2101 is the draw that exhausts the pool in the reference's
    own hypothesis test."""
    from repro.serve.pages import PagePool as JPool
    from repro.serve.pages import prefix_digests as jdigests
    from repro_torch.serve.pages import PagePool, prefix_digests
    num_slots, ps = 5, 8
    a = PagePool(widths, num_slots, ps, pool_frac=pool_frac,
                 page_cap=page_cap)
    b = JPool(widths, num_slots, ps, pool_frac=pool_frac, page_cap=page_cap)
    rng = np.random.default_rng(seed)
    prefixes = [rng.integers(0, 100, size=n).astype(np.int32)
                for n in (16, 20, 9)]
    seen = []  # prompts admitted so far (exact duplicates re-admitted)
    held = {}  # slot -> lane length
    ops = ["admit", "grow", "range", "release", "adopt", "drop"]
    counts = dict.fromkeys(ops, 0)
    for _ in range(160):
        op = rng.choice(ops, p=[0.34, 0.3, 0.1, 0.18, 0.05, 0.03])
        if op == "admit":
            free = [s for s in range(num_slots) if s not in held]
            if not free:
                continue
            s = int(rng.choice(free))
            if seen and rng.random() < 0.25:
                prompt = seen[int(rng.integers(len(seen)))].copy()
            else:
                prompt = np.concatenate([
                    prefixes[int(rng.integers(3))],
                    rng.integers(0, 100, size=int(rng.integers(1, 14)))
                ]).astype(np.int32)
            L = len(prompt)
            assert prefix_digests(prompt, ps, L // ps) == \
                jdigests(prompt, ps, L // ps)
            ha, hb = a.probe_prefix(prompt), b.probe_prefix(prompt)
            assert _hit(ha) == _hit(hb)
            off = hb.n_shared if hb is not None else 0
            if hb is not None:
                a.map_shared(s, ha)
                b.map_shared(s, hb)
            ra = _call(a, "alloc_prefix", s, L + 1)
            rb = _call(b, "alloc_prefix", s, L + 1)
            assert ra[1] == rb[1]
            if rb[1] is None and off:
                ra = _call(a, "make_range_writable", s, off, L + 1)
                rb = _call(b, "make_range_writable", s, off, L + 1)
                assert ra == rb
            if rb[1] is not None:  # rolled back, as assign_many does
                a.release(s)
                b.release(s)
            else:
                a.publish_prefix(s, prompt)
                b.publish_prefix(s, prompt)
                held[s] = L
                seen.append(prompt)
        elif op == "grow" and held:
            s = int(rng.choice(list(held)))
            got, want = a.make_writable(s, held[s]), b.make_writable(s,
                                                                     held[s])
            assert got == want
            if want[0]:
                held[s] += 1
        elif op == "range" and held:
            s = int(rng.choice(list(held)))
            lo = int(rng.integers(0, held[s] + 1))
            hi = int(rng.integers(lo, held[s] + 2))
            assert _call(a, "make_range_writable", s, lo, hi) == \
                _call(b, "make_range_writable", s, lo, hi)
        elif op == "release" and held:
            s = int(rng.choice(list(held)))
            a.release(s)
            b.release(s)
            del held[s]
        elif op == "adopt":
            w = int(rng.choice(widths))
            prompt = seen[int(rng.integers(len(seen)))] if seen \
                else prefixes[0]
            lp = int(rng.integers(0, max(len(prompt) // ps, 1)))
            dig = prefix_digests(prompt, ps, lp + 1)[lp]
            assert a.adopt_published(w, lp, dig) == \
                b.adopt_published(w, lp, dig)
        elif op == "drop":
            a.drop_prefix_cache()
            b.drop_prefix_cache()
        else:
            continue
        counts[op] += 1
        assert _pool_state(a) == _pool_state(b), op
        a.check_invariants()
        b.check_invariants()
    assert all(counts[op] for op in ("admit", "grow", "release")), counts
    for s in list(held):
        a.release(s)
        b.release(s)
    assert _pool_state(a) == _pool_state(b)
    assert a.pages_in_use() == 0
    a.check_invariants()


def test_pool_sharing_basics_and_audits():
    """The reference tests' pool facts on the port alone: only full pages
    publish, an exact page-aligned duplicate shares all but its last
    token, a changed first page kills the chain, released published pages
    are retained and then evicted LRU-first, and each audit names its
    check."""
    from repro_torch.core.errors import AuditError
    from repro_torch.serve.pages import PagePool
    pool = PagePool([64], num_slots=4, page_size=8)
    toks = np.random.default_rng(0).integers(0, 1000, 20).astype(np.int32)
    assert pool.probe_prefix(toks) is None
    pool.alloc_prefix(0, 21)
    pool.publish_prefix(0, toks)
    hit = pool.probe_prefix(toks)
    assert hit.n_shared == 16 and len(hit.pages[64]) == 2
    assert pool.probe_prefix(toks[:16]).n_shared == 15
    other = toks.copy()
    other[3] += 1
    assert pool.probe_prefix(other) is None
    assert pool.probe_prefix(toks[:7]) is None
    pool.map_shared(1, hit)
    assert pool.pages_shared() == 2
    pool.check_write_private(0, 20)  # page 2 is slot 0's own
    with pytest.raises(AuditError, match="cow-write-shared"):
        pool.check_write_private(1, 3)
    with pytest.raises(AuditError, match="write-unmapped"):
        pool.check_write_private(1, 17)
    pool.check_lane_bounds(0, 20)
    with pytest.raises(AuditError, match="lane-bounds"):
        pool.check_lane_bounds(1, 16)
    ok, copies = pool.make_writable(1, 15)  # CoW of the shared page 1
    assert ok and copies == [(64, hit.pages[64][1], copies[0][2])]
    with pytest.raises(AuditError, match="cow-write-published"):
        pool.check_write_private(0, 10)  # slot 0 alone, still published
    pool.release(0)
    pool.release(1)
    c = pool.classes[64]
    assert pool.pages_in_use() == 0 and len(c.retained) == 2
    assert pool.probe_prefix(toks).n_shared == 16
    pool.check_invariants()
    for s in range(4):  # every page: the retained ones are evicted
        pool.alloc_prefix(s, 64)
    assert not c.retained and pool.probe_prefix(toks) is None
    pool.check_invariants()
    c.retained[c.table[0, 0]] = None
    with pytest.raises(AuditError):
        pool.check_invariants()


# ---------------------------------------------------------------------------
# slot table, scheduler, suffix prefill
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kv_quant", [False, True])
def test_offset_assign_copy_and_gather_match_reference(models, kv_quant):
    """A lane assigned from a prefill row, its pages published, then a
    second lane mapping them and assigned only its suffix behind them
    (copy-on-write of the shared tail page), then an exact duplicate: the
    caches (codes and scales) and block tables equal the reference's after
    each round, and the gathered prefix K/V (dequantized for int8) are
    equal too."""
    import jax.numpy as jnp
    from repro.serve.kv_slots import SlotKVCache as JSlots
    from repro_torch.serve.kv_slots import SlotKVCache
    jm, _, tm, _ = _pair(models, "qwen2.5-32b", kv_quant)
    js = JSlots(jm, 4, 40, page_size=8)
    ts = SlotKVCache(tm, 4, 40, page_size=8)
    rng = np.random.default_rng(3)
    src = {}
    for name, leaf in tm.init_cache(3, 32).items():
        src[name] = (rng.integers(-127, 128, leaf.shape).astype(np.int8)
                     if leaf.dtype == torch.int8 else
                     rng.standard_normal(leaf.shape).astype(np.float32))
    jsrc = {k: jnp.asarray(v) for k, v in src.items()}
    tsrc = {k: tp.t(v) for k, v in src.items()}
    prompt = np.arange(20, dtype=np.int32)

    def same():
        for name in js.caches:
            np.testing.assert_array_equal(ts.caches[name].numpy(),
                                          np.asarray(js.caches[name]),
                                          err_msg=name)
        np.testing.assert_array_equal(ts.lengths, js.lengths)
        for w, c in js.pool.classes.items():
            np.testing.assert_array_equal(ts.pool.classes[w].table, c.table)
        ts.pool.check_invariants()

    for s in (js, ts):
        s.assign_many([(0, "a", 0, 0, 20)], jsrc if s is js else tsrc)
        s.pool.publish_prefix(0, prompt)
    same()
    # a suffix behind two shared pages, then a page-aligned duplicate whose
    # recomputed last token lands in a shared page (copy-on-write)
    for slot, row, toks, off in (
            (1, 1, np.concatenate([prompt[:16], np.arange(7) + 50]), 16),
            (2, 2, prompt[:16], 15)):
        hits = [s.pool.probe_prefix(toks) for s in (js, ts)]
        assert _hit(hits[0]) == _hit(hits[1]) and hits[1].n_shared == off
        for s, h in zip((js, ts), hits):
            s.pool.map_shared(slot, h)
            s.assign_many([(slot, "b", row, 3, len(toks) - off, off)],
                          jsrc if s is js else tsrc)
        same()
        ids = {w: np.array([hits[1].pages[w] + [c.FREE]], np.int32)
               for w, c in ts.pool.classes.items()}
        jk, jv = js.gather_prefix(ids)
        tk, tv = ts.gather_prefix(ids)
        for got, want in ((tk, jk), (tv, jv)):
            np.testing.assert_array_equal(got[:, :, :16].numpy(),
                                          np.asarray(want)[:, :, :16])
    assert ts.pages_copied == 1
    # a direct copy of a shared page into a free one
    copies = [(w, int(c.table[1, 0]), c.free[0])
              for w, c in ts.pool.classes.items()]
    for s in (js, ts):
        s.copy_pages(copies)
    same()


def test_scheduler_shared_admissions_match_reference():
    """``next_admissions`` with a probe: hits gather into shared groups
    (flushed by a chunked prompt between them and at ``max_rows``), misses
    pack or chunk as before; ``next_mixed`` returns the estimates. Same
    groups and queue as the reference."""
    from repro.serve.scheduler import Request as JReq, Scheduler as JSched
    from repro_torch.serve.scheduler import Request, Scheduler
    lengths = [5, 20, 9, 30, 12, 7, 18, 3, 25, 11]
    shared = {1: 16, 2: 8, 4: 8, 6: 16, 7: 0, 9: 8}

    def probe(r):
        return shared.get(r.rid, 0)

    def summary(groups):
        return [(sorted(r.rid for r in g.requests), g.shared_prefix,
                 g.shared_prefixes, g.packed is not None,
                 None if g.chunks is None else len(g.chunks))
                for g in groups]

    a, b = Scheduler(max_len=16, max_rows=2), JSched(max_len=16, max_rows=2)
    for i, n in enumerate(lengths):
        a.submit(Request(rid=i, prompt=np.ones(n, np.int32)))
        b.submit(JReq(rid=i, prompt=np.ones(n, np.int32)))
    for free in (4, 3, 5):
        assert summary(a.next_admissions(free, probe=probe)) == \
            summary(b.next_admissions(free, probe=probe))
        assert [r.rid for r in a.queue] == [r.rid for r in b.queue]
    for i, n in enumerate(lengths):
        a.submit(Request(rid=i, prompt=np.ones(n, np.int32)))
        b.submit(JReq(rid=i, prompt=np.ones(n, np.int32)))
    got = [(r.rid, n) for r, n in a.next_mixed(6, probe=probe)]
    assert got == [(r.rid, n) for r, n in b.next_mixed(6, probe=probe)]
    assert got[1] == (1, 16)


def test_suffix_prefill_attention_and_hidden_match_reference(models):
    """``attention_block(prefix_kv=...)`` (one layer) and
    ``Model.hidden(prefix_kv=...)`` (2 layers, the suffix K/V it writes
    included) against the reference on the same inputs: two suffix rows
    at absolute positions, over gathered prefixes of 16 and 9 valid
    positions (the rest padding), one row with trailing padding. Limits:
    ATOL_LAYER (1e-5) for the block, ATOL_LOGITS (1e-4) for logits,
    ATOL_POOL (1e-5) for the written K/V; padding rows and columns are
    not compared."""
    import jax.numpy as jnp
    from repro.models import layers as JL
    from repro_torch.models import layers as L
    cfg, jm, jp, tm, tparams = models["qwen2.5-32b"]
    rng = np.random.default_rng(4)
    B, S, Np, plen = 2, 8, 16, np.array([16, 9], np.int32)
    Hkv, D = cfg.kv_heads, cfg.head_dim
    pos = plen[:, None] + np.arange(S, dtype=np.int32)[None]
    seg = np.ones((B, S), np.int32)
    seg[1, 6:] = 0
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    pk = rng.standard_normal((B, Np, Hkv, D)).astype(np.float32)
    pv = rng.standard_normal((B, Np, Hkv, D)).astype(np.float32)
    jlay = tp.to_numpy_tree(jp["layers"]["attn"])
    want = JL.attention_block(
        {k: {kk: jnp.asarray(vv[0]) for kk, vv in v.items()}
         for k, v in jlay.items()}, jnp.asarray(x), cfg=cfg, dicts=None,
        positions=jnp.asarray(pos), seg_ids=jnp.asarray(seg),
        prefix_kv={"k": jnp.asarray(pk), "v": jnp.asarray(pv),
                   "len": jnp.asarray(plen)})[0]
    got = L.attention_block(
        {k: {kk: vv[0] for kk, vv in v.items()}
         for k, v in tparams["layers"]["attn"].items()}, tp.t(x),
        cfg=tm.cfg, positions=tp.t(pos).long(), seg_ids=tp.t(seg),
        prefix_kv={"k": tp.t(pk), "v": tp.t(pv), "len": tp.t(plen)})
    live = seg > 0
    np.testing.assert_allclose(got.numpy()[live], np.asarray(want)[live],
                               rtol=0, atol=tp.ATOL_LAYER)

    Lk = rng.standard_normal((cfg.n_layers, B, Np, Hkv, D)).astype(
        np.float32)
    Lv = rng.standard_normal((cfg.n_layers, B, Np, Hkv, D)).astype(
        np.float32)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    jcache = jm.init_cache(B, S, ring=False)
    jlog, jcache, _ = jm.apply(
        jp, {"inputs": jnp.asarray(toks), "positions": jnp.asarray(pos),
             "seg_ids": jnp.asarray(seg)}, caches=jcache,
        cache_index=jnp.int32(0),
        prefix_kv={"k": jnp.asarray(Lk), "v": jnp.asarray(Lv),
                   "len": jnp.asarray(plen)})
    tcache = tm.init_cache(B, S)
    tlog, tcache = tm.apply(
        tparams, {"inputs": tp.t(toks), "positions": tp.t(pos),
                  "seg_ids": tp.t(seg)}, caches=tcache,
        prefix_kv={"k": tp.t(Lk), "v": tp.t(Lv), "len": tp.t(plen)})
    np.testing.assert_allclose(tlog.numpy()[live], np.asarray(jlog)[live],
                               rtol=0, atol=tp.ATOL_LOGITS)
    for name in ("k", "v"):
        np.testing.assert_allclose(tcache[name].numpy()[:, live],
                                   np.asarray(jcache[name])[:, live],
                                   rtol=0, atol=tp.ATOL_POOL)


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------


def _prefix_prompts(vocab, seed, pre_len, suffixes):
    rng = np.random.default_rng(seed)
    pre = rng.integers(0, vocab, size=pre_len).astype(np.int32)
    return [np.concatenate([pre, rng.integers(0, vocab, size=n)]).astype(
        np.int32) for n in suffixes]


@pytest.mark.parametrize("engine", sorted(ENGINES))
@pytest.mark.parametrize("arch", ARCHS)
def test_shared_prefill_matches_reference_cold_and_contiguous(models, arch,
                                                              engine):
    """The reference test's scenario (``test_prefix_sharing.py``): A, then
    B sharing A's 20-token prefix, on one engine. The port's tokens and
    counters (``prefix_hit_ratio``, ``pages_shared``, ``kv_memory_ratio``,
    steps) equal the reference Engine's after each run, B hits, and each
    request's tokens equal a cold paged run's and a contiguous run's."""
    cfg = models[arch][0]
    A, B = _prefix_prompts(cfg.vocab_size, 0, 20, [6, 9])
    out, st, eng = _both(models, arch, engine, [[(0, A, 5)], [(1, B, 5)]])
    assert st[1]["prefix_hit_ratio"] > 0 and st[1]["pages_shared"] > 0
    assert eng.prefix_share and eng.slots.pool.pages_in_use() == 0
    for rid, prompt in ((0, A), (1, B)):
        for kw in (dict(prefix_share=False), dict(paged=False)):
            assert _solo(models, arch, engine, rid, prompt, 5, **kw) == \
                out[rid], kw


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_duplicate_prompt_cows_partial_tail(models, engine):
    """An exact duplicate shares all but its last token, whose recompute
    lands inside a shared page (copy-on-write at assign or claim); the
    original's published pages stay intact, so a later prompt extending
    them still hits. Equal to the reference at every run, and the last
    request equal to a contiguous run."""
    cfg = models["qwen1.5-4b"][0]
    rng = np.random.default_rng(1)
    A = rng.integers(0, cfg.vocab_size, size=16).astype(np.int32)
    C = np.concatenate([A, rng.integers(0, cfg.vocab_size, size=5)]).astype(
        np.int32)
    out, st, eng = _both(models, "qwen1.5-4b", engine,
                         [[(0, A, 5)], [(1, A.copy(), 5)], [(2, C, 5)]],
                         max_prompt_len=32)
    assert out[0] == out[1]
    assert st[1]["prefix_hit_ratio"] > 0.9 and st[2]["prefix_hit_ratio"] > 0.5
    assert _solo(models, "qwen1.5-4b", engine, 2, C, 5, paged=False,
                 max_prompt_len=32) == out[2]


@pytest.mark.parametrize("engine,budget", [
    ("mixed", None), ("mixed", 4), ("serialized", None),
    ("serialized_int8", None)])
def test_system_prompt_traffic_matches_reference(models, engine, budget):
    """System-prompt traffic: eight requests behind one 17-token prefix
    (two full pages and a token) with distinct suffixes, four up front and
    four arriving mid-decode, over three slots (so queued hits are
    admitted as slots free, several into one serialized suffix sweep).
    Tokens and counters equal the reference's; the prefix is shared; every
    request's tokens equal the port's cold run of the same traffic."""
    cfg = models["qwen2.5-32b"][0]
    prompts = _prefix_prompts(cfg.vocab_size, 6, 17,
                              [3, 9, 1, 14, 6, 2, 11, 5])
    ticks = [1, 1, 1, 1, 2, 4, 6, 9]
    rnd = [(t, (i, p, 4 + i % 3)) for i, (t, p) in
           enumerate(zip(ticks, prompts))]
    kw = dict(num_slots=3, prefill_budget=budget)
    out, st, eng = _both(models, "qwen2.5-32b", engine, [rnd], **kw)
    assert st[0]["prefix_hit_ratio"] > 0.2 and st[0]["pages_shared"] >= 8
    assert all(s == "ok" for _, s in out.values())
    mixed, kv_quant = ENGINES[engine]
    _, _, tm, tparams = _pair(models, "qwen2.5-32b", kv_quant)
    cold, cst, _ = tp.serve_rounds("repro_torch", tm, tparams, [rnd],
                                   **dict(KW, mixed=mixed, prefix_share=False,
                                          **kw))
    assert cold == out and cst[0]["prefix_hit_ratio"] == 0


def test_batched_suffix_prefill_matches_reference(models):
    """Two hits with distinct prefixes ride one two-row suffix sweep in the
    serialized engine: the sweep entries (``engine.stats``), tokens and
    counters equal the reference's."""
    from repro.serve import Engine as JEngine, EngineConfig as JEC, \
        Request as JReq
    from repro_torch.serve import Engine, EngineConfig, Request
    cfg, jm, jp, tm, tparams = models["qwen2.5-32b"]
    v = cfg.vocab_size
    w1, h1 = _prefix_prompts(v, 8, 16, [4, 7])
    w2, h2 = _prefix_prompts(v, 9, 16, [5, 6])
    runs = []
    for E, C, R, m, p in ((JEngine, JEC, JReq, jm, jp),
                          (Engine, EngineConfig, Request, tm, tparams)):
        eng = E(m, p, config=C(**dict(KW, num_slots=4, mixed=False)))
        for rid, pr in ((0, w1), (1, w2)):
            eng.submit(R(rid=rid, prompt=pr, max_new_tokens=4))
        eng.run()
        n0 = len(eng.stats)
        for rid, pr in ((2, h1), (3, h2)):
            eng.submit(R(rid=rid, prompt=pr, max_new_tokens=4))
        done = eng.run()
        runs.append(({r.rid: list(r.output) for r in done},
                     eng.stats[n0:], eng.decode_stats["prefix_hit_ratio"]))
    assert runs[0] == runs[1]
    assert runs[1][1] == [{"rows": 2, "n_requests": 2,
                           "utilization": runs[1][1][0]["utilization"]}]
    assert runs[1][2] > 0.5
