"""Preemption in the port, held to the reference: a pool too small for
the lanes in flight preempts the youngest request and requeues it as a
continuation (a mixed-step chunk of the youngest is deferred instead), a
request over its preemption budget fails, a lane that cannot grow even
alone fails, and ``cancel`` returns a request's pages. Tokens equal an
uncut pool's and the reference Engine's; statuses and counters equal the
reference's."""
import pytest

torch = pytest.importorskip("torch")

import _torch_parity as tp  # noqa: E402

tp.tf32_off()

# 7 pages of 8 tokens for three lanes of up to 48 positions.
TIGHT = dict(tp.ENGINE_KW, page_size=8, pool_frac=0.34)
LENGTHS, BUDGET = [30, 30, 30, 12], 8


@pytest.fixture(scope="module")
def qwen():
    cfg, m, params = tp.jax_qwen_smoke()
    tm, tparams = tp.torch_qwen_smoke(params)
    return cfg, m, params, tm, tparams


def _models(qwen, kv_quant):
    import dataclasses
    from repro.models.transformer import Model as JModel
    from repro_torch.models.transformer import Model
    _, jm, jp, tm, tparams = qwen
    if kv_quant:
        jm = JModel(dataclasses.replace(jm.cfg, kv_quant=True))
        tm = Model(dataclasses.replace(tm.cfg, kv_quant=True), device="cpu")
    return jm, jp, tm, tparams


def _round(vocab, lengths=LENGTHS, budget=BUDGET):
    return [(i, p, budget) for i, p in
            enumerate(tp.prompts(vocab, lengths, seed=5))]


@pytest.mark.parametrize("mixed,budget,kv_quant,share", [
    (True, None, False, True), (True, None, False, False),
    (True, 4, False, True), (False, None, False, True),
    (False, None, False, False), (False, None, True, True)])
def test_preemption_matches_reference_and_uncut_pool(qwen, mixed, budget,
                                                     kv_quant, share):
    """Three 30-token prompts and a 12-token one growing 8 tokens each in
    7 pages: requests are preempted (and, in the mixed engine, chunks
    deferred) and resumed as continuations. Tokens, statuses and counters
    (``preemptions``, ``preemptions_recovered``, ``prefix_hit_ratio``,
    ``pages_shared``, ``kv_memory_ratio``, steps) equal the reference
    Engine's, and the tokens equal an uncut pool's run, which preempts
    nothing. With sharing on, a continuation resumes over its own
    published pages (a prefix hit)."""
    cfg = qwen[0]
    jm, jp, tm, tparams = _models(qwen, kv_quant)
    kw = dict(TIGHT, mixed=mixed, prefill_budget=budget, prefix_share=share)
    rnd = [_round(cfg.vocab_size)]
    ref, ref_st, _ = tp.serve_rounds("repro", jm, jp, rnd, **kw)
    out, st, eng = tp.serve_rounds("repro_torch", tm, tparams, rnd, **kw)
    assert out == ref and st == ref_st
    assert st[0]["preemptions"] > 0
    assert st[0]["preemptions_recovered"] == st[0]["preemptions"]
    assert all(s == "ok" for _, s in out.values())
    if share and budget is None:
        assert st[0]["prefix_hit_ratio"] > 0 and st[0]["pages_shared"] > 0
    uncut, ust, _ = tp.serve_rounds("repro_torch", tm, tparams, rnd,
                                    **dict(kw, pool_frac=1.0))
    assert ust[0]["preemptions"] == 0 and uncut == out
    assert eng.slots.pool.pages_in_use() == 0


@pytest.mark.parametrize("mixed", [True, False])
def test_preemption_budget_fails_requests_like_reference(qwen, mixed):
    """``Request.max_preemptions=0`` and the engine's
    ``max_preemptions_per_request=1``: requests over budget end
    ``failed`` (their reason names the budget) while the rest finish
    ``ok``; outputs, statuses, reasons and counters equal the
    reference's."""
    from repro.serve import Engine as JEngine, EngineConfig as JEC, \
        Request as JReq
    from repro_torch.serve import Engine, EngineConfig, Request
    cfg, jm, jp, tm, tparams = qwen
    prompts = tp.prompts(cfg.vocab_size, LENGTHS, seed=5)
    runs = []
    for E, C, R, m, p in ((JEngine, JEC, JReq, jm, jp),
                          (Engine, EngineConfig, Request, tm, tparams)):
        res = []
        for limit, per_req in ((None, 0), (1, None)):
            eng = E(m, p, config=C(mixed=mixed,
                                   max_preemptions_per_request=limit,
                                   **TIGHT))
            for i, pr in enumerate(prompts):
                eng.submit(R(rid=i, prompt=pr, max_new_tokens=BUDGET,
                             max_preemptions=per_req if i % 2 else None))
            done = eng.run()
            eng.slots.pool.check_invariants()
            res.append(({r.rid: (list(r.output), r.status, r.status_reason)
                         for r in done},
                        {k: eng.decode_stats[k] for k in tp.SHARE_STATS}))
        runs.append(res)
    assert runs[0] == runs[1]
    statuses = [s for _, s, _ in runs[1][0][0].values()]
    assert "failed" in statuses and "ok" in statuses
    assert any("preemption budget" in (r or "")
               for _, _, r in runs[1][0][0].values())
    assert runs[1][0][1]["preemptions"] > \
        runs[1][0][1]["preemptions_recovered"]


def test_cancel_returns_pages_like_reference(qwen):
    """``cancel`` mid-session (an in-flight request and a queued one) and
    between sessions (a queued one): each ends ``cancelled``, in-flight
    pages return to the pool at once, a terminal or unknown request is
    refused, and every return value, status and output equals the
    reference's. ``iteration`` counts the session's steps (0 outside)."""
    from repro.serve import Engine as JEngine, EngineConfig as JEC, \
        Request as JReq
    from repro_torch.serve import Engine, EngineConfig, Request
    cfg, jm, jp, tm, tparams = qwen
    prompts = tp.prompts(cfg.vocab_size, [20, 9, 14, 6], seed=7)
    runs = []
    for E, C, R, m, p in ((JEngine, JEC, JReq, jm, jp),
                          (Engine, EngineConfig, Request, tm, tparams)):
        eng = E(m, p, config=C(page_size=8, **dict(tp.ENGINE_KW,
                                                    num_slots=2)))
        reqs = [R(rid=i, prompt=pr, max_new_tokens=6)
                for i, pr in enumerate(prompts)]
        for r in reqs[:3]:
            eng.submit(r)
        log = [eng.iteration]
        for _ in range(3):
            eng.step()
        log.append(eng.iteration)
        used = eng.slots.pool.pages_in_use()
        log.append(eng.cancel(reqs[0]))  # in flight
        log.append(used - eng.slots.pool.pages_in_use())
        log.append(eng.cancel(reqs[2]))  # queued
        log.append(eng.cancel(reqs[2]))  # already terminal
        log.append(eng.cancel(reqs[3]))  # never submitted
        while eng.has_work():
            eng.step()
        done = eng.finish_run()
        eng.submit(reqs[3])
        log.append(eng.cancel(reqs[3]))  # queued, outside a session
        done += eng.run()
        eng.slots.pool.check_invariants()
        log.append(eng.iteration)
        runs.append((log, [(r.rid, r.status, list(r.output))
                           for r in done]))
    assert runs[0] == runs[1]
    log = runs[1][0]
    assert log[:3] == [0, 3, True] and log[3] > 0
    assert log[4:] == [True, False, False, True, 0]
    assert [s for _, s, _ in runs[1][1]].count("cancelled") == 3


def test_lane_that_cannot_grow_fails_like_reference(qwen):
    """Under ``page_cap=2`` (pages of 16) a 12-token request budgeted 25
    tokens cannot hold its third page even alone: it ends ``failed``
    naming ``page_cap`` with the tokens it made, not the engine; and a
    pool floored at one lane (``pool_frac=0.01``) serves 20-, 25- and
    30-token prompts one at a time with the contiguous run's tokens. Both
    as the reference does."""
    from repro.serve import Engine as JEngine, EngineConfig as JEC, \
        Request as JReq
    from repro_torch.serve import Engine, EngineConfig, Request
    cfg, jm, jp, tm, tparams = qwen
    runs = []
    for E, C, R, m, p in ((JEngine, JEC, JReq, jm, jp),
                          (Engine, EngineConfig, Request, tm, tparams)):
        res = []
        eng = E(m, p, config=C(max_len=16, max_new_tokens=32, num_slots=2,
                               page_size=16, page_cap=2))
        eng.submit(R(rid=0, prompt=tp.prompts(cfg.vocab_size, [12],
                                              seed=8)[0],
                     max_new_tokens=25))
        (r,) = eng.run()
        res.append((list(r.output), r.status, r.status_reason))
        for pkw in (dict(page_size=16, pool_frac=0.01), dict(paged=False)):
            eng = E(m, p, config=C(max_len=16, max_new_tokens=8,
                                   num_slots=2, max_prompt_len=32, **pkw))
            for i, pr in enumerate(tp.prompts(cfg.vocab_size, [20, 25, 30],
                                              seed=9)):
                eng.submit(R(rid=i, prompt=pr, max_new_tokens=6))
            res.append(({r.rid: (list(r.output), r.status)
                         for r in eng.run()},
                        eng.decode_stats["preemptions"]))
        runs.append(res)
    assert runs[0] == runs[1]
    out, status, reason = runs[1][0]
    assert status == "failed" and "page_cap" in reason and 0 < len(out) < 25
    assert runs[1][1][0] == runs[1][2][0]
