"""The port's steppable engine, asyncio ``Frontend``, multi-replica
``Dispatcher`` with its ``FleetPrefixIndex``, the public surface and the
traces, held to the reference: the cases of ``tests/test_frontend.py``,
each run's statuses and tokens compared with the reference's on the same
trace (greedy and with per-request seeded sampling), the dispatcher's
routing and the fleet's restored pages counted alike, and the port's
traces equal to ``benchmarks/traces.py``'s for fixed seeds."""
import asyncio
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_parity as tp  # noqa: E402

tp.tf32_off()

PKGS = ("repro", "repro_torch")
ECFG = dict(max_len=64, max_new_tokens=8, num_slots=4, page_size=8,
            mixed=True, prefill_budget=16)


@pytest.fixture(scope="module")
def fm():
    cfg, m, params = tp.jax_qwen_smoke()
    tm, tparams = tp.torch_qwen_smoke(params)
    return cfg, {"repro": (m, params), "repro_torch": (tm, tparams)}


def _serve(pkg):
    return importlib.import_module(pkg + ".serve")


def _engine(fm, pkg, **kw):
    serve = _serve(pkg)
    model, params = fm[1][pkg]
    return serve.Engine(model, params,
                        config=serve.EngineConfig(**{**ECFG, **kw}))


def _trace(pkg, vocab, n=6, sampled=True, seed=0):
    """Fresh (tick, Request) arrivals of ``pkg``; every other request
    carries its own SamplingParams when ``sampled``."""
    serve = _serve(pkg)
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        prompt = rng.integers(1, vocab, size=int(rng.integers(3, 14))) \
            .astype(np.int32)
        sp = (serve.SamplingParams(temperature=0.8, top_k=5, seed=500 + i)
              if sampled and i % 2 else None)
        out.append((1 + 2 * i, serve.Request(rid=i, prompt=prompt,
                                             max_new_tokens=5, sampling=sp)))
    return out


def _outputs(done):
    return {r.rid: (r.status, tuple(r.output)) for r in done}


_REF = {}


def _ref_run(fm, sampled, n=6):
    """The reference Engine's run of the trace (cached per module)."""
    key = (sampled, n)
    if key not in _REF:
        _REF[key] = _outputs(_engine(fm, "repro").run(
            arrivals=_trace("repro", fm[0].vocab_size, n=n,
                            sampled=sampled)))
    return _REF[key]


# -- step(): run() is a thin loop over it ------------------------------------


@pytest.mark.parametrize("sampled", [False, True])
def test_manual_step_loop_matches_reference_run(fm, sampled):
    eng = _engine(fm, "repro_torch")
    arr = sorted(_trace("repro_torch", fm[0].vocab_size, sampled=sampled),
                 key=lambda a: a[0])
    ai, emitted, finished = 0, {}, []
    while eng.has_work() or ai < len(arr):
        due = []
        while ai < len(arr) and arr[ai][0] <= eng.iteration + 1:
            due.append(arr[ai][1])
            ai += 1
        res = eng.step(submits=due)
        assert res.device_time >= 0
        finished.extend(res.finished)
        for req, tok in res.emitted:
            emitted.setdefault(req.rid, []).append(tok)
    done = eng.finish_run()
    assert _outputs(done) == _ref_run(fm, sampled)
    assert {rid: tuple(t) for rid, t in emitted.items()} == {
        r.rid: tuple(r.output) for r in done}
    assert sorted(r.rid for r in finished) == sorted(r.rid for r in done)


def test_run_refuses_mid_session(fm):
    from repro_torch.serve import Request
    eng = _engine(fm, "repro_torch")
    eng.step(submits=[Request(rid=0, prompt=[3, 4, 5], max_new_tokens=4)])
    with pytest.raises(RuntimeError, match="session"):
        eng.run()
    eng.finish_run()
    eng.run()


# -- Frontend ----------------------------------------------------------------


def _drive_frontend(engine, arrivals):
    from repro_torch.serve import Frontend

    async def main():
        streamed = {}
        async with Frontend(engine) as fe:
            handles = [fe.submit(r, tick=t) for t, r in arrivals]

            async def consume(h):
                streamed[h.request.rid] = [tok async for tok in h]

            await asyncio.gather(*(consume(h) for h in handles))
        return streamed, fe

    return asyncio.run(main())


@pytest.mark.parametrize("sampled", [False, True],
                         ids=["greedy", "seeded-sampled"])
def test_frontend_token_identical_to_reference_run(fm, sampled):
    eng = _engine(fm, "repro_torch")
    streamed, fe = _drive_frontend(
        eng, _trace("repro_torch", fm[0].vocab_size, sampled=sampled))
    assert _outputs(fe.results) == _ref_run(fm, sampled)
    assert streamed == {r.rid: list(r.output) for r in fe.results}
    assert fe.stats["itl_p99"] > 0


def test_frontend_result_resolves_terminal_status(fm):
    from repro_torch.serve import Frontend, Request
    eng = _engine(fm, "repro_torch")

    async def main():
        async with Frontend(eng) as fe:
            h = fe.submit(Request(rid=0, prompt=[2, 3, 4], max_new_tokens=3))
            req = await h.result()
            assert h.done()
        return req

    req = asyncio.run(main())
    assert req.status == "ok" and len(req.output) == 3


def test_cancel_mid_decode_frees_pages(fm):
    from repro_torch.serve import Frontend, Request
    eng = _engine(fm, "repro_torch", max_new_tokens=64, mixed=None,
                  prefill_budget=None, prefix_share=False)

    async def main():
        async with Frontend(eng) as fe:
            h = fe.submit(Request(rid=0, prompt=list(range(2, 12)),
                                  max_new_tokens=64))
            got = 0
            async for _ in h:
                got += 1
                if got == 3:
                    assert eng.slots.pool.memory_ratio() > 0
                    assert await h.cancel()
                    break
            req = await h.result()
        return req, got

    req, got = asyncio.run(main())
    assert req.status == "cancelled" and got == 3 and len(req.output) >= 3
    assert not eng.slots.active.any()
    assert eng.slots.pool.memory_ratio() == 0.0
    assert eng.cancel(req) is False


def test_cancel_before_submission_never_reaches_engine(fm):
    from repro_torch.serve import Frontend, Request
    eng = _engine(fm, "repro_torch")

    async def main():
        async with Frontend(eng) as fe:
            h = fe.submit(Request(rid=7, prompt=[2, 3], max_new_tokens=2),
                          tick=10_000)
            h2 = fe.submit(Request(rid=8, prompt=[4, 5], max_new_tokens=2))
            assert await h.cancel()
            await h2.result()
        return fe

    outs = _outputs(asyncio.run(main()).results)
    assert outs[7] == ("cancelled", ()) and outs[8][0] == "ok"


def test_cancel_is_counted_and_terminal(fm):
    from repro_torch.serve import TERMINAL_STATUSES, Request
    eng = _engine(fm, "repro_torch")
    req = Request(rid=0, prompt=[3, 4, 5, 6], max_new_tokens=32)
    eng.step(submits=[req])
    assert eng.cancel(req) is True
    done = eng.finish_run()
    assert "cancelled" in TERMINAL_STATUSES
    assert _outputs(done)[0][0] == "cancelled"
    assert eng.decode_stats["cancelled"] == 1


# -- Dispatcher and the fleet ------------------------------------------------


def test_dispatcher_replicas_match_reference(fm):
    """Two replicas behind a Dispatcher give the single engine's tokens,
    and the reference Dispatcher's routing and merged counters."""
    got = {}
    for pkg in PKGS:
        serve = _serve(pkg)
        disp = serve.Dispatcher([_engine(fm, pkg) for _ in range(2)])
        done = disp.run(arrivals=_trace(pkg, fm[0].vocab_size, n=8))
        st = disp.decode_stats
        got[pkg] = (_outputs(done), st["routed_counts"], st["steps"],
                    st["decoded_tokens"], st["status_counts"])
        assert st["itl_p99"] > 0
    assert got["repro_torch"] == got["repro"]
    assert got["repro_torch"][0] == _ref_run(fm, True, n=8)
    assert all(c > 0 for c in got["repro_torch"][1])


def test_dispatcher_routes_least_loaded_deterministically(fm):
    from repro_torch.serve import Dispatcher, Request
    disp = Dispatcher([_engine(fm, "repro_torch") for _ in range(2)])
    for i in range(4):
        disp.route(Request(rid=i, prompt=[2 + i, 3, 4], max_new_tokens=2))
    assert disp.routed_counts == [2, 2]
    assert disp.cancel(Request(rid=99, prompt=[2], max_new_tokens=1)) \
        is False


@pytest.mark.parametrize("mixed", [True, False])
def test_fleet_prefix_restored_on_second_replica(fm, mixed):
    """Replica B restores the pages replica A published from the fleet's
    host tier: as many pages as the reference restores, the same hit
    ratio and fleet counters, and replica A's tokens."""
    got = {}
    prefix = list(range(2, 2 + 24))  # 3 full pages
    for pkg in PKGS:
        serve = _serve(pkg)
        kw = dict(max_new_tokens=4, mixed=mixed, prefill_budget=None)
        disp = serve.Dispatcher([_engine(fm, pkg, **kw) for _ in range(2)])
        a, b = disp.replicas
        ra = a.run(arrivals=[(1, serve.Request(
            rid=0, prompt=prefix + [7, 8], max_new_tokens=4))])
        rb = b.run(arrivals=[(1, serve.Request(
            rid=1, prompt=prefix + [7, 8], max_new_tokens=4))])
        f = disp.fleet
        got[pkg] = (tuple(ra[0].output), tuple(rb[0].output),
                    b.decode_stats["fleet_restored_pages"],
                    b.decode_stats["prefix_hit_ratio"],
                    (len(f), f.published, f.hits, f.misses,
                     f.restored_pages))
    assert got["repro_torch"] == got["repro"]
    outs_a, outs_b, restored, hit, _ = got["repro_torch"]
    assert outs_a == outs_b and restored > 0 and hit > 0


def test_fleet_pages_round_trip_bit_identical(fm):
    """``read_page`` / ``write_page`` move one page of every leaf to host
    numpy and back unchanged, int8 codes and f32 scales included, and bf16
    leaves as their bit patterns."""
    import dataclasses
    from repro_torch.models.transformer import Model
    from repro_torch.serve.kv_slots import SlotKVCache
    tm, _ = fm[1]["repro_torch"]
    for over in ({"kv_quant": True}, {"dtype": "bfloat16"}):
        cfg = dataclasses.replace(tm.cfg, **over)
        sl = SlotKVCache(Model(cfg, device="cpu"), 2, 32, page_size=8)
        g = torch.Generator().manual_seed(0)
        for leaf in sl.caches.values():
            leaf.copy_(torch.randn(leaf.shape, generator=g).mul(50)
                       .to(leaf.dtype))
        host = sl.read_page(sl.width, 1)
        assert [h.shape for h in host] == [sl.caches[k][:, 1].shape
                                           for k in sorted(sl.caches)]
        before = {k: v.clone() for k, v in sl.caches.items()}
        sl.write_page(sl.width, 3, host)
        for k, v in sl.caches.items():
            assert torch.equal(v[:, 3], before[k][:, 1])
            assert torch.equal(v[:, 2], before[k][:, 2])


def test_fleet_requires_prefix_share(fm):
    from repro_torch.serve import EngineConfig, UnsupportedConfigError
    from repro_torch.serve.pages import FleetPrefixIndex
    eng = _engine(fm, "repro_torch", prefix_share=False)
    with pytest.raises(UnsupportedConfigError, match="prefix"):
        eng.attach_fleet(FleetPrefixIndex())
    tm, tparams = fm[1]["repro_torch"]
    from repro_torch.serve import Engine
    with pytest.raises(UnsupportedConfigError, match="prefix"):
        Engine(tm, tparams, config=EngineConfig(max_len=16, paged=False),
               fleet=FleetPrefixIndex())


def test_fleet_index_lru_capacity():
    from repro_torch.serve.pages import FleetPrefixIndex
    f = FleetPrefixIndex(capacity=2)
    for lp in range(3):
        f.publish(8, lp, "d", [np.zeros(2)])
    assert len(f) == 2 and not f.has(8, 0, "d") and f.version == 3
    assert f.get(8, 0, "d") is None and f.get(8, 2, "d") is not None
    assert (f.hits, f.misses) == (1, 1)
    with pytest.raises(ValueError):
        FleetPrefixIndex(capacity=0)


# -- sampling surface --------------------------------------------------------


def test_per_request_sampling_matches_engine_wide(fm):
    """Engine-wide sampling with per-request seeds equals a greedy engine
    carrying the same sampling per request, and the reference's tokens."""
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, fm[0].vocab_size, size=7).astype(np.int32)
               for _ in range(3)]
    outs = {}
    for pkg in PKGS:
        serve = _serve(pkg)
        wide = _engine(fm, pkg, max_new_tokens=6, mixed=None,
                       prefill_budget=None, temperature=0.8, top_k=5).run(
            arrivals=[(1, serve.Request(rid=i, prompt=p, max_new_tokens=6,
                                        seed=900 + i))
                      for i, p in enumerate(prompts)])
        per = _engine(fm, pkg, max_new_tokens=6, mixed=None,
                      prefill_budget=None).run(
            arrivals=[(1, serve.Request(
                rid=i, prompt=p, max_new_tokens=6,
                sampling=serve.SamplingParams(temperature=0.8, top_k=5,
                                              seed=900 + i)))
                for i, p in enumerate(prompts)])
        assert _outputs(per) == _outputs(wide)
        outs[pkg] = _outputs(per)
    assert outs["repro_torch"] == outs["repro"]


def test_legacy_kwargs_warn_once_and_match_config(fm, monkeypatch):
    """The reference's test of the same name: the legacy per-knob kwargs
    build the same EngineConfig behind one DeprecationWarning per process,
    and serve the reference Engine's tokens."""
    import warnings
    from repro_torch.serve import Engine, EngineConfig
    from repro_torch.serve import engine as engine_mod
    monkeypatch.setattr(engine_mod, "_LEGACY_KWARGS_WARNED", False)
    m, params = fm[1]["repro_torch"]
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        legacy = Engine(m, params, **ECFG)
        Engine(m, params, max_len=64, num_slots=4)  # no second warning
    deprecations = [x for x in w
                    if issubclass(x.category, DeprecationWarning)]
    assert len(deprecations) == 1
    assert "EngineConfig" in str(deprecations[0].message)
    assert legacy.config == EngineConfig(**ECFG)
    got = _outputs(legacy.run(arrivals=_trace("repro_torch",
                                              fm[0].vocab_size)))
    assert got == _ref_run(fm, True)


def test_config_and_legacy_kwargs_are_exclusive(fm):
    """``config=`` beside a knob, and an unknown knob, raise TypeError as
    in the reference."""
    from repro_torch.serve import Engine, EngineConfig
    m, params = fm[1]["repro_torch"]
    with pytest.raises(TypeError, match="config"):
        Engine(m, params, config=EngineConfig(**ECFG), max_len=64)
    with pytest.raises(TypeError, match="unexpected keyword"):
        Engine(m, params, max_lenn=64)


def test_public_surface_is_the_references():
    import repro.serve as ref
    import repro_torch.serve as serve
    assert set(serve.__all__) == set(ref.__all__) == {
        "Engine", "EngineConfig", "Request", "SamplingParams",
        "Frontend", "Dispatcher", "FaultPlan", "TERMINAL_STATUSES"}
    for name in serve.__all__:
        assert getattr(serve, name) is not None
    assert serve.TERMINAL_STATUSES == ref.TERMINAL_STATUSES


# -- traces ------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["poisson", "bursty"])
@pytest.mark.parametrize("seed", [0, 3])
def test_traces_match_reference(kind, seed):
    """Same specs and arrivals (ticks, prompts, budgets, sampling) as
    ``benchmarks/traces.py`` for the same seed."""
    from benchmarks import traces as ref
    from repro_torch.serve import traces
    if kind == "poisson":
        specs = [m.poisson_trace(12, seed) for m in (ref, traces)]
    else:
        specs = [m.bursty_trace(3, 4, seed) for m in (ref, traces)]
    assert [vars(s) for s in specs[0]] == [vars(s) for s in specs[1]]
    arr = [m.build_arrivals(s, 256, seed + 1)
           for m, s in zip((ref, traces), specs)]
    for (t0, r0), (t1, r1) in zip(*arr):
        assert t0 == t1 and r0.rid == r1.rid
        assert np.array_equal(r0.prompt, r1.prompt)
        assert r0.max_new_tokens == r1.max_new_tokens
        assert (r0.sampling is None) == (r1.sampling is None)
        if r0.sampling is not None:
            assert vars(r0.sampling) == vars(r1.sampling)
    assert len(arr[0]) == len(arr[1])
