"""The chaos harness and audits in the port, held to the reference: the
cases of the reference's ``tests/test_faults.py`` on the port's
``FaultPlan`` / ``FaultInjector``, the engine's fault seams (allocation
failures, forced preemption, NaN logits on the device, stall ticks) and
``audit=True``, each compared with the reference Engine run on the same
workload: statuses, outputs and counters."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_parity as tp  # noqa: E402

tp.tf32_off()

PKGS = ("repro", "repro_torch")
ENGINES = {"mixed": dict(mixed=True), "serialized": dict(mixed=False)}
COUNTERS = ("status_counts", "faults_injected", "preemptions",
            "preemptions_recovered", "audit_violations", "clock_ticks",
            "steps", "decoded_tokens")


@pytest.fixture(scope="module")
def fm():
    cfg, m, params = tp.jax_qwen_smoke()
    tm, tparams = tp.torch_qwen_smoke(params)
    return cfg, {"repro": (m, params), "repro_torch": (tm, tparams)}


def _workload(cfg, n=6, seed=11):
    rng = np.random.default_rng(seed)
    lengths = [int(rng.integers(3, 14)) for _ in range(n)]
    budgets = [int(rng.integers(3, 9)) for _ in range(n)]
    prompts = [rng.integers(0, cfg.vocab_size, size=L).astype(np.int32)
               for L in lengths]
    return prompts, budgets


def _serve(pkg):
    import importlib
    return importlib.import_module(pkg + ".serve")


def _run(fm, pkg, prompts, budgets, *, req_kw=None, faults=None, **kw):
    """One engine of ``pkg`` over the workload; ``faults`` is a callable
    given the package's serve module (each package its own plan)."""
    serve = _serve(pkg)
    model, params = fm[1][pkg]
    kw = {"max_len": 16, "max_new_tokens": 16, "num_slots": 4, **kw}
    eng = serve.Engine(model, params, config=serve.EngineConfig(**kw),
                       faults=faults(serve) if faults else None)
    for rid, (p, b) in enumerate(zip(prompts, budgets)):
        eng.submit(serve.Request(rid=rid, prompt=p, max_new_tokens=b,
                                 **(req_kw[rid] if req_kw else {})))
    done = eng.run()
    return {r.rid: (r.status, list(r.output), r.status_reason)
            for r in done}, eng


def _both(fm, prompts, budgets, **kw):
    """The port's run, after checking it equals the reference's:
    statuses, outputs, reasons and the COUNTERS of decode_stats."""
    (ref, reng), (got, eng) = (_run(fm, p, prompts, budgets, **kw)
                               for p in PKGS)
    assert got == ref
    for k in COUNTERS:
        assert eng.decode_stats[k] == reng.decode_stats[k], k
    return got, eng


# -- the injector itself ---------------------------------------------------


def _trace(inj_cls, plan, steps=20):
    inj = inj_cls(plan)
    active = np.array([True, True, True, False])
    out = []
    for step in range(steps):
        ticks = inj.begin_step(step, 4, active)
        m = inj.nan_mask()
        out.append((ticks, None if m is None else m.tolist(),
                    inj.forced_preempt(),
                    [inj.alloc_fail() for _ in range(3)]))
    return out, dict(inj.counts)


def test_injector_schedule_is_reproducible_and_the_references():
    """The same plan gives the same schedule twice, and the reference
    injector's: one numpy generator drawn NaN, preempt, stall per step and
    once per allocation call."""
    plans = {pkg: _serve(pkg).FaultPlan(
        seed=9, p_nan_logits=0.2, p_forced_preempt=0.3, p_alloc_fail=0.25,
        p_stall=0.2, max_faults=12, nan_at=((3, 1),), preempt_at=(5,),
        stall_at=((2, 7),)) for pkg in PKGS}
    from repro_torch.serve.faults import FaultInjector
    from repro.serve.faults import FaultInjector as RefInjector
    a = _trace(FaultInjector, plans["repro_torch"])
    assert a == _trace(FaultInjector, plans["repro_torch"])
    assert a == _trace(RefInjector, plans["repro"])
    assert sum(a[1].values()) > 0


def test_injector_scheduled_faults_fire_exactly():
    from repro_torch.serve.faults import FaultInjector, FaultPlan
    plan = FaultPlan(nan_at=((2, 0), (2, 3)), preempt_at=(4,),
                     alloc_fail_at=(1,), stall_at=((3, 9),))
    inj = FaultInjector(plan)
    for step in range(6):
        ticks = inj.begin_step(step, 4, np.ones(4, bool))
        if step == 2:
            assert inj.nan_mask().tolist() == [True, False, False, True]
        else:
            assert inj.nan_mask() is None
        assert inj.forced_preempt() == (step == 4)
        assert inj.alloc_fail() == (step == 1)
        assert inj.alloc_fail() == (step == 1)
        assert ticks == (9 if step == 3 else 0)
    inj = FaultInjector(plan)
    inj.begin_step(2, 4, np.array([True, False, False, False]))
    assert inj.nan_mask().tolist() == [True, False, False, False]


def test_fault_plan_requires_known_type(fm):
    from repro_torch.serve import Engine, EngineConfig
    tm, tparams = fm[1]["repro_torch"]
    with pytest.raises(TypeError):
        Engine(tm, tparams, config=EngineConfig(max_len=16),
               faults={"p_nan_logits": 0.1})


# -- chaos in, clean survivors and full accounting out -----------------------


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_chaos_survivors_match_reference_and_clean_run(fm, engine):
    """Seeded chaos (allocation failures, forced preemptions, NaN logits,
    stalls) with audits on: the port's statuses, outputs, reasons,
    ``faults_injected``, ``preemptions`` and clock equal the reference's;
    survivors' tokens equal a fault-free run's, the quarantined keep a
    clean prefix; a second run replays the first."""
    cfg = fm[0]
    prompts, budgets = _workload(cfg, n=6)
    kw = dict(page_size=16, **ENGINES[engine])
    clean, _ = _run(fm, "repro_torch", prompts, budgets, **kw)

    def plan(serve):
        return serve.FaultPlan(seed=5, p_alloc_fail=0.05,
                               p_forced_preempt=0.2, p_nan_logits=0.04,
                               p_stall=0.1, max_faults=10)

    got, eng = _both(fm, prompts, budgets, faults=plan, audit=True, **kw)
    st = eng.decode_stats
    assert sum(st["faults_injected"].values()) > 0
    assert st["preemptions"] > 0 and st["failed"] > 0
    assert st["completed_ok"] + st["failed"] == len(prompts)
    assert st["failed"] <= st["faults_injected"]["nan_logits"]
    for rid, (status, out, reason) in got.items():
        if status == "ok":
            assert out == clean[rid][1]
        else:
            assert out == clean[rid][1][:len(out)]
            assert "non-finite" in reason
    again, eng2 = _run(fm, "repro_torch", prompts, budgets, faults=plan,
                       audit=True, **kw)
    assert again == got
    assert eng2.decode_stats["faults_injected"] == st["faults_injected"]


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_nan_quarantine_isolates_one_slot(fm, engine):
    """A NaN written onto slot 1's logits at iteration 1 (on the device,
    after the model) fails that request alone, as in the reference; the
    others keep the clean run's tokens. Sampled too: the NaN reaches the
    sentinel before the sampler's draw counts."""
    cfg = fm[0]
    prompts, _ = _workload(cfg, n=4, seed=9)
    for extra in ({}, {"temperature": 0.8, "top_k": 12, "seed": 3}):
        kw = dict(page_size=16, **ENGINES[engine], **extra)
        clean, _ = _run(fm, "repro_torch", prompts, [8] * 4, **kw)
        got, eng = _both(fm, prompts, [8] * 4, audit=True,
                         faults=lambda s: s.FaultPlan(nan_at=((1, 1),)),
                         **kw)
        st = eng.decode_stats
        assert st["faults_injected"]["nan_logits"] == 1
        assert st["failed"] == 1 and st["completed_ok"] == 3
        for rid, (status, out, reason) in got.items():
            if status == "failed":
                assert "non-finite" in reason
                assert out == clean[rid][1][:len(out)]
                assert len(out) < len(clean[rid][1])
            else:
                assert out == clean[rid][1]


# -- deadlines, preemption budget, watchdog ---------------------------------


def test_stall_faults_age_deadlines(fm):
    cfg = fm[0]
    prompts, _ = _workload(cfg, n=1, seed=5)
    got, _ = _both(fm, prompts, [6], req_kw=[{"ttl_steps": 10}])
    assert got[0][0] == "ok"
    got, eng = _both(fm, prompts, [6], req_kw=[{"ttl_steps": 10}],
                     faults=lambda s: s.FaultPlan(stall_at=((2, 50),)))
    assert got[0][0] == "timed_out"
    assert eng.decode_stats["faults_injected"]["stall"] == 1


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_forced_preemption_budget_escalates_to_failed(fm, engine):
    """Forced preemptions at iterations 1..4 burn through rid 1's budget
    of one cycle, then bounce rid 0, which still ends with the clean run's
    tokens; the reference's statuses and counters."""
    cfg = fm[0]
    prompts, _ = _workload(cfg, n=2, seed=10)
    kw = dict(page_size=16, **ENGINES[engine])
    clean, _ = _run(fm, "repro_torch", prompts, [8, 8], **kw)
    got, eng = _both(fm, prompts, [8, 8],
                     faults=lambda s: s.FaultPlan(preempt_at=(1, 2, 3, 4)),
                     req_kw=[{}, {"max_preemptions": 1}], **kw)
    assert got[1][0] == "failed" and "preemption budget" in got[1][2]
    assert got[0][:2] == clean[0][:2]
    st = eng.decode_stats
    assert st["preemptions_recovered"] >= 2
    assert st["preemptions"] > st["preemptions_recovered"]


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_watchdog_fails_a_permanently_blocked_head(fm, engine):
    """Every allocation failing (injected) head-blocks the queue with no
    active slot; the watchdog fails the head after ``watchdog_patience``
    idle iterations, at the reference's clock tick."""
    cfg = fm[0]
    prompts, _ = _workload(cfg, n=1, seed=12)
    got, eng = _both(
        fm, prompts, [4], page_size=16, watchdog_patience=5,
        faults=lambda s: s.FaultPlan(alloc_fail_at=tuple(range(200))),
        **ENGINES[engine])
    assert got[0][0] == "failed" and "watchdog" in got[0][2]
    assert got[0][1] == [] and eng.decode_stats["clock_ticks"] < 20


def test_injector_instance_runs_on_across_sessions(fm):
    """A FaultInjector passed as is keeps its schedule across runs (a
    FaultPlan rebuilds one per run), as in the reference."""
    cfg = fm[0]
    prompts, budgets = _workload(cfg, n=3, seed=4)
    counts = {}
    for pkg in PKGS:
        serve = _serve(pkg)
        model, params = fm[1][pkg]
        inj = serve.FaultInjector(serve.FaultPlan(seed=2, p_nan_logits=0.1,
                                                  p_stall=0.3))
        eng = serve.Engine(model, params, config=serve.EngineConfig(
            max_len=16, num_slots=4, page_size=16), faults=inj)
        runs = []
        for _ in range(2):
            for rid, (p, b) in enumerate(zip(prompts, budgets)):
                eng.submit(serve.Request(rid=rid, prompt=p,
                                         max_new_tokens=b))
            runs.append(sorted((r.rid, r.status, tuple(r.output))
                               for r in eng.run()))
        counts[pkg] = (runs, dict(inj.counts), eng.fault_injector is inj)
    assert counts["repro_torch"] == counts["repro"]
    assert counts["repro_torch"][2]


# -- audits ------------------------------------------------------------------


def test_audit_catches_refcount_corruption():
    from repro_torch.core.errors import AuditError
    from repro_torch.serve.pages import PagePool
    pool = PagePool([32], num_slots=2, page_size=16, device="cpu")
    pool.alloc_prefix(0, 20)
    pool.check_invariants()
    c = pool.classes[32]
    c.refcount[int(c.table[0, 0])] += 1
    with pytest.raises(AuditError) as ei:
        pool.check_invariants()
    assert ei.value.check == "refcount-drift"
    assert "[audit:refcount-drift]" in str(ei.value)


def test_audit_catches_lane_bounds_violation():
    from repro_torch.core.errors import AuditError
    from repro_torch.serve.pages import PagePool
    pool = PagePool([32], num_slots=2, page_size=16, device="cpu")
    pool.alloc_prefix(0, 20)
    pool.check_lane_bounds(0, 19)
    pool.check_write_private(0, 19)
    c = pool.classes[32]
    c.table[0, 1] = c.FREE
    with pytest.raises(AuditError):
        pool.check_lane_bounds(0, 19)


def test_engine_audit_raises_on_corruption_and_counts_it(fm):
    """A refcount corrupted between steps trips the next step's audit,
    which raises AuditError and counts the violation."""
    from repro_torch.core.errors import AuditError
    from repro_torch.serve import Engine, EngineConfig, Request
    cfg = fm[0]
    tm, tparams = fm[1]["repro_torch"]
    eng = Engine(tm, tparams, config=EngineConfig(
        max_len=16, num_slots=2, page_size=8, audit=True))
    eng.step(submits=[Request(rid=0, prompt=np.arange(1, 12, dtype=np.int32),
                              max_new_tokens=6)])
    c = eng.slots.pool.classes[eng.slots.width]
    c.refcount[int(c.table[0, 0])] += 1
    with pytest.raises(AuditError):
        eng.step()
    assert eng._audit_violations == 1


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_audit_mode_is_transparent_on_a_healthy_run(fm, engine,
                                                    monkeypatch):
    """``audit=True`` (and the ``REPRO_SERVE_AUDIT`` default) changes no
    token and no counter."""
    cfg = fm[0]
    prompts, budgets = _workload(cfg, n=4, seed=13)
    kw = dict(page_size=16, **ENGINES[engine])
    plain, _ = _run(fm, "repro_torch", prompts, budgets, **kw)
    audited, eng = _both(fm, prompts, budgets, audit=True, **kw)
    assert audited == plain and eng.audit
    assert eng.decode_stats["audit_violations"] == 0
    monkeypatch.setenv("REPRO_SERVE_AUDIT", "1")
    by_env, eng = _run(fm, "repro_torch", prompts, budgets, **kw)
    assert eng.audit and by_env == plain
