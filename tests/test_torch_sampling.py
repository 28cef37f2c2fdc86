"""Seeded sampling in the port, held to the reference bit for bit: the
threefry2x32 bits and float32 uniforms of ``fold_in(key(seed), position)``
against ``jax.random`` (jax 0.9, partitionable layout), the Gumbel noise
within 2 ulp of each ``log`` step, ``sample_tokens`` /
``sample_tokens_batch`` token for token, and the reference's sampled-engine
tests (``tests/test_pages.py``) mirrored on the mixed and the serialized
engine against the reference Engine's tokens."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_parity as tp  # noqa: E402

tp.tf32_off()

SEEDS = [0, 1, 7, 2**31, 2**32 - 1]
POSITIONS = [0, 1, 5, 1000, 2**31 - 1]
N_BITS = 1000
TINY = np.finfo(np.float32).tiny
# Each torch.log is within 1 ulp of XLA's on the CPU (the two libms round
# differently); the Gumbel draw stacks two logs, so the inner -log(u) is
# held within 2 ulp and the outer value within 2 ulp of max(1, |g|)
# (near g = 0 a 1-ulp change of the inner log is many ulp of g itself).
GUMBEL_ULP = 2


def _ulp_diff(a, b):
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_threefry_bits_and_uniforms_match_jax(seed):
    """Raw 32-bit draws equal as integers, uniforms bit-identical, Gumbel
    noise within 2 ulp per log step, for keys ``fold_in(key(seed), p)``."""
    import jax
    from repro_torch.serve import sampling as S
    for p in POSITIONS:
        k = jax.random.fold_in(jax.random.key(np.uint32(seed)), np.int32(p))
        tk = S.fold_in(S.prng_key(np.uint32(seed)), np.uint32(p))
        assert np.array_equal(
            np.asarray(jax.random.key_data(k)).astype(np.int64),
            torch.stack(tk).numpy())
        jb = np.asarray(jax.random.bits(k, (N_BITS,)))
        assert np.array_equal(jb, S.random_bits(tk, N_BITS).numpy()
                              .astype(np.uint32)), (seed, p)
        ju = np.asarray(jax.random.uniform(k, (N_BITS,), minval=TINY,
                                           maxval=1.0))
        tu = S.uniform(tk, N_BITS).numpy()
        assert np.array_equal(ju.view(np.int32), tu.view(np.int32))
        assert _ulp_diff(np.asarray(-jax.numpy.log(ju)),
                         (-torch.log(torch.from_numpy(tu))).numpy()).max() \
            <= GUMBEL_ULP
        jg = np.asarray(jax.random.gumbel(k, (N_BITS,)))
        tg = S.gumbel(tk, N_BITS).numpy()
        lim = GUMBEL_ULP * np.finfo(np.float32).eps * np.maximum(1.0,
                                                                 abs(jg))
        assert (np.abs(jg - tg) <= lim).all()


def _inputs(V, B=16, seed=0):
    rng = np.random.default_rng(seed + V)
    logits = (3 * rng.standard_normal((B, V))).astype(np.float32)
    seeds = rng.integers(0, 2**32, size=B, dtype=np.uint64) \
        .astype(np.uint32)
    pos = rng.integers(0, 5000, size=B).astype(np.int32)
    return logits, seeds, pos


@pytest.mark.parametrize("V", [50, 256, 1000])
@pytest.mark.parametrize("top_k", [None, 1, 5, "V"])
def test_sample_tokens_matches_reference(V, top_k):
    import jax.numpy as jnp
    from repro.serve.sampling import sample_tokens as ref
    from repro_torch.serve.sampling import sample_tokens
    k = V if top_k == "V" else top_k
    logits, seeds, pos = _inputs(V)
    want = np.asarray(ref(jnp.asarray(logits), jnp.asarray(seeds),
                          jnp.asarray(pos), 0.8, k))
    got = sample_tokens(torch.from_numpy(logits), seeds, pos, 0.8, k)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("V", [50, 256, 1000])
def test_sample_tokens_batch_matches_reference(V):
    """Per-row temperatures (0 among them: the greedy lane) and top-k
    (0 and -1: no truncation; 1, 3, 5, 7 and V)."""
    import jax.numpy as jnp
    from repro.serve.sampling import sample_tokens_batch as ref
    from repro_torch.serve.sampling import sample_tokens_batch
    logits, seeds, pos = _inputs(V)
    temps = np.array([0.0, 0.5, 1.3, 0.8] * 4, np.float32)
    topks = np.array([0, 1, 5, V, 3, -1, 0, 7] * 2, np.int32)
    want = np.asarray(ref(*(jnp.asarray(a) for a in (logits, seeds, pos,
                                                      temps, topks))))
    got = sample_tokens_batch(torch.from_numpy(logits), seeds, pos, temps,
                              topks).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(got[temps == 0], logits[temps == 0].argmax(-1))


def test_sampling_unit_respects_top_k():
    """The reference's ``test_sampling_unit_respects_top_k`` on the port:
    draws stay in the top-k set, repeat for the same (seed, position),
    move with the position."""
    from repro_torch.serve.sampling import sample_tokens
    rng = np.random.default_rng(0)
    logits = torch.from_numpy(rng.normal(size=(64, 50)).astype(np.float32))
    top = torch.topk(logits, 5).indices.numpy()
    seeds = np.arange(64, dtype=np.uint32)
    draws = sample_tokens(logits, seeds, np.zeros(64, np.int32), 1.3,
                          top_k=5).numpy()
    for b, t in enumerate(draws):
        assert t in top[b]
    again = sample_tokens(logits, seeds, np.zeros(64, np.int32), 1.3,
                          top_k=5).numpy()
    assert np.array_equal(draws, again)
    moved = sample_tokens(logits, seeds, np.ones(64, np.int32), 1.3,
                          top_k=5).numpy()
    assert not np.array_equal(draws, moved)


def test_nonfinite_row_reports_sentinel_when_sampled():
    from repro_torch.serve.sampling import sample_or_greedy
    x = torch.randn(3, 20)
    x[1, 4] = float("nan")
    s = (np.arange(3, dtype=np.uint32), np.zeros(3, np.int32),
         np.array([0.9, 0.9, 0.0], np.float32), np.zeros(3, np.int32))
    out = sample_or_greedy(x, s).numpy()
    assert out[1] == -1 and out[0] >= 0 and out[2] == int(x[2].argmax())


# -- the engines ---------------------------------------------------------

ENGINES = {"mixed": dict(mixed=True), "serialized": dict(mixed=False)}
SAMPLED = dict(temperature=0.8, top_k=12)


@pytest.fixture(scope="module")
def qwen():
    cfg, m, params = tp.jax_qwen_smoke()
    tm, tparams = tp.torch_qwen_smoke(params)
    return cfg, m, params, tm, tparams


def _run(pkg, model, params, prompts, budgets, req_kw=None, **kw):
    import importlib
    serve = importlib.import_module(pkg + ".serve")
    kw = {"max_len": 16, "max_new_tokens": 8, "num_slots": 2, **kw}
    eng = serve.Engine(model, params, config=serve.EngineConfig(**kw))
    for rid, (p, b) in enumerate(zip(prompts, budgets)):
        eng.submit(serve.Request(rid=rid, prompt=p, max_new_tokens=b,
                                 **(req_kw or {})))
    done = eng.run()
    return {r.rid: (r.status, list(r.output)) for r in done}, \
        eng.decode_stats


def _workload(cfg):
    return tp.prompts(cfg.vocab_size, [3, 11, 7, 5]), [4, 3, 5, 4]


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_engine_sampling_deterministic_and_seeded(qwen, engine):
    """The reference's ``test_engine_sampling_deterministic_and_seeded`` on
    each port engine, and its tokens equal to the reference Engine's: the
    same seed repeats, another base seed moves a stream, an explicit
    ``Request.seed`` pins the stream whatever the base seed."""
    cfg, jm, jp, tm, tparams = qwen
    prompts, budgets = _workload(cfg)
    kw = dict(SAMPLED, **ENGINES[engine])
    a, _ = _run("repro_torch", tm, tparams, prompts, budgets, seed=7, **kw)
    b, _ = _run("repro_torch", tm, tparams, prompts, budgets, seed=7, **kw)
    c, _ = _run("repro_torch", tm, tparams, prompts, budgets, seed=8, **kw)
    ref, _ = _run("repro", jm, jp, prompts, budgets, seed=7, **kw)
    assert a == b == ref
    assert a != c
    greedy, _ = _run("repro_torch", tm, tparams, prompts, budgets,
                     **ENGINES[engine])
    assert a != greedy
    d, _ = _run("repro_torch", tm, tparams, prompts, [4] * 4,
                req_kw={"seed": 99}, seed=7, **kw)
    e, _ = _run("repro_torch", tm, tparams, prompts, [4] * 4,
                req_kw={"seed": 99}, seed=8, **kw)
    assert d == e


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_sampled_decode_invariant_under_preemption(qwen, engine):
    """The reference's ``test_sampled_decode_invariant_under_preemption``
    on each port engine: 7 pages of 8 tokens for three 30-token prompts
    preempt, and the resumed requests draw the uncut pool's tokens, which
    are the reference Engine's (preemptions counted alike)."""
    cfg, jm, jp, tm, tparams = qwen
    prompts = tp.prompts(cfg.vocab_size, [30, 30, 30, 12], seed=5)
    budgets = [8] * 4
    kw = dict(SAMPLED, seed=7, num_slots=3, max_prompt_len=40, page_size=8,
              **ENGINES[engine])
    free, _ = _run("repro_torch", tm, tparams, prompts, budgets, **kw)
    tight, st = _run("repro_torch", tm, tparams, prompts, budgets,
                     pool_frac=0.34, **kw)
    ref, rst = _run("repro", jm, jp, prompts, budgets, pool_frac=0.34, **kw)
    assert st["preemptions"] > 0
    assert tight == free == ref
    assert st["preemptions"] == rst["preemptions"]
    assert st["preemptions_recovered"] == rst["preemptions_recovered"]


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_per_request_sampling_mixed_batch_matches_reference(qwen, engine):
    """Greedy requests and requests with their own ``SamplingParams``
    (temperature, top-k, seed; one with ``top_k=0`` under an engine-wide
    top-k) share batches: tokens equal the reference Engine's, and the
    greedy ones equal an all-greedy run's."""
    cfg, jm, jp, tm, tparams = qwen
    prompts = tp.prompts(cfg.vocab_size, [6, 9, 4, 12, 7], seed=3)
    budgets = [5, 6, 4, 5, 6]

    def run(pkg, model, params, sampled):
        import importlib
        serve = importlib.import_module(pkg + ".serve")
        sps = [None, serve.SamplingParams(temperature=0.9, top_k=4, seed=7),
               None, serve.SamplingParams(temperature=1.1, seed=3),
               serve.SamplingParams(temperature=0.7, top_k=0)]
        eng = serve.Engine(model, params, config=serve.EngineConfig(
            max_len=16, max_new_tokens=8, num_slots=3, top_k=9,
            **ENGINES[engine]))
        for rid, (p, b) in enumerate(zip(prompts, budgets)):
            eng.submit(serve.Request(rid=rid, prompt=p, max_new_tokens=b,
                                     sampling=sps[rid] if sampled else None))
        return {r.rid: (r.status, list(r.output)) for r in eng.run()}

    got = run("repro_torch", tm, tparams, True)
    assert got == run("repro", jm, jp, True)
    greedy = run("repro_torch", tm, tparams, False)
    for rid in (0, 2):
        assert got[rid] == greedy[rid]
    assert any(got[rid] != greedy[rid] for rid in (1, 3, 4))


def test_greedy_step_builds_no_sampling_op(qwen, monkeypatch):
    """An all-greedy step never calls the batch sampler; a sampled one
    does, once per step (the first token's draw included)."""
    from repro_torch.serve import sampling as S
    cfg, _, _, tm, tparams = qwen
    calls = []
    real = S.sample_tokens_batch
    monkeypatch.setattr(S, "sample_tokens_batch",
                        lambda *a: calls.append(1) or real(*a))
    prompts, budgets = _workload(cfg)
    _, st = _run("repro_torch", tm, tparams, prompts, budgets)
    assert not calls
    _, st = _run("repro_torch", tm, tparams, prompts, budgets, **SAMPLED)
    assert len(calls) == st["steps"]
