"""The mixed step over its live columns alone (``Model.mixed_hidden`` with
``cols``, the engine's path for dense stacks) against the reference's
``mixed_step``, which computes every column of the ``(B, S)`` grid, on
bridged float32 smoke models over paged lanes; and the engine that packs
its mixed steps.

* One grid of rows — a mid-prompt chunk, a decode row, an inert (masked)
  row, a fresh full-width prompt and a chunk that wraps its lane — for
  qwen2.5 (dense and tda attention, dense and compressed weights) and
  starcoder2 on ring lanes of its window: logits at every live column and
  the page pools.
* The engine: greedy tokens equal to the reference Engine's and to the
  port's own all-column step, every mixed ``dispatch`` span's ``cols`` and
  ``live`` equal to the step's fresh tokens; a routed (MoE) stack runs
  every column of its steps.

Tolerances as ``tests/test_torch_model.py``'s: ``ATOL_LOGITS``,
``ATOL_POOL``."""
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_parity as tp  # noqa: E402

tp.tf32_off()

PS, S = 8, 6
# rows: mid-prompt chunk, decode row, inert (masked) row, fresh full-width
# prompt, a chunk whose last columns wrap past the lane's end
NN = np.array([4, 1, 3, S, S], np.int32)
ACTIVE = np.array([True, True, False, True, True])
B = NN.size

_MODELS = {}


def _models(arch, fmt):
    """(reference model, params, port model, params), made once each."""
    if (arch, fmt) in _MODELS:
        return _MODELS[arch, fmt]
    if fmt == "dense":
        _, jm, jp = tp.jax_smoke(arch)
        tm, tparams = tp.torch_smoke(arch, jp)
    else:
        from repro.core import factorized as rf
        from repro_torch.core import factorized as tf
        _, jm, jp = tp.jax_smoke(arch, factorization=rf.FactorizationConfig(
            **tp.FCFG))
        jm, jp, _ = jm.compress_params(rf.project_wd_leaves(
            jp, jm.cfg.factorization))
        tm, tparams = tp.torch_smoke(arch, jp, factorization=(
            tf.FactorizationConfig(**tp.FCFG)))
        tm = tm.with_weight_format("compressed")
    _MODELS[arch, fmt] = jm, jp, tm, tparams
    return _MODELS[arch, fmt]


@pytest.mark.parametrize("arch,fmt,mode", [
    ("qwen2.5-32b", "dense", "dense"),
    ("qwen2.5-32b", "dense", "tda"),
    ("qwen2.5-32b", "compressed", "dense"),
    ("qwen2.5-32b", "compressed", "tda"),
    ("starcoder2-15b", "dense", "tda"),
])
def test_packed_mixed_step_matches_reference(arch, fmt, mode):
    """The port runs the live columns alone (the inert row has none); the
    reference runs the whole grid. starcoder2's lanes are rings of its
    32-token window; qwen2.5's are 24 positions wide."""
    import jax.numpy as jnp
    jm, jp, tm, tparams = _models(arch, fmt)
    jm, tm = jm.with_decode_attn(mode), tm.with_decode_attn(mode)
    cfg = tm.cfg
    W = cfg.sliding_window or 3 * PS  # the lane: a ring of the window
    npg = W // PS
    ci = np.array([5, 14, 9, 0, W - 2], np.int32)
    rng = np.random.default_rng(11)
    P = B * npg + 2
    bt = rng.permutation(P)[:B * npg].reshape(B, npg).astype(np.int32)
    bt[1, -1] = P  # row 1 holds one page fewer (a FREE tail)
    shape = (cfg.n_layers, P, PS, cfg.kv_heads, cfg.head_dim)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    jl, jc = jm.mixed_step(
        jp, {"inputs": jnp.asarray(toks)},
        {"k": jnp.asarray(k), "v": jnp.asarray(v)}, jnp.asarray(ci),
        jnp.asarray(NN), slot_mask=jnp.asarray(ACTIVE),
        pages={"bt": jnp.asarray(bt), "width": W, "page_size": PS})
    row, col = np.nonzero((np.arange(S)[None] < NN[:, None])
                          & ACTIVE[:, None])
    tc = {"k": tp.t(k), "v": tp.t(v)}
    with torch.inference_mode():
        h, tc = tm.mixed_hidden(
            tparams, {"inputs": tp.t(toks[row, col][None])}, tc, tp.t(ci),
            tp.t(NN), slot_mask=tp.t(ACTIVE),
            pages={"bt": tp.t(bt), "width": W, "page_size": PS},
            cols={"row": tp.t(row), "col": tp.t(col), "width": S})
        tl = tm.logits(tparams, h)[0]
    assert h.shape == (1, int(NN[ACTIVE].sum()), cfg.d_model)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl)[row, col],
                               atol=tp.ATOL_LOGITS, rtol=0)
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   atol=tp.ATOL_POOL, rtol=0)


# Chunks of 8 (budget 8) over prompts of 5-25 tokens on 3 slots: steps
# carry mid-prompt chunks, budget-starved rows and decode rows together.
ENGINE_KW = dict(tp.ENGINE_KW, max_len=8, prefill_budget=8,
                 prefix_share=False)


def _rounds():
    return [[(i, p, b) for i, (p, b) in enumerate(zip(
        tp.prompts(256, tp.LENGTHS), tp.BUDGETS))]]


def _mixed_dispatches(lo):
    from repro_torch.serve import spans
    got = spans.records(lo, time.time_ns())
    assert got.complete
    return [s.attrs for s in got.spans if s.name == "dispatch"
            and s.attrs["kind"] == "mixed"]


def _serve_port(model, params, pack):
    """The port's engine on :func:`_rounds`, packing its mixed steps or
    running every column; the outputs and each mixed step's ``n_new``."""
    from repro_torch.serve import Engine, EngineConfig, Request
    eng = Engine(model, params, config=EngineConfig(**ENGINE_KW))
    assert eng._pack_mixed
    eng._pack_mixed = pack
    n_new = []
    run = eng._run_mixed

    def keep(toks, nn, *a):
        n_new.append(nn.copy())
        return run(toks, nn, *a)

    eng._run_mixed = keep
    for rid, prompt, budget in _rounds()[0]:
        eng.submit(Request(rid=rid, prompt=prompt, max_new_tokens=budget))
    lo = time.time_ns()
    done = eng.run()
    return {r.rid: (list(r.output), r.status) for r in done}, n_new, \
        _mixed_dispatches(lo)


def test_engine_packs_mixed_steps_with_the_same_tokens():
    """Greedy tokens equal to the reference Engine's and to the port's
    all-column mixed step; each mixed dispatch ran Σ n_new columns."""
    _, jm, jp = tp.jax_qwen_smoke()
    tm, tparams = tp.torch_qwen_smoke(jp)
    want, _, _ = tp.serve_rounds("repro", jm, jp, _rounds(), **ENGINE_KW)
    got, n_new, attrs = _serve_port(tm, tparams, True)
    wide, _, wide_attrs = _serve_port(tm, tparams, False)
    assert got == want == wide
    assert all(s == "ok" for _, s in got.values())
    live = [int(n.sum()) for n in n_new]
    assert len(attrs) == len(live) > 4
    assert [(a["cols"], a["live"]) for a in attrs] == [(n, n) for n in live]
    # steps that mix a chunk with decode rows, and chunk-only ones
    assert any(n.max() > 1 and (n == 1).any() for n in n_new)
    assert any(n.max() > 1 and not (n == 1).any() for n in n_new)
    assert [a["cols"] for a in wide_attrs] == \
        [ENGINE_KW["num_slots"] * ENGINE_KW["max_len"]] * len(wide_attrs)
    assert [a["live"] for a in wide_attrs] == live


def test_routed_stack_runs_every_column():
    """A routed (MoE) stack's experts take every column of the step, so
    its engine keeps the ``num_slots x chunk`` grid."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import Model
    from repro_torch.serve import Engine, EngineConfig, Request
    model = Model(get_config("dbrx-132b", "smoke", dtype="float32"),
                  device="cpu")
    eng = Engine(model, model.init(seed=0),
                 config=EngineConfig(**ENGINE_KW))
    assert not eng._pack_mixed
    for rid, prompt, budget in _rounds()[0]:
        eng.submit(Request(rid=rid, prompt=prompt, max_new_tokens=budget))
    lo = time.time_ns()
    done = eng.run()
    assert all(r.status == "ok" for r in done)
    attrs = _mixed_dispatches(lo)
    assert attrs
    assert all(a["cols"] == ENGINE_KW["num_slots"] * ENGINE_KW["max_len"]
               > a["live"] for a in attrs)
