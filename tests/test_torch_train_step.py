"""Parity of the port's training pieces (``repro_torch``'s data, sparsity,
cross-entropy, ``Model.loss``, optimizers and train step) with the JAX
reference on the CPU, float32, smoke widths, inputs made with numpy from
fixed seeds.

Tolerances, each with its reason:

* ``ATOL_LOSS`` (1e-5 on losses of ~6) and ``RTOL_GRAD`` (1e-5 of
  ``max(1, max |ref|)`` per gradient leaf), with their reasons in
  ``tests/_torch_parity.py``.
* ``ATOL_OPT`` 1e-6 on parameters after optimizer steps at lr 1e-2
  (updates of O(lr); f32 rounding of sqrt / rsqrt / division, ~1e-7 of
  the update), 5e-6 after 5 steps; ``ATOL_OPT_BF16`` 1e-4 with bf16
  moments, whose rounding may land one bf16 ulp (2^-8 relative) apart
  when the f32 values feeding it differ in the last bit.
* Parameters after several train steps: AdamW and Adafactor divide each
  gradient entry by its own running RMS, so an entry whose gradient is at
  the noise level of the reordering above (~1e-7; e.g. the k-projection
  bias, which RoPE makes nearly invariant) moves by up to ``lr`` per step
  in a direction the noise decides. So ``FRAC_STEP`` (1e-3) bounds the
  share of entries more than ``ATOL_STEP`` (1e-5) apart, and no entry may
  be more than ``2 * lr`` per step apart.
* Masks of the top-k projection are compared exactly: seeded float
  weights have no equal magnitudes, where ``lax.top_k`` and
  ``torch.topk`` might order ties differently.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_parity as tp  # noqa: E402

ATOL_LOSS = tp.ATOL_LOSS
RTOL_GRAD = tp.RTOL_GRAD
ATOL_OPT = 1e-6
ATOL_OPT5 = 5e-6
ATOL_OPT_BF16 = 1e-4
ATOL_STEP = 1e-5
FRAC_STEP = 1e-3


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,n_codebooks", [(0, 1), (3, 1), (7, 4)])
def test_lm_batches_bit_equal(seed, n_codebooks):
    from repro.data import lm_batches as ref
    from repro_torch.data import lm_batches
    a = ref(97, 3, 12, seed=seed, n_codebooks=n_codebooks)
    b = lm_batches(97, 3, 12, seed=seed, n_codebooks=n_codebooks)
    for _ in range(3):
        x, y = next(a), next(b)
        assert sorted(x) == sorted(y)
        for k in x:
            assert x[k].dtype == y[k].dtype
            np.testing.assert_array_equal(x[k], y[k])


@pytest.mark.parametrize("dist", ["bert", "uniform", "vit"])
def test_request_lengths_equal(dist):
    from repro.data import request_lengths as ref
    from repro_torch.data import request_lengths
    assert [int(n) for n in request_lengths(40, 64, dist, seed=5)] \
        == [int(n) for n in ref(40, 64, dist, seed=5)]


def test_device_batches_on_cpu():
    from repro_torch.data import device_batches, lm_batches
    b = next(device_batches(lm_batches(50, 2, 8), device="cpu"))
    assert b["inputs"].dtype == torch.int32 and b["inputs"].shape == (2, 8)


# ---------------------------------------------------------------------------
# sparsity, embedding, cross-entropy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("r,d_out,nnz", [(16, 12, 4), (32, 7, 8), (5, 9, 9)])
def test_sparsity_ops_match_reference(r, d_out, nnz):
    """``ste_sparse`` (values, and the identity gradient),
    ``out_of_support_l1`` (value and gradient) and ``column_sparsity``."""
    import jax
    import jax.numpy as jnp
    from repro.core import sparsity as ref
    from repro_torch.core import sparsity
    rng = np.random.default_rng(r * 100 + d_out)
    wd = rng.standard_normal((r, d_out)).astype(np.float32)
    up = rng.standard_normal((r, d_out)).astype(np.float32)

    def jloss(w):
        return jnp.sum(ref.ste_sparse(w, nnz) * up) \
            + 3.0 * ref.out_of_support_l1(w, nnz)

    jv, jg = jax.value_and_grad(jloss)(jnp.asarray(wd))
    w = tp.t(wd).requires_grad_(True)
    tv = (sparsity.ste_sparse(w, nnz) * tp.t(up)).sum() \
        + 3.0 * sparsity.out_of_support_l1(w, nnz)
    (tg,) = torch.autograd.grad(tv, w)
    assert abs(float(tv.detach()) - float(jv)) <= ATOL_LOSS
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-6)
    proj = sparsity.ste_sparse(tp.t(wd), nnz)
    np.testing.assert_array_equal(proj.numpy(),
                                  np.asarray(ref.ste_sparse(wd, nnz)))
    assert ((proj != 0).sum(0) == min(nnz, r)).all()
    # a mean of 0/1 entries in f32: the two reductions round differently
    assert abs(float(sparsity.column_sparsity(proj)) - float(
        ref.column_sparsity(jnp.asarray(proj.numpy())))) <= 1e-6


def test_embedding_out_of_range_ids_match_jnp_take():
    """-1 counts from the end; ids outside [-V, V) give NaN rows, as
    ``jnp.take`` does (the train loop's guard relies on the NaN)."""
    import jax.numpy as jnp
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    cfg = get_config("qwen2.5-32b", "smoke", dtype="float32")
    V = cfg.vocab_size
    rng = np.random.default_rng(0)
    tok = rng.standard_normal((V, cfg.d_model)).astype(np.float32)
    ids = np.array([[-1, V, V + 5, -V, -V - 1, 3]], np.int32)
    want = np.asarray(jnp.take(jnp.asarray(tok), jnp.asarray(ids), axis=0))
    got = L.embed_tokens({"tok": tp.t(tok)}, tp.t(ids), cfg).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.nan_to_num(got), np.nan_to_num(want))


XENT_CASES = {
    # name: (arch, S, chunk, weighted)
    "chunks": ("qwen2.5-32b", 16, 4, False),
    "weights": ("qwen2.5-32b", 16, 8, True),
    "fallback": ("qwen2.5-32b", 15, 4, True),  # S % chunk != 0
    "one_chunk": ("qwen2.5-32b", 12, 512, False),
    "codebooks": ("musicgen-large", 16, 4, True),
    "tied": ("mamba2-370m", 16, 8, False),
}


@pytest.mark.parametrize("name", sorted(XENT_CASES))
def test_xent_matches_reference(name):
    """``cross_entropy`` / ``chunked_xent`` values and gradients with
    respect to ``h`` and the head (or the tied table)."""
    import jax
    from repro.configs import get_config as jget
    from repro.models import layers as JL
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    arch, S, chunk, weighted = XENT_CASES[name]
    jcfg = jget(arch, "smoke", dtype="float32")
    cfg = get_config(arch, "smoke", dtype="float32")
    rng = np.random.default_rng(len(name))
    B, d, V, C = 2, cfg.d_model, cfg.vocab_size, cfg.n_codebooks
    h = rng.standard_normal((B, S, d)).astype(np.float32)
    lbl = rng.integers(0, V, (B, S) + ((C,) if C > 1 else ())).astype(
        np.int32)
    w = (rng.random((B, S)) > 0.3).astype(np.float32) if weighted else None
    if cfg.tie_embeddings:
        head, emb = {}, {"tok": rng.standard_normal((V, d)).astype(
            np.float32) * 0.1}
    else:
        shape = ((C,) if C > 1 else ()) + (d, V)
        head = {"w": rng.standard_normal(shape).astype(np.float32) * 0.1}
        emb = {}

    def jf(hh, hd, em):
        return JL.chunked_xent(hd, em, hh, lbl, jcfg, w, chunk=chunk)

    jv, jg = jax.value_and_grad(jf, argnums=(0, 1, 2))(h, head, emb)
    th = tp.t(h).requires_grad_(True)
    thead = {k: tp.t(v).requires_grad_(True) for k, v in head.items()}
    temb = {k: tp.t(v).requires_grad_(True) for k, v in emb.items()}
    tv = L.chunked_xent(thead, temb, th, tp.t(lbl), cfg,
                        None if w is None else tp.t(w), chunk=chunk)
    leaves = [th] + list(thead.values()) + list(temb.values())
    grads = torch.autograd.grad(tv, leaves)
    assert abs(float(tv.detach()) - float(jv)) <= ATOL_LOSS
    want = [jg[0]] + [jg[1][k] for k in thead] + [jg[2][k] for k in temb]
    for g, j in zip(grads, want):
        j = np.asarray(j)
        assert np.abs(g.numpy() - j).max() <= RTOL_GRAD * max(
            1.0, np.abs(j).max())
    if C == 1 and not weighted:  # the plain function too
        logits = rng.standard_normal((B, S, V)).astype(np.float32)
        assert abs(float(L.cross_entropy(tp.t(logits), tp.t(lbl)))
                   - float(JL.cross_entropy(logits, lbl))) <= ATOL_LOSS


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------

OPT_CASES = {
    "adamw_cosine": dict(name="adamw", schedule="cosine"),
    "adamw_linear_noclip": dict(name="adamw", schedule="linear",
                                grad_clip=0.0),
    "adamw_constant_nowd": dict(name="adamw", schedule="constant",
                                weight_decay=0.0),
    "adamw_bf16_state": dict(name="adamw", state_dtype="bfloat16"),
    "adafactor": dict(name="adafactor", factored_min_dim=6),
    "adafactor_bf16_state": dict(name="adafactor", factored_min_dim=6,
                                 state_dtype="bfloat16"),
    "adamw_project": dict(name="adamw", project=True),
}


def _opt_tree(rng):
    """Leaves of every kind the trainer meets: stacked matrices (factored
    by Adafactor at ``factored_min_dim`` 6), a small matrix (not
    factored), vectors, and a W_D leaf for the projection."""
    return {"layers": {"w": rng.standard_normal((2, 8, 12)),
                       "b": rng.standard_normal((2, 12)),
                       "wd": rng.standard_normal((2, 16, 6))},
            "head": {"w": rng.standard_normal((4, 5))},
            "norm": {"scale": rng.standard_normal((7,))}}


@pytest.mark.parametrize("name", sorted(OPT_CASES))
def test_apply_updates_matches_reference(name):
    """One step, then 4 more on fresh gradients, against the reference's
    ``apply_updates``: params, moments (AdamW ``m``/``v``; Adafactor
    ``vr``/``vc`` on factored leaves, ``v`` on the others), grad norm and
    lr, through warmup and the schedule's decay."""
    import jax
    import jax.numpy as jnp
    from repro.core.factorized import FactorizationConfig as JF
    from repro.optim import OptConfig as JO, apply_updates as j_apply
    from repro.optim import init_opt_state as j_init
    from repro.train import make_project_fn as j_proj
    from repro_torch.core.factorized import FactorizationConfig
    from repro_torch.optim import OptConfig, apply_updates, init_opt_state
    from repro_torch.train import make_project_fn
    kw = dict(OPT_CASES[name])
    project = kw.pop("project", False)
    kw.update(lr=1e-2, warmup_steps=2, total_steps=6)
    rng = np.random.default_rng(len(name))
    p0 = jax.tree.map(lambda a: a.astype(np.float32), _opt_tree(rng))
    jcfg, cfg = JO(**kw), OptConfig(**kw)
    fk = dict(enabled=True, nnz=3)
    jproj = j_proj(JF(**fk)) if project else None
    tproj = make_project_fn(FactorizationConfig(**fk)) if project else None
    jp, js = jax.tree.map(jnp.asarray, p0), j_init(p0, jcfg)
    j_step = jax.jit(lambda p, g, s, i: j_apply(p, g, s, i, jcfg,
                                                project_fn=jproj))
    tpar = {k: jax.tree.map(tp.t, v) for k, v in p0.items()}
    ts = init_opt_state(tpar, cfg)
    assert tp.flat_tree(tp.to_numpy_tree(js)).keys() \
        == tp.flat_tree(ts).keys()
    bf16 = cfg.state_dtype == "bfloat16"
    for step in range(5):
        g = jax.tree.map(lambda a: (a * (3.0 if step == 1 else 0.3)).astype(
            np.float32), _opt_tree(rng))
        jp, js, jst = j_step(jp, g, js, jnp.int32(step))
        tpar, ts, st = apply_updates(
            tpar, {k: jax.tree.map(tp.t, v) for k, v in g.items()}, ts,
            torch.tensor(step, dtype=torch.int32), cfg, project_fn=tproj)
        atol = ATOL_OPT_BF16 if bf16 else (ATOL_OPT if step == 0
                                           else ATOL_OPT5)
        tp.assert_tree_close(tpar, tp.to_numpy_tree(jp), atol)
        tp.assert_tree_close(ts, tp.to_numpy_tree(js), atol, rel=True)
        assert abs(float(st["lr"]) - float(jst["lr"])) <= 1e-9
        assert abs(float(st["grad_norm"]) - float(jst["grad_norm"])) \
            <= 1e-5 * float(jst["grad_norm"])
    if project:
        assert ((tpar["layers"]["wd"] != 0).sum(-2) == 3).all()


@functools.lru_cache(maxsize=None)
def _jax_train_pair(fact: bool):
    return tp.jax_smoke("qwen2.5-32b", **tp.fcfg_over("jax", fact))


@pytest.mark.parametrize("fact,sparse,opt", [
    (False, False, "adamw"), (True, True, "adamw"),
    (True, True, "adafactor")])
def test_train_step_matches_reference(fact, sparse, opt):
    """Three steps of ``launch/steps.py::make_train_step`` (forward,
    backward, the update in place) against the reference's jitted step:
    metrics (with ``grad_norm`` and ``lr``), params and the step."""
    import jax
    import jax.numpy as jnp
    from repro.launch.steps import make_train_step as j_make
    from repro.optim import OptConfig as JO, init_opt_state as j_init
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.bridge import state_from_numpy
    from repro_torch.optim import OptConfig
    kw = dict(name=opt, lr=3e-3, warmup_steps=2, total_steps=10,
              factored_min_dim=16)
    cfg, jm, jp = _jax_train_pair(fact)
    js = {"params": jp, "opt": j_init(jp, JO(**kw)),
          "step": jnp.zeros((), jnp.int32)}
    model, _ = tp.torch_smoke("qwen2.5-32b", jp,
                              **tp.fcfg_over("torch", fact))
    ts = state_from_numpy(tp.to_numpy_tree(js), "cpu")
    jstep = jax.jit(j_make(jm, JO(**kw), sparse_train=sparse))
    tstep = make_train_step(model, OptConfig(**kw), sparse_train=sparse)
    rng = np.random.default_rng(4)
    for _ in range(3):
        batch = tp.train_batch(cfg, rng)
        js, jmet = jstep(js, batch)
        ts, met = tstep(ts, {k: tp.t(v) for k, v in batch.items()})
        assert sorted(met) == sorted(jmet)
        for k in jmet:
            assert abs(float(met[k]) - float(jmet[k])) <= ATOL_LOSS * max(
                1.0, abs(float(jmet[k]))), k
    assert int(ts["step"]) == int(js["step"]) == 3
    got = tp.flat_tree(ts["params"])
    want = tp.flat_tree(tp.to_numpy_tree(js["params"]))
    assert sorted(got) == sorted(want)
    diff = np.concatenate([np.abs(got[k].numpy() - want[k]).ravel()
                           for k in want])
    assert (diff > ATOL_STEP).mean() <= FRAC_STEP, (diff > ATOL_STEP).mean()
    assert diff.max() <= 2 * kw["lr"] * 3
    # A refused update (the loop's guard) leaves the state as it was.
    before = {k: v.clone() for k, v in tp.flat_tree(ts["params"]).items()}
    ts, _ = tstep(ts, {k: tp.t(v) for k, v in batch.items()},
                  guard=lambda m: False)
    assert int(ts["step"]) == 3
    assert all(torch.equal(before[k], v)
               for k, v in tp.flat_tree(ts["params"]).items())
