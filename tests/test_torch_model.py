"""``Model.decode_step`` / ``Model.mixed_step`` of the port against the
reference on bridged float32 qwen2.5 smoke (2 layers) over paged lanes: a
mixed batch of chunk, decode, fresh and inert rows; logits and the page
pools each step writes."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_parity as tp  # noqa: E402

tp.tf32_off()

PS, NPG, B, S = 8, 3, 4, 6
W = PS * NPG  # logical lane width


@pytest.fixture(scope="module")
def models():
    cfg, jm, params = tp.jax_qwen_smoke()
    tm, tparams = tp.torch_qwen_smoke(params)
    return cfg, jm, params, tm, tparams


def _state(cfg, seed):
    """Pre-filled pools, shuffled block tables (FREE tails), inputs."""
    rng = np.random.default_rng(seed)
    P = B * NPG + 2
    bt = rng.permutation(P)[:B * NPG].reshape(B, NPG).astype(np.int32)
    bt[1, 2] = P  # row 1 holds only two pages
    shape = (cfg.n_layers, P, PS, cfg.kv_heads, cfg.head_dim)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    return rng, bt, k, v


def _run_both(models, mode, step, ci, nn, active, seed):
    import jax.numpy as jnp
    cfg, jm, params, tm, tparams = models
    rng, bt, k, v = _state(cfg, seed)
    width = 1 if step == "decode" else S
    toks = rng.integers(0, cfg.vocab_size, size=(B, width)).astype(np.int32)
    jmodel = jm.with_decode_attn(mode)
    tmodel = tm.with_decode_attn(mode)
    jpages = {"bt": jnp.asarray(bt), "width": W, "page_size": PS}
    tpages = {"bt": tp.t(bt), "width": W, "page_size": PS}
    jc = {"k": jnp.asarray(k), "v": jnp.asarray(v)}
    tc = {"k": tp.t(k), "v": tp.t(v)}
    if step == "decode":
        jl, jc = jmodel.decode_step(params, {"inputs": jnp.asarray(toks)}, jc,
                                    jnp.asarray(ci),
                                    slot_mask=jnp.asarray(active),
                                    pages=jpages)
        tl, tc = tmodel.decode_step(tparams, {"inputs": tp.t(toks)}, tc,
                                    tp.t(ci), slot_mask=tp.t(active),
                                    pages=tpages)
    else:
        jl, jc = jmodel.mixed_step(params, {"inputs": jnp.asarray(toks)}, jc,
                                   jnp.asarray(ci), jnp.asarray(nn),
                                   slot_mask=jnp.asarray(active), pages=jpages)
        tl, tc = tmodel.mixed_step(tparams, {"inputs": tp.t(toks)}, tc,
                                   tp.t(ci), tp.t(nn), slot_mask=tp.t(active),
                                   pages=tpages)
    return np.asarray(jl), tl.numpy(), jc, tc


@pytest.mark.parametrize("mode", ["dense", "tda"])
def test_decode_step_matches_reference(models, mode):
    ci = np.array([3, 15, 0, 20], np.int32)
    active = np.array([True, True, False, True])
    jl, tl, jc, tc = _run_both(models, mode, "decode", ci, None, active, 0)
    np.testing.assert_allclose(tl, jl, atol=tp.ATOL_LOGITS, rtol=0)
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   atol=tp.ATOL_POOL, rtol=0)


@pytest.mark.parametrize("mode", ["dense", "tda"])
def test_mixed_step_matches_reference(models, mode):
    # rows: mid-prompt chunk, decode row, inert (masked) row, fresh prompt
    ci = np.array([5, 14, 9, 0], np.int32)
    nn = np.array([4, 1, 3, S], np.int32)
    active = np.array([True, True, False, True])
    jl, tl, jc, tc = _run_both(models, mode, "mixed", ci, nn, active, 1)
    live = (np.arange(S)[None, :] < nn[:, None]) & active[:, None]
    np.testing.assert_allclose(tl[live], jl[live], atol=tp.ATOL_LOGITS,
                               rtol=0)
    if mode == "dense":  # same formula for the ignored columns as well
        np.testing.assert_allclose(tl, jl, atol=tp.ATOL_LOGITS, rtol=0)
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   atol=tp.ATOL_POOL, rtol=0)


def test_mixed_chunk_wrapping_lane_writes_last_columns(models):
    """A chunk longer than the rest of the lane wraps: only the last
    ``min(n_new, width)`` columns write, exactly as the reference."""
    ci = np.array([W - 2, 0, 0, 0], np.int32)
    nn = np.array([S, 0, 0, 0], np.int32)
    active = np.array([True, False, False, False])
    jl, tl, jc, tc = _run_both(models, "dense", "mixed", ci, nn, active, 2)
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   atol=tp.ATOL_POOL, rtol=0)


def test_prepare_and_init(models):
    """``prepare`` casts layer weights to the compute dtype once; ``init``
    draws the reference's shapes from a torch generator."""
    import dataclasses
    from repro_torch.models.transformer import Model
    cfg, _, params, tm, tparams = models
    prep = tm.prepare(tparams)
    assert prep["layers"]["attn"]["wq"]["w"].dtype == torch.float32
    bm = Model(dataclasses.replace(tm.cfg, dtype="bfloat16"), device="cpu")
    bprep = bm.prepare(tparams)
    assert bprep["layers"]["ffn"]["w_up"]["w"].dtype == torch.bfloat16
    assert bprep["lm_head"]["w"].dtype == torch.float32
    mine = tm.init(seed=0)
    shapes = lambda tr: {k: (shapes(v) if isinstance(v, dict)  # noqa: E731
                             else tuple(v.shape)) for k, v in tr.items()}
    assert shapes(mine) == shapes(tparams)
    again = tm.init(seed=0)
    assert torch.equal(mine["layers"]["attn"]["wq"]["w"],
                       again["layers"]["attn"]["wq"]["w"])
    _, jm, _, _, _ = models
    ref = jm.init_cache(3, 20)
    got = tm.init_cache(3, 20)
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in ref.items()}
    assert tm.cache_lane_specs() == jm.cache_lane_specs()
    assert tm._block_ring("attn", 20) == jm._block_ring("attn", 20)


def test_bridge_keeps_layout_and_bfloat16_bits():
    import jax.numpy as jnp
    from repro_torch.models.bridge import params_from_numpy
    x = np.asarray(jnp.asarray([1.5, -2.0, 3.0e-3, 65504.0], jnp.bfloat16))
    tree = params_from_numpy({"a": {"w": x, "b": np.arange(6.0).reshape(2, 3)},
                              "l": [np.zeros(2, np.int32)]}, "cpu")
    assert tree["a"]["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tree["a"]["w"].float().numpy(),
                                  x.astype(np.float32))
    assert tree["a"]["b"].shape == (2, 3) and tree["l"][0].dtype == torch.int32
