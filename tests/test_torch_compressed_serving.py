"""Compressed weights through the port's serving path, against the
reference on bridged parameters (float32 qwen2.5 smoke, factorized with
the JAX tests' ``FCFG``, W_D projected to its support and compressed by
the reference's ``Model.compress_params``):

* each linear (``apply_compressed_linear``) on the kernel route (the DMM /
  SMM wrappers' plain versions here) and the decompress route;
* ``Model.decode_step`` / ``mixed_step`` logits over paged lanes;
* the ``Engine``'s tokens on compressed and on dense-factorized params
  equal to the reference ``Engine``'s, and its traffic accounting.

Tolerances: logits ``ATOL_LOGITS`` (f32 reduction order through 2 layers
and the LM head, ``_torch_parity.py``); a single linear 1e-5 (f32, one
reduction order); byte counts exact, ``bytes_per_token`` to float
rounding (rel 1e-12).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_parity as tp  # noqa: E402

tp.tf32_off()

PS, NPG, B, S = 8, 3, 4, 6
W = PS * NPG
FAMILIES = {"wq": "attn_q", "wk": "attn_k", "wv": "attn_v", "wo": "attn_o",
            "w_up": "ffn_up", "w_gate": "ffn_gate", "w_down": "ffn_down"}
BLOCK = {"attn_q": "attn", "attn_k": "attn", "attn_v": "attn",
         "attn_o": "attn", "ffn_up": "ffn", "ffn_gate": "ffn",
         "ffn_down": "ffn"}


def _fcfg(mod):
    return mod.FactorizationConfig(enabled=True, min_dim=32, rank=32, nnz=8)


@pytest.fixture(scope="module")
def trees():
    """(reference model, projected params, compressed model, cparams,
    stats) and the port's (model, params, compressed model, cparams) on
    the CPU, the latter bridged from the former."""
    import jax
    from repro.configs import get_config as jget
    from repro.core import factorized as rf
    from repro.models.transformer import Model as JM
    from repro_torch.configs import get_config as tget
    from repro_torch.core import factorized as tf
    from repro_torch.models.bridge import params_from_numpy
    from repro_torch.models.transformer import Model as TM
    jm = JM(jget("qwen2.5-32b", "smoke", dtype="float32",
                 factorization=_fcfg(rf)))
    jp = rf.project_wd_leaves(jm.init(jax.random.key(0)), _fcfg(rf))
    jmc, jcp, stats = jm.compress_params(jp)
    tm = TM(tget("qwen2.5-32b", "smoke", dtype="float32",
                 factorization=_fcfg(tf)), device="cpu")
    tparams = params_from_numpy(tp.to_numpy_tree(jp), tp.CPU)
    tcp = params_from_numpy(tp.to_numpy_tree(jcp), tp.CPU)
    return jm, jp, jmc, jcp, stats, tm, tparams, tm.with_weight_format(
        "compressed"), tcp


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_compressed_linear_matches_reference(trees, name, use_kernel):
    """One layer's linear on the kernel route (the reference's Pallas
    kernels in interpret mode; the port's wrappers run their plain
    versions on the CPU) and on the decompress route."""
    import jax.numpy as jnp
    from repro.core.factorized import apply_compressed_linear as japply
    from repro_torch.core.factorized import apply_compressed_linear
    _, jpar, _, jcp, _, _, _, _, tcp = trees
    fam = FAMILIES[name]
    jp = {k: v[1] for k, v in jcp["layers"][BLOCK[fam]][name].items()}
    tparams = {k: v[1] for k, v in tcp["layers"][BLOCK[fam]][name].items()}
    d_in = jpar["dicts"][fam].shape[0]
    x = np.random.default_rng(4).normal(size=(2, 3, d_in)).astype(np.float32)
    ref = japply(jp, jnp.asarray(x), jcp["dicts"], fam,
                 compute_dtype=jnp.float32, use_kernel=use_kernel)
    got = apply_compressed_linear(tparams, tp.t(x), tcp["dicts"], fam,
                                  compute_dtype=torch.float32,
                                  use_kernel=use_kernel)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_raw_dictionary_keeps_smm_route(trees, name, monkeypatch):
    """A raw (uncompressed) W_S beside compressed W_D streams: the kernel
    route multiplies by the dense W_S and still sends W_D through the SMM
    wrapper, never a densified W_D; it equals the reference's decompress
    route to 1e-5 (f32, one reduction order)."""
    import jax.numpy as jnp
    from repro.core.factorized import apply_compressed_linear as japply
    from repro_torch.core import factorized as tf
    from repro_torch.kernels.smm import ops as smm_ops
    jm, jpar, _, jcp, _, _, _, _, tcp = trees
    fam = FAMILIES[name]
    jp = {k: v[1] for k, v in jcp["layers"][BLOCK[fam]][name].items()}
    tparams = {k: v[1] for k, v in tcp["layers"][BLOCK[fam]][name].items()}
    ws = np.asarray(jpar["dicts"][fam])
    x = np.random.default_rng(5).normal(size=(2, 3, ws.shape[0])).astype(
        np.float32)
    ref = japply(jp, jnp.asarray(x), {fam: jnp.asarray(ws)}, fam,
                 compute_dtype=jnp.float32, use_kernel=False)
    calls = []
    real = smm_ops.compressed_matmul
    monkeypatch.setattr(smm_ops, "compressed_matmul",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))

    def no_densify(*a, **kw):
        raise AssertionError("the kernel route densified W_D")

    monkeypatch.setattr(tf, "decompress_wd_leaf", no_densify)
    got = tf.apply_compressed_linear(tparams, tp.t(x), {fam: tp.t(ws)}, fam,
                                     compute_dtype=torch.float32,
                                     use_kernel=True)
    assert len(calls) == 1
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)


def _state(cfg, seed):
    rng = np.random.default_rng(seed)
    P = B * NPG + 2
    bt = rng.permutation(P)[:B * NPG].reshape(B, NPG).astype(np.int32)
    bt[1, 2] = P
    shape = (cfg.n_layers, P, PS, cfg.kv_heads, cfg.head_dim)
    return (rng, bt, rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize("step", ["decode", "mixed"])
def test_compressed_steps_match_reference(trees, step):
    """Paged decode and mixed steps on the compressed streams: logits of
    live rows / columns and the written pools."""
    import jax.numpy as jnp
    _, _, jmc, jcp, _, _, _, tmc, tcp = trees
    rng, bt, k, v = _state(jmc.cfg, 3)
    width = 1 if step == "decode" else S
    toks = rng.integers(0, jmc.cfg.vocab_size, size=(B, width)).astype(
        np.int32)
    active = np.array([True, True, False, True])
    jpages = {"bt": jnp.asarray(bt), "width": W, "page_size": PS}
    tpages = {"bt": tp.t(bt), "width": W, "page_size": PS}
    jc = {"k": jnp.asarray(k), "v": jnp.asarray(v)}
    tc = {"k": tp.t(k), "v": tp.t(v)}
    if step == "decode":
        ci = np.array([3, 15, 0, 20], np.int32)
        jl, jc = jmc.decode_step(jcp, {"inputs": jnp.asarray(toks)}, jc,
                                 jnp.asarray(ci),
                                 slot_mask=jnp.asarray(active), pages=jpages)
        tl, tc = tmc.decode_step(tcp, {"inputs": tp.t(toks)}, tc, tp.t(ci),
                                 slot_mask=tp.t(active), pages=tpages)
        live = np.ones((B, 1), bool)
    else:
        ci = np.array([5, 14, 9, 0], np.int32)
        nn = np.array([4, 1, 3, S], np.int32)
        jl, jc = jmc.mixed_step(jcp, {"inputs": jnp.asarray(toks)}, jc,
                                jnp.asarray(ci), jnp.asarray(nn),
                                slot_mask=jnp.asarray(active), pages=jpages)
        tl, tc = tmc.mixed_step(tcp, {"inputs": tp.t(toks)}, tc, tp.t(ci),
                                tp.t(nn), slot_mask=tp.t(active),
                                pages=tpages)
        live = (np.arange(S)[None] < nn[:, None]) & active[:, None]
    np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live],
                               atol=tp.ATOL_LOGITS, rtol=0)
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   atol=tp.ATOL_POOL, rtol=0)


_RUNS = {}


def _serve(pkg, model, params, wsb):
    if pkg == "jax":
        from repro.serve import Engine, EngineConfig, Request
    else:
        from repro_torch.serve import Engine, EngineConfig, Request
    eng = Engine(model, params, config=EngineConfig(
        mixed=True, prefill_budget=16, prefix_share=False,
        weight_stream_bits=wsb, **tp.ENGINE_KW))
    reqs = [Request(rid=i, prompt=p, max_new_tokens=b)
            for i, (p, b) in enumerate(zip(
                tp.prompts(model.cfg.vocab_size, tp.LENGTHS), tp.BUDGETS))]
    done = eng.run(arrivals=list(zip(tp.TICKS, reqs)))
    assert sorted(r.rid for r in done) == list(range(len(reqs)))
    assert all(r.status == "ok" for r in done)
    return {r.rid: list(r.output) for r in done}, eng.decode_stats


def _run(trees, pkg, fmt):
    """Serve the parity workload once per (package, format); the dense
    factorized engines price weights by the fallback (every leaf of the
    params as passed), the compressed ones by the audited stream bits."""
    if (pkg, fmt) not in _RUNS:
        jm, jp, jmc, jcp, stats, tm, tparams, tmc, tcp = trees
        model, params = {("jax", "dense"): (jm, jp),
                         ("jax", "compressed"): (jmc, jcp),
                         ("torch", "dense"): (tm, tparams),
                         ("torch", "compressed"): (tmc, tcp)}[(pkg, fmt)]
        wsb = stats["weight_stream_bits"] if fmt == "compressed" else None
        _RUNS[(pkg, fmt)] = _serve(pkg, model, params, wsb)
    return _RUNS[(pkg, fmt)]


@pytest.mark.parametrize("fmt", ["dense", "compressed"])
def test_engine_matches_reference_engine(trees, fmt):
    """Same tokens, counters and traffic accounting as the reference
    Engine, on dense-factorized and on compressed params."""
    ref_out, ref_st = _run(trees, "jax", fmt)
    out, st = _run(trees, "torch", fmt)
    assert out == ref_out
    for key in ("steps", "mixed_steps", "decoded_tokens", "kv_blocks_visited",
                "weight_format", "weight_bytes_per_step", "tp_ranks"):
        assert st[key] == ref_st[key], key
    for key in ("weight_bytes_per_token", "kv_bytes_per_token",
                "kv_bytes_per_token_per_rank", "bytes_per_token"):
        assert st[key] == pytest.approx(ref_st[key], rel=1e-12), key


def test_compressed_bytes_per_token_below_dense(trees):
    """As the reference's serving test asserts: equal decoded tokens, equal
    KV traffic, strictly fewer weight bytes and total bytes per token, in
    the ratio of the stream bits."""
    _, _, _, _, stats, _, tparams, _, _ = trees
    from repro_torch.core.factorized import params_stream_bits
    _, dense = _run(trees, "torch", "dense")
    _, comp = _run(trees, "torch", "compressed")
    assert dense["weight_format"] == "dense"
    assert comp["weight_format"] == "compressed"
    assert comp["decoded_tokens"] == dense["decoded_tokens"] > 0
    assert comp["kv_bytes_per_token"] == pytest.approx(
        dense["kv_bytes_per_token"])
    assert 0 < comp["weight_bytes_per_token"] < dense["weight_bytes_per_token"]
    assert 0 < comp["bytes_per_token"] < dense["bytes_per_token"]
    assert dense["weight_bytes_per_step"] * 8 == params_stream_bits(tparams) \
        == stats["weight_stream_bits_dense"]
    assert dense["weight_bytes_per_token"] / comp["weight_bytes_per_token"] \
        == pytest.approx(stats["weight_compression_ratio"])


def test_model_init_factorized_layout(trees):
    """``Model.init`` draws the factorized layout from its generator: the
    reference's tree shapes, dictionaries per family, stacked ``wd``;
    ``compress_params`` and ``prepare`` keep streams as they are."""
    _, _, _, _, _, tm, tparams, _, _ = trees
    mine = tm.init(seed=0)

    def shapes(tr):
        return {k: (shapes(v) if isinstance(v, dict) else tuple(v.shape))
                for k, v in tr.items()}

    assert shapes(mine) == shapes(tparams)
    assert set(mine["dicts"]) == set(FAMILIES.values())
    mc, cp, st = tm.compress_params(mine)
    assert mc.cfg.weight_format == "compressed"
    assert cp["layers"]["ffn"]["w_up"]["wd_deltas"].dtype == torch.uint8
    prep = mc.prepare(cp)
    assert prep["layers"]["attn"]["wq"]["wd_vq"] is \
        cp["layers"]["attn"]["wq"]["wd_vq"]
    assert prep["dicts"]["attn_q"]["lut"] is cp["dicts"]["attn_q"]["lut"]


def test_bridge_keeps_compressed_streams(trees):
    """The reference's compressed tree crosses the bridge unchanged: the
    nested ``{"codes_packed", "lut"}`` dictionaries and the uint8 / int16
    / int32 / f32 stream leaves keep their dtypes, shapes and values."""
    _, _, _, jcp, _, _, _, _, tcp = trees
    dtypes = {"uint8": torch.uint8, "int16": torch.int16,
              "int32": torch.int32, "float32": torch.float32}
    seen = set()

    def walk(ref, got):
        if isinstance(ref, dict):
            assert set(ref) == set(got)
            for k in ref:
                walk(ref[k], got[k])
            return
        ref = np.asarray(ref)
        seen.add(ref.dtype.name)
        assert got.dtype == dtypes[ref.dtype.name]
        np.testing.assert_array_equal(got.numpy(), ref)

    walk(jcp, tcp)
    assert {"uint8", "int32", "float32"} <= seen
    assert set(tcp["dicts"]["ffn_down"]) == {"codes_packed", "lut"}
