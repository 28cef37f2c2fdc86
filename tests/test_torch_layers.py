"""Layer primitives and configs of the port against the reference, at f32:
norms, interleaved RoPE, the SwiGLU FFN, embeddings, logits, the dense
decode attention and the linear layer; and every config field."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_parity as tp  # noqa: E402

tp.tf32_off()


def _cfgs():
    from repro.configs import get_config as jget
    from repro_torch.configs import get_config
    cfg = get_config("qwen2.5-32b", "smoke", dtype="float32")
    jcfg = jget("qwen2.5-32b", "smoke", dtype="float32")
    return cfg, jcfg


@pytest.mark.parametrize("variant", ["smoke", "full"])
def test_configs_match_reference(variant):
    """Every field of every architecture's config, smoke and full."""
    from repro.configs import get_config as jget, list_archs
    from repro_torch.configs import get_config, list_archs as tlist
    assert tlist() == list_archs()
    for arch in list_archs():
        a, b = get_config(arch, variant), jget(arch, variant)
        for f in dataclasses.fields(b):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if dataclasses.is_dataclass(y):
                assert dataclasses.asdict(x) == dataclasses.asdict(y), \
                    (arch, f.name)
            else:
                assert x == y, (arch, f.name)
        assert (a.kv_heads, a.head_dim, a.uniform_layers) == \
            (b.kv_heads, b.head_dim, b.uniform_layers)
        assert str(a.compute_dtype).split(".")[-1] == str(b.compute_dtype)
        if b.moe is None and b.uniform_layers and b.family != "ssm":
            assert a.n_params() == b.n_params(), arch


@pytest.mark.parametrize("layernorm", [False, True])
def test_apply_norm(layernorm):
    import jax.numpy as jnp
    from repro.models import layers as J
    from repro_torch.models import layers as T
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3
    p = {"scale": rng.standard_normal(64).astype(np.float32)}
    if layernorm:
        p["bias"] = rng.standard_normal(64).astype(np.float32)
    ref = np.asarray(J.apply_norm({k: jnp.asarray(v) for k, v in p.items()},
                                  jnp.asarray(x)))
    got = T.apply_norm({k: tp.t(v) for k, v in p.items()}, tp.t(x))
    np.testing.assert_allclose(got.numpy(), ref, atol=tp.ATOL_LAYER, rtol=0)


def test_rope_interleaved():
    import jax.numpy as jnp
    from repro.models import layers as J
    from repro_torch.models import layers as T
    rng = np.random.default_rng(1)
    pos = rng.integers(0, 4000, size=(2, 7)).astype(np.int32)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    jc, js = J.rope_tables(jnp.asarray(pos), 16, 1e6)
    tc, ts = T.rope_tables(tp.t(pos), 16, 1e6)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=tp.ATOL_LAYER)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=tp.ATOL_LAYER)
    ref = np.asarray(J.apply_rope(jnp.asarray(x), jc, js))
    got = T.apply_rope(tp.t(x), tc, ts).numpy()
    np.testing.assert_allclose(got, ref, atol=tp.ATOL_LAYER, rtol=0)
    # Interleaved pairs, not rotate_half: position 0 is the identity and
    # pair (0, 1) rotates together.
    z = T.apply_rope(tp.t(x), *T.rope_tables(torch.zeros(2, 7), 16, 1e6))
    np.testing.assert_allclose(z.numpy(), x, atol=0)


def test_ffn_linear_embed_logits():
    import jax
    import jax.numpy as jnp
    from repro.core.factorized import apply_linear as jlin
    from repro.models import layers as J
    from repro_torch.core.factorized import apply_linear
    from repro_torch.models import layers as T
    cfg, jcfg = _cfgs()
    _, jm, params = tp.jax_qwen_smoke()
    npp = tp.to_numpy_tree(params)
    lp = jax.tree.map(lambda a: a[0], params["layers"])
    tlp = {k: tp.t(v[0]) for k, v in npp["layers"]["ffn"]["w_up"].items()}
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 4, 64)).astype(np.float32)
    ref = np.asarray(J.ffn_block(lp["ffn"], jnp.asarray(x), cfg=jcfg,
                                 dicts=None))
    tffn = {n: {k: tp.t(v[0]) for k, v in d.items()}
            for n, d in npp["layers"]["ffn"].items()}
    got = T.ffn_block(tffn, tp.t(x), cfg=cfg).numpy()
    np.testing.assert_allclose(got, ref, atol=tp.ATOL_LAYER, rtol=0)
    wq = {k: tp.t(v[0]) for k, v in npp["layers"]["attn"]["wq"].items()}
    jref = np.asarray(jlin(lp["attn"]["wq"], jnp.asarray(x), None, "q",
                           jcfg.factorization))
    np.testing.assert_allclose(apply_linear(wq, tp.t(x)).numpy(), jref,
                               atol=tp.ATOL_LAYER, rtol=0)
    assert tlp["w"].shape == (64, 128)  # (d_in, d_out) kept
    toks = rng.integers(0, cfg.vocab_size, size=(3, 4)).astype(np.int32)
    emb = {"tok": tp.t(npp["embed"]["tok"])}
    np.testing.assert_array_equal(
        T.embed_tokens(emb, tp.t(toks), cfg).numpy(),
        np.asarray(J.embed_tokens(params["embed"], jnp.asarray(toks), jcfg)))
    head = {"w": tp.t(npp["lm_head"]["w"])}
    np.testing.assert_allclose(
        T.lm_logits(head, emb, tp.t(x), cfg).numpy(),
        np.asarray(J.lm_logits(params["lm_head"], params["embed"],
                               jnp.asarray(x), jcfg)),
        atol=tp.ATOL_LOGITS, rtol=0)


def test_dense_decode_attention():
    """The dense decode path, including rows with no valid position (the
    reference's uniform average, which the engine discards)."""
    import jax.numpy as jnp
    from repro.models import layers as J
    from repro_torch.models import layers as T
    rng = np.random.default_rng(3)
    q = rng.standard_normal((4, 1, 10, 16)).astype(np.float32)
    k = rng.standard_normal((4, 24, 2, 16)).astype(np.float32)
    v = rng.standard_normal((4, 24, 2, 16)).astype(np.float32)
    idx = np.array([0, 1, 13, 24], np.int32)
    ref = np.asarray(J.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), jnp.asarray(idx)))
    got = T.decode_attention(tp.t(q), tp.t(k), tp.t(v), tp.t(idx)).numpy()
    np.testing.assert_allclose(got, ref, atol=tp.ATOL_ATTN, rtol=0)


def test_sampling_greedy_first_index_and_nonfinite():
    from repro_torch.serve.sampling import greedy_tokens
    x = torch.tensor([[0.0, 2.0, 2.0, 1.0], [1.0, float("nan"), 0.0, 0.0],
                      [-1.0, -1.0, -1.0, -1.0]])
    assert greedy_tokens(x).tolist() == [1, -1, 0]
