"""External embeddings and multi-codebook logits (llava-next-mistral-7b,
musicgen-large) against the reference at float32 on the CPU: ``apply``,
``prefill`` and ``decode_step`` on ``{"embeds": (B, S, d)}`` batches with
the reference's parameters bridged over (no token table is drawn for such
models), musicgen's ``(B, S, 4, V)`` logits, musicgen with int8 K/V lanes
(``kv_quant``, the reference's ``tests/test_kv_quant.py`` case), and the
Engine's refusal (the reference's Engine feeds token ids only).

Limits: logits atol 1e-4 (``tp.ATOL_LOGITS``), caches atol 1e-5; the int8
lanes: codes equal but for rounding ties, and logits within the
reference test's relative bound of the full forward (0.05).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_parity as tp  # noqa: E402

ARCHS = ["llava-next-mistral-7b", "musicgen-large"]
_PAIRS: dict = {}


def _pair(arch, **over):
    key = (arch, tuple(sorted(over.items())))
    if key not in _PAIRS:
        cfg, jm, jp = tp.jax_smoke(arch, **over)
        tm, tparams = tp.torch_smoke(arch, jp, **over)
        _PAIRS[key] = (cfg, jm, jp, tm, tparams)
    return _PAIRS[key]


def _embeds(cfg, B=2, S=24, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("arch", ARCHS)
def test_embeds_apply_prefill_decode_match_reference(arch):
    """Logits of ``apply`` over 24 embedded positions, ``prefill`` of 20
    and four ``decode_step``s, and every cache leaf, against the
    reference; no ``embed.tok`` in either tree."""
    import functools
    import jax
    import jax.numpy as jnp
    cfg, jm, jp, tm, tparams = _pair(arch)
    assert "tok" not in jp["embed"] and "tok" not in tparams["embed"]
    assert "tok" not in tm.init(0)["embed"]
    x = _embeds(cfg)
    S = x.shape[1]
    jl = jax.jit(lambda p, b: jm.apply(p, b)[0])(
        jp, {"embeds": jnp.asarray(x)})
    tl, _ = tm.apply(tparams, {"embeds": tp.t(x)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                               atol=tp.ATOL_LOGITS, rtol=0)
    P = S - 4
    jl, jc = jax.jit(functools.partial(jm.prefill, max_len=S + 4))(
        jp, {"embeds": jnp.asarray(x[:, :P])})
    tl, tc = tm.prefill(tparams, {"embeds": tp.t(x[:, :P])}, max_len=S + 4)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                               atol=tp.ATOL_LOGITS, rtol=0)
    decode = jax.jit(jm.decode_step)
    for i in range(P, S):
        jl, jc = decode(jp, {"embeds": jnp.asarray(x[:, i:i + 1])}, jc,
                        jnp.int32(i))
        tl, tc = tm.decode_step(tparams, {"embeds": tp.t(x[:, i:i + 1])}, tc,
                                torch.tensor(i))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=tp.ATOL_LOGITS, rtol=0)
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   atol=tp.ATOL_POOL, rtol=0)


def test_musicgen_multi_codebook_logits():
    """musicgen's head is ``(4, d, V)``: ``apply`` gives ``(B, S, 4, V)``
    and a decode step ``(B, 1, 4, V)``, each codebook its own product."""
    cfg, jm, jp, tm, tparams = _pair("musicgen-large")
    x = tp.t(_embeds(cfg, S=6))
    logits, _ = tm.apply(tparams, {"embeds": x})
    assert tuple(logits.shape) == (2, 6, cfg.n_codebooks, cfg.vocab_size)
    h, _ = tm.hidden(tparams, {"embeds": x})
    for c in range(cfg.n_codebooks):
        torch.testing.assert_close(logits[:, :, c],
                                   h @ tparams["lm_head"]["w"][c],
                                   atol=tp.ATOL_LAYER, rtol=0)
    _, caches = tm.prefill(tparams, {"embeds": x[:, :5]}, max_len=8)
    step, _ = tm.decode_step(tparams, {"embeds": x[:, 5:]}, caches,
                             torch.tensor(5))
    assert tuple(step.shape) == (2, 1, cfg.n_codebooks, cfg.vocab_size)


def test_musicgen_int8_lanes_match_reference():
    """musicgen with ``kv_quant``: prefill 15 embedded positions into int8
    lanes, decode the 16th; codes equal the reference's (but for ties of
    the rounding, at most 1 in 1000), scales within 1e-6, and both
    packages' decode logits within 0.05 of their full forward (the
    reference test's bound)."""
    import jax.numpy as jnp
    cfg, jm, jp, tm, tparams = _pair("musicgen-large", kv_quant=True)
    x = _embeds(cfg, S=16, seed=3)
    _, jc = jm.prefill(jp, {"embeds": jnp.asarray(x[:, :15])}, max_len=20)
    _, tc = tm.prefill(tparams, {"embeds": tp.t(x[:, :15])}, max_len=20)
    assert tc["k"].dtype == torch.int8 and "k_scale" in tc
    for name in ("k", "v"):
        diff = tc[name].numpy().astype(np.int32) - np.asarray(jc[name])
        assert np.abs(diff).max() <= 1 and np.mean(diff != 0) <= 1e-3
        np.testing.assert_allclose(tc[name + "_scale"].numpy(),
                                   np.asarray(jc[name + "_scale"]),
                                   atol=1e-6, rtol=0)
    full, _ = tm.apply(tparams, {"embeds": tp.t(x)})
    dec, _ = tm.decode_step(tparams, {"embeds": tp.t(x[:, 15:])}, tc,
                            torch.tensor(15))
    a, b = full[:, -1].numpy(), dec[:, 0].numpy()
    assert np.abs(a - b).max() / np.abs(a).max() < 0.05
    jdec, _ = jm.decode_step(jp, {"embeds": jnp.asarray(x[:, 15:])}, jc,
                             jnp.int32(15))
    np.testing.assert_allclose(b, np.asarray(jdec)[:, 0], atol=2e-3, rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_refuses_external_embeddings(arch):
    """The Engine feeds token ids only (the reference's fails on such a
    model with a KeyError): the port refuses at construction."""
    from repro_torch.core.errors import UnsupportedConfigError
    from repro_torch.serve import Engine, EngineConfig
    _, _, _, tm, tparams = _pair(arch)
    with pytest.raises(UnsupportedConfigError, match="token ids only"):
        Engine(tm, tparams, config=EngineConfig(max_len=16))


ALL_ARCHS = ["qwen2.5-32b", "starcoder2-15b", "mamba2-370m",
             "recurrentgemma-2b", "musicgen-large", "dbrx-132b",
             "arctic-480b", "yi-34b", "qwen1.5-4b", "llava-next-mistral-7b"]


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_decode_matches_full_forward(arch):
    """The reference's ``tests/test_models_smoke.py`` check on the port:
    every config's smoke variant (bf16 compute, the port's own seeded
    weights) constructs, and a decode step after a 15-position prefill
    gives the full forward's last logits within 0.02 relative."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import Model
    cfg = get_config(arch, "smoke")
    m = Model(cfg, device="cpu")
    params = m.init(0)
    B, S = 2, 16
    g = torch.Generator().manual_seed(0)
    if cfg.external_embeddings:
        x = torch.randn((B, S, cfg.d_model), generator=g)
        full, pre, dec = ({"embeds": x}, {"embeds": x[:, :S - 1]},
                          {"embeds": x[:, S - 1:]})
    else:
        t = torch.randint(0, cfg.vocab_size, (B, S), generator=g)
        full, pre, dec = ({"inputs": t}, {"inputs": t[:, :S - 1]},
                          {"inputs": t[:, S - 1:]})
    logits_full, _ = m.apply(params, full)
    _, caches = m.prefill(params, pre, max_len=S + 4)
    logits_dec, _ = m.decode_step(params, dec, caches, torch.tensor(S - 1))
    a = logits_full[:, -1].float()
    b = logits_dec[:, 0].float()
    rel = (a - b).abs().max() / a.abs().max()
    assert rel < 0.02, f"{arch}: decode diverges from full forward ({rel})"
