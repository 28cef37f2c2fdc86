"""The phase-serialized engine's model pieces: the plain flash (prefill)
attention against the reference's on packed segment ids, causal and
windowed; ``Model.prefill`` / ``Model.apply`` logits and caches, fp and
int8, on packed rows; and the contiguous-lane ``decode_step`` (fp and int8,
dense and TDA), each against the reference at float32."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_parity as tp  # noqa: E402

tp.tf32_off()


def _segments(rng, B, S):
    """Packed rows: runs of segment ids 1, 2, ... then 0 padding; one row
    all padding."""
    seg = np.zeros((B, S), np.int32)
    for b in range(B - 1):
        pos, sid = 0, 1
        while pos < S - 2:
            n = int(rng.integers(1, S // 2))
            seg[b, pos:pos + n] = sid
            pos += n
            sid += 1
    return seg


# A window only with causal masking: the reference's windowed scan visits
# the kv chunks behind each query chunk only.
@pytest.mark.parametrize("causal,window", [(True, None), (True, 3),
                                           (False, None)])
@pytest.mark.parametrize("heads", [(4, 2), (10, 2)])
def test_flash_attention_matches_reference(heads, causal, window):
    import jax.numpy as jnp
    from repro.models.layers import flash_attention as jflash
    from repro_torch.models.layers import flash_attention
    Hq, Hkv = heads
    rng = np.random.default_rng(Hq + int(causal))
    B, S, D = 3, 24, 16
    q = rng.standard_normal((B, S, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    seg = _segments(rng, B, S)
    for chunk in (8, 512):  # the reference's chunk; the port's query block
        want = np.asarray(jflash(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=causal,
                                 window=window, chunk=chunk,
                                 seg_q=jnp.asarray(seg),
                                 seg_kv=jnp.asarray(seg)))
        got = flash_attention(tp.t(q), tp.t(k), tp.t(v), causal=causal,
                              window=window, seg_q=tp.t(seg),
                              seg_kv=tp.t(seg), chunk=chunk).numpy()
        live = seg > 0  # padding queries see no key: not compared
        np.testing.assert_allclose(got[live], want[live],
                                   atol=tp.ATOL_ATTN, rtol=0)
    # no segment ids: every position is one sequence
    want = np.asarray(jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=causal, window=window))
    got = flash_attention(tp.t(q), tp.t(k), tp.t(v), causal=causal,
                          window=window).numpy()
    np.testing.assert_allclose(got, want, atol=tp.ATOL_ATTN, rtol=0)


@pytest.fixture(scope="module")
def qwen():
    cfg, m, params = tp.jax_qwen_smoke()
    tm, tparams = tp.torch_qwen_smoke(params)
    return cfg, m, params, tm, tparams


def _models(qwen, kv_quant):
    cfg, m, params, tm, tparams = qwen
    if kv_quant:
        m = type(m)(dataclasses.replace(m.cfg, kv_quant=True))
        tm = type(tm)(dataclasses.replace(tm.cfg, kv_quant=True),
                      device="cpu")
    return m, params, tm, tparams


def _packed_batch(vocab):
    """Two packed 16-token rows (segments of 5+3+2 and 12 tokens, then
    padding) and one padding row, as the engine's power-of-two padding
    leaves them."""
    from repro_torch.core.packing import PackingPolicy, pack_requests
    pk = pack_requests(tp.prompts(vocab, [5, 12, 3, 2]),
                       PackingPolicy(max_len=16))
    pad = ((0, 1), (0, 0))
    return {"inputs": np.pad(pk.tokens, pad),
            "positions": np.pad(pk.positions, pad),
            "seg_ids": np.pad(pk.segment_ids, pad)}


def _assert_caches(got, want, live):
    """Caches at the written (live) positions: int8 codes equal, fp
    leaves and scales within the pool tolerance."""
    for name, w in want.items():
        g = got[name].numpy()
        w = np.asarray(w)
        g, w = g[:, live], w[:, live]
        assert g.dtype == w.dtype, name
        if w.dtype == np.int8:
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, atol=tp.ATOL_POOL, rtol=1e-6,
                                       err_msg=name)


@pytest.mark.parametrize("kv_quant", [False, True])
def test_prefill_and_apply_match_reference(qwen, kv_quant):
    """``Model.apply`` over packed rows (all-position logits at the live
    positions, and the caches the engine copies lanes from), and
    ``Model.prefill``'s last-position logits and caches."""
    import jax.numpy as jnp
    m, params, tm, tparams = _models(qwen, kv_quant)
    batch = _packed_batch(m.cfg.vocab_size)
    live = batch["seg_ids"] > 0
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: tp.t(v) for k, v in batch.items()}
    rows, width = batch["inputs"].shape
    jl, jc, _ = m.apply(params, jb, caches=m.init_cache(rows, width,
                                                        ring=False),
                        cache_index=jnp.int32(0))
    tl, tc = tm.apply(tparams, tb, caches=tm.init_cache(rows, width))
    np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live],
                               atol=tp.ATOL_LOGITS, rtol=0)
    assert set(tc) == set(jc)
    _assert_caches(tc, jc, live)
    # prefill: one unpacked sequence, caches wider than the prompt
    toks = {"inputs": tp.prompts(m.cfg.vocab_size, [11, 11], seed=4)}
    toks["inputs"] = np.stack(toks["inputs"])
    jl, jc = m.prefill(params, {"inputs": jnp.asarray(toks["inputs"])},
                       max_len=20)
    tl, tc = tm.prefill(tparams, {"inputs": tp.t(toks["inputs"])},
                        max_len=20)
    assert tl.shape == (2, 1, m.cfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                               atol=tp.ATOL_LOGITS, rtol=0)
    live = np.arange(20)[None, :].repeat(2, 0) < 11
    _assert_caches(tc, jc, live)
    for name in tc:  # positions past the prompt stay zero
        assert not tc[name][:, :, 11:].any()


@pytest.mark.parametrize("decode_attn", ["dense", "tda"])
@pytest.mark.parametrize("kv_quant", [False, True])
def test_contiguous_decode_step_matches_reference(qwen, kv_quant,
                                                  decode_attn):
    """Two decode steps over contiguous lanes filled by the reference's
    prefill: per-row depths, one row masked off (its lane untouched), int8
    lanes written as codes and scales; logits and caches."""
    import jax.numpy as jnp
    m, params, tm, tparams = _models(qwen, kv_quant)
    jm = m.with_decode_attn(decode_attn, 16) if decode_attn == "tda" else m
    tmm = tm.with_decode_attn(decode_attn, 16)
    B, W = 3, 24
    prompts = np.stack(tp.prompts(m.cfg.vocab_size, [W] * B, seed=2))
    _, jc = m.prefill(params, {"inputs": jnp.asarray(prompts[:, :12])},
                      max_len=W)
    tc = {k: tp.t(np.asarray(v)) for k, v in jc.items()}
    ci = np.array([12, 7, 12], np.int32)
    mask = np.array([True, True, False])
    for step in range(2):
        toks = prompts[np.arange(B), ci][:, None]
        jl, jc = jm.decode_step(params, {"inputs": jnp.asarray(toks)}, jc,
                                jnp.asarray(ci),
                                slot_mask=jnp.asarray(mask))
        tl, tc = tmm.decode_step(tparams, {"inputs": tp.t(toks)}, tc,
                                 tp.t(ci), slot_mask=tp.t(mask))
        np.testing.assert_allclose(tl.numpy()[mask], np.asarray(jl)[mask],
                                   atol=tp.ATOL_LOGITS, rtol=0)
        live = np.arange(W)[None, :] <= ci[:, None]
        _assert_caches(tc, jc, live & mask[:, None])
        ci = ci + mask
    for name in tc:  # the masked row's lane is the prefill's, untouched
        np.testing.assert_array_equal(tc[name][:, 2, 12:].numpy(), 0)


# ---- the flash prefill's probability-block dtype and causal wedge -----------

# bf16 probability blocks: the port runs the reference's online softmax
# step for step and rounds the same f32 probabilities to bf16. XLA's exp
# and torch's differ by one ulp on ~10% of entries, which now and then
# moves a probability across a bf16 rounding edge: that entry's weight
# moves by one bf16 step (2^-7 of it), and the output element by at most
# 2^-7 of the largest |v|. Such flips are rare (a few output rows in
# 10^4), and every other element stays within ATOL_ATTN.
BF16_STEP = 2.0 ** -7
FLIP_SHARE = 0.01
# Model logits at float32 compute with bf16 blocks (qwen2.5 smoke, 2
# layers, 2 x 64 tokens): a flip in layer 0 reaches later positions through
# layer 1. Measured 4.0e-4 against logits up to 4.09; the same config
# before the fix (blocks left f32) differed by 1.0e-2, the size of the
# bf16 blocks' own effect.
ATOL_BF16_BLOCK_LOGITS = 1e-3


@pytest.mark.parametrize("causal,window,skv", [(True, None, 24),
                                               (True, 3, 24),
                                               (False, None, 24),
                                               (False, None, 40)])
def test_flash_block_dtype_matches_reference(causal, window, skv):
    """``flash_attention(block_dtype=bfloat16)`` against the reference's,
    packed segments (padding rows included, their online-softmax value),
    causal, windowed, bidirectional and cross-attention shaped (Skv 40 >
    Sq 24), chunks of 8 over f32 inputs: every element within ATOL_ATTN
    but at most FLIP_SHARE of them, those within a bf16 step of max |v|."""
    import jax.numpy as jnp
    from repro.models.layers import flash_attention as jflash
    from repro_torch.models.layers import flash_attention
    rng = np.random.default_rng(7 + skv + int(causal))
    B, S, Hq, Hkv, D = 3, 24, 4, 2, 16
    q = rng.standard_normal((B, S, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, skv, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, skv, Hkv, D)).astype(np.float32)
    seg = _segments(rng, B, S)
    seg_kv = seg if skv == S else _segments(rng, B, skv)
    if skv != S:
        seg = np.where(seg > 0, 1, 0).astype(np.int32)
        seg_kv = np.where(seg_kv > 0, 1, 0).astype(np.int32)
    want = np.asarray(jflash(*map(jnp.asarray, (q, k, v)), causal=causal,
                             window=window, chunk=8,
                             seg_q=jnp.asarray(seg),
                             seg_kv=jnp.asarray(seg_kv),
                             block_dtype=jnp.bfloat16))
    got = flash_attention(*map(tp.t, (q, k, v)), causal=causal,
                          window=window, seg_q=tp.t(seg),
                          seg_kv=tp.t(seg_kv), chunk=8,
                          block_dtype=torch.bfloat16).numpy()
    err = np.abs(got - want)
    assert (err > tp.ATOL_ATTN).mean() <= FLIP_SHARE
    assert err.max() <= tp.ATOL_ATTN + BF16_STEP * np.abs(v).max()


def test_flash_block_dtype_model_matches_reference(qwen):
    """``Model.apply`` with ``flash_block_dtype="bfloat16"`` at float32
    compute against the reference's (the config's field reaches every
    prefill attention), within ATOL_BF16_BLOCK_LOGITS."""
    import jax.numpy as jnp
    cfg, m, params, tm, tparams = qwen
    jm = type(m)(dataclasses.replace(m.cfg, flash_block_dtype="bfloat16"))
    tmm = type(tm)(dataclasses.replace(tm.cfg,
                                       flash_block_dtype="bfloat16"),
                   device="cpu")
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 64))
    toks = toks.astype(np.int32)
    want = np.asarray(jm.apply(params, {"inputs": jnp.asarray(toks)})[0])
    got = tmm.apply(tparams, {"inputs": tp.t(toks)})[0].numpy()
    np.testing.assert_allclose(got, want, atol=ATOL_BF16_BLOCK_LOGITS,
                               rtol=0)


@pytest.mark.parametrize("S,chunk", [(32, 4), (64, 8), (64, 16), (48, 8)])
@pytest.mark.parametrize("Hq,Hkv", [(4, 2), (4, 4)])
def test_causal_wedge_matches_masked(S, chunk, Hq, Hkv):
    """``flash_attention(wedge=True)`` against the masked path within
    ``tests/test_wedge.py``'s bound (rtol 1e-5, atol 1e-6); with bf16
    blocks (the reference's task order and merges) against the
    reference's wedge, flips aside as above, at GQA 4 / 2 (the f32 wedge
    meets the reference's in the test below)."""
    import jax.numpy as jnp
    from repro.models.layers import flash_attention as jflash
    from repro_torch.models.layers import flash_attention
    rng = np.random.default_rng(0)
    B, D = 2, 8
    q, k, v = (rng.standard_normal((B, S, h, D)).astype(np.float32)
               for h in (Hq, Hkv, Hkv))
    a = flash_attention(*map(tp.t, (q, k, v)), chunk=chunk).numpy()
    b = flash_attention(*map(tp.t, (q, k, v)), chunk=chunk,
                        wedge=True).numpy()
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    if Hkv != 2:
        return
    want = np.asarray(jflash(*map(jnp.asarray, (q, k, v)), chunk=chunk,
                             wedge=True, block_dtype=jnp.bfloat16))
    got = flash_attention(*map(tp.t, (q, k, v)), chunk=chunk, wedge=True,
                          block_dtype=torch.bfloat16).numpy()
    err = np.abs(got - want)
    assert (err > tp.ATOL_ATTN).mean() <= FLIP_SHARE
    assert err.max() <= tp.ATOL_ATTN + BF16_STEP * np.abs(v).max()


def test_causal_wedge_segments_grads_and_work():
    """The wedge with packed segments and trailing padding (whose rows
    take the reference's wedge value): loss within 1e-5 relative and
    query gradients within rtol 1e-4 / atol 1e-5 of the masked path
    (``tests/test_wedge.py``'s bounds), outputs within ATOL_ATTN of the
    reference's wedge on every row, padding included; and the work: at S
    1024 in chunks of 128 the wedge's products take at most 0.72 of the
    masked path's FLOPs (the reference test's bound; the causal cut
    visits 36 of 64 blocks)."""
    import jax.numpy as jnp
    from torch.utils.flop_counter import FlopCounterMode
    from repro.models.layers import flash_attention as jflash
    from repro_torch.models.layers import flash_attention
    rng = np.random.default_rng(1)
    B, S, H, D = 2, 64, 2, 8
    q, k, v = (rng.standard_normal((B, S, H, D)).astype(np.float32)
               for _ in range(3))
    seg = np.concatenate([np.ones((B, 30)), 2 * np.ones((B, 26)),
                          np.zeros((B, 8))], axis=1).astype(np.int32)

    def loss(wedge):
        qt = tp.t(q).requires_grad_(True)
        out = flash_attention(qt, tp.t(k), tp.t(v), chunk=8, seg_q=tp.t(seg),
                              seg_kv=tp.t(seg), wedge=wedge)
        val = (out ** 2).sum()
        return float(val.detach()), torch.autograd.grad(val, qt)[0].numpy(), out

    v1, g1, _ = loss(False)
    v2, g2, out = loss(True)
    assert abs(v1 - v2) / abs(v1) < 1e-5
    np.testing.assert_allclose(g1, g2, rtol=1e-4, atol=1e-5)
    want = np.asarray(jflash(*map(jnp.asarray, (q, k, v)), chunk=8,
                             seg_q=jnp.asarray(seg), seg_kv=jnp.asarray(seg),
                             wedge=True))
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=0,
                               atol=tp.ATOL_ATTN)
    x = torch.zeros((1, 1024, 2, 32))
    flops = {}
    for wedge in (False, True):
        with FlopCounterMode(display=False) as fc:
            flash_attention(x, x, x, chunk=128, wedge=wedge)
        flops[wedge] = fc.get_total_flops()
    assert flops[True] <= 0.72 * flops[False], flops


def test_causal_wedge_model_logits(qwen):
    """``causal_wedge=True`` in the config: ``Model.apply`` logits within
    5e-3 of the masked model's largest (``tests/test_wedge.py``'s model
    bound) and within ATOL_LOGITS of the reference's wedged model."""
    import jax.numpy as jnp
    cfg, m, params, tm, tparams = qwen
    tmw = type(tm)(dataclasses.replace(tm.cfg, causal_wedge=True),
                   device="cpu")
    jmw = type(m)(dataclasses.replace(m.cfg, causal_wedge=True))
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 64))
    toks = toks.astype(np.int32)
    base = tm.apply(tparams, {"inputs": tp.t(toks)})[0].numpy()
    got = tmw.apply(tparams, {"inputs": tp.t(toks)})[0].numpy()
    assert np.abs(base - got).max() / np.abs(base).max() < 5e-3
    want = np.asarray(jmw.apply(params, {"inputs": jnp.asarray(toks)})[0])
    np.testing.assert_allclose(got, want, atol=tp.ATOL_LOGITS, rtol=0)
