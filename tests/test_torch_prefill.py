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
