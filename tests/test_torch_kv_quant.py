"""The int8 KV codec (``layers.kv_quantize`` / ``kv_dequantize``): codes
and scales bit-equal to the reference's, exact .5 ties (round half to
even) and all-zero rows included."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_parity as tp  # noqa: E402


def _cases():
    rng = np.random.default_rng(0)
    yield rng.standard_normal((3, 7, 2, 16)).astype(np.float32)
    yield (rng.standard_normal((2, 5, 4, 128)) * 30).astype(np.float32)
    # amax 127: 127 + 1e-6 rounds to 127 in f32, so the scale is exactly 1
    # and t / scale lands on k + 0.5 for these entries (ties)
    ties = np.zeros((4, 2, 8), np.float32)
    ties[..., 0] = 127.0
    ties[..., 1:] = np.array([0.5, 1.5, 2.5, -0.5, -1.5, 3.5, 126.5],
                             np.float32)
    yield ties
    z = rng.standard_normal((2, 3, 2, 8)).astype(np.float32)
    z[0, 1] = 0.0  # all-zero rows: scale 1e-6 / 127, codes 0
    yield z
    yield rng.standard_normal((2, 3, 2, 8)).astype(np.float32) * 1e-9


@pytest.mark.parametrize("case", range(5))
def test_kv_quantize_matches_reference(case):
    import jax.numpy as jnp
    from repro.models.layers import kv_dequantize as jdeq
    from repro.models.layers import kv_quantize as jq
    from repro_torch.models.layers import kv_dequantize, kv_quantize
    x = list(_cases())[case]
    jc, js = (np.asarray(a) for a in jq(jnp.asarray(x)))
    tc, ts = kv_quantize(tp.t(x))
    assert tc.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tc.numpy(), jc)
    np.testing.assert_array_equal(ts.numpy(), js)
    np.testing.assert_array_equal(
        kv_dequantize(tc, ts).numpy(),
        np.asarray(jdeq(jnp.asarray(jc), jnp.asarray(js))))
    if case == 2:  # the ties rounded half to even
        assert tc[0, 0, 1:].tolist() == [0, 2, 2, 0, -2, 4, 126]
    assert int(tc.abs().max()) <= 127


@pytest.mark.parametrize("heads", [(4, 2), (10, 2)])
def test_dense_decode_attention_with_scales_matches_reference(heads):
    """The dense ``decode_attention`` over int8 lanes with ``k_scale`` /
    ``v_scale`` (dequantized in f32 first), per-row depths including an
    empty row."""
    import jax.numpy as jnp
    from repro.models.layers import decode_attention as jdec
    from repro_torch.models.layers import decode_attention, kv_quantize
    Hq, Hkv = heads
    rng = np.random.default_rng(Hq)
    B, S, D = 4, 13, 16
    q = rng.standard_normal((B, 1, Hq, D)).astype(np.float32)
    k, ks = kv_quantize(tp.t(rng.standard_normal((B, S, Hkv, D))
                             .astype(np.float32)))
    v, vs = kv_quantize(tp.t(rng.standard_normal((B, S, Hkv, D))
                             .astype(np.float32)))
    idx = np.array([0, 1, 7, S], np.int32)
    want = np.asarray(jdec(jnp.asarray(q), jnp.asarray(k.numpy()),
                           jnp.asarray(v.numpy()), jnp.asarray(idx),
                           k_scale=jnp.asarray(ks.numpy()),
                           v_scale=jnp.asarray(vs.numpy())))
    got = decode_attention(tp.t(q), k, v, tp.t(idx), k_scale=ks,
                           v_scale=vs).numpy()
    np.testing.assert_allclose(got, want, atol=tp.ATOL_ATTN, rtol=0)
