"""The decode kernels' split path (flash-decoding) on the CPU: the port's
``decode_partials`` / ``merge_partials`` against the reference's
(``repro.kernels.tda.sharded``) on the same numpy inputs; partials over
arbitrary split boundaries of ``[lo, hi)``, merged, against the dense
plain version; and the wrappers' split plan, a pure host function. The
kernels themselves run only on the card (``tests/test_torch_tda.py``,
``-m gpu``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_parity as tp  # noqa: E402

tp.tf32_off()

# f32 partials and merges: the same formulas on both sides, summed in
# another order.
ATOL = 1e-5
B, S, D = 5, 40, 16


def _case(seed, Hq, Hkv, quant, s=S, d=D, rows=B):
    """q, k, v (int8 codes + f32 scales when ``quant``) and per-row
    lengths: an empty lane, one token, a partial and a full lane."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((rows, Hq, d)).astype(np.float32)
    k = rng.standard_normal((rows, s, Hkv, d)).astype(np.float32)
    v = rng.standard_normal((rows, s, Hkv, d)).astype(np.float32)
    ks = vs = None
    if quant:
        ks = rng.uniform(0.005, 0.02, (rows, s, Hkv)).astype(np.float32)
        vs = rng.uniform(0.005, 0.02, (rows, s, Hkv)).astype(np.float32)
        k = rng.integers(-127, 128, k.shape).astype(np.int8)
        v = rng.integers(-127, 128, v.shape).astype(np.int8)
    lengths = np.array([0, 1, 17, s, s - 9], np.int32)
    return q, k, v, ks, vs, lengths


def _opt(a, f):
    return None if a is None else f(a)


def _both_partials(q, k, v, ks, vs, lengths, a, b, window):
    """Partials over keys [a, b) from both packages, as numpy."""
    import jax.numpy as jnp
    from repro.kernels.tda.sharded import decode_partials as jpartials
    from repro_torch.kernels.tda.sharded import decode_partials
    sl = slice(a, b)
    J = lambda x: _opt(x, lambda y: jnp.asarray(y[:, sl]))  # noqa: E731
    T = lambda x: _opt(x, lambda y: tp.t(y[:, sl]))  # noqa: E731
    ref = jpartials(jnp.asarray(q), J(k), J(v), jnp.asarray(lengths),
                    k_scale=J(ks), v_scale=J(vs), window=window,
                    pos_offset=a)
    got = decode_partials(tp.t(q), T(k), T(v), tp.t(lengths), k_scale=T(ks),
                          v_scale=T(vs), window=window, pos_offset=a)
    return [np.asarray(x) for x in ref], [x.numpy() for x in got]


@pytest.mark.parametrize("window", [None, 6])
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("bounds", [(0, 13, 40), (0, 8, 16, 24, 40),
                                    (0, 1, 17, 18, 39, 40)])
def test_partials_and_merge_match_reference(bounds, quant, window):
    """Partials over each split of the key axis (empty ones among them:
    rows of length 0 or 1 and splits past a row's hi) and their merge,
    port against reference, f32 within 1e-5; every empty partial is
    exactly (0, NEG_INF, 0) on both sides; the length-0 row merges to 0."""
    import jax.numpy as jnp
    from repro.kernels.tda.sharded import merge_partials as jmerge
    from repro_torch.kernels.tda.ref import NEG_INF
    from repro_torch.kernels.tda.sharded import merge_partials
    q, k, v, ks, vs, lengths = _case(len(bounds) + quant, 10, 2, quant)
    refs, gots = [], []
    for a, b in zip(bounds[:-1], bounds[1:]):
        ref, got = _both_partials(q, k, v, ks, vs, lengths, a, b, window)
        for r, g in zip(ref, got):
            np.testing.assert_allclose(g, r, atol=ATOL, rtol=0)
        lo = lengths - (window or lengths.max() + 1)
        empty = (lengths <= a) | (np.maximum(lo, 0) >= b)
        for x in got, ref:
            assert not x[0][empty].any() and not x[2][empty].any()
            assert (x[1][empty] == NEG_INF).all()
        refs.append(ref)
        gots.append(got)
    want = np.asarray(jmerge(*(jnp.stack([jnp.asarray(r[i]) for r in refs])
                               for i in range(3))))
    out = merge_partials(*(torch.stack([tp.t(g[i]) for g in gots])
                           for i in range(3))).numpy()
    np.testing.assert_allclose(out, want, atol=ATOL, rtol=0)
    assert np.isfinite(out).all() and not out[0].any()


def test_merge_of_all_empty_partials_is_zero():
    """Every partial empty (a never-attended slot) -> exactly 0, no NaN;
    one live partial among empty ones -> that partial normalized."""
    import jax.numpy as jnp
    from repro.kernels.tda.sharded import merge_partials as jmerge
    from repro_torch.kernels.tda.ref import NEG_INF
    from repro_torch.kernels.tda.sharded import merge_partials
    rng = np.random.default_rng(3)
    R, H = 4, 6
    acc = np.zeros((R, B, H, D), np.float32)
    m = np.full((R, B, H), NEG_INF, np.float32)
    l = np.zeros((R, B, H), np.float32)
    acc[2, 1] = rng.standard_normal((H, D))
    m[2, 1] = rng.standard_normal(H)
    l[2, 1] = rng.uniform(1, 3, H)
    out = merge_partials(tp.t(acc), tp.t(m), tp.t(l)).numpy()
    want = np.asarray(jmerge(jnp.asarray(acc), jnp.asarray(m),
                             jnp.asarray(l)))
    np.testing.assert_allclose(out, want, atol=ATOL, rtol=0)
    assert not np.delete(out, 1, axis=0).any()
    np.testing.assert_allclose(out[1], acc[2, 1] / l[2, 1][:, None],
                               atol=ATOL, rtol=0)


def _split_merge(q, k, v, ks, vs, bounds, edges):
    """The port's partials over the splits ``[edges[i], edges[i+1])`` of
    ``[lo, hi)`` (window ``hi - lo`` per row), merged."""
    from repro_torch.kernels.tda.sharded import decode_partials, merge_partials
    lo, hi = bounds[:, 0].long(), bounds[:, 1].long()
    parts = [decode_partials(q, k[:, a:b], v[:, a:b], hi,
                             k_scale=_opt(ks, lambda x: x[:, a:b]),
                             v_scale=_opt(vs, lambda x: x[:, a:b]),
                             window=hi - lo, pos_offset=a)
             for a, b in zip(edges[:-1], edges[1:])]
    return merge_partials(*(torch.stack([p[i] for p in parts])
                            for i in range(3)))


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("G", [1, 2, 5, 8])
def test_split_merge_matches_decode_reference(G, quant):
    """Partials over split boundaries that fall inside ``[lo, hi)``, on
    ``hi`` and ``lo`` exactly, windows (``lo > 0``) crossing a split, and
    splits from the wrappers' plan, merged, against the dense plain
    version over ``[lo, hi)``; rows with ``hi <= lo`` give zeros."""
    from repro_torch.kernels.tda.ref import decode_attention_reference
    from repro_torch.kernels.tda.tda import decode_split_plan
    Hkv = 2
    # [lo, hi): empty lane, hi <= lo, a window across a split edge, hi on
    # a split edge, lo on one, one token, the whole lane
    bounds = np.array([(0, 0), (30, 20), (13, 37), (8, 32), (16, 50),
                       (40, 41), (0, 72)], np.int32)
    q, k, v, ks, vs, _ = _case(G + 7 * quant, G * Hkv, Hkv, quant, s=72,
                               rows=len(bounds))
    T = lambda x: _opt(x, tp.t)  # noqa: E731
    tq, tk, tv, tks, tvs, tb = (T(x) for x in (q, k, v, ks, vs, bounds))
    hi, lo = tb[:, 1:].long(), tb[:, :1].long()
    want = decode_attention_reference(tq, tk, tv, hi, k_scale=tks,
                                      v_scale=tvs, window=hi - lo)
    want = torch.where((hi > lo)[:, :, None], want, 0.0)
    L = decode_split_plan(72, 8)
    for edges in ((0, 8, 16, 32, 72), (0, 37, 72), (0, 1, 13, 14, 50, 72),
                  tuple(range(0, 72, L)) + (72,)):
        out = _split_merge(tq, tk, tv, tks, tvs, tb, edges)
        np.testing.assert_allclose(out.numpy(), want.numpy(), atol=ATOL,
                                   rtol=0)
        dead = (tb[:, 1] <= tb[:, 0]).numpy()
        assert not out.numpy()[dead].any()


@pytest.mark.parametrize("page_size", [None, 1, 8, 16, 96, 100, 128, 256])
@pytest.mark.parametrize("width", [1, 37, 64, 544, 640, 5000, 40000])
def test_split_plan_covers_each_position_once(width, page_size):
    """The plan's splits ``[i L, (i + 1) L)`` cover ``[0, width)`` once
    each, there are at most MAX_SPLITS of them, on paged lanes ``L``
    divides the page or is a whole number of pages, and with a LUT table
    there is one split."""
    from repro_torch.kernels.tda import tda
    L = tda.decode_split_plan(width, page_size)
    n = -(-width // L)
    hits = np.zeros(width, np.int64)
    for i in range(n):
        hits[i * L:min((i + 1) * L, width)] += 1
    assert (hits == 1).all()
    assert n <= tda.MAX_SPLITS and L >= tda.SPLIT_BASE
    if page_size is not None:
        assert page_size % L == 0 or L % page_size == 0
    assert tda.decode_split_plan(width, page_size, lut=True) >= width


def test_split_plan_fills_the_card_at_the_served_shape():
    """The served decode shape (8 slots, 8 kv heads, 128-token pages over
    5-page lanes, about 2 630 live tokens) gives half-page splits and at
    least two waves of 132 live blocks; a contiguous 544-token lane 64-
    position splits."""
    from repro_torch.kernels.tda.tda import decode_split_plan
    L = decode_split_plan(5 * 128, 128)
    assert L == 64 and decode_split_plan(544) == 64
    lengths = np.random.default_rng(1).integers(33, 544, size=8)
    live = sum(-(-int(n) // L) for n in lengths) * 8
    assert lengths.sum() > 2000 and live >= 2 * 132
