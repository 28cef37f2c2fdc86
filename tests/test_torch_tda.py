"""TDA attention parity: the port's decode attention over contiguous and
paged lanes (fp and int8) and its mixed-step attention (kernel wrappers on
CPU tensors run their plain versions) against the reference's Pallas
kernels in interpret mode and its jnp oracle; plus, on a CUDA device only,
each hand-written kernel against its plain version."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_parity as tp  # noqa: E402

tp.tf32_off()

HEADS = [(4, 2), (10, 2)]  # (Hq, Hkv): G = 2 and G = 5 (not a power of 2)
D = 16


def _decode_case(seed, Hq, Hkv, ps, window):
    rng = np.random.default_rng(seed)
    n = 4
    W = n * ps
    B = 6
    k, v, bt, P = tp.paged_pool(rng, B=B, Hkv=Hkv, D=D, ps=ps, n=n)
    # hi: an empty lane, one token, a partial page, a full lane (its row
    # holds no FREE entry), two pages, and a lane cut short by a FREE tail.
    lengths = np.array([0, 1, ps + 3, W, 2 * ps, 3 * ps - 1], np.int32)
    lo = np.zeros_like(lengths) if window is None \
        else np.maximum(lengths - window, 0)
    bounds = np.stack([lo, lengths], 1).astype(np.int32)
    bounds[4] = [ps + 2, ps]  # hi <= lo: never attended
    q = rng.standard_normal((B, Hq, D)).astype(np.float32)
    return q, k, v, bounds, bt, lengths


@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("ps", [8, 16])
@pytest.mark.parametrize("heads", HEADS)
def test_paged_decode_matches_reference(heads, ps, window):
    import jax.numpy as jnp
    from repro.kernels.tda.ops import fused_decode_attention as jfused
    from repro.kernels.tda.tda import tda_paged_decode_attention as jkernel
    from repro_torch.kernels.tda.ops import fused_decode_attention
    from repro_torch.kernels.tda.tda import tda_paged_decode_attention
    Hq, Hkv = heads
    q, k, v, bounds, bt, lengths = _decode_case(ps + Hq, Hq, Hkv, ps, window)
    ref = np.asarray(jkernel(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray(bounds), jnp.asarray(bt),
                             interpret=True))
    got = tda_paged_decode_attention(tp.t(q), tp.t(k), tp.t(v),
                                     tp.t(bounds), tp.t(bt)).numpy()
    np.testing.assert_allclose(got, ref, atol=tp.ATOL_ATTN, rtol=0)
    assert not got[0].any() and not got[4].any()  # hi <= lo: exact zeros
    for use_kernel in (False, True):
        jref = np.asarray(jfused(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), jnp.asarray(lengths),
                                 block_table=jnp.asarray(bt), window=window,
                                 use_kernel=False))
        out = fused_decode_attention(tp.t(q), tp.t(k), tp.t(v),
                                     tp.t(lengths), block_table=tp.t(bt),
                                     window=window, use_kernel=use_kernel)
        np.testing.assert_allclose(out.numpy(), jref, atol=tp.ATOL_ATTN,
                                   rtol=0)


def _quantized(rng, shape):
    """int8 codes and f32 scales of random K/V (the codec's own output)."""
    from repro_torch.models.layers import kv_quantize
    codes, scale = kv_quantize(
        tp.t(rng.standard_normal(shape).astype(np.float32)))
    return codes.numpy(), scale.numpy()


def _contig_case(seed, Hq, Hkv, S, window, quant):
    """Contiguous lanes of a ragged width S: an empty lane, one token, a
    partial lane, a full lane, a hi <= lo row and, without a window, a
    length past S (clamped to the lane; with a window the reference's
    kernel and oracle disagree there). Returns (q, k, v, k_scale, v_scale,
    bounds, lengths)."""
    rng = np.random.default_rng(seed)
    B = 6
    lengths = np.array([0, 1, S // 2 + 3, S, 7,
                        S + 5 if window is None else S - 2], np.int32)
    lo = np.zeros_like(lengths) if window is None \
        else np.maximum(np.minimum(lengths, S) - window, 0)
    bounds = np.stack([lo, np.minimum(lengths, S)], 1).astype(np.int32)
    bounds[4] = [9, 7]  # hi <= lo: never attended
    q = rng.standard_normal((B, Hq, D)).astype(np.float32)
    if quant:
        k, ks = _quantized(rng, (B, S, Hkv, D))
        v, vs = _quantized(rng, (B, S, Hkv, D))
    else:
        k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
        v = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
        ks = vs = None
    return q, k, v, ks, vs, bounds, lengths


def _opt(a, f):
    return None if a is None else f(a)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("S", [37, 48])
@pytest.mark.parametrize("heads", HEADS)
def test_contiguous_decode_matches_reference(heads, S, window, quant):
    """``tda_decode_attention`` and the contiguous ``fused_decode_attention``
    at a lane width that is no multiple of the block (the port passes the
    lane as it is; the reference pads it), fp and int8."""
    import jax.numpy as jnp
    from repro.kernels.tda.ops import fused_decode_attention as jfused
    from repro.kernels.tda.tda import tda_decode_attention as jkernel
    from repro_torch.kernels.tda.ops import fused_decode_attention
    from repro_torch.kernels.tda.tda import tda_decode_attention
    Hq, Hkv = heads
    q, k, v, ks, vs, bounds, lengths = _contig_case(S + Hq, Hq, Hkv, S,
                                                    window, quant)
    J = lambda a: _opt(a, jnp.asarray)  # noqa: E731
    Sp = -(-S // 16) * 16
    pad = lambda a: _opt(a, lambda x: jnp.asarray(np.pad(  # noqa: E731
        x, [(0, 0), (0, Sp - S)] + [(0, 0)] * (x.ndim - 2))))
    ref = np.asarray(jkernel(J(q), pad(k), pad(v), J(bounds), pad(ks),
                             pad(vs), block_k=16, interpret=True))
    got = tda_decode_attention(tp.t(q), tp.t(k), tp.t(v), tp.t(bounds),
                               _opt(ks, tp.t), _opt(vs, tp.t)).numpy()
    np.testing.assert_allclose(got, ref, atol=tp.ATOL_ATTN, rtol=0)
    assert not got[0].any() and not got[4].any()  # hi <= lo: exact zeros
    jref = np.asarray(jfused(J(q), J(k), J(v), J(lengths), k_scale=J(ks),
                             v_scale=J(vs), window=window, use_kernel=False))
    for use_kernel in (False, True):
        out = fused_decode_attention(
            tp.t(q)[:, None], tp.t(k), tp.t(v), tp.t(lengths),
            k_scale=_opt(ks, tp.t), v_scale=_opt(vs, tp.t), window=window,
            use_kernel=use_kernel)
        assert out.shape == (q.shape[0], 1, Hq, D)
        np.testing.assert_allclose(out[:, 0].numpy(), jref,
                                   atol=tp.ATOL_ATTN, rtol=0)


@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("heads", HEADS)
def test_paged_decode_int8_matches_reference(heads, window):
    """int8 page pools with scale pools read through the same block table
    (FREE tail entries included)."""
    import jax.numpy as jnp
    from repro.kernels.tda.ops import fused_decode_attention as jfused
    from repro.kernels.tda.tda import tda_paged_decode_attention as jkernel
    from repro_torch.kernels.tda.ops import fused_decode_attention
    from repro_torch.kernels.tda.tda import tda_paged_decode_attention
    Hq, Hkv = heads
    ps = 8
    q, kf, _, bounds, bt, lengths = _decode_case(Hq + 3, Hq, Hkv, ps, window)
    rng = np.random.default_rng(Hq)
    k, ks = _quantized(rng, kf.shape)
    v, vs = _quantized(rng, kf.shape)
    J = [jnp.asarray(a) for a in (q, k, v, bounds, bt, ks, vs)]
    T = [tp.t(a) for a in (q, k, v, bounds, bt, ks, vs)]
    ref = np.asarray(jkernel(*J, interpret=True))
    got = tda_paged_decode_attention(*T).numpy()
    np.testing.assert_allclose(got, ref, atol=tp.ATOL_ATTN, rtol=0)
    assert not got[0].any() and not got[4].any()
    jref = np.asarray(jfused(J[0], J[1], J[2], jnp.asarray(lengths),
                             k_scale=J[5], v_scale=J[6], block_table=J[4],
                             window=window, use_kernel=False))
    for use_kernel in (False, True):
        out = fused_decode_attention(T[0], T[1], T[2], tp.t(lengths),
                                     k_scale=T[5], v_scale=T[6],
                                     block_table=T[4], window=window,
                                     use_kernel=use_kernel)
        np.testing.assert_allclose(out.numpy(), jref, atol=tp.ATOL_ATTN,
                                   rtol=0)


def _mixed_case(seed, Hq, Hkv, ps, ring_short):
    rng = np.random.default_rng(seed)
    n, S, B = 3, 8, 7
    W = n * ps
    ring = W - ps + 3 if ring_short else W
    k, v, bt, P = tp.paged_pool(rng, B=B, Hkv=Hkv, D=D, ps=ps, n=n,
                                free_tail=False)
    # (ci, n_new): dead row, fresh prompt (ci = 0), decode row, inert row
    # (n_new = 0 with a resident lane), mid-prompt chunk, full chunk at a
    # page edge, and a lane past its ring width (wraps when ring < W).
    rows = [(0, 0), (0, 5), (7, 1), (9, 0), (ps + 2, 6), (ps, S),
            (ring + 4, 3)]
    bounds = np.array(rows, np.int32)
    bt[0, 1:] = P  # FREE tail entries on a lane that holds nothing
    q = rng.standard_normal((B, S, Hq, D)).astype(np.float32)
    kr = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    vr = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    return q, k, v, kr, vr, bounds, bt, ring


@pytest.mark.parametrize("window", [None, 6])
@pytest.mark.parametrize("ring_short", [False, True])
@pytest.mark.parametrize("ps", [8, 16])
@pytest.mark.parametrize("heads", HEADS)
def test_mixed_matches_reference(heads, ps, ring_short, window):
    import jax.numpy as jnp
    from repro.kernels.tda.ops import fused_mixed_attention as jfused
    from repro.kernels.tda.tda import tda_mixed_attention as jkernel
    from repro_torch.kernels.tda.ops import fused_mixed_attention
    from repro_torch.kernels.tda.tda import tda_mixed_attention
    Hq, Hkv = heads
    q, k, v, kr, vr, bounds, bt, ring = _mixed_case(ps + Hq, Hq, Hkv, ps,
                                                    ring_short)
    J = [jnp.asarray(a) for a in (q, k, v, kr, vr, bounds, bt)]
    T = [tp.t(a) for a in (q, k, v, kr, vr, bounds, bt)]
    ref = np.asarray(jkernel(*J, ring=ring, window=window, interpret=True))
    got = tda_mixed_attention(*T, ring=ring, window=window).numpy()
    live = np.arange(q.shape[1])[None, :] < bounds[:, 1:2]  # (B, S)
    np.testing.assert_allclose(got[live], ref[live], atol=tp.ATOL_ATTN,
                               rtol=0)
    assert not got[0].any()  # ci = 0 and n_new = 0: no key, exact zeros
    ci, nn = bounds[:, 0], bounds[:, 1]
    jref = np.asarray(jfused(*J[:5], jnp.asarray(ci), jnp.asarray(nn),
                             block_table=J[6], ring=ring, window=window,
                             use_kernel=False))
    out = fused_mixed_attention(*T[:5], tp.t(ci), tp.t(nn),
                                block_table=T[6], ring=ring, window=window,
                                use_kernel=False).numpy()
    np.testing.assert_allclose(out, jref, atol=tp.ATOL_ATTN, rtol=0)
    kern = fused_mixed_attention(*T[:5], tp.t(ci), tp.t(nn),
                                 block_table=T[6], ring=ring, window=window,
                                 use_kernel=True).numpy()
    np.testing.assert_allclose(kern[live], jref[live], atol=tp.ATOL_ATTN,
                               rtol=0)


def test_paged_addressing_and_block_stats_match_reference():
    import jax.numpy as jnp
    from repro.kernels.tda import ops as jops
    from repro.kernels.tda.ref import block_stats as jstats
    from repro_torch.kernels.tda import ops
    from repro_torch.kernels.tda.ref import block_stats
    rng = np.random.default_rng(5)
    k, _, bt, P = tp.paged_pool(rng, B=4, Hkv=2, D=D, ps=8, n=3)
    np.testing.assert_array_equal(
        ops.paged_flat_positions(tp.t(bt), 8).numpy(),
        np.asarray(jops.paged_flat_positions(jnp.asarray(bt), 8)))
    np.testing.assert_array_equal(
        ops.gather_paged_lanes(tp.t(k), tp.t(bt)).numpy(),
        np.asarray(jops.gather_paged_lanes(jnp.asarray(k), jnp.asarray(bt))))
    for lens, window in (([0, 5, 17, 40], None), ([3, 33, 64, 9], 10)):
        assert block_stats(lens, 48, 16, window=window) == \
            jstats(lens, 48, 16, window=window)


def test_wrappers_refuse_bad_inputs_on_cuda_only_path():
    """The CPU path never launches and never counts; bad dtypes on the
    kernel path raise before any launch."""
    from repro_torch.kernels.tda import tda
    q, k, v, bounds, bt, _ = _decode_case(0, 4, 2, 8, None)
    tda.reset_launch_counts()
    tda.tda_paged_decode_attention(tp.t(q), tp.t(k), tp.t(v), tp.t(bounds),
                                   tp.t(bt))
    assert tda.LAUNCHES == {"tda_decode_attention": 0,
                            "tda_paged_decode_attention": 0,
                            "tda_mixed_attention": 0}
    with pytest.raises(TypeError):
        tda._check("x", (tp.t(q),), (tp.t(q), tp.t(k, dtype=torch.float64)),
                   ())
    with pytest.raises(ValueError):
        tda._heads("x", 40, 6, 128)  # Hq no multiple of Hkv
    with pytest.raises(ValueError):
        tda._heads("x", 48, 4, 264)  # head dim past MAX_HEAD_DIM (256)
    with pytest.raises(ValueError):  # the mixed kernel stops at 128
        tda._heads("x", 10, 1, 256, tda.MAX_MIXED_HEAD_DIM)
    tda._heads("x", 10, 1, 256)  # recurrentgemma's local layers: decode
    tda._heads("x", 48, 4, 128)  # G = 12: the decode kernels tile groups
    assert [tda.group_tiles(g * 4, 4) for g in (1, 5, 8, 10, 12, 16, 17)] \
        == [1, 1, 1, 2, 2, 2, 3]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernels_match_plain_versions(dtype):
    """Each hand-written CUDA kernel against its plain version, the
    ``ref.py`` oracle over gathered lanes, on the same inputs on the card:
    max abs diff 1e-3 on the f32 outputs of attended rows and live columns
    from identical inputs. The kernels write exact zeros where nothing is
    attended (decode ``hi <= lo``) or read (mixed columns ``j >= n_new``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from repro_torch.kernels.tda import tda
    from repro_torch.kernels.tda.ops import gather_paged_lanes as gather
    from repro_torch.kernels.tda.ref import (decode_attention_reference,
                                             mixed_attention_reference)
    dev = torch.device("cuda")
    dt = getattr(torch, dtype)
    for Hq, Hkv in HEADS:
        for ps in (8, 16):
            for window in (None, 5):
                q, k, v, bounds, bt, _ = _decode_case(1, Hq, Hkv, ps, window)
                tq, tk, tv = (tp.t(a, dev, dt) for a in (q, k, v))
                tb, tt = tp.t(bounds, dev), tp.t(bt, dev)
                n0 = tda.LAUNCHES["tda_paged_decode_attention"]
                got = tda.tda_paged_decode_attention(tq, tk, tv, tb, tt)
                assert tda.LAUNCHES["tda_paged_decode_attention"] == n0 + 1
                hi, lo = tb[:, 1:].long(), tb[:, :1].long()
                plain = decode_attention_reference(
                    tq, gather(tk, tt), gather(tv, tt), hi, window=hi - lo)
                live = (hi > lo)[:, 0]
                assert (got - plain)[live].abs().max().item() <= 1e-3
                assert not got[~live].any()
            for ring_short in (False, True):
                q, k, v, kr, vr, bounds, bt, ring = _mixed_case(
                    2, Hq, Hkv, ps, ring_short)
                tq, tk, tv, tkr, tvr = (tp.t(a, dev, dt)
                                        for a in (q, k, v, kr, vr))
                tb, tt = tp.t(bounds, dev), tp.t(bt, dev)
                live = torch.arange(q.shape[1], device=dev)[None] < tb[:, 1:]
                for window in (None, 6):
                    got = tda.tda_mixed_attention(tq, tk, tv, tkr, tvr, tb,
                                                  tt, ring=ring,
                                                  window=window)
                    plain = mixed_attention_reference(
                        tq, gather(tk, tt), gather(tv, tt), tkr, tvr,
                        tb[:, 0], tb[:, 1], ring=ring, window=window)
                    assert (got - plain)[live].abs().max().item() <= 1e-3
                    assert not got[~live].any()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_decode_kernels_int8_and_contiguous(dtype):
    """The contiguous decode kernel (fp and int8) and the int8 paged
    decode kernel against their plain versions on the card: max abs diff
    1e-3 on attended rows, exact zeros on the others. The int8 case keeps
    q in the compute dtype and the scales in f32."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from repro_torch.kernels.tda import tda
    from repro_torch.kernels.tda.ops import gather_paged_lanes as gather
    from repro_torch.kernels.tda.ref import decode_attention_reference
    dev = torch.device("cuda")
    dt = getattr(torch, dtype)

    def T(a):
        x = tp.t(a, dev)
        return x.to(dt) if x.is_floating_point() else x

    def plain(q, k, v, bounds, ks=None, vs=None):
        hi, lo = bounds[:, 1:].long(), bounds[:, :1].long()
        return decode_attention_reference(q, k, v, hi, k_scale=ks,
                                          v_scale=vs, window=hi - lo)

    for Hq, Hkv in HEADS:
        for window in (None, 5):
            for S in (37, 48, 130):
                for quant in (False, True):
                    q, k, v, ks, vs, bounds, _ = _contig_case(
                        3, Hq, Hkv, S, window, quant)
                    tq, tk, tv, tb = T(q), T(k), T(v), tp.t(bounds, dev)
                    tks = _opt(ks, lambda a: tp.t(a, dev))
                    tvs = _opt(vs, lambda a: tp.t(a, dev))
                    n0 = tda.LAUNCHES["tda_decode_attention"]
                    got = tda.tda_decode_attention(tq, tk, tv, tb, tks, tvs)
                    assert tda.LAUNCHES["tda_decode_attention"] == n0 + 1
                    want = plain(tq, tk, tv, tb, tks, tvs)
                    live = tb[:, 1] > tb[:, 0]
                    assert (got - want)[live].abs().max().item() <= 1e-3
                    assert not got[~live].any()
            q, kf, _, bounds, bt, _ = _decode_case(4, Hq, Hkv, 8, window)
            rng = np.random.default_rng(5)
            k, ks = _quantized(rng, kf.shape)
            v, vs = _quantized(rng, kf.shape)
            tq, tk, tv = T(q), tp.t(k, dev), tp.t(v, dev)
            tks, tvs = tp.t(ks, dev), tp.t(vs, dev)
            tb, tt = tp.t(bounds, dev), tp.t(bt, dev)
            got = tda.tda_paged_decode_attention(tq, tk, tv, tb, tt, tks,
                                                 tvs)
            want = plain(tq, gather(tk, tt), gather(tv, tt), tb,
                         gather(tks, tt), gather(tvs, tt))
            live = tb[:, 1] > tb[:, 0]
            assert (got - want)[live].abs().max().item() <= 1e-3
            assert not got[~live].any()


# Split edges of the decode kernels (split-K over the key axis): (G, D, B)
# with one slot over a long lane (many splits) and 64 slots over short
# lanes (one or few splits); G 1, 2, 5, 8, and 10, 12, 16 (two group tiles
# of 5, 6, 8 rows); D 64 and 128, and 20 (rows of no multiple of 16 bytes
# in bf16 and int8: element copies).
SPLIT_EDGES = [(1, 64, 1), (2, 128, 64), (5, 128, 1), (8, 64, 64),
               (5, 128, 8), (2, 20, 8), (12, 128, 8), (10, 64, 1),
               (16, 20, 64)]


def _split_edge_bounds(rng, W, L, B):
    """[lo, hi) rows at a lane of W positions cut into splits of L: many
    splits, hi <= lo, one token, hi and lo on split edges, a window across
    a split edge, the whole lane, the last position; then random rows."""
    rows = [(5, W - 7), (L + 2, L), (0, 1), (0, L), (L, 2 * L),
            (L - 3, 2 * L + 5), (0, W), (W - 1, W), (L - 1, L + 1), (0, 0)]
    rows = [(min(a, W), min(b, W)) for a, b in rows]
    while len(rows) < B:
        lo = int(rng.integers(0, W))
        rows.append((lo, int(rng.integers(lo, W + 1))))
    return np.array(rows[:B], np.int32)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_decode_split_edges(dtype):
    """Both decode kernels at their split edges (SPLIT_EDGES; 128- and
    16-token pages; contiguous lanes of ragged widths), fp and int8, exact
    and LUT exp, against their plain versions on the card: max abs diff
    1e-3 exact, 1e-5 LUT, on attended rows; exact zeros elsewhere. A
    second launch on the same workspace and counters gives the same bits
    (the counters reset themselves; the merge runs in split order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from repro_torch.kernels.afu.ref import exp_lut_table
    from repro_torch.kernels.tda import tda
    from repro_torch.kernels.tda.ops import gather_paged_lanes as gather
    from repro_torch.kernels.tda.ref import (decode_attention_lut,
                                             decode_attention_reference)
    from repro_torch.models.layers import kv_quantize
    dev = torch.device("cuda")
    dt = getattr(torch, dtype)
    table = exp_lut_table(dev)

    def plain(q, k, v, tb, ks, vs, lut_block):
        if lut_block:
            return decode_attention_lut(q, k, v, tb, table, lut_block, ks, vs)
        hi, lo = tb[:, 1:].long(), tb[:, :1].long()
        return decode_attention_reference(q, k, v, hi, k_scale=ks,
                                          v_scale=vs, window=hi - lo)

    def close(run, want, live, atol):
        got = run()
        assert (got - want)[live].abs().max().item() <= atol
        assert not got[~live].any()
        assert torch.equal(run(), got)

    Hkv = 2
    for i, (G, Dh, B) in enumerate(SPLIT_EDGES):
        rng = np.random.default_rng(60 + i)
        q = tp.t(rng.standard_normal((B, G * Hkv, Dh)).astype(np.float32),
                 dev, dt)
        for ps, n in ((128, 32 if B == 1 else 2), (16, 64 if B == 1 else 4)):
            W = n * ps
            tb = tp.t(_split_edge_bounds(rng, W, tda.decode_split_plan(W, ps),
                                         B), dev)
            live = tb[:, 1] > tb[:, 0]
            kf, vf, bt, _ = tp.paged_pool(rng, B=B, Hkv=Hkv, D=Dh, ps=ps, n=n,
                                          free_tail=False)
            tt = tp.t(bt, dev)
            k, v = tp.t(kf, dev, dt), tp.t(vf, dev, dt)
            (kq, ks), (vq, vs) = kv_quantize(k.float()), kv_quantize(v.float())
            for pool in ((k, v, None, None), (kq, vq, ks, vs)):
                lanes = [None if x is None else gather(x, tt) for x in pool]
                for tab in (None, table):
                    close(lambda: tda.tda_paged_decode_attention(
                        q, *pool[:2], tb, tt, *pool[2:], tab),
                        plain(q, *lanes[:2], tb, *lanes[2:],
                              0 if tab is None else ps),
                        live, 1e-3 if tab is None else 1e-5)
        for S in ((4000, 544) if B == 1 else (100, 130)):
            tb = tp.t(_split_edge_bounds(rng, S, tda.decode_split_plan(S), B),
                      dev)
            live = tb[:, 1] > tb[:, 0]
            shape = (B, S, Hkv, Dh)
            k = tp.t(rng.standard_normal(shape).astype(np.float32), dev, dt)
            v = tp.t(rng.standard_normal(shape).astype(np.float32), dev, dt)
            (kq, ks), (vq, vs) = kv_quantize(k.float()), kv_quantize(v.float())
            for lanes in ((k, v, None, None), (kq, vq, ks, vs)):
                for tab, bk in ((None, 0), (table, 128)):
                    close(lambda: tda.tda_decode_attention(
                        q, *lanes[:2], tb, *lanes[2:], tab, block_k=128),
                        plain(q, *lanes[:2], tb, *lanes[2:], min(bk, S)),
                        live, 1e-3 if tab is None else 1e-5)


# Head dims past 128 (the decode kernels' second instance): D 136, 192, 256
# at G 1, 5 and 10 over one kv head (recurrentgemma-2b's local layers: 10 q
# heads of 256 over 1 kv head).
D256_CASES = [(136, 1), (192, 5), (256, 10)]


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("window", [None, 9])
@pytest.mark.parametrize("Dh,G", D256_CASES)
def test_decode_plain_versions_at_head_dim_256(Dh, G, window, quant):
    """The decode kernels' plain versions at head dims past 128, paged (one
    row of 16-token pages) and contiguous, fp and int8, against the
    reference's ``kernels/tda/ref.py`` oracle on the CPU: atol 1e-5, as
    at D = 16 (f32 softmax over the same products)."""
    import jax.numpy as jnp
    from repro.kernels.tda.ref import decode_attention_reference as jref
    from repro_torch.kernels.tda.tda import (tda_decode_attention,
                                             tda_paged_decode_attention)
    rng = np.random.default_rng(Dh + G)
    B, ps, n = 5, 16, 4
    W = n * ps
    q = rng.standard_normal((B, G, Dh)).astype(np.float32)
    hi = np.array([W, 1, 37, 17, 0], np.int32)
    lo = np.zeros_like(hi) if window is None else np.maximum(hi - window, 0)
    bounds = np.stack([lo, hi], 1).astype(np.int32)
    if quant:
        k, ks = _quantized(rng, (B, W, 1, Dh))
        v, vs = _quantized(rng, (B, W, 1, Dh))
    else:
        k = rng.standard_normal((B, W, 1, Dh)).astype(np.float32)
        v = rng.standard_normal((B, W, 1, Dh)).astype(np.float32)
        ks = vs = None
    J = lambda a: _opt(a, jnp.asarray)  # noqa: E731
    want = np.array(jref(J(q), J(k), J(v), jnp.asarray(hi[:, None]),
                         k_scale=J(ks), v_scale=J(vs),
                         window=jnp.asarray((hi - lo)[:, None])))
    want[hi <= lo] = 0.0
    T = lambda a: _opt(a, tp.t)  # noqa: E731
    got = tda_decode_attention(T(q), T(k), T(v), T(bounds), T(ks),
                               T(vs)).numpy()
    np.testing.assert_allclose(got, want, atol=tp.ATOL_ATTN, rtol=0)
    # The same lanes as a shuffled page pool behind a block table.
    perm = rng.permutation(B * n).astype(np.int32)
    bt = perm.reshape(B, n)

    def pool(a):
        if a is None:
            return None
        out = np.empty((B * n, ps) + a.shape[2:], a.dtype)
        out[bt.reshape(-1)] = a.reshape((B * n, ps) + a.shape[2:])
        return tp.t(out)

    got = tda_paged_decode_attention(T(q), pool(k), pool(v), T(bounds),
                                     tp.t(bt), pool(ks), pool(vs)).numpy()
    np.testing.assert_allclose(got, want, atol=tp.ATOL_ATTN, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_decode_kernels_head_dim_256(dtype):
    """Both decode kernels at head dims 136, 192 and 256 (their kMaxD = 256
    instance), G 1, 5 and 10 over one kv head, on lanes of 2048 positions
    (pages of 128 and 16; contiguous), fp and int8, exact and LUT exp,
    against their plain versions on the card: max abs diff 1e-3 exact,
    1e-5 LUT, on attended rows; exact zeros elsewhere; a second launch
    gives the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from repro_torch.kernels.afu.ref import exp_lut_table
    from repro_torch.kernels.tda import tda
    from repro_torch.kernels.tda.ops import gather_paged_lanes as gather
    from repro_torch.kernels.tda.ref import (decode_attention_lut,
                                             decode_attention_reference)
    from repro_torch.models.layers import kv_quantize
    dev = torch.device("cuda")
    dt = getattr(torch, dtype)
    table = exp_lut_table(dev)

    def plain(q, k, v, tb, ks, vs, lut_block):
        if lut_block:
            return decode_attention_lut(q, k, v, tb, table, lut_block, ks, vs)
        hi, lo = tb[:, 1:].long(), tb[:, :1].long()
        return decode_attention_reference(q, k, v, hi, k_scale=ks,
                                          v_scale=vs, window=hi - lo)

    def close(run, want, live, atol):
        got = run()
        assert (got - want)[live].abs().max().item() <= atol
        assert not got[~live].any()
        assert torch.equal(run(), got)

    B, W = 8, 2048
    for i, (Dh, G) in enumerate(D256_CASES):
        rng = np.random.default_rng(90 + i)
        q = tp.t(rng.standard_normal((B, G, Dh)).astype(np.float32), dev, dt)
        for ps in (128, 16):
            n = W // ps
            tb = tp.t(_split_edge_bounds(rng, W, tda.decode_split_plan(W, ps),
                                         B), dev)
            live = tb[:, 1] > tb[:, 0]
            kf, vf, bt, _ = tp.paged_pool(rng, B=B, Hkv=1, D=Dh, ps=ps, n=n,
                                          free_tail=False)
            tt = tp.t(bt, dev)
            k, v = tp.t(kf, dev, dt), tp.t(vf, dev, dt)
            (kq, ks), (vq, vs) = kv_quantize(k.float()), kv_quantize(v.float())
            for lanes_ in ((k, v, None, None), (kq, vq, ks, vs)):
                lanes = [None if x is None else gather(x, tt)
                         for x in lanes_]
                for tab in ((None, table) if ps == 128 else (None,)):
                    close(lambda: tda.tda_paged_decode_attention(
                        q, *lanes_[:2], tb, tt, *lanes_[2:], tab),
                        plain(q, *lanes[:2], tb, *lanes[2:],
                              0 if tab is None else ps),
                        live, 1e-3 if tab is None else 1e-5)
        tb = tp.t(_split_edge_bounds(rng, W, tda.decode_split_plan(W), B),
                  dev)
        live = tb[:, 1] > tb[:, 0]
        shape = (B, W, 1, Dh)
        k = tp.t(rng.standard_normal(shape).astype(np.float32), dev, dt)
        v = tp.t(rng.standard_normal(shape).astype(np.float32), dev, dt)
        (kq, ks), (vq, vs) = kv_quantize(k.float()), kv_quantize(v.float())
        for lanes in ((k, v, None, None), (kq, vq, ks, vs)):
            for tab, bk in ((None, 0), (table, 128)):
                close(lambda: tda.tda_decode_attention(
                    q, *lanes[:2], tb, *lanes[2:], tab, block_k=128),
                    plain(q, *lanes[:2], tb, *lanes[2:], bk),
                    live, 1e-3 if tab is None else 1e-5)


# ---- LUT exp and int8 mixed ------------------------------------------------
# The reference has no plain LUT oracle (its ``use_kernel=False`` ops ignore
# the table), so the port's blockwise LUT plain versions are held against
# the reference's Pallas kernels in interpret mode, at the same atol: both
# take the same per-block recurrence in f32, summed in another order.


def _lut_tables():
    from repro.kernels.afu.ref import exp_lut_table as jtable
    from repro_torch.kernels.afu.ref import exp_lut_table
    return jtable(), exp_lut_table()


def _padded(a, Sp):
    """A contiguous lane (B, S, ...) zero-padded to Sp positions, as the
    reference's ops pads it for its kernel."""
    import jax.numpy as jnp
    return _opt(a, lambda x: jnp.asarray(np.pad(
        x, [(0, 0), (0, Sp - x.shape[1])] + [(0, 0)] * (x.ndim - 2))))


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("S", [37, 48])
@pytest.mark.parametrize("block_k", [16, 32])
def test_lut_contiguous_decode_matches_reference(block_k, S, window, quant):
    """LUT softmax blocks of ``block_k`` positions over a ragged lane (the
    reference pads it to a multiple of the block), fp and int8, with an
    empty lane and a hi <= lo row; also through the ops with lengths."""
    import jax.numpy as jnp
    from repro.kernels.tda.ops import fused_decode_attention as jfused
    from repro.kernels.tda.tda import tda_decode_attention as jkernel
    from repro_torch.kernels.tda.ops import fused_decode_attention
    from repro_torch.kernels.tda.tda import tda_decode_attention
    Hq, Hkv = HEADS[(S + block_k) % 2]
    q, k, v, ks, vs, bounds, lengths = _contig_case(S + block_k, Hq, Hkv, S,
                                                    window, quant)
    jt, tt = _lut_tables()
    Sp = -(-S // block_k) * block_k
    J = lambda a: _opt(a, jnp.asarray)  # noqa: E731
    ref = np.asarray(jkernel(J(q), _padded(k, Sp), _padded(v, Sp),
                             J(bounds), _padded(ks, Sp), _padded(vs, Sp), jt,
                             block_k=block_k, interpret=True))
    T = lambda a: _opt(a, tp.t)  # noqa: E731
    got = tda_decode_attention(T(q), T(k), T(v), T(bounds), T(ks), T(vs), tt,
                               block_k=block_k).numpy()
    np.testing.assert_allclose(got, ref, atol=tp.ATOL_ATTN, rtol=0)
    assert not got[0].any() and not got[4].any()  # hi <= lo: exact zeros
    jref = np.asarray(jfused(J(q), J(k), J(v), J(lengths), k_scale=J(ks),
                             v_scale=J(vs), window=window, lut_table=jt,
                             block_k=block_k, interpret=True))
    out = fused_decode_attention(T(q), T(k), T(v), T(lengths), k_scale=T(ks),
                                 v_scale=T(vs), window=window, lut_table=tt,
                                 block_k=block_k)
    np.testing.assert_allclose(out.numpy(), jref, atol=tp.ATOL_ATTN, rtol=0)


def test_lut_follows_the_reference_block_partition():
    """Under the LUT exp the result depends on the blocks: the reference's
    outputs at block_k 16 and 32 differ by more than 1e-4, and the port
    follows each (a port that rescaled on its own tiles would match at
    most one of them)."""
    import jax.numpy as jnp
    from repro.kernels.tda.tda import tda_decode_attention as jkernel
    from repro_torch.kernels.tda.tda import tda_decode_attention
    rng = np.random.default_rng(11)
    B, S, Hq, Hkv = 4, 64, 4, 2
    q = (rng.standard_normal((B, Hq, D)) * 2).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    bounds = np.array([[0, 64], [3, 61], [10, 40], [0, 33]], np.int32)
    jt, tt = _lut_tables()
    outs = {}
    for bk in (16, 32):
        ref = np.asarray(jkernel(*(jnp.asarray(a) for a in (q, k, v, bounds)),
                                 lut_table=jt, block_k=bk, interpret=True))
        got = tda_decode_attention(tp.t(q), tp.t(k), tp.t(v), tp.t(bounds),
                                   lut_table=tt, block_k=bk).numpy()
        np.testing.assert_allclose(got, ref, atol=tp.ATOL_ATTN, rtol=0)
        outs[bk] = ref
    assert np.abs(outs[16] - outs[32]).max() > 1e-4


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("ps", [8, 16])
def test_lut_paged_decode_matches_reference(ps, window, quant):
    """One page per LUT block, FREE tail entries, fp and int8 pools."""
    import jax.numpy as jnp
    from repro.kernels.tda.ops import fused_decode_attention as jfused
    from repro.kernels.tda.tda import tda_paged_decode_attention as jkernel
    from repro_torch.kernels.tda.ops import fused_decode_attention
    from repro_torch.kernels.tda.tda import tda_paged_decode_attention
    Hq, Hkv = HEADS[ps // 8 - 1]
    q, k, v, bounds, bt, lengths = _decode_case(ps + 7, Hq, Hkv, ps, window)
    ks = vs = None
    if quant:
        rng = np.random.default_rng(ps)
        k, ks = _quantized(rng, k.shape)
        v, vs = _quantized(rng, k.shape)
    jt, tt = _lut_tables()
    J = lambda a: _opt(a, jnp.asarray)  # noqa: E731
    T = lambda a: _opt(a, tp.t)  # noqa: E731
    ref = np.asarray(jkernel(J(q), J(k), J(v), J(bounds), J(bt), J(ks),
                             J(vs), jt, interpret=True))
    got = tda_paged_decode_attention(T(q), T(k), T(v), T(bounds), T(bt),
                                     T(ks), T(vs), tt).numpy()
    np.testing.assert_allclose(got, ref, atol=tp.ATOL_ATTN, rtol=0)
    assert not got[0].any() and not got[4].any()
    jref = np.asarray(jfused(J(q), J(k), J(v), J(lengths), k_scale=J(ks),
                             v_scale=J(vs), block_table=J(bt), window=window,
                             lut_table=jt, interpret=True))
    out = fused_decode_attention(T(q), T(k), T(v), T(lengths), k_scale=T(ks),
                                 v_scale=T(vs), block_table=T(bt),
                                 window=window, lut_table=tt)
    np.testing.assert_allclose(out.numpy(), jref, atol=tp.ATOL_ATTN, rtol=0)


def _quantized_pool(k, v, seed):
    """int8 codes and f32 scale pools of random pages shaped like k."""
    rng = np.random.default_rng(seed)
    kq, ks = _quantized(rng, k.shape)
    vq, vs = _quantized(rng, v.shape)
    return kq, vq, ks, vs


@pytest.mark.parametrize("lut", [False, True])
@pytest.mark.parametrize("window", [None, 6])
@pytest.mark.parametrize("ring_short", [False, True])
@pytest.mark.parametrize("ps", [8, 16])
def test_mixed_lut_and_int8_match_reference(ps, ring_short, window, lut):
    """The mixed step with the LUT exp over an fp pool, or over int8 pool
    codes with f32 scales with the exact exp."""
    _check_mixed(ps, ring_short, window, lut=lut, quant=not lut)


@pytest.mark.parametrize("window", [None, 6])
@pytest.mark.parametrize("ring_short", [False, True])
@pytest.mark.parametrize("ps", [8, 16])
def test_mixed_int8_lut_matches_reference(ps, ring_short, window):
    """The mixed step with the LUT exp over int8 pool codes."""
    _check_mixed(ps, ring_short, window, lut=True, quant=True)


def _check_mixed(ps, ring_short, window, *, lut, quant):
    """The mixed kernel's wrapper and op against the reference's Pallas
    kernel in interpret mode, with the LUT exp (per page, then the row
    chunk as one block) or without, over an fp pool or int8 pool codes with
    f32 scales, on live columns; a wrapped short ring and a window. Exact
    exp: also the op's oracle against the reference's."""
    import jax.numpy as jnp
    from repro.kernels.tda.ops import fused_mixed_attention as jfused
    from repro.kernels.tda.tda import tda_mixed_attention as jkernel
    from repro_torch.kernels.tda.ops import fused_mixed_attention
    from repro_torch.kernels.tda.tda import tda_mixed_attention
    Hq, Hkv = HEADS[int(ring_short)]
    q, k, v, kr, vr, bounds, bt, ring = _mixed_case(ps + Hq + 2, Hq, Hkv, ps,
                                                    ring_short)
    ks = vs = None
    if quant:
        k, v, ks, vs = _quantized_pool(k, v, ps + 1)
    jt, tt = _lut_tables() if lut else (None, None)
    J = lambda a: _opt(a, jnp.asarray)  # noqa: E731
    T = lambda a: _opt(a, tp.t)  # noqa: E731
    args = (q, k, v, kr, vr, bounds, bt, ks, vs)
    ref = np.asarray(jkernel(*map(J, args), jt, ring=ring, window=window,
                             interpret=True))
    got = tda_mixed_attention(*map(T, args), tt, ring=ring,
                              window=window).numpy()
    live = np.arange(q.shape[1])[None, :] < bounds[:, 1:2]  # (B, S)
    np.testing.assert_allclose(got[live], ref[live], atol=tp.ATOL_ATTN,
                               rtol=0)
    assert not got[0].any()  # ci = 0 and n_new = 0: no key, exact zeros
    ci, nn = bounds[:, 0], bounds[:, 1]
    kern = fused_mixed_attention(*map(T, args[:5]), T(ci), T(nn),
                                 block_table=T(bt), ring=ring, window=window,
                                 k_scale=T(ks), v_scale=T(vs),
                                 lut_table=tt).numpy()
    np.testing.assert_allclose(kern[live], ref[live], atol=tp.ATOL_ATTN,
                               rtol=0)
    if not lut:
        jref = np.asarray(jfused(*map(J, args[:5]), J(ci), J(nn),
                                 block_table=J(bt), ring=ring, window=window,
                                 k_scale=J(ks), v_scale=J(vs),
                                 use_kernel=False))
        out = fused_mixed_attention(*map(T, args[:5]), T(ci), T(nn),
                                    block_table=T(bt), ring=ring,
                                    window=window, k_scale=T(ks),
                                    v_scale=T(vs), use_kernel=False).numpy()
        np.testing.assert_allclose(out, jref, atol=tp.ATOL_ATTN, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_lut_and_int8_mixed_kernels(dtype):
    """The LUT mode of all three kernels (decode over fp and int8 lanes)
    and the mixed kernel over int8 pools (exact and LUT) against their
    plain versions on the card: max abs diff on attended rows and live
    columns 1e-5 with the LUT exp (the same f32 formulas, summed in another
    order), 1e-3 with the exact exp (as the exact kernels' test), exact
    zeros elsewhere; each launch counted under its variant."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from repro_torch.kernels.afu.ref import exp_lut_table
    from repro_torch.kernels.tda import tda
    from repro_torch.kernels.tda.ops import gather_paged_lanes as gather
    from repro_torch.kernels.tda.ref import (decode_attention_lut,
                                             mixed_attention_lut,
                                             mixed_attention_reference)
    dev = torch.device("cuda")
    dt = getattr(torch, dtype)
    table = exp_lut_table(dev)

    def T(a):
        x = tp.t(a, dev)
        return x.to(dt) if x.dtype == torch.float32 else x

    def close(got, want, live, atol=1e-5):
        assert (got - want)[live].abs().max().item() <= atol
        assert not got[~live].any()

    for Hq, Hkv in HEADS:
        for S in (37, 48, 130):
            for quant in (False, True):
                q, k, v, ks, vs, bounds, _ = _contig_case(3, Hq, Hkv, S, 5,
                                                          quant)
                tq, tk, tv, tb = T(q), T(k), T(v), tp.t(bounds, dev)
                tks = _opt(ks, lambda a: tp.t(a, dev))
                tvs = _opt(vs, lambda a: tp.t(a, dev))
                for bk in (16, 128):
                    key = "tda_decode_attention" + (".int8" if quant
                                                    else "") + ".lut"
                    n0 = tda.VARIANT_LAUNCHES[key]
                    got = tda.tda_decode_attention(tq, tk, tv, tb, tks, tvs,
                                                   table, block_k=bk)
                    assert tda.VARIANT_LAUNCHES[key] == n0 + 1
                    close(got, decode_attention_lut(
                        tq, tk, tv, tb, table, min(bk, S), tks, tvs),
                        tb[:, 1] > tb[:, 0])
        for ps in (8, 16):
            q, kf, vf, bounds, bt, _ = _decode_case(4, Hq, Hkv, ps, 5)
            kq, vq, ks, vs = _quantized_pool(kf, vf, ps)
            tq, tb, tt = T(q), tp.t(bounds, dev), tp.t(bt, dev)
            for k, v, ks_, vs_ in ((T(kf), T(vf), None, None),
                                   (tp.t(kq, dev), tp.t(vq, dev),
                                    tp.t(ks, dev), tp.t(vs, dev))):
                got = tda.tda_paged_decode_attention(tq, k, v, tb, tt, ks_,
                                                     vs_, table)
                want = decode_attention_lut(
                    tq, gather(k, tt), gather(v, tt), tb, table, ps,
                    _opt(ks_, lambda a: gather(a, tt)),
                    _opt(vs_, lambda a: gather(a, tt)))
                close(got, want, tb[:, 1] > tb[:, 0])
            q, kf, vf, kr, vr, bounds, bt, ring = _mixed_case(
                5, Hq, Hkv, ps, True)
            kq, vq, ks, vs = _quantized_pool(kf, vf, ps + 2)
            tq, tkr, tvr = T(q), T(kr), T(vr)
            tb, tt = tp.t(bounds, dev), tp.t(bt, dev)
            live = torch.arange(q.shape[1], device=dev)[None] < tb[:, 1:]
            for window in (None, 6):
                for k, v, ks_, vs_ in ((T(kf), T(vf), None, None),
                                       (tp.t(kq, dev), tp.t(vq, dev),
                                        tp.t(ks, dev), tp.t(vs, dev))):
                    lanes = (tq, gather(k, tt), gather(v, tt), tkr, tvr,
                             tb[:, 0], tb[:, 1])
                    sc = dict(k_scale=_opt(ks_, lambda a: gather(a, tt)),
                              v_scale=_opt(vs_, lambda a: gather(a, tt)))
                    got = tda.tda_mixed_attention(tq, k, v, tkr, tvr, tb, tt,
                                                  ks_, vs_, table, ring=ring,
                                                  window=window)
                    close(got, mixed_attention_lut(
                        *lanes, page_size=ps, ring=ring, window=window,
                        table=table, **sc), live)
                    if ks_ is not None:
                        got = tda.tda_mixed_attention(
                            tq, k, v, tkr, tvr, tb, tt, ks_, vs_, ring=ring,
                            window=window)
                        close(got, mixed_attention_reference(
                            *lanes, ring=ring, window=window, **sc), live,
                            atol=1e-3)


# Tile edges of the tensor-core mixed kernel (bf16 q; 64 packed query rows
# a block): (G, D, page_size). S = 20 columns, so S G (20, 40, 100, 160) is
# no multiple of 64; D 16, 72 (int8 rows copy in 8-byte pieces), 128 and 20
# (element copies); pages of 8, 16 and 128.
MIXED_TILE_EDGES = [(1, 16, 8), (2, 72, 16), (5, 128, 128), (8, 16, 128),
                    (8, 72, 8), (5, 16, 16), (1, 128, 16), (2, 20, 16)]


def _mixed_tile_case(G, Dh, ps, ring_short, seed):
    """Rows (ci, n_new): dead, a fresh full chunk, a decode row, an inert
    row, a full chunk over a resident lane, a lane past its ring (wraps
    when the ring is short) and a mid-lane chunk."""
    rng = np.random.default_rng(seed)
    n = 2 if ps == 128 else 3
    S, B, Hkv = 20, 7, 2
    W = n * ps
    ring = W - ps + 3 if ring_short else W
    k, v, bt, _ = tp.paged_pool(rng, B=B, Hkv=Hkv, D=Dh, ps=ps, n=n,
                                free_tail=False)
    bounds = np.array([(0, 0), (0, S), (W // 2, 1), (W // 3, 0),
                       (W - S, S), (ring + 5, 3), (ps + 2, S // 2 + 3)],
                      np.int32)
    q = rng.standard_normal((B, S, G * Hkv, Dh)).astype(np.float32)
    kr = rng.standard_normal((B, S, Hkv, Dh)).astype(np.float32)
    vr = rng.standard_normal((B, S, Hkv, Dh)).astype(np.float32)
    return q, k, v, kr, vr, bounds, bt, ring


@pytest.mark.gpu
def test_cuda_mixed_kernel_tile_edges():
    """The tensor-core mixed kernel at its tile edges (MIXED_TILE_EDGES,
    short rings, windows; n_new 0, 1 and S; bf16 and int8 pools, exact and
    LUT exp) against its plain versions on the card: max abs diff on live
    columns 1e-3 with the exact exp, 1e-5 with the LUT exp, exact zeros
    elsewhere."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from repro_torch.kernels.afu.ref import exp_lut_table
    from repro_torch.kernels.tda import tda
    from repro_torch.kernels.tda.ops import gather_paged_lanes as gather
    from repro_torch.kernels.tda.ref import (mixed_attention_lut,
                                             mixed_attention_reference)
    from repro_torch.models.layers import kv_quantize
    dev = torch.device("cuda")
    table = exp_lut_table(dev)
    bf = torch.bfloat16
    for i, (G, Dh, ps) in enumerate(MIXED_TILE_EDGES):
        for ring_short in (False, True):
            q, k, v, kr, vr, bounds, bt, ring = _mixed_tile_case(
                G, Dh, ps, ring_short, 20 + i)
            tq, tk, tv, tkr, tvr = (tp.t(a, dev, bf) for a in (q, k, v, kr,
                                                               vr))
            tb, tt = tp.t(bounds, dev), tp.t(bt, dev)
            kq, ks = kv_quantize(tp.t(k, dev))
            vq, vs = kv_quantize(tp.t(v, dev))
            live = torch.arange(q.shape[1], device=dev)[None] < tb[:, 1:]
            for window in (None, 7):
                for pool in ((tk, tv, None, None), (kq, vq, ks, vs)):
                    lanes = (tq, gather(pool[0], tt), gather(pool[1], tt),
                             tkr, tvr, tb[:, 0], tb[:, 1])
                    sc = {"k_scale": _opt(pool[2], lambda a: gather(a, tt)),
                          "v_scale": _opt(pool[3], lambda a: gather(a, tt))}
                    for lut in (False, True):
                        got = tda.tda_mixed_attention(
                            tq, *pool[:2], tkr, tvr, tb, tt, *pool[2:],
                            table if lut else None, ring=ring, window=window)
                        want = (mixed_attention_lut(
                            *lanes, page_size=ps, ring=ring, window=window,
                            table=table, **sc) if lut else
                            mixed_attention_reference(
                                *lanes, ring=ring, window=window, **sc))
                        err = (got - want)[live].abs().max().item()
                        assert err <= (1e-5 if lut else 1e-3), \
                            (G, Dh, ps, ring_short, window, lut, err)
                        assert not got[~live].any()


def test_lut_table_and_variant_counts_checked_before_launch():
    """A LUT table must be a contiguous (64,) f32 tensor on q's device and
    its blocks at most 256 positions; launch counts keep one key per
    variant and reset together."""
    from repro_torch.kernels.afu.ref import exp_lut_table
    from repro_torch.kernels.tda import tda
    q = tp.t(np.zeros((2, 4, D), np.float32))
    table = exp_lut_table()
    assert tda._table("x", None, q, 1000) == 0
    assert tda._table("x", table, q, 256) == table.data_ptr()
    for bad in (table.double(), table[:32], table.reshape(8, 8)):
        with pytest.raises(TypeError):
            tda._table("x", bad, q, 16)
    for block in (0, 257):
        with pytest.raises(ValueError):
            tda._table("x", table, q, block)
    assert set(tda.VARIANT_LAUNCHES) == {
        name + suffix for name in tda.LAUNCHES
        for suffix in ("", ".int8", ".lut", ".int8.lut")}
    tda._count("tda_mixed_attention", 1, 0)
    tda._count("tda_mixed_attention", 0, table.data_ptr())
    assert tda.VARIANT_LAUNCHES["tda_mixed_attention.int8"] == 1
    assert tda.VARIANT_LAUNCHES["tda_mixed_attention.lut"] == 1
    assert tda.LAUNCHES["tda_mixed_attention"] == 2  # the variants' sum
    assert dict(tda.LAUNCHES) == {"tda_decode_attention": 0,
                                  "tda_paged_decode_attention": 0,
                                  "tda_mixed_attention": 2}
    tda.reset_launch_counts()
    assert not any(tda.LAUNCHES.values()) \
        and not any(tda.VARIANT_LAUNCHES.values())
