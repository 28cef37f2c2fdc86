"""TDA attention parity: the port's paged-decode and mixed-step attention
(kernel wrappers on CPU tensors run their plain versions) against the
reference's Pallas kernels in interpret mode and its jnp oracle; plus, on a
CUDA device only, each hand-written kernel against its plain version."""
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
    assert tda.LAUNCHES == {"tda_paged_decode_attention": 0,
                            "tda_mixed_attention": 0}
    with pytest.raises(TypeError):
        tda._check("x", (tp.t(q),), (tp.t(q), tp.t(k, dtype=torch.float64)),
                   ())
    with pytest.raises(ValueError):
        tda._heads("x", 40, 4, 128, tda.MAX_GROUP)  # G = 10 > 8


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
