"""The port's T-REX compression (``repro_torch.core.compression``,
``sparsity`` and the tree walks of ``factorized``) against the reference on
the same numpy inputs and on bridged reference parameters (float32 qwen2.5
smoke, factorized with the JAX tests' ``FCFG``).

Tolerances, each with its reason: W_D integer streams (first index,
deltas and their dtype, value codes, value widths) and the ``stats`` are
exact — integer work on the same f32 values. LUT, scale and offset to rtol
1e-6: the port keeps the scale as f32 where the reference holds a Python
float (the f32 it stores in the tree is the same number). W_S codes are
equal except where an element lies within 1e-6 of a LUT edge (k-means in
another library could move an edge by an ulp); such elements are counted
and bounded.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_parity as tp  # noqa: E402

RNG_SEED = 0
EDGE_EPS = 1e-6


def _fcfg(mod):
    return mod.FactorizationConfig(enabled=True, min_dim=32, rank=32, nnz=8)


def _codes_equal_off_edges(ref_codes, got_codes, values, lut):
    """Codes equal except for elements within EDGE_EPS of a LUT edge; at
    most 1 in 10^4 elements (and at least 1 allowed) may differ there."""
    lut = np.asarray(lut, np.float32)
    edges = (lut[1:] + lut[:-1]) / 2
    near = np.abs(np.asarray(values, np.float32).reshape(-1)[:, None]
                  - edges[None]).min(1) <= EDGE_EPS
    diff = (np.asarray(ref_codes).reshape(-1)
            != np.asarray(got_codes).reshape(-1))
    assert not (diff & ~near).any()
    assert diff.sum() <= max(1, diff.size // 10_000)


@pytest.mark.parametrize("shape", [(64, 32), (333, 77), (1000, 300)])
def test_compress_ws_matches_reference(shape):
    from repro.core import compression as rc
    from repro_torch.core import compression as tc
    w = (np.random.default_rng(RNG_SEED).standard_normal(shape) * 0.1
         ).astype(np.float32)
    ref = rc.compress_ws(w)
    got = tc.compress_ws(tp.t(w))
    np.testing.assert_allclose(got.lut.numpy(), ref.lut, rtol=1e-6, atol=0)
    assert got.codes.dtype == torch.uint8 and got.shape == ref.shape
    _codes_equal_off_edges(ref.codes, got.codes.numpy(), w, ref.lut)
    assert tc.ws_compressed_bits(got) == rc.ws_compressed_bits(ref)
    np.testing.assert_array_equal(
        tc.dequantize_nonuniform(got.codes, got.lut).numpy(),
        np.asarray(rc.dequantize_nonuniform(ref.codes, ref.lut)))


def test_compress_ws_constant_matrix_pads_centers():
    """A constant matrix has one distinct quantile: the centers are padded
    by 1e-6 steps to 16, as in the reference."""
    from repro.core import compression as rc
    from repro_torch.core import compression as tc
    w = np.full((8, 8), 0.25, np.float32)
    ref, got = rc.compress_ws(w), tc.compress_ws(tp.t(w))
    np.testing.assert_allclose(got.lut.numpy(), ref.lut, rtol=1e-6)
    np.testing.assert_array_equal(got.codes.numpy(), ref.codes)


@pytest.mark.parametrize("r,d_out,nnz,bits", [
    (64, 48, 8, 6), (333, 77, 20, 6), (1024, 40, 2, 6), (96, 64, 24, 4),
    (128, 32, 16, 7)])
def test_compress_wd_matches_reference(r, d_out, nnz, bits):
    """Integer streams exact; scale/offset rtol 1e-6; the r=1024, nnz=2
    case needs more than 8 delta bits (the int16 stream)."""
    from repro.core import compression as rc
    from repro_torch.core import compression as tc
    wd = np.random.default_rng(r + nnz).standard_normal((r, d_out)).astype(
        np.float32)
    ref = rc.compress_wd(wd, nnz, value_bits=bits)
    got = tc.compress_wd(tp.t(wd), nnz, value_bits=bits)
    np.testing.assert_array_equal(got.deltas.numpy(), ref.deltas)
    assert got.deltas.dtype == torch.int32
    np.testing.assert_array_equal(got.values_q.numpy(), ref.values_q)
    np.testing.assert_allclose(float(got.scale), ref.scale, rtol=1e-6)
    np.testing.assert_allclose(float(got.offset), ref.offset, rtol=1e-6)
    assert got.achieved_delta_bits == ref.achieved_delta_bits
    assert (got.achieved_delta_bits > 8) == (r == 1024)
    assert got.first_index_bits == ref.first_index_bits
    for mode in (False, True):
        assert tc.wd_compressed_bits(got, mode) == \
            rc.wd_compressed_bits(ref, mode)
    np.testing.assert_array_equal(tc.delta_decode(got.deltas).numpy(),
                                  rc.delta_decode(ref.deltas))


def test_uniform_quant_and_helpers_match_reference():
    from repro.core import compression as rc
    from repro_torch.core import compression as tc
    rng = np.random.default_rng(3)
    v = rng.standard_normal((40, 9)).astype(np.float32)
    for bits in (4, 6):
        ref, got = rc.quantize_uniform(v, bits), tc.quantize_uniform(tp.t(v),
                                                                     bits)
        np.testing.assert_array_equal(got.q.numpy(), ref.q)
        deq_ref = np.asarray(rc.dequantize_uniform(
            ref.q, np.float32(ref.scale), np.float32(ref.offset), bits))
        deq = tc.dequantize_uniform(got.q, got.scale, got.offset,
                                    torch.tensor(bits, dtype=torch.int32))
        np.testing.assert_allclose(deq.numpy(), deq_ref, rtol=1e-6,
                                   atol=1e-6)
    const = tc.quantize_uniform(torch.full((5,), 2.0))
    assert float(const.scale) == 0.0 and not const.q.any()
    assert float(const.offset) == 2.0
    for x in (0, 1, 2, 3, 255, 256, 1023):
        assert tc.bits_needed(x) == rc.bits_needed(x)
    idx = np.sort(rng.integers(0, 50, size=(6, 4)), axis=0)
    np.testing.assert_array_equal(tc.delta_encode(tp.t(idx)).numpy(),
                                  rc.delta_encode(idx))


def test_topk_projection_matches_reference():
    import jax.numpy as jnp
    from repro.core import sparsity as rs
    from repro_torch.core import sparsity as ts
    wd = np.random.default_rng(5).standard_normal((50, 30)).astype(np.float32)
    for nnz in (1, 7, 50, 80):
        np.testing.assert_array_equal(
            ts.topk_column_mask(tp.t(wd), nnz).numpy(),
            np.asarray(rs.topk_column_mask(jnp.asarray(wd), nnz)))
        np.testing.assert_array_equal(
            ts.project_topk_columns(tp.t(wd), nnz).numpy(),
            np.asarray(rs.project_topk_columns(jnp.asarray(wd), nnz)))


@pytest.fixture(scope="module")
def factorized_trees():
    """Reference smoke params (factorized), projected and compressed by
    both packages from the same bridged values."""
    import jax
    from repro.configs import get_config as jget
    from repro.core import factorized as rf
    from repro.models.transformer import Model as JM
    from repro_torch.core import factorized as tf
    from repro_torch.models.bridge import params_from_numpy
    jm = JM(jget("qwen2.5-32b", "smoke", dtype="float32",
                 factorization=_fcfg(rf)))
    params = jm.init(jax.random.key(0))
    jproj = rf.project_wd_leaves(params, _fcfg(rf))
    _, jcp, jstats = jm.compress_params(jproj)
    tparams = params_from_numpy(tp.to_numpy_tree(params), tp.CPU)
    tproj = tf.project_wd_leaves(tparams, _fcfg(tf))
    tcp, tstats = tf.compress_model_params(tproj, _fcfg(tf))
    return (tp.to_numpy_tree(jproj), tp.to_numpy_tree(jcp), jstats, tproj,
            tcp, tstats)


def _walk(a, b, fn, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _walk(a[k], b[k], fn, f"{path}/{k}")
    else:
        fn(path, np.asarray(a), b)


def test_project_wd_leaves_matches_reference(factorized_trees):
    jproj, _, _, tproj, _, _ = factorized_trees

    def same(path, ref, got):
        assert got.dtype == torch.float32, path
        np.testing.assert_array_equal(got.numpy(), ref, err_msg=path)

    _walk(jproj, tproj, same)


def test_compress_model_params_matches_reference(factorized_trees):
    """Every leaf of the compressed tree: integer streams (and their
    dtypes) exact, LUT / scale / offset rtol 1e-6, W_S codes off LUT
    edges exact, passthrough leaves exact; stats equal integer for
    integer."""
    jproj, jcp, jstats, _, tcp, tstats = factorized_trees
    assert tstats == jstats
    assert set(tcp["dicts"]) == {"attn_q", "attn_k", "attn_v", "attn_o",
                                 "ffn_up", "ffn_gate", "ffn_down"}
    torch_dtype = {np.dtype(np.uint8): torch.uint8,
                   np.dtype(np.int16): torch.int16,
                   np.dtype(np.int32): torch.int32,
                   np.dtype(np.float32): torch.float32}

    def close(path, ref, got):
        assert got.dtype == torch_dtype[ref.dtype], path
        assert tuple(got.shape) == ref.shape, path
        if path.endswith(("lut", "wd_scale", "wd_offset")):
            np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6,
                                       err_msg=path)
        elif not path.endswith("codes_packed"):
            np.testing.assert_array_equal(got.numpy(), ref, err_msg=path)

    _walk(jcp, tcp, close)
    from repro_torch.core.factorized import unpack_nibbles
    for fam, entry in tcp["dicts"].items():
        ws = jproj["dicts"][fam]
        _codes_equal_off_edges(
            unpack_nibbles(tp.t(jcp["dicts"][fam]["codes_packed"])
                           )[:ws.shape[0]].numpy(),
            unpack_nibbles(entry["codes_packed"])[:ws.shape[0]].numpy(),
            ws, jcp["dicts"][fam]["lut"])


def test_params_stream_bits_and_decompression_match_reference(
        factorized_trees):
    import jax.numpy as jnp
    from repro.core import factorized as rf
    from repro_torch.core import factorized as tf
    jproj, jcp, _, tproj, tcp, _ = factorized_trees
    assert tf.params_stream_bits(tproj) == rf.params_stream_bits(jproj)
    assert tf.params_stream_bits(tcp) == rf.params_stream_bits(jcp)
    for fam, entry in tcp["dicts"].items():
        d_in = jproj["dicts"][fam].shape[0]
        ref = rf.decompress_ws_entry(
            {k: jnp.asarray(v) for k, v in jcp["dicts"][fam].items()}, d_in)
        np.testing.assert_allclose(
            tf.decompress_ws_entry(entry, d_in).numpy(), np.asarray(ref),
            rtol=1e-6)
    grp = tcp["layers"]["ffn"]["w_up"]
    jgrp = jcp["layers"]["ffn"]["w_up"]
    r = jproj["layers"]["ffn"]["w_up"]["wd"].shape[-2]
    for i in range(grp["wd_vq"].shape[0]):
        ref = rf.decompress_wd_leaf({k: jnp.asarray(v[i])
                                     for k, v in jgrp.items()}, r)
        got = tf.decompress_wd_leaf({k: v[i] for k, v in grp.items()}, r)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                                   atol=1e-7)
        # the projection made the streams exact on the indices
        wd = jproj["layers"]["ffn"]["w_up"]["wd"][i]
        np.testing.assert_array_equal(got.numpy() != 0, wd != 0)


def test_pack_nibbles_odd_rows_match_reference():
    from repro.core import factorized as rf
    from repro_torch.core import factorized as tf
    codes = np.random.default_rng(9).integers(0, 16, size=(7, 5)).astype(
        np.uint8)
    packed = tf.pack_nibbles(tp.t(codes))
    np.testing.assert_array_equal(packed.numpy(), rf.pack_nibbles(codes))
    np.testing.assert_array_equal(tf.unpack_nibbles(packed)[:7].numpy(),
                                  codes)


def test_compress_model_params_needs_dicts():
    from repro_torch.core import factorized as tf
    with pytest.raises(ValueError, match="dicts"):
        tf.compress_model_params({"layers": {}}, _fcfg(tf))


def test_compress_model_params_int16_deltas_match_reference():
    """A stack whose deltas need more than 8 bits (r = 1024, nnz = 2)
    stores ``wd_deltas`` as int16 for every slice, as the reference does;
    biases pass through and are priced in the stats."""
    import jax.numpy as jnp
    from repro.core import factorized as rf
    from repro_torch.core import factorized as tf
    rng = np.random.default_rng(11)
    tree = {"dicts": {"f": rng.normal(size=(16, 1024)).astype(np.float32)},
            "layers": {"lin": {
                "wd": rng.normal(size=(2, 1024, 40)).astype(np.float32),
                "b": rng.normal(size=(2, 40)).astype(np.float32)}}}
    cfg = dict(enabled=True, min_dim=8, rank=1024, nnz=2)
    jcp, jst = rf.compress_model_params(
        {k: {kk: (jnp.asarray(vv) if not isinstance(vv, dict) else
                  {a: jnp.asarray(b) for a, b in vv.items()})
             for kk, vv in v.items()} for k, v in tree.items()},
        rf.FactorizationConfig(**cfg))
    tcp, tst = tf.compress_model_params(
        {k: {kk: (tp.t(vv) if not isinstance(vv, dict) else
                  {a: tp.t(b) for a, b in vv.items()})
             for kk, vv in v.items()} for k, v in tree.items()},
        tf.FactorizationConfig(**cfg))
    assert tst == jst
    got, ref = tcp["layers"]["lin"], tp.to_numpy_tree(jcp)["layers"]["lin"]
    assert got["wd_deltas"].dtype == torch.int16 == \
        {np.dtype(np.int16): torch.int16}[ref["wd_deltas"].dtype]
    for k in ("wd_first", "wd_deltas", "wd_vq", "wd_bits", "b"):
        np.testing.assert_array_equal(got[k].numpy(), ref[k])


# ---- the offline tooling: reorder, compress_linear, accounting -------------

@pytest.mark.parametrize("r,d_out,nnz", [(64, 48, 8), (128, 96, 16),
                                         (200, 70, 3), (130, 300, 40)])
def test_reorder_for_delta_matches_reference(r, d_out, nnz):
    """The greedy co-occurrence order, element for element, on each
    column's top-nnz rows (the reference's lossy 64-column bitmap, ties
    to the lowest row); and on a tie-only case (every row in every
    column)."""
    from repro.core import compression as rc
    from repro_torch.core import compression as tc
    wd = np.random.default_rng(r).standard_normal((r, d_out)).astype(
        np.float32)
    idx = np.sort(np.argsort(-np.abs(wd), axis=0)[:nnz], axis=0)
    want = rc.reorder_for_delta(idx, r)
    got = tc.reorder_for_delta(tp.t(idx), r)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    ties = np.tile(np.arange(4)[:, None], (1, 10))
    np.testing.assert_array_equal(tc.reorder_for_delta(ties, 12),
                                  rc.reorder_for_delta(ties, 12))


@pytest.mark.parametrize("reorder", [True, False])
@pytest.mark.parametrize("r,d_out,nnz", [(64, 48, 8), (200, 70, 3),
                                         (1024, 40, 2)])
def test_compress_linear_matches_reference(r, d_out, nnz, reorder):
    """``compress_linear``: the same order and integer streams (and
    dtypes: int16 deltas past 8 bits at r 1024, nnz 2), scale / offset to
    rtol 1e-6, the bias passed through; a dense layer unchanged. Then
    ``compress_wd(order=)`` and the dense reconstructions
    ``decompress_wd_dense`` / ``decompress_ws_dense`` against the
    reference's (rtol 1e-6: the same f32 dequantization)."""
    from repro.core import compression as rc
    from repro.core import factorized as rf
    from repro_torch.core import compression as tc
    from repro_torch.core import factorized as tf
    rng = np.random.default_rng(r + nnz)
    wd = rng.standard_normal((r, d_out)).astype(np.float32)
    b = rng.standard_normal(d_out).astype(np.float32)
    kw = dict(enabled=True, min_dim=8, rank=r, nnz=nnz)
    want = rf.compress_linear({"wd": wd, "b": b}, {}, "f",
                              rf.FactorizationConfig(**kw), reorder=reorder)
    got = tf.compress_linear({"wd": tp.t(wd), "b": tp.t(b)}, {}, "f",
                             tf.FactorizationConfig(**kw), reorder=reorder)
    assert set(got) == set(want)
    for k, w in want.items():
        g, w = got[k].numpy(), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if k in ("wd_scale", "wd_offset"):
            np.testing.assert_allclose(g, w, rtol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)
    dense = {"w": tp.t(wd)}
    assert tf.compress_linear(dense, {}, "f", tf.FactorizationConfig(
        **kw)) == dense
    order = want.get("_order")
    cw = rc.compress_wd(wd, nnz, order=order)
    ct = tc.compress_wd(tp.t(wd), nnz, order=order)
    np.testing.assert_array_equal(ct.deltas.numpy(), cw.deltas)
    np.testing.assert_allclose(tc.decompress_wd_dense(ct).numpy(),
                               np.asarray(rc.decompress_wd_dense(cw)),
                               rtol=1e-6, atol=0)
    ws = rng.standard_normal((48, r)).astype(np.float32)
    sw, st = rc.compress_ws(ws), tc.compress_ws(tp.t(ws))
    np.testing.assert_allclose(
        tc.decompress_ws_dense(st).numpy(),
        np.asarray(rc.decompress_ws_dense(sw)), rtol=1e-6, atol=0)


def test_linear_macs_and_param_bits_match_reference():
    """``linear_macs`` and ``linear_param_bits`` (compressed and not, two
    dense widths) equal the reference's integers over a grid of shapes
    and factorizations, dense ones included."""
    from repro.core import factorized as rf
    from repro_torch.core import factorized as tf
    shapes = [(64, 64), (768, 3072), (3072, 768), (256, 2048), (384, 1536),
              (100, 30), (512, 512), (5120, 27648)]
    cfgs = [dict(enabled=True), dict(enabled=True, min_dim=128),
            dict(enabled=True, rank=32, nnz=8, min_dim=32),
            dict(enabled=False), dict(enabled=True, nnz_ratio=0.25)]
    for d_in, d_out in shapes:
        for kw in cfgs:
            a, b = rf.FactorizationConfig(**kw), tf.FactorizationConfig(**kw)
            for tokens in (1, 128):
                assert tf.linear_macs(tokens, d_in, d_out, b) == \
                    rf.linear_macs(tokens, d_in, d_out, a)
            for comp, bits in ((True, 16), (False, 16), (False, 8)):
                got = tf.linear_param_bits(d_in, d_out, 12, b, bits, comp)
                assert got == rf.linear_param_bits(d_in, d_out, 12, a, bits,
                                                   comp)
                assert isinstance(got, int)
