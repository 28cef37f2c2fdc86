"""The MoE family (dbrx-132b, arctic-480b) in the port against the reference,
at smoke size (2 layers, d_model 64; dbrx 4 experts top-2, arctic 8 experts
top-2 plus its parallel dense FFN), float32, with the reference's params
bridged over: ``moe_ffn`` (router, capacity dispatch, combine; dense,
factorized and compressed experts), the model's logits on every column the
reference computes (the mixed step's columns ``j >= n_new``, idle decode
rows and prefill pad rows included), and the mixed kernel's all-columns
mode on the card (the engines: ``tests/test_torch_moe_engine.py``).

Capacity: the smoke configs never drop a claim (dbrx's capacity factor 2.0
gives ``C = T``; arctic's 8.0 more), so every case that claims to cover
drops replaces it with the published 1.25 and asserts that a claim was
dropped (the port's own ``router_counts``).

Tolerances, each with its reason: ``moe_ffn``'s output 1e-5 x max(1, max
|ref|) (the same f32 products, another reduction order), its aux loss
1e-6 (an f32 mean over T x E terms), positions and keep flags exact;
logits 1e-4 (``ATOL_LOGITS``: the order compounds over 2 layers and the LM
head); attention 1e-5 (``ATOL_ATTN``); tokens and host counters exact.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_parity as tp  # noqa: E402

tp.tf32_off()

ARCHS = ("dbrx-132b", "arctic-480b")
FCFG = tp.MOE_FCFG


# ---- moe_ffn ----------------------------------------------------------------

def _layer0(tree):
    return {k: _layer0(v) if isinstance(v, dict) else v[0]
            for k, v in tree.items()}


def _skewed_tokens(router, T, seed):
    """(1, T, d) f32 tokens leaning towards expert 0 (a unit step along the
    router's first column, ten norms long): routing piles onto one expert,
    so a binding capacity drops claims at every T."""
    rng = np.random.default_rng(seed)
    d = router.shape[0]
    u = router[:, 0] / np.linalg.norm(router[:, 0])
    x = rng.standard_normal((1, T, d)) + 10.0 * u
    return x.astype(np.float32)


@pytest.mark.parametrize("T", [3, 8, 64])
@pytest.mark.parametrize("capacity", ["smoke", "binding"])
@pytest.mark.parametrize("fmt", ["dense", "factorized", "compressed"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_matches_reference(arch, fmt, capacity, T):
    """``moe_ffn`` on layer 0's experts against the reference's
    ``moe_ffn(mesh=None)``: y within 1e-5 x max(1, max |ref|), aux within
    1e-6, and the dispatch's (pos, keep) equal to the reference's
    ``_dispatch``; with the smoke capacity nothing is dropped, with the
    published one something is."""
    import jax.numpy as jnp
    from repro.models import moe as JMoE
    from repro_torch.models import moe as TMoE
    jm, jp, tm, tparams = tp.moe_pair(arch, fmt, None if capacity == "smoke"
                                      else tp.MOE_CF)
    cfg = jm.cfg
    jl = _layer0(jp["layers"]["moe"])
    tl = _layer0(tparams["layers"]["moe"])
    x = _skewed_tokens(np.asarray(jl["router"]), T, seed=T)
    y, aux = JMoE.moe_ffn(jl, jnp.asarray(x), cfg=cfg, dicts=jp.get("dicts"))
    TMoE.reset_router_counts()
    ty, taux = TMoE.moe_ffn(tl, tp.t(x), cfg=tm.cfg,
                            dicts=tparams.get("dicts"))
    y = np.asarray(y)
    np.testing.assert_allclose(ty.numpy(), y, rtol=0,
                               atol=1e-5 * max(1.0, np.abs(y).max()))
    assert abs(float(aux) - taux.item()) <= 1e-6
    m = cfg.moe
    tok = jnp.asarray(x.reshape(T, -1))
    gates, eidx, _ = JMoE._router(tok, jl["router"], m)
    C = JMoE._capacity(T, m.top_k, m.n_experts, m.capacity_factor)
    _, pos, keep = JMoE._dispatch(tok, gates, eidx, m.n_experts, C)
    _, teidx, _ = TMoE._router(tp.t(x.reshape(T, -1)), tl["router"],
                               m.top_k)
    assert TMoE._capacity(T, m.top_k, m.n_experts, m.capacity_factor) == C
    _, tpos, tkeep = TMoE._dispatch(tp.t(x.reshape(T, -1)), teidx,
                                    m.n_experts, C)
    np.testing.assert_array_equal(teidx.numpy(), np.asarray(eidx))
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(pos))
    np.testing.assert_array_equal(tkeep.numpy(), np.asarray(keep))
    counts = TMoE.router_counts()
    assert counts == {"claims": T * m.top_k,
                      "dropped": int((~tkeep).sum())}
    assert (counts["dropped"] > 0) == (capacity == "binding"), counts


def test_top_k_breaks_ties_as_the_reference():
    """Equal probabilities: ``lax.top_k`` takes the lower expert index
    first, and so does the port's router (``torch.topk`` promises no
    order)."""
    import jax
    import jax.numpy as jnp
    from repro_torch.models.moe import _top_k
    probs = np.array([[0.25, 0.25, 0.25, 0.25],
                      [0.1, 0.3, 0.3, 0.3],
                      [0.4, 0.1, 0.4, 0.1],
                      [0.0, 0.5, 0.0, 0.5]], np.float32)
    for k in (1, 2, 3):
        jv, ji = jax.lax.top_k(jnp.asarray(probs), k)
        tv, ti = _top_k(tp.t(probs), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


# ---- layers and params ---------------------------------------------------------

@pytest.mark.parametrize("window", [None, 8])
def test_flash_attention_pad_rows_match_reference(window):
    """Rows with no visible key (segment id 0: a prefill sweep's pad rows
    and columns) get what the reference's online softmax gives them — the
    values of the key chunks they visit over the chunks' padded count
    (here 20 keys in chunks of 16, so the count is 32) — and live rows are
    unchanged."""
    import jax.numpy as jnp
    from repro.models import layers as JL
    from repro_torch.models import layers as L
    rng = np.random.default_rng(0)
    B, S, Hq, Hkv, D = 3, 20, 4, 2, 16
    q, k, v = (rng.standard_normal((B, S, h, D)).astype(np.float32)
               for h in (Hq, Hkv, Hkv))
    seg = np.ones((B, S), np.int32)
    seg[0, 13:] = 0           # a packed row's pad tail
    seg[1, :] = 0             # a whole pad row
    seg[2, 7:] = 2            # a second segment
    want = np.asarray(JL.flash_attention(
        *map(jnp.asarray, (q, k, v)), window=window, chunk=16,
        seg_q=jnp.asarray(seg), seg_kv=jnp.asarray(seg)))
    got = L.flash_attention(*map(tp.t, (q, k, v)), window=window, chunk=16,
                            seg_q=tp.t(seg), seg_kv=tp.t(seg)).numpy()
    np.testing.assert_allclose(got, want, atol=tp.ATOL_ATTN, rtol=0)
    # the old convention (the mean of v over the 20 keys) misses it
    mean = v.mean(1)[1][None, :, None, :]  # (1, Hkv, 1, D)
    assert np.abs(mean - want[1].reshape(S, Hkv, Hq // Hkv, D)).max() > 1e-3


def test_dense_ffn_prefix_and_width_match_reference():
    """arctic's parallel dense FFN: ``init_ffn(prefix="densefn",
    d_ff=d_ff_dense)`` is factorized through the ``densefn_*``
    dictionaries at its own width, and ``ffn_block(prefix=...)`` reads
    them."""
    import jax
    import jax.numpy as jnp
    from repro.core.factorized import DictionaryBank as JBank
    from repro.core.factorized import FactorizationConfig as JF
    from repro.models import layers as JL
    from repro_torch.core.factorized import DictionaryBank, \
        FactorizationConfig
    from repro_torch.models import layers as L
    from repro_torch.models.bridge import params_from_numpy
    from repro.configs import get_config as jget
    from repro_torch.configs import get_config
    jcfg = jget("arctic-480b", "smoke", dtype="float32",
                factorization=JF(**FCFG))
    cfg = get_config("arctic-480b", "smoke", dtype="float32",
                     factorization=FactorizationConfig(**FCFG))
    bank = JBank(jcfg.factorization, jcfg.params_dtype)
    jp = JL.init_ffn(jax.random.key(1), jcfg, bank,
                     d_ff=jcfg.moe.d_ff_dense, prefix="densefn")
    mine_bank = DictionaryBank(cfg.factorization)
    mine = L.init_ffn(torch.Generator().manual_seed(1), cfg, mine_bank,
                      prefix="densefn", d_ff=cfg.moe.d_ff_dense)
    assert sorted(bank.dicts) == sorted(mine_bank.dicts) == [
        "densefn_down", "densefn_gate", "densefn_up"]
    assert {k: tuple(v["wd"].shape) for k, v in mine.items()} == \
        {k: tuple(v["wd"].shape) for k, v in jp.items()}
    x = np.random.default_rng(2).standard_normal((2, 5, 64)).astype(
        np.float32)
    want = JL.ffn_block(jp, jnp.asarray(x), cfg=jcfg, dicts=bank.dicts,
                        prefix="densefn")
    got = L.ffn_block(params_from_numpy(tp.to_numpy_tree(jp), "cpu"),
                      tp.t(x), cfg=cfg, dicts=params_from_numpy(
                          tp.to_numpy_tree(bank.dicts), "cpu"),
                      prefix="densefn")
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=tp.ATOL_LAYER, rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_layout_and_counts_match_reference(arch):
    """The bridge hands a reference ``Model.init`` tree and its
    ``compress_params`` tree over unchanged, leaf for leaf ((L, E, ...)
    expert stacks, the shared ``moe_*`` and ``densefn_*`` dictionaries);
    the port's own ``init`` draws the reference's layout; ``n_params`` and
    ``n_active_params`` equal the reference's at both sizes."""
    import jax
    from repro.configs import get_config as jget
    from repro_torch.configs import get_config
    for fmt in ("dense", "factorized", "compressed"):
        jm, jp, tm, tparams = tp.moe_pair(arch, fmt)
        ref = tp.to_numpy_tree(jp)

        def same(a, b):
            assert a.keys() == b.keys()
            for k in a:
                if isinstance(a[k], dict):
                    same(a[k], b[k])
                else:
                    assert tuple(a[k].shape) == b[k].shape, k
                    np.testing.assert_array_equal(a[k].numpy(), b[k])
        same(tparams, ref)
        if fmt != "compressed":
            mine = tm.init(seed=0)
            shapes = jax.tree.map(lambda a: tuple(a.shape), jp)
            assert jax.tree.map(lambda a: tuple(a.shape), mine) == shapes
    assert ("dense_ffn" in tparams["layers"]) == (arch == "arctic-480b")
    for variant in ("smoke", "full"):
        a, b = get_config(arch, variant), jget(arch, variant)
        assert a.n_params() == b.n_params()
        assert a.n_active_params() == b.n_active_params()


# ---- model level --------------------------------------------------------------

PS, NPG, B, S = 8, 3, 4, 6
W = PS * NPG


def _steps(arch, fmt, mode, step, ci, nn, active, seed):
    import jax.numpy as jnp
    from repro_torch.models import moe as TMoE
    jm, jp, tm, tparams = tp.moe_pair(arch, fmt)
    cfg = jm.cfg
    rng = np.random.default_rng(seed)
    P = B * NPG + 2
    bt = rng.permutation(P)[:B * NPG].reshape(B, NPG).astype(np.int32)
    shape = (cfg.n_layers, P, PS, cfg.kv_heads, cfg.head_dim)
    k, v = (rng.standard_normal(shape).astype(np.float32) for _ in "kv")
    width = 1 if step == "decode" else S
    toks = rng.integers(0, cfg.vocab_size, size=(B, width)).astype(np.int32)
    jmodel, tmodel = jm.with_decode_attn(mode), tm.with_decode_attn(mode)
    jpages = {"bt": jnp.asarray(bt), "width": W, "page_size": PS}
    tpages = {"bt": tp.t(bt), "width": W, "page_size": PS}
    jc = {"k": jnp.asarray(k), "v": jnp.asarray(v)}
    tc = {"k": tp.t(k), "v": tp.t(v)}
    TMoE.reset_router_counts()
    if step == "decode":
        jl, jc = jmodel.decode_step(jp, {"inputs": jnp.asarray(toks)}, jc,
                                    jnp.asarray(ci),
                                    slot_mask=jnp.asarray(active),
                                    pages=jpages)
        tl, tc = tmodel.decode_step(tparams, {"inputs": tp.t(toks)}, tc,
                                    tp.t(ci), slot_mask=tp.t(active),
                                    pages=tpages)
    else:
        jl, jc = jmodel.mixed_step(jp, {"inputs": jnp.asarray(toks)}, jc,
                                   jnp.asarray(ci), jnp.asarray(nn),
                                   slot_mask=jnp.asarray(active),
                                   pages=jpages)
        tl, tc = tmodel.mixed_step(tparams, {"inputs": tp.t(toks)}, tc,
                                   tp.t(ci), tp.t(nn),
                                   slot_mask=tp.t(active), pages=tpages)
    return np.asarray(jl), tl.numpy(), TMoE.router_counts()["dropped"]


@pytest.mark.parametrize("fmt", ["dense", "compressed"])
@pytest.mark.parametrize("arch", ARCHS)
def test_model_logits_every_column_match_reference(arch, fmt):
    """At the published capacity factor: ``apply`` over two rows of 20;
    then, with the dense and the kernel (``tda``) attention, ``decode_step``
    over paged lanes with an idle slot (its row attends nothing: the dense
    path's uniform average, the kernel path's zeros, as in the reference)
    and ``mixed_step`` with a chunk row, a decode row (five columns past
    ``n_new``), an inert row and a row whose chunk was deferred (``n_new``
    0 on a resident lane). Logits on every row and column, those the
    engine ignores included, within ATOL_LOGITS of the reference's
    (``tda``: its Pallas kernels in interpret mode); claims dropped in
    ``apply``, in the mixed steps and in at least one decode step (8 claims
    for a capacity of 3 a expert: whether one drops varies by step)."""
    import jax.numpy as jnp
    from repro_torch.models import moe as TMoE
    jm, jp, tm, tparams = tp.moe_pair(arch, fmt)
    toks = np.random.default_rng(3).integers(
        0, 256, size=(2, 20)).astype(np.int32)
    TMoE.reset_router_counts()
    want = np.asarray(jm.apply(jp, {"inputs": jnp.asarray(toks)})[0])
    got, _ = tm.apply(tparams, {"inputs": tp.t(toks)})
    np.testing.assert_allclose(got.numpy(), want, atol=tp.ATOL_LOGITS,
                               rtol=0)
    assert TMoE.router_counts()["dropped"] > 0
    active = np.array([True, True, False, True])
    decode_drops = 0
    for mode, seed in (("dense", 5), ("tda", 3)):
        ci = np.array([3, 15, 0, 20], np.int32)
        jl, tl, dropped = _steps(arch, fmt, mode, "decode", ci, None,
                                 active, seed)
        np.testing.assert_allclose(tl, jl, atol=tp.ATOL_LOGITS, rtol=0)
        decode_drops += dropped
        ci = np.array([5, 14, 9, 11], np.int32)
        nn = np.array([4, 1, 3, 0], np.int32)
        jl, tl, dropped = _steps(arch, fmt, mode, "mixed", ci, nn, active,
                                 1)
        np.testing.assert_allclose(tl, jl, atol=tp.ATOL_LOGITS, rtol=0)
        assert dropped > 0
    assert decode_drops > 0


def test_mixed_wrapper_all_columns_on_the_cpu():
    """On the CPU the mixed wrapper gives the plain version's values in
    every column in both modes and counts no launch."""
    from repro_torch.kernels.tda import tda
    from repro_torch.kernels.tda.ops import fused_mixed_attention
    from repro_torch.kernels.tda.ref import mixed_attention_reference
    from repro_torch.kernels.tda.ops import gather_paged_lanes as gather
    q, k, v, kr, vr, bounds, bt, ring = _mixed_case(2, 16, 8, 0)
    tda.reset_launch_counts()
    args = [tp.t(a) for a in (q, k, v, kr, vr)]
    want = mixed_attention_reference(
        args[0], gather(args[1], tp.t(bt)), gather(args[2], tp.t(bt)),
        args[3], args[4], tp.t(bounds[:, 0]), tp.t(bounds[:, 1]), ring=ring)
    for mode in (False, True):
        got = fused_mixed_attention(*args, tp.t(bounds[:, 0]),
                                    tp.t(bounds[:, 1]), block_table=tp.t(bt),
                                    ring=ring, all_columns=mode)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert tda.MODE_LAUNCHES == {"tda_mixed_attention.all_columns": 0}
    assert sum(tda.VARIANT_LAUNCHES.values()) == 0


def test_refusals_name_their_items():
    """The MoE family constructs; compressed experts on a mesh of two
    ranks stay refused with the reference's message (item 11 serves the
    rest on a mesh) and an encoder-decoder in ``Model`` names its item
    (12c) and ``EncDecModel``; learned positions construct (item 12c), as
    do the families of items 10b and 10c."""
    from repro_torch.configs import get_config
    from repro_torch.core.errors import UnsupportedConfigError
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.transformer import Model
    from repro_torch.serve import Engine, EngineConfig
    for arch in ARCHS:
        for variant in ("smoke", "full"):
            Model(get_config(arch, variant), device="cpu")
    m = Model(get_config("dbrx-132b", "smoke", dtype="float32",
                         weight_format="compressed"), device="cpu")
    mesh = Mesh({"data": 1, "model": 2}, {"data": 0, "model": 0}, {},
                torch.device("cpu"))
    with pytest.raises(UnsupportedConfigError,
                       match="compressed MoE expert weights"):
        Engine(m, None, config=EngineConfig(max_len=16), mesh=mesh)
    with pytest.raises(UnsupportedConfigError, match="EncDecModel.*item 12"):
        Model(get_config("dbrx-132b", "smoke", n_encoder_layers=2),
              device="cpu")
    Model(get_config("dbrx-132b", "smoke", learned_pos=True), device="cpu")
    for arch in ("mamba2-370m", "recurrentgemma-2b",
                 "llava-next-mistral-7b", "musicgen-large"):
        Model(get_config(arch, "smoke"), device="cpu")


# ---- the mixed kernel's all-columns mode on the card ---------------------------

def _mixed_case(G, Dh, ps, seed):
    """Rows (ci, n_new): dead, a fresh chunk, a decode row, an inert row
    on a resident lane, a full chunk over a resident lane, a short chunk
    mid-lane; S 20 columns."""
    rng = np.random.default_rng(seed)
    n, Sc, Bc, Hkv = 3, 20, 6, 2
    Wc = n * ps
    k, v, bt, _ = tp.paged_pool(rng, B=Bc, Hkv=Hkv, D=Dh, ps=ps, n=n,
                                free_tail=False)
    bounds = np.array([(0, 0), (0, Sc), (Wc // 2, 1), (Wc // 3, 0),
                       (Wc - Sc, Sc), (ps + 2, 7)], np.int32)
    q = rng.standard_normal((Bc, Sc, G * Hkv, Dh)).astype(np.float32)
    kr = rng.standard_normal((Bc, Sc, Hkv, Dh)).astype(np.float32)
    vr = rng.standard_normal((Bc, Sc, Hkv, Dh)).astype(np.float32)
    return q, k, v, kr, vr, bounds, bt, Wc


@pytest.mark.gpu
def test_cuda_mixed_kernel_all_columns():
    """The mixed kernel's all-columns mode (both bodies: f32 and the bf16
    tensor-core one; fp and int8 pools; exact and LUT exp; with and
    without a window) against its plain versions on every column that has
    a key (1e-3 exact, 1e-5 LUT), exact zeros on columns with none; the
    skip mode unchanged (zeros past n_new); the launches counted by mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from repro_torch.kernels.afu.ref import exp_lut_table
    from repro_torch.kernels.tda import tda
    from repro_torch.kernels.tda.ops import gather_paged_lanes as gather
    from repro_torch.kernels.tda.ref import (_mixed_masks,
                                             mixed_attention_lut,
                                             mixed_attention_reference)
    from repro_torch.models.layers import kv_quantize
    dev = torch.device("cuda")
    table = exp_lut_table(dev)
    tda.reset_launch_counts()
    n_all = 0
    for i, (G, Dh, ps) in enumerate([(6, 128, 16), (2, 16, 8), (1, 72, 16),
                                     (8, 20, 8)]):
        q, k, v, kr, vr, bounds, bt, ring = _mixed_case(G, Dh, ps, 40 + i)
        tb, tt = tp.t(bounds, dev), tp.t(bt, dev)
        live = torch.arange(q.shape[1], device=dev)[None] < tb[:, 1:]
        for dt in (torch.float32, torch.bfloat16):
            tq, tk, tv, tkr, tvr = (tp.t(a, dev, dt) for a in (q, k, v, kr,
                                                               vr))
            kq, ks = kv_quantize(tp.t(k, dev))
            vq, vs = kv_quantize(tp.t(v, dev))
            for window in (None, 9):
                cv, rv = _mixed_masks(tb[:, :1].long(), tb[:, 1:].long(),
                                      q.shape[1], bt.shape[1] * ps, ring,
                                      window)
                has_key = (cv.any(-1) | rv.any(-1))
                for pool in ((tk, tv, None, None), (kq, vq, ks, vs)):
                    sc = {"k_scale": None if pool[2] is None
                          else gather(pool[2], tt),
                          "v_scale": None if pool[3] is None
                          else gather(pool[3], tt)}
                    lanes = (tq, gather(pool[0], tt), gather(pool[1], tt),
                             tkr, tvr, tb[:, 0], tb[:, 1])
                    for lut in (False, True):
                        want = (mixed_attention_lut(
                            *lanes, page_size=ps, ring=ring, window=window,
                            table=table, **sc) if lut else
                            mixed_attention_reference(
                                *lanes, ring=ring, window=window, **sc))
                        for mode, cols in ((True, has_key), (False, live)):
                            got = tda.tda_mixed_attention(
                                tq, *pool[:2], tkr, tvr, tb, tt, *pool[2:],
                                table if lut else None, ring=ring,
                                window=window, all_columns=mode)
                            n_all += mode
                            err = (got - want)[cols].abs().max().item()
                            assert err <= (1e-5 if lut else 1e-3), \
                                (G, Dh, ps, dt, window, lut, mode, err)
                            assert not got[~cols].any()
    assert tda.MODE_LAUNCHES["tda_mixed_attention.all_columns"] == n_all
