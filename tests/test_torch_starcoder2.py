"""starcoder2 in the port against the reference, at smoke size (2 layers,
d_model 64, 4 q / 2 kv heads of 16, window 32), float32, with the
reference's ``Model.init`` params bridged over: LayerNorm with bias, the
tanh GELU and GeGLU FFNs, sliding-window ring lanes in the model (prefill
into canonical ring phase, decode past the window, int8 ring lanes), the
slot table's ring-phase lane gather and the pool's ring class, both
engines (mixed and phase-serialized, paged and contiguous) with prompts
past the window, copy-on-write when a ring lane wraps into a shared page,
compressed starcoder2, and the decode attention at GQA groups above 8.

Tolerances, each with its reason: layers 1e-5 (``ATOL_LAYER``: the same
f32 formulas, another reduction order); logits 1e-4 (``ATOL_LOGITS``: the
order compounds over 2 layers and the LM head); attention 1e-5
(``ATOL_ATTN``); lane gathers, tokens and host counters exact.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_parity as tp  # noqa: E402

tp.tf32_off()

ARCH = "starcoder2-15b"
WINDOW = 32  # the smoke config's sliding window


@pytest.fixture(scope="module")
def sc2():
    cfg, jm, jp = tp.jax_smoke(ARCH)
    tm, tparams = tp.torch_smoke(ARCH, jp)
    assert cfg.sliding_window == WINDOW and cfg.norm == "layernorm" \
        and cfg.act == "gelu"
    return cfg, jm, jp, tm, tparams


# ---- layers ---------------------------------------------------------------

def test_layernorm_matches_reference():
    import jax.numpy as jnp
    from repro.configs import get_config as jget
    from repro.models import layers as JL
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32) * 3 + 1
    p = {"scale": rng.standard_normal(64).astype(np.float32),
         "bias": rng.standard_normal(64).astype(np.float32)}
    want = JL.apply_norm({k: jnp.asarray(v) for k, v in p.items()},
                         jnp.asarray(x))
    got = L.apply_norm({k: tp.t(v) for k, v in p.items()}, tp.t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=tp.ATOL_LAYER)
    # init: a zero bias beside the unit scale, as the reference's init_norm
    cfg = get_config(ARCH, "smoke")
    jp = JL.init_norm(jget(ARCH, "smoke"))
    tpn = L.init_norm(cfg, (), tp.CPU)
    assert sorted(tpn) == sorted(jp) == ["bias", "scale"]
    for k in jp:
        np.testing.assert_array_equal(tpn[k].numpy(), np.asarray(jp[k]))


@pytest.mark.parametrize("act", ["gelu", "geglu"])
def test_ffn_matches_reference(act):
    """The reference's GELU FFN branches (``jax.nn.gelu`` is the tanh
    approximation; SwiGLU is ``test_torch_layers.py``'s), on its own
    ``init_ffn`` weights: ``gelu`` has no ``w_gate``."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jget
    from repro.models import layers as JL
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    from repro_torch.models.bridge import params_from_numpy
    jcfg = jget(ARCH, "smoke", dtype="float32", act=act)
    jp = JL.init_ffn(jax.random.key(3), jcfg, None)
    assert ("w_gate" in jp) == (act != "gelu")
    x = np.random.default_rng(1).standard_normal((2, 7, 64)).astype(
        np.float32)
    want = JL.ffn_block(jp, jnp.asarray(x), cfg=jcfg, dicts=None)
    got = L.ffn_block(params_from_numpy(tp.to_numpy_tree(jp), "cpu"),
                      tp.t(x), cfg=get_config(ARCH, "smoke", dtype="float32",
                                              act=act))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=tp.ATOL_LAYER)


# ---- model ----------------------------------------------------------------

def test_init_layout_matches_reference(sc2):
    """``Model.init``: the reference's tree (LayerNorm biases, no
    ``w_gate``), stacked over layers, zero norm biases."""
    import jax
    cfg, jm, jp, tm, _ = sc2
    mine = tm.init(seed=0)
    ref = jax.tree.map(lambda a: tuple(a.shape), jp)

    def shapes(t):
        return {k: shapes(v) if isinstance(v, dict) else tuple(v.shape)
                for k, v in t.items()}

    assert shapes(mine) == ref
    assert not mine["layers"]["norm1"]["bias"].any()


def test_logits_match_reference_past_window(sc2):
    """``apply`` over 40 tokens (past the window), ``prefill`` of 36 into
    ring caches of 32 (canonical ring phase: the same cache as the
    reference's ``ring_layout``), then ``decode_step`` to position 39: each
    within ATOL_LOGITS of the reference's, and decode equal to the full
    forward's last positions (the reference's
    ``test_decode_matches_full_forward`` past the window)."""
    import jax.numpy as jnp
    cfg, jm, jp, tm, tparams = sc2
    B, S, P = 2, 40, 36
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    full = np.asarray(jm.apply(jp, {"inputs": jnp.asarray(toks)})[0])
    got, _ = tm.apply(tparams, {"inputs": tp.t(toks)})
    np.testing.assert_allclose(got.numpy(), full, atol=tp.ATOL_LOGITS)
    _, jc = jm.prefill(jp, {"inputs": jnp.asarray(toks[:, :P])},
                       max_len=S + 8)
    _, tc = tm.prefill(tparams, {"inputs": tp.t(toks[:, :P])},
                       max_len=S + 8)
    assert tuple(tc["k"].shape) == tuple(jc["k"].shape) \
        == (cfg.n_layers, B, WINDOW, cfg.kv_heads, cfg.head_dim)
    for name in jc:
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   atol=tp.ATOL_POOL)
    for i in range(P, S):
        jl, jc = jm.decode_step(jp, {"inputs": jnp.asarray(toks[:, i:i + 1])},
                                jc, jnp.int32(i))
        tl, tc = tm.decode_step(tparams, {"inputs": tp.t(toks[:, i:i + 1])},
                                tc, torch.tensor(i))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=tp.ATOL_LOGITS)
        np.testing.assert_allclose(tl[:, 0].numpy(), full[:, i],
                                   atol=tp.ATOL_LOGITS)


def test_int8_ring_lanes_match_reference():
    """The reference's ``test_int8_kv_decode_close_to_full`` on starcoder2
    (int8 ring lanes, prompt past the window): the port's int8 caches equal
    the reference's codes, and its decode logits match the reference's and
    stay within the reference test's 5 % of the full forward."""
    import jax.numpy as jnp
    cfg, jm, jp = tp.jax_smoke(ARCH, kv_quant=True)
    tm, tparams = tp.torch_smoke(ARCH, jp, kv_quant=True)
    B, S = 2, 40
    toks = np.random.default_rng(2).integers(
        0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    full = np.asarray(jm.apply(jp, {"inputs": jnp.asarray(toks)})[0])
    _, jc = jm.prefill(jp, {"inputs": jnp.asarray(toks[:, :S - 1])},
                       max_len=S + 4)
    _, tc = tm.prefill(tparams, {"inputs": tp.t(toks[:, :S - 1])},
                       max_len=S + 4)
    assert tc["k"].dtype == torch.int8 and "k_scale" in tc
    for name in ("k", "v"):
        assert (tc[name].numpy().astype(np.int32)
                - np.asarray(jc[name]).astype(np.int32)).__abs__().max() <= 1
    jl, _ = jm.decode_step(jp, {"inputs": jnp.asarray(toks[:, S - 1:])}, jc,
                           jnp.int32(S - 1))
    tl, _ = tm.decode_step(tparams, {"inputs": tp.t(toks[:, S - 1:])}, tc,
                           torch.tensor(S - 1))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-3)
    a, b = full[:, -1], tl[:, 0].numpy()
    assert np.abs(a - b).max() / np.abs(a).max() < 0.05


# ---- lanes and pool ---------------------------------------------------------

@pytest.mark.parametrize("page_size", [None, 8])
def test_gather_lanes_matches_reference(sc2, page_size):
    """``SlotKVCache._gather_lanes`` in canonical ring phase, byte for byte:
    segments shorter than, equal to and longer than the ring, from packed
    rows, with and without a destination offset; and the lane widths and
    pool classes of both slot tables."""
    import jax.numpy as jnp
    from repro.serve.kv_slots import SlotKVCache as JSlots
    from repro_torch.serve.kv_slots import SlotKVCache
    cfg, jm, jp, tm, _ = sc2
    cache_len = 80
    js = JSlots(jm, 4, cache_len, page_size=page_size)
    ts = SlotKVCache(tm, 4, cache_len, page_size=page_size)
    assert ts.widths == {"k": WINDOW, "v": WINDOW} == js.widths
    if page_size:
        assert sorted(ts.pool.classes) == sorted(js.pool.classes) == [WINDOW]
        assert tuple(ts.caches["k"].shape) == tuple(js.caches["k"].shape)
    src = np.random.default_rng(4).standard_normal(
        (cfg.n_layers, 3, 72, cfg.kv_heads, cfg.head_dim)).astype(np.float32)
    rows, starts = [0, 1, 2, 2, 1], [0, 3, 0, 40, 0]
    lengths, offs = [10, 32, 33, 31, 70], [0, 0, 0, 0, 0]
    out_w = 40 if page_size else WINDOW
    for offs in (offs, [0, 8, 0, 0, 0]):
        args = [np.asarray(a, np.int32) for a in (rows, starts, lengths, offs)]
        want, wv = js._gather_lanes(jnp.asarray(src), *map(jnp.asarray,
                                                           args[:3]),
                                    WINDOW, out_w, jnp.float32,
                                    jnp.asarray(args[3]))
        got, gv = ts._gather_lanes(tp.t(src), *(tp.t(a).long()
                                                for a in args[:3]),
                                   WINDOW, out_w, tp.t(args[3]).long())
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_page_pool_ring_class_wraps():
    """The reference's ``test_page_pool_ring_class_wraps``: a ring class
    never needs more than its own pages and ``ensure_write`` wraps."""
    from repro_torch.serve.pages import PagePool
    pool = PagePool([32], num_slots=2, page_size=16, device="cpu")
    pool.alloc_prefix(0, 32)
    assert pool.pages_in_use() == 2
    assert pool.ensure_write(0, 40)  # 40 % 32 = 8: page 0, resident
    assert pool.pages_in_use() == 2
    assert pool.class_needs(100) == {32: 2}
    pool.check_invariants()


# ---- engines ----------------------------------------------------------------

# Host counters held to the reference Engine's: every key of decode_stats
# but wall-clock timings.
_TIMED = ("step_ms", "ttft")
LENGTHS = [3, 11, 25, 7, 40, 45, 33]
BUDGETS = [4, 2, 12, 3, 6, 9, 5]


def _stats(eng):
    return {k: v for k, v in eng.decode_stats.items() if k not in _TIMED}


@pytest.mark.parametrize("kw", [
    {},  # mixed, paged, sharing on (the default EngineConfig)
    {"page_size": 8, "prefill_budget": 5},
    {"page_size": 8, "pool_frac": 0.5},  # preempts
    {"mixed": False},  # serialized, paged
    {"mixed": False, "paged": False},  # serialized, contiguous
], ids=["mixed", "mixed_budget", "mixed_cut_pool", "serialized_paged",
        "serialized_contiguous"])
def test_engines_match_reference_past_window(sc2, kw):
    """Prompts shorter than, at and past the window of 32 (up to 45
    tokens, decoding to 54): tokens, statuses and every host counter of
    decode_stats equal the reference Engine's."""
    cfg, jm, jp, tm, tparams = sc2
    prompts = tp.prompts(cfg.vocab_size, LENGTHS)
    rnd = [[(i, p, b) for i, (p, b) in enumerate(zip(prompts, BUDGETS))]]
    ekw = dict(max_len=16, max_new_tokens=12, num_slots=3, max_prompt_len=48,
               **kw)
    want, _, jeng = tp.serve_rounds("repro", jm, jp, rnd, **ekw)
    got, _, eng = tp.serve_rounds("repro_torch", tm, tparams, rnd, **ekw)
    assert got == want
    assert all(s == "ok" for _, s in got.values())
    assert _stats(eng) == _stats(jeng)
    if kw.get("pool_frac"):
        assert eng.decode_stats["preemptions"] > 0


@pytest.mark.parametrize("sample_kw", [{}, dict(temperature=0.8, top_k=12,
                                                seed=7)],
                         ids=["greedy", "sampled"])
@pytest.mark.parametrize("layout", ["cut_pool", "late_arrival"])
def test_ring_cow_past_window_matches_reference(sc2, sample_kw, layout):
    """The reference's ``test_ring_cow_past_window_matches_contiguous``:
    two requests share a 16-token prefix and decode past the window, so
    their write pointers wrap into the shared pages. ``cut_pool`` is the
    reference's case (a pool of 0.75: the second request is admitted only
    because its reservation discounts its hits, and the wrap's copy finds
    the pool dry and preempts it); ``late_arrival`` gives the pool its
    full size and lets the second request arrive once the first has
    published, so the wrap copies the shared page with both sharers alive.
    Tokens equal the reference Engine's and the port's contiguous run's,
    and so do the host counters; the prefix is shared."""
    cfg, jm, jp, tm, tparams = sc2
    rng = np.random.default_rng(0)
    pre = rng.integers(0, cfg.vocab_size, size=16).astype(np.int32)
    A = np.concatenate([pre, rng.integers(0, cfg.vocab_size, size=8)
                        ]).astype(np.int32)
    B = np.concatenate([pre, rng.integers(0, cfg.vocab_size, size=6)
                        ]).astype(np.int32)
    kw = dict(max_len=32, max_new_tokens=12, num_slots=2, **sample_kw)
    if layout == "cut_pool":
        rnd = [[(0, A, 12), (1, B, 12)]]
        paged = dict(page_size=8, pool_frac=0.75, **kw)
    else:
        rnd = [[(0, A, 12), (2, (1, B, 12))]]
        paged = dict(page_size=8, **kw)
    contiguous, _, _ = tp.serve_rounds("repro_torch", tm, tparams, rnd,
                                       paged=False, **kw)
    want, _, jeng = tp.serve_rounds("repro", jm, jp, rnd, **paged)
    got, _, eng = tp.serve_rounds("repro_torch", tm, tparams, rnd, **paged)
    assert got == want == contiguous
    assert eng.decode_stats["prefix_hit_ratio"] > 0
    assert _stats(eng) == _stats(jeng)
    if layout == "cut_pool":
        assert eng.decode_stats["preemptions"] > 0
    else:
        assert eng.slots.pages_copied > 0


def test_wrapped_ring_prompt_neither_shares_nor_publishes(sc2):
    """A prompt longer than its ring is not a function of its prefix: a
    repeat of it hits nothing (the reference's probe refuses it too), while
    a repeat of a prompt inside the window does."""
    cfg, jm, jp, tm, tparams = sc2
    long_p, short_p = tp.prompts(cfg.vocab_size, [40, 24], seed=5)
    kw = dict(max_len=16, max_new_tokens=4, num_slots=2, max_prompt_len=48,
              page_size=8)
    rounds = [[(0, long_p, 4)], [(1, long_p, 4)], [(2, short_p, 4)],
              [(3, short_p, 4)]]
    want, wst, _ = tp.serve_rounds("repro", jm, jp, rounds, **kw)
    got, gst, _ = tp.serve_rounds("repro_torch", tm, tparams, rounds, **kw)
    assert got == want and gst == wst
    assert [s["prefix_hit_ratio"] > 0 for s in gst] == [False, False, False,
                                                        True]


def test_check_supported_accepts_starcoder2():
    """starcoder2 smoke and full construct (so do the MoE family's, item
    10a, and since items 10b and 10c every other family's); learned
    positions construct since item 12c, and an encoder-decoder stays
    refused (``EncDecModel`` runs it, item 12c)."""
    from repro_torch.configs import get_config
    from repro_torch.core.errors import UnsupportedConfigError
    from repro_torch.models.transformer import Model, check_supported
    for variant in ("smoke", "full"):
        check_supported(get_config(ARCH, variant))
        Model(get_config(ARCH, variant), device="cpu")
    for arch in ("qwen2.5-32b", "yi-34b", "qwen1.5-4b"):
        check_supported(get_config(arch, "full"))
    check_supported(get_config(ARCH, "smoke", learned_pos=True))
    with pytest.raises(UnsupportedConfigError, match="item 12c"):
        check_supported(get_config(ARCH, "smoke", n_encoder_layers=2))
    for arch in ("dbrx-132b", "arctic-480b"):
        check_supported(get_config(arch, "smoke"))
    for arch in ("mamba2-370m", "recurrentgemma-2b",
                 "llava-next-mistral-7b", "musicgen-large"):
        check_supported(get_config(arch, "smoke"))


# ---- compressed starcoder2 ---------------------------------------------------

def test_compressed_starcoder2_matches_reference():
    """The reference's ``compress_params`` takes starcoder2 smoke
    (factorized, no ``w_gate``): the port's logits on the bridged streams
    equal the reference's compressed logits, through the DMM/SMM wrappers'
    plain versions and the decompress route."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jget
    from repro.core import factorized as rf
    from repro.models.transformer import Model as JM
    from repro_torch.configs import get_config as tget
    from repro_torch.core import factorized as tf
    from repro_torch.models.bridge import params_from_numpy
    from repro_torch.models.transformer import Model as TM

    def fcfg(mod):
        return mod.FactorizationConfig(enabled=True, min_dim=32, rank=32,
                                       nnz=8)

    jm = JM(jget(ARCH, "smoke", dtype="float32", factorization=fcfg(rf)))
    jp = rf.project_wd_leaves(jm.init(jax.random.key(0)), fcfg(rf))
    jmc, jcp, _ = jm.compress_params(jp)
    assert "w_gate" not in jcp["layers"]["ffn"]
    tm = TM(tget(ARCH, "smoke", dtype="float32", factorization=fcfg(tf)),
            device="cpu").with_weight_format("compressed")
    tcp = params_from_numpy(tp.to_numpy_tree(jcp), tp.CPU)
    toks = np.random.default_rng(3).integers(
        0, 256, size=(2, 40)).astype(np.int32)
    want = np.asarray(jmc.apply(jcp, {"inputs": jnp.asarray(toks)})[0])
    got, _ = tm.apply(tcp, {"inputs": tp.t(toks)})
    np.testing.assert_allclose(got.numpy(), want, atol=tp.ATOL_LOGITS)


# ---- decode attention at GQA groups above 8 ----------------------------------

@pytest.mark.parametrize("heads", [(48, 4), (40, 4), (10, 1)],
                         ids=["G12", "G10", "G10_one_kv_head"])
def test_decode_plain_versions_large_groups(heads):
    """The decode wrappers (their plain versions on the CPU) at G = 12
    (starcoder2-15b's 48 over 4) and G = 10 (recurrentgemma-2b's 10 over 1)
    against the reference's jnp oracle (``kernels/tda/ref.py``), paged and
    contiguous, over ring lanes whose bounds stop at the ring."""
    import jax.numpy as jnp
    from repro.kernels.tda.ref import decode_attention_reference as jref
    from repro_torch.kernels.tda import tda
    Hq, Hkv = heads
    rng = np.random.default_rng(Hq + Hkv)
    ps, n, B, D = 16, 4, 5, 32
    k, v, bt, _ = tp.paged_pool(rng, B=B, Hkv=Hkv, D=D, ps=ps, n=n,
                                free_tail=False)
    hi = np.array([0, 1, 17, 64, 63], np.int32)  # 64: a full ring lane
    bounds = np.stack([np.zeros_like(hi), hi], 1).astype(np.int32)
    q = rng.standard_normal((B, Hq, D)).astype(np.float32)
    lanes = [a[bt].reshape(B, n * ps, Hkv, D) for a in (k, v)]
    want = np.asarray(jref(jnp.asarray(q), *map(jnp.asarray, lanes),
                           jnp.asarray(hi)))
    live = hi > 0
    paged = tda.tda_paged_decode_attention(tp.t(q), tp.t(k), tp.t(v),
                                           tp.t(bounds), tp.t(bt)).numpy()
    contig = tda.tda_decode_attention(tp.t(q), *map(tp.t, lanes),
                                      tp.t(bounds)).numpy()
    for got in (paged, contig):
        np.testing.assert_allclose(got[live], want[live], atol=tp.ATOL_ATTN)
        assert not got[~live].any()


def test_mixed_plain_version_wrapping_ring_group_12():
    """The mixed step's plain version at G = 12 over a ring of 24 positions
    that wraps (chunks past the ring, inside the window and at it) against
    the reference's mixed oracle."""
    import jax.numpy as jnp
    from repro.kernels.tda.ref import mixed_attention_reference as jref
    from repro_torch.kernels.tda import tda
    rng = np.random.default_rng(12)
    Hq, Hkv, D, ps, n, S, B = 48, 4, 16, 8, 3, 10, 4
    ring = n * ps
    k, v, bt, _ = tp.paged_pool(rng, B=B, Hkv=Hkv, D=D, ps=ps, n=n,
                                free_tail=False)
    rows = np.array([(0, S), (20, S), (30, 7), (50, 1)], np.int32)
    q = rng.standard_normal((B, S, Hq, D)).astype(np.float32)
    kr = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    vr = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    lanes = [a[bt].reshape(B, ring, Hkv, D) for a in (k, v)]
    live = np.arange(S)[None] < rows[:, 1:]
    for window in (None, ring):
        want = np.asarray(jref(jnp.asarray(q), *map(jnp.asarray, lanes),
                               jnp.asarray(kr), jnp.asarray(vr),
                               jnp.asarray(rows[:, 0]),
                               jnp.asarray(rows[:, 1]), ring=ring,
                               window=window))
        got = tda.tda_mixed_attention(tp.t(q), tp.t(k), tp.t(v), tp.t(kr),
                                      tp.t(vr), tp.t(rows), tp.t(bt),
                                      ring=ring, window=window).numpy()
        np.testing.assert_allclose(got[live], want[live], atol=tp.ATOL_ATTN)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_decode_kernels_large_groups(dtype):
    """Both decode kernels at G = 10 and 12 (two group tiles of 5 and 6
    rows) against their plain versions on the card, fp and int8, on ring
    lanes of 128-token pages: max abs diff 1e-3 on attended rows, exact
    zeros elsewhere, the same bits from a second launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from repro_torch.kernels.tda import tda
    from repro_torch.kernels.tda.ops import gather_paged_lanes as gather
    from repro_torch.kernels.tda.ref import decode_attention_reference
    from repro_torch.models.layers import kv_quantize
    dev = torch.device("cuda")
    dt = getattr(torch, dtype)
    for Hq, Hkv in ((48, 4), (10, 1), (40, 4)):
        rng = np.random.default_rng(Hq)
        B, ps, n, D = 8, 128, 32, 128
        kf, vf, bt, _ = tp.paged_pool(rng, B=B, Hkv=Hkv, D=D, ps=ps, n=n,
                                      free_tail=False)
        hi = np.array([0, 1, 200, 4096, 4095, 2048, 64, 3000], np.int32)
        tb = tp.t(np.stack([np.zeros_like(hi), hi], 1).astype(np.int32), dev)
        tt = tp.t(bt, dev)
        q = tp.t(rng.standard_normal((B, Hq, D)).astype(np.float32), dev, dt)
        k, v = tp.t(kf, dev, dt), tp.t(vf, dev, dt)
        (kq, ks), (vq, vs) = kv_quantize(k.float()), kv_quantize(v.float())
        live = tb[:, 1] > 0
        for pool in ((k, v, None, None), (kq, vq, ks, vs)):
            lanes = [None if x is None else gather(x, tt) for x in pool]
            want = decode_attention_reference(
                q, lanes[0], lanes[1], tb[:, 1:].long(), k_scale=lanes[2],
                v_scale=lanes[3])
            for run in (lambda: tda.tda_paged_decode_attention(
                            q, *pool[:2], tb, tt, *pool[2:]),
                        lambda: tda.tda_decode_attention(
                            q, *(None if x is None else x.contiguous()
                                 for x in lanes[:2]), tb,
                            *(None if x is None else x.contiguous()
                              for x in lanes[2:]))):
                got = run()
                assert (got - want)[live].abs().max().item() <= 1e-3
                assert not got[~live].any()
                assert torch.equal(run(), got)


def test_bf16_logits_within_reference_rounding(sc2):
    """bf16 starcoder2 ``apply`` logits past the window: the port's within
    2x the reference's own bf16-vs-f32 gap on the same inputs, from both
    the reference's bf16 and its f32 logits (as
    ``test_torch_bf16_parity.py`` holds qwen2.5)."""
    import jax.numpy as jnp
    from repro.models.transformer import Model as JM
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import Model
    cfg, jm, jp, _, _ = sc2
    jm16 = JM(dataclasses.replace(cfg, dtype="bfloat16"))
    tm16 = Model(get_config(ARCH, "smoke", dtype="bfloat16"), device="cpu")
    tparams = tm16.prepare(tp.torch_smoke(ARCH, jp)[1])
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(2, 40)).astype(np.int32)
    ref32 = np.asarray(jm.apply(jp, {"inputs": jnp.asarray(toks)})[0])
    ref16 = np.asarray(jm16.apply(jp, {"inputs": jnp.asarray(toks)})[0],
                       np.float32)
    got = tm16.apply(tparams, {"inputs": tp.t(toks)})[0].float().numpy()
    gap = np.abs(ref16 - ref32).max()
    assert gap > 0 and np.isfinite(got).all()
    assert np.abs(got - ref16).max() <= 2 * gap
    assert np.abs(got - ref32).max() <= 2 * gap
