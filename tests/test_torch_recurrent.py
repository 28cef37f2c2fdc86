"""Recurrent blocks and stacks against the reference at float32 on the CPU:
the SSD mixer (mamba2-370m) and the RG-LRU block (recurrentgemma-2b) on
seeded numpy inputs — right-aligned padding (segment id 0) ending in a solo
row's state, decode steps with ``slot_mask`` freezing rows, sequences past
the SSD chunk — then the whole smoke models' ``apply``, ``prefill`` and
``decode_step`` logits and caches with the reference's parameters bridged
over.

Limits: blocks atol 1e-5 (``tp.ATOL_LAYER``: the same f32 formulas, summed
in another order; the RG-LRU scan pairs as ``lax.associative_scan`` does);
model logits atol 1e-4 (``tp.ATOL_LOGITS``); caches atol 1e-5.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_parity as tp  # noqa: E402

_PAIRS: dict = {}


def _pair(arch):
    """(reference cfg, Model, params, port Model, bridged params) of the
    float32 smoke config, made once per process."""
    if arch not in _PAIRS:
        nl = 3 if arch == "recurrentgemma-2b" else 2
        cfg, jm, jp = tp.jax_smoke(arch, n_layers=nl)
        tm, tparams = tp.torch_smoke(arch, jp, n_layers=nl)
        _PAIRS[arch] = (cfg, jm, jp, tm, tparams)
    return _PAIRS[arch]


def _block(arch):
    """One block's (kind, reference params, port params, port cfg)."""
    cfg, jm, jp, tm, tparams = _pair(arch)
    if arch == "mamba2-370m":
        jb = {k: v for k, v in _tree_index(jp["layers"]["ssd"], 0).items()}
        tb = _tree_index(tparams["layers"]["ssd"], 0)
        return "ssd", jb, tb, tm.cfg
    return ("rglru", jp["layers"]["layer_00"]["rglru"],
            tparams["layers"]["layer_00"]["rglru"], tm.cfg)


def _tree_index(tree, i):
    if isinstance(tree, dict):
        return {k: _tree_index(v, i) for k, v in tree.items()}
    return tree[i]


_JIT: dict = {}


def _jitted(arch, kind):
    """The reference block under ``jax.jit`` (one compile per shape, not
    one per op)."""
    if (arch, kind) not in _JIT:
        import functools
        import jax
        from repro.models import rglru as JR
        from repro.models import ssd as JS
        fn = JS.ssd_block if kind == "ssd" else JR.rglru_block
        _JIT[arch, kind] = jax.jit(functools.partial(
            fn, cfg=_pair(arch)[0], dicts=None))
    return _JIT[arch, kind]


def _run(arch, kind, jp, tp_, cfg, x, seg=None, cache=None, slot_mask=None):
    """The block in both packages: (ref out, ref cache, port out, port
    cache) as numpy; caches are ``{leaf: array}`` or None."""
    import jax.numpy as jnp
    from repro_torch.models import rglru as R
    from repro_torch.models import ssd as S
    J = (lambda a: None if a is None else jnp.asarray(a))
    jcache = None if cache is None else {k: J(v) for k, v in cache.items()}
    tcache = None if cache is None else {k: tp.t(v) for k, v in cache.items()}
    T = (lambda a: None if a is None else tp.t(a))
    jo, jc = _jitted(arch, kind)(jp, J(x), cache=jcache, seg_ids=J(seg),
                                 slot_mask=J(slot_mask))
    block = S.ssd_block if kind == "ssd" else R.rglru_block
    to = block(tp_, T(x), cfg=cfg, cache=tcache, seg_ids=T(seg),
               slot_mask=T(slot_mask))
    np_ = (lambda c: None if c is None else {k: np.asarray(v, np.float32)
                                             for k, v in c.items()})
    tcn = None if tcache is None else {k: v.float().numpy()
                                       for k, v in tcache.items()}
    return np.asarray(jo), np_(jc), to.numpy(), tcn


def _zero_cache(arch, B):
    from repro_torch.models import rglru as R
    from repro_torch.models import ssd as S
    cfg = _pair(arch)[3].cfg
    c = S.init_ssd_cache(cfg, B) if arch == "mamba2-370m" \
        else R.init_rglru_cache(cfg, B)
    return {k: v.numpy() for k, v in c.items()}


ARCHS = ["mamba2-370m", "recurrentgemma-2b"]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("S", [12, 48])
def test_block_full_sequence_right_aligned_padding(arch, S):
    """Full-sequence block outputs and filled caches against the
    reference, with rows right-aligned behind segment-id-0 padding; S = 48
    runs three SSD chunks of 16. Each padded row ends in the state a solo
    forward of its tokens gives (both packages)."""
    kind, jp, tp_, cfg = _block(arch)
    rng = np.random.default_rng(S)
    B = 3
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    lens = [S, S - 5, 3]
    seg = np.zeros((B, S), np.int32)
    for b, n in enumerate(lens):
        seg[b, S - n:] = 1
    jo, jc, to, tc = _run(arch, kind, jp, tp_, cfg, x, seg,
                          _zero_cache(arch, B))
    live = seg > 0
    np.testing.assert_allclose(to[live], jo[live], atol=tp.ATOL_LAYER, rtol=0)
    for k in jc:
        np.testing.assert_allclose(tc[k], jc[k], atol=tp.ATOL_LAYER, rtol=0)
    # A solo row of the second request's tokens ends in the same state
    # (SSD rows need whole chunks: its 43 tokens ride the 48 width there).
    n = lens[1]
    solo_x = x[1:2, S - n:]
    solo_seg = None
    if kind == "ssd" and n > 16 and n % 16:
        solo_x, solo_seg = x[1:2], seg[1:2]
    _, sjc, _, stc = _run(arch, kind, jp, tp_, cfg, solo_x, solo_seg,
                          _zero_cache(arch, 1))
    for k in sjc:
        np.testing.assert_allclose(stc[k][0], tc[k][1], atol=tp.ATOL_LAYER,
                                   rtol=0)
        np.testing.assert_allclose(sjc[k][0], jc[k][1], atol=tp.ATOL_LAYER,
                                   rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_block_decode_with_slot_mask(arch):
    """Three decode steps from filled states against the reference; rows
    outside ``slot_mask`` keep their state and conv taps bit for bit."""
    kind, jp, tp_, cfg = _block(arch)
    rng = np.random.default_rng(5)
    B = 4
    x = rng.standard_normal((B, 20, cfg.d_model)).astype(np.float32)
    _, jc, _, _ = _run(arch, kind, jp, tp_, cfg, x[:, :16], None,
                       _zero_cache(arch, B))
    cache = jc
    mask = np.array([True, False, True, False])
    for t in range(16, 19):
        jo, jc, to, tc = _run(arch, kind, jp, tp_, cfg, x[:, t:t + 1], None,
                              cache, slot_mask=mask)
        np.testing.assert_allclose(to[mask], jo[mask], atol=tp.ATOL_LAYER,
                                   rtol=0)
        for k in jc:
            np.testing.assert_allclose(tc[k], jc[k], atol=tp.ATOL_LAYER,
                                       rtol=0)
            np.testing.assert_array_equal(tc[k][~mask], cache[k][~mask])
        cache = jc


def test_associative_scan_matches_jax():
    """``rglru.associative_scan`` against ``jax.lax.associative_scan`` on
    the RG-LRU combine at odd and even lengths: atol 1e-6 (same pairing,
    f32)."""
    import jax
    import jax.numpy as jnp
    from repro_torch.models.rglru import _combine, associative_scan
    rng = np.random.default_rng(0)
    for S in (1, 2, 7, 16, 33):
        a = rng.uniform(0.5, 1.0, (2, S, 5)).astype(np.float32)
        b = rng.standard_normal((2, S, 5)).astype(np.float32)

        def jcomb(c1, c2):
            return c1[0] * c2[0], c2[0] * c1[1] + c2[1]

        want = jax.lax.associative_scan(jcomb, (jnp.asarray(a),
                                                jnp.asarray(b)), axis=1)
        got = associative_scan(_combine, (tp.t(a), tp.t(b)), axis=1)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6,
                                       rtol=0)


def _cache_close(tc, jc, atol):
    """Every leaf of a port cache tree against the reference's."""
    import jax
    for path, leaf in jax.tree_util.tree_flatten_with_path(jc)[0]:
        t = tc
        for k in path:
            t = t[k.key]
        np.testing.assert_allclose(t.float().numpy(),
                                   np.asarray(leaf, np.float32), atol=atol,
                                   rtol=0, err_msg=str(path))


@pytest.mark.parametrize("arch", ARCHS)
def test_model_apply_prefill_decode(arch):
    """The smoke model (mamba2: 2 SSD layers; recurrentgemma: rglru,
    rglru, local with a window of 32) against the reference: ``apply``
    logits over 48 tokens, ``prefill`` of 44 (recurrentgemma; 32 for the
    SSD chunks of mamba2) and three ``decode_step``s past it, logits and
    every cache leaf."""
    import functools
    import jax
    import jax.numpy as jnp
    cfg, jm, jp, tm, tparams = _pair(arch)
    rng = np.random.default_rng(11)
    B, S = 2, 48
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    apply = jax.jit(lambda p, b: jm.apply(p, b)[0])
    prefill = jax.jit(functools.partial(jm.prefill, max_len=S + 4))
    decode = jax.jit(jm.decode_step)
    jl = apply(jp, {"inputs": jnp.asarray(toks)})
    tl, _ = tm.apply(tparams, {"inputs": tp.t(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                               atol=tp.ATOL_LOGITS, rtol=0)
    P = 32 if arch == "mamba2-370m" else 44
    jl, jc = prefill(jp, {"inputs": jnp.asarray(toks[:, :P])})
    tl, tc = tm.prefill(tparams, {"inputs": tp.t(toks[:, :P])},
                        max_len=S + 4)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                               atol=tp.ATOL_LOGITS, rtol=0)
    _cache_close(tc, jc, tp.ATOL_POOL)
    for i in range(P, P + 3):
        jl, jc = decode(jp, {"inputs": jnp.asarray(toks[:, i:i + 1])}, jc,
                        jnp.int32(i))
        tl, tc = tm.decode_step(tparams, {"inputs": tp.t(toks[:, i:i + 1])},
                                tc, torch.tensor(i))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=tp.ATOL_LOGITS, rtol=0)
        _cache_close(tc, jc, tp.ATOL_POOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_layout_and_lane_specs_match_reference(arch):
    """``Model.init`` (the port's own draws) has the reference's tree,
    shapes and dtypes; ``init_cache`` and ``cache_lane_specs`` too."""
    import jax
    cfg, jm, jp, tm, tparams = _pair(arch)
    mine = tm.init(0)
    ref = jax.tree_util.tree_flatten_with_path(jm.param_shapes())[0]
    flat = {tuple(k.key for k in p): v for p, v in ref}
    got = {}

    def walk(t, pre=()):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, pre + (k,))
            else:
                got[pre + (k,)] = v

    walk(mine)
    assert set(got) == set(flat)
    for k, v in flat.items():
        assert tuple(got[k].shape) == tuple(v.shape), k
    assert tm.cache_lane_specs() == jm.cache_lane_specs()
    jcache = jax.tree_util.tree_flatten_with_path(jm.init_cache(3, 40))[0]
    tcache = tm.init_cache(3, 40)
    for path, leaf in jcache:
        t = tcache
        for k in path:
            t = t[k.key]
        assert tuple(t.shape) == tuple(leaf.shape), path
        assert str(t.dtype).split(".")[-1] == str(leaf.dtype), path
