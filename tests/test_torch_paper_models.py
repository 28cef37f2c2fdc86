"""The paper's four evaluation models (``repro_torch.models.paper_models``:
bert, vit, mt, s2t) against the reference's ``paper_models`` at narrowed
widths (2 encoder and 2 decoder layers, d_model 64, 4 heads, d_ff 128,
vocabulary 256, max_len 64, ``min_dim`` 32, float32), from bridged
reference parameters and seeded numpy inputs: dense, factorized and
compressed (each package's own ``compress_model_params`` of the same
bridged tree); bert packed as the paper's dynamic batching; a padded
source through cross-attention; bert served by the Engine.

Tolerances, each with its reason: logits within ``RTOL_PAPER`` (1e-5) of
the reference's largest logit and losses within ``RTOL_PAPER`` of the
reference's loss — the same f32 formulas summed in other orders over a
few matmuls and an f32 head (measured at most 8.5e-7 and 2.4e-7). The
reference's runs go through ``jax.jit`` (one compile per model and
weight format, shared by the tests through a module-scoped cache).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_parity as tp  # noqa: E402

tp.tf32_off()

RTOL_PAPER = 1e-5
NARROW = dict(n_layers=2, d_model=64, n_heads=4, d_ff=128, vocab_size=256,
              max_len=64, dtype="float32")
MODES = ("dense", "factorized", "compressed")
B, S, ST = 2, 24, 12  # batch, source length, target length


def narrowed(pkg: str, name: str, mode: str):
    """The narrowed config of ``name`` in package ``pkg`` (``"repro"`` or
    ``"repro_torch"``) for weight format ``mode``."""
    import importlib
    pm = importlib.import_module(pkg + ".models.paper_models")
    fac = importlib.import_module(pkg + ".core.factorized")
    cfg = pm.paper_model_config(name, mode != "dense")
    over = dict(NARROW)
    if cfg.n_encoder_layers:
        over["n_encoder_layers"] = 2
    return dataclasses.replace(cfg, factorization=fac.FactorizationConfig(
        enabled=mode != "dense", min_dim=32), **over)


def batch_for(cfg, seed: int = 0):
    """Seeded numpy inputs: encoders ``inputs`` (bert) or ``embeds``
    (vit); encoder-decoders ``src`` (mt) or 80-wide ``src_feats`` (s2t),
    a source padded from position 17 on row 1 (``src_seg`` 0), ``tgt`` and
    ``labels``."""
    rng = np.random.default_rng(seed)
    V = cfg.vocab_size
    if not cfg.n_encoder_layers:
        if cfg.external_embeddings:
            return {"embeds": rng.standard_normal(
                (B, S, cfg.d_model)).astype(np.float32)}
        return {"inputs": rng.integers(0, V, (B, S)).astype(np.int32)}
    seg = np.ones((B, S), np.int32)
    seg[1, 17:] = 0
    b = {"src_seg": seg,
         "tgt": rng.integers(0, V, (B, ST)).astype(np.int32),
         "labels": rng.integers(0, V, (B, ST)).astype(np.int32)}
    if cfg.external_embeddings:
        b["src_feats"] = rng.standard_normal((B, S, 80)).astype(np.float32)
    else:
        b["src"] = rng.integers(0, V, (B, S)).astype(np.int32)
    return b


class Pairs:
    """The shared runs of this module: :meth:`pair` builds each model and
    weight format once, :meth:`ref` runs the reference once under
    ``jax.jit``."""

    def __init__(self):
        self._pairs, self._refs = {}, {}

    def pair(self, name: str, mode: str):
        """``(jcfg, jmodel, jparams, tcfg, tmodel, tparams)`` for ``name``
        at weight format ``mode``: reference params from
        ``init(key(0))``, bridged to the port; compressed trees from each
        package's ``compress_model_params`` of the factorized tree."""
        key = (name, mode)
        if key not in self._pairs:
            import jax
            from repro.core.factorized import (
                compress_model_params as jcompress)
            from repro.models.paper_models import EncDecModel as JEncDec
            from repro.models.transformer import Model as JModel
            from repro_torch.core.factorized import compress_model_params
            from repro_torch.models.bridge import params_from_numpy
            from repro_torch.models.paper_models import EncDecModel
            from repro_torch.models.transformer import Model
            jcfg = narrowed("repro", name, mode)
            tcfg = narrowed("repro_torch", name, mode)
            encdec = bool(jcfg.n_encoder_layers)
            jm = JEncDec(jcfg) if encdec else JModel(jcfg)
            tm = EncDecModel(tcfg, "cpu") if encdec else Model(tcfg, "cpu")
            jp = jm.init(jax.random.key(0))
            tparams = params_from_numpy(tp.to_numpy_tree(jp), "cpu")
            if mode == "compressed":
                jp, _ = jcompress(jp, jcfg.factorization)
                tparams, _ = compress_model_params(tparams,
                                                   tcfg.factorization)
            self._pairs[key] = (jcfg, jm, jp, tcfg, tm, tparams)
        return self._pairs[key]

    def ref(self, name: str, mode: str):
        """The reference's logits (and, for the encoder-decoders, loss)
        on :func:`batch_for`."""
        key = (name, mode)
        if key not in self._refs:
            import jax
            import jax.numpy as jnp
            from repro.models.layers import cross_entropy
            jcfg, jm, jp, *_ = self.pair(name, mode)
            jb = {k: jnp.asarray(v) for k, v in batch_for(jcfg).items()}
            if jcfg.n_encoder_layers:
                logits = jax.jit(
                    lambda p, b: jm.decode(p, jm.encode(p, b), b))(jp, jb)
                self._refs[key] = (np.asarray(logits), float(
                    cross_entropy(logits, jb["labels"])))
            else:
                logits = jax.jit(lambda p, b: jm.apply(p, b)[0])(jp, jb)
                self._refs[key] = (np.asarray(logits), None)
        return self._refs[key]


@pytest.fixture(scope="module")
def runs():
    return Pairs()


def test_paper_configs_match_reference():
    """The published configs, field for field, factorized and not."""
    from repro.models.paper_models import paper_model_config as jconf
    from repro_torch.models.paper_models import (PAPER_MODELS,
                                                 paper_model_config)
    for name in PAPER_MODELS:
        for fact in (True, False):
            a = dataclasses.asdict(paper_model_config(name, fact))
            b = dataclasses.asdict(jconf(name, fact))
            assert a == b, name
    with pytest.raises(ValueError):
        paper_model_config("gpt")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", ["bert", "vit", "mt", "s2t"])
def test_paper_model_matches_reference(runs, name, mode):
    """Encoder logits (bert, vit) or the encoder-decoder's logits and loss
    (mt, s2t, over a padded source) against the reference's, from the
    bridged tree (dense, factorized) or each package's compression of it;
    the compressed trees carry the same leaves."""
    jcfg, jm, jp, tcfg, tm, tparams = runs.pair(name, mode)
    want, want_loss = runs.ref(name, mode)
    tb = {k: tp.t(v) for k, v in batch_for(tcfg).items()}
    if tcfg.n_encoder_layers:
        got = tm.decode(tparams, tm.encode(tparams, tb), tb)
        loss, metrics = tm.loss(tparams, tb)
        assert set(metrics) == {"xent", "loss"}
        assert abs(float(loss) - want_loss) <= RTOL_PAPER * abs(want_loss)
    else:
        got = tm.apply(tparams, tb)[0]
    assert tuple(got.shape) == want.shape
    err = float(np.abs(got.numpy() - want).max())
    assert err <= RTOL_PAPER * float(np.abs(want).max()), err
    if mode == "compressed":
        assert sorted(tp.flat_tree(tparams)) == sorted(tp.flat_tree(
            tp.to_numpy_tree(jp)))


def test_packed_bert_matches_reference(runs):
    """The paper's dynamic batching on bert: requests of
    ``request_lengths(12, 64, "bert")`` packed by ``pack_requests(
    PackingPolicy(64, 4))`` (segment ids, within-request positions into
    the learned table); the packed forward against the reference's on
    every live position, and each request's logits against a run of that
    request alone (the same limit)."""
    import jax.numpy as jnp
    from repro_torch.core.packing import (PackingPolicy, pack_requests,
                                          packing_utilization)
    from repro_torch.data import request_lengths
    jcfg, jm, jp, tcfg, tm, tparams = runs.pair("bert", "factorized")
    lens = request_lengths(12, 64, "bert")
    reqs = tp.prompts(tcfg.vocab_size, lens, seed=3)
    pk = pack_requests(reqs, PackingPolicy(64, 4))
    assert pk.rows < len(reqs) and packing_utilization(pk) > np.mean(
        lens) / 64
    batch = {"inputs": pk.tokens, "positions": pk.positions,
             "seg_ids": pk.segment_ids}
    want = np.asarray(jm.apply(jp, {k: jnp.asarray(v) for k, v in
                                    batch.items()})[0])
    got = tm.apply(tparams, {k: tp.t(v) for k, v in batch.items()})[0]
    got = got.numpy()
    live = pk.segment_ids > 0
    lim = RTOL_PAPER * float(np.abs(want[live]).max())
    assert float(np.abs(got[live] - want[live]).max()) <= lim
    for req, (row, start, n) in zip(reqs, pk.request_slots):
        alone = tm.apply(tparams, {"inputs": tp.t(req[None])})[0][0].numpy()
        assert float(np.abs(got[row, start:start + n] - alone).max()) <= lim


def test_cross_attention_padded_source_matches_reference(runs):
    """``attention_block(kv=, seg_kv=)`` (mt's first decoder layer's
    ``xattn``, one layer) against the reference's over a memory longer
    than the queries with a padded tail on one row: every query sees every
    live memory position (no causal cut, no decode-style alignment), and
    what lies on the pad does not reach the output."""
    import jax.numpy as jnp
    from repro.models import layers as JL
    from repro_torch.models import layers as L
    jcfg, jm, jp, tcfg, tm, tparams = runs.pair("mt", "factorized")
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, ST, 64)).astype(np.float32)
    mem = rng.standard_normal((B, S, 64)).astype(np.float32)
    seg = batch_for(tcfg)["src_seg"]
    jl = jp["decoder"]["layer_00"]["xattn"]
    tl = tparams["decoder"]["layer_00"]["xattn"]
    pos = np.broadcast_to(np.arange(ST, dtype=np.int32), (B, ST))
    want = np.asarray(JL.attention_block(
        jl, jnp.asarray(x), cfg=jcfg, dicts=jp["dicts"],
        positions=jnp.asarray(pos), seg_ids=None, kv=jnp.asarray(mem),
        seg_kv=jnp.asarray(seg), prefix="dec_xattn")[0])

    def port(m):
        return L.attention_block(
            tl, tp.t(x), cfg=tcfg, dicts=tparams["dicts"],
            positions=tp.t(pos).long(), window=None, kv=tp.t(m),
            seg_kv=tp.t(seg), prefix="dec_xattn").numpy()

    got = port(mem)
    np.testing.assert_allclose(got, want, rtol=0, atol=tp.ATOL_LAYER)
    noisy = mem.copy()
    noisy[seg == 0] = 1e3
    np.testing.assert_allclose(port(noisy), got, rtol=0, atol=tp.ATOL_LAYER)
    with pytest.raises(ValueError, match="without caches"):
        L.attention_block(tl, tp.t(x), cfg=tcfg, dicts=tparams["dicts"],
                          positions=tp.t(pos).long(), kv=tp.t(mem),
                          cache_index=torch.zeros(B, dtype=torch.long))


def test_model_refuses_encoder_decoder_and_inits(runs):
    """``Model`` refuses an encoder-decoder config and names
    ``EncDecModel``; each port model's own ``init`` draws the reference's
    tree (the same paths and shapes) from a ``torch.Generator``."""
    from repro_torch.core.errors import UnsupportedConfigError
    from repro_torch.models.paper_models import (EncDecModel,
                                                 build_paper_model)
    from repro_torch.models.transformer import Model
    with pytest.raises(UnsupportedConfigError, match="EncDecModel"):
        Model(narrowed("repro_torch", "mt", "dense"), device="cpu")
    with pytest.raises(ValueError):
        EncDecModel(narrowed("repro_torch", "bert", "dense"), device="cpu")
    for name in ("bert", "vit", "mt", "s2t"):
        jcfg, jm, jp, tcfg, tm, _ = runs.pair(name, "factorized")
        mine = tm.init(seed=1)
        want = {k: np.shape(v) for k, v in tp.flat_tree(
            tp.to_numpy_tree(jp)).items()}
        assert {k: tuple(v.shape) for k, v in
                tp.flat_tree(mine).items()} == want
        model, cfg = build_paper_model(name, device="cpu")
        assert type(model).__name__ == ("EncDecModel" if cfg.n_encoder_layers
                                        else "Model")


def test_bert_engine_matches_reference(runs):
    """The reference's Engine serves bert's config (``causal=False``,
    learned positions) without refusal, its mixed step causal within the
    chunk as for any stack; the port's Engine does the same: the same
    tokens and statuses as the reference's on the default (mixed),
    serialized paged and serialized contiguous engines."""
    _, jm, jp, _, tm, tparams = runs.pair("bert", "dense")
    rounds = [[(i, p, 4) for i, p in enumerate(
        tp.prompts(NARROW["vocab_size"], [5, 9, 3, 20], seed=2))]]
    kw = dict(max_len=32, max_new_tokens=4, num_slots=2)
    for over in ({}, {"mixed": False}, {"mixed": False, "paged": False}):
        want, _, _ = tp.serve_rounds("repro", jm, jp, rounds, **kw, **over)
        got, _, eng = tp.serve_rounds("repro_torch", tm, tparams, rounds,
                                      **kw, **over)
        assert got == want, over
        assert all(s == "ok" for _, s in got.values())


@pytest.mark.gpu
def test_cuda_compressed_bert_layer_matches_plain():
    """The card: one compressed bert layer at its published widths (d 768,
    d_ff 3072, r 512, nnz 64) over 2 x 128 tokens, its six linears
    through the DMM and SMM kernels, against the same layer with its
    weights decompressed first (f32 throughout; the limit is
    ``chip_smoke.py``'s for DMM and SMM, 1e-3 of max(1, the largest plain
    output): f32 sums in other orders over K up to 3072)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the port's CUDA device)")
    from repro_torch.core.factorized import (compress_model_params,
                                             decompress_wd_leaf,
                                             decompress_ws_entry,
                                             project_wd_leaves)
    from repro_torch.core.tree import tree_map
    from repro_torch.kernels.dmm import dmm
    from repro_torch.kernels.smm import smm
    from repro_torch.models import layers as L
    from repro_torch.models.paper_models import paper_model_config
    from repro_torch.models.transformer import Model
    cfg = dataclasses.replace(paper_model_config("bert"), n_layers=1,
                              dtype="float32")
    params = project_wd_leaves(Model(cfg).init(seed=0), cfg.factorization)
    cparams, _ = compress_model_params(params, cfg.factorization)
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((2, 128, 768), generator=g, device="cuda")
    pos = torch.zeros((2, 128), dtype=torch.long, device="cuda")

    def layer(lay, dicts):
        lp = tree_map(lambda t: t[0], lay)
        h = x + L.attention_block(lp["attn"], L.apply_norm(lp["norm1"], x),
                                  cfg=cfg, dicts=dicts, positions=pos)
        return h + L.ffn_block(lp["ffn"], L.apply_norm(lp["norm2"], h),
                               cfg=cfg, dicts=dicts)

    dmm.reset_launch_counts()
    smm.reset_launch_counts()
    got = layer(cparams["layers"], cparams["dicts"])
    torch.cuda.synchronize()
    assert dmm.LAUNCHES["dmm_matmul"] == smm.LAUNCHES["smm_matmul"] == 6

    def plain(c, p):  # every stream group back to its dense wd
        if "wd_vq" in c:
            out = {k: v for k, v in c.items() if not k.startswith("wd_")}
            out["wd"] = decompress_wd_leaf(tree_map(lambda t: t[0], c),
                                           p["wd"].shape[-2])[None]
            return out
        return {k: plain(v, p[k]) if isinstance(v, dict) else v
                for k, v in c.items()}

    dicts = {f: decompress_ws_entry(e, params["dicts"][f].shape[0])
             for f, e in cparams["dicts"].items()}
    want = layer(plain(cparams["layers"], params["layers"]), dicts)
    err = (got - want).abs().max().item()
    assert err <= 1e-3 * max(1.0, want.abs().max().item()), err
