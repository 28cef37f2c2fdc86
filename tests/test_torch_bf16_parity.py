"""bf16 logits of the port against the reference's, on qwen2.5 smoke (2
layers) with the reference's ``Model.init`` params bridged over: ``apply``,
``mixed_step`` and ``decode_step`` over paged lanes.

The bound is the reference's own bf16 rounding, measured on the same
inputs: the port's bf16 logits may differ from the reference's bf16 logits
by at most ``BF16_FACTOR`` times the largest gap between the reference's
bf16 and float32 logits, and from the reference's float32 logits by no more
than that either. The two frameworks round bf16 at different places (the
port multiplies bf16 weights made once by ``Model.prepare``; the
reference's dense ``apply_linear`` multiplies the bf16 activation by the
f32 weight as an f32 product), so the logits differ by about the size of
bf16 rounding itself, not by float32 summation order. Greedy tokens are not
compared at bf16: near-ties flip on either side."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_parity as tp  # noqa: E402

tp.tf32_off()

# Port bf16 vs reference bf16 (and vs reference f32), as a multiple of the
# reference's own bf16-vs-f32 gap on the same inputs. At 2 layers the two
# gaps are about equal (ROADMAP Queue 3): 2x leaves room for the other
# rounding order without admitting an error of a different kind.
BF16_FACTOR = 2.0
PS, NPG, B, S = 8, 3, 4, 6
W = PS * NPG


@pytest.fixture(scope="module")
def models():
    from repro.models.transformer import Model as JModel
    from repro_torch.configs import get_config
    from repro_torch.models.bridge import params_from_numpy
    from repro_torch.models.transformer import Model
    cfg32, jm32, params = tp.jax_qwen_smoke()
    jm16 = JModel(dataclasses.replace(cfg32, dtype="bfloat16"))
    tcfg = get_config("qwen2.5-32b", "smoke", dtype="bfloat16", n_layers=2)
    tm16 = Model(tcfg, device="cpu")
    tparams = tm16.prepare(params_from_numpy(tp.to_numpy_tree(params),
                                             "cpu"))
    return cfg32, jm32, jm16, params, tm16, tparams


def _check(ref32, ref16, got16, live=None):
    """max |port bf16 - ref bf16| and max |port bf16 - ref f32| within
    BF16_FACTOR x max |ref bf16 - ref f32| (over ``live`` positions)."""
    sel = (lambda a: a[live]) if live is not None else (lambda a: a)
    ref32, ref16, got16 = (sel(np.asarray(a, np.float32))
                           for a in (ref32, ref16, got16))
    assert np.isfinite(got16).all()
    gap = np.abs(ref16 - ref32).max()
    assert gap > 0  # the reference's bf16 run really rounds
    bound = BF16_FACTOR * gap
    assert np.abs(got16 - ref16).max() <= bound
    assert np.abs(got16 - ref32).max() <= bound


def test_bf16_apply_logits_within_reference_rounding(models):
    import jax.numpy as jnp
    cfg, jm32, jm16, params, tm16, tparams = models
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(2, 12)).astype(np.int32)
    ref32 = jm32.apply(params, {"inputs": jnp.asarray(toks)})[0]
    ref16 = jm16.apply(params, {"inputs": jnp.asarray(toks)})[0]
    got16, _ = tm16.apply(tparams, {"inputs": tp.t(toks)})
    _check(ref32, ref16, got16.float().numpy())


def _bf16_values(a):
    """float32 array of bf16-representable values (both sides store the
    pools in bf16)."""
    return torch.from_numpy(a).bfloat16().float().numpy()


def _step(models, mode, step, ci, nn, active, seed):
    """The same pools, tables and tokens through one step of the reference
    at f32 and bf16 and of the port at bf16: three logits arrays."""
    import jax.numpy as jnp
    cfg, jm32, jm16, params, tm16, tparams = models
    rng = np.random.default_rng(seed)
    P = B * NPG + 2
    bt = rng.permutation(P)[:B * NPG].reshape(B, NPG).astype(np.int32)
    shape = (cfg.n_layers, P, PS, cfg.kv_heads, cfg.head_dim)
    k = _bf16_values(rng.standard_normal(shape).astype(np.float32))
    v = _bf16_values(rng.standard_normal(shape).astype(np.float32))
    width = 1 if step == "decode" else S
    toks = rng.integers(0, cfg.vocab_size, size=(B, width)).astype(np.int32)
    jpages = {"bt": jnp.asarray(bt), "width": W, "page_size": PS}
    outs = []
    for jm, dt in ((jm32, jnp.float32), (jm16, jnp.bfloat16)):
        jm = jm.with_decode_attn(mode)
        jc = {"k": jnp.asarray(k, dt), "v": jnp.asarray(v, dt)}
        args = (params, {"inputs": jnp.asarray(toks)}, jc, jnp.asarray(ci))
        if step == "decode":
            logits, _ = jm.decode_step(*args, slot_mask=jnp.asarray(active),
                                       pages=jpages)
        else:
            logits, _ = jm.mixed_step(*args, jnp.asarray(nn),
                                      slot_mask=jnp.asarray(active),
                                      pages=jpages)
        outs.append(np.asarray(logits, np.float32))
    tmodel = tm16.with_decode_attn(mode)
    tc = {"k": tp.t(k, dtype=torch.bfloat16),
          "v": tp.t(v, dtype=torch.bfloat16)}
    tpages = {"bt": tp.t(bt), "width": W, "page_size": PS}
    targs = (tparams, {"inputs": tp.t(toks)}, tc, tp.t(ci))
    if step == "decode":
        got, _ = tmodel.decode_step(*targs, slot_mask=tp.t(active),
                                    pages=tpages)
    else:
        got, _ = tmodel.mixed_step(*targs, tp.t(nn), slot_mask=tp.t(active),
                                   pages=tpages)
    return outs[0], outs[1], got.float().numpy()


@pytest.mark.parametrize("mode", ["dense", "tda"])
def test_bf16_decode_step_logits_within_reference_rounding(models, mode):
    ci = np.array([3, 15, 0, 20], np.int32)
    active = np.array([True, True, False, True])
    ref32, ref16, got = _step(models, mode, "decode", ci, None, active, 0)
    _check(ref32, ref16, got, active)


@pytest.mark.parametrize("mode", ["dense", "tda"])
def test_bf16_mixed_step_logits_within_reference_rounding(models, mode):
    # rows: mid-prompt chunk, decode row, inert (masked) row, fresh prompt
    ci = np.array([5, 14, 9, 0], np.int32)
    nn = np.array([4, 1, 3, S], np.int32)
    active = np.array([True, True, False, True])
    ref32, ref16, got = _step(models, mode, "mixed", ci, nn, active, 1)
    live = (np.arange(S)[None, :] < nn[:, None]) & active[:, None]
    _check(ref32, ref16, got, live)
