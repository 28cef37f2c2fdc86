"""The port's examples (``repro_torch.examples``) on the CPU at reduced
steps, held to the reference on bridged params at float32:

* ``quickstart``: the sparse-training loss of the same params and batch
  within 1e-5 relative of the reference's ``Model.loss``; the EMA and
  chip-model figures equal to ``repro.core.ema``'s;
* ``compress_and_eval``: after two sparse-training steps, every W_D
  leaf's ``nnz`` / column, achieved delta bits and the fp16 / compressed
  KiB equal to the reference's numpy functions (``repro.core.
  compression``, ``project_topk_columns``) on the same weights;
* ``train_factorized_lm``: the factorized run's losses over 4 steps
  (sparse from step 2, a projection every 2) equal to the port's own
  ``train`` on the reference example's settings (``tests/
  test_torch_train_loop.py`` holds that ``train`` to the reference's;
  the reference's jit compiles of a 4-step run would take most of this
  file's time);
* ``serve_dynamic_batching``'s dense, prefix, recurrent and degraded
  sections and ``serve_async_frontend``'s trace: the same section code run
  by the reference's serving package (``serve=repro.serve``) on the
  reference's models gives the same tokens and counters; the async
  example's own checks (streaming equal to ``Engine.run``, a cancel that
  frees its pages) hold.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_parity as tp  # noqa: E402

tp.tf32_off()


def _bridge(params):
    from repro_torch.models.bridge import params_from_numpy
    return params_from_numpy(tp.to_numpy_tree(params), "cpu")


def _ref_model(cfg_port):
    """The reference's Model and ``init(key(0))`` params for the port
    config's fields."""
    import jax
    from repro.configs import get_config
    from repro.core.factorized import FactorizationConfig
    from repro.models.transformer import Model
    f = cfg_port.factorization
    cfg = get_config(cfg_port.name.replace("-smoke", ""), "smoke",
                     dtype=cfg_port.dtype, factorization=FactorizationConfig(
                         enabled=f.enabled, min_dim=f.min_dim))
    m = Model(cfg)
    return m, m.init(jax.random.key(0))


def test_quickstart_matches_reference():
    import jax.numpy as jnp
    from repro.core import ema as ref_ema
    from repro.core.factorized import FactorizationConfig as RefF
    from repro_torch.examples import quickstart as qs
    cfg = qs.quickstart_config("float32")
    rm, rparams = _ref_model(cfg)
    batch = qs.quickstart_batch(cfg)
    out = qs.main(["--device", "cpu", "--dtype", "float32"],
                  params=_bridge(rparams))
    import jax
    want, wm = jax.jit(lambda p, b: rm.loss(p, b, sparse_train=True))(
        rparams, {k: jnp.asarray(v) for k, v in batch.items()})
    assert abs(out["loss"] - float(want)) <= 1e-5 * abs(float(want))
    assert abs(out["sparsity_reg"] - float(wm["sparsity_reg"])) <= \
        1e-5 * abs(float(wm["sparsity_reg"]))
    w = ref_ema.PAPER_WORKLOADS["bert"]
    r = ref_ema.ema_report(w, RefF(enabled=True))
    le = ref_ema.latency_energy_report(w, RefF(enabled=True), corner="slow")
    for k in ("reduction_factorize", "reduction_compress",
              "reduction_batching", "reduction_total"):
        assert out[k] == float(r[k]), k
    assert out["us_per_token"] == float(le["us_per_token"])
    assert out["uJ_per_token"] == float(le["uJ_per_token"])


def test_compress_and_eval_matches_reference_accounting():
    from repro.core import compression as comp
    from repro.core.factorized import FactorizationConfig as RefF
    from repro.core.sparsity import project_topk_columns
    from repro_torch.examples import compress_and_eval as ce
    cfg = ce.compress_config("float32")
    _, rparams = _ref_model(cfg)
    params = _bridge(rparams)
    out = ce.main(["--device", "cpu", "--dtype", "float32", "--steps", "2"],
                  params=params)  # trained in place
    assert np.isfinite(out["loss"])
    np_params = tp.torch_to_numpy(params)
    fcfg = RefF(enabled=True, min_dim=32)
    want, dense_bits, comp_bits = [], 0, 0
    for path, leaf in tp.flat_tree(np_params).items():
        if not path.endswith("/wd"):
            continue
        r, d_out = leaf.shape[-2], leaf.shape[-1]
        nnz = fcfg.nnz_for(r)
        stack = np.asarray(project_topk_columns(
            leaf.reshape(-1, r, d_out)[0], nnz))
        cwd = comp.compress_wd(stack, nnz, order=comp.reorder_for_delta(
            comp.delta_decode(comp.delta_encode(np.sort(np.argsort(
                -np.abs(stack), axis=0)[:nnz], axis=0))), r))
        dense_bits += leaf.size * 16
        comp_bits += comp.wd_compressed_bits(cwd) * leaf.reshape(
            -1, r, d_out).shape[0]
        want.append({"leaf": path[:-3], "nnz": nnz,
                     "delta_bits": int(cwd.achieved_delta_bits)})
    for ws in np_params["dicts"].values():
        dense_bits += ws.size * 16
        comp_bits += comp.ws_compressed_bits(comp.compress_ws(ws))
    assert sorted(out["leaves"], key=lambda x: x["leaf"]) == \
        sorted(want, key=lambda x: x["leaf"])
    assert out["dense_kib"] == dense_bits / 8 / 1024
    assert out["compressed_kib"] == comp_bits / 8 / 1024


def test_train_factorized_lm_matches_train(tmp_path):
    from repro_torch.core.tree import tree_map
    from repro_torch.data import lm_batches
    from repro_torch.examples import train_factorized_lm as tf
    from repro_torch.models.transformer import Model
    from repro_torch.optim import OptConfig
    from repro_torch.train import TrainLoopConfig, train
    cfg = tf.run_config("qwen2.5-32b", True, "float32")
    params = Model(cfg, device="cpu").init(0)
    got = tf.train_run(cfg, 4, str(tmp_path / "ex"), "cpu", params=params,
                       sparse_from_step=2, project_every=2)
    loop = TrainLoopConfig(total_steps=4, ckpt_dir=str(tmp_path / "direct"),
                           ckpt_every=50, log_every=1, sparse_from_step=2,
                           project_every=2)
    want = train(Model(cfg, device="cpu"),
                 lm_batches(cfg.vocab_size, 8, 32, seed=1),
                 OptConfig(lr=5e-3, warmup_steps=10, schedule="constant",
                           weight_decay=0.0),
                 loop, params=tree_map(lambda t: t.clone(), params))
    losses = {h["step"]: h["loss"] for h in want["history"]}
    for h in got["history"]:
        assert abs(h["loss"] - losses[h["step"]]) <= 1e-4, h


def test_serve_examples_match_reference_engine():
    from repro import serve as ref_serve
    from repro_torch.examples import serve_async_frontend as sa
    from repro_torch.examples import serve_dynamic_batching as sd
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import Model
    cfg = get_config("qwen2.5-32b", "smoke", dtype="float32")
    rm, rparams = _ref_model(cfg)
    model, params = Model(cfg, device="cpu"), _bridge(rparams)
    rcfg = get_config("recurrentgemma-2b", "smoke", dtype="float32")
    rrm, rrparams = _ref_model(rcfg)
    rmodel, rp = Model(rcfg, device="cpu"), _bridge(rrparams)
    rng_p, rng_r = np.random.default_rng(0), np.random.default_rng(0)

    def same(a, b, what):
        assert a["outputs"] == b["outputs"], what
        assert a["counters"] == b["counters"], what

    got = sd.dense_section(model, params, rng_p)
    want = sd.dense_section(rm, rparams, rng_r, serve=ref_serve)
    same(got, want, "dense")
    assert (got["fills"], got["rows"]) == (want["fills"], want["rows"])
    same(sd.prefix_section(got["engine"], rng_p),
         sd.prefix_section(want["engine"], rng_r, serve=ref_serve), "prefix")
    same(sd.recurrent_section(rmodel, rp, rng_p),
         sd.recurrent_section(rrm, rrparams, rng_r, serve=ref_serve),
         "recurrent")
    got = sd.degraded_section(model, params, rng_p)
    want = sd.degraded_section(rm, rparams, rng_r, serve=ref_serve)
    same(got, want, "degraded")
    assert got["statuses"] == want["statuses"]

    out = sa.main(["--device", "cpu"], params=params)
    assert out["streamed"] == sa.reference_run(rm, rparams, serve=ref_serve)
    assert out["cancel"]["pool_ratio"] == 0.0
    assert out["cancel"]["status"] == "cancelled"
