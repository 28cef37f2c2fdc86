"""The port's train loop, checkpoints and launchers against the JAX
reference on the CPU, float32, qwen2.5 smoke, inputs from fixed seeds.

Tolerances, each with its reason:

* ``ATOL_HIST`` 1e-4 on every loss of a history (losses of ~6), and 1e-5
  relative on ``grad_norm``: the two packages' f32 rounding differs by
  ~1e-7 relative (``tests/_torch_parity.py``'s ``ATOL_LOSS``), and a
  trajectory can amplify that: initial params perturbed by 1e-7 relative
  move step 9's loss of the NaN scenario below by up to 8.3e-5 (measured
  on the CPU; Adam moves entries whose gradient is at the noise level by
  up to ``lr`` a step). Measured against the reference: <= 1e-6.
* Final parameters after many steps: ``FRAC_STEP`` / ``ATOL_STEP`` of
  ``tests/test_torch_train_step.py`` (an Adam update turns gradient noise
  at the 1e-7 level into up to ``lr`` per step on entries whose gradient
  is that small), and at most ``2 * lr`` per step on any entry.
* Checkpoints and tokens are compared exactly.

The reference's own loop cannot skip a NaN step while a checkpoint exists
on the CPU: its donated state buffers are gone when it keeps the old
state (``Buffer has been deleted or donated`` on the next step). So the
port's skip is held to the reference's run on the same stream with the
poisoned batch taken out, which is what a skip means.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_parity as tp  # noqa: E402

ATOL_HIST = 1e-4
ATOL_STEP = 1e-5
FRAC_STEP = 1e-3
OPT = dict(lr=1e-3, warmup_steps=1, schedule="constant")


def _inject_minus_one(step, batch):
    """The reference test's fault: ids of -1 at step 7 (``jnp.take``
    wraps them to the last row, so the loss stays finite)."""
    if step == 7:
        bad = dict(batch)
        bad["inputs"] = np.full_like(batch["inputs"], -1)
        return bad
    return batch


def _poison(steps, vocab):
    """ids >= V at ``steps``: NaN embedding rows, a NaN loss."""
    def hook(step, batch):
        if step in steps:
            bad = dict(batch)
            bad["inputs"] = np.full_like(batch["inputs"], vocab + 7)
            return bad
        return batch
    return hook


def _hist_close(got, want):
    assert [h["step"] for h in got] == [h["step"] for h in want]
    for a, b in zip(got, want):
        assert abs(a["loss"] - b["loss"]) <= ATOL_HIST, (a, b)
        assert abs(a["grad_norm"] - b["grad_norm"]) \
            <= 1e-5 * max(1.0, b["grad_norm"]), (a, b)
        assert a["sparse"] == b["sparse"]


def _params_close(got, want, lr, steps):
    g, w = tp.flat_tree(got), tp.flat_tree(want)
    assert sorted(g) == sorted(w)
    diff = np.concatenate([np.abs(g[k].numpy() - np.asarray(w[k])).ravel()
                           for k in w])
    assert (diff > ATOL_STEP).mean() <= FRAC_STEP, (diff > ATOL_STEP).mean()
    assert diff.max() <= 2 * lr * steps, diff.max()


def _port_model(fcfg=None):
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import Model
    over = {} if fcfg is None else {"factorization": fcfg}
    return Model(get_config("qwen2.5-32b", "smoke", dtype="float32", **over),
                 device="cpu")


def _ref_model(fcfg=None):
    from repro.configs import get_config
    from repro.models.transformer import Model
    over = {} if fcfg is None else {"factorization": fcfg}
    return Model(get_config("qwen2.5-32b", "smoke", dtype="float32", **over))


def _init_params(jm):
    """The reference ``train``'s initial params (``init(key(0))``), for
    both packages."""
    import jax
    from repro_torch.models.bridge import params_from_numpy
    jp = jm.init(jax.random.key(0))
    return params_from_numpy(tp.to_numpy_tree(jp), "cpu")


@pytest.fixture(scope="module")
def ref_fault_run(tmp_path_factory):
    """The reference's fault-injection scenario
    (``tests/test_optim_checkpoint.py::
    test_train_loop_fault_injection_and_restart``) with a record every
    step: 12 steps with the -1 batch at step 7, checkpoints every 5, then
    a restart to 15 on the same stream."""
    from repro.data import lm_batches
    from repro.optim import OptConfig
    from repro.train import TrainLoopConfig, train
    d = tmp_path_factory.mktemp("ref_ckpt")
    jm = _ref_model()
    data = lm_batches(jm.cfg.vocab_size, batch=2, seq=16, seed=0)
    out = train(jm, data, OptConfig(**OPT), TrainLoopConfig(
        total_steps=12, ckpt_dir=str(d), ckpt_every=5, log_every=1),
        hooks={"inject_fault": _inject_minus_one})
    kept = sorted(p.name for p in d.iterdir())
    out2 = train(jm, data, OptConfig(**OPT), TrainLoopConfig(
        total_steps=15, ckpt_dir=str(d), ckpt_every=5, log_every=1))
    return {"model": jm, "hist": out["history"], "hist2": out2["history"],
            "state": tp.to_numpy_tree(out2["state"]), "dir": d,
            "kept": kept}


def test_train_loop_fault_injection_and_restart_matches_reference(
        ref_fault_run, tmp_path):
    """The reference test's scenario through the port's ``train``: the
    same history, checkpoint steps, restart point and final state."""
    from repro_torch.checkpoint import latest_step
    from repro_torch.data import lm_batches
    from repro_torch.optim import OptConfig
    from repro_torch.train import TrainLoopConfig, train
    ref = ref_fault_run
    model = _port_model()
    p0 = _init_params(ref["model"])
    data = lm_batches(model.cfg.vocab_size, batch=2, seq=16, seed=0)
    out = train(model, data, OptConfig(**OPT), TrainLoopConfig(
        total_steps=12, ckpt_dir=str(tmp_path), ckpt_every=5, log_every=1),
        hooks={"inject_fault": _inject_minus_one}, params=p0)
    _hist_close(out["history"], ref["hist"])
    assert latest_step(tmp_path) == 10
    assert sorted(p.name for p in tmp_path.iterdir()) == ref["kept"]
    out2 = train(model, data, OptConfig(**OPT), TrainLoopConfig(
        total_steps=15, ckpt_dir=str(tmp_path), ckpt_every=5, log_every=1),
        params=p0)
    _hist_close(out2["history"], ref["hist2"])
    assert int(out2["state"]["step"]) == int(ref["state"]["step"]) == 15
    _params_close(out2["state"]["params"], ref["state"]["params"],
                  OPT["lr"], 15)


def test_nan_step_skipped_matches_reference_without_that_batch(tmp_path):
    """A NaN batch (ids >= V) at step 7 with a checkpoint on disk is
    skipped with the state untouched: the later losses are the
    reference's on the same stream with that batch taken out. Without a
    checkpoint the step is taken (the reference's ``state = new_state``):
    the parameters turn NaN and every later step is bad."""
    from repro.data import lm_batches as j_batches
    from repro.optim import OptConfig as JO
    from repro.train import TrainLoopConfig as JL, train as j_train
    from repro_torch.data import lm_batches
    from repro_torch.optim import OptConfig
    from repro_torch.train import TrainLoopConfig, train
    jm = _ref_model()
    V = jm.cfg.vocab_size
    p0 = _init_params(jm)

    def skip7():
        for i, b in enumerate(j_batches(V, batch=2, seq=16, seed=0)):
            if i != 7:
                yield b

    ref = j_train(jm, skip7(), JO(**OPT), JL(
        total_steps=11, ckpt_dir=str(tmp_path / "ref"), ckpt_every=100,
        log_every=1))["history"]
    model = _port_model()
    out = train(model, lm_batches(V, batch=2, seq=16, seed=0),
                OptConfig(**OPT), TrainLoopConfig(
                    total_steps=12, ckpt_dir=str(tmp_path / "port"),
                    ckpt_every=5, log_every=1),
                hooks={"inject_fault": _poison({7}, V)}, params=p0)
    got = out["history"]
    assert [h["step"] for h in got] == [0, 1, 2, 3, 4, 5, 6, 8, 9, 10, 11]
    for a, b in zip(got, ref):
        assert abs(a["loss"] - b["loss"]) <= ATOL_HIST
    assert int(out["state"]["step"]) == 11

    # no checkpoint: the step is taken (the reference's ``state =
    # new_state``), the params turn NaN and no later step is recorded;
    # steps 0-6 are the stream's first seven, the same as above
    out = train(model, lm_batches(V, batch=2, seq=16, seed=0),
                OptConfig(**OPT), TrainLoopConfig(
                    total_steps=10, ckpt_dir=str(tmp_path / "port2"),
                    ckpt_every=100, log_every=1),
                hooks={"inject_fault": _poison({7}, V)},
                params=_init_params(jm))
    _hist_close(out["history"], ref[:7])
    assert int(out["state"]["step"]) == 10
    assert torch.isnan(out["state"]["params"]["final_norm"]["scale"]).all()


def test_consecutive_bad_steps_restore_checkpoint(tmp_path):
    """``max_consecutive_bad`` (3) NaN steps in a row restore the last
    checkpoint; training goes on from its step."""
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.data import lm_batches
    from repro_torch.optim import OptConfig, init_opt_state
    from repro_torch.train import TrainLoopConfig, train
    model = _port_model()
    V = model.cfg.vocab_size
    out = train(model, lm_batches(V, batch=2, seq=16, seed=0),
                OptConfig(**OPT), TrainLoopConfig(
                    total_steps=12, ckpt_dir=str(tmp_path), ckpt_every=5,
                    log_every=1),
                hooks={"inject_fault": _poison({7, 8, 9}, V)})
    assert [h["step"] for h in out["history"]] == [0, 1, 2, 3, 4, 5, 6,
                                                   10, 11]
    # restored at step 5's state, then steps 10 and 11 applied
    assert int(out["state"]["step"]) == 7
    params = model.init(seed=0)
    like = {"params": params, "opt": init_opt_state(params, OptConfig()),
            "step": torch.zeros((), dtype=torch.int32)}
    ck, step = restore_checkpoint(tmp_path, like, step=5)
    assert int(ck["step"]) == 5


@pytest.fixture(scope="module")
def ref_sparse_run(tmp_path_factory):
    """The paper's schedule in the reference: factorized qwen2.5 smoke
    (``min_dim`` 32, the default ranks), sparse from step 4, a hard
    projection every 4 steps, 12 steps."""
    from repro.core.factorized import FactorizationConfig
    from repro.data import lm_batches
    from repro.optim import OptConfig
    from repro.train import TrainLoopConfig, train
    d = tmp_path_factory.mktemp("ref_sparse")
    jm = _ref_model(FactorizationConfig(enabled=True, min_dim=32))
    out = train(jm, lm_batches(jm.cfg.vocab_size, batch=2, seq=16, seed=0),
                OptConfig(**OPT), TrainLoopConfig(
                    total_steps=12, ckpt_dir=str(d), ckpt_every=4,
                    log_every=1, sparse_from_step=4, project_every=4))
    return {"model": jm, "history": out["history"],
            "params": tp.to_numpy_tree(out["state"]["params"])}


def test_factorized_schedule_matches_reference(ref_sparse_run, tmp_path):
    """Dense warmup, then sparse training (STE + out-of-support L1) and
    the projection every 4 steps, run by the port in two parts (8 steps,
    then a restart to 12 from the step-8 checkpoint): the reference's
    uninterrupted history; after each projection (steps 7 and 11) every
    W_D column holds exactly ``nnz_for(r)`` non-zeros; at the end, the
    reference's support but for near-ties (at most ``FRAC_STEP`` of the
    entries) and its params."""
    from repro_torch.core.factorized import FactorizationConfig
    from repro_torch.data import lm_batches
    from repro_torch.optim import OptConfig
    from repro_torch.train import TrainLoopConfig, train
    fcfg = FactorizationConfig(enabled=True, min_dim=32)
    model = _port_model(fcfg)
    p0 = _init_params(ref_sparse_run["model"])
    data = lm_batches(model.cfg.vocab_size, batch=2, seq=16, seed=0)
    ref_hist = ref_sparse_run["history"]
    for start, total in ((0, 8), (8, 12)):
        out = train(model, data, OptConfig(**OPT), TrainLoopConfig(
            total_steps=total, ckpt_dir=str(tmp_path), ckpt_every=4,
            log_every=1, sparse_from_step=4, project_every=4), params=p0)
        _hist_close(out["history"],
                    [h for h in ref_hist if start <= h["step"] < total])
        got = tp.flat_tree(out["state"]["params"])
        wd = [k for k in got if k.endswith("/wd")]
        assert len(wd) == 7
        for k in wd:
            nz = (got[k] != 0).sum(-2)
            assert (nz == fcfg.nnz_for(got[k].shape[-2])).all(), k
    want = tp.flat_tree(ref_sparse_run["params"])
    for k in wd:
        agree = (got[k].numpy() != 0) == (want[k] != 0)
        assert 1 - agree.mean() <= FRAC_STEP, k
    _params_close(out["state"]["params"], ref_sparse_run["params"],
                  OPT["lr"], 12)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip_keep_k_and_async_snapshot(tmp_path):
    """The reference test's round trip and keep-2, plus a bf16 leaf and an
    ``async_save`` whose tensors change after the call."""
    from repro_torch.checkpoint import (async_save, latest_step,
                                        restore_checkpoint, save_checkpoint,
                                        wait_pending)
    tree = {"w": torch.arange(12.0).reshape(3, 4),
            "s": torch.tensor(7, dtype=torch.int32),
            "nested": {"x": torch.ones(2), "h": torch.full(
                (3,), 1.5, dtype=torch.bfloat16)}}
    for step in (10, 20, 30, 40):
        save_checkpoint(tmp_path, step, tree, keep=2)
    assert latest_step(tmp_path) == 40
    assert sorted(p.name for p in tmp_path.iterdir()) \
        == ["step_00000030", "step_00000040"]
    like = {"w": torch.zeros(3, 4), "s": torch.zeros((), dtype=torch.int32),
            "nested": {"x": torch.zeros(2),
                       "h": torch.zeros(3, dtype=torch.bfloat16)}}
    got, step = restore_checkpoint(tmp_path, like)
    assert step == 40 and int(got["s"]) == 7
    assert torch.equal(got["w"], tree["w"])
    assert torch.equal(got["nested"]["h"], tree["nested"]["h"])
    async_save(tmp_path, 50, tree, keep=3)
    tree["w"].add_(100.0)  # after the snapshot
    wait_pending()
    got, step = restore_checkpoint(tmp_path, like)
    assert step == 50 and float(got["w"].max()) == 11.0
    assert latest_step(tmp_path / "none") is None


def test_checkpoint_shape_mismatch_and_missing_leaf_raise(tmp_path):
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    save_checkpoint(tmp_path, 1, {"w": torch.ones(2, 2)})
    with pytest.raises(ValueError, match="shape mismatch"):
        restore_checkpoint(tmp_path, {"w": torch.zeros(3, 3)})
    with pytest.raises(KeyError, match="missing leaf v"):
        restore_checkpoint(tmp_path, {"w": torch.zeros(2, 2),
                                      "v": torch.zeros(1)})
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(tmp_path / "empty", {"w": torch.zeros(2, 2)})


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_checkpoints_cross_read_both_ways(opt, tmp_path):
    """A train state (params, optimizer state in its layout, step)
    written by either package restores in the other, bit for bit."""
    import jax
    import jax.numpy as jnp
    from repro.checkpoint import restore_checkpoint as j_restore
    from repro.checkpoint import save_checkpoint as j_save
    from repro.optim import OptConfig as JO, init_opt_state as j_init
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.models.bridge import state_from_numpy
    jm = _ref_model()
    jp = jm.init(jax.random.key(1))
    rng = np.random.default_rng(0)
    jopt = jax.tree.map(lambda a: jnp.asarray(rng.standard_normal(
        a.shape).astype(np.float32)), j_init(jp, JO(name=opt,
                                                    factored_min_dim=16)))
    jstate = {"params": jp, "opt": jopt, "step": jnp.int32(9)}
    j_save(tmp_path / "ref", 9, jstate)
    like = state_from_numpy(jax.tree.map(
        lambda a: np.zeros(a.shape, a.dtype), tp.to_numpy_tree(jstate)),
        "cpu")
    got, step = restore_checkpoint(tmp_path / "ref", like)
    assert step == 9
    tp.assert_tree_close(got, tp.to_numpy_tree(jstate), 0.0)
    save_checkpoint(tmp_path / "port", 4, got)
    back, step = j_restore(tmp_path / "port", jax.tree.map(
        jnp.zeros_like, jstate))
    assert step == 4
    tp.assert_tree_close(tp.to_numpy_tree(back), tp.to_numpy_tree(jstate),
                         0.0)


def test_serve_ckpt_serves_reference_checkpoint_tokens(ref_fault_run,
                                                       tmp_path):
    """``launch/serve.py --ckpt`` on the checkpoint the reference's
    ``train`` wrote (a ``{"params", "opt", "step"}`` state) serves the
    reference Engine's tokens on the same restored params at float32; a
    bare params tree restores too (the reference's fallback)."""
    import jax
    from repro.checkpoint import restore_checkpoint as j_restore
    from repro.checkpoint import save_checkpoint as j_save
    from repro.data import request_lengths
    from repro.serve import Engine, EngineConfig, Request
    from repro_torch.launch import serve
    jm = ref_fault_run["model"]
    params = jm.init(jax.random.key(0))
    argv = ["--arch", "qwen2.5-32b", "--dtype", "float32", "--requests",
            "6", "--max-len", "32", "--max-new", "4", "--device", "cpu"]
    cases = {"state": ref_fault_run["dir"], "bare": tmp_path / "bare"}
    restored, _ = j_restore(ref_fault_run["dir"], {"params": params})
    j_save(cases["bare"], 3, restored["params"])
    eng = Engine(jm, restored["params"], config=EngineConfig(
        max_len=32, max_new_tokens=4))
    rng = np.random.default_rng(0)
    for rid, n in enumerate(request_lengths(6, 32, "bert")):
        eng.submit(Request(rid=rid, prompt=rng.integers(
            0, jm.cfg.vocab_size, size=n).astype(np.int32)))
    want = {r.rid: list(map(int, r.output)) for r in eng.run()}
    for name, d in cases.items():
        _, done = serve.main(argv + ["--ckpt", str(d)])
        assert {r.rid: list(map(int, r.output)) for r in done} == want, name


# ---------------------------------------------------------------------------
# launcher
# ---------------------------------------------------------------------------

def test_launch_train_on_cpu_then_serve(tmp_path, capsys):
    """``python -m repro_torch.launch.train`` on the CPU: the factorized
    schedule at smoke size (sparse from a third of the run), checkpoints
    every quarter, finite losses; then a dense run whose checkpoint
    ``launch/serve.py --ckpt`` serves."""
    from repro_torch.checkpoint import latest_step
    from repro_torch.launch import serve, train
    common = ["--arch", "qwen2.5-32b", "--steps", "8", "--batch", "2",
              "--seq", "16", "--device", "cpu"]
    out = train.main(common + ["--factorized", "--ckpt",
                               str(tmp_path / "f")])
    assert latest_step(tmp_path / "f") == 8
    assert all(np.isfinite(h["loss"]) for h in out["history"])
    assert out["history"][-1]["sparse"]
    train.main(common + ["--ckpt", str(tmp_path / "d")])
    assert "done: final loss" in capsys.readouterr().out
    _, done = serve.main(["--arch", "qwen2.5-32b", "--requests", "3",
                          "--max-len", "16", "--max-new", "2", "--ckpt",
                          str(tmp_path / "d"), "--device", "cpu"])
    assert len(done) == 3
    assert "loaded checkpoint step 8" in capsys.readouterr().out


def test_launch_train_one_device_mesh(tmp_path):
    """``--mesh-data 1 --mesh-model 1`` (and ``--mesh-data 1`` alone), a
    one-device mesh the reference trains on, trains as no mesh: the same
    losses and grad norms, step for step, as the run without the flags
    (2 steps at smoke size on the CPU)."""
    from repro_torch.launch import train
    common = ["--arch", "qwen2.5-32b", "--steps", "2", "--batch", "2",
              "--seq", "16", "--device", "cpu"]
    runs = {}
    for name, flags in (("plain", []),
                        ("mesh11", ["--mesh-data", "1", "--mesh-model", "1"]),
                        ("mesh1", ["--mesh-data", "1"])):
        out = train.main(common + flags + ["--ckpt", str(tmp_path / name)])
        runs[name] = [(h["step"], h["loss"], h["grad_norm"])
                      for h in out["history"]]
    assert len(runs["plain"]) == 2
    assert runs["mesh11"] == runs["plain"] == runs["mesh1"]


@pytest.mark.parametrize("flags", [["--mesh-data", "2"],
                                   ["--mesh-model", "2"],
                                   ["--production-mesh"], ["--multi-pod"]])
def test_launch_train_refuses_mesh_flags(flags, tmp_path):
    """The mesh flags were refused until sharded training came. Now
    ``--mesh-data 2`` and ``--mesh-model 2`` train on two gloo ranks (2
    steps at smoke size on the CPU, every loss finite), and
    ``--production-mesh`` / ``--multi-pod`` are refused only on a run
    without the 256 / 512 ranks they need, naming the count."""
    from repro_torch.launch import train
    argv = ["--arch", "qwen2.5-32b", "--device", "cpu"] + flags
    if flags[0] in ("--production-mesh", "--multi-pod"):
        n = 512 if flags[0] == "--multi-pod" else 256
        with pytest.raises(RuntimeError, match=f"needs {n} ranks"):
            train.main(argv)
        return
    out = train.main(argv + ["--steps", "2", "--batch", "2", "--seq", "16",
                             "--ckpt", str(tmp_path)])
    assert [h["step"] for h in out["history"]] == [0, 1]
    assert all(np.isfinite(h["loss"]) for h in out["history"])


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_cuda_train_matches_cpu(tmp_path):
    """``chip_smoke.py``'s train phase, part (a), in small: the port's
    ``train`` on the card and on the CPU from the same params and stream
    (float32, TF32 off), dense and then factorized (sparse from step 4, a
    projection every 4 steps), with a NaN batch at step 7: the same steps
    recorded, losses within ``chip_smoke.py``'s ``TRAIN_LOSS_TOL`` (1e-3:
    cuBLAS and the CPU's BLAS sum in other orders, and the trajectory
    amplifies it, see ``ATOL_HIST``), exact nnz per W_D column after
    training."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the port's CUDA device)")
    from repro_torch.configs import get_config
    from repro_torch.core.factorized import FactorizationConfig
    from repro_torch.data import lm_batches
    from repro_torch.models.transformer import Model
    from repro_torch.optim import OptConfig
    from repro_torch.train import TrainLoopConfig, train
    tp.tf32_off()

    def to(tree, dev):
        if isinstance(tree, dict):
            return {k: to(v, dev) for k, v in tree.items()}
        return tree.to(dev, copy=True)

    for fcfg in (None, FactorizationConfig(enabled=True, min_dim=32)):
        over = {} if fcfg is None else {"factorization": fcfg}
        cfg = get_config("qwen2.5-32b", "smoke", dtype="float32", **over)
        host = Model(cfg, device="cpu").init(seed=0)
        hists = {}
        for dev in ("cpu", "cuda"):
            out = train(Model(cfg, device=dev),
                        lm_batches(cfg.vocab_size, batch=2, seq=16, seed=0),
                        OptConfig(**OPT), TrainLoopConfig(
                            total_steps=12, ckpt_every=4, log_every=1,
                            ckpt_dir=str(tmp_path / f"{dev}{fcfg is None}"),
                            sparse_from_step=4, project_every=4),
                        hooks={"inject_fault": _poison({7},
                                                       cfg.vocab_size)},
                        params=to(host, dev))
            hists[dev] = out["history"]
            for k, v in tp.flat_tree(out["state"]["params"]).items():
                if k.endswith("/wd"):
                    assert ((v != 0).sum(-2)
                            == fcfg.nnz_for(v.shape[-2])).all(), k
        steps = [h["step"] for h in hists["cuda"]]
        assert steps == [h["step"] for h in hists["cpu"]] and 7 not in steps
        for a, b in zip(hists["cuda"], hists["cpu"]):
            assert abs(a["loss"] - b["loss"]) <= 1e-3, (a, b)
