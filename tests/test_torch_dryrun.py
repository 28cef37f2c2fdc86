"""The dry run's pieces (``configs.SHAPES`` / ``shapes_for``,
``Model.param_shapes``, ``launch/steps.py``'s shapes and bundles,
``launch/dryrun.py::model_flops``) against the reference's, and the dry
run itself on placeholder ranks: a ``fake`` process group of 8 ranks in a
child process, rank 0's step on fake tensors.

* ``param_shapes`` of all ten archs at full width: the reference's
  ``Model.param_shapes()`` leaf for leaf (paths, shapes, dtypes);
* ``SHAPES``, ``shapes_for``, ``batch_shapes`` and ``model_flops`` for
  every arch and shape; ``train_state_shapes`` of qwen2.5-32b and
  dbrx-132b;
* on a ``(4, 2)`` mesh the train cell's FLOPs on rank 0, times 8, equal
  the unsharded step's at the same global batch, exactly, plus the work
  that every rank of ``model`` repeats: the MoE router's product, which
  the reference too computes replicated (qwen2.5 and dbrx smoke);
* the decode cells refused at ``(4, 2)`` and ``(2, 4)`` (every arch at
  smoke size) are the reference's, with its message: the reference's
  decode bundles lowered on 8 host devices in a second child;
* ``run_ranks`` refuses the ``fake`` backend;
* a fake run leaves no fake tensor in ``moe.ROUTER_COUNTS``: a real dbrx
  decode after a fake one gives the reference's logits.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_parity as tp  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
MESHES = ((4, 2), (2, 4))
TRAIN_CELL = {"seq": 64, "batch": 16, "step": "train"}

PORT_CHILD = """
import json, sys
from repro_torch.configs import get_config, list_archs
from repro_torch.launch.dryrun import measure, placeholder_mesh
out = {"flops": {}, "refused": {}}
meshes = {m: placeholder_mesh({"data": m[0], "model": m[1]})
          for m in MESHES}
for arch in ("qwen2.5-32b", "dbrx-132b"):
    cfg = get_config(arch, "smoke")
    out["flops"][arch] = [measure(cfg, TRAIN_CELL, meshes[(4, 2)])["flops"],
                          measure(cfg, TRAIN_CELL, None)["flops"]]
for arch in list_archs():
    cfg = get_config(arch, "smoke")
    for m, mesh in meshes.items():
        try:
            measure(cfg, "decode_32k", mesh)
        except ValueError as e:
            out["refused"][f"{arch}@{m[0]}x{m[1]}"] = str(e)
print(json.dumps(out))
"""

REF_CHILD = """
import json
import jax
from repro.configs import get_config, list_archs
from repro.launch.mesh import compat_make_mesh
from repro.launch.steps import build_bundle
out = {}
for arch in list_archs():
    cfg = get_config(arch, "smoke")
    for m in MESHES:
        mesh = compat_make_mesh(m, ("data", "model"))
        b = build_bundle(cfg, "decode_32k", mesh)
        try:
            with mesh:
                jax.jit(b.fn, in_shardings=b.in_shardings,
                        out_shardings=b.out_shardings).lower(*b.args)
        except ValueError as e:
            out[f"{arch}@{m[0]}x{m[1]}"] = str(e)
print(json.dumps(out))
"""


def _child(code, **env):
    full = dict(os.environ, PYTHONPATH=str(ROOT / "src"), **env)
    pre = f"MESHES = {MESHES!r}\nTRAIN_CELL = {TRAIN_CELL!r}\n"
    return subprocess.Popen([sys.executable, "-c", pre + code], env=full,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


@pytest.fixture(scope="module")
def children():
    """The port's placeholder-rank child and the reference's lowering
    child, run side by side."""
    procs = {
        "port": _child(PORT_CHILD, OMP_NUM_THREADS="1"),
        "ref": _child(REF_CHILD, JAX_PLATFORMS="cpu", XLA_FLAGS=(
            "--xla_force_host_platform_device_count=8")),
    }
    out = {}
    for name, p in procs.items():
        stdout, stderr = p.communicate(timeout=600)
        assert p.returncode == 0, f"{name} child failed:\n{stderr[-3000:]}"
        out[name] = json.loads(stdout.strip().splitlines()[-1])
    return out


def _flat_shapes(tree):
    return {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in tp.flat_tree(tree).items()}


@pytest.mark.parametrize("arch", ["qwen2.5-32b", "starcoder2-15b", "yi-34b",
                                  "qwen1.5-4b", "llava-next-mistral-7b",
                                  "recurrentgemma-2b", "musicgen-large",
                                  "mamba2-370m", "dbrx-132b", "arctic-480b"])
def test_param_shapes_match_reference(arch):
    from repro.configs import get_config as ref_config
    from repro.models.transformer import Model as RefModel
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import Model
    want = _flat_shapes(RefModel(ref_config(arch)).param_shapes())
    got_tree = Model(get_config(arch), device="cpu").param_shapes()
    assert all(torch._subclasses.fake_tensor.is_fake(v)
               for v in tp.flat_tree(got_tree).values())
    assert _flat_shapes(got_tree) == want


def _ref_dryrun():
    """``repro.launch.dryrun`` sets ``XLA_FLAGS`` when imported: keep this
    process's."""
    before = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun
    if before is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = before
    return dryrun


def test_shapes_batches_and_model_flops_match_reference():
    from repro import configs as ref_configs
    from repro.launch.steps import batch_shapes as ref_batch_shapes
    from repro_torch import configs
    from repro_torch.launch.dryrun import model_flops
    from repro_torch.launch.steps import batch_shapes
    ref_flops = _ref_dryrun().model_flops
    assert configs.SHAPES == ref_configs.SHAPES
    for arch in configs.list_archs():
        assert configs.shapes_for(arch) == ref_configs.shapes_for(arch)
        cfg, rcfg = configs.get_config(arch), ref_configs.get_config(arch)
        assert cfg.sub_quadratic == rcfg.sub_quadratic
        for shape in configs.SHAPES:
            assert _flat_shapes(batch_shapes(cfg, shape)) == _flat_shapes(
                ref_batch_shapes(rcfg, shape))
            assert model_flops(cfg, shape) == ref_flops(rcfg, shape)


@pytest.mark.parametrize("arch", ["qwen2.5-32b", "dbrx-132b"])
def test_train_state_shapes_match_reference(arch):
    from repro.configs import get_config as ref_config
    from repro.launch.steps import train_state_shapes as ref_state
    from repro.models.transformer import Model as RefModel
    from repro.optim import OptConfig as RefOpt
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import train_state_shapes
    from repro_torch.models.transformer import Model
    from repro_torch.optim import OptConfig
    want = ref_state(RefModel(ref_config(arch)), RefOpt())
    got = train_state_shapes(Model(get_config(arch), device="cpu"),
                             OptConfig())
    assert _flat_shapes(got) == _flat_shapes(want)


def _router_flops(cfg, tokens):
    """The train step's FLOPs of the MoE router's ``(T, d) @ (d, E)``
    over ``tokens`` rows: forward, and the gradients of the tokens and of
    the router (no remat at smoke size), in every layer (each routes)."""
    if cfg.moe is None:
        return 0
    assert cfg.remat == "none"
    return 3 * 2 * tokens * cfg.d_model * cfg.moe.n_experts * cfg.n_layers


@pytest.mark.parametrize("arch", ["qwen2.5-32b", "dbrx-132b"])
def test_sharded_train_flops_times_ranks_equal_unsharded(children, arch):
    """Every product is cut over the 8 ranks except the router's, which
    each of the ``model`` axis's 2 ranks computes on its rows."""
    from repro_torch.configs import get_config
    sharded, whole = children["port"]["flops"][arch]
    data, model = MESHES[0]
    repeated = (model - 1) * _router_flops(
        get_config(arch, "smoke"), TRAIN_CELL["seq"] * TRAIN_CELL["batch"])
    assert (repeated > 0) == (arch == "dbrx-132b")
    assert sharded > 0 and sharded * data * model == whole + repeated


def test_refused_decode_cells_match_reference(children):
    got, want = children["port"]["refused"], children["ref"]
    assert got == want
    assert "mamba2-370m@2x4" not in got  # no attention: nothing to refuse
    assert "qwen2.5-32b@2x4" in got and "qwen1.5-4b@2x4" not in got


def test_run_ranks_refuses_fake_backend():
    from repro_torch.launch.mesh import make_local_mesh, run_ranks
    with pytest.raises(ValueError, match="dry run's only"):
        run_ranks(2, print, device="cpu", backend="fake")
    with pytest.raises(ValueError, match="dry run's only"):
        from repro_torch.launch.mesh import _check_backend
        _check_backend("fake", 2, torch.device("cpu"))
    assert make_local_mesh(1, 1, device="cpu").size == 1


def test_sharded_decode_refusal_matches_reference():
    """A ``(1, 4)`` mesh with smoke heads 4 / 2: the port's Engine refuses
    the mesh before any step (its lanes would hold half a kv head a
    rank); the head-split check of the port's decode on a mesh
    (``check_head_split``, which ``sharded_decode_attention`` and the
    model's mesh decode call) raises the reference's
    ``sharded_decode_attention`` message."""
    from repro.kernels.tda.sharded import \
        sharded_decode_attention as ref_sharded
    from repro_torch.configs import get_config
    from repro_torch.core.errors import UnsupportedConfigError
    from repro_torch.kernels.tda.sharded import check_head_split
    from repro_torch.launch.mesh import AXES, Mesh, MeshShape
    from repro_torch.models.transformer import Model
    from repro_torch.serve import Engine, EngineConfig
    q = np.zeros((2, 1, 4, 16), np.float32)
    kv = np.zeros((2, 8, 2, 16), np.float32)
    with pytest.raises(ValueError) as want:
        ref_sharded(q, kv, kv, 3, mesh=MeshShape({"data": 1, "model": 4},
                                                 AXES))
    with pytest.raises(ValueError) as got:
        check_head_split(2, 4, 4)
    assert str(got.value) == str(want.value)
    mesh = Mesh({"data": 1, "model": 4}, {"data": 0, "model": 0}, {},
                torch.device("cpu"))
    model = Model(get_config("qwen2.5-32b", "smoke"), device="cpu")
    with pytest.raises(UnsupportedConfigError, match="kv_heads=2"):
        Engine(model, model.init(0), EngineConfig(max_len=16), mesh=mesh)


def test_fake_run_leaves_router_counts_real():
    """A dbrx decode on fake tensors, then a real one in the same process:
    the counters hold no fake tensor and the real logits are the
    reference's (``ATOL_LOGITS``)."""
    import jax.numpy as jnp
    from torch._subclasses.fake_tensor import FakeTensorMode, is_fake
    from repro_torch.models import moe
    cfg, rm, rparams = tp.jax_smoke("dbrx-132b")
    model, params = tp.torch_smoke("dbrx-132b", rparams)
    batch = np.random.default_rng(2).integers(0, 256, (2, 6)).astype(
        np.int32)
    tok = np.array([[3], [5]], np.int32)
    moe.reset_router_counts()
    with FakeTensorMode():
        fake = model.param_shapes()
        _, caches = model.prefill(fake, {"inputs": torch.zeros(
            (2, 6), dtype=torch.int32)}, max_len=8)
        model.decode_step(fake, {"inputs": torch.zeros(
            (2, 1), dtype=torch.int32)}, caches, torch.tensor(6))
    assert not any(is_fake(c) for c in moe.ROUTER_COUNTS.values())
    _, caches = model.prefill(params, {"inputs": tp.t(batch)}, max_len=8)
    got, _ = model.decode_step(params, {"inputs": tp.t(tok)}, caches,
                               torch.tensor(6))
    _, rc = rm.prefill(rparams, {"inputs": jnp.asarray(batch)}, max_len=8)
    want, _ = rm.decode_step(rparams, {"inputs": jnp.asarray(tok)}, rc,
                             jnp.int32(6))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=tp.ATOL_LOGITS)
    assert moe.router_counts()["claims"] > 0
