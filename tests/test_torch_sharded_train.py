"""Sharded training of the port (``launch/mesh.py``, ``launch/sharding.py``,
``launch/steps.py``, ``optim/``, ``train/loop.py``, ``checkpoint/``,
``launch/train.py``) against the JAX reference on the CPU, float32,
smoke widths, inputs made with numpy from fixed seeds.

One spawn of four gloo ranks (``tests/_torch_parity.py::
rank_sharded_train``) serves every mesh case, with new groups inside the
same processes: ``(2, 2)``, ``(2, 2, 1)`` ``(pod, data, model)`` and
``(4, 1)``. The reference's single-device runs are module fixtures, and
its sharded MoE step and pod compression run in one ``mesh_cpu(4)``
child.

Tolerances, each with its reason:

* ``RTOL`` 1e-5 of ``max(1, max |ref|)`` per leaf, for gradients, losses,
  ``grad_norm``, params and moments: the reference's GSPMD step is the
  same arithmetic on whole arrays; the port sums the same products in
  another order (partial sums over ``model``, the batch over ``data``),
  1e-7 of the values (measured). The updates are AdamW / Adafactor steps
  at the warmup's first learning rates (``lr * (step + 1) /
  warmup_steps``, 1e-5 and 2e-5), so an entry whose gradient sits at the
  noise of that reordering, whose update's sign the noise decides, moves
  by at most ``2 * lr`` apart, inside the limit.
* The launcher's losses within 1e-5 of the unmeshed run's, as asked of it.
* Replicated leaves across one ``model`` group: bitwise equal (every value
  that reaches them comes out of one all-reduce, received by every rank).
* The pod compression: exact against the reference (the same f32 and
  bf16 roundings).
"""
from __future__ import annotations

import functools
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_parity as tp  # noqa: E402

RTOL = 1e-5
B, S = 8, 32
OPT_DENSE = dict(name="adamw", lr=1e-3, warmup_steps=100, total_steps=1000)
OPT_FACT = dict(name="adafactor", lr=1e-3, warmup_steps=100,
                total_steps=1000, factored_min_dim=16)
OPT_ELASTIC = dict(name="adamw", lr=1e-3, warmup_steps=100,
                   total_steps=1000)


def _batches(cfg, n, seed=4):
    rng = np.random.default_rng(seed)
    return [tp.train_batch(cfg, rng, B=B, S=S) for _ in range(n)]


def _close(got, want, what=""):
    """Every leaf within RTOL of max(1, max |want|)."""
    g, w = tp.flat_tree(got), tp.flat_tree(want)
    assert sorted(g) == sorted(w), (what, set(g) ^ set(w))
    for k in w:
        a, b = np.asarray(g[k], np.float32), np.asarray(w[k], np.float32)
        assert a.shape == b.shape, (what, k, a.shape, b.shape)
        lim = RTOL * max(1.0, float(np.abs(b).max()) if b.size else 0.0)
        err = float(np.abs(a - b).max()) if b.size else 0.0
        assert err <= lim, (what, k, err, lim)


@functools.lru_cache(maxsize=None)
def _ref_run(fact: bool, steps: int):
    """The reference's single-device ``make_train_step`` on qwen2.5 smoke:
    per step the gradients at the step's params, the metrics, and the
    params and optimizer state after it."""
    import jax
    import jax.numpy as jnp
    from repro.launch.steps import make_train_step
    from repro.optim import OptConfig, init_opt_state
    from repro.train.loop import make_project_fn
    cfg, m, p = tp.jax_smoke("qwen2.5-32b", **tp.fcfg_over("jax", fact))
    oc = OptConfig(**(OPT_FACT if fact else OPT_DENSE))
    state = {"params": p, "opt": init_opt_state(p, oc),
             "step": jnp.zeros((), jnp.int32)}
    step = jax.jit(make_train_step(
        m, oc, sparse_train=fact,
        project_fn=make_project_fn(cfg.factorization) if fact else None))
    grad = jax.jit(jax.grad(lambda q, b: m.loss(q, b, sparse_train=fact)[0]))
    batches = _batches(cfg, steps)
    recs = []
    for b in batches:
        g = grad(state["params"], b)
        state, met = step(state, b)
        recs.append({"grads": tp.to_numpy_tree(g),
                     "metrics": {k: float(v) for k, v in met.items()},
                     "params": tp.to_numpy_tree(state["params"]),
                     "opt": tp.to_numpy_tree(state["opt"])})
    return tp.to_numpy_tree(p), batches, recs


def _moe_params():
    from repro.core.factorized import FactorizationConfig
    cfg, _, p = tp.jax_smoke("dbrx-132b", factorization=FactorizationConfig(
        **tp.MOE_FCFG))
    return cfg, tp.to_numpy_tree(p)


def _grad_rounds(per_pod: bool):
    rng = np.random.default_rng(11)

    def one():
        return {"a": rng.standard_normal((8, 6)).astype(np.float32),
                "b": (1e-3 * rng.standard_normal(5)).astype(np.float32)}
    return [[one(), one()] if per_pod else one() for _ in range(2)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every port case in one spawn of four gloo ranks."""
    from repro_torch.launch.mesh import run_ranks
    dense_p, dense_b, _ = _ref_run(False, 2)
    fact_p, fact_b, _ = _ref_run(True, 1)
    mcfg, moe_p = _moe_params()
    dense = dict(arch="qwen2.5-32b", fcfg=None, params=dense_p,
                 batches=dense_b, opt=OPT_DENSE, sparse=False,
                 project=False)
    job = {
        "train": {
            "dense": dict(dense, mesh=(2, 2)),
            "pod": dict(dense, mesh=(2, 2, 1)),
            "fact": dict(arch="qwen2.5-32b", fcfg=tp.FCFG, params=fact_p,
                         batches=fact_b, opt=OPT_FACT, sparse=True,
                         project=True, mesh=(2, 2)),
            "moe": dict(arch="dbrx-132b", fcfg=tp.MOE_FCFG, params=moe_p,
                        batches=_batches(mcfg, 1), opt=OPT_DENSE,
                        sparse=True, project=False, mesh=(2, 2)),
        },
        "compress": {"equal": dict(per_pod=False,
                                   rounds=_grad_rounds(False)),
                     "unequal": dict(per_pod=True,
                                     rounds=_grad_rounds(True))},
        "elastic": dict(params=dense_p, opt=OPT_ELASTIC,
                        batches=_batches(_ref_cfg(), 3, seed=9),
                        dir=str(tmp_path_factory.mktemp("elastic"))),
    }
    return tp.run_sharded_train(job)


def _ref_cfg():
    from repro.configs import get_config
    return get_config("qwen2.5-32b", "smoke", dtype="float32")


# ---------------------------------------------------------------------------
# the train step against the reference's single-device step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case,fact,steps", [
    ("dense", False, 2), ("pod", False, 2), ("fact", True, 1)])
def test_sharded_step_matches_single_device(ranks, case, fact, steps):
    """(2, 2) AdamW (dense), (2, 2, 1) pod mesh AdamW with ZeRO'd moments,
    (2, 2) factorized sparse training with Adafactor and the post-update
    projection: the assembled gradients, every metric (loss, xent, aux,
    sparsity_reg, grad_norm, lr), params and moments after each step."""
    _, _, want = _ref_run(fact, steps)
    got = ranks["train"][case]
    assert len(got) == len(want) == steps
    for i, (g, w) in enumerate(zip(got, want)):
        assert sorted(g["metrics"]) == sorted(w["metrics"])
        for k, v in w["metrics"].items():
            assert abs(g["metrics"][k] - v) <= RTOL * max(1.0, abs(v)), \
                (case, i, k, g["metrics"][k], v)
        _close(g["grads"], w["grads"], f"{case} grads {i}")
        _close(g["params"], w["params"], f"{case} params {i}")
        _close(g["opt"], w["opt"], f"{case} opt {i}")


@pytest.mark.parametrize("case", ["dense", "fact", "moe"])
def test_replicated_leaves_bitwise_equal_in_model_group(ranks, case):
    """The ranks of one ``model`` group hold bitwise-equal copies of every
    leaf the placement replicates over ``model`` (and equal-shaped slices
    elsewhere) after the update."""
    from repro_torch.launch.sharding import spec_axes
    groups = {}
    for r in ranks["ranks"]:
        coords, local, specs = r["local"][case]
        groups.setdefault(coords["data"], []).append((local, specs))
    assert len(groups) == 2 and all(len(v) == 2 for v in groups.values())
    n_rep = 0
    for (a, specs), (b, _) in groups.values():
        fa, fb, fs = tp.flat_tree(a), tp.flat_tree(b), tp.flat_tree(specs)
        for k, sp in fs.items():
            assert fa[k].shape == fb[k].shape
            if "model" not in [x for e in sp for x in spec_axes(e)]:
                np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)
                n_rep += 1
    assert n_rep > 0


def test_moe_sparse_step_matches_reference_sharded(ranks, mesh_cpu):
    """dbrx smoke, factorized, ``sparse_train``, one AdamW step on (2, 2)
    against the reference's ``make_train_step(mesh=)`` on a (2, 2) host
    mesh (expert capacity per data shard, aux averaged over ``data``,
    no expert STE on a mesh): loss, metrics, gradients, params and
    moments."""
    ref = _ref_mesh(mesh_cpu)
    _, moe_p = _moe_params()
    _close(ref["init"], moe_p, "the child's init")
    got = ranks["train"]["moe"][0]
    for k, v in ref["metrics"].items():
        assert abs(got["metrics"][k] - v) <= RTOL * max(1.0, abs(v)), \
            (k, got["metrics"][k], v)
    _close(got["grads"], ref["grads"], "moe grads")
    _close(got["params"], ref["params"], "moe params")
    _close(got["opt"], ref["opt"], "moe opt")


_REF_MESH: dict = {}


def _ref_mesh(mesh_cpu):
    """The reference's sharded MoE step and its pod compression, in one
    ``mesh_cpu(4)`` child (run once per module)."""
    if _REF_MESH:
        return _REF_MESH
    import tempfile
    cfg, _ = _moe_params()
    batch = _batches(cfg, 1)[0]
    with tempfile.TemporaryDirectory() as d:
        np.savez(f"{d}/in.npz", **batch)
        with open(f"{d}/rounds.json", "w") as f:
            json.dump({k: _listed(_grad_rounds(k == "unequal"))
                       for k in ("equal", "unequal")}, f)
        mesh_cpu(4, _CHILD.replace("{dir}", d))
        with np.load(f"{d}/out.npz") as z:
            flat = {k: z[k] for k in z.files}
    out = {}
    for k, v in flat.items():
        node = out
        parts = k.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    out["metrics"] = {k: float(v) for k, v in out["metrics"].items()}
    _REF_MESH.update(out)
    return _REF_MESH


def _listed(rounds):
    def lst(t):
        return {k: v.tolist() for k, v in t.items()}
    return [[lst(x) for x in r] if isinstance(r, list) else lst(r)
            for r in rounds]


_CHILD = """
import dataclasses
from repro.configs import get_config
from repro.core.factorized import FactorizationConfig
from repro.launch.mesh import make_local_mesh
from repro.launch.steps import make_train_step
from repro.models.transformer import Model
from repro.optim import (OptConfig, compress_pod_allreduce, init_ef_state,
                         init_opt_state)
d = "{dir}"
cfg = get_config("dbrx-132b", "smoke", dtype="float32",
                 factorization=FactorizationConfig(%s))
m = Model(cfg)
p = m.init(jax.random.key(0))
batch = dict(np.load(d + "/in.npz"))
oc = OptConfig(%s)
state = {"params": p, "opt": init_opt_state(p, oc),
         "step": jnp.zeros((), jnp.int32)}
mesh = make_local_mesh(2, 2)
with mesh:
    g = jax.jit(jax.grad(lambda q: m.loss(q, batch, mesh=mesh,
                                          sparse_train=True)[0]))(p)
    new, met = jax.jit(make_train_step(m, oc, mesh=mesh,
                                       sparse_train=True))(state, batch)
flat = {}
def put(pre, tree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(k, "key", k)) for k in path)
        flat[pre + "/" + key] = np.asarray(leaf, np.float32)
put("init", p); put("grads", g); put("params", new["params"])
put("opt", new["opt"]); put("metrics", met)
pmesh = jax.sharding.Mesh(np.array(jax.devices()[:2]), ("pod",))
rounds = json.load(open(d + "/rounds.json"))["equal"]
ef = None
for i, r in enumerate(rounds):
    gr = {k: jnp.asarray(np.asarray(v, np.float32)) for k, v in r.items()}
    ef = init_ef_state(gr) if ef is None else ef
    gr, ef = compress_pod_allreduce(gr, ef, pmesh, n_pods=2)
    put("compress/%%d/g" %% i, gr); put("compress/%%d/ef" %% i, ef)
np.savez(d + "/out.npz", **flat)
print(json.dumps({"ok": True}))
""" % (", ".join(f"{k}={v!r}" for k, v in tp.MOE_FCFG.items()),
       ", ".join(f"{k}={v!r}" for k, v in OPT_DENSE.items()))


# ---------------------------------------------------------------------------
# pod compression
# ---------------------------------------------------------------------------

def test_compress_pod_allreduce_equal_grads_match_reference(ranks,
                                                            mesh_cpu):
    """Equal gradients on both pods of the (2, 2, 1) mesh: outputs and
    error feedback over two rounds equal the reference's
    ``compress_pod_allreduce`` on a 2-device pod mesh."""
    ref = _ref_mesh(mesh_cpu)["compress"]
    for r in ranks["ranks"]:
        _, rounds = r["compress"]["equal"]
        for i, (g, ef) in enumerate(rounds):
            for k in g:
                np.testing.assert_array_equal(g[k], ref[str(i)]["g"][k])
                np.testing.assert_array_equal(ef[k], ref[str(i)]["ef"][k])


def _np_compress(rounds):
    """The reference's per-pod body in numpy, for pods holding different
    gradients: ``[(mean, [ef of pod 0, ef of pod 1]), ...]``."""
    import ml_dtypes
    bf16 = ml_dtypes.bfloat16
    ef = [{k: np.zeros(v.shape, bf16) for k, v in rounds[0][0].items()}
          for _ in range(2)]
    out = []
    for r in rounds:
        mean, new_ef = {}, [{}, {}]
        for k in r[0]:
            deq = []
            for p in range(2):
                x = r[p][k].astype(np.float32) + ef[p][k].astype(np.float32)
                scale = np.float32(np.abs(x).max() + np.float32(1e-12)) \
                    / np.float32(127.0)
                q = np.clip(np.round(x / scale), -127, 127).astype(np.int8)
                dq = q.astype(np.float32) * scale
                new_ef[p][k] = (x - dq).astype(bf16)
                deq.append(dq.astype(bf16))
            total = (deq[0].astype(np.float32) + deq[1].astype(np.float32)
                     ).astype(bf16)
            mean[k] = total.astype(np.float32) / np.float32(2)
        ef = new_ef
        out.append((mean, [{k: v.astype(np.float32) for k, v in e.items()}
                           for e in new_ef]))
    return out


def test_compress_pod_allreduce_unequal_grads_match_numpy(ranks):
    """Different gradients on the two pods: every rank's output equals a
    numpy rendering of the reference's per-pod arithmetic, and each pod's
    error feedback its own."""
    want = _np_compress(_grad_rounds(True))
    for r in ranks["ranks"]:
        pod, rounds = r["compress"]["unequal"]
        for (g, ef), (mean, efs) in zip(rounds, want):
            for k in mean:
                np.testing.assert_array_equal(g[k], mean[k])
                np.testing.assert_array_equal(ef[k], efs[pod][k])


# ---------------------------------------------------------------------------
# elastic restore, the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("where", ["(4, 1)", "none"])
def test_elastic_restore_takes_the_same_step(ranks, where):
    """A run saved on (2, 2) after 2 steps resumes on (4, 1) or without a
    mesh: the next step's loss and the params after it equal the
    uninterrupted (2, 2) run's."""
    el = ranks["elastic"]
    whole_loss, whole_p = el["whole"]
    loss, p = el[where]
    assert len(whole_loss) == 3 and len(loss) == 1
    assert abs(loss[0] - whole_loss[2]) <= RTOL * max(1.0, whole_loss[2])
    _close(p, whole_p, where)


def test_launcher_mesh_losses_match_unmeshed(ranks):
    """``launch/train.py --mesh-data 2 --mesh-model 2 --device cpu
    --backend gloo`` at smoke size (float32): the losses of the unmeshed
    run within 1e-5."""
    meshed, plain = ranks["launch"]
    assert len(meshed) == len(plain) >= 2
    np.testing.assert_allclose(meshed, plain, rtol=0, atol=1e-5)


@pytest.mark.parametrize("flag,n", [("--production-mesh", 256),
                                    ("--multi-pod", 512)])
def test_launcher_production_mesh_needs_its_ranks(flag, n):
    from repro_torch.launch.train import main
    with pytest.raises(RuntimeError, match=f"needs {n} ranks"):
        main(["--arch", "qwen2.5-32b", flag, "--device", "cpu"])


# ---------------------------------------------------------------------------
# placement rules at production size (no processes)
# ---------------------------------------------------------------------------

def _norm(spec, nd):
    """A spec as a tuple of ``nd`` entries, one-axis tuples as the axis."""
    out = []
    for e in tuple(spec):
        out.append(e[0] if isinstance(e, tuple) and len(e) == 1 else
                   (tuple(e) if isinstance(e, (tuple, list)) else e))
    return tuple(out) + (None,) * (nd - len(out))


@pytest.mark.parametrize("arch", ["qwen2.5-32b", "dbrx-132b"])
@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_specs_match_reference(arch, multi_pod):
    """``param_specs``, ``opt_state_specs``, ``batch_spec`` and
    ``cache_specs`` at the reference's production meshes, (16, 16) and
    (2, 16, 16), for the full configs: the reference's rule functions read
    only ``mesh.shape`` and ``mesh.axis_names``, so both packages get
    the same stand-in (``production_mesh_shape``) and the reference's
    ``jax.eval_shape`` shapes."""
    import jax
    from repro.configs import get_config
    from repro.launch import sharding as rs
    from repro.launch.steps import batch_shapes
    from repro.models.transformer import Model
    from repro_torch.launch import sharding as ts
    from repro_torch.launch.mesh import (devices_per_pod,
                                         production_mesh_shape)
    ms = production_mesh_shape(multi_pod)
    assert devices_per_pod(ms) == (256 if multi_pod else 0)
    cfg = get_config(arch, "full")
    model = Model(cfg)
    shapes = jax.eval_shape(lambda: model.init(jax.random.key(0)))
    shapes = tp.flat_tree(jax.tree.map(lambda x: x, shapes,
                                       is_leaf=lambda x: hasattr(x, "shape")))
    tree = {}
    for k, v in shapes.items():
        node = tree
        parts = k.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v

    def cmp(ref, got, what):
        fr = tp.flat_tree(jax.tree.map(
            lambda s: s, ref, is_leaf=lambda x: isinstance(
                x, jax.sharding.PartitionSpec)))
        fg = tp.flat_tree(got)
        assert sorted(fr) == sorted(fg), what
        for k in fr:
            nd = max(len(tuple(fr[k])), len(fg[k]))
            assert _norm(fr[k], nd) == _norm(fg[k], nd), (what, k, fr[k],
                                                           fg[k])

    rp = rs.param_specs(tree, ms)
    tps = ts.param_specs(tree, ms)
    cmp(rp, tps, "param_specs")
    cmp(rs.opt_state_specs(rp, ms, param_shapes=tree),
        ts.opt_state_specs(tps, ms, tree), "opt_state_specs")
    batch = batch_shapes(cfg, "train_4k")
    cmp(rs.batch_spec(batch, ms), ts.batch_spec(batch, ms), "batch_spec")
    caches = jax.eval_shape(lambda: model.init_cache(32, 1024))
    for decode in (False, True):
        cmp(rs.cache_specs(caches, ms, cfg.uniform_layers, decode=decode),
            ts.cache_specs(caches, ms, cfg.uniform_layers, decode=decode),
            f"cache_specs decode={decode}")
