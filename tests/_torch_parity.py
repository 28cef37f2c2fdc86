"""Shared helpers for the PyTorch-port parity tests (``tests/test_torch_*``).

Inputs are made with numpy from fixed seeds and handed to both packages;
reference (JAX) outputs come back as numpy. Import this module only after
``pytest.importorskip("torch")``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

# Tolerances, each with its reason:
# TDA attention at f32: both sides take an f32 softmax over the same
# products; only the summation order differs (online vs one-shot softmax).
ATOL_ATTN = 1e-5
# Layer primitives at f32: same formulas, different BLAS/XLA reduction order.
ATOL_LAYER = 1e-5
# Model logits at f32 through 2 layers plus an f32 LM head: reduction-order
# error compounds over ~10 matmuls and the vocab projection.
ATOL_LOGITS = 1e-4
# Model page pools at f32 (post-RoPE K/V written by the step).
ATOL_POOL = 1e-5
# Training losses of ~6 at f32: the same formulas summed in another order
# by the two backends (measured <= 1e-6).
ATOL_LOSS = 1e-5
# Gradients at f32, per leaf, of max(1, max |ref|): the backward pass
# compounds the same reordering over a few matmuls (measured <= 1.6e-6).
RTOL_GRAD = 1e-5
# The factorization of the training tests (min_dim 32 reaches every smoke
# linear).
FCFG = dict(enabled=True, min_dim=32, rank=32, nnz=8)

ENGINE_KW = dict(max_len=16, max_new_tokens=8, num_slots=3,
                 max_prompt_len=40)
LENGTHS = [5, 25, 12, 18]
BUDGETS = [6, 5, 4, 6]
TICKS = [1, 1, 3, 6]
CPU = torch.device("cpu")


def tf32_off() -> None:
    """Parity needs full f32 products on every device."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def to_numpy_tree(tree):
    """A reference (JAX) pytree -> the same nested dicts of numpy arrays."""
    import jax
    return jax.tree.map(np.asarray, tree)


def t(a, device=CPU, dtype=None) -> torch.Tensor:
    """numpy -> torch (a copy), optionally cast."""
    x = torch.from_numpy(np.array(a, copy=True)).to(device)
    return x if dtype is None else x.to(dtype)


def jax_qwen_smoke(n_layers: int = 2, seed: int = 0, **over):
    """Float32 qwen2.5 smoke in the reference: (cfg, Model, params)."""
    import jax
    from repro.configs import get_config
    from repro.models.transformer import Model
    cfg = get_config("qwen2.5-32b", "smoke", dtype="float32",
                     n_layers=n_layers, **over)
    m = Model(cfg)
    return cfg, m, m.init(jax.random.key(seed))


def torch_qwen_smoke(jax_params, n_layers: int = 2, device=CPU, **over):
    """The port's float32 qwen2.5 smoke on ``device`` with the reference's
    parameters bridged over: (Model, params)."""
    from repro_torch.configs import get_config
    from repro_torch.models.bridge import params_from_numpy
    from repro_torch.models.transformer import Model
    cfg = get_config("qwen2.5-32b", "smoke", dtype="float32",
                     n_layers=n_layers, **over)
    return Model(cfg, device=device), params_from_numpy(
        to_numpy_tree(jax_params), device)


def prompts(vocab: int, lengths, seed: int = 1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in lengths]


def paged_pool(rng, *, B, Hkv, D, ps, n, extra_pages=3, free_tail=True):
    """A shuffled page pool and block table: (k, v, bt, P). Each row maps
    its ``n`` logical pages to distinct physical pages; with ``free_tail``
    the last entry of every other row carries the FREE sentinel
    (``== P``), as unallocated tail pages do."""
    P = B * n + extra_pages
    perm = rng.permutation(P)[:B * n].reshape(B, n).astype(np.int32)
    if free_tail:
        perm[::2, -1] = P
    k = rng.standard_normal((P, ps, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((P, ps, Hkv, D)).astype(np.float32)
    return k, v, perm, P


# Host counters the sharing and preemption parity tests hold to the
# reference's (exact: they follow lengths and prompt tokens, not logits).
SHARE_STATS = ("prefix_hit_ratio", "pages_shared", "preemptions",
               "preemptions_recovered", "kv_memory_ratio", "steps",
               "mixed_steps", "decoded_tokens", "status_counts")


def jax_smoke(arch: str, n_layers: int = 2, seed: int = 0, **over):
    """Float32 ``arch`` smoke in the reference: (cfg, Model, params)."""
    import jax
    from repro.configs import get_config
    from repro.models.transformer import Model
    cfg = get_config(arch, "smoke", dtype="float32", n_layers=n_layers,
                     **over)
    m = Model(cfg)
    return cfg, m, m.init(jax.random.key(seed))


def torch_smoke(arch: str, jax_params, n_layers: int = 2, device=CPU,
                **over):
    """The port's float32 ``arch`` smoke with the reference's parameters
    bridged over: (Model, params)."""
    from repro_torch.configs import get_config
    from repro_torch.models.bridge import params_from_numpy
    from repro_torch.models.transformer import Model
    cfg = get_config(arch, "smoke", dtype="float32", n_layers=n_layers,
                     **over)
    return Model(cfg, device=device), params_from_numpy(
        to_numpy_tree(jax_params), device)


def serve_rounds(pkg: str, model, params, rounds, **cfg_kw):
    """Serve ``rounds`` on ONE engine of package ``pkg`` (``"repro"`` or
    ``"repro_torch"``), one ``run`` per round; each round is a list of
    ``(rid, prompt, max_new_tokens)`` or ``(tick, (rid, prompt,
    max_new_tokens))`` arrivals. Returns ``({rid: (output, status)},
    [SHARE_STATS of each round], engine)``; the pool's invariants are
    checked after every round."""
    import importlib
    serve = importlib.import_module(pkg + ".serve")
    eng = serve.Engine(model, params, config=serve.EngineConfig(**cfg_kw))
    out, stats = {}, []
    for rnd in rounds:
        arrivals = []
        for item in rnd:
            tick, (rid, prompt, budget) = item if len(item) == 2 \
                else (0, item)
            req = serve.Request(rid=rid, prompt=prompt,
                                max_new_tokens=budget)
            if tick:
                arrivals.append((tick, req))
            else:
                eng.submit(req)
        done = eng.run(arrivals=arrivals)
        out.update({r.rid: (list(r.output), r.status) for r in done})
        stats.append({k: eng.decode_stats[k] for k in SHARE_STATS})
        if eng.paged:
            eng.slots.pool.check_invariants()
    return out, stats, eng


# MoE smoke pairs (tests/test_torch_moe*.py): factorized and compressed
# weights use a factorization that reaches smoke widths; the published
# capacity factor (1.25) is the default, since the smoke configs' own (2.0,
# 8.0) never drop a claim.
MOE_FCFG = dict(enabled=True, min_dim=32, rank=32, nnz=8)
MOE_CF = 1.25
_MOE_PARAMS: dict = {}


def moe_pair(arch: str, fmt: str = "dense", cf=MOE_CF):
    """(reference Model, its params, port Model on the CPU, the params
    bridged over) of ``arch`` smoke at float32 in format ``fmt``
    (``dense``, ``factorized``, or ``compressed``: W_D projected, then the
    reference's ``compress_params``), with capacity factor ``cf`` (None:
    the smoke config's). Params are made once per (arch, fmt) and
    process."""
    import jax
    from repro.configs import get_config as jget
    from repro.core import factorized as rf
    from repro.models.transformer import Model as JM
    from repro_torch.configs import get_config as tget
    from repro_torch.core import factorized as tf
    from repro_torch.models.bridge import params_from_numpy
    from repro_torch.models.transformer import Model as TM
    jo, to = {}, {}
    if fmt != "dense":
        jo["factorization"] = rf.FactorizationConfig(**MOE_FCFG)
        to["factorization"] = tf.FactorizationConfig(**MOE_FCFG)
    if fmt == "compressed":
        jo["weight_format"] = to["weight_format"] = "compressed"
    jcfg = jget(arch, "smoke", dtype="float32", **jo)
    tcfg = tget(arch, "smoke", dtype="float32", **to)
    if cf is not None:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, capacity_factor=cf))
        tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
            tcfg.moe, capacity_factor=cf))
    key = (arch, fmt)
    if key not in _MOE_PARAMS:
        jm = JM(dataclasses.replace(jcfg, weight_format="dense"))
        jp = jm.init(jax.random.key(0))
        if fmt == "compressed":
            _, jp, _ = jm.compress_params(rf.project_wd_leaves(
                jp, jcfg.factorization))
        _MOE_PARAMS[key] = (jp, params_from_numpy(to_numpy_tree(jp), CPU))
    jp, tparams = _MOE_PARAMS[key]
    return JM(jcfg), jp, TM(tcfg, device=CPU), tparams


# ---- tensor-parallel helpers (tests/test_torch_tp_*.py, ..._sharded_*) ----
# Rank functions run in the processes of repro_torch.launch.mesh.run_ranks
# (spawned: they are pickled by import path, so they live here).


def rank_sharded_decode(shapes, cases):
    """One rank: ``sharded_decode_attention`` on the rank's block of kv
    heads of each case (a dict of numpy arrays: ``q`` (B, 1, Hq, D), ``k``
    / ``v`` lanes or pools, optional ``k_scale`` / ``v_scale``, ``bt``,
    ``lengths``, ``window``), on each mesh of ``shapes``
    (``(data, model)``: the model axis is the tensor-parallel one, so a
    ``(2, 2)`` grid of four ranks runs two 2-rank cases side by side).
    Returns ``{shape: outputs}``."""
    from repro_torch.kernels.tda.sharded import sharded_decode_attention
    from repro_torch.launch.mesh import make_local_mesh
    res = {}
    for shape in shapes:
        mesh = make_local_mesh(*shape)
        dev = mesh.device
        out = []
        for c in cases:
            def local(name, dim, c=c):
                if c.get(name) is None:
                    return None
                return mesh.block(t(c[name], dev), dim).contiguous()

            o = sharded_decode_attention(
                t(c["q"], dev), local("k", -2), local("v", -2),
                t(c["lengths"], dev), mesh=mesh, window=c.get("window"),
                k_scale=local("k_scale", -1), v_scale=local("v_scale", -1),
                block_table=None if c.get("bt") is None
                else t(c["bt"], dev))
            out.append(o.cpu().numpy())
        res[shape] = out
    return res


def rank_moe(cases):
    """One rank of a ``(2, 2)`` mesh: ``moe_ffn(mesh=)`` on the rank's
    slice of each case's params (``{"layers": {"moe": ...}, "dicts":
    ...}``, cut by ``shard_params``) and its batch block of ``x`` over
    ``data``. Returns ``(data coordinate, y, aux, router_counts())`` per
    case."""
    import dataclasses as dc
    from repro_torch.configs import get_config
    from repro_torch.core.factorized import FactorizationConfig
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.sharding import param_specs, shard_params
    from repro_torch.models.bridge import params_from_numpy
    from repro_torch.models import moe
    mesh = make_local_mesh(2, 2)
    out = []
    for c in cases:
        cfg = get_config("dbrx-132b", "smoke", dtype="float32")
        if c["dicts"]:
            cfg = dc.replace(cfg, factorization=FactorizationConfig(
                **MOE_FCFG))
        cfg = dc.replace(cfg, moe=dc.replace(
            cfg.moe, capacity_factor=c["cf"]))
        tree = params_from_numpy({"layers": {"moe": c["moe"]},
                                  "dicts": c["dicts"]}, CPU)
        loc = shard_params(tree, param_specs(tree, mesh), mesh)
        x = mesh.block(t(c["x"]), 0, "data")
        moe.reset_router_counts()
        y, aux = moe.moe_ffn(loc["layers"]["moe"], x, cfg=cfg,
                             dicts=loc["dicts"], mesh=mesh)
        out.append((mesh.coords["data"], y.numpy(), float(aux),
                    moe.router_counts()))
    return out


def rank_audit_ranks(cfg, params):
    """One rank of a ``(1, 2)`` mesh: an audited paged Engine's
    ``_audit_step`` three times: as built, after rank 1 reversed a free
    list (a drift its own checks cannot see) and after rank 1 broke a
    refcount (its own checks fail). Returns each audit's ``(check,
    detail)`` or None, and the count of violations."""
    from repro_torch.core.errors import AuditError
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.transformer import Model
    from repro_torch.serve import Engine, EngineConfig
    mesh = make_local_mesh(1, 2)
    eng = Engine(Model(cfg, device=mesh.device), params,
                 config=EngineConfig(max_len=16, audit=True), mesh=mesh)
    c = next(iter(eng.slots.pool.classes.values()))
    out = []
    for corrupt in (None, "order", "refcount"):
        if mesh.coords["model"] == 1:
            if corrupt == "order":
                c.free.reverse()
            elif corrupt == "refcount":
                c.refcount[0] += 1
        try:
            eng._audit_step()
            out.append(None)
        except AuditError as e:
            out.append((e.check, e.detail))
    return out, eng._audit_violations


def tp_rounds(lengths, budgets, ticks=None, seed: int = 1, vocab: int = 256):
    """One round of ``(tick, rid, prompt, max_new_tokens)`` for
    ``launch.tp_serve``, prompts from :func:`prompts`."""
    ticks = ticks or [0] * len(lengths)
    return [[(tk, i, p, b) for i, (p, b, tk) in enumerate(
        zip(prompts(vocab, lengths, seed), budgets, ticks))]]


def ref_serve(model, params, rounds, faults=None, **cfg_kw):
    """The reference Engine (``mesh=None``) on ``tp_rounds``-style rounds:
    ``({rid: (tokens, status)}, decode_stats)``."""
    from repro.serve import Engine, EngineConfig, Request
    eng = Engine(model, params, config=EngineConfig(**cfg_kw), faults=faults)
    out = {}
    for rnd in rounds:
        arrivals = []
        for tick, rid, prompt, budget in rnd:
            req = Request(rid=rid, prompt=np.asarray(prompt, np.int32),
                          max_new_tokens=budget)
            if tick:
                arrivals.append((tick, req))
            else:
                eng.submit(req)
        done = eng.run(arrivals=arrivals)
        out.update({r.rid: (list(map(int, r.output)), r.status)
                    for r in done})
    return out, eng.decode_stats


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def flat_tree(tree, pre=""):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(flat_tree(v, pre + k + "/"))
        else:
            out[pre + k] = v
    return out


def _as_np(x):
    return x.detach().float().numpy() if torch.is_tensor(x) \
        else np.asarray(x, dtype=np.float32)


def assert_tree_close(got, want, atol, rel=False):
    g, w = flat_tree(got), flat_tree(want)
    assert sorted(g) == sorted(w), set(g) ^ set(w)
    for k in w:
        a, b = _as_np(g[k]), np.asarray(w[k], dtype=np.float32)
        assert a.shape == b.shape, (k, a.shape, b.shape)
        scale = max(1.0, float(np.abs(b).max())) if rel and b.size else 1.0
        err = float(np.abs(a - b).max()) if b.size else 0.0
        assert err <= atol * scale, (k, err, atol * scale)


def fcfg_over(pkg: str, factorized: bool):
    if not factorized:
        return {}
    if pkg == "jax":
        from repro.core.factorized import FactorizationConfig
    else:
        from repro_torch.core.factorized import FactorizationConfig
    return {"factorization": FactorizationConfig(**FCFG)}


def train_batch(cfg, rng, B=2, S=16):
    b = {}
    if cfg.external_embeddings:
        b["embeds"] = rng.standard_normal((B, S, cfg.d_model)).astype(
            np.float32)
    else:
        b["inputs"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(
            np.int32)
    lbl = (B, S) + ((cfg.n_codebooks,) if cfg.n_codebooks > 1 else ())
    b["labels"] = rng.integers(0, cfg.vocab_size, lbl).astype(np.int32)
    return b


def port_loss_grads(model, params, batch, sparse):
    leaves = flat_tree(params)
    for v in leaves.values():
        v.requires_grad_(True)
    total, metrics = model.loss(params, {k: t(v) for k, v in
                                         batch.items()}, sparse_train=sparse)
    names = sorted(leaves)
    grads = torch.autograd.grad(total, [leaves[n] for n in names],
                                allow_unused=True)
    for v in leaves.values():
        v.requires_grad_(False)
    return metrics, {n: (torch.zeros_like(leaves[n]) if g is None else g)
                     for n, g in zip(names, grads)}


# ---- sharded training (tests/test_torch_sharded_train.py) ----------------

def torch_to_numpy(tree):
    """Tensors -> numpy copies (f32 for bf16), nested dicts kept."""
    if isinstance(tree, dict):
        return {k: torch_to_numpy(v) for k, v in tree.items()}
    return np.array(tree.detach().cpu().float().numpy()) \
        if torch.is_tensor(tree) else tree


def _rank_mesh(shape):
    from repro_torch.launch.mesh import make_local_mesh
    if shape is None:
        return None
    if len(shape) == 3:
        return make_local_mesh(shape[1], shape[2], pod=shape[0])
    return make_local_mesh(*shape)


def _train_case(c, mesh):
    """One parity case on ``mesh``: ``c["steps"]`` train steps from the
    bridged ``c["params"]``; per step the assembled gradients (taken
    before the step), metrics, params and optimizer state; and this
    rank's slices of the params after the last step."""
    from repro_torch.configs import get_config
    from repro_torch.core.factorized import FactorizationConfig
    from repro_torch.core.tree import tree_map
    from repro_torch.launch.sharding import (batch_spec, cut_leaf,
                                             gather_tree, param_specs,
                                             shard_params)
    from repro_torch.launch.steps import loss_and_grads, make_train_step
    from repro_torch.models.bridge import params_from_numpy
    from repro_torch.models.transformer import Model
    from repro_torch.optim import OptConfig, init_opt_state
    from repro_torch.optim.adamw import opt_state_leaf_specs
    from repro_torch.train.loop import make_project_fn
    over = {"factorization": FactorizationConfig(**c["fcfg"])} \
        if c["fcfg"] else {}
    cfg = get_config(c["arch"], "smoke", dtype="float32", **over)
    model = Model(cfg, device=CPU)
    params = params_from_numpy(c["params"], CPU)
    specs = param_specs(params, mesh)
    loc = tree_map(lambda x: x.clone(), shard_params(params, specs, mesh))
    oc = OptConfig(**c["opt"])
    state = {"params": loc, "opt": init_opt_state(loc, oc, mesh, specs),
             "step": torch.zeros((), dtype=torch.int32)}
    ospecs = opt_state_leaf_specs(loc, specs, mesh, oc)
    pf = make_project_fn(cfg.factorization, mesh, specs) \
        if c["project"] else None
    step = make_train_step(model, oc, c["sparse"], pf, mesh=mesh,
                           specs=specs)
    recs = []
    for b in c["batches"]:
        tb = {k: torch.from_numpy(v) for k, v in b.items()}
        tb = {k: cut_leaf(v, sp, mesh) for (k, v), sp in zip(
            tb.items(), batch_spec(tb, mesh).values())}
        _, grads = loss_and_grads(model, state["params"], tb,
                                  sparse_train=c["sparse"], mesh=mesh,
                                  specs=specs)
        grads = gather_tree(grads, specs, mesh)
        state, met = step(state, tb)
        recs.append({"grads": torch_to_numpy(grads),
                     "metrics": {k: float(v) for k, v in met.items()},
                     "params": torch_to_numpy(gather_tree(state["params"], specs,
                                                    mesh)),
                     "opt": torch_to_numpy(gather_tree(state["opt"], ospecs,
                                                 mesh))})
    return {"recs": recs, "local": torch_to_numpy(state["params"]),
            "specs": specs}


def _compress_case(c, mesh):
    from repro_torch.models.bridge import params_from_numpy
    from repro_torch.optim import compress_pod_allreduce, init_ef_state
    pod = mesh.coords["pod"]
    out = []
    ef = None
    for rnd in c["rounds"]:
        g = params_from_numpy(rnd[pod] if c["per_pod"] else rnd, CPU)
        ef = init_ef_state(g) if ef is None else ef
        g, ef = compress_pod_allreduce(g, ef, mesh, mesh.shape["pod"])
        out.append((torch_to_numpy(g), torch_to_numpy(ef)))
    return out


def _elastic_case(c):
    """Save on ``(2, 2)`` after 2 steps, resume on ``(4, 1)`` and without
    a mesh, against the uninterrupted ``(2, 2)`` run."""
    import os
    from repro_torch.configs import get_config
    from repro_torch.launch.sharding import gather_tree
    from repro_torch.models.bridge import params_from_numpy
    from repro_torch.models.transformer import Model
    from repro_torch.optim import OptConfig
    from repro_torch.train import TrainLoopConfig, train
    cfg = get_config("qwen2.5-32b", "smoke", dtype="float32")
    model = Model(cfg, device=CPU)
    oc = OptConfig(**c["opt"])
    rank = torch.distributed.get_rank()

    def run(shape, steps, ckpt, start=0, every=1000):
        mesh = _rank_mesh(shape)
        o = train(model, iter(c["batches"][start:]), oc,
                  TrainLoopConfig(total_steps=steps, ckpt_dir=ckpt,
                                  ckpt_every=every, log_every=1),
                  mesh=mesh, params=params_from_numpy(c["params"], CPU))
        p = o["state"]["params"] if mesh is None else gather_tree(
            o["state"]["params"], o["specs"], mesh)
        return [h["loss"] for h in o["history"]], torch_to_numpy(p)

    saved = os.path.join(c["dir"], "saved")
    run((2, 2), 2, saved, every=2)
    out = {"whole": run((2, 2), 3, os.path.join(c["dir"], "whole")),
           "(4, 1)": run((4, 1), 3, saved, start=2)}
    # Without a mesh every rank resumes on its own (nothing is written).
    out["none"] = run(None, 3, saved, start=2)
    return out if rank == 0 else None


def rank_sharded_train(job):
    """One rank of a 4-rank world, every sharded-training case of
    ``tests/test_torch_sharded_train.py`` in turn (new mesh groups for
    each): the train cases (``_train_case``) on their meshes, the pod
    compression, the elastic restore and the launcher. Rank 0 returns the
    assembled results; every rank returns its slices of the params after
    each train case, with its coordinates."""
    import os
    from repro_torch.launch.train import main
    rank = torch.distributed.get_rank()
    out = {"train": {}, "local": {}, "compress": {}}
    for name, c in job["train"].items():
        mesh = _rank_mesh(c["mesh"])
        r = _train_case(c, mesh)
        out["local"][name] = (dict(mesh.coords), r["local"], r["specs"])
        if rank == 0:
            out["train"][name] = r["recs"]
    mesh = _rank_mesh((2, 2, 1))
    for name, c in job["compress"].items():
        out["compress"][name] = (mesh.coords["pod"],
                                 _compress_case(c, mesh))
    out["elastic"] = _elastic_case(job["elastic"])
    argv = ["--arch", "qwen2.5-32b", "--steps", "3", "--dtype", "float32",
            "--device", "cpu"]
    d = job["elastic"]["dir"]
    meshed = main(argv + ["--mesh-data", "2", "--mesh-model", "2",
                          "--backend", "gloo", "--ckpt",
                          os.path.join(d, "launch_mesh")])
    if rank == 0:
        plain = main(argv + ["--ckpt", os.path.join(d, "launch_plain")])
        out["launch"] = ([h["loss"] for h in meshed["history"]],
                         [h["loss"] for h in plain["history"]])
    return out


def run_sharded_train(job):
    """:func:`rank_sharded_train` on four gloo ranks of the CPU: rank 0's
    results, with every rank's in ``"ranks"``."""
    from repro_torch.launch.mesh import run_ranks
    res = run_ranks(4, rank_sharded_train, job, device="cpu",
                    backend="gloo")
    out = dict(res[0])
    out["ranks"] = res
    return out


def rank_moe_sparse(cfg, tree, x):
    """One rank of a ``(1, 2)`` mesh: ``moe_ffn`` on the rank's slice of
    the expert params with ``sparse_train`` on and off: ``(y, y)``."""
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.sharding import param_specs, shard_params
    from repro_torch.models.bridge import params_from_numpy
    from repro_torch.models.moe import moe_ffn
    mesh = make_local_mesh(1, 2)
    tree = params_from_numpy(tree, CPU)
    loc = shard_params(tree, param_specs(tree, mesh), mesh)
    return tuple(moe_ffn(loc["layers"]["moe"], torch.from_numpy(x), cfg=cfg,
                         dicts=loc["dicts"], mesh=mesh,
                         sparse_train=s)[0].numpy() for s in (True, False))


def rank_mesh_infer(cases):
    """One rank of a 4-rank world, each case of
    ``tests/test_torch_mesh_infer.py`` on its own ``(data, model)`` mesh
    (new groups for each): :func:`_mesh_infer_case`. Returns ``{name:
    results}``; every rank holds the whole results."""
    return {name: _mesh_infer_case(c) for name, c in cases.items()}


def _mesh_infer_case(c):
    """float32 ``c["arch"]`` smoke of ``c["n_layers"]`` layers on
    ``c["mesh"]``, from the whole params ``c["params"]`` (numpy), placed by
    ``param_specs`` (FSDP over ``data``, TP over ``model``), rows over the
    data-parallel axes:

    * ``c["train"]`` (a batch with labels): ``loss_and_grads`` on the mesh,
      the loss and the gathered gradients;
    * ``c["prompt"]``: ``make_prefill_step`` (caches of the prompt's
      length), its logits and gathered caches;
    * ``c["decode"]`` (one token vector a step): ``Model.prefill`` into
      caches of ``c["width"]`` positions, then a ``make_serve_step`` step
      for each at depth S + i (the logits; the gathered caches after the
      last), and with ``c["slot_mask"]`` one ``make_slot_serve_step`` step
      at depth S + len(decode) (its tokens and gathered caches); or, with
      ``c["refused"]``, the message of the ``ValueError`` that the first
      serve step raises.

    Every cache is gathered whole (``launch.sharding.gather_tree`` over its
    ``cache_specs``), every logits block over the data-parallel axes."""
    from repro_torch.configs import get_config
    from repro_torch.launch.sharding import (batch_spec, cut_leaf,
                                             gather_tree, param_specs,
                                             shard_params)
    from repro_torch.launch.steps import (loss_and_grads, make_prefill_step,
                                          make_serve_step,
                                          make_slot_serve_step)
    from repro_torch.models.bridge import params_from_numpy
    from repro_torch.models.transformer import Model
    mesh = _rank_mesh(c["mesh"])
    model = Model(get_config(c["arch"], "smoke", dtype="float32",
                             n_layers=c["n_layers"]), device=CPU)
    full = params_from_numpy(c["params"], CPU)
    specs = param_specs(full, mesh)
    local = shard_params(full, specs, mesh)

    def rows(tree):
        tree = {k: torch.as_tensor(v) for k, v in tree.items()}
        return {k: cut_leaf(v, sp, mesh) for (k, v), sp in zip(
            tree.items(), batch_spec(tree, mesh).values())}

    def whole(t):  # the rank's rows -> every row (dim 0 over data)
        return mesh.gather(t.contiguous(), 0, "data")

    out = {}
    if c.get("train") is not None:
        met, grads = loss_and_grads(model, local, rows(c["train"]),
                                    mesh=mesh, specs=specs)
        out["loss"] = float(met["loss"])
        out["grads"] = gather_tree(grads, specs, mesh)
    prompt = c["prompt"]
    B, S = prompt.shape
    with torch.no_grad():
        cs = model.cache_placement(B, S, mesh)
        logits, caches = make_prefill_step(model, mesh, specs, cs)(
            local, rows({"inputs": prompt}))
        out["prefill_logits"] = whole(logits)
        out["prefill_caches"] = gather_tree(caches, cs, mesh)
        if not c.get("decode"):
            return torch_to_numpy(out)
        cs = model.cache_placement(B, c["width"], mesh)
        _, caches = model.prefill(local, rows({"inputs": prompt}),
                                  max_len=c["width"], mesh=mesh,
                                  specs=specs, cache_specs=cs)
        step = make_serve_step(model, mesh, specs, cs)
        for i, tok in enumerate(c["decode"]):
            try:
                logits, caches = step(local, rows({"inputs": tok[:, None]}),
                                      caches, torch.tensor(S + i,
                                                           dtype=torch.int32))
            except ValueError as e:
                if not c.get("refused"):
                    raise
                out["refused"] = str(e)
                return torch_to_numpy(out)
            out[f"decode_{i}"] = whole(logits)
        out["decode_caches"] = gather_tree(caches, cs, mesh)
        if c.get("slot_mask") is None:
            return torch_to_numpy(out)
        n = len(c["decode"])
        last = rows({"inputs": c["decode"][-1][:, None],
                     "index": np.full(B, S + n, np.int32),
                     "mask": c["slot_mask"]})
        toks, caches = make_slot_serve_step(model, mesh, specs, cs)(
            local, {"inputs": last["inputs"]}, caches, last["index"],
            last["mask"])
        out["slot_tokens"] = whole(toks)
        out["slot_caches"] = gather_tree(caches, cs, mesh)
    return torch_to_numpy(out)
