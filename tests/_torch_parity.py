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
