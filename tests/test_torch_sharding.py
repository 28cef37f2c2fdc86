"""The port's placement (``repro_torch.launch.sharding``) against the
reference's (``repro.launch.sharding``), no process spawned: ``param_specs``
and ``slot_cache_specs`` give every leaf of each family's smoke params and
serving caches the reference's spec on ``(data, model)`` meshes of shape
``(1, 2)``, ``(1, 4)`` and ``(2, 2)`` (the reference's on a
``jax.sharding.AbstractMesh``; a reference spec shorter than its leaf is
padded with ``None``, which is what it means), and the slices of
``shard_params``, put back at their ranks' coordinates, give back the
full tree exactly."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_parity as tp  # noqa: E402

MESHES = [(1, 2), (1, 4), (2, 2)]
FAMILIES = ["qwen2.5-32b", "qwen1.5-4b", "starcoder2-15b", "dbrx-132b",
            "arctic-480b", "mamba2-370m", "recurrentgemma-2b",
            "llava-next-mistral-7b", "musicgen-large", "qwen2.5-32b:factorized",
            "dbrx-132b:factorized", "qwen2.5-32b:compressed"]


_REF_PARAMS: dict = {}


def _ref_params(family: str):
    """The reference's smoke params of ``family`` (``arch[:fmt]``) as
    shape structs (compressed: the real tree, which ``compress_params``
    needs), made once per process."""
    if family not in _REF_PARAMS:
        _REF_PARAMS[family] = _make_ref_params(family)
    return _REF_PARAMS[family]


def _make_ref_params(family: str):
    import jax
    from repro.configs import get_config
    from repro.core import factorized as rf
    from repro.models.transformer import Model
    arch, _, fmt = family.partition(":")
    over = {}
    if fmt:
        over["factorization"] = rf.FactorizationConfig(**tp.MOE_FCFG)
    cfg = get_config(arch, "smoke", dtype="float32", **over)
    m = Model(cfg)
    if fmt != "compressed":
        return cfg, jax.eval_shape(lambda: m.init(jax.random.key(0)))
    p = rf.project_wd_leaves(m.init(jax.random.key(0)), cfg.factorization)
    return cfg, m.compress_params(p)[1]


def _abstract(shape):
    from jax.sharding import AbstractMesh
    return AbstractMesh(shape, ("data", "model"))


def _norm(spec, nd):
    """A reference PartitionSpec as the port writes it: one entry per
    dim."""
    s = tuple(spec)
    return s + (None,) * (nd - len(s))


def _flat(tree, pre=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, pre + (k,)))
        else:
            out[pre + (k,)] = v
    return out


def _ref_flat_specs(specs, shapes):
    import jax
    fs = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    fl = jax.tree_util.tree_flatten_with_path(shapes)[0]
    out = {}
    for (path, spec), (_, leaf) in zip(fs, fl, strict=True):
        out[tuple(str(k.key) for k in path)] = _norm(spec, len(leaf.shape))
    return out


@pytest.mark.parametrize("mesh", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("family", FAMILIES)
def test_param_specs_match_reference(family, mesh):
    """Every leaf's spec equals the reference's ``param_specs`` on the same
    mesh shape (the port's computed on the reference's own tree)."""
    from repro.launch import sharding as rs
    from repro_torch.launch import sharding as ts
    _, shapes = _ref_params(family)
    want = _ref_flat_specs(rs.param_specs(shapes, _abstract(mesh)), shapes)
    got = _flat(ts.param_specs(shapes, {"data": mesh[0], "model": mesh[1]}))
    assert got == want
    assert any("model" in s for s in got.values())


@pytest.mark.parametrize("mesh", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch,kw", [
    ("qwen2.5-32b", {}), ("qwen2.5-32b", {"page_size": 8}),
    ("qwen1.5-4b", {"kv_quant": True}), ("starcoder2-15b", {"page_size": 8}),
    ("recurrentgemma-2b", {"page_size": 8}), ("mamba2-370m", {})])
def test_slot_cache_specs_match_reference(arch, kw, mesh):
    """The serving lanes (contiguous or paged, fp or int8, ring lanes,
    recurrent states) placed on the KV-head axis as the reference places
    them."""
    from repro.launch import sharding as rs
    from repro_torch.configs import get_config
    from repro_torch.launch import sharding as ts
    from repro_torch.models.transformer import Model
    from repro_torch.serve.kv_slots import SlotKVCache
    kw = dict(kw)
    quant = kw.pop("kv_quant", False)
    cfg = get_config(arch, "smoke", dtype="float32", kv_quant=quant)
    caches = SlotKVCache(Model(cfg, device="cpu"), 2, 24, **kw).caches
    want = _ref_flat_specs(rs.slot_cache_specs(_np_tree(caches),
                                               _abstract(mesh)), caches)
    got = _flat(ts.slot_cache_specs(caches, {"data": mesh[0],
                                             "model": mesh[1]}))
    assert got == want


def _np_tree(tree):
    return {k: _np_tree(v) if isinstance(v, dict) else v.numpy()
            for k, v in tree.items()}


def _assemble(full, specs, shards, mesh):
    """Write every rank's slice at its coordinates into zeros: must give
    ``full`` back, each element covered."""
    out = torch.zeros_like(full)
    cover = torch.zeros(full.shape, dtype=torch.int64)
    for (d, m), shard in shards.items():
        coords = {"data": d, "model": m}
        idx = []
        for dim, axis in enumerate(specs):
            n = mesh[axis] if axis is not None else 1
            w = full.shape[dim] // n
            c = coords[axis] if n > 1 else 0
            idx.append(slice(c * w, (c + 1) * w))
        out[tuple(idx)] = shard
        cover[tuple(idx)] += 1
    return out, cover


@pytest.mark.parametrize("mesh", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("family", ["qwen2.5-32b", "dbrx-132b",
                                    "arctic-480b", "qwen2.5-32b:factorized",
                                    "qwen2.5-32b:compressed"])
def test_shard_params_round_trip(family, mesh):
    """Each rank's slices, written back at the rank's coordinates, give
    the full tree exactly; every cut leaf is cut into equal blocks, and a
    compressed dictionary stays whole on every rank."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch import sharding as ts
    from repro_torch.models.bridge import params_from_numpy
    _, ref = _ref_params(family)
    params = params_from_numpy(_zeros_like(ref), "cpu")
    shape = {"data": mesh[0], "model": mesh[1]}
    specs = ts.param_specs(params, shape)
    rng = torch.Generator().manual_seed(0)
    flat = _flat(params)
    for path, leaf in flat.items():
        if leaf.is_floating_point():
            leaf.copy_(torch.randn(leaf.shape, generator=rng))
    shards = {}
    for d in range(mesh[0]):
        for m in range(mesh[1]):
            r = Mesh(shape, {"data": d, "model": m}, {}, torch.device("cpu"))
            shards[(d, m)] = _flat(ts.shard_params(params, specs, r))
    fspecs = _flat(specs)
    for path, leaf in flat.items():
        if path[0] == "dicts" and len(path) > 2:
            assert all(torch.equal(s[path], leaf) for s in shards.values())
            continue
        out, cover = _assemble(leaf, fspecs[path],
                               {c: s[path] for c, s in shards.items()},
                               shape)
        assert torch.equal(out, leaf), path
        reps = int(np.prod([mesh[0] if "data" not in fspecs[path] else 1,
                            mesh[1] if "model" not in fspecs[path] else 1]))
        assert bool((cover == reps).all()), path


def _zeros_like(tree):
    import jax.numpy as jnp
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    return np.zeros(tree.shape, dtype=jnp.dtype(tree.dtype))
