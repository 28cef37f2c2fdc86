"""Parameter and serving-cache placement (``repro.launch.sharding``).

A spec is a tuple with one entry per dim: a mesh axis name (``"data"``,
``"model"``) or ``None`` (replicated). :func:`param_specs` and
:func:`slot_cache_specs` give every leaf the reference's placement, by the
same path rules: column-parallel linears (``_COL_NAMES``) cut their output
features over ``model``, row-parallel ones (``_ROW_NAMES``) their input
features, the shared dictionaries ``W_S`` their rank, the token table and
the head the vocabulary, MoE experts ``E`` over ``data`` and their
contraction over ``model``; an axis that does not divide its dim falls
back to replication. :func:`shard_params` cuts one rank's slice.

What the serving path does with that placement (``models/layers.py``,
``core/factorized.py``, ``models/moe.py``), boundary by boundary:

* the residual stream ``x (B, S, d)`` is **replicated** on every rank of
  the ``model`` axis, bit for bit (every value that reaches it comes out
  of one ``all_reduce``, whose result every rank receives);
* a column-parallel linear takes the replicated ``x`` and gives this
  rank's block of output features: its heads (``wq``/``wk``/``wv``: ``Hq /
  N`` and ``Hkv / N`` whole heads, GQA groups with their kv head) or its
  slice of ``d_ff``. A factorized leaf computes ``(x @ W_S[:, r_loc]) @
  W_D[r_loc]``, ``all_reduce`` s the partial sums and keeps its block;
  a compressed leaf (streams replicated, its ``{codes_packed, lut}``
  dictionary kept whole by :func:`shard_params`: DMM and SMM run on the
  whole linear) computes every feature and keeps its block;
* attention runs on the rank's own heads against its own head slice of
  the K/V lanes (:func:`slot_cache_specs`), through the port's kernels;
* a row-parallel linear takes the rank's block (heads or ``d_ff`` slice)
  and gives the replicated output: dense ``x_loc @ W[rows_loc]`` then one
  ``all_reduce(SUM)`` (Megatron's pairing); a factorized or compressed
  leaf first gathers the input, then runs as above;
* the token table and the head are **cut over the vocabulary**: the
  lookup reads the rank's rows (zeros elsewhere) and one ``all_reduce``
  assembles the embedding; the logits are computed for the rows the
  engine reads only, each rank its vocabulary block, assembled by one
  ``all_gather`` — never ``(B, S, V)``;
* the MoE router and the routing are replicated (every rank routes the
  same tokens the same way); dense experts run their ``d_ff`` slice and
  ``all_reduce`` after ``w_down``, factorized ones after each ``W_D``.

Norms, biases of row-parallel linears and the recurrent blocks' leaves
stay replicated (recurrent stacks are refused on a mesh: their head
counts do not divide).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

__all__ = ["param_specs", "slot_cache_specs", "shard_params", "mesh_shape"]

_COL_NAMES = {"wq", "wk", "wv", "w_up", "w_gate", "w_y", "w_x", "w_a", "w_i",
              "in_proj"}
_ROW_NAMES = {"wo", "w_down", "w_out", "out_proj"}

Spec = Tuple[Optional[str], ...]


def mesh_shape(mesh) -> Dict[str, int]:
    """``{"data": D, "model": M}`` of a :class:`~repro_torch.launch.mesh.
    Mesh`, or the dict itself."""
    return dict(getattr(mesh, "shape", mesh))


def _axis_ok(shape: Dict[str, int], axis, dim: int) -> bool:
    return axis is None or dim % shape.get(axis, 1) == 0


def _validated(shape, spec, dims) -> Spec:
    """``spec`` left-padded with ``None`` to the leaf's rank, each axis
    that does not divide its dim replaced by ``None``."""
    spec = (None,) * (len(dims) - len(spec)) + tuple(spec)
    return tuple(a if _axis_ok(shape, a, d) else None
                 for a, d in zip(spec, dims))


def _leaf_spec(names: List[str], dims: Tuple[int, ...], shape) -> Spec:
    """The reference's ``_leaf_spec``: placement by the leaf's path."""
    name = names[-1] if names else ""
    parents = names[:-1]
    par = parents[-1] if parents else ""
    rep = (None,) * len(dims)
    if parents and parents[0] == "dicts":  # shared W_S (d_in, r): rank
        s = tuple(a if _axis_ok(shape, a, d) else None
                  for a, d in zip((None, "model"), dims))
        return s + (None,) * (len(dims) - len(s))
    if par == "embed" and name == "tok":
        return _validated(shape, ("model", "data"), dims)
    if par == "embed" and name == "pos":
        return rep
    if par == "lm_head":
        return _validated(shape, ("data", "model"), dims)
    if "moe" in parents:
        if name == "w":
            return _validated(shape, ("data", "model", None)
                              if par == "w_down" else ("data", None, "model"),
                              dims)
        if name == "wd":
            return _validated(shape, ("data", "model", None), dims)
        if name in ("router", "b"):
            return rep
    if name == "w":
        if par in _COL_NAMES:
            return _validated(shape, ("data", "model"), dims)
        if par in _ROW_NAMES:
            return _validated(shape, ("model", "data"), dims)
        return rep
    if name == "wd":
        return _validated(shape, (None, "data") if par in _ROW_NAMES
                          else ("model", "data"), dims)
    if name == "b" and par in _COL_NAMES:
        return _validated(shape, ("model",), dims)
    return rep


def _map_paths(fn, tree, pre=()):
    return {k: (_map_paths(fn, v, pre + (k,)) if isinstance(v, dict)
                else fn(pre + (k,), v)) for k, v in tree.items()}


def param_specs(params, mesh) -> Dict:
    """A spec for every leaf of ``params`` (anything with ``.shape``), the
    reference's ``param_specs`` placement on a mesh of this shape."""
    shape = mesh_shape(mesh)
    return _map_paths(lambda p, leaf: _leaf_spec(
        list(p), tuple(leaf.shape), shape), params)


def slot_cache_specs(caches, mesh) -> Dict:
    """Serving lanes cut on the **KV-head** axis over ``model``: ``k`` /
    ``v`` ``(L?, P|B, page_size|width, Hkv, D)`` at dim -2, the int8
    ``k_scale`` / ``v_scale`` ``(..., Hkv)`` at dim -1; everything else
    (recurrent states) replicated. Block tables and slot metadata live on
    the host and are the same on every rank."""
    shape = mesh_shape(mesh)

    def spec(path, leaf):
        nd, name = len(leaf.shape), path[-1]
        s = [None] * nd
        if name in ("k", "v") and nd >= 4 \
                and _axis_ok(shape, "model", leaf.shape[-2]):
            s[-2] = "model"
        elif name in ("k_scale", "v_scale") and nd >= 3 \
                and _axis_ok(shape, "model", leaf.shape[-1]):
            s[-1] = "model"
        return tuple(s)

    return _map_paths(spec, caches)


def shard_params(params, specs, mesh) -> Dict:
    """This rank's slice of every leaf: each dim placed on an axis of size
    above 1 is cut into equal blocks and the block at the rank's
    coordinate kept (a view). A compressed dictionary (a ``{codes_packed,
    lut}`` entry under ``dicts``) stays whole, whatever its spec: the DMM
    kernel decodes the whole ``W_S`` of a replicated compressed linear."""
    def cut(path, leaf):
        if path[0] == "dicts" and len(path) > 2:
            return leaf
        spec = _get(specs, path)
        for dim, axis in enumerate(spec):
            n = mesh.shape[axis] if axis is not None else 1
            if n > 1:
                w = leaf.shape[dim] // n
                leaf = leaf.narrow(dim, mesh.coords[axis] * w, w)
        return leaf

    return _map_paths(cut, params)


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree
