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

**Training placement** (``launch/steps.py``, ``train/loop.py``) on a
``(data, model)`` or ``(pod, data, model)`` mesh is the same rule
(:func:`param_specs`) with ``data`` above 1:

* every big weight is TP-cut on ``model`` as above and **FSDP**-cut on
  ``data`` along its other dim; a layer gathers its FSDP-cut leaves over
  ``data`` inside its body (``launch.mesh.fsdp_gather``: all-gather
  forward, reduce-scatter backward), under the layer's checkpoint when
  remat is on, so a rank holds one layer's gathered weights at a time;
  the token table and the head are gathered the same way;
* an MoE expert leaf's ``data`` entry is its expert axis E: **expert
  parallelism**. It is never gathered; its tokens travel by
  ``all_to_all`` (``models/moe.py``);
* the shared dictionaries ``W_S`` are replicated over ``data`` (and
  ``pod``), and so are norms and biases;
* ``pod`` is pure data parallelism for the parameters: no leaf is cut
  over it. The AdamW moments are also ZeRO-cut over it
  (:func:`opt_state_specs`: ``data`` widened to ``("data", "pod")``);
* the batch is cut over ``("pod", "data")`` (:func:`batch_spec`).

**Gradients by axis** (:func:`grad_reduce_axes`): each rank's backward
gives the gradient of the global loss restricted to its batch block. A
leaf that a data-parallel axis does not cut gets its gradient summed
(all-reduce) over that axis; an FSDP leaf gets the ``data`` sum from its
gather's reduce-scatter, and an expert leaf from the ``all_to_all`` that
brought it every rank's tokens; a leaf replicated over ``model`` gets no
reduction, since Megatron's ``f`` / ``g`` pairs make its gradient whole
and equal on every rank of the axis.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core.tree import tree_at, tree_map_paths

__all__ = ["param_specs", "slot_cache_specs", "shard_params", "mesh_shape",
           "dp_axes", "batch_spec", "cache_specs", "opt_state_specs",
           "spec_axes", "cut_leaf", "local_shape", "full_shape", "fsdp_dim",
           "grad_reduce_axes", "gather_leaf", "gather_tree"]

_COL_NAMES = {"wq", "wk", "wv", "w_up", "w_gate", "w_y", "w_x", "w_a", "w_i",
              "in_proj"}
_ROW_NAMES = {"wo", "w_down", "w_out", "out_proj"}

Spec = Tuple[Optional[str], ...]


def mesh_shape(mesh) -> Dict[str, int]:
    """``{axis: size}`` of a :class:`~repro_torch.launch.mesh.Mesh` or
    :class:`~repro_torch.launch.mesh.MeshShape`, or the dict itself."""
    return dict(getattr(mesh, "shape", mesh))


def dp_axes(mesh) -> Tuple[str, ...]:
    """The data-parallel axes of ``mesh``: ``pod`` and ``data``, those it
    has, in that order (the reference's ``dp_axes``)."""
    names = getattr(mesh, "axis_names", None) or tuple(mesh_shape(mesh))
    return tuple(a for a in ("pod", "data") if a in names)


def spec_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry (``None``, an axis, or a tuple of
    axes, major first)."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _axis_ok(shape: Dict[str, int], axis, dim: int) -> bool:
    return dim % math.prod(shape.get(a, 1) for a in spec_axes(axis)) == 0


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


def param_specs(params, mesh) -> Dict:
    """A spec for every leaf of ``params`` (anything with ``.shape``), the
    reference's ``param_specs`` placement on a mesh of this shape."""
    shape = mesh_shape(mesh)
    return tree_map_paths(lambda p, leaf: _leaf_spec(
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

    return tree_map_paths(spec, caches)


def shard_params(params, specs, mesh) -> Dict:
    """This rank's slice of every leaf: each dim placed on axes of size
    above 1 is cut into equal blocks and the block at the rank's
    coordinate kept (a view; a dim on a tuple of axes, major first, is
    cut in the product of their sizes). A compressed dictionary (a
    ``{codes_packed, lut}`` entry under ``dicts``) stays whole, whatever
    its spec: the DMM kernel decodes the whole ``W_S`` of a replicated
    compressed linear."""
    def cut(path, leaf):
        if path[0] == "dicts" and len(path) > 2:
            return leaf
        return cut_leaf(leaf, tree_at(specs, path), mesh)

    return tree_map_paths(cut, params)


def cut_leaf(leaf, spec, mesh):
    """This rank's slice of one whole ``leaf`` placed by ``spec`` (a
    view)."""
    for dim, entry in enumerate(spec):
        n, idx = 1, 0
        for a in spec_axes(entry):
            n, idx = n * mesh.n(a), idx * mesh.n(a) + mesh.coord(a)
        if n > 1:
            w = leaf.shape[dim] // n
            leaf = leaf.narrow(dim, idx * w, w)
    return leaf


def local_shape(shape, spec, mesh) -> Tuple[int, ...]:
    """The shape of one rank's slice of a leaf of ``shape``."""
    return tuple(d // math.prod(mesh_shape(mesh).get(a, 1)
                                for a in spec_axes(e))
                 for d, e in zip(shape, spec))


def full_shape(shape, spec, mesh) -> Tuple[int, ...]:
    """The whole leaf's shape from one rank's slice of ``shape``."""
    return tuple(d * math.prod(mesh_shape(mesh).get(a, 1)
                               for a in spec_axes(e))
                 for d, e in zip(shape, spec))


def fsdp_dim(path, spec) -> Optional[int]:
    """The dim of a parameter leaf that a layer gathers over ``data``
    before use (FSDP), or ``None``: an MoE expert leaf's ``data`` dim is
    its expert axis (expert parallelism), never gathered."""
    if "moe" in path[:-1] and path[-1] in ("w", "wd"):
        return None
    for dim, e in enumerate(spec):
        if "data" in spec_axes(e):
            return dim
    return None


def grad_reduce_axes(spec, mesh) -> Tuple[str, ...]:
    """The data-parallel axes over which a leaf of ``spec`` gets its
    gradient all-reduced (SUM): those that do not cut it."""
    cut = {a for e in spec for a in spec_axes(e)}
    return tuple(a for a in dp_axes(mesh) if a not in cut
                 and mesh_shape(mesh).get(a, 1) > 1)


def gather_leaf(leaf: Any, spec, mesh) -> Any:
    """The whole leaf from every rank's slice (the inverse of
    :func:`shard_params`'s cut): one ``all_gather`` per axis that cuts it,
    the minor axis of a tuple entry first. Every rank of the mesh must
    call it."""
    for dim, e in enumerate(spec):
        for a in reversed(spec_axes(e)):
            leaf = mesh.gather(leaf, dim, a)
    return leaf


def gather_tree(tree, specs, mesh) -> Dict:
    """:func:`gather_leaf` of every leaf (a collective, every rank)."""
    return tree_map_paths(
        lambda p, leaf: gather_leaf(leaf, tree_at(specs, p), mesh), tree)


def batch_spec(batch, mesh) -> Dict:
    """Inputs: the batch dim over ``dp_axes`` (``("pod", "data")``) when
    they divide it, else replicated (the reference's ``batch_spec``)."""
    dp = dp_axes(mesh)
    shape = mesh_shape(mesh)

    def spec(path, leaf):
        nd = len(leaf.shape)
        b = leaf.shape[0] if nd else 1
        first = (dp if len(dp) > 1 else dp[0]) if dp and _axis_ok(
            shape, dp, b) else None
        return (first,) + (None,) * (nd - 1) if nd else ()

    return tree_map_paths(spec, batch)


def cache_specs(caches, mesh, stacked: bool = True,
                decode: bool = False) -> Dict:
    """Prefill / train caches ``(L?, B, S, H, D)`` (the reference's
    ``cache_specs``): B over ``dp_axes``, S over ``model``; with
    ``decode`` (weight-stationary, batch replicated) S over ``("data",
    "model")``. ``k_scale`` / ``v_scale`` ``(L?, B, S, H)`` mirror the
    codes' (B, S) cut; recurrent states put B over ``dp_axes`` (dim 1 when
    ``stacked``) and their last dim over ``model``."""
    shape = mesh_shape(mesh)
    names = getattr(mesh, "axis_names", None) or tuple(shape)
    dp = dp_axes(mesh)
    dpe = dp if len(dp) > 1 else (dp[0] if dp else None)
    seq = tuple(a for a in ("data", "model") if a in names)
    seqe = seq if len(seq) > 1 else (seq[0] if seq else None)

    def ok(axis, dim):
        return axis if axis is not None and _axis_ok(shape, axis, dim) \
            else None

    def spec(path, leaf):
        dims, nd, name = tuple(leaf.shape), len(leaf.shape), path[-1]
        s = [None] * nd
        if name in ("k", "v") and nd >= 4:
            if decode:
                s[nd - 3] = ok(seqe, dims[nd - 3])
            else:
                s[nd - 4] = ok(dpe, dims[nd - 4])
                s[nd - 3] = ok("model", dims[nd - 3])
            return tuple(s)
        if name in ("k_scale", "v_scale") and nd >= 3:
            s[nd - 3] = ok(dpe, dims[nd - 3])
            s[nd - 2] = ok("model", dims[nd - 2])
            return tuple(s)
        bdim = 1 if (stacked and nd >= 2) else 0
        if nd > bdim:
            s[bdim] = ok(dpe, dims[bdim])
        if nd - 1 > bdim and _axis_ok(shape, "model", dims[-1]):
            s[-1] = "model"
        return tuple(s)

    return tree_map_paths(spec, caches)


def opt_state_specs(pspecs, mesh, params=None) -> Dict:
    """Optimizer moments: the parameters' specs, with ``data`` widened to
    ``("data", "pod")`` on a mesh with a ``pod`` axis (ZeRO over pods)
    where the leaf's dim (``params`` given) divides by both (the
    reference's ``opt_state_specs``)."""
    names = getattr(mesh, "axis_names", None) or tuple(mesh_shape(mesh))
    if "pod" not in names:
        return pspecs
    shape = mesh_shape(mesh)

    def widen(path, spec):
        dims = None if params is None else tuple(tree_at(params, path).shape)
        return tuple(("data", "pod") if e == "data" and (
            dims is None or _axis_ok(shape, ("data", "pod"), dims[i]))
            else e for i, e in enumerate(spec))

    return tree_map_paths(widen, pspecs)
