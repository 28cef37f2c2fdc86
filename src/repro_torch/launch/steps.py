"""Step builders (``repro.launch.steps``): the train step, the prefill
step, the serving decode steps, their input shapes and the per-cell
bundles that the dry run (``launch/dryrun.py``) runs.

**The train step**: forward, backward and the optimizer update of one
batch, on one device or on one rank of a mesh.

The step updates the train state ``{"params", "opt", "step"}`` **in
place** and holds no second copy of it: a full-width state on one card
(f32 masters, gradients and two moments) leaves no room for one. So a
caller that may refuse the update (the train loop's NaN / spike guard)
decides between the backward pass and the update: ``guard(metrics)`` is
called with the loss metrics once the gradients exist, and a false
answer leaves the state untouched.

On a mesh (``mesh=``, ``specs=``; ``launch/sharding.py`` describes the
placement) each rank runs the forward and backward pass of its batch
block on its slices of the weights, through the autograd-aware
collectives of ``launch/mesh.py``, so its gradients are the whole
batch's for what it holds but for the sums over the data-parallel
copies of a leaf: :func:`loss_and_grads` adds those (an all-reduce over
each ``pod`` / ``data`` axis that does not cut the leaf; an FSDP leaf's
``data`` sum came from its gather's reduce-scatter, an expert leaf's
from the ``all_to_all``, and a leaf replicated over ``model`` needs
none). Then the sharded update. The reference's GSPMD step computes the
same arithmetic on whole arrays.

**Prefill and decode** (:func:`make_prefill_step`, :func:`make_serve_step`,
:func:`make_slot_serve_step`) on one device, or on one rank of a ``(data,
model)`` / ``(pod, data, model)`` mesh with the reference's placement:
weights by ``launch.sharding.param_specs`` (each layer gathers its
FSDP-cut leaves), the batch's rows over the data-parallel axes and the
contiguous caches by ``launch.sharding.cache_specs`` (rows over the
data-parallel axes, positions over ``model``; ``models/transformer.py``
says how a step moves them). These are real programs: they run on gloo
ranks as on one card.

**Bundles** (:func:`build_bundle`): one cell's step function, its
arguments as fake tensors of their whole shapes (the reference's
``ShapeDtypeStruct`` s: shapes, dtypes, no storage), their placement as
spec trees (the reference's shardings) and ``donate_argnums``, which the
port keeps as a record only (its train step updates the state in place;
its decode step writes the caches in place). :func:`rank_args` gives one
rank's blocks of the arguments, fresh fake tensors of the rank's shapes.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs import SHAPES
from repro_torch.core.tree import tree_at, tree_leaves, tree_map_paths
from repro_torch.launch.sharding import (batch_spec, cache_specs,
                                         grad_reduce_axes, local_shape,
                                         opt_state_specs, param_specs)
from repro_torch.models.common import ModelConfig
from repro_torch.models.transformer import Model, shape_mode
from repro_torch.optim.adamw import (OptConfig, apply_updates,
                                     init_opt_state, opt_state_leaf_specs)

__all__ = ["StepBundle", "make_train_step", "loss_and_grads",
           "make_prefill_step", "make_serve_step", "make_slot_serve_step",
           "batch_shapes", "build_bundle", "train_state_shapes", "rank_args",
           "shape_info"]


def loss_and_grads(model, params: Dict, batch: Dict, *,
                   sparse_train: bool = False, mesh=None,
                   specs: Optional[Dict] = None
                   ) -> Tuple[Dict, Dict]:
    """``(metrics, grads)``: ``model.loss``'s metrics (detached) and the
    gradient of its total with respect to every parameter leaf, a tree
    like ``params`` (zeros for a leaf the loss does not reach, as
    ``jax.grad`` gives). On a mesh, this rank's slices of the whole
    batch's gradients (see the module docstring)."""
    leaves = [leaf for _, leaf in tree_leaves(params)]
    for leaf in leaves:
        leaf.requires_grad_(True)
    try:
        total, metrics = model.loss(params, batch, sparse_train=sparse_train,
                                    mesh=mesh, specs=specs)
        grads = torch.autograd.grad(total, leaves, allow_unused=True)
    finally:
        for leaf in leaves:
            leaf.requires_grad_(False)
    metrics = {k: v.detach() for k, v in metrics.items()}
    sharded = mesh is not None and mesh.size > 1
    grad_tree: Dict = {}
    for (path, p), g in zip(tree_leaves(params), grads):
        g = torch.zeros_like(p) if g is None else g
        if sharded:
            for a in grad_reduce_axes(tree_at(specs, path), mesh):
                g = mesh.all_reduce(g, a)
        node = grad_tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = g
    return metrics, grad_tree


def make_train_step(model, opt_cfg: OptConfig, sparse_train: bool = False,
                    project_fn: Optional[Callable] = None, *, mesh=None,
                    specs: Optional[Dict] = None) -> Callable:
    """``train_step(state, batch, guard=None) -> (state, metrics)``:
    :func:`loss_and_grads` of ``model.loss(state["params"], batch,
    sparse_train=)``, then :func:`apply_updates` in place and
    ``state["step"] += 1``. ``metrics`` holds the loss's keys plus
    ``grad_norm`` and ``lr`` (f32 0-d tensors on the device; no host sync
    unless ``guard`` reads one). When ``guard(metrics)`` is false the
    update is skipped and the state is returned as it was. On a ``mesh``
    the state holds this rank's slices (``specs``: the parameters'
    placement), ``batch`` is its block, and every rank must call the step
    (and make the same ``guard`` decision)."""

    def train_step(state: Dict, batch: Dict,
                   guard: Optional[Callable[[Dict], bool]] = None
                   ) -> Tuple[Dict, Dict]:
        metrics, grads = loss_and_grads(model, state["params"], batch,
                                        sparse_train=sparse_train,
                                        mesh=mesh, specs=specs)
        if guard is not None and not guard(metrics):
            return state, metrics
        new_params, _, stats = apply_updates(
            state["params"], grads, state["opt"], state["step"], opt_cfg,
            project_fn=project_fn, mesh=mesh, specs=specs)
        del grads
        state["params"] = new_params
        state["step"] += 1
        metrics.update(stats)
        return state, metrics

    return train_step


def make_prefill_step(model, mesh=None, specs: Optional[Dict] = None,
                      cache_specs: Optional[Dict] = None) -> Callable:
    """``prefill_step(params, batch) -> (logits (B, V), caches)``: the last
    position's logits and the caches the prompt filled. On a ``mesh``
    (``specs``: the weights' placement) the rank's rows and cache blocks,
    placed by ``cache_specs`` (default: ``Model.cache_placement``)."""
    def prefill_step(params, batch):
        logits, caches = model.prefill(params, batch, mesh=mesh, specs=specs,
                                       cache_specs=cache_specs)
        return logits[:, -1], caches

    return prefill_step


def make_serve_step(model, mesh=None, specs: Optional[Dict] = None,
                    cache_specs: Optional[Dict] = None) -> Callable:
    """``serve_step(params, batch, caches, cache_index) -> (logits (B, V),
    caches)``: one token a row against the caches (written in place) at
    ``cache_index`` (0-d: every row at one depth). On a ``mesh``, as
    :func:`make_prefill_step`; ``cache_specs`` is required there."""
    def serve_step(params, batch, caches, cache_index):
        logits, caches = model.decode_step(
            params, batch, caches, cache_index, mesh=mesh, specs=specs,
            cache_specs=cache_specs)
        return logits[:, 0], caches

    return serve_step


def make_slot_serve_step(model, mesh=None, specs: Optional[Dict] = None,
                         cache_specs: Optional[Dict] = None) -> Callable:
    """The continuous-batching decode step: ``slot_serve_step(params,
    batch, caches, cache_index (B,), slot_mask (B,)) -> (tokens (B,)
    int32, caches)``. Each row is a slot at its own depth; rows outside
    ``slot_mask`` write nothing. The greedy argmax stays in the step, so
    serving reads one ``(B,)`` token vector a step."""
    def slot_serve_step(params, batch, caches, cache_index, slot_mask):
        logits, caches = model.decode_step(
            params, batch, caches, cache_index, slot_mask=slot_mask,
            mesh=mesh, specs=specs, cache_specs=cache_specs)
        return torch.argmax(logits[:, 0], dim=-1).to(torch.int32), caches

    return slot_serve_step


# --------------------------------------------------------------------------
# Input shapes and bundles per (config, shape cell)
# --------------------------------------------------------------------------


@dataclasses.dataclass
class StepBundle:
    """One cell's step: ``fn``, its ``args`` (fake tensors of the whole
    shapes), their placement ``in_shardings`` (spec trees; ``()`` for a
    0-d argument; ``None`` without a mesh), the outputs'
    ``out_shardings`` (``None``: not placed) and ``donate_argnums`` (a
    record: the port's steps update in place)."""

    name: str
    fn: Callable
    args: Tuple[Any, ...]
    in_shardings: Tuple[Any, ...]
    out_shardings: Any
    donate_argnums: Tuple[int, ...] = ()


def shape_info(shape) -> Dict:
    """A cell's ``{"seq", "batch", "step"}``: ``SHAPES[shape]``, or
    ``shape`` itself when it is such a dict (a cut-down cell)."""
    return SHAPES[shape] if isinstance(shape, str) else shape


def batch_shapes(cfg: ModelConfig, shape_name,
                 device="cpu") -> Dict[str, torch.Tensor]:
    """The cell's batch as fake tensors: ``inputs`` (B, S) int32 (or
    ``embeds`` (B, S, d) bf16 for a model fed external embeddings), S = 1
    for a decode cell, and ``labels`` (B, S) (``(B, S, C)`` for a
    multi-codebook head) for a train cell. ``shape_name``: a key of
    ``SHAPES`` or a dict like its values."""
    info = shape_info(shape_name)
    B = info["batch"]
    S = 1 if info["step"] == "decode" else info["seq"]
    with shape_mode():
        if cfg.external_embeddings:
            batch = {"embeds": torch.empty((B, S, cfg.d_model),
                                           dtype=torch.bfloat16,
                                           device=device)}
        else:
            batch = {"inputs": torch.empty((B, S), dtype=torch.int32,
                                           device=device)}
        if info["step"] == "train":
            lbl = (B, S, cfg.n_codebooks) if cfg.n_codebooks > 1 else (B, S)
            batch["labels"] = torch.empty(lbl, dtype=torch.int32,
                                          device=device)
    return batch


def train_state_shapes(model, opt_cfg: OptConfig) -> Dict:
    """``{"params", "opt", "step"}`` of a fresh train state as fake
    tensors (the reference's ``eval_shape`` of the state's init)."""
    with shape_mode():
        params = model.param_shapes()
        return {"params": params, "opt": init_opt_state(params, opt_cfg),
                "step": torch.zeros((), dtype=torch.int32,
                                    device=model.device)}


def _local_fakes(tree, specs, mesh):
    return tree_map_paths(lambda p, t: t.new_empty(
        local_shape(t.shape, tree_at(specs, p), mesh)), tree)


def build_bundle(cfg: ModelConfig, shape_name, mesh,
                 opt_cfg: Optional[OptConfig] = None,
                 sparse_train: bool = False, device="cpu") -> StepBundle:
    """The cell's :class:`StepBundle` on ``mesh`` (this rank's ``Mesh``, or
    ``None`` for one device): a ``train`` cell's train step over the state
    and batch (``donate_argnums`` (0,)); a ``prefill`` cell's
    :func:`make_prefill_step` over params and batch; a ``decode`` cell's
    :func:`make_serve_step` over params, a one-token batch, caches of the
    cell's length and a 0-d ``cache_index`` (``donate_argnums`` (2,)).
    Placement as the reference's: ``param_specs``, ``batch_spec``,
    ``cache_specs``, AdamW moments by ``opt_state_specs``. Builds fake
    tensors only (in the active fake mode, or a new one). ``shape_name``:
    a key of ``SHAPES`` or a dict like its values."""
    info = shape_info(shape_name)
    tag = shape_name if isinstance(shape_name, str) \
        else f"{info['step']}_{info['seq']}x{info['batch']}"
    model = Model(cfg, device=device)
    sharded = mesh is not None and mesh.size > 1
    step_mesh = mesh if sharded else None
    with shape_mode():
        pshapes = model.param_shapes()
        batch = batch_shapes(cfg, info, device)
        pspecs = param_specs(pshapes, mesh) if sharded else None
        bspecs = batch_spec(batch, mesh) if sharded else None
        if info["step"] == "train":
            opt_cfg = opt_cfg or OptConfig()
            state = {"params": pshapes,
                     "opt": init_opt_state(pshapes, opt_cfg),
                     "step": torch.zeros((), dtype=torch.int32,
                                         device=device)}
            state_specs = None
            if sharded:
                if opt_cfg.name == "adamw":
                    ms = opt_state_specs(pspecs, mesh, pshapes)
                    ospecs = {"m": ms, "v": ms}
                else:
                    ospecs = opt_state_leaf_specs(
                        _local_fakes(pshapes, pspecs, mesh), pspecs, mesh,
                        opt_cfg)
                state_specs = {"params": pspecs, "opt": ospecs, "step": ()}
            fn = make_train_step(model, opt_cfg, sparse_train=sparse_train,
                                 mesh=step_mesh, specs=pspecs)
            return StepBundle(
                name=f"train:{cfg.name}:{tag}", fn=fn,
                args=(state, batch), in_shardings=(state_specs, bspecs),
                out_shardings=(state_specs, None), donate_argnums=(0,))
        cache = model.init_cache(info["batch"], info["seq"])
        cspecs = cache_specs(cache, mesh, cfg.uniform_layers) \
            if sharded else None
        if info["step"] == "prefill":
            return StepBundle(
                name=f"prefill:{cfg.name}:{tag}",
                fn=make_prefill_step(model, step_mesh, pspecs, cspecs),
                args=(pshapes, batch), in_shardings=(pspecs, bspecs),
                out_shardings=(None, cspecs))
        idx = torch.zeros((), dtype=torch.int32, device=device)
        return StepBundle(
            name=f"decode:{cfg.name}:{tag}",
            fn=make_serve_step(model, step_mesh, pspecs, cspecs),
            args=(pshapes, batch, cache, idx),
            in_shardings=(pspecs, bspecs, cspecs, ()),
            out_shardings=(None, cspecs), donate_argnums=(2,))


def rank_args(bundle: StepBundle, mesh) -> Tuple[Any, ...]:
    """This rank's blocks of ``bundle.args``: fresh fake tensors of the
    rank's shapes (``launch.sharding.local_shape`` of each leaf's spec),
    so that nothing holds the whole arrays; the args as they are without
    a mesh."""
    if mesh is None or mesh.size == 1:
        return bundle.args
    with shape_mode():
        return tuple(
            a.new_empty(local_shape(a.shape, sp, mesh)) if torch.is_tensor(a)
            else _local_fakes(a, sp, mesh)
            for a, sp in zip(bundle.args, bundle.in_shardings))
