"""The train step (``repro.launch.steps.make_train_step``): forward,
backward and the optimizer update of one batch, on one device or on one
rank of a mesh.

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
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.core.tree import tree_at, tree_leaves
from repro_torch.launch.sharding import grad_reduce_axes
from repro_torch.optim.adamw import OptConfig, apply_updates

__all__ = ["make_train_step", "loss_and_grads"]


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
