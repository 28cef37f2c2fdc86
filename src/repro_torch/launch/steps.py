"""The train step (``repro.launch.steps.make_train_step``): forward,
backward and the optimizer update of one batch on one device.

The step updates the train state ``{"params", "opt", "step"}`` **in
place** and holds no second copy of it: a full-width state on one card
(f32 masters, gradients and two moments) leaves no room for one. So a
caller that may refuse the update (the train loop's NaN / spike guard)
decides between the backward pass and the update: ``guard(metrics)`` is
called with the loss metrics once the gradients exist, and a false
answer leaves the state untouched.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.core.tree import tree_leaves
from repro_torch.optim.adamw import OptConfig, apply_updates

__all__ = ["make_train_step"]


def make_train_step(model, opt_cfg: OptConfig, sparse_train: bool = False,
                    project_fn: Optional[Callable] = None) -> Callable:
    """``train_step(state, batch, guard=None) -> (state, metrics)``: the
    gradients of ``model.loss(state["params"], batch, sparse_train=)``
    with respect to every parameter leaf (zeros for a leaf the loss does
    not reach, as ``jax.grad`` gives), then :func:`apply_updates` in place
    and ``state["step"] += 1``. ``metrics`` holds the loss's keys plus
    ``grad_norm`` and ``lr`` (f32 0-d tensors on the device; no host sync
    unless ``guard`` reads one). When ``guard(metrics)`` is false the
    update is skipped and the state is returned as it was."""

    def train_step(state: Dict, batch: Dict,
                   guard: Optional[Callable[[Dict], bool]] = None
                   ) -> Tuple[Dict, Dict]:
        params = state["params"]
        leaves = [leaf for _, leaf in tree_leaves(params)]
        for leaf in leaves:
            leaf.requires_grad_(True)
        try:
            total, metrics = model.loss(params, batch,
                                        sparse_train=sparse_train)
            grads = torch.autograd.grad(total, leaves, allow_unused=True)
        finally:
            for leaf in leaves:
                leaf.requires_grad_(False)
        metrics = {k: v.detach() for k, v in metrics.items()}
        if guard is not None and not guard(metrics):
            return state, metrics
        grad_tree: Dict = {}
        for (path, p), g in zip(tree_leaves(params), grads):
            node = grad_tree
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = torch.zeros_like(p) if g is None else g
        del grads
        new_params, _, stats = apply_updates(
            params, grad_tree, state["opt"], state["step"], opt_cfg,
            project_fn=project_fn)
        del grad_tree
        state["params"] = new_params
        state["step"] += 1
        metrics.update(stats)
        return state, metrics

    return train_step

