"""Cross-pod gradient compression with error feedback
(``repro.optim.grad_comp``).

The ``pod`` axis crosses the data-center interconnect, the slowest hop of
a multi-pod mesh. Each pod quantizes its gradient to int8 per tensor
before the pod all-reduce and carries the quantization error into the
next step (error feedback, as in 1-bit Adam / EF-SGD), which cuts the
gradient traffic over pods 4x against f32.

The arithmetic is the reference's, step for step: ``x = g + e`` in f32,
the scale ``(max |x| + 1e-12) / 127`` of the whole tensor, ``q =
clip(round(x / scale), -127, 127)`` as int8, the new error ``x - q *
scale``, and the dequantized payload summed over pods in bf16, then
divided by the number of pods in f32. As in the reference, the payload
sent is the dequantized one (the wire format of int8 codes plus per-pod
scales moves the same bytes a value). On a mesh whose ranks hold slices
of a tensor (``specs`` given), the max that sets the scale is taken over
the whole tensor (all-reduce MAX over the axes that cut it), as the
reference's pod-only ``shard_map`` sees whole tensors.

As in the reference, the train loop does not call it: it is the
building block of a loop that reduces gradients over pods by hand.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.launch.sharding import spec_axes

__all__ = ["init_ef_state", "compress_pod_allreduce"]


def init_ef_state(grads_like: Any, dtype=torch.bfloat16) -> Any:
    """Zero error-feedback buffers like ``grads_like``, in ``dtype``."""
    return tree_map(lambda g: torch.zeros(g.shape, dtype=dtype,
                                          device=g.device), grads_like)


def _quant(x: torch.Tensor, amax: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 codes of ``x`` and their scale."""
    scale = (amax + 1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


@torch.no_grad()
def compress_pod_allreduce(grads: Any, ef: Any, mesh, n_pods: int,
                           specs: Optional[Any] = None) -> Tuple[Any, Any]:
    """All-reduce ``grads`` over the ``pod`` axis of ``mesh`` with int8
    codes and error feedback ``ef``. Returns ``(the mean gradients over
    pods, the new error-feedback state)``, new trees; the identity when
    the mesh has no pod axis (or one pod). ``specs``: the leaves'
    placement when each rank holds a slice of them."""
    if mesh is None or "pod" not in mesh.axis_names or n_pods <= 1:
        return grads, ef
    out_g, out_e = {}, {}
    leaves = list(tree_leaves(grads))
    flat_e = [e for _, e in tree_leaves(ef)]
    flat_s = [None] * len(leaves) if specs is None \
        else [s for _, s in tree_leaves(specs)]
    for (path, g), e, spec in zip(leaves, flat_e, flat_s):
        x = g.float() + e.float()
        amax = x.abs().max()
        for a in sorted({a for ent in spec or () for a in spec_axes(ent)}):
            amax = mesh.all_reduce(amax.reshape(1), a, "max")[0]
        q, scale = _quant(x, amax)
        deq = q.float() * scale
        total = mesh.all_reduce(deq.to(torch.bfloat16), "pod")
        for node, val in ((out_g, (total.float() / n_pods).to(g.dtype)),
                          (out_e, (x - deq).to(e.dtype))):
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = val
    return out_g, out_e
