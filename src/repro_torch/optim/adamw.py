"""Optimizers (``repro.optim.adamw``): AdamW and Adafactor with schedules,
global-norm clipping, reduced-precision moment storage and a post-update
projection hook (the paper's fixed-NZ W_D).

Trees are nested dicts of tensors. :func:`apply_updates` writes the new
parameters and moments **in place**, under ``torch.no_grad()``, one leaf
at a time: a full-width train state on one card (f32 masters, gradients
and two moments) leaves no room for a second copy. Leaves are visited in
sorted-key order, the order in which ``jax.tree`` flattens a dict, so the
global norm sums in the reference's order. Weight decay applies to every
leaf (norm scales and biases too), as in the reference. Schedules and
bias corrections are computed on the step's device from the ``step``
tensor: no host sync.

On a mesh (``mesh=``, ``specs=``: the train step's, each leaf this rank's
slice) every quantity that the reference takes over a whole leaf is
taken over the whole leaf here too: the global gradient norm sums each
leaf's squares over the axes that cut it (a replicated leaf counted
once), Adafactor's row and column means and its update RMS all-reduce
over the axes that cut their dims. AdamW's moments are placed as
``launch.sharding.opt_state_specs`` says: on a mesh with a ``pod`` axis
they are also cut over pods (ZeRO), so each rank updates its pod block
of its slice and the pod ranks all-gather the new parameters. Adafactor's
factored moments follow their leaf's slice (the reference leaves their
placement to GSPMD).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.core.tree import (tree_at, tree_leaves, tree_map,
                                   tree_map_paths)
from repro_torch.launch.sharding import (full_shape, local_shape,
                                         opt_state_specs, spec_axes)
from repro_torch.models.common import torch_dtype

__all__ = ["OptConfig", "init_opt_state", "apply_updates", "lr_at",
           "moment_specs", "opt_state_leaf_specs"]


@dataclasses.dataclass(frozen=True)
class OptConfig:
    """The reference's fields and defaults."""

    name: str = "adamw"  # adamw | adafactor
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: str = "float32"
    warmup_steps: int = 100
    total_steps: int = 10000
    schedule: str = "cosine"  # cosine | constant | linear
    factored_min_dim: int = 128  # Adafactor: factor leaves at least this wide
    project: bool = False


def lr_at(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup over ``warmup_steps`` times the decay (``cosine`` to 0
    at ``total_steps``, ``linear``, or ``constant``), f32 on ``step``'s
    device."""
    s = torch.as_tensor(step).float()
    warm = torch.clamp((s + 1.0) / max(cfg.warmup_steps, 1), max=1.0)
    if cfg.schedule == "constant":
        decay = 1.0
    elif cfg.schedule == "linear":
        decay = torch.clamp(1.0 - s / max(cfg.total_steps, 1), min=0.0)
    else:  # cosine
        frac = torch.clamp(s / max(cfg.total_steps, 1), 0.0, 1.0)
        decay = 0.5 * (1.0 + torch.cos(math.pi * frac))
    return cfg.lr * warm * decay


def _factored(shape, min_dim) -> bool:
    return len(shape) >= 2 and shape[-1] >= min_dim and shape[-2] >= min_dim


class _Shape:
    """A leaf's whole shape, for the placement rules."""

    def __init__(self, shape):
        self.shape = tuple(shape)


def moment_specs(params: Any, specs: Any, mesh) -> Any:
    """The AdamW moments' placement: ``launch.sharding.opt_state_specs``
    of the parameters' ``specs`` over their whole shapes (``params`` this
    rank's slices)."""
    shapes = tree_map_paths(lambda path, p: _Shape(full_shape(
        p.shape, tree_at(specs, path), mesh)), params)
    return opt_state_specs(specs, mesh, shapes)


def opt_state_leaf_specs(params: Any, specs: Any, mesh,
                         cfg: OptConfig) -> Dict:
    """The placement of every leaf of :func:`init_opt_state`'s tree on a
    mesh: AdamW's ``m`` and ``v`` as :func:`moment_specs`; Adafactor's
    ``vr`` as its leaf without the last dim (a row mean is whole on the
    ranks that cut the columns), ``vc`` without dim -2, ``v`` as its
    leaf."""
    if cfg.name == "adamw":
        ms = moment_specs(params, specs, mesh)
        return {"m": ms, "v": ms}

    def vspec(path, p):
        sp = tree_at(specs, path)
        if _factored(full_shape(p.shape, sp, mesh), cfg.factored_min_dim):
            return {"vr": sp[:-1], "vc": sp[:-2] + sp[-1:]}
        return {"v": sp}
    return {"v": tree_map_paths(vspec, params)}


def init_opt_state(params: Any, cfg: OptConfig, mesh=None,
                   specs: Any = None) -> Dict:
    """Zero moments in ``state_dtype`` on each leaf's device: AdamW
    ``{"m", "v"}`` trees like ``params``; Adafactor ``{"v"}`` whose leaves
    are ``{"vr" (..., r), "vc" (..., c)}`` for leaves whose last two dims
    are both at least ``factored_min_dim``, else ``{"v"}``. On a mesh
    (``params`` this rank's slices, placed by ``specs``) each moment is
    this rank's slice of the whole one: AdamW's cut as
    :func:`moment_specs` says, Adafactor's as their leaf (the factoring
    decided on the whole leaf's shape)."""
    dt = torch_dtype(cfg.state_dtype)
    sharded = mesh is not None and specs is not None

    def zeros(p, shape=None):
        return torch.zeros(p.shape if shape is None else shape, dtype=dt,
                           device=p.device)

    if cfg.name == "adamw":
        if not sharded:
            return {"m": tree_map(zeros, params),
                    "v": tree_map(zeros, params)}
        ms = moment_specs(params, specs, mesh)

        def mzeros(path, p):
            sp = tree_at(specs, path)
            return zeros(p, local_shape(full_shape(p.shape, sp, mesh),
                                        tree_at(ms, path), mesh))

        return {k: tree_map_paths(mzeros, params) for k in ("m", "v")}
    if cfg.name == "adafactor":
        def vstate(path, p):
            whole = full_shape(p.shape, tree_at(specs, path), mesh) \
                if sharded else tuple(p.shape)
            if _factored(whole, cfg.factored_min_dim):
                return {"vr": zeros(p, p.shape[:-1]),
                        "vc": zeros(p, p.shape[:-2] + p.shape[-1:])}
            return {"v": zeros(p)}
        return {"v": tree_map_paths(vstate, params)}
    raise ValueError(cfg.name)


def _store(dst: torch.Tensor, val: torch.Tensor) -> None:
    """``dst`` <- ``val`` cast to ``dst``'s dtype (no copy when ``val`` is
    ``dst`` itself, updated in place)."""
    if val is not dst:
        dst.copy_(val)


def _as_f32(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when f32 (to be updated in place), else an f32 copy."""
    return t if t.dtype == torch.float32 else t.float()


def _adamw_update(p, g, m, v, lr, cfg: OptConfig, t) -> None:
    gf = g.float()
    mf = _as_f32(m).mul_(cfg.b1).add_(gf * (1 - cfg.b1))
    vf = _as_f32(v).mul_(cfg.b2).add_(gf.square() * (1 - cfg.b2))
    del gf
    upd = (mf / (1 - cfg.b1 ** t)).div_(
        (vf / (1 - cfg.b2 ** t)).sqrt_().add_(cfg.eps))
    _store(m, mf)
    _store(v, vf)
    del mf, vf
    pf = _as_f32(p)
    if cfg.weight_decay:
        upd.add_(cfg.weight_decay * pf)
    _store(p, pf.sub_(lr * upd))


def _adafactor_update(p, g, vs: Dict, lr, cfg: OptConfig, t,
                      mean=None) -> None:
    """``mean(x, dim, leaf_dim)``: the mean of ``x`` over its ``dim`` (None:
    over every entry) taken over the whole leaf, whose dim ``leaf_dim``
    that is (default ``dim``); plain ``mean`` off a mesh."""
    if mean is None:
        def mean(x, dim, leaf_dim=None):
            return x.mean() if dim is None else x.mean(dim)
    gf = g.float()
    decay = 1.0 - t ** -0.8
    g2 = gf.square().add_(1e-30)
    if "vr" in vs:
        vr = _as_f32(vs["vr"]).mul_(decay).add_(mean(g2, -1) * (1 - decay))
        vc = _as_f32(vs["vc"]).mul_(decay).add_(mean(g2, -2) * (1 - decay))
        del g2
        denom = (vr / torch.clamp(mean(vr, -1, -2)[..., None], min=1e-30)
                 )[..., None] * vc[..., None, :]
        upd = gf.mul_(torch.rsqrt(denom.add_(1e-30)))
        del denom
        _store(vs["vr"], vr)
        _store(vs["vc"], vc)
    else:
        vf = _as_f32(vs["v"]).mul_(decay).add_(g2.mul_(1 - decay))
        del g2
        upd = gf.mul_(torch.rsqrt(vf + 1e-30))
        _store(vs["v"], vf)
    # Update clipping (Adafactor d = 1.0).
    rms = torch.sqrt(mean(upd.square(), None) + 1e-30)
    upd.div_(torch.clamp(rms, min=1.0))
    pf = _as_f32(p)
    if cfg.weight_decay:
        upd.add_(cfg.weight_decay * pf)
    _store(p, pf.sub_(lr * upd))


def _leaf_mean(mesh, spec):
    """:func:`_adafactor_update`'s ``mean`` for a slice of a leaf placed
    by ``spec``: the sums all-reduce over the axes that cut the leaf's
    ``leaf_dim`` (every cutting axis for a mean over every entry) and
    divide by the whole leaf's count."""
    def mean(x, dim, leaf_dim=None):
        entries = spec if dim is None else (
            spec[dim if leaf_dim is None else leaf_dim],)
        axes = [a for e in entries for a in spec_axes(e) if mesh.n(a) > 1]
        if not axes:
            return x.mean() if dim is None else x.mean(dim)
        s, n = (x.sum(), x.numel()) if dim is None else (x.sum(dim),
                                                          x.shape[dim])
        for a in axes:
            s = mesh.all_reduce(s, a)
            n *= mesh.n(a)
        return s / n
    return mean


def _global_norm(grads: List[torch.Tensor], mesh=None,
                 specs: Optional[List] = None) -> torch.Tensor:
    """sqrt of the sum of every gradient's squares, in leaf order. On a
    mesh each slice's sum is all-reduced over the axes that cut its leaf
    (sums grouped by those axes: one all-reduce per group and axis)."""
    groups: Dict[Tuple[str, ...], Any] = {}
    for k, g in enumerate(grads):
        axes = () if specs is None else tuple(
            a for e in specs[k] for a in spec_axes(e) if mesh.n(a) > 1)
        groups[axes] = groups.get(axes, 0.0) + g.float().square().sum()
    total = 0.0
    for axes, val in groups.items():
        for a in axes:
            val = mesh.all_reduce(val.reshape(1), a)[0]
        total = total + val
    return torch.sqrt(total + 1e-20)


@torch.no_grad()
def apply_updates(params: Any, grads: Any, state: Dict, step: torch.Tensor,
                  cfg: OptConfig,
                  project_fn: Optional[Callable[[Any], Any]] = None, *,
                  mesh=None, specs: Any = None
                  ) -> Tuple[Any, Dict, Dict]:
    """One optimizer step, in place: ``grads`` (a tree like ``params``)
    scaled to a global norm of at most ``grad_clip``, then AdamW (bias
    corrected, decoupled weight decay) or Adafactor (factored second
    moment, update clipping) at ``lr_at(cfg, step)``; then
    ``project_fn(params)``. The gradients are scaled in place too.
    Returns ``(params, state, {"grad_norm", "lr"})``, the same tree
    objects as given (``project_fn``'s result for the params). On a
    ``mesh`` (``params``, ``grads`` and ``state`` this rank's slices,
    ``specs`` the parameters' placement, each gradient already summed
    over its data-parallel copies) the step is the whole tree's, as the
    module docstring says."""
    if mesh is None or mesh.size == 1 or specs is None:
        mesh = specs = None
    flat_p = [leaf for _, leaf in tree_leaves(params)]
    flat_g = [leaf for _, leaf in tree_leaves(grads)]
    flat_s = None if specs is None else [sp for _, sp in tree_leaves(specs)]
    if len(flat_p) != len(flat_g):
        raise ValueError(f"{len(flat_g)} gradients for {len(flat_p)} "
                         "parameters")
    gnorm = _global_norm(flat_g, mesh, flat_s)
    if cfg.grad_clip:
        scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
        for g in flat_g:
            g.mul_(scale)
    lr = lr_at(cfg, step)
    t = torch.as_tensor(step).float() + 1.0
    if cfg.name == "adamw":
        flat_m = [leaf for _, leaf in tree_leaves(state["m"])]
        flat_v = [leaf for _, leaf in tree_leaves(state["v"])]
        for p, g, m, v in zip(flat_p, flat_g, flat_m, flat_v):
            pod = [i for i in range(p.dim()) if m.shape[i] != p.shape[i]]
            if not pod:
                _adamw_update(p, g, m, v, lr, cfg, t)
                continue
            # ZeRO over pods: update this pod's block, gather the rest.
            blk = mesh.block(p, pod[0], "pod")
            _adamw_update(blk, mesh.block(g, pod[0], "pod"), m, v, lr, cfg,
                          t)
            p.copy_(mesh.gather(blk, pod[0], "pod"))
    elif cfg.name == "adafactor":
        for k, ((path, p), g) in enumerate(zip(tree_leaves(params), flat_g)):
            vs = state["v"]
            for key in path:
                vs = vs[key]
            mean = None if mesh is None else _leaf_mean(mesh, flat_s[k])
            _adafactor_update(p, g, vs, lr, cfg, t, mean)
    else:
        raise ValueError(cfg.name)
    if project_fn is not None:
        params = project_fn(params)
    return params, state, {"grad_norm": gnorm, "lr": lr}
