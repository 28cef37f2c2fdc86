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
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.models.common import torch_dtype

__all__ = ["OptConfig", "init_opt_state", "apply_updates", "lr_at"]


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


def init_opt_state(params: Any, cfg: OptConfig) -> Dict:
    """Zero moments in ``state_dtype`` on each leaf's device: AdamW
    ``{"m", "v"}`` trees like ``params``; Adafactor ``{"v"}`` whose leaves
    are ``{"vr" (..., r), "vc" (..., c)}`` for leaves whose last two dims
    are both at least ``factored_min_dim``, else ``{"v"}``."""
    dt = torch_dtype(cfg.state_dtype)

    def zeros(p, shape=None):
        return torch.zeros(p.shape if shape is None else shape, dtype=dt,
                           device=p.device)

    if cfg.name == "adamw":
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params)}
    if cfg.name == "adafactor":
        def vstate(p):
            if _factored(p.shape, cfg.factored_min_dim):
                return {"vr": zeros(p, p.shape[:-1]),
                        "vc": zeros(p, p.shape[:-2] + p.shape[-1:])}
            return {"v": zeros(p)}
        return {"v": tree_map(vstate, params)}
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


def _adafactor_update(p, g, vs: Dict, lr, cfg: OptConfig, t) -> None:
    gf = g.float()
    decay = 1.0 - t ** -0.8
    g2 = gf.square().add_(1e-30)
    if "vr" in vs:
        vr = _as_f32(vs["vr"]).mul_(decay).add_(g2.mean(-1) * (1 - decay))
        vc = _as_f32(vs["vc"]).mul_(decay).add_(g2.mean(-2) * (1 - decay))
        del g2
        denom = (vr / torch.clamp(vr.mean(-1, keepdim=True), min=1e-30)
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
    rms = torch.sqrt(upd.square().mean() + 1e-30)
    upd.div_(torch.clamp(rms, min=1.0))
    pf = _as_f32(p)
    if cfg.weight_decay:
        upd.add_(cfg.weight_decay * pf)
    _store(p, pf.sub_(lr * upd))


def _global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    total = 0.0
    for g in grads:
        total = total + g.float().square().sum()
    return torch.sqrt(total + 1e-20)


@torch.no_grad()
def apply_updates(params: Any, grads: Any, state: Dict, step: torch.Tensor,
                  cfg: OptConfig,
                  project_fn: Optional[Callable[[Any], Any]] = None
                  ) -> Tuple[Any, Dict, Dict]:
    """One optimizer step, in place: ``grads`` (a tree like ``params``)
    scaled to a global norm of at most ``grad_clip``, then AdamW (bias
    corrected, decoupled weight decay) or Adafactor (factored second
    moment, update clipping) at ``lr_at(cfg, step)``; then
    ``project_fn(params)``. The gradients are scaled in place too.
    Returns ``(params, state, {"grad_norm", "lr"})``, the same tree
    objects as given (``project_fn``'s result for the params)."""
    flat_p = [leaf for _, leaf in tree_leaves(params)]
    flat_g = [leaf for _, leaf in tree_leaves(grads)]
    if len(flat_p) != len(flat_g):
        raise ValueError(f"{len(flat_g)} gradients for {len(flat_p)} "
                         "parameters")
    gnorm = _global_norm(flat_g)
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
            _adamw_update(p, g, m, v, lr, cfg, t)
    elif cfg.name == "adafactor":
        for (path, p), g in zip(tree_leaves(params), flat_g):
            vs = state["v"]
            for k in path:
                vs = vs[k]
            _adafactor_update(p, g, vs, lr, cfg, t)
    else:
        raise ValueError(cfg.name)
    if project_fn is not None:
        params = project_fn(params)
    return params, state, {"grad_norm": gnorm, "lr": lr}
