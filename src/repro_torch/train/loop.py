"""The training loop (``repro.train.loop``), on one device or on a mesh of
rank processes: checkpoint and restart, the NaN / spike / step-timeout
guard, and the paper's schedule:
dense warmup, then factorized sparse training (the straight-through top-k
projection of W_D in the forward pass plus the out-of-support L1 term)
from ``sparse_from_step``, with a hard projection of every W_D to its
fixed NZ per column every ``project_every`` sparse steps.

On the CPU its observable behaviour is the reference's: the same
``history`` and checkpoint cadence for the same data. Where the reference
relies on buffer donation, the port decides between the backward pass and
the in-place update (``launch/steps.py``): a bad step leaves the state as
it was when a checkpoint exists, and takes the updated state when none
does. Before it looks for a checkpoint the guard waits for pending
asynchronous saves, so the choice does not depend on the writer thread's
progress.

On a mesh (``train(..., mesh=)``, every rank of it calling ``train``
with the same arguments) the state holds this rank's slices, placed by
``launch.sharding.param_specs`` of the whole tree, and each rank takes
its block of every batch over ``pod`` / ``data``. The ranks decide
together: the step's bad verdict (whose timeout part is each rank's own
clock) is agreed by an all-reduce MAX, and so is the look for a
checkpoint, which only the writing rank makes. Checkpoints stay the
reference's mesh-independent ``npz-v1`` of whole leaves: the ranks
gather the state leaf by leaf to the host of rank 0 of the mesh, which
writes it once; a restore keeps the slice of the current mesh
(``restore_checkpoint(shardings=)``). The post-update projection sees
whole W_D columns (their rows gathered over ``model``).
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.checkpoint.checkpoint import (async_save, latest_step,
                                               restore_checkpoint,
                                               wait_pending)
from repro_torch.core.factorized import (FactorizationConfig,
                                         project_wd_leaves)
from repro_torch.core.tree import (tree_at, tree_leaves, tree_map,
                                   tree_map_paths)
from repro_torch.data.loader import to_device
from repro_torch.launch.sharding import (batch_spec, cut_leaf, gather_leaf,
                                         param_specs, shard_params,
                                         spec_axes)
from repro_torch.launch.steps import make_train_step
from repro_torch.optim.adamw import (OptConfig, init_opt_state,
                                     opt_state_leaf_specs)

__all__ = ["TrainLoopConfig", "train", "make_project_fn"]


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int = 200
    ckpt_dir: str = "checkpoints"
    ckpt_every: int = 50
    keep: int = 3
    log_every: int = 10
    # Fault tolerance
    nan_guard: bool = True
    max_consecutive_bad: int = 3
    step_timeout_s: float = 0.0  # 0 = off; > 0: a slower step is bad
    # Paper schedule
    sparse_from_step: int = 0  # STE projection active from this step
    project_every: int = 25  # hard top-k projection of W_D (0 = off)


def make_project_fn(fcfg: FactorizationConfig, mesh=None,
                    specs=None) -> Callable[[Any], Any]:
    """Hard top-k-per-column projection of every W_D leaf (any leading
    dims), :func:`~repro_torch.core.factorized.project_wd_leaves` written
    back into the tree's own tensors: returns the same tree, so whoever
    holds it (or its leaves) sees the projected W_D. On a mesh (``specs``
    the tree's placement) a W_D whose rank axis ``model`` cut gathers the
    rows of its columns, projects the whole columns and keeps its rows."""

    def copy_back(dst, src):
        for k, v in dst.items():
            if isinstance(v, dict):
                copy_back(v, src[k])
            elif k == "wd":
                v.copy_(src[k])

    def project(params):
        with torch.no_grad():
            if mesh is None or mesh.size == 1:
                copy_back(params, project_wd_leaves(params, fcfg))
                return params
            for path, leaf in tree_leaves(params):
                if path[-1] != "wd":
                    continue
                if "model" not in spec_axes(tree_at(specs, path)[-2]):
                    leaf.copy_(project_wd_leaves({"wd": leaf}, fcfg)["wd"])
                    continue
                whole = mesh.gather(leaf, -2, "model")
                leaf.copy_(mesh.block(
                    project_wd_leaves({"wd": whole}, fcfg)["wd"], -2))
        return params

    return project


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _agree(flag: bool, mesh) -> bool:
    """``flag`` of any rank of ``mesh`` (all-reduce MAX over every axis)."""
    if mesh is None or mesh.size == 1:
        return flag
    t = torch.tensor([float(flag)], device=mesh.device)
    for a in mesh.axis_names:
        t = mesh.all_reduce(t, a, "max")
    return bool(t.item())


def _writer(mesh) -> bool:
    return mesh is None or all(c == 0 for c in mesh.coords.values())


def _gather_to_host(state, specs, mesh):
    """The whole state on the writer's host, gathered leaf by leaf (every
    rank joins each gather; a rank's device holds one whole leaf at a
    time). Other ranks get None leaves."""
    keep = _writer(mesh)

    def leaf(path, t):
        t = gather_leaf(t, tree_at(specs, path), mesh)
        return t.cpu() if keep else None

    return tree_map_paths(leaf, state)


def train(model, data: Iterator[Dict[str, np.ndarray]],
          opt_cfg: OptConfig, loop_cfg: TrainLoopConfig, *, mesh=None,
          seed: int = 0, hooks: Optional[Dict[str, Callable]] = None,
          params: Optional[Dict] = None,
          specs: Optional[Dict] = None) -> Dict[str, Any]:
    """Run (or resume) training of ``model`` on its device over numpy
    batches from ``data``. The state starts from ``params`` (default
    ``model.init(seed)``; the whole tree, or on a mesh with ``specs``
    this rank's slices of it, placed by ``specs``), or from the latest
    checkpoint in ``loop_cfg.ckpt_dir`` when there is one.
    ``hooks["inject_fault"](step, batch)`` may replace a batch. Returns
    ``{"state": {"params", "opt", "step"}, "history": [{"step", "loss",
    "dt", "grad_norm", "sparse"}, ...]}`` (a record every ``log_every``
    steps and at the last; ``dt`` the whole step's wall seconds,
    synchronized) and ``"specs"``: on a ``mesh`` (see the module
    docstring), where the state holds this rank's slices, the placement
    of its params (else None). On a mesh only its rank 0 prints."""
    hooks = hooks or {}
    if specs is not None and params is None:
        raise ValueError("specs= places given params (this rank's slices)")
    fcfg = model.cfg.factorization
    dev = model.device
    if mesh is not None and mesh.size == 1:
        mesh = None
    say = print if _writer(mesh) else (lambda *a, **k: None)
    ckpt = loop_cfg.ckpt_dir

    params = model.init(seed) if params is None else params
    if mesh is None:
        specs = None
    elif specs is None:
        specs = param_specs(params, mesh)
        params = tree_map(lambda t: t.to(dev).clone(),
                          shard_params(params, specs, mesh))
    state = {"params": params,
             "opt": init_opt_state(params, opt_cfg, mesh, specs),
             "step": torch.zeros((), dtype=torch.int32, device=dev)}
    state_specs = None if mesh is None else {
        "params": specs, "step": (),
        "opt": opt_state_leaf_specs(params, specs, mesh, opt_cfg)}
    project_fn = make_project_fn(fcfg, mesh, specs) if (
        fcfg.enabled and loop_cfg.project_every) else None

    def restore(state):
        return restore_checkpoint(ckpt, state, shardings=state_specs,
                                  mesh=mesh)

    if latest_step(ckpt) is not None:
        state, start_step = restore(state)
        say(f"[train] resumed from step {start_step}")
    step0 = int(state["step"])

    dense_step = make_train_step(model, opt_cfg, sparse_train=False,
                                 mesh=mesh, specs=specs)
    sparse_step = make_train_step(model, opt_cfg, sparse_train=True,
                                  mesh=mesh, specs=specs)

    def has_checkpoint() -> bool:
        # Only the writer waits for its saves; the others learn the answer.
        if _writer(mesh):
            wait_pending()
        return _agree(_writer(mesh) and latest_step(ckpt) is not None, mesh)

    history = []
    bad_streak = 0
    prev_loss = None
    for step in range(step0, loop_cfg.total_steps):
        batch = next(data)
        if "inject_fault" in hooks:
            batch = hooks["inject_fault"](step, batch)
        batch = to_device(batch, dev)
        if mesh is not None:
            batch = {k: cut_leaf(v, sp, mesh) for (k, v), sp in zip(
                batch.items(), batch_spec(batch, mesh).values())}
        sparse = fcfg.enabled and step >= loop_cfg.sparse_from_step
        fn = sparse_step if sparse else dense_step
        _sync(dev)
        t0 = time.perf_counter()
        verdict: Dict[str, Any] = {}

        def guard(metrics, t0=t0, verdict=verdict, prev=prev_loss):
            # Reads the loss (a host sync) after the backward pass. The
            # timeout sees the step up to here: past the update, a bad
            # step could no longer leave the state as it was.
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            bad = not math.isfinite(loss)
            if prev is not None and math.isfinite(loss):
                bad |= loss > max(3.0 * prev, prev + 5.0)
            if loop_cfg.step_timeout_s and dt > loop_cfg.step_timeout_s:
                bad = True
            bad = _agree(bad, mesh)
            verdict.update(loss=loss, bad=bad)
            if not (loop_cfg.nan_guard and bad):
                return True
            return not has_checkpoint()  # no checkpoint: take it

        state, metrics = fn(state, batch, guard=guard)
        _sync(dev)
        dt = time.perf_counter() - t0
        loss = verdict["loss"]

        if loop_cfg.nan_guard and verdict["bad"]:
            bad_streak += 1
            say(f"[train] step {step}: bad step (loss={loss}, "
                  f"{dt:.1f}s) — skipped "
                  f"({bad_streak}/{loop_cfg.max_consecutive_bad})")
            if bad_streak >= loop_cfg.max_consecutive_bad:
                if has_checkpoint():
                    state, ck = restore(state)
                    say(f"[train] restarted from checkpoint step {ck}")
                bad_streak = 0
            continue
        bad_streak = 0
        prev_loss = loss if prev_loss is None \
            else 0.9 * prev_loss + 0.1 * loss

        # Paper schedule: periodic hard projection of W_D.
        if project_fn is not None and sparse and \
                (step + 1) % loop_cfg.project_every == 0:
            state["params"] = project_fn(state["params"])

        if step % loop_cfg.log_every == 0 \
                or step == loop_cfg.total_steps - 1:
            rec = {"step": step, "loss": loss, "dt": dt,
                   "grad_norm": float(metrics.get("grad_norm", 0.0)),
                   "sparse": sparse}
            history.append(rec)
            say(f"[train] step {step:5d} loss {loss:8.4f} "
                  f"gnorm {rec['grad_norm']:8.3f} {dt * 1e3:7.1f}ms"
                  f"{' [sparse]' if sparse else ''}")
        if (step + 1) % loop_cfg.ckpt_every == 0:
            whole = state if mesh is None else _gather_to_host(
                state, state_specs, mesh)
            if _writer(mesh):
                async_save(ckpt, step + 1, whole, keep=loop_cfg.keep)
            del whole

    wait_pending()
    _agree(False, mesh)  # every rank returns once the writer's saves end
    return {"state": state, "history": history, "specs": specs}
