"""Fault-tolerant checkpoints (``repro.checkpoint.checkpoint``), in the
reference's ``npz-v1`` format, so a checkpoint written by either package
restores in the other: one ``arrays.npz`` keyed by the tree's flattened
paths joined by ``/`` (dict keys sorted at every level), and a
``manifest.json`` (``step``, sorted ``keys``, ``nbytes``, ``format``)
written last into a temporary directory that is renamed to
``step_XXXXXXXX`` atomically, so a partial write is invisible to restore.
Keep-last-k cleanup, and :func:`async_save`, which snapshots the tensors
to host numpy before its writer thread starts, so the train loop may go
on updating them in place.

bf16 leaves are stored as the reference stores them (numpy has no
bfloat16: 2-byte ``|V2`` records of the bits) and read back by their
bits.

A checkpoint holds whole leaves whatever mesh wrote it (the train loop
gathers a sharded state and one rank writes it), so it is
mesh-independent: :func:`restore_checkpoint` with ``shardings=`` (the
placement of each leaf of the tree to restore) and ``mesh=`` reads whole
arrays and keeps the slice that this rank's mesh gives it. That is the
elastic re-mesh: a run saved on a ``(2, 2)`` mesh resumes on ``(4, 1)``,
or without a mesh, and takes the same steps.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core.tree import tree_leaves
from repro_torch.launch.sharding import cut_leaf, full_shape

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "async_save", "wait_pending", "cleanup_old"]


def _to_numpy(x: torch.Tensor) -> np.ndarray:
    """A host copy of a leaf, detached from it."""
    t = x.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _flatten(tree: Any) -> Dict[str, np.ndarray]:
    return {"/".join(p): _to_numpy(leaf) for p, leaf in tree_leaves(tree)}


def save_checkpoint(ckpt_dir: Union[str, Path], step: int, tree: Any,
                    keep: int = 3) -> Path:
    """Write atomically: tmp dir -> arrays.npz + manifest.json -> rename;
    then keep the last ``keep`` steps."""
    return _write(ckpt_dir, step, _flatten(tree), keep)


def _write(ckpt_dir: Union[str, Path], step: int,
           flat: Dict[str, np.ndarray], keep: int) -> Path:
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = Path(tempfile.mkdtemp(prefix=f".tmp_step_{step}_", dir=ckpt_dir))
    try:
        np.savez(tmp / "arrays.npz", **flat)
        manifest = {
            "step": step,
            "keys": sorted(flat.keys()),
            "nbytes": int(sum(v.nbytes for v in flat.values())),
            "format": "npz-v1",
        }
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)  # atomic on POSIX
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    cleanup_old(ckpt_dir, keep)
    return final


_PENDING: List[threading.Thread] = []


def async_save(ckpt_dir: Union[str, Path], step: int, tree: Any,
               keep: int = 3) -> None:
    """Snapshot the tree to host numpy now (a copy, synchronous), write it
    to disk in a thread: the caller may update the tensors meanwhile."""
    t = threading.Thread(target=_write,
                         args=(ckpt_dir, step, _flatten(tree), keep),
                         daemon=True)
    t.start()
    _PENDING.append(t)
    _PENDING[:] = [x for x in _PENDING if x.is_alive()]


def wait_pending() -> None:
    for t in list(_PENDING):
        t.join()


def latest_step(ckpt_dir: Union[str, Path]) -> Optional[int]:
    d = Path(ckpt_dir)
    if not d.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in d.iterdir()
             if p.name.startswith("step_") and (p / "manifest.json").exists()]
    return max(steps) if steps else None


def _to_tensor(arr: np.ndarray, like: torch.Tensor, spec=None,
               mesh=None) -> torch.Tensor:
    arr = np.require(arr, requirements="C")  # keeps 0-d leaves 0-d
    if like.dtype == torch.bfloat16 and arr.dtype.itemsize == 2 \
            and arr.dtype.kind not in "f":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    if spec is not None:
        t = cut_leaf(t, spec, mesh).clone()
    return t.to(like.dtype).to(like.device)


def restore_checkpoint(ckpt_dir: Union[str, Path], tree_like: Any,
                       step: Optional[int] = None, shardings: Any = None,
                       mesh=None) -> Tuple[Any, int]:
    """Restore step ``step`` (default: the latest complete one) into the
    structure of ``tree_like``: each leaf becomes a tensor of its
    ``tree_like`` leaf's dtype on that leaf's device.
    Raises ``FileNotFoundError`` without a checkpoint, ``KeyError`` for a
    leaf the checkpoint lacks and ``ValueError`` for a shape that differs,
    as the reference does.

    ``shardings`` (a tree like ``tree_like`` of specs, with ``mesh``, this
    rank's mesh): ``tree_like``'s leaves are this rank's slices; each
    whole array is read, checked against the whole shape, and cut to the
    rank's slice (``launch.sharding.shard_params``' cut)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    if mesh is None or mesh.size == 1:
        shardings = None
    d = Path(ckpt_dir) / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    keys = set(manifest["keys"])
    with np.load(d / "arrays.npz") as data:
        def build(node, prefix, spec):
            if isinstance(node, dict):
                return {k: build(v, prefix + (str(k),),
                                 None if spec is None else spec[k])
                        for k, v in node.items()}
            key = "/".join(prefix)
            if key not in keys:
                raise KeyError(f"checkpoint missing leaf {key}")
            arr = data[key]
            want = tuple(node.shape) if spec is None \
                else full_shape(node.shape, spec, mesh)
            if tuple(arr.shape) != want:
                raise ValueError(f"shape mismatch for {key}: "
                                 f"{arr.shape} vs {want}")
            return _to_tensor(arr, node, spec, mesh)
        return build(tree_like, (), shardings), step


def cleanup_old(ckpt_dir: Union[str, Path], keep: int) -> None:
    d = Path(ckpt_dir)
    steps = sorted(
        p for p in d.iterdir()
        if p.name.startswith("step_") and (p / "manifest.json").exists())
    for p in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(p, ignore_errors=True)
