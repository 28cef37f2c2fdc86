"""The serving mesh over ``torch.distributed`` (``repro.launch.mesh``).

A :class:`Mesh` is one rank's view of a ``("data", "model")`` grid of
processes: the grid's shape, this rank's coordinates on it, the process
group of each axis it belongs to, and its device. Rank ``r`` sits at
``divmod(r, model)``, the row-major order of the reference's device grid.
The reference runs one controller over every device; the port runs one
process per rank (:func:`run_ranks`), each holding its own slice of the
weights and of the K/V lanes, and the collectives below stand in for the
reference's ``psum`` / ``pmax`` / ``all_to_all``.

The serving path sends ``all_reduce`` (SUM; MAX in the audit and in
``kernels/tda/sharded.py``) and
``all_gather`` (:meth:`Mesh.gather`, the logits' vocabulary blocks and a
gathered input), and the same code runs on ``nccl`` (one card per rank)
and on ``gloo`` (ranks on the CPU, or ranks sharing one card: gloo takes
their CUDA tensors for both collectives, and for ``all_to_all_single``,
and stages them through the host). The backend is the caller's choice,
never swapped: ``nccl`` with more ranks than cards raises. Only the
expert-parallel exchange of ``models/moe.py`` (a ``data`` axis above 1,
which the Engine refuses) sends an ``all_to_all``.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch
import torch.distributed as dist

__all__ = ["AXES", "Mesh", "make_local_mesh", "tensor_parallel_size",
           "rank_device", "run_ranks"]

AXES = ("data", "model")
_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}
# This process's device, as run_ranks assigned it (None: not a rank of it).
_RANK_DEVICE: Dict[str, Optional[torch.device]] = {"device": None}


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """One rank's view of a ``(data, model)`` process grid: ``shape``
    ``{"data": D, "model": M}``, this rank's ``coords`` ``{"data": d,
    "model": m}``, the process ``groups`` of the axes of size above 1 that
    this rank belongs to, and its ``device``. ``stats`` counts the
    all-reduces and all-gathers sent (``calls``), the bytes of their
    results (``bytes``) and the host seconds spent in them (each returns
    when its result is in place)."""

    shape: Dict[str, int]
    coords: Dict[str, int]
    groups: Dict[str, Any]
    device: torch.device
    axis_names: Tuple[str, ...] = AXES
    stats: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {"calls": 0, "bytes": 0, "seconds": 0.0})

    @property
    def size(self) -> int:
        return self.shape["data"] * self.shape["model"]

    def all_reduce(self, t: torch.Tensor, axis: str = "model",
                   op: str = "sum") -> torch.Tensor:
        """``t`` reduced over ``axis`` (``sum`` or ``max``), in place on a
        contiguous ``t``; returned as is on an axis of size 1."""
        if self.shape[axis] == 1:
            return t
        t = t.contiguous()
        t0 = time.perf_counter()
        dist.all_reduce(t, op=_OPS[op], group=self.groups[axis])
        self.stats["seconds"] += time.perf_counter() - t0
        self.stats["calls"] += 1
        self.stats["bytes"] += t.numel() * t.element_size()
        return t

    def gather(self, t: torch.Tensor, dim: int = -1,
               axis: str = "model") -> torch.Tensor:
        """The blocks ``t`` of every rank on ``axis``, concatenated along
        ``dim`` in rank order (one ``all_gather``)."""
        n = self.shape[axis]
        if n == 1:
            return t
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(n)]
        t0 = time.perf_counter()
        dist.all_gather(parts, t, group=self.groups[axis])
        self.stats["seconds"] += time.perf_counter() - t0
        self.stats["calls"] += 1
        self.stats["bytes"] += n * t.numel() * t.element_size()
        return torch.cat(parts, dim)

    def block(self, t: torch.Tensor, dim: int = -1,
              axis: str = "model") -> torch.Tensor:
        """This rank's block of ``t`` along ``dim``, cut in ``shape[axis]``
        equal blocks (``t`` as is on an axis of size 1)."""
        n = self.shape[axis]
        if n == 1:
            return t
        w = t.shape[dim] // n
        return t.narrow(dim, self.coords[axis] * w, w)


def tensor_parallel_size(mesh) -> int:
    """Size of the ``model`` (tensor-parallel) axis: 1 for ``None`` or a
    mesh without one. The one predicate of the sharded serving path; a
    mesh of one rank and no mesh are the same program."""
    if mesh is None or "model" not in mesh.axis_names:
        return 1
    return int(mesh.shape["model"])


def rank_device(rank: int, device: Optional[Union[str, torch.device]]
                = None) -> torch.device:
    """The device of rank ``rank``: ``cuda:(rank % device_count)``, or the
    CPU when ``device`` asks for it (an explicit CUDA index is kept)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu" or dev.index is not None:
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: the ranks run on an NVIDIA GPU "
            "by default; pass device='cpu' explicitly to run them on the "
            "CPU (with backend='gloo')")
    return torch.device("cuda", rank % torch.cuda.device_count())


def _check_backend(backend: str, n: int, device: torch.device) -> None:
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend must be 'gloo' or 'nccl', got {backend!r}")
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError("backend='nccl' runs on CUDA devices only; "
                             "ranks on the CPU take backend='gloo'")
        cards = torch.cuda.device_count()
        if n > cards:
            raise ValueError(
                f"backend='nccl' needs one card per rank: {n} ranks on "
                f"{cards} card(s) (NCCL refuses two ranks on one GPU). "
                "Ranks that share a card pass backend='gloo'.")


def make_local_mesh(data: int = 1, model: int = 1, *,
                    device: Optional[Union[str, torch.device]] = None,
                    backend: Optional[str] = None) -> Mesh:
    """This rank's :class:`Mesh` over a ``(data, model)`` grid of the
    processes of the initialized default group (``data * model`` of them;
    :func:`run_ranks` starts them). Every rank creates every axis group,
    in the same order, as ``torch.distributed.new_group`` requires.
    ``device`` defaults to the one :func:`run_ranks` gave this rank;
    ``backend`` (default: the default group's) is checked as
    :func:`run_ranks` checks it. A grid of one rank needs no process
    group."""
    if data < 1 or model < 1:
        raise ValueError(f"mesh axes must be positive, got ({data}, {model})")
    n = data * model
    shape = {"data": data, "model": model}
    if n == 1:
        rank = dist.get_rank() if dist.is_initialized() else 0
        dev = torch.device(device) if device is not None else (
            _RANK_DEVICE["device"] or rank_device(rank))
        return Mesh(shape, {"data": 0, "model": 0}, {}, dev)
    if not dist.is_initialized() or dist.get_world_size() != n:
        raise RuntimeError(
            f"make_local_mesh({data}, {model}) needs an initialized process "
            f"group of {n} ranks (run_ranks starts one)")
    rank = dist.get_rank()
    dev = torch.device(device) if device is not None else (
        _RANK_DEVICE["device"] or rank_device(rank))
    backend = backend or dist.get_backend()
    if backend != dist.get_backend():
        raise ValueError(f"backend {backend!r} differs from the process "
                         f"group's {dist.get_backend()!r}")
    _check_backend(backend, n, dev)
    d, m = divmod(rank, model)
    groups = {}
    for i in range(data):  # the model axis: one group per data row
        g = dist.new_group([i * model + j for j in range(model)],
                           backend=backend) if model > 1 else None
        if i == d and g is not None:
            groups["model"] = g
    for j in range(model):  # the data axis: one group per model column
        g = dist.new_group([i * model + j for i in range(data)],
                           backend=backend) if data > 1 else None
        if j == m and g is not None:
            groups["data"] = g
    return Mesh(shape, {"data": d, "model": m}, groups, dev)


def _rank_main(rank: int, n: int, fn: Callable, args: tuple, store: str,
               backend: str, device, out: str) -> None:
    dev = rank_device(rank, device)
    _RANK_DEVICE["device"] = dev
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:  # ranks on the CPU share its cores: one thread each
        torch.set_num_threads(1)
    dist.init_process_group(backend, store=dist.FileStore(store, n),
                            rank=rank, world_size=n)
    try:
        result = fn(*args)
        torch.save(result, os.path.join(out, f"rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def run_ranks(n: int, fn: Callable, *args,
              device: Optional[Union[str, torch.device]] = None,
              backend: str = "nccl") -> List[Any]:
    """Run ``fn(*args)`` in ``n`` new processes (``spawn``), each a rank of
    one process group of ``backend`` with a ``FileStore`` rendezvous in a
    temporary directory (no network), and return every rank's result in
    rank order. Rank ``r`` runs on :func:`rank_device` ``(r, device)``;
    ``fn`` builds its mesh with :func:`make_local_mesh`. ``fn`` and
    ``args`` are pickled (``fn`` by import path), and so is the result.
    A rank on the CPU runs one thread (``torch.set_num_threads(1)``):
    the ranks, and whatever else runs there, share the host's cores.
    Raises if a rank fails; returns after every rank has exited."""
    import torch.multiprocessing as mp
    if n < 1:
        raise ValueError(f"run_ranks needs at least one rank, got {n}")
    _check_backend(backend, n, rank_device(0, device))
    with tempfile.TemporaryDirectory(prefix="repro_ranks_") as tmp:
        store = str(Path(tmp) / "store")
        mp.spawn(_rank_main, args=(n, fn, args, store, backend, device, tmp),
                 nprocs=n, join=True)
        return [torch.load(Path(tmp) / f"rank{r}.pt", weights_only=False)
                for r in range(n)]
