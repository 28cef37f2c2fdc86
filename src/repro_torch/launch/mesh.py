"""The process mesh over ``torch.distributed`` (``repro.launch.mesh``).

A :class:`Mesh` is one rank's view of a ``("data", "model")`` grid of
processes, or ``("pod", "data", "model")`` with a leading pod axis: the
grid's shape, this rank's coordinates on it, the process group of each
axis it belongs to, and its device. Ranks sit in the row-major order of
the reference's device grid (rank ``r`` of a ``(D, M)`` grid at
``divmod(r, M)``). The reference runs one controller over every device;
the port runs one process per rank (:func:`run_ranks`), each holding its
own slice of the weights (and of the K/V lanes, or of the optimizer
state), and the collectives below stand in for the reference's ``psum``
/ ``pmax`` / ``all_gather`` / ``all_to_all`` and for the ones GSPMD
inserts into its sharded train step.

The same code runs on ``nccl`` (one card per rank) and on ``gloo`` (ranks
on the CPU, or ranks sharing one card: gloo takes their CUDA tensors for
``all_reduce``, ``all_gather``, ``reduce_scatter`` and
``all_to_all_single``, and stages them through the host). The backend is
the caller's choice, never swapped: ``nccl`` with more ranks than cards
raises.

**Collectives under autograd** (the train step differentiates through
them). ``torch.distributed``'s own ops have no gradient, and
``torch.distributed.nn``'s ``all_reduce`` all-reduces the gradient as
well, which gives N times the gradient when every rank of an axis holds
the same loss. So each collective of the training forward is one of the
functions below, whose backward is its forward's adjoint:

* :func:`copy_to` (Megatron's ``f``): identity forward, all-reduce (SUM)
  backward; where a replicated activation enters a computation of which
  each rank holds a part (a column-parallel linear, a vocabulary block);
* :func:`reduce_from` (Megatron's ``g``): all-reduce (SUM) forward,
  identity backward; the partial sums of a row-parallel linear, the loss
  over ``data``;
* :func:`gather_from`: all-gather forward, this rank's block backward;
* :func:`scatter_to`: this rank's block forward, all-gather backward (a
  replicated tensor of which each rank goes on with its block);
* :func:`fsdp_gather`: all-gather forward, reduce-scatter (SUM) backward
  (a weight cut over ``data``, gathered for use: its gradient is summed
  over the ranks that used it and cut again);
* :func:`all_to_all`: the tiled exchange forward and backward (it is its
  own adjoint).

Without autograd (serving, or a tensor that needs no gradient) each is
the plain collective; on an axis of size 1 each returns its input.
"""
from __future__ import annotations

import dataclasses
import math
import os
import tempfile
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch
import torch.distributed as dist

__all__ = ["AXES", "Mesh", "MeshShape", "make_local_mesh",
           "make_production_mesh", "production_mesh_shape",
           "devices_per_pod", "tensor_parallel_size", "rank_device",
           "run_ranks", "copy_to", "reduce_from", "gather_from",
           "scatter_to", "fsdp_gather", "all_to_all"]

AXES = ("data", "model")
POD_AXES = ("pod", "data", "model")
_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}
# This process's device, as run_ranks assigned it (None: not a rank of it).
_RANK_DEVICE: Dict[str, Optional[torch.device]] = {"device": None}


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's ``shape`` (``{axis: size}``) and ``axis_names`` without
    processes: what the placement rules read (``launch/sharding.py``, and
    the reference's rule functions, which read only these two
    attributes)."""

    shape: Dict[str, int]
    axis_names: Tuple[str, ...]

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """One rank's view of a ``(data, model)`` or ``(pod, data, model)``
    process grid: ``shape`` ``{axis: size}``, this rank's ``coords``
    ``{axis: index}``, the process ``groups`` of the axes of size above 1
    that this rank belongs to, and its ``device``. ``stats`` counts the
    collectives sent (``calls``), the bytes of their results (``bytes``)
    and the host seconds spent in them (each returns when its result is
    in place). An axis the mesh lacks (``pod`` of a 2-D mesh) has size 1."""

    shape: Dict[str, int]
    coords: Dict[str, int]
    groups: Dict[str, Any]
    device: torch.device
    axis_names: Tuple[str, ...] = AXES
    stats: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {"calls": 0, "bytes": 0, "seconds": 0.0})

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def n(self, axis: str) -> int:
        """Size of ``axis`` (1 for an axis the mesh lacks)."""
        return self.shape.get(axis, 1)

    def coord(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def _timed(self, fn, nbytes: int) -> None:
        t0 = time.perf_counter()
        fn()
        self.stats["seconds"] += time.perf_counter() - t0
        self.stats["calls"] += 1
        self.stats["bytes"] += nbytes

    def all_reduce(self, t: torch.Tensor, axis: str = "model",
                   op: str = "sum") -> torch.Tensor:
        """``t`` reduced over ``axis`` (``sum`` or ``max``), in place on a
        contiguous ``t``; returned as is on an axis of size 1."""
        if self.n(axis) == 1:
            return t
        t = t.contiguous()
        self._timed(lambda: dist.all_reduce(t, op=_OPS[op],
                                            group=self.groups[axis]),
                    t.numel() * t.element_size())
        return t

    def gather(self, t: torch.Tensor, dim: int = -1,
               axis: str = "model") -> torch.Tensor:
        """The blocks ``t`` of every rank on ``axis``, concatenated along
        ``dim`` in rank order (one ``all_gather``)."""
        n = self.n(axis)
        if n == 1:
            return t
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(n)]
        self._timed(lambda: dist.all_gather(parts, t,
                                            group=self.groups[axis]),
                    n * t.numel() * t.element_size())
        return torch.cat(parts, dim)

    def reduce_scatter(self, t: torch.Tensor, dim: int = -1,
                       axis: str = "data") -> torch.Tensor:
        """The sum of ``t`` over ``axis``, of which this rank keeps its
        block along ``dim`` (one ``reduce_scatter`` of the blocks)."""
        n = self.n(axis)
        if n == 1:
            return t
        dim = dim % t.dim()
        src = t.movedim(dim, 0).contiguous()
        out = torch.empty((src.shape[0] // n,) + src.shape[1:],
                          dtype=t.dtype, device=t.device)
        self._timed(lambda: dist.reduce_scatter(
            out, list(src.chunk(n)), group=self.groups[axis]),
            out.numel() * out.element_size())
        return out.movedim(0, dim).contiguous()

    def exchange(self, t: torch.Tensor, axis: str = "data") -> torch.Tensor:
        """Tiled ``all_to_all`` over ``axis``: block ``j`` of ``t``'s
        leading dim goes to rank ``j``; the result holds the blocks
        received, in source order."""
        if self.n(axis) == 1:
            return t
        t = t.contiguous()
        out = torch.empty_like(t)
        self._timed(lambda: dist.all_to_all_single(
            out, t, group=self.groups[axis]), t.numel() * t.element_size())
        return out

    def block(self, t: torch.Tensor, dim: int = -1,
              axis: str = "model") -> torch.Tensor:
        """This rank's block of ``t`` along ``dim``, cut in ``shape[axis]``
        equal blocks (``t`` as is on an axis of size 1)."""
        n = self.n(axis)
        if n == 1:
            return t
        w = t.shape[dim] // n
        return t.narrow(dim, self.coord(axis) * w, w)


# ---- collectives under autograd ------------------------------------------


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g.clone(), ctx.axis), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return mesh.all_reduce(x.clone(), axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim, axis):
        ctx.mesh, ctx.dim, ctx.axis = mesh, dim, axis
        return mesh.gather(x, dim, axis)

    @staticmethod
    def backward(ctx, g):
        return (ctx.mesh.block(g, ctx.dim, ctx.axis).contiguous(), None,
                None, None)


class _ScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim, axis):
        ctx.mesh, ctx.dim, ctx.axis = mesh, dim, axis
        return mesh.block(x, dim, axis).clone()

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.gather(g, ctx.dim, ctx.axis), None, None, None


class _FSDPGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim, axis):
        ctx.mesh, ctx.dim, ctx.axis = mesh, dim, axis
        return mesh.gather(x, dim, axis)

    @staticmethod
    def backward(ctx, g):
        return (ctx.mesh.reduce_scatter(g, ctx.dim, ctx.axis), None, None,
                None)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return mesh.exchange(x, axis)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.exchange(g, ctx.axis), None, None


def _differentiable(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def copy_to(x: torch.Tensor, mesh, axis: str = "model") -> torch.Tensor:
    """Megatron's ``f`` over ``axis``: ``x`` forward, the all-reduced
    gradient backward."""
    if mesh is None or mesh.n(axis) == 1 or not _differentiable(x):
        return x
    return _CopyTo.apply(x, mesh, axis)


def reduce_from(x: torch.Tensor, mesh, axis: str = "model") -> torch.Tensor:
    """Megatron's ``g`` over ``axis``: the all-reduced (SUM) ``x`` forward,
    the gradient as is backward. Without autograd ``x`` is reduced in
    place, as :meth:`Mesh.all_reduce` does."""
    if mesh is None or mesh.n(axis) == 1:
        return x
    if not _differentiable(x):
        return mesh.all_reduce(x, axis)
    return _ReduceFrom.apply(x, mesh, axis)


def gather_from(x: torch.Tensor, mesh, dim: int = -1,
                axis: str = "model") -> torch.Tensor:
    """All-gather along ``dim`` forward, this rank's block backward."""
    if mesh is None or mesh.n(axis) == 1:
        return x
    if not _differentiable(x):
        return mesh.gather(x, dim, axis)
    return _GatherFrom.apply(x, mesh, dim, axis)


def scatter_to(x: torch.Tensor, mesh, dim: int = -1,
               axis: str = "model") -> torch.Tensor:
    """This rank's block along ``dim`` forward, the all-gathered gradient
    backward (``x`` replicated over ``axis``)."""
    if mesh is None or mesh.n(axis) == 1:
        return x
    if not _differentiable(x):
        return mesh.block(x, dim, axis)
    return _ScatterTo.apply(x, mesh, dim, axis)


def fsdp_gather(x: torch.Tensor, mesh, dim: int,
                axis: str = "data") -> torch.Tensor:
    """All-gather along ``dim`` forward, reduce-scatter (SUM) backward."""
    if mesh is None or mesh.n(axis) == 1:
        return x
    if not _differentiable(x):
        return mesh.gather(x, dim, axis)
    return _FSDPGather.apply(x, mesh, dim, axis)


def all_to_all(x: torch.Tensor, mesh, axis: str = "data") -> torch.Tensor:
    """Tiled ``all_to_all`` over ``axis`` forward and backward."""
    if mesh is None or mesh.n(axis) == 1:
        return x
    if not _differentiable(x):
        return mesh.exchange(x, axis)
    return _AllToAll.apply(x, mesh, axis)


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


def make_local_mesh(data: int = 1, model: int = 1, *, pod: int = 1,
                    device: Optional[Union[str, torch.device]] = None,
                    backend: Optional[str] = None) -> Mesh:
    """This rank's :class:`Mesh` over a ``(data, model)`` grid (with
    ``pod`` above 1: a ``(pod, data, model)`` grid) of the processes of the
    initialized default group (``pod * data * model`` of them;
    :func:`run_ranks` starts them). Every rank creates every axis group,
    in the same order, as ``torch.distributed.new_group`` requires, so a
    world may build several meshes of its size one after the other.
    ``device`` defaults to the one :func:`run_ranks` gave this rank;
    ``backend`` (default: the default group's) is checked as
    :func:`run_ranks` checks it. A grid of one rank needs no process
    group."""
    if data < 1 or model < 1 or pod < 1:
        raise ValueError(
            f"mesh axes must be positive, got ({pod}, {data}, {model})")
    names = POD_AXES if pod > 1 else AXES
    sizes = (pod, data, model) if pod > 1 else (data, model)
    shape = dict(zip(names, sizes))
    n = math.prod(sizes)
    rank = dist.get_rank() if dist.is_initialized() else 0
    dev = torch.device(device) if device is not None else (
        _RANK_DEVICE["device"] or rank_device(rank))
    if n == 1:
        return Mesh(shape, {a: 0 for a in names}, {}, dev, names)
    if not dist.is_initialized() or dist.get_world_size() != n:
        have = dist.get_world_size() if dist.is_initialized() else 1
        raise RuntimeError(
            f"a {tuple(sizes)} mesh {names} needs an initialized process "
            f"group of {n} ranks (run_ranks starts one); this run has "
            f"{have}")
    backend = backend or dist.get_backend()
    if backend != dist.get_backend():
        raise ValueError(f"backend {backend!r} differs from the process "
                         f"group's {dist.get_backend()!r}")
    _check_backend(backend, n, dev)
    coords, rest = {}, rank
    for a, size in reversed(list(zip(names, sizes))):
        rest, coords[a] = divmod(rest, size)
    strides = {a: math.prod(sizes[i + 1:]) for i, a in enumerate(names)}
    groups = {}
    for a, size in zip(names, sizes):
        if size == 1:
            continue
        others = [b for b in names if b != a]
        # One group per setting of the other axes, in row-major order.
        for idx in range(n // size):
            fixed, rest = {}, idx
            for b in reversed(others):
                rest, fixed[b] = divmod(rest, shape[b])
            base = sum(fixed[b] * strides[b] for b in others)
            g = dist.new_group([base + i * strides[a] for i in range(size)],
                               backend=backend)
            if all(fixed[b] == coords[b] for b in others):
                groups[a] = g
    return Mesh(shape, {a: coords[a] for a in names}, groups, dev, names)


def production_mesh_shape(multi_pod: bool = False) -> MeshShape:
    """The reference's production mesh without its devices: ``(16, 16)``
    ``("data", "model")``, or ``(2, 16, 16)`` ``("pod", "data", "model")``
    with ``multi_pod``."""
    if multi_pod:
        return MeshShape({"pod": 2, "data": 16, "model": 16}, POD_AXES)
    return MeshShape({"data": 16, "model": 16}, AXES)


def make_production_mesh(*, multi_pod: bool = False,
                         device: Optional[Union[str, torch.device]] = None,
                         backend: Optional[str] = None) -> Mesh:
    """This rank's mesh of the reference's production shape
    (:func:`production_mesh_shape`): needs a run of 256 ranks (512 with
    ``multi_pod``), and raises naming that count on any other run, as the
    reference's ``jax.make_mesh`` fails on a host with fewer devices."""
    ms = production_mesh_shape(multi_pod)
    have = dist.get_world_size() if dist.is_initialized() else 1
    if have != ms.size:
        raise RuntimeError(
            f"the production mesh {tuple(ms.shape.values())} "
            f"{ms.axis_names} needs {ms.size} ranks; this run has {have}")
    return make_local_mesh(ms.shape["data"], ms.shape["model"],
                           pod=ms.shape.get("pod", 1), device=device,
                           backend=backend)


def devices_per_pod(mesh) -> int:
    """Ranks in one pod (0 when the mesh has no pod axis)."""
    if "pod" not in mesh.axis_names:
        return 0
    return math.prod(mesh.shape.values()) // mesh.shape["pod"]


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
