"""The dry run on placeholder ranks (``repro.launch.dryrun``): one rank's
step of every (arch x shape x mesh) cell on the production mesh, counted
on fake tensors, and its roofline terms at H100 rates.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-32b \\
      --shape train_4k --mesh single            # one cell
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-32b \\
      --mesh single                             # every shape of the arch
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh both]
  ... --factorized    # the paper's factorization on
  ... --opt           # flash_block_dtype bf16, attn_chunk 1024
  ... --summary       # print the table of the records in --out

Each cell runs in a process of its own. It starts a process group of the
``fake`` backend (``torch.testing._internal.distributed.fake_pg``: every
collective returns at once) of 256 ranks (512 with ``--mesh multi``),
builds rank 0's mesh of the reference's production shape (``(16, 16)``
``(data, model)``, or ``(2, 16, 16)`` with ``pod``), and runs rank 0's step
of ``launch/steps.py::build_bundle`` on the CPU under ``FakeTensorMode``:
shapes, dtypes and every op of the plain PyTorch path, no storage. The
custom CUDA kernels are reached through ctypes and no counter could see
them, so the dry run takes the plain paths (fake tensors on the CPU), and
the train step runs with ``guard=None`` (a guard reads the loss on the
host). A cell writes ``<out>/<arch>__<shape>__<mesh>[__fact][__opt].json``,
or ``.FAILED`` with the traceback when its step raises (the reference's
refusals: decode on a ``model`` axis that does not divide the head
counts), and then ``main`` exits 1. Existing records are kept unless
``--force``.

What a record counts, per chip (rank 0; every rank of these meshes runs
the same shapes):

* ``counts.flops_per_chip``: ``torch.utils.flop_counter.FlopCounterMode``,
  which counts the matmul, bmm, convolution and attention families; the
  elementwise work (norms, softmax, the optimizer's update) is not
  counted, where XLA's cost analysis counts it;
* ``counts.bytes_per_chip``: a ``TorchDispatchMode`` that adds every aten
  op's input and output bytes (views and allocations move none;
  collectives are counted apart): an upper bound on HBM traffic, as if no
  op were fused. ``bytes_by_op`` lists the 25 largest ops;
* ``memory``: the argument bytes (state, caches and batch of the rank's
  shapes) and the peak of ``torch.distributed._tools.mem_tracker.
  MemTracker`` over the step, arguments included (beside
  ``launch/sharded_train.py::predict_rank_bytes`` on AdamW train cells);
* ``collectives``: the result bytes by axis and kind (``Mesh.stats``), each
  axis's link bytes under the reference's ring model
  (:func:`collective_link_bytes`, a copy of
  ``repro.launch.hlo_analysis._collective_link_bytes``), split into
  in-pod traffic and the ``pod`` axis's, which alone crosses pods. A
  decode step moves the position-cut caches to the rank's kv heads by one
  ``all_to_all`` over ``model`` a leaf and a layer, the move that the
  reference's compiled program makes at its ``shard_map`` boundary; it
  is counted under ``model`` / ``all_to_all``.

The roofline divides these by the data-sheet rates of one NVIDIA H100 SXM
(:data:`RATES`): ``t_compute_s`` (FLOPs over dense bf16 peak),
``t_memory_s`` (bytes over HBM), ``t_collective_s`` (each axis's link
bytes over NVLink when its ranks share an 8-GPU node, else over the
node's network port), and their largest is ``step_time_bound_s`` (the
reference's key). ``t_memory_s`` comes from the unfused byte count, an
upper estimate of HBM traffic, so ``step_time_bound_s`` is an estimate,
neither a lower bound on the step nor comparable to the reference's
(XLA counts fused bytes); ``lower_bound_s`` is the compute term alone, the
least time the counted FLOPs take at peak. These are rates from the data
sheets, not measurements.

``repro.launch.hlo_analysis`` has no port: the port has no HLO to parse;
the dispatch-level counters above take its place; which bytes a fusion
would keep on chip cannot be seen at that level (so ``bytes_per_chip`` is
unfused); and the while-loop trip counts it recovers are moot, since the
port's loops (layers, attention chunks) are Python and every iteration
dispatches its ops. ``--opt``'s ``unroll_decode`` and ``constrain_acts``
are XLA-only knobs, which the port ignores (the record lists them).
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
import traceback
from collections import Counter
from pathlib import Path
from typing import Any, Callable, Dict, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import SHAPES, get_config, list_archs, shapes_for
from repro_torch.launch.mesh import traffic

# One NVIDIA H100 SXM5 80 GB, from the data sheets (not measured here).
RATES = {
    "card": "NVIDIA H100 SXM5 80 GB",
    "peak_flops": 989e12,       # dense bf16 tensor-core FLOP/s
    "hbm_bytes_s": 3.35e12,     # HBM3
    "nvlink_bytes_s": 450e9,    # NVLink 4, per direction per GPU, 8-GPU node
    "network_bytes_s": 50e9,    # one 400 Gb/s NDR port per GPU: nodes, pods
    "gpus_per_node": 8,
    "source": ("NVIDIA H100 Tensor Core GPU data sheet (SXM5: 989 TFLOP/s "
               "dense bf16, 3.35 TB/s HBM3, 900 GB/s NVLink = 450 GB/s a "
               "direction); NVIDIA DGX H100: 8 GPUs a node, one 400 Gb/s "
               "ConnectX-7 (NDR InfiniBand) port a GPU"),
}
XLA_ONLY_KNOBS = ("unroll_decode", "constrain_acts")
OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / \
    "dryrun_torch"
FLOPS_NOTE = ("FlopCounterMode: matmul, bmm, convolution and attention "
              "families; elementwise work is not counted (XLA's count "
              "includes it)")
BYTES_NOTE = ("every aten op's input and output bytes (views and "
              "allocations none, collectives apart): unfused, an upper "
              "bound on HBM traffic")
ROOFLINE_NOTE = ("t_memory_s is an unfused upper estimate (every aten "
                 "op's bytes), so step_time_bound_s, the largest term, is "
                 "an estimate, not a lower bound; lower_bound_s is "
                 "t_compute_s alone")
DECODE_NOTE = ("decode moves the position-cut caches to the rank's kv "
               "heads by one all_to_all over 'model' a leaf and a layer "
               "(the reference's shard_map boundary), counted under "
               "model/all_to_all")


def model_flops(cfg, shape_name: str) -> float:
    """6 N D (train; N_active for MoE) or 2 N D (prefill, decode: one
    token a row) over the cell's tokens (the reference's)."""
    info = SHAPES[shape_name]
    tokens = info["batch"] * (1 if info["step"] == "decode" else info["seq"])
    mult = 6.0 if info["step"] == "train" else 2.0
    return mult * cfg.n_active_params() * tokens


def collective_link_bytes(kind: str, op_bytes: float, res_bytes: float,
                          group_size: int) -> float:
    """Per-chip link traffic of one collective under a ring model
    (``repro.launch.hlo_analysis._collective_link_bytes``)."""
    g = max(group_size, 1)
    if g == 1:
        return 0.0
    frac = (g - 1) / g
    if kind == "all_reduce":
        return 2.0 * op_bytes * frac
    if kind == "all_gather":
        return res_bytes * frac
    return op_bytes * frac  # reduce_scatter, all_to_all


def _op_bytes(kind: str, res: float, g: int) -> float:
    """A collective's operand bytes from its result's (``Mesh.stats``)."""
    return {"all_gather": res / g, "reduce_scatter": res * g}.get(kind, res)


def _axis_in_node(shape: Dict[str, int], axis: str) -> bool:
    """Whether one group of ``axis`` (ranks in row-major order) lies in
    one node of ``RATES["gpus_per_node"]`` GPUs."""
    names = list(shape)
    stride = math.prod(shape[a] for a in names[names.index(axis) + 1:])
    span = stride * shape[axis]
    return span <= RATES["gpus_per_node"] \
        and RATES["gpus_per_node"] % span == 0


def collective_terms(stats: Dict[str, float],
                     shape: Dict[str, int]) -> Dict[str, Any]:
    """Link bytes and seconds per axis from :attr:`Mesh.stats`."""
    by_axis = traffic(stats)
    link, secs = {}, {}
    for axis, kinds in by_axis.items():
        g = shape.get(axis, 1)
        link[axis] = sum(collective_link_bytes(k, _op_bytes(k, b, g), b, g)
                         for k, b in kinds.items())
        rate = RATES["nvlink_bytes_s"] if axis != "pod" and \
            _axis_in_node(shape, axis) else RATES["network_bytes_s"]
        secs[axis] = link[axis] / rate
    return {"by_axis": by_axis, "calls": int(stats.get("calls", 0)),
            "link_bytes": link, "link_seconds": secs,
            "in_pod_bytes_per_chip": sum(v for a, v in link.items()
                                         if a != "pod"),
            "pod_bytes_per_chip": link.get("pod", 0.0),
            "t_collective_s": sum(secs.values())}


class ByteCounter(TorchDispatchMode):
    """Adds every aten op's input and output tensor bytes (``total``, and
    by op in ``by_op``); views, allocations and collectives move none."""

    _SKIP = {"empty", "empty_strided", "new_empty", "new_empty_strided",
             "empty_like", "detach", "lift_fresh", "_unsafe_view",
             "_reshape_alias"}

    def __init__(self):
        super().__init__()
        self.total = 0
        self.by_op: Counter = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        if func.is_view or func.namespace != "aten" or name in self._SKIP:
            return out
        n = 0
        for t in _tensors((args, kwargs or {}, out)):
            n += t.numel() * t.element_size()
        self.total += n
        self.by_op[name] += n
        return out


def _tensors(obj):
    if torch.is_tensor(obj):
        yield obj
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            yield from _tensors(o)
    elif isinstance(obj, dict):
        for o in obj.values():
            yield from _tensors(o)


def tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def count_step(fn: Callable, args: Sequence[Any]) -> Dict[str, Any]:
    """Run ``fn(*args)`` (fake tensors, in their fake mode) under the
    FLOP counter, the byte counter and ``MemTracker``: per-call
    ``flops``, ``bytes``, ``bytes_by_op`` (the 25 largest), the argument
    bytes, the peak bytes (arguments included) and the seconds taken."""
    from torch.distributed._tools.mem_tracker import MemTracker
    mt = MemTracker()
    mt.track_external(*[t for t in _tensors(args)])
    flops = FlopCounterMode(display=False)
    nbytes = ByteCounter()
    t0 = time.perf_counter()
    with mt, flops, nbytes:
        out = fn(*args)
    del out
    seconds = time.perf_counter() - t0
    peak = sum(v["Total"] for v in mt.get_tracker_snapshot("peak").values())
    return {"flops": float(flops.get_total_flops()),
            "bytes": float(nbytes.total),
            "bytes_by_op": dict(nbytes.by_op.most_common(25)),
            "argument_bytes": tree_bytes(args), "peak_bytes": int(peak),
            "seconds": seconds}


def roofline(flops: float, nbytes: float, t_coll: float) -> Dict[str, Any]:
    t_compute = flops / RATES["peak_flops"]
    t_memory = nbytes / RATES["hbm_bytes_s"]
    terms = {"compute": t_compute, "memory": t_memory,
             "collective": t_coll}
    return {"t_compute_s": t_compute, "t_memory_s": t_memory,
            "t_collective_s": t_coll,
            "dominant": max(terms, key=terms.get),
            "step_time_bound_s": max(terms.values()),
            "lower_bound_s": t_compute, "note": ROOFLINE_NOTE}


def placeholder_group(n: int) -> None:
    """Start a ``fake`` process group of ``n`` ranks, this one rank 0 (once
    a process)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=n)


def placeholder_mesh(shape: Dict[str, int]):
    """Rank 0's mesh of ``shape`` (``{axis: size}``, row-major) over a
    ``fake`` process group of that many ranks."""
    from repro_torch.launch.mesh import make_local_mesh
    placeholder_group(math.prod(shape.values()))
    return make_local_mesh(shape.get("data", 1), shape.get("model", 1),
                           pod=shape.get("pod", 1), device="cpu",
                           backend="fake", placeholder=True)


def cell_config(arch: str, shape_name: str, factorized: bool = False,
                opt: bool = False, variant: str = "full"):
    """The cell's config: bf16 weights for inference steps (as the
    reference's dry run), ``--opt``'s knobs that the port reads."""
    overrides = {}
    if SHAPES[shape_name]["step"] != "train":
        overrides["param_dtype"] = "bfloat16"
    if opt:
        overrides.update(flash_block_dtype="bfloat16", attn_chunk=1024)
    return get_config(arch, variant, factorized=factorized, **overrides)


def measure(cfg, shape, mesh, opt_cfg=None) -> Dict[str, Any]:
    """One rank's counts of the cell's bundle (``launch/steps.py``) on
    ``mesh`` (``None``: one device), under a new ``FakeTensorMode``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch.steps import build_bundle, rank_args
    with FakeTensorMode():
        bundle = build_bundle(cfg, shape, mesh, opt_cfg=opt_cfg)
        args = rank_args(bundle, mesh)
        out = count_step(bundle.fn, args)
        out["predicted_rank_bytes"] = None
        if mesh is not None and bundle.name.startswith("train:") \
                and (opt_cfg is None or opt_cfg.name == "adamw"):
            from repro_torch.launch.sharded_train import predict_rank_bytes
            from repro_torch.models.transformer import Model
            state, batch = args
            rows, seq = next(iter(batch.values())).shape[:2]
            out["predicted_rank_bytes"] = predict_rank_bytes(
                Model(cfg, "cpu"), state["params"],
                bundle.in_shardings[0]["params"], mesh, rows, seq)
    out["bundle"] = bundle.name
    out["donate_argnums"] = list(bundle.donate_argnums)
    return out


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             factorized: bool = False, verbose: bool = True,
             opt: bool = False) -> Dict[str, Any]:
    """The record of one cell (module docstring). Starts the fake process
    group of the production mesh's size in this process: one cell a
    process (:func:`main` spawns them)."""
    from repro_torch.launch.mesh import (make_production_mesh,
                                         production_mesh_shape)
    t0 = time.perf_counter()
    multi = mesh_kind == "multi"
    shape = dict(production_mesh_shape(multi).shape)
    placeholder_group(math.prod(shape.values()))
    mesh = make_production_mesh(multi_pod=multi, device="cpu",
                                backend="fake", placeholder=True)
    cfg = cell_config(arch, shape_name, factorized, opt)
    c = measure(cfg, shape_name, mesh)
    coll = collective_terms(mesh.stats, shape)
    n_chips = mesh.size
    rl = roofline(c["flops"], c["bytes"], coll["t_collective_s"])
    mflops = model_flops(cfg, shape_name)
    rec = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "mesh_shape": shape, "factorized": factorized, "opt": opt,
        "step": SHAPES[shape_name]["step"], "n_chips": n_chips,
        "analyzer": "torch dispatch", "bundle": c["bundle"],
        "donate_argnums": c["donate_argnums"],
        "seconds": round(time.perf_counter() - t0, 1),
        "step_seconds": round(c["seconds"], 1),
        "rates": RATES,
        "memory": {
            "argument_bytes": c["argument_bytes"],
            "peak_bytes": c["peak_bytes"],
            "peak_per_chip_gb": round(c["peak_bytes"] / 2**30, 3),
            "predicted_rank_bytes": c["predicted_rank_bytes"],
        },
        "counts": {"flops_per_chip": c["flops"], "flops_note": FLOPS_NOTE,
                   "bytes_per_chip": c["bytes"], "bytes_note": BYTES_NOTE,
                   "bytes_by_op": c["bytes_by_op"]},
        "collectives": coll,
        "roofline": rl,
        "model_flops_6nd": mflops,
        "useful_flops_ratio": (mflops / (c["flops"] * n_chips)
                               if c["flops"] else 0.0),
        "roofline_fraction": ((mflops / n_chips / RATES["peak_flops"])
                              / rl["step_time_bound_s"]
                              if rl["step_time_bound_s"] > 0 else 0.0),
    }
    if rec["step"] == "decode":
        rec["collectives"]["note"] = DECODE_NOTE
    if opt:
        rec["ignored_knobs"] = {k: "XLA-only; the port ignores it"
                                for k in XLA_ONLY_KNOBS}
    if verbose:
        print(json.dumps({k: rec[k] for k in ("bundle", "roofline")}),
              flush=True)
    return rec


def cell_path(arch, shape, mesh_kind, factorized, opt=False,
              out: Path = OUT_DIR) -> Path:
    tag = f"{arch}__{shape}__{mesh_kind}" + ("__fact" if factorized else "") \
        + ("__opt" if opt else "")
    return Path(out) / f"{tag}.json"


def _fmt(x, p=3):
    if x == 0:
        return "0"
    if x < 1e-4 or x >= 1e4:
        return f"{x:.2e}"
    return f"{x:.{p}g}"


def load(out: Path, mesh_kind: str, fact: bool = False,
         opt: bool = False) -> Dict:
    recs = {}
    for p in sorted(Path(out).glob(f"*__{mesh_kind}*.json")):
        r = json.loads(p.read_text())
        if bool(r.get("factorized")) == fact and bool(r.get("opt")) == opt:
            recs[(r["arch"], r["shape"])] = r
    return recs


def table(out: Path, mesh_kind: str) -> str:
    """The records' table (``experiments/summarize.py``'s columns; the
    pod-crossing MiB in place of DCI MiB, and each cell's seconds)."""
    rows = []
    for (arch, shape), r in sorted(load(out, mesh_kind).items()):
        rl = r["roofline"]
        rows.append((
            arch, shape, r["step"], _fmt(rl["t_compute_s"]),
            _fmt(rl["t_memory_s"]), _fmt(rl["t_collective_s"]),
            rl["dominant"], _fmt(r["memory"]["peak_per_chip_gb"]),
            _fmt(r["model_flops_6nd"]), _fmt(r["useful_flops_ratio"], 2),
            _fmt(r["roofline_fraction"], 2),
            _fmt(r["collectives"]["pod_bytes_per_chip"] / 2**20)
            if mesh_kind == "multi" else "-", r["seconds"]))
    hdr = ("| arch | shape | step | t_comp(s) | t_mem(s) | t_coll(s) | "
           "dominant | GB/chip | 6ND | useful | roofline_frac | pod MiB | "
           "s |")
    failed = sorted(p.stem for p in Path(out).glob(f"*__{mesh_kind}*.FAILED"))
    lines = [hdr, "|" + "---|" * 13] + ["| " + " | ".join(map(str, r))
                                         + " |" for r in rows]
    if failed:
        lines.append("refused: " + ", ".join(failed))
    return "\n".join(lines)


def _child(args) -> int:
    path = cell_path(args.arch, args.shape, args.mesh, args.factorized,
                     args.opt, args.out)
    try:
        rec = run_cell(args.arch, args.shape, args.mesh, args.factorized,
                       opt=args.opt)
    except Exception:
        err = traceback.format_exc()
        print(f"  FAIL {args.arch} {args.shape} {args.mesh}:\n{err[-2000:]}",
              flush=True)
        path.with_suffix(".FAILED").write_text(err)
        return 1
    path.write_text(json.dumps(rec, indent=1))
    r = rec["roofline"]
    print(f"  ok: dominant={r['dominant']} compute={r['t_compute_s']:.3e}s "
          f"memory={r['t_memory_s']:.3e}s coll={r['t_collective_s']:.3e}s "
          f"mem/chip={rec['memory']['peak_per_chip_gb']}GB "
          f"roofline_frac={rec['roofline_fraction']:.3f} "
          f"({rec['seconds']} s)", flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--factorized", action="store_true")
    ap.add_argument("--opt", action="store_true",
                    help="flash_block_dtype bf16, attn_chunk 1024")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", type=Path, default=OUT_DIR)
    ap.add_argument("--summary", action="store_true",
                    help="print the table of the records in --out")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        return _child(args)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.summary:
        for mk in meshes:
            print(table(args.out, mk))
        return 0
    if args.all:
        cells = [(a, s, mk) for a in list_archs() for s in shapes_for(a)
                 for mk in meshes]
    elif args.arch:
        shapes = [args.shape] if args.shape else shapes_for(args.arch)
        cells = [(args.arch, s, mk) for s in shapes for mk in meshes]
    else:
        ap.error("--arch (and --shape) required, or --all")
    args.out.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ)
    src = str(Path(__file__).resolve().parents[2])
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    failures = 0
    for arch, shape, mk in cells:
        path = cell_path(arch, shape, mk, args.factorized, args.opt,
                         args.out)
        if path.exists() and not args.force:
            print(f"[skip] {path.name}")
            continue
        path.with_suffix(".FAILED").unlink(missing_ok=True)
        print(f"[run ] {arch} x {shape} x {mk}"
              + (" (factorized)" if args.factorized else "")
              + (" (opt)" if args.opt else ""), flush=True)
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--child",
               "--arch", arch, "--shape", shape, "--mesh", mk,
               "--out", str(args.out)]
        cmd += ["--factorized"] * args.factorized + ["--opt"] * args.opt
        if subprocess.run(cmd, env=env).returncode:
            failures += 1
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
