"""Build the hand-written CUDA kernels at first use and bind them with ctypes.

Each source under ``kernels/csrc/`` is one ``.cu`` file with a plain C
interface (the two decode kernels share ``tda_decode_body.cuh``; it, the
mixed kernel and the AFU share ``lut_exp.cuh``).
``build_all`` compiles every source that has no up-to-date library yet, one
``nvcc`` process per source, all started together, into ``build/kernels/``
at the root of the checkout (listed in ``.gitignore``). A library's file
name carries a hash of its source, the shared headers and the flags, so an
edited source is rebuilt and a stale library is never loaded. Every C entry
point returns ``cudaGetLastError()`` after its launch.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List

__all__ = ["SOURCES", "build_all", "load", "build_dir"]

_CSRC = Path(__file__).resolve().parent / "csrc"
# library name -> source file under csrc/
SOURCES = {"tda_decode": "tda_decode.cu",
           "tda_paged_decode": "tda_paged_decode.cu",
           "tda_mixed": "tda_mixed.cu",
           "dmm": "dmm.cu",
           "smm": "smm.cu",
           "afu": "afu.cu"}
_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points of each library: (pointers..., int shape args..., dtype
# code, [quant flag,] [all-columns flag,] [scale,] stream); every one
# returns an int.
_ARGTYPES = {
    "tda_decode": {"tda_decode": [_P] * 10 + [_I] * 7 + [_I, _I, _F, _P]},
    "tda_paged_decode": {
        "tda_paged_decode": [_P] * 11 + [_I] * 8 + [_I, _I, _F, _P]},
    "tda_mixed": {"tda_mixed": [_P] * 11 + [_I] * 10 + [_I, _I, _I, _F, _P]},
    "dmm": {"dmm": [_P] * 6 + [_I] * 4 + [_I, _P],
            "dmm_splits": [_I] * 4, "dmm_body": [_I] * 2},
    "smm": {"smm": [_P] * 8 + [_I] * 4 + [_I, _P], "smm_body": [_I] * 5},
    "afu": {"softmax_lut": [_P] * 3 + [_I] * 2 + [_I, _P],
            "softmax_lut_regime": [_I],
            "layernorm_residual": [_P] * 5 + [_I] * 2 + [_I, _F, _P]},
}
_LOADED: Dict[str, ctypes.CDLL] = {}
# name -> {"seconds": build time, "ptxas": compiler resource report}
BUILD_LOG: Dict[str, dict] = {}


def build_dir() -> Path:
    """``build/kernels`` at the root of the checkout."""
    return Path(__file__).resolve().parents[3] / "build" / "kernels"


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cands: List[str] = []
    if CUDA_HOME:
        cands.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    for c in cands:
        if os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "source at first use and need the CUDA toolkit")


def _lib_path(name: str) -> Path:
    src = (_CSRC / SOURCES[name]).read_bytes() + b"".join(
        h.read_bytes() for h in sorted(_CSRC.glob("*.cuh")))
    tag = hashlib.sha256(src + " ".join(_FLAGS).encode()).hexdigest()[:12]
    return build_dir() / f"lib{name}-{tag}.so"


def build_all() -> Dict[str, dict]:
    """Compile every kernel library that is missing, in parallel. Raises
    with the compiler's output if any build fails. Returns ``BUILD_LOG``."""
    todo = {n: _lib_path(n) for n in SOURCES if not _lib_path(n).exists()}
    if not todo:
        return BUILD_LOG
    build_dir().mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name, out in todo.items():
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *_FLAGS, "-o", str(tmp), str(_CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    errors = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOG[name] = {"seconds": time.perf_counter() - t0,
                           "ptxas": log}
        if proc.returncode != 0:
            errors.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(errors))
    return BUILD_LOG


def load(name: str) -> ctypes.CDLL:
    """The bound library for kernel ``name``, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        path = _lib_path(name)
        if not path.exists():
            build_all()
        lib = ctypes.CDLL(str(path))
        for fname, argtypes in _ARGTYPES[name].items():
            fn = getattr(lib, fname)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LOADED[name] = lib
    return lib
