"""AFU kernel wrappers: the LUT-exp row softmax and the fused residual +
LayerNorm, through the hand-written CUDA kernels of ``kernels/csrc/afu.cu``.

``softmax_lut`` and ``layernorm_residual`` take the reference Pallas
kernels' arguments (``repro.kernels.afu.afu``) less their row blocking and
interpret flag. On CUDA tensors they launch the kernels on the current
stream, or raise: there is no fallback. On CPU tensors they run the plain
versions of ``ref.py``, which are also what the kernels are held against on
the card. ``LAUNCHES`` counts kernel launches only, and
``REGIME_LAUNCHES`` the softmax's launches by the regime that ran
(:func:`softmax_regime`).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.afu.ref import (
    LUT_SIZE,
    layernorm_residual_reference,
    softmax_lut_reference,
)

__all__ = ["softmax_lut", "layernorm_residual", "softmax_regime",
           "kernel_regime", "REGIMES", "LAUNCHES", "REGIME_LAUNCHES",
           "reset_launch_counts"]

LAUNCHES = {"softmax_lut": 0, "layernorm_residual": 0}
# softmax_lut's regimes, as ``kernels/csrc/afu.cu`` picks them by C (its
# ``softmax_lut_regime`` codes 0-3): a warp a row up to WARP_MAX_C; a block
# a row, staged in shared memory, up to BLOCK_MAX_C; past that a cluster of
# CLUSTER CTAs a row, each staging up to SLICE_MAX entries, or re-reading
# its slice from device memory past CLUSTER x SLICE_MAX.
REGIMES = ("warp", "block", "cluster", "cluster_reread")
WARP_MAX_C, BLOCK_MAX_C, CLUSTER, SLICE_MAX = 1024, 24 * 1024, 16, 24 * 1024
REGIME_LAUNCHES = {f"softmax_lut.{r}": 0 for r in REGIMES}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_BOUND = {}  # C entry point name -> ctypes function, bound once a process


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, REGIME_LAUNCHES):
        for name in counts:
            counts[name] = 0


def softmax_regime(C: int) -> str:
    """The regime ``softmax_lut`` launches for rows of ``C`` entries."""
    if C <= WARP_MAX_C:
        return "warp"
    if C <= BLOCK_MAX_C:
        return "block"
    return "cluster" if -(-C // CLUSTER) <= SLICE_MAX else "cluster_reread"


def kernel_regime(C: int) -> str:
    """The regime the CUDA library itself picks for rows of ``C`` entries
    (needs the card: it builds and loads the library), against which
    :func:`softmax_regime` is held."""
    return REGIMES[_entry("softmax_lut_regime")(C)]


def _entry(name: str):
    """The AFU library's C entry point ``name`` (the library built first
    if needed)."""
    fn = _BOUND.get(name)
    if fn is None:
        from repro_torch.kernels.build import load
        fn = _BOUND[name] = getattr(load("afu"), name)
    return fn


def _check(name: str, rows, params) -> int:
    """Device / dtype / contiguity checks: ``rows`` (f32 or bf16, one
    dtype) and ``params`` (f32) on one device, all contiguous. Returns the
    kernel's dtype code of ``rows``."""
    dev = rows[0].device
    for t in rows + params:
        if t.device != dev:
            raise ValueError(f"{name}: all inputs must be on {dev}, got "
                             f"{t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    dts = {t.dtype for t in rows}
    if len(dts) != 1 or next(iter(dts)) not in _DTYPE_CODE:
        raise TypeError(f"{name}: inputs must share one dtype of "
                        f"{sorted(map(str, _DTYPE_CODE))}, got {dts}")
    for t in params:
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: tables, scale and bias must be "
                            f"float32, got {t.dtype}")
    return _DTYPE_CODE[next(iter(dts))]


def _raise_on(name: str, err: int) -> None:
    if err:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


def softmax_lut(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """LUT-exp softmax over the last axis. x (R, C) f32 or bf16; table
    (LUT_SIZE,) f32 -> (R, C) f32."""
    if x.device.type == "cpu":
        return softmax_lut_reference(x, table)
    name = "softmax_lut"
    code = _check(name, (x,), (table,))
    if x.dim() != 2 or table.shape != (LUT_SIZE,):
        raise ValueError(f"{name}: needs x (R, C) and a ({LUT_SIZE},) table, "
                         f"got {tuple(x.shape)} and {tuple(table.shape)}")
    R, C = x.shape
    out = torch.empty((R, C), dtype=torch.float32, device=x.device)
    _raise_on(name, _entry(name)(
        x.data_ptr(), table.data_ptr(), out.data_ptr(), R, C, code,
        torch.cuda.current_stream(x.device).cuda_stream))
    if R and C:
        LAUNCHES[name] += 1
        REGIME_LAUNCHES[f"{name}.{softmax_regime(C)}"] += 1
    return out


def layernorm_residual(x: torch.Tensor, res: torch.Tensor,
                       scale: torch.Tensor, bias: torch.Tensor, *,
                       eps: float = 1e-6) -> torch.Tensor:
    """Fused ``(x + res)`` -> LayerNorm. x, res (R, C) f32 or bf16 (one
    dtype); scale, bias (C,) f32 -> (R, C) f32."""
    if x.device.type == "cpu":
        return layernorm_residual_reference(x, res, scale, bias, eps)
    name = "layernorm_residual"
    code = _check(name, (x, res), (scale, bias))
    if x.dim() != 2 or res.shape != x.shape \
            or scale.shape != (x.shape[1],) or bias.shape != scale.shape:
        raise ValueError(f"{name}: needs x, res (R, C) and scale, bias (C,), "
                         f"got {tuple(x.shape)}, {tuple(res.shape)}, "
                         f"{tuple(scale.shape)}, {tuple(bias.shape)}")
    R, C = x.shape
    out = torch.empty((R, C), dtype=torch.float32, device=x.device)
    _raise_on(name, _entry(name)(
        x.data_ptr(), res.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        out.data_ptr(), R, C, code, float(eps),
        torch.cuda.current_stream(x.device).cuda_stream))
    LAUNCHES[name] += 1
    return out
