"""SMM kernel wrapper: ``z = y @ densify(first, deltas, vq, scale, offset,
value_bits)`` through the hand-written CUDA kernel ``kernels/csrc/smm.cu``.

Takes the reference Pallas kernel's streams (``repro.kernels.smm.smm``);
the per-layer scalars ``scale``, ``offset`` (f32) and ``value_bits``
(int32) are 0-d device tensors that the kernel reads itself, so a layer's
slice of the stacked ``(L,)`` leaves passes without a host sync. On CUDA
tensors it launches the kernel on the current stream, or raises: there is
no fallback. On CPU tensors it runs the plain version
(``ref.smm_reference``), which is also what the kernel is held against on
the card. ``LAUNCHES`` counts kernel launches only, and ``BODY_LAUNCHES``
the same launches by the body that ran (``smm_matmul.small``: M <= 32;
``.tc``: the tensor-core body, uint8 deltas at M > 32; ``.fma``: the
CUDA-core body for the rest), as the kernel chooses it from the shapes
and the deltas' type (``smm_body``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.smm.ref import smm_reference

__all__ = ["smm_matmul", "LAUNCHES", "BODY_LAUNCHES", "reset_launch_counts"]

LAUNCHES = {"smm_matmul": 0}
_BODIES = ("small", "tc", "fma")  # smm_body() codes 0, 1, 2
BODY_LAUNCHES = {f"smm_matmul.{b}": 0 for b in _BODIES}
_DELTA_CODE = {torch.uint8: 0, torch.int16: 1}


def reset_launch_counts() -> None:
    LAUNCHES["smm_matmul"] = 0
    for k in BODY_LAUNCHES:
        BODY_LAUNCHES[k] = 0


def smm_matmul(y: torch.Tensor, first: torch.Tensor, deltas: torch.Tensor,
               vq: torch.Tensor, scale: torch.Tensor, offset: torch.Tensor,
               value_bits: torch.Tensor) -> torch.Tensor:
    """y (M, r) f32; first (N,) int32; deltas (nnz-1, N) uint8/int16; vq
    (nnz, N) uint8; scale, offset 0-d f32; value_bits 0-d int32 -> (M, N)
    f32. Row indices outside ``[0, r)`` are skipped."""
    name = "smm_matmul"
    M, r = y.shape
    nnz, N = vq.shape
    if first.shape != (N,) or deltas.shape != (max(nnz - 1, 0), N):
        raise ValueError(f"{name}: shape mismatch first{tuple(first.shape)} "
                         f"deltas{tuple(deltas.shape)} vq{tuple(vq.shape)}")
    if y.device.type == "cpu":
        return smm_reference(y, first, deltas, vq, scale, offset, value_bits)
    ts = (y, first, deltas, vq, scale, offset, value_bits)
    for t in ts:
        if t.device != y.device:
            raise ValueError(f"{name}: all inputs must be on {y.device}, got "
                             f"{t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    if y.dtype != torch.float32 or first.dtype != torch.int32 \
            or deltas.dtype not in _DELTA_CODE or vq.dtype != torch.uint8 \
            or scale.dtype != torch.float32 or offset.dtype != torch.float32 \
            or value_bits.dtype != torch.int32:
        raise TypeError(f"{name}: needs y f32, first int32, deltas "
                        f"uint8/int16, vq uint8, scale/offset f32, value_bits "
                        f"int32; got {[str(t.dtype) for t in ts]}")
    if scale.numel() != 1 or offset.numel() != 1 or value_bits.numel() != 1:
        raise ValueError(f"{name}: scale, offset and value_bits are scalars")
    out = torch.empty((M, N), dtype=torch.float32, device=y.device)
    if M == 0 or N == 0:
        return out
    from repro_torch.kernels.build import load
    lib = load("smm")
    code = _DELTA_CODE[deltas.dtype]
    body = _BODIES[lib.smm_body(M, r, nnz, N, code)]
    err = lib.smm(
        y.data_ptr(), first.data_ptr(), deltas.data_ptr(), vq.data_ptr(),
        scale.data_ptr(), offset.data_ptr(), value_bits.data_ptr(),
        out.data_ptr(), M, r, nnz, N, code,
        torch.cuda.current_stream(y.device).cuda_stream)
    if err:
        what = ("a column tile's streams are staged in shared memory, which "
                "bounds nnz" if body == "tc" else "rows of y are staged in "
                "shared memory, which bounds r")
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err} "
                           f"(M={M}, r={r}, nnz={nnz}, N={N}, {body} body; "
                           f"{what})")
    LAUNCHES[name] += 1
    BODY_LAUNCHES[f"{name}.{body}"] += 1
    return out
