"""DMM kernel wrapper: ``y = x @ LUT[unpack(codes_packed)]`` through the
hand-written CUDA kernel ``kernels/csrc/dmm.cu``.

Takes the reference Pallas kernel's arguments (``repro.kernels.dmm.dmm``).
On CUDA tensors it launches the kernel on the current stream, or raises:
there is no fallback. On CPU tensors it runs the plain version
(``ref.dmm_reference``), which is also what the kernel is held against on
the card. ``LAUNCHES`` counts kernel launches only, and ``BODY_LAUNCHES``
the same launches by the body that ran (``dmm_matmul.small``: bf16 ``x``,
M <= 32; ``.tc``: bf16 ``x``, M > 32; ``.fma``: f32 ``x``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import merge_counters
from repro_torch.kernels.dmm.ref import dmm_reference

__all__ = ["dmm_matmul", "LAUNCHES", "BODY_LAUNCHES", "reset_launch_counts"]

LAUNCHES = {"dmm_matmul": 0}
_BODIES = ("small", "tc", "fma")  # dmm_body() codes 0, 1, 2
BODY_LAUNCHES = {f"dmm_matmul.{b}": 0 for b in _BODIES}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def reset_launch_counts() -> None:
    LAUNCHES["dmm_matmul"] = 0
    for k in BODY_LAUNCHES:
        BODY_LAUNCHES[k] = 0


def dmm_matmul(x: torch.Tensor, codes_packed: torch.Tensor,
               lut: torch.Tensor) -> torch.Tensor:
    """x (M, K) f32/bf16; codes_packed (ceil(K/2), N) uint8 (row 2i in the
    high nibble; an odd K's pad row is never read against a live ``x``
    column); lut (16,) f32 -> (M, N) f32."""
    name = "dmm_matmul"
    M, K = x.shape
    Kp, N = codes_packed.shape
    if Kp != (K + 1) // 2:
        raise ValueError(f"{name}: codes_packed has {Kp} rows, K={K} needs "
                         f"{(K + 1) // 2}")
    if x.device.type == "cpu":
        return dmm_reference(x, codes_packed, lut)
    for t in (x, codes_packed, lut):
        if t.device != x.device:
            raise ValueError(f"{name}: all inputs must be on {x.device}, got "
                             f"{t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    if x.dtype not in _DTYPE_CODE or codes_packed.dtype != torch.uint8 \
            or lut.dtype != torch.float32 or lut.shape != (16,):
        raise TypeError(f"{name}: needs x f32/bf16, codes uint8 and a (16,) "
                        f"f32 lut; got {x.dtype}, {codes_packed.dtype}, "
                        f"{lut.dtype}{tuple(lut.shape)}")
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    if M == 0 or N == 0:
        return out
    from repro_torch.kernels.build import load
    lib = load("dmm")
    code = _DTYPE_CODE[x.dtype]
    splits = lib.dmm_splits(M, K, N, code)
    ws = torch.empty((splits, M, N) if splits > 1 else (0,),
                     dtype=torch.float32, device=x.device)
    cnt = merge_counters(x.device, -(-N // 128))
    err = lib.dmm(x.data_ptr(), codes_packed.data_ptr(), lut.data_ptr(),
                  out.data_ptr(), ws.data_ptr(), cnt.data_ptr(), M, K, N,
                  splits, code, torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")
    LAUNCHES[name] += 1
    BODY_LAUNCHES[f"{name}.{_BODIES[lib.dmm_body(M, code)]}"] += 1
    return out
