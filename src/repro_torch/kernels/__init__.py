"""Hand-written CUDA kernels for Hopper beside their plain PyTorch versions,
one package per kernel family, as the reference's ``repro.kernels``:

- dmm: the LUT-dequant matmul ``x @ LUT[codes]`` (the DMM core);
- smm: the delta-coded sparse matmul ``y @ densify(W_D streams)`` (SMM);
- afu: the LUT-exp softmax and the fused residual + LayerNorm (AFU);
- tda: length-predicated slot-decode and mixed-step attention over
  contiguous or paged lanes, fp or int8, exact or LUT exp (TRF).

Every kernel is built at first use from ``csrc/`` (``build.py``); importing
this package needs neither ``nvcc`` nor a GPU.
"""
from repro_torch.kernels.afu.ops import (  # noqa: F401
    fused_layernorm_residual,
    fused_softmax,
)
from repro_torch.kernels.dmm.ops import lut_matmul  # noqa: F401
from repro_torch.kernels.smm.ops import compressed_matmul  # noqa: F401
from repro_torch.kernels.tda.ops import fused_decode_attention  # noqa: F401
from repro_torch.kernels.tda.ref import block_stats  # noqa: F401
