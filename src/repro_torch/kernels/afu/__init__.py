"""AFU: the LUT-exp row softmax and the fused residual + LayerNorm —
hand-written CUDA kernels (``csrc/afu.cu``), their plain versions and the
public ops."""
