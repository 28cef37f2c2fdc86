"""DMM: the LUT-dequant matmul ``y = x @ LUT[codes]`` — a hand-written CUDA
kernel (``csrc/dmm.cu``), its plain version and the public op."""
