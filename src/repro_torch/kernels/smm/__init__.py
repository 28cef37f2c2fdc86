"""SMM: the delta-coded sparse matmul ``z = y @ densify(W_D streams)`` — a
hand-written CUDA kernel (``csrc/smm.cu``), its plain version and the
public op."""
